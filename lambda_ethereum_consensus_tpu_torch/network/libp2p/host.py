"""The composed libp2p host: TCP -> multistream -> noise -> mplex -> streams.

Equivalent of the reference's go-libp2p host construction (ref:
reqresp.go:30-46) built from this package's wire-exact layers.  Upgrade
sequence per connection, matching the libp2p connection spec:

1. TCP connect/accept;
2. multistream-select on the raw socket negotiates ``/noise``;
3. the libp2p-noise XX handshake authenticates both peers' ed25519
   identities (noise_transport);
4. multistream-select *inside* the encrypted channel negotiates
   ``/mplex/6.7.0``;
5. each application stream opens with its own multistream negotiation of
   the protocol path (e.g. ``/eth2/beacon_chain/req/status/1/ssz_snappy``).

``request()`` implements the eth2 req/resp stream discipline: write the
request, half-close, read the response to EOF (ref: reqresp.go:73-86).

The port's copy of the JAX package's ``network/libp2p/host.py``; the
bytes it puts on the wire are the JAX module's. One change: the identify
message omits a listener bound to 0.0.0.0, as the JAX host does when its
``SIDECAR_EXTERNAL_IP`` variable is unset; the port reads no such
variable.
"""

from __future__ import annotations

import asyncio
import logging

from .identity import Identity, PeerId
from .mplex import Mplex, MplexError, MplexStream
from .multistream import NegotiationError, handle as ms_handle, select as ms_select
from .noise_transport import secure_connection
from .yamux import Yamux
from . import varint

NOISE_PROTOCOL = "/noise"
MPLEX_PROTOCOL = "/mplex/6.7.0"
YAMUX_PROTOCOL = "/yamux/1.0.0"
# yamux preferred, like go-libp2p's default muxer order (ref:
# reqresp.go:32-41) — mainnet peers overwhelmingly pick it
MUXER_PROTOCOLS = [YAMUX_PROTOCOL, MPLEX_PROTOCOL]
IDENTIFY_PROTOCOL = "/ipfs/id/1.0.0"
AGENT_VERSION = "lambda-ethereum-consensus-tpu/0.4.0"


class Libp2pError(Exception):
    pass


class Connection:
    def __init__(self, channel, muxer: Mplex, peer_id: PeerId):
        self.channel = channel
        self.muxer = muxer
        self.peer_id = peer_id
        self.run_task: asyncio.Task | None = None


class Libp2pHost:
    """Minimal libp2p host speaking the real wire protocols."""

    def __init__(self, identity: Identity | None = None):
        self.identity = identity or Identity()
        self.peer_id = self.identity.peer_id
        self.connections: dict[PeerId, Connection] = {}
        self.handlers: dict[str, object] = {}  # protocol -> async handler
        self._server: asyncio.AbstractServer | None = None
        self.on_peer = None  # optional async callback(PeerId, addr)
        self.on_peer_gone = None  # optional async callback(PeerId)
        self.listen_addrs: list[tuple[str, int]] = []
        # every libp2p host answers identify implicitly — go-libp2p peers
        # probe it right after the handshake and treat silence as broken
        self.set_stream_handler(IDENTIFY_PROTOCOL, self._identify_handler)

    # ------------------------------------------------------------ lifecycle
    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._accept, host, port)
        sock = self._server.sockets[0].getsockname()
        self.listen_addrs.append((sock[0], sock[1]))
        return sock[0], sock[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for conn in list(self.connections.values()):
            if conn.run_task is not None:
                conn.run_task.cancel()
            conn.channel.close()
        self.connections.clear()

    def set_stream_handler(self, protocol: str, handler) -> None:
        """``handler(stream, protocol, peer_id)`` runs per inbound stream."""
        self.handlers[protocol] = handler

    # ----------------------------------------------------------- connecting
    async def dial(self, host: str, port: int, timeout: float = 10.0) -> PeerId:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout
        )
        try:
            conn = await asyncio.wait_for(
                self._upgrade(reader, writer, initiator=True), timeout
            )
        except Exception as e:
            # negotiation/noise/varint/short-read — anything a hostile or
            # non-libp2p endpoint can provoke must surface as Libp2pError
            # with the socket closed, never a leaked writer + stray task
            # exception
            writer.close()
            raise Libp2pError(f"dial {host}:{port}: {type(e).__name__}: {e}") from None
        await self._register(conn, f"{host}:{port}")
        return conn.peer_id

    async def _accept(self, reader, writer) -> None:
        try:
            conn = await asyncio.wait_for(
                self._upgrade(reader, writer, initiator=False), 10.0
            )
        except Exception:
            writer.close()
            return
        peername = writer.get_extra_info("peername")
        await self._register(conn, f"{peername[0]}:{peername[1]}" if peername else "")

    async def _upgrade(self, reader, writer, initiator: bool) -> Connection:
        # security negotiation on the raw socket
        if initiator:
            await ms_select(reader, writer, [NOISE_PROTOCOL])
        else:
            await ms_handle(reader, writer, [NOISE_PROTOCOL])
        channel = await secure_connection(reader, writer, self.identity, initiator)
        # muxer negotiation inside the encrypted channel: yamux preferred,
        # mplex kept for peers that only speak it
        if initiator:
            chosen = await ms_select(channel, channel, MUXER_PROTOCOLS)
        else:
            chosen = await ms_handle(channel, channel, MUXER_PROTOCOLS)
        if chosen == YAMUX_PROTOCOL:
            muxer = Yamux(
                channel, on_stream=self._inbound_stream, initiator=initiator,
                # go-yamux keepalive cadence: an unanswered ping tears the
                # session down, so a silently dead TCP path (NAT timeout,
                # pulled cable) cannot strand its streams forever
                keepalive_s=Yamux.KEEPALIVE_INTERVAL_S,
            )
        else:
            muxer = Mplex(channel, on_stream=self._inbound_stream)
        return Connection(channel, muxer, channel.peer_id)

    async def _register(self, conn: Connection, addr: str) -> None:
        if conn.peer_id == self.peer_id or conn.peer_id in self.connections:
            conn.channel.close()  # self-dial or duplicate
            return
        conn.run_task = asyncio.ensure_future(self._run(conn))
        self.connections[conn.peer_id] = conn
        if self.on_peer is not None:
            await self.on_peer(conn.peer_id, addr)

    async def _run(self, conn: Connection) -> None:
        try:
            await conn.muxer.run()
        finally:
            if self.connections.get(conn.peer_id) is conn:
                del self.connections[conn.peer_id]
                if self.on_peer_gone is not None:
                    try:
                        await self.on_peer_gone(conn.peer_id)
                    except Exception:
                        pass
            conn.channel.close()

    # ------------------------------------------------------------- identify
    def _identify_message(self) -> bytes:
        """The Identify protobuf (libp2p identify spec): field 1 publicKey,
        2 listenAddrs (multiaddr bytes), 3 protocols, 5 protocolVersion,
        6 agentVersion.  Hand-encoded like the identity/noise protobufs."""

        def field(num: int, payload: bytes) -> bytes:
            return varint.encode(num << 3 | 2) + varint.encode(len(payload)) + payload

        out = bytearray()
        out += field(1, self.identity.public_pb)
        for ip, port in self.listen_addrs:
            if ip == "0.0.0.0":
                continue  # an unspecified bind address is unroutable for peers
            try:  # multiaddr /ip4/<ip>/tcp/<port>: code 4 + addr, code 6 + port
                ip_raw = bytes(int(x) for x in ip.split("."))
                if len(ip_raw) != 4:
                    continue
            except ValueError:
                continue
            out += field(
                2,
                varint.encode(4) + ip_raw + varint.encode(6)
                + port.to_bytes(2, "big"),
            )
        for proto in sorted(self.handlers):
            out += field(3, proto.encode())
        out += field(5, b"ipfs/0.1.0")
        out += field(6, AGENT_VERSION.encode())
        return bytes(out)

    async def _identify_handler(self, stream, protocol: str, peer_id) -> None:
        msg = self._identify_message()
        stream.write(varint.encode(len(msg)) + msg)
        await stream.close_write()

    # -------------------------------------------------------------- streams
    async def _inbound_stream(self, stream: MplexStream) -> None:
        try:
            protocol = await ms_handle(stream, stream, sorted(self.handlers))
        except (NegotiationError, asyncio.IncompleteReadError, MplexError):
            await stream.reset()  # peer protocol error / stream death
            return
        except Exception:
            # a local bug (bad handler registry etc.) must be diagnosable,
            # not a silent reset indistinguishable from peer misbehavior
            logging.getLogger("libp2p.host").exception("inbound negotiation failed")
            await stream.reset()
            return
        peer_id = stream._muxer._channel.peer_id
        handler = self.handlers[protocol]
        try:
            await handler(stream, protocol, peer_id)
        except (MplexError, asyncio.IncompleteReadError, ConnectionError, OSError):
            await stream.reset()
        except Exception:
            logging.getLogger("libp2p.host").exception(
                "stream handler failed for %s", protocol
            )
            await stream.reset()

    async def new_stream(self, peer_id: PeerId, protocols: list[str]) -> tuple[MplexStream, str]:
        conn = self.connections.get(peer_id)
        if conn is None:
            raise Libp2pError(f"not connected to {peer_id!r}")
        stream = await conn.muxer.open_stream()
        try:
            chosen = await ms_select(stream, stream, protocols)
        except NegotiationError as e:
            await stream.reset()
            raise Libp2pError(str(e)) from None
        return stream, chosen

    async def request(
        self, peer_id: PeerId, protocol: str, payload: bytes, timeout: float = 15.0
    ) -> bytes:
        """eth2 req/resp exchange: write || half-close || read-to-EOF."""
        stream, _ = await self.new_stream(peer_id, [protocol])
        try:
            stream.write(payload)
            await stream.close_write()
            return await asyncio.wait_for(stream.read_all(), timeout)
        except asyncio.TimeoutError:
            await stream.reset()
            raise Libp2pError(f"request timed out on {protocol}") from None
        except (MplexError, ConnectionError, OSError) as e:
            # peer reset / connection death mid-request: the caller gets a
            # typed failure, not a stranded task
            raise Libp2pError(f"request failed on {protocol}: {e}") from None
