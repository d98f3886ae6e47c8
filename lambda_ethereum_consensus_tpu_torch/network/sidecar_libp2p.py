"""libp2p-wire sidecar: the stdio Command/Notification contract served by
the REAL libp2p protocol stack.

Selected with ``SIDECAR_WIRE=libp2p`` (``network.sidecar.main`` branches
on it); the host runtime is unchanged — same ``Port`` API, same protobuf
schema — but on the wire this process speaks what go-libp2p speaks
(ref: native/libp2p_port/internal/{reqresp,subscriptions}):

- TCP + multistream-select + libp2p-noise + /mplex/6.7.0 (libp2p/host);
- gossip on /meshsub/1.1.0 with the gossipsub v1.1 RPC protobuf,
  StrictNoSign, eth2 message ids (libp2p/gossipsub);
- eth2 req/resp as one-stream-per-request with half-close (the payload
  framing — varint + ssz_snappy — stays the host's job, as in the
  reference where Elixir frames and Go moves bytes).

Identity is an ed25519 libp2p key (peer ids are the real ``12D3KooW…``
kind), persisted via ``SIDECAR_KEY_FILE`` like the bespoke sidecar's
noise key.  Fork-digest separation needs no HELLO here: eth2 topic names
embed the digest, and req/resp protocols are explicit paths — peers on
another fork share neither (the reference additionally filters at
discovery time via ENR, discovery.go:122-146, which has no counterpart
in this direct-dial deployment).

The port's copy of the JAX package's ``network/sidecar_libp2p.py``, with
discovery off: discv5 is not ported (ROADMAP.md Queue 1 item 4b), so the
init result carries an empty ENR, ``enr:`` bootnodes are not dialed, and
one stderr line at init says so.  ``host:port`` bootnodes and everything
else behave as in the JAX sidecar.  The identity is loaded by the init
command, so without ``cryptography`` the init fails (``Port.start`` then
raises): the sidecar never starts without noise.  It imports no ``torch``.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import sys
from collections import OrderedDict

from .libp2p.gossipsub import ACCEPT, IGNORE, REJECT, Gossipsub
from .libp2p.host import Libp2pError, Libp2pHost
from .libp2p.mplex import MplexError
from .libp2p.identity import Identity, PeerId
from .proto import port_pb2

MAX_FRAME = 1 << 28
PENDING_CAP = 4096
VALIDATION_TIMEOUT_S = 5.0

_VERDICTS = {
    port_pb2.ValidateMessage.ACCEPT: ACCEPT,
    port_pb2.ValidateMessage.REJECT: REJECT,
    port_pb2.ValidateMessage.IGNORE: IGNORE,
}


def _load_identity() -> Identity:
    key_file = os.environ.get("SIDECAR_KEY_FILE")
    if key_file and os.path.exists(key_file):
        try:
            with open(key_file, "rb") as fh:
                return Identity.from_seed(fh.read(32))
        except Exception:
            print(
                f"sidecar: corrupt key file {key_file}; regenerating identity",
                file=sys.stderr,
                flush=True,
            )
    identity = Identity()
    if key_file:
        tmp = f"{key_file}.tmp.{os.getpid()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as fh:
            fh.write(identity.private_bytes())
        os.replace(tmp, key_file)
    return identity


class Libp2pSidecar:
    def __init__(self):
        # set by the init command (_setup)
        self.identity: Identity | None = None
        self.host: Libp2pHost | None = None
        self.gossip: Gossipsub | None = None
        # peer_id bytes -> last known "host:port", learned from live
        # connections: the dialable subset of peer-exchange (signed peer
        # records are not implemented, so PX from peers we have never
        # met carries no address we could verify).  Bounded LRU — the
        # addresses we mostly need are of DISCONNECTED peers (PX re-dial
        # after a prune), so eviction is by age, not by peer_gone
        self._px_addrs: OrderedDict[bytes, str] = OrderedDict()
        self.listen_port = 0
        # msg_id -> future the gossip validator awaits (host verdict)
        self.pending_validation: OrderedDict[bytes, asyncio.Future] = OrderedDict()
        # request_id -> inbound stream awaiting its response
        self.incoming_requests: dict[bytes, object] = {}
        self._req_counter = 0
        self.stdout_lock = asyncio.Lock()

    def _setup(self, identity: Identity) -> None:
        self.identity = identity
        self.host = Libp2pHost(identity)
        self.host.on_peer = self._on_peer
        self.host.on_peer_gone = self._on_peer_gone
        # Gossipsub chains host.on_peer, so construct it after setting ours
        self.gossip = Gossipsub(
            self.host, validator=self._validate, on_px=self._on_px
        )

    # ------------------------------------------------------------- stdio
    async def notify(self, notification: port_pb2.Notification) -> None:
        raw = notification.SerializeToString()
        async with self.stdout_lock:
            sys.stdout.buffer.write(struct.pack(">I", len(raw)) + raw)
            sys.stdout.buffer.flush()

    async def result(
        self, cmd_id: bytes, ok: bool, payload: bytes = b"", error: str = ""
    ) -> None:
        n = port_pb2.Notification()
        n.result.id = cmd_id
        n.result.ok = ok
        n.result.payload = payload
        n.result.error = error
        await self.notify(n)

    async def command_loop(self) -> None:
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin.buffer
        )
        while True:
            head = await reader.readexactly(4)
            (length,) = struct.unpack(">I", head)
            if length > MAX_FRAME:
                raise RuntimeError("oversized command frame")
            raw = await reader.readexactly(length)
            cmd = port_pb2.Command.FromString(raw)
            try:
                await self.handle_command(cmd)
            except Exception as e:
                await self.result(cmd.id, False, error=f"{type(e).__name__}: {e}")

    async def handle_command(self, cmd: port_pb2.Command) -> None:
        which = cmd.WhichOneof("c")
        if which == "init":
            # raises without `cryptography`: the init fails, never plaintext
            self._setup(_load_identity())
            host, _, port = (cmd.init.listen_addr or "127.0.0.1:0").rpartition(":")
            _, self.listen_port = await self.host.listen(
                host or "127.0.0.1", int(port or 0)
            )
            self.gossip.start()
            # bootnodes: "host:port" dials directly; "enr:..." would go
            # through discv5, which is not ported
            for addr in cmd.init.bootnodes:
                if not addr.startswith("enr:"):
                    asyncio.ensure_future(self._dial(addr))
            enr_text = self._start_discovery()
            payload = f"{self.listen_port} {enr_text}".encode()
            await self.result(cmd.id, True, payload=payload)
        elif which == "get_node_identity":
            await self.result(cmd.id, True, payload=self.identity.peer_id.bytes)
        elif which == "add_peer":
            ok, err = await self._dial(cmd.add_peer.addr)
            await self.result(cmd.id, ok, error=err)
        elif which == "subscribe":
            await self.gossip.subscribe(cmd.subscribe.topic)
            await self.result(cmd.id, True)
        elif which == "unsubscribe":
            await self.gossip.unsubscribe(cmd.unsubscribe.topic)
            await self.result(cmd.id, True)
        elif which == "publish":
            await self.gossip.publish(cmd.publish.topic, cmd.publish.payload)
            await self.result(cmd.id, True)
        elif which == "validate_message":
            fut = self.pending_validation.pop(cmd.validate_message.msg_id, None)
            if fut is not None and not fut.done():
                fut.set_result(_VERDICTS.get(cmd.validate_message.verdict, IGNORE))
            await self.result(cmd.id, True)
        elif which == "set_request_handler":
            protocol = cmd.set_request_handler.protocol_id
            self.host.set_stream_handler(protocol, self._serve_stream)
            await self.result(cmd.id, True)
        elif which == "get_gossip_stats":
            await self.result(
                cmd.id, True, payload=json.dumps(self.gossip.stats()).encode()
            )
        elif which == "send_request":
            asyncio.ensure_future(self._send_request(cmd))
        elif which == "send_response":
            # backgrounded like send_request: a peer that stops reading
            # (TCP backpressure) must stall only its own response, never
            # the command loop (validation verdicts ride the same loop)
            asyncio.ensure_future(self._send_response(cmd))
        else:
            await self.result(cmd.id, False, error=f"unknown command {which}")

    # ----------------------------------------------------------- discovery
    def _start_discovery(self) -> str:
        """Discovery is off: discv5 is not ported, so this returns the
        empty ENR and says so on stderr.  The libp2p host stays up, as the
        JAX sidecar's does when its discv5 start fails."""
        print(
            "sidecar: discv5 disabled (discovery is not ported: ROADMAP.md "
            "Queue 1 item 4b); enr: bootnodes are not dialed",
            file=sys.stderr,
            flush=True,
        )
        return ""

    # ------------------------------------------------------------- peering
    async def _dial(self, addr: str) -> tuple[bool, str]:
        host, _, port = addr.rpartition(":")
        try:
            await self.host.dial(host, int(port))
            return True, ""
        except (Libp2pError, ValueError, OSError) as e:
            return False, f"dial {addr}: {e}"

    _PX_ADDRS_CAP = 512

    async def _on_peer(self, peer_id: PeerId, addr: str) -> None:
        if addr:
            self._px_addrs[peer_id.bytes] = addr
            self._px_addrs.move_to_end(peer_id.bytes)
            while len(self._px_addrs) > self._PX_ADDRS_CAP:
                self._px_addrs.popitem(last=False)
        n = port_pb2.Notification()
        n.new_peer.peer_id = peer_id.bytes
        n.new_peer.addr = addr
        await self.notify(n)

    def _on_px(self, topic: str, infos) -> None:
        """Peer exchange from a good-standing PRUNE: re-dial offered
        peers whose address we know from an earlier connection, so a
        prune-for-oversubscription heals the topic instead of shrinking
        it.  PX for never-met peers needs signed peer records (their
        ``signed_peer_record`` field) — not implemented, skipped."""
        for info in infos:
            if not info.peer_id:
                continue
            peer_id = PeerId(info.peer_id)
            if peer_id in self.host.connections:
                continue
            addr = self._px_addrs.get(info.peer_id)
            if addr:
                asyncio.ensure_future(self._dial(addr))

    async def _on_peer_gone(self, peer_id: PeerId) -> None:
        n = port_pb2.Notification()
        n.peer_gone.peer_id = peer_id.bytes
        await self.notify(n)

    # ------------------------------------------------------------- gossip
    async def _validate(
        self, topic: str, data: bytes, msg_id: bytes, peer_id: PeerId
    ) -> int:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.pending_validation[msg_id] = fut
        while len(self.pending_validation) > PENDING_CAP:
            _, stale = self.pending_validation.popitem(last=False)
            if not stale.done():
                stale.set_result(IGNORE)
        n = port_pb2.Notification()
        n.gossip.topic = topic
        n.gossip.msg_id = msg_id
        n.gossip.payload = data
        n.gossip.peer_id = peer_id.bytes
        await self.notify(n)
        try:
            return await asyncio.wait_for(fut, VALIDATION_TIMEOUT_S)
        except asyncio.TimeoutError:
            self.pending_validation.pop(msg_id, None)
            return IGNORE

    # ------------------------------------------------------------ req/resp
    async def _serve_stream(self, stream, protocol: str, peer_id: PeerId) -> None:
        payload = await stream.read_all()
        self._req_counter += 1
        request_id = self._req_counter.to_bytes(8, "big")
        self.incoming_requests[request_id] = stream
        # a request the host never answers (or whose peer resets the
        # stream) must not pin its stream object forever: expire it after
        # the response window, like pending_validation's cap
        asyncio.get_running_loop().call_later(
            self.RESPONSE_TIMEOUT_S * 2, self._expire_request, request_id
        )
        n = port_pb2.Notification()
        n.request.protocol_id = protocol
        n.request.request_id = request_id
        n.request.payload = payload
        n.request.peer_id = peer_id.bytes
        await self.notify(n)

    RESPONSE_TIMEOUT_S = 10.0

    def _expire_request(self, request_id: bytes) -> None:
        stream = self.incoming_requests.pop(request_id, None)
        if stream is not None:
            task = asyncio.ensure_future(stream.reset())  # async close
            task.add_done_callback(  # already-dead / cancelled: both fine
                lambda t: None if t.cancelled() else t.exception()
            )

    async def _send_response(self, cmd: port_pb2.Command) -> None:
        stream = self.incoming_requests.pop(cmd.send_response.request_id, None)
        if stream is None:
            await self.result(cmd.id, False, error="unknown request id")
            return

        async def write_and_close():
            stream.write(cmd.send_response.payload)
            await stream.close_write()

        try:
            await asyncio.wait_for(write_and_close(), self.RESPONSE_TIMEOUT_S)
            await self.result(cmd.id, True)
        except (Libp2pError, MplexError, ConnectionError, OSError, asyncio.TimeoutError) as e:
            await self.result(cmd.id, False, error=f"send: {type(e).__name__}: {e}")

    async def _send_request(self, cmd: port_pb2.Command) -> None:
        req = cmd.send_request
        peer_id = PeerId(req.peer_id)
        timeout = (req.timeout_ms or 15000) / 1000
        try:
            payload = await self.host.request(
                peer_id, req.protocol_id, req.payload, timeout=timeout
            )
            await self.result(cmd.id, True, payload=payload)
        except (Libp2pError, ConnectionError, OSError) as e:
            await self.result(cmd.id, False, error=str(e))


async def _main() -> None:
    sidecar = Libp2pSidecar()
    await sidecar.command_loop()


def main() -> None:
    try:
        asyncio.run(_main())
    except (KeyboardInterrupt, asyncio.IncompleteReadError, EOFError):
        pass


if __name__ == "__main__":
    main()
