"""The port's /yamux/1.0.0 and muxer negotiation: the cases of the JAX
package's ``tests/unit/test_yamux.py`` against the port's modules.

Frame bytes against the yamux spec; flow control, ping, reset, the accept
ACK, window overrun and the buffer cap's deferred grants over in-memory
pipes; two port hosts negotiating yamux by default and mplex for a
dialer that offers only mplex; the identify answer.  Every wait has a
bound.  Tolerance: none.
"""

import asyncio
import time

import pytest

pytest.importorskip(
    "cryptography",
    reason="libp2p identity/noise needs the optional 'cryptography' module",
)


from lambda_ethereum_consensus_tpu_torch.network.libp2p import host as host_mod
from lambda_ethereum_consensus_tpu_torch.network.libp2p import yamux
from lambda_ethereum_consensus_tpu_torch.network.libp2p.host import Libp2pHost
from lambda_ethereum_consensus_tpu_torch.network.libp2p.mplex import Mplex
from lambda_ethereum_consensus_tpu_torch.network.libp2p.yamux import (
    FLAG_ACK,
    FLAG_FIN,
    FLAG_SYN,
    TYPE_DATA,
    TYPE_PING,
    TYPE_WINDOW,
    Yamux,
    encode_frame,
)


def test_yamux_frame_bytes():
    """Header fixture: version 0, type/flags/id/length big-endian (spec)."""
    # data frame, SYN, stream 1, 3 bytes
    assert encode_frame(TYPE_DATA, FLAG_SYN, 1, 3, b"abc") == (
        bytes([0, 0, 0x00, 0x01, 0, 0, 0, 1, 0, 0, 0, 3]) + b"abc"
    )
    # window update +256KiB on stream 2
    assert encode_frame(TYPE_WINDOW, 0, 2, 256 * 1024) == bytes(
        [0, 1, 0, 0, 0, 0, 0, 2, 0, 4, 0, 0]
    )
    # ping ACK echoing opaque value 0xdeadbeef
    assert encode_frame(TYPE_PING, FLAG_ACK, 0, 0xDEADBEEF) == bytes(
        [0, 2, 0, 2, 0, 0, 0, 0, 0xDE, 0xAD, 0xBE, 0xEF]
    )
    # FIN half-close, stream 5
    assert encode_frame(TYPE_DATA, FLAG_FIN, 5, 0) == bytes(
        [0, 0, 0, 4, 0, 0, 0, 5, 0, 0, 0, 0]
    )


async def _until(cond, limit_s: float = 10.0) -> None:
    t_end = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"condition not met within {limit_s} s")
        await asyncio.sleep(0.005)


class _Pipe:
    """In-memory duplex channel half with the channel interface."""

    def __init__(self):
        self._reader = asyncio.StreamReader()
        self.other: "_Pipe" = None

    def write(self, data: bytes) -> None:
        self.other._reader.feed_data(data)

    async def drain(self) -> None:
        pass

    async def readexactly(self, n: int) -> bytes:
        return await self._reader.readexactly(n)

    def close(self) -> None:
        self._reader.feed_eof()
        self.other._reader.feed_eof()


def _pipe_pair():
    a, b = _Pipe(), _Pipe()
    a.other, b.other = b, a
    return a, b


def test_yamux_reqresp_discipline_and_flow_control():
    """write || half-close || read-to-EOF over a payload larger than the
    256 KiB initial window — the sender must block on WindowUpdate and
    the receiver's immediate grants must un-block it."""

    async def scenario():
        ca, cb = _pipe_pair()
        served = {}

        async def handler(stream):
            data = await stream.read_all()
            served["request"] = len(data)
            stream.write(b"R" * (300 * 1024))  # > initial window
            await stream.close_write()

        ma = Yamux(ca, initiator=True)
        mb = Yamux(cb, on_stream=handler, initiator=False)
        ta = asyncio.ensure_future(ma.run())
        tb = asyncio.ensure_future(mb.run())

        stream = await ma.open_stream()
        assert stream.stream_id % 2 == 1  # initiator ids are odd
        stream.write(b"Q" * (300 * 1024))
        await stream.close_write()
        response = await asyncio.wait_for(stream.read_all(), 10)
        ca.close()
        await asyncio.gather(ta, tb, return_exceptions=True)
        return served, response

    served, response = asyncio.run(asyncio.wait_for(scenario(), 30))
    assert served["request"] == 300 * 1024
    assert response == b"R" * (300 * 1024)


def test_yamux_ping_echo_and_reset():
    async def scenario():
        ca, cb = _pipe_pair()
        ma = Yamux(ca, initiator=True)
        mb = Yamux(cb, initiator=False)
        ta = asyncio.ensure_future(ma.run())
        tb = asyncio.ensure_future(mb.run())

        # a ping from A: B echoes it with ACK and the same opaque value
        rtt = await ma.ping(timeout=10)
        assert rtt >= 0

        stream = await ma.open_stream()
        await stream.reset()
        with pytest.raises(Exception):
            await stream.read_all()
        ca.close()
        await asyncio.gather(ta, tb, return_exceptions=True)

    asyncio.run(asyncio.wait_for(scenario(), 30))


def test_hosts_negotiate_yamux_by_default_and_mplex_fallback(monkeypatch):
    """Both hosts prefer yamux; a dialer that only offers mplex still
    connects (the fallback go-libp2p keeps, reqresp.go:32-41)."""

    async def scenario(dialer_muxers):
        server, client = Libp2pHost(), Libp2pHost()
        host, port = await server.listen()
        if dialer_muxers is not None:
            # restrict ONLY the dialer's muxer proposal — the server keeps
            # its full preference list, so this exercises the real
            # asymmetric case: a yamux-capable listener answering an
            # mplex-only dialer
            orig_select = host_mod.ms_select

            async def select_restricted(reader, writer, protocols):
                if protocols == host_mod.MUXER_PROTOCOLS:
                    protocols = dialer_muxers
                return await orig_select(reader, writer, protocols)

            monkeypatch.setattr(host_mod, "ms_select", select_restricted)
        peer = await client.dial(host, port)
        server_kind = type(next(iter(server.connections.values())).muxer)
        kind = type(client.connections[peer].muxer)
        assert server_kind is kind  # both ends agreed
        # a real stream exchange over the negotiated muxer: identify
        raw = await client.request(peer, host_mod.IDENTIFY_PROTOCOL, b"")
        await client.close()
        await server.close()
        return kind, raw

    kind, raw = asyncio.run(asyncio.wait_for(scenario(None), 30))
    assert kind is Yamux

    kind, raw = asyncio.run(
        asyncio.wait_for(scenario([host_mod.MPLEX_PROTOCOL]), 30)
    )
    assert kind is Mplex


def test_identify_response_parses():
    """The identify answer is a varint-delimited Identify protobuf with
    our public key, listen addr and served protocols."""
    from lambda_ethereum_consensus_tpu_torch.network.libp2p import varint
    from lambda_ethereum_consensus_tpu_torch.network.libp2p.identity import (
        PeerId,
        _pb_read_varint,
    )

    async def scenario():
        server, client = Libp2pHost(), Libp2pHost()
        server.set_stream_handler("/eth2/test/1", lambda s, p, pid: None)
        host, port = await server.listen()
        peer = await client.dial(host, port)
        raw = await client.request(peer, host_mod.IDENTIFY_PROTOCOL, b"")
        await client.close()
        await server.close()
        return server, port, raw

    server, port, raw = asyncio.run(asyncio.wait_for(scenario(), 30))
    # varint length prefix then the message
    n, pos = _pb_read_varint(raw, 0)
    msg = raw[pos : pos + n]
    assert len(msg) == n
    # parse repeated fields by hand
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(msg):
        key, pos = _pb_read_varint(msg, pos)
        assert key & 7 == 2  # all fields length-delimited
        ln, pos = _pb_read_varint(msg, pos)
        fields.setdefault(key >> 3, []).append(msg[pos : pos + ln])
        pos += ln
    assert PeerId.from_public_key_pb(fields[1][0]) == server.peer_id
    addr_bytes = fields[2][0]
    assert addr_bytes[0] == 4  # /ip4
    assert int.from_bytes(addr_bytes[-2:], "big") == port
    protos = {f.decode() for f in fields[3]}
    assert "/eth2/test/1" in protos and host_mod.IDENTIFY_PROTOCOL in protos
    assert fields[6][0].decode().startswith("lambda-ethereum-consensus-tpu")


def test_yamux_accept_ack_sent_on_inbound_syn():
    """Accepting a SYN must answer an immediate WindowUpdate+ACK — go-yamux
    only frees its accept-backlog slot on ACK and kills the session when
    StreamOpenTimeout fires on an un-ACKed stream.  The
    stream here is one-directional (we never respond), so the ACK cannot
    ride any other frame."""

    async def scenario():
        ca, cb = _pipe_pair()
        got = asyncio.Event()

        async def handler(stream):
            await stream.read_all()
            got.set()

        mb = Yamux(cb, on_stream=handler, initiator=False)
        tb = asyncio.ensure_future(mb.run())

        # raw opener side: SYN + data + FIN, then read B's frames directly
        ca.write(encode_frame(TYPE_WINDOW, FLAG_SYN, 1, 0))
        ca.write(encode_frame(TYPE_DATA, 0, 1, 3, b"abc"))
        ca.write(encode_frame(TYPE_DATA, FLAG_FIN, 1, 0))
        head = await asyncio.wait_for(ca.readexactly(12), 5)
        version, typ, flags, stream_id, length = yamux._HEADER.unpack(head)
        ca.close()
        await asyncio.gather(tb, return_exceptions=True)
        return typ, flags, stream_id, length

    typ, flags, stream_id, length = asyncio.run(asyncio.wait_for(scenario(), 30))
    assert typ == TYPE_WINDOW and stream_id == 1
    assert flags & FLAG_ACK
    assert length == 0


def test_yamux_window_overrun_kills_session():
    """Data beyond the granted receive window is a protocol violation:
    the session tears down instead of buffering unbounded bytes."""

    async def scenario():
        ca, cb = _pipe_pair()
        mb = Yamux(cb, on_stream=lambda s: asyncio.sleep(0), initiator=False)
        tb = asyncio.ensure_future(mb.run())

        ca.write(encode_frame(TYPE_WINDOW, FLAG_SYN, 1, 0))
        # claim a frame bigger than the 256 KiB initial window (but under
        # MAX_FRAME_DATA so the length check alone doesn't catch it)
        over = yamux.INITIAL_WINDOW + 1
        ca.write(encode_frame(TYPE_DATA, 0, 1, over, b"x" * over))
        await asyncio.wait_for(tb, 5)  # read loop must exit
        return mb._closed

    assert asyncio.run(asyncio.wait_for(scenario(), 30)) is True


def test_yamux_buffer_cap_defers_grants():
    """A stream nobody reads stops receiving window grants once its
    buffer passes MAX_STREAM_BUFFER; a reader draining it releases the
    deferred grant (an authenticated peer cannot park unbounded memory)."""

    async def scenario():
        ca, cb = _pipe_pair()
        streams = {}

        async def handler(stream):
            streams["s"] = stream  # accept but do NOT read

        mb = Yamux(cb, on_stream=handler, initiator=False)
        tb = asyncio.ensure_future(mb.run())

        small_cap = 1024
        orig_cap = yamux.MAX_STREAM_BUFFER
        yamux.MAX_STREAM_BUFFER = small_cap
        try:
            ca.write(encode_frame(TYPE_WINDOW, FLAG_SYN, 1, 0))
            head = await asyncio.wait_for(ca.readexactly(12), 5)  # accept-ACK
            # fill past the cap in two frames; stay inside the window
            ca.write(encode_frame(TYPE_DATA, 0, 1, small_cap, b"a" * small_cap))
            ca.write(encode_frame(TYPE_DATA, 0, 1, 512, b"b" * 512))
            await _until(lambda: "s" in streams and len(streams["s"]._buf) == small_cap + 512)
            s = streams["s"]
            # first frame was granted back (buffer was at the cap, not
            # over); the second pushed the buffer over -> grant deferred
            head = await asyncio.wait_for(ca.readexactly(12), 5)
            _, typ1, _, _, granted1 = yamux._HEADER.unpack(head)
            assert typ1 == TYPE_WINDOW and granted1 == small_cap
            assert s._deferred_grant == 512
            # a reader drains the buffer -> deferred grant flushes
            data = await s.readexactly(small_cap + 512)
            assert data == b"a" * small_cap + b"b" * 512
            head = await asyncio.wait_for(ca.readexactly(12), 5)
            _, typ2, _, _, granted2 = yamux._HEADER.unpack(head)
            assert typ2 == TYPE_WINDOW and granted2 == 512
            assert s._deferred_grant == 0
        finally:
            yamux.MAX_STREAM_BUFFER = orig_cap
            ca.close()
            await asyncio.gather(tb, return_exceptions=True)

    asyncio.run(asyncio.wait_for(scenario(), 30))


def test_yamux_large_readexactly_survives_buffer_cap():
    """A single readexactly() larger than MAX_STREAM_BUFFER must keep
    granting window while it drains — buffering the whole read first
    would deadlock against the grant deferral (gossipsub RPCs can be
    10 MiB against a 4 MiB cap)."""

    async def scenario():
        ca, cb = _pipe_pair()
        got = {}

        async def handler(stream):
            got["data"] = await stream.readexactly(600 * 1024)

        mb = Yamux(cb, on_stream=handler, initiator=False)
        tb = asyncio.ensure_future(mb.run())
        ma = Yamux(ca, initiator=True)
        ta = asyncio.ensure_future(ma.run())

        small_cap = 64 * 1024  # << the 600 KiB read
        orig_cap = yamux.MAX_STREAM_BUFFER
        yamux.MAX_STREAM_BUFFER = small_cap
        try:
            s = await ma.open_stream()
            s.write(b"z" * (600 * 1024))  # > initial window AND > cap
            await asyncio.wait_for(s.drain(), 10)
            await _until(lambda: "data" in got)
            assert got["data"] == b"z" * (600 * 1024)
        finally:
            yamux.MAX_STREAM_BUFFER = orig_cap
            ca.close()
            await asyncio.gather(ta, tb, return_exceptions=True)

    asyncio.run(asyncio.wait_for(scenario(), 30))
