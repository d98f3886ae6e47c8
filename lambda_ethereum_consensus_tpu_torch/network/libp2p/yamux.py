"""/yamux/1.0.0 stream multiplexing (the yamux spec go-libp2p prefers).

The reference's go-libp2p host lists yamux ahead of mplex (ref:
native/libp2p_port/internal/reqresp/reqresp.go:32-41), and current
mainnet peers overwhelmingly negotiate it — without this muxer the real
wire mode fails stream muxing with most of the live network.

Frame header — 12 bytes, big-endian::

    version(1)=0 | type(1) | flags(2) | stream_id(4) | length(4)

Types: 0 Data, 1 WindowUpdate, 2 Ping, 3 GoAway.  Flags: 0x1 SYN,
0x2 ACK, 0x4 FIN, 0x8 RST.  Stream ids are odd for the connection
initiator and even for the responder (so the two id spaces never
collide — unlike mplex, no initiator/receiver flag variants needed).

Flow control: data consumes the receiver's window (256 KiB initial);
``WindowUpdate`` frames return capacity.  This implementation grants the
window back as data arrives while the stream's buffer stays small (the
eth2 req/resp exchange reads streams to EOF immediately, so deferring
grants until application reads would only add latency) — but once a
stream buffers more than ``MAX_STREAM_BUFFER`` un-read bytes, further
grants are DEFERRED until a reader drains the buffer, so a peer cannot
park unbounded memory in streams nobody reads.  Data beyond the granted
window is a protocol violation and kills the session (go-yamux does the
same).  On send we respect the peer's window, blocking until an update
arrives.

Accept ACK: go-yamux only releases the opener's accept-backlog slot when
the first response frame carries FLAG_ACK, and tears the WHOLE session
down when its StreamOpenTimeout fires on an un-ACKed stream — so every
inbound SYN is answered with an immediate zero-length WindowUpdate+ACK
(gossipsub streams are one-directional; waiting to piggyback the ACK on
a data frame would mean never sending it).

Half-close: FIN ends our sending direction — the peer's reader sees EOF
while ours stays open, exactly the ``write request, close_write, read
response`` discipline eth2 req/resp needs.  RST kills both directions.
``Ping`` echoes with ACK; ``GoAway`` tears the session down.

The stream object is interface-compatible with ``MplexStream``
(readexactly/read_all/write/drain/close_write/reset), so multistream,
gossipsub and req/resp run unchanged over either muxer.

The port's copy of the JAX package's ``network/libp2p/yamux.py``; the
bytes it puts on the wire are the JAX module's.
"""

from __future__ import annotations

import asyncio
import struct

from ..noise import NoiseError
from . import varint
from .mplex import MplexError

TYPE_DATA = 0
TYPE_WINDOW = 1
TYPE_PING = 2
TYPE_GOAWAY = 3

FLAG_SYN = 0x1
FLAG_ACK = 0x2
FLAG_FIN = 0x4
FLAG_RST = 0x8

INITIAL_WINDOW = 256 * 1024
MAX_FRAME_DATA = 1 << 20  # sanity bound well above any window grant
# un-read bytes a stream may buffer before window grants are deferred
MAX_STREAM_BUFFER = 4 * 1024 * 1024

_HEADER = struct.Struct(">BBHII")


class YamuxError(MplexError):
    """Subclasses MplexError so every muxer-failure catch site (host,
    gossipsub, req/resp, sidecar) handles both muxers uniformly."""


def encode_frame(typ: int, flags: int, stream_id: int, length: int,
                 data: bytes = b"") -> bytes:
    return _HEADER.pack(0, typ, flags, stream_id, length) + data


class YamuxStream:
    """One bidirectional stream; same surface as ``MplexStream``."""

    def __init__(self, muxer: "Yamux", stream_id: int, we_initiated: bool):
        self._muxer = muxer
        self.stream_id = stream_id
        self._we_initiated = we_initiated
        self._buf = bytearray()
        self._eof = False
        self._reset = False
        self._local_closed = False
        self._recv_event = asyncio.Event()
        self._out = bytearray()
        self._send_window = INITIAL_WINDOW
        self._window_event = asyncio.Event()
        self._sent_syn = False
        # receiver-side flow control: what we have granted minus what the
        # peer has sent; grants deferred while _buf is over the cap
        self._recv_window = INITIAL_WINDOW
        self._deferred_grant = 0

    # -- feeding (called by the muxer read loop) --------------------------
    def _feed(self, data: bytes) -> None:
        self._buf += data
        self._recv_event.set()

    def _consume_recv_window(self, n: int) -> None:
        if n > self._recv_window:
            raise YamuxError(
                f"stream {self.stream_id}: peer overran receive window "
                f"({n} > {self._recv_window})"
            )
        self._recv_window -= n
        self._deferred_grant += n

    def _grant_due(self) -> int:
        """Window to hand back now: everything consumed, unless the
        buffer is over the cap (then grants wait for a reader)."""
        if len(self._buf) > MAX_STREAM_BUFFER or not self._deferred_grant:
            return 0
        due, self._deferred_grant = self._deferred_grant, 0
        self._recv_window += due
        return due

    def _flush_grants(self) -> None:
        """Called after a reader drained ``_buf``: release deferred
        grants (fire-and-forget; the send lock serializes frames)."""
        due = self._grant_due()
        if due and not self._muxer._closed:

            async def _grant():
                try:
                    await self._muxer._send(
                        encode_frame(TYPE_WINDOW, 0, self.stream_id, due)
                    )
                except (ConnectionError, OSError, YamuxError):
                    pass  # connection died mid-grant; run() tears down

            asyncio.ensure_future(_grant())

    def _feed_eof(self) -> None:
        self._eof = True
        self._recv_event.set()
        self._maybe_finished()

    def _maybe_finished(self) -> None:
        if self._eof and self._local_closed:
            self._muxer._drop(self.stream_id)

    def _feed_reset(self) -> None:
        self._reset = True
        self._eof = True
        self._recv_event.set()
        self._window_event.set()

    def _grow_window(self, delta: int) -> None:
        self._send_window += delta
        self._window_event.set()

    # -- reader side ------------------------------------------------------
    async def readexactly(self, n: int) -> bytes:
        """Drains ``_buf`` incrementally (like ``read_all``) so a read
        larger than MAX_STREAM_BUFFER keeps granting window as it
        consumes — waiting for the full ``n`` to buffer first would
        deadlock against the grant deferral."""
        out = bytearray()
        while len(out) < n:
            if self._buf:
                take = min(n - len(out), len(self._buf))
                out += self._buf[:take]
                del self._buf[:take]
                self._flush_grants()
                continue
            if self._reset:
                raise YamuxError("stream reset by peer")
            if self._eof:
                raise asyncio.IncompleteReadError(bytes(out), n)
            self._recv_event.clear()
            await self._recv_event.wait()
        return bytes(out)

    async def read_all(self) -> bytes:
        """Read until the peer half-closes (the req/resp response read).

        Drains ``_buf`` into the local accumulator on every wake so the
        stream buffer (and with it the window-grant deferral) stays
        small during large responses."""
        out = bytearray()
        while not self._eof:
            if self._buf:
                out += self._buf
                self._buf.clear()
                self._flush_grants()
            self._recv_event.clear()
            await self._recv_event.wait()
        if self._reset:
            raise YamuxError("stream reset by peer")
        out += self._buf
        self._buf.clear()
        return bytes(out)

    # -- writer side ------------------------------------------------------
    def write(self, data: bytes) -> None:
        self._out += data

    def _syn_flag(self) -> int:
        if self._we_initiated and not self._sent_syn:
            self._sent_syn = True
            return FLAG_SYN
        return 0

    async def drain(self) -> None:
        if self._reset or self._muxer._closed:
            raise YamuxError("stream reset or connection closed")
        data, self._out = bytes(self._out), bytearray()
        off = 0
        while off < len(data):
            # respect the peer's receive window; block for WindowUpdate
            while self._send_window <= 0:
                if self._reset or self._muxer._closed:
                    raise YamuxError("stream reset while awaiting window")
                self._window_event.clear()
                await self._window_event.wait()
            n = min(len(data) - off, self._send_window, MAX_FRAME_DATA)
            chunk = data[off : off + n]
            self._send_window -= n
            await self._muxer._send(
                encode_frame(TYPE_DATA, self._syn_flag(), self.stream_id,
                             len(chunk), chunk)
            )
            off += n

    async def close_write(self) -> None:
        """Half-close: peer's reader sees EOF, our reader stays open."""
        await self.drain()
        await self._muxer._send(
            encode_frame(TYPE_DATA, FLAG_FIN | self._syn_flag(),
                         self.stream_id, 0)
        )
        self._local_closed = True
        self._maybe_finished()

    async def reset(self) -> None:
        await self._muxer._send(
            encode_frame(TYPE_WINDOW, FLAG_RST, self.stream_id, 0)
        )
        self._muxer._drop(self.stream_id)
        self._feed_reset()


class Yamux:
    """Muxer over a secured channel (anything with readexactly/write/drain).

    ``initiator`` decides the stream-id parity: odd ids for the side that
    dialed the connection, even for the accepter (yamux spec §streamids).
    """

    # go-yamux's keepalive defaults: a ping every 30 s, session torn
    # down when one goes unanswered for the connection-write timeout
    KEEPALIVE_INTERVAL_S = 30.0
    KEEPALIVE_TIMEOUT_S = 10.0

    # GoAway codes (yamux spec §goaway)
    GOAWAY_NORMAL = 0
    GOAWAY_PROTOCOL_ERROR = 1
    GOAWAY_INTERNAL_ERROR = 2

    def __init__(
        self,
        channel,
        on_stream=None,
        initiator: bool = True,
        keepalive_s: float | None = None,
    ):
        self._channel = channel
        self._on_stream = on_stream  # async callback(YamuxStream)
        self._initiator = initiator
        self._next_id = 1 if initiator else 2
        self._streams: dict[int, YamuxStream] = {}
        self._send_lock = asyncio.Lock()
        self._closed = False
        # outbound ping bookkeeping: opaque value -> waiter future (the
        # spec rides the opaque value in the length field; the ACK MUST
        # echo it, so responses match their pings by value)
        self._ping_counter = 0
        self._ping_waiters: dict[int, asyncio.Future] = {}
        self._keepalive_s = keepalive_s
        self._keepalive_task: asyncio.Task | None = None
        # set on receiving GoAway: no NEW streams after it (spec MUST);
        # a normal (code 0) GoAway lets in-flight streams finish, any
        # error code tears the session down immediately
        self.remote_goaway: int | None = None
        self._sent_goaway = False

    async def _send(self, frame: bytes) -> None:
        async with self._send_lock:
            self._channel.write(frame)
            await self._channel.drain()

    def _drop(self, stream_id: int) -> None:
        self._streams.pop(stream_id, None)

    # -- keepalive / ping -------------------------------------------------

    async def ping(self, timeout: float | None = None) -> float:
        """One outbound keepalive ping; returns the RTT.  The opaque
        value (length field) must come back verbatim in the ACK — a
        mismatched ACK simply never resolves this waiter and the timeout
        raises, which is what kills a half-dead session."""
        if self._closed:
            raise YamuxError("session closed")
        self._ping_counter = (self._ping_counter + 1) & 0xFFFFFFFF
        opaque = self._ping_counter
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._ping_waiters[opaque] = fut

        async def send_and_wait():
            # the SEND is inside the timeout too: a dead path with a
            # backed-up socket buffer blocks in drain() and would hang
            # the keepalive before ever waiting on the ACK (go-yamux's
            # connection-write timeout covers the same case)
            await self._send(encode_frame(TYPE_PING, FLAG_SYN, 0, opaque))
            await fut

        t0 = asyncio.get_running_loop().time()
        try:
            await asyncio.wait_for(
                send_and_wait(),
                self.KEEPALIVE_TIMEOUT_S if timeout is None else timeout,
            )
        finally:
            self._ping_waiters.pop(opaque, None)
        return asyncio.get_running_loop().time() - t0

    async def _keepalive_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self._keepalive_s)
            try:
                await self.ping()
            except (asyncio.TimeoutError, YamuxError, ConnectionError, OSError):
                # an unanswered keepalive means the transport is dead in
                # at least one direction: close the channel so run()'s
                # read loop tears the whole session down (go-yamux's
                # keepalive failure path)
                close = getattr(self._channel, "close", None)
                if close is not None:
                    result = close()
                    if asyncio.iscoroutine(result):
                        await result
                self._closed = True
                return

    # -- goaway -----------------------------------------------------------

    async def goaway(self, code: int = GOAWAY_NORMAL) -> None:
        """Announce session shutdown (spec: sent on intentional close so
        the peer distinguishes shutdown from a dead TCP path)."""
        if self._sent_goaway:
            return
        self._sent_goaway = True
        await self._send(encode_frame(TYPE_GOAWAY, 0, 0, code))

    async def open_stream(self, name: str = "") -> YamuxStream:
        if self.remote_goaway is not None or self._sent_goaway or self._closed:
            # spec MUST: no new streams once either side said GoAway
            raise YamuxError("session is going away; refusing new stream")
        stream_id = self._next_id
        self._next_id += 2
        stream = YamuxStream(self, stream_id, we_initiated=True)
        self._streams[stream_id] = stream
        # announce with an empty window update carrying SYN (go-yamux's
        # form); the first data frame would also carry SYN if this were
        # lost — both forms are accepted inbound
        stream._sent_syn = True
        await self._send(encode_frame(TYPE_WINDOW, FLAG_SYN, stream_id, 0))
        return stream

    async def run(self) -> None:
        """Read loop: dispatch frames until the channel dies."""
        if self._keepalive_s is not None and self._keepalive_task is None:
            self._keepalive_task = asyncio.ensure_future(self._keepalive_loop())
        try:
            while True:
                head = await self._channel.readexactly(_HEADER.size)
                version, typ, flags, stream_id, length = _HEADER.unpack(head)
                if version != 0:
                    raise YamuxError(f"unknown yamux version {version}")
                if typ == TYPE_DATA:
                    if length > MAX_FRAME_DATA:
                        raise YamuxError(f"oversized data frame ({length})")
                    data = await self._channel.readexactly(length) if length else b""
                    await self._dispatch_data(stream_id, flags, data)
                elif typ == TYPE_WINDOW:
                    await self._dispatch_window(stream_id, flags, length)
                elif typ == TYPE_PING:
                    if flags & FLAG_ACK:
                        # ACK to one of OUR pings: resolve its waiter by
                        # the echoed opaque value; an unknown value is a
                        # stale/forged ACK and resolves nothing (the
                        # waiting ping then times out — spec: the ACK
                        # MUST carry the ping's opaque value)
                        waiter = self._ping_waiters.get(length)
                        if waiter is not None and not waiter.done():
                            waiter.set_result(None)
                        continue
                    await self._send(
                        encode_frame(TYPE_PING, FLAG_ACK, 0, length)
                    )
                elif typ == TYPE_GOAWAY:
                    self.remote_goaway = length
                    if length != self.GOAWAY_NORMAL:
                        return  # error goaway: session-fatal immediately
                    # normal termination: no NEW streams (open_stream
                    # refuses now), but in-flight streams drain until
                    # the peer closes the transport
                    continue
                else:
                    raise YamuxError(f"unknown yamux frame type {typ}")
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            YamuxError,
            varint.VarintError,
            NoiseError,
        ):
            pass  # connection dead or peer spoke garbage: tear down
        finally:
            self._closed = True
            if self._keepalive_task is not None:
                self._keepalive_task.cancel()
            for waiter in self._ping_waiters.values():
                if not waiter.done():
                    waiter.set_exception(YamuxError("session closed"))
            for stream in list(self._streams.values()):
                stream._feed_reset()

    async def _get_or_open(self, stream_id: int, flags: int) -> YamuxStream | None:
        stream = self._streams.get(stream_id)
        if stream is None and flags & FLAG_SYN:
            if self._sent_goaway or self.remote_goaway is not None:
                # going away: a racing inbound SYN is refused with RST
                # instead of silently accumulating post-goaway streams
                await self._send(
                    encode_frame(TYPE_WINDOW, FLAG_RST, stream_id, 0)
                )
                return None
            if stream_id % 2 == (1 if self._initiator else 0):
                # a SYN in OUR id space would later collide with
                # open_stream and clobber the entry — protocol violation,
                # session-fatal (go-yamux rejects wrong-parity SYNs too)
                raise YamuxError(
                    f"peer opened stream {stream_id} with our id parity"
                )
            stream = YamuxStream(self, stream_id, we_initiated=False)
            self._streams[stream_id] = stream
            # immediate accept-ACK: go-yamux frees its accept-backlog slot
            # (and arms StreamOpenTimeout session teardown) on this flag,
            # and inbound gossipsub streams may never see a response frame
            # to piggyback it on
            await self._send(
                encode_frame(TYPE_WINDOW, FLAG_ACK, stream_id, 0)
            )
            if self._on_stream is not None:
                asyncio.ensure_future(self._on_stream(stream))
        return stream

    async def _dispatch_data(self, stream_id: int, flags: int, data: bytes) -> None:
        stream = await self._get_or_open(stream_id, flags)
        if stream is None:
            return  # unknown/already-reset stream: drop silently
        if flags & FLAG_RST:
            self._drop(stream_id)
            stream._feed_reset()
            return
        if data:
            # window accounting: overrun is session-fatal (YamuxError
            # propagates to run()'s teardown), grants deferred while the
            # stream buffers over MAX_STREAM_BUFFER un-read bytes
            stream._consume_recv_window(len(data))
            stream._feed(data)
            due = stream._grant_due()
            if due:
                await self._send(
                    encode_frame(TYPE_WINDOW, 0, stream_id, due)
                )
        if flags & FLAG_FIN:
            stream._feed_eof()

    async def _dispatch_window(self, stream_id: int, flags: int, delta: int) -> None:
        stream = await self._get_or_open(stream_id, flags)
        if stream is None:
            return
        if flags & FLAG_RST:
            self._drop(stream_id)
            stream._feed_reset()
            return
        if delta:
            stream._grow_window(delta)
        if flags & FLAG_FIN:
            stream._feed_eof()
