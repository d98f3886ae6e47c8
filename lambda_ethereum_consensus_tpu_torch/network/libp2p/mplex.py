"""/mplex/6.7.0 stream multiplexing (mplex spec).

The muxer go-libp2p negotiates for the reference's host (ref:
reqresp.go:33-35 — ``libp2p.Muxer("/mplex/6.7.0", ...)``).  Frame format:

    varint(stream_id << 3 | flag) || varint(len) || data

Flags: NewStream=0, MessageReceiver=1, MessageInitiator=2,
CloseReceiver=3, CloseInitiator=4, ResetReceiver=5, ResetInitiator=6.
Stream IDs are scoped to their initiator; the Receiver/Initiator flag
variants disambiguate the two ID spaces on the wire.  ``Close`` is a
half-close (EOF to the other direction's reader); ``Reset`` kills both
directions — exactly the semantics eth2 req/resp relies on for its
"write request, CloseWrite, read response" exchange (reqresp.go:73-86).

The port's copy of the JAX package's ``network/libp2p/mplex.py``; the
bytes it puts on the wire are the JAX module's.
"""

from __future__ import annotations

import asyncio

NEW_STREAM = 0
MSG_RECEIVER = 1
MSG_INITIATOR = 2
CLOSE_RECEIVER = 3
CLOSE_INITIATOR = 4
RESET_RECEIVER = 5
RESET_INITIATOR = 6

MAX_MSG = 1 << 20  # go-mplex's default message-size cap


class MplexError(Exception):
    pass


from ..noise import NoiseError
from . import varint


def encode_frame(stream_id: int, flag: int, data: bytes = b"") -> bytes:
    return varint.encode(stream_id << 3 | flag) + varint.encode(len(data)) + data


class MplexStream:
    """One bidirectional stream; reader/writer interface compatible with
    the multistream + req/resp layers."""

    def __init__(self, muxer: "Mplex", stream_id: int, we_initiated: bool):
        self._muxer = muxer
        self.stream_id = stream_id
        self._we_initiated = we_initiated
        self._buf = bytearray()
        self._eof = False
        self._reset = False
        self._local_closed = False
        self._recv_event = asyncio.Event()
        self._out = bytearray()

    # -- feeding (called by the muxer read loop) --------------------------
    def _feed(self, data: bytes) -> None:
        self._buf += data
        self._recv_event.set()

    def _feed_eof(self) -> None:
        self._eof = True
        self._recv_event.set()
        self._maybe_finished()

    def _maybe_finished(self) -> None:
        # both half-closes seen: the muxer can forget the stream (the app
        # still holds the object and can drain the remaining buffer)
        if self._eof and self._local_closed:
            self._muxer._drop(self.stream_id, self._we_initiated)

    def _feed_reset(self) -> None:
        self._reset = True
        self._eof = True
        self._recv_event.set()

    # -- reader side ------------------------------------------------------
    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            if self._reset:
                raise MplexError("stream reset by peer")
            if self._eof:
                raise asyncio.IncompleteReadError(bytes(self._buf), n)
            self._recv_event.clear()
            await self._recv_event.wait()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def read_all(self) -> bytes:
        """Read until the peer half-closes (the req/resp response read)."""
        while not self._eof:
            self._recv_event.clear()
            await self._recv_event.wait()
        if self._reset:
            raise MplexError("stream reset by peer")
        out = bytes(self._buf)
        self._buf.clear()
        return out

    # -- writer side ------------------------------------------------------
    @property
    def _msg_flag(self) -> int:
        return MSG_INITIATOR if self._we_initiated else MSG_RECEIVER

    def write(self, data: bytes) -> None:
        self._out += data

    async def drain(self) -> None:
        # a reset/dead stream must FAIL the send, not blackhole it — the
        # gossipsub layer relies on this to drop peers whose meshsub
        # stream died (a silently-successful drain would leave them
        # grafted but unreachable forever)
        if self._reset or self._muxer._closed:
            raise MplexError("stream reset or connection closed")
        data, self._out = bytes(self._out), bytearray()
        for off in range(0, len(data), MAX_MSG):
            await self._muxer._send(
                encode_frame(self.stream_id, self._msg_flag, data[off : off + MAX_MSG])
            )

    async def close_write(self) -> None:
        """Half-close: peer's reader sees EOF, our reader stays open."""
        await self.drain()
        flag = CLOSE_INITIATOR if self._we_initiated else CLOSE_RECEIVER
        await self._muxer._send(encode_frame(self.stream_id, flag))
        self._local_closed = True
        self._maybe_finished()

    async def reset(self) -> None:
        flag = RESET_INITIATOR if self._we_initiated else RESET_RECEIVER
        await self._muxer._send(encode_frame(self.stream_id, flag))
        self._muxer._drop(self.stream_id, self._we_initiated)
        self._feed_reset()


class Mplex:
    """Muxer over a secured channel (anything with readexactly/write/drain)."""

    def __init__(self, channel, on_stream=None):
        self._channel = channel
        self._on_stream = on_stream  # async callback(MplexStream)
        self._next_id = 0
        self._ours: dict[int, MplexStream] = {}
        self._theirs: dict[int, MplexStream] = {}
        self._send_lock = asyncio.Lock()
        self._closed = False

    async def _send(self, frame: bytes) -> None:
        async with self._send_lock:
            self._channel.write(frame)
            await self._channel.drain()

    def _drop(self, stream_id: int, ours: bool) -> None:
        (self._ours if ours else self._theirs).pop(stream_id, None)

    async def open_stream(self, name: str = "") -> MplexStream:
        stream_id = self._next_id
        self._next_id += 1
        stream = MplexStream(self, stream_id, we_initiated=True)
        self._ours[stream_id] = stream
        await self._send(
            encode_frame(stream_id, NEW_STREAM, (name or str(stream_id)).encode())
        )
        return stream

    async def run(self) -> None:
        """Read loop: dispatch frames until the channel dies."""
        try:
            while True:
                header = await varint.read(self._channel)
                length = await varint.read(self._channel)
                if length > MAX_MSG:
                    raise MplexError(f"oversized mplex frame ({length})")
                data = await self._channel.readexactly(length) if length else b""
                await self._dispatch(header >> 3, header & 7, data)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            MplexError,
            varint.VarintError,
            NoiseError,
        ):
            pass  # connection dead or peer spoke garbage: tear down
        finally:
            self._closed = True
            for stream in [*self._ours.values(), *self._theirs.values()]:
                stream._feed_reset()

    async def _dispatch(self, stream_id: int, flag: int, data: bytes) -> None:
        if flag == NEW_STREAM:
            stream = MplexStream(self, stream_id, we_initiated=False)
            self._theirs[stream_id] = stream
            if self._on_stream is not None:
                asyncio.ensure_future(self._on_stream(stream))
            return
        # Receiver-flagged frames target streams WE initiated; Initiator-
        # flagged frames target streams THEY initiated.
        ours = flag in (MSG_RECEIVER, CLOSE_RECEIVER, RESET_RECEIVER)
        stream = (self._ours if ours else self._theirs).get(stream_id)
        if stream is None:
            return  # unknown/already-reset stream: drop silently
        if flag in (MSG_RECEIVER, MSG_INITIATOR):
            stream._feed(data)
        elif flag in (CLOSE_RECEIVER, CLOSE_INITIATOR):
            stream._feed_eof()
        elif flag in (RESET_RECEIVER, RESET_INITIATOR):
            self._drop(stream_id, ours)
            stream._feed_reset()
