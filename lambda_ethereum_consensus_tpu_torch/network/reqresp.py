"""Eth2 req/resp protocols: ssz_snappy framing, client and server.

Framing per the consensus p2p spec (and ref: lib/.../p2p/block_downloader.ex
request/response handling + incoming_requests/handler.ex):

- request payload:  ``varint(len(ssz)) || snappy_frames(ssz)``
- response payload: chunks of ``result_byte || [context] || varint || frames``

The server side answers from live chain state (the reference hardcodes status/
metadata responses — ref: incoming_requests/handler.ex:18-41 — noted as a gap
in SURVEY.md §7 stage 7; here a ``ChainView`` supplies real values).

The port's copy of the JAX package's ``network/reqresp.py``; its requests and
response chunks are the JAX package's, byte for byte.  ``ReqRespError``
derives from ``faults.WireError``: still a ``RuntimeError``, never a device
fault.
"""

from __future__ import annotations

from typing import Protocol

from ..compression import SnappyError, frame_compress, frame_decompress
from ..compression.snappy import _read_varint as _snappy_read_varint
from ..compression.snappy import _write_varint, read_frame_chunk
from ..config import ChainSpec, get_chain_spec
from ..faults import WireError
from ..types.beacon import SignedBeaconBlock
from ..types.p2p import (
    BeaconBlocksByRangeRequest,
    BeaconBlocksByRootRequest,
    Metadata,
    StatusMessage,
)
from .port import Port, PortError

PROTOCOL_PREFIX = "/eth2/beacon_chain/req"
STATUS = f"{PROTOCOL_PREFIX}/status/1/ssz_snappy"
GOODBYE = f"{PROTOCOL_PREFIX}/goodbye/1/ssz_snappy"
PING = f"{PROTOCOL_PREFIX}/ping/1/ssz_snappy"
METADATA_PROTOCOL = f"{PROTOCOL_PREFIX}/metadata/2/ssz_snappy"
BLOCKS_BY_RANGE = f"{PROTOCOL_PREFIX}/beacon_blocks_by_range/2/ssz_snappy"
BLOCKS_BY_ROOT = f"{PROTOCOL_PREFIX}/beacon_blocks_by_root/2/ssz_snappy"

SUCCESS = 0
ERROR_INVALID_REQUEST = 1
ERROR_SERVER_ERROR = 2
ERROR_RESOURCE_UNAVAILABLE = 3

MAX_REQUEST_BLOCKS = 1024


class ReqRespError(WireError):
    pass


# ------------------------------------------------------------------ framing

def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    try:
        return _snappy_read_varint(data, pos)
    except SnappyError as e:
        raise ReqRespError(str(e)) from None


def encode_request(ssz_bytes: bytes) -> bytes:
    return _write_varint(len(ssz_bytes)) + frame_compress(ssz_bytes)


def decode_request(payload: bytes) -> bytes:
    length, pos = _read_varint(payload, 0)
    try:
        data = frame_decompress(payload[pos:])
    except SnappyError as e:
        raise ReqRespError(f"bad snappy body: {e}") from None
    if len(data) != length:
        raise ReqRespError(f"length prefix {length} != body {len(data)}")
    return data


def encode_response_chunk(
    result: int, ssz_bytes: bytes, context: bytes = b""
) -> bytes:
    return (
        bytes([result]) + context + _write_varint(len(ssz_bytes)) + frame_compress(ssz_bytes)
    )


def decode_response_chunks(
    payload: bytes, context_bytes: int = 0
) -> list[tuple[int, bytes, bytes]]:
    """Split a response into ``(result, context, ssz_bytes)`` chunks.

    Mirrors how a stream reader consumes the wire: after the varint length,
    snappy frames are decoded one at a time until exactly that many
    decompressed bytes have been produced — so chunk boundaries are exact,
    not guessed.
    """
    out = []
    pos = 0
    n = len(payload)
    while pos < n:
        result = payload[pos]
        pos += 1
        context = b""
        if result == SUCCESS and context_bytes:
            context = payload[pos : pos + context_bytes]
            pos += context_bytes
        length, pos = _read_varint(payload, pos)
        data, pos = _read_snappy_frames(payload, pos, length)
        out.append((result, context, data))
    return out


_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"


def _read_snappy_frames(payload: bytes, pos: int, length: int) -> tuple[bytes, int]:
    """Consume snappy frames until ``length`` decompressed bytes are read."""
    if payload[pos : pos + len(_STREAM_ID)] != _STREAM_ID:
        raise ReqRespError("missing snappy stream identifier in chunk")
    pos += len(_STREAM_ID)
    out = bytearray()
    n = len(payload)
    # frame_compress always emits at least one data chunk, even for empty
    # payloads — consume it so a zero-length body doesn't desync the stream
    consumed_data_chunk = False
    while len(out) < length or not consumed_data_chunk:
        if pos >= n and length == 0:
            break  # tolerate encoders that emit nothing for empty bodies
        try:
            piece, pos = read_frame_chunk(payload, pos)
        except SnappyError as e:
            raise ReqRespError(str(e)) from None
        if piece is not None:
            out += piece
            consumed_data_chunk = True
    if len(out) != length:
        raise ReqRespError("chunk produced more data than declared")
    return bytes(out), pos


# ---------------------------------------------------------------- chain view

class ChainView(Protocol):
    """What the server needs from the node (status/blocks/metadata)."""

    def status(self) -> StatusMessage: ...

    def metadata(self) -> Metadata: ...

    def block_by_slot(self, slot: int) -> SignedBeaconBlock | None: ...

    def block_by_root(self, root: bytes) -> SignedBeaconBlock | None: ...


# -------------------------------------------------------------------- server

class ReqRespServer:
    """Serves the five eth2 req/resp protocols from live chain state
    (ref: p2p/incoming_requests/{receiver.ex,handler.ex})."""

    def __init__(self, port: Port, chain: ChainView, spec: ChainSpec | None = None):
        self.port = port
        self.chain = chain
        self.spec = spec or get_chain_spec()

    async def register(self) -> None:
        for protocol in (STATUS, GOODBYE, PING, METADATA_PROTOCOL, BLOCKS_BY_RANGE, BLOCKS_BY_ROOT):
            await self.port.set_request_handler(protocol, self.handle)

    async def handle(self, protocol_id, request_id, payload, peer_id) -> None:
        try:
            response = self._respond(protocol_id, payload)
        except ReqRespError as e:
            response = encode_response_chunk(
                ERROR_INVALID_REQUEST, (str(e) or "invalid request").encode()
            )
        except Exception as e:  # never kill the server on bad input
            response = encode_response_chunk(
                ERROR_SERVER_ERROR, (str(e) or type(e).__name__).encode()
            )
        try:
            await self.port.send_response(request_id, response)
        except PortError:
            pass

    def _respond(self, protocol_id: str, payload: bytes) -> bytes:
        spec = self.spec
        if protocol_id == STATUS:
            decode_request(payload)  # validate peer's status
            return encode_response_chunk(
                SUCCESS, self.chain.status().encode(spec)
            )
        if protocol_id == PING:
            decode_request(payload)
            seq = self.chain.metadata().seq_number
            return encode_response_chunk(SUCCESS, int(seq).to_bytes(8, "little"))
        if protocol_id == GOODBYE:
            decode_request(payload)
            return encode_response_chunk(SUCCESS, (0).to_bytes(8, "little"))
        if protocol_id == METADATA_PROTOCOL:
            return encode_response_chunk(SUCCESS, self.chain.metadata().encode(spec))
        if protocol_id == BLOCKS_BY_RANGE:
            req = BeaconBlocksByRangeRequest.decode(decode_request(payload), spec)
            count = min(req.count, MAX_REQUEST_BLOCKS)
            step = max(req.step, 1)
            chunks = bytearray()
            digest = _fork_digest(spec, self.chain)
            for i in range(count):
                block = self.chain.block_by_slot(req.start_slot + i * step)
                if block is not None:
                    chunks += encode_response_chunk(
                        SUCCESS, block.encode(spec), context=digest
                    )
            return bytes(chunks)
        if protocol_id == BLOCKS_BY_ROOT:
            body = decode_request(payload)
            req = BeaconBlocksByRootRequest.decode(body, spec)
            chunks = bytearray()
            digest = _fork_digest(spec, self.chain)
            for root in req.body[:MAX_REQUEST_BLOCKS]:
                block = self.chain.block_by_root(bytes(root))
                if block is not None:
                    chunks += encode_response_chunk(
                        SUCCESS, block.encode(spec), context=digest
                    )
            return bytes(chunks)
        raise ReqRespError(f"unknown protocol {protocol_id}")


def _fork_digest(spec: ChainSpec, chain: ChainView) -> bytes:
    return bytes(chain.status().fork_digest)


# -------------------------------------------------------------------- client

class BlockDownloader:
    """Range/root block fetcher with retry + peer rotation
    (ref: p2p/block_downloader.ex:18-209)."""

    def __init__(self, port: Port, peerbook, spec: ChainSpec | None = None, retries: int = 5):
        self.port = port
        self.peerbook = peerbook
        self.spec = spec or get_chain_spec()
        self.retries = retries

    async def request_blocks_by_range(
        self, start_slot: int, count: int
    ) -> list[SignedBeaconBlock]:
        req = BeaconBlocksByRangeRequest(start_slot=start_slot, count=count, step=1)
        payload = encode_request(req.encode(self.spec))
        return await self._request_with_retries(BLOCKS_BY_RANGE, payload)

    async def request_blocks_by_root(self, roots: list[bytes]) -> list[SignedBeaconBlock]:
        req = BeaconBlocksByRootRequest(body=list(roots))
        payload = encode_request(req.encode(self.spec))
        return await self._request_with_retries(BLOCKS_BY_ROOT, payload)

    async def _request_with_retries(self, protocol: str, payload: bytes):
        last_error: Exception | None = None
        for _ in range(self.retries):
            peer_id = self.peerbook.get_some_peer()
            if peer_id is None:
                raise ReqRespError("no peers available")
            try:
                raw = await self.port.send_request(peer_id, protocol, payload)
                chunks = decode_response_chunks(raw, context_bytes=4)
                blocks = []
                for result, _context, data in chunks:
                    if result != SUCCESS:
                        raise ReqRespError(f"peer error chunk: {data[:80]!r}")
                    blocks.append(SignedBeaconBlock.decode(data, self.spec))
                self.peerbook.reward(peer_id)
                return blocks
            except (PortError, ReqRespError, SnappyError, ValueError) as e:
                last_error = e
                self.peerbook.penalize(peer_id)
        raise ReqRespError(f"all retries failed: {last_error}")


# -------------------------------------------------------------------- pinger

async def ping_peer(port: Port, peer_id: bytes, seq: int = 0) -> int:
    """Send a ping, return the peer's metadata seq number."""
    payload = encode_request(int(seq).to_bytes(8, "little"))
    raw = await port.send_request(peer_id, PING, payload)
    chunks = decode_response_chunks(raw)
    if not chunks:
        raise ReqRespError("empty ping response")
    result, _, data = chunks[0]
    if result != SUCCESS:
        raise ReqRespError("ping failed")
    return int.from_bytes(data, "little")
