"""Snappy block + frame formats (spec: google/snappy format description).

The port's copy of the JAX package's ``compression/snappy.py``, unchanged in
behaviour.  Raw block format: a varint uncompressed-length preamble, then a
tag stream of literals and back-references (copy1/copy2/copy4).  The
compressor is a greedy 4-gram hash matcher over 64 KiB fragments emitting
copy2 ops: modest ratios, spec-exact output; the decompressor handles every
element type, so data from any conformant compressor round-trips.

Frame format: ``sNaPpY`` stream identifier + compressed/uncompressed chunks,
each carrying a masked CRC32C of the uncompressed payload.
"""

from __future__ import annotations

__all__ = [
    "SnappyError",
    "compress",
    "decompress",
    "frame_compress",
    "frame_decompress",
]


class SnappyError(ValueError):
    """Corrupt snappy input."""


# ----------------------------------------------------------------- varint

def _write_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


# ------------------------------------------------------------ block format

_FRAGMENT = 65536
_MIN_MATCH = 4


def _emit_literal(out: bytearray, data: bytes, start: int, end: int) -> None:
    n = end - start
    while n > 0:
        chunk = min(n, 0x10000)  # 4-byte length form caps far higher; keep simple
        if chunk - 1 < 60:
            out.append((chunk - 1) << 2)
        elif chunk - 1 < 0x100:
            out.append(60 << 2)
            out.append(chunk - 1)
        else:
            out.append(61 << 2)
            out += (chunk - 1).to_bytes(2, "little")
        out += data[start : start + chunk]
        start += chunk
        n -= chunk


def _emit_copy2(out: bytearray, offset: int, length: int) -> None:
    # copy2 length range is 1..64 per op
    while length > 64:
        out.append(((64 - 1) << 2) | 2)
        out += offset.to_bytes(2, "little")
        length -= 64
    if length:
        out.append(((length - 1) << 2) | 2)
        out += offset.to_bytes(2, "little")


def _compress_fragment(data: bytes, base: int, end: int, out: bytearray) -> None:
    table: dict[bytes, int] = {}
    pos = base
    literal_start = base
    while pos + _MIN_MATCH <= end:
        gram = data[pos : pos + _MIN_MATCH]
        cand = table.get(gram)
        table[gram] = pos
        if cand is not None and pos - cand <= 0xFFFF:
            # extend the match forward
            length = _MIN_MATCH
            while (
                pos + length < end
                and length < 1024
                and data[cand + length] == data[pos + length]
            ):
                length += 1
            if literal_start < pos:
                _emit_literal(out, data, literal_start, pos)
            _emit_copy2(out, pos - cand, length)
            pos += length
            literal_start = pos
        else:
            pos += 1
    if literal_start < end:
        _emit_literal(out, data, literal_start, end)


def compress(data: bytes) -> bytes:
    """Raw snappy block of ``data``."""
    data = bytes(data)
    out = bytearray(_write_varint(len(data)))
    for frag in range(0, len(data), _FRAGMENT):
        _compress_fragment(data, frag, min(frag + _FRAGMENT, len(data)), out)
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decode a raw snappy block (all element types)."""
    expected, pos = _read_varint(bytes(data), 0)
    out = bytearray()
    data = bytes(data)
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length < 60:
                length += 1
            else:
                extra = length - 59
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy with 1-byte offset extension
            length = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise SnappyError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy with 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy with 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("copy offset out of range")
        start = len(out) - offset
        if offset >= length:  # non-overlapping: bulk slice copy
            out += out[start : start + length]
        else:  # overlapping copies are byte-at-a-time semantics
            for i in range(length):
                out.append(out[start + i])
    if len(out) != expected:
        raise SnappyError(
            f"decompressed length {len(out)} != preamble {expected}"
        )
    return bytes(out)


# ------------------------------------------------------------------ crc32c

def _make_crc32c_table() -> list[int]:
    poly = 0x82F63B78  # reflected Castagnoli
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ frame format

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_FRAME_MAX = 65536


def frame_compress(data: bytes) -> bytes:
    """Framed snappy stream (the eth2 req/resp ``ssz_snappy`` encoding)."""
    out = bytearray(_STREAM_ID)
    data = bytes(data)
    starts = range(0, len(data), _FRAME_MAX) if data else [0]
    for start in starts:
        chunk = data[start : start + _FRAME_MAX]
        body = _masked_crc(chunk).to_bytes(4, "little") + compress(chunk)
        out.append(_CHUNK_COMPRESSED)
        out += len(body).to_bytes(3, "little")
        out += body
    return bytes(out)


def read_frame_chunk(data: bytes, pos: int) -> tuple[bytes | None, int]:
    """Parse one frame chunk at ``pos``: ``(payload | None, new_pos)``.

    ``None`` payload means the chunk carried no data (repeated stream id or a
    skippable chunk, types 0x80-0xFE per the framing spec).  The single chunk
    parser shared by :func:`frame_decompress` and the req/resp stream reader.
    """
    n = len(data)
    if pos + 4 > n:
        raise SnappyError("truncated chunk header")
    ctype = data[pos]
    length = int.from_bytes(data[pos + 1 : pos + 4], "little")
    pos += 4
    if pos + length > n:
        raise SnappyError("truncated chunk body")
    body = data[pos : pos + length]
    pos += length
    if ctype in (_CHUNK_COMPRESSED, _CHUNK_UNCOMPRESSED):
        if length < 4:
            raise SnappyError("chunk too short for checksum")
        want_crc = int.from_bytes(body[:4], "little")
        payload = (
            decompress(body[4:]) if ctype == _CHUNK_COMPRESSED else bytes(body[4:])
        )
        if _masked_crc(payload) != want_crc:
            raise SnappyError("chunk checksum mismatch")
        return payload, pos
    if ctype == 0xFF:
        if body != _STREAM_ID[4:]:
            raise SnappyError("bad repeated stream identifier")
        return None, pos
    if 0x80 <= ctype <= 0xFE:
        return None, pos  # skippable chunk types
    raise SnappyError(f"unknown chunk type {ctype:#x}")


def frame_decompress(data: bytes) -> bytes:
    data = bytes(data)
    if not data.startswith(_STREAM_ID):
        raise SnappyError("missing snappy stream identifier")
    pos = len(_STREAM_ID)
    out = bytearray()
    while pos < len(data):
        payload, pos = read_frame_chunk(data, pos)
        if payload is not None:
            out += payload
    return bytes(out)
