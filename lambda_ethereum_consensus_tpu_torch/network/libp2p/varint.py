"""Unsigned LEB128 varints — the one integer encoding every libp2p
layer shares (multistream lengths, mplex headers, pubsub RPC delimiters,
protobuf fields).  Single source of truth for the package.

The port's copy of the JAX package's ``network/libp2p/varint.py``; the
bytes it puts on the wire are the JAX module's.
"""

from __future__ import annotations


class VarintError(Exception):
    pass


def encode(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode(data: bytes, pos: int = 0, max_shift: int = 63) -> tuple[int, int]:
    """Sync decode from a buffer; returns (value, next_pos)."""
    shift = n = 0
    while True:
        if pos >= len(data):
            raise VarintError("truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > max_shift:
            raise VarintError("varint too long")


async def read(reader, max_shift: int = 63) -> int:
    """Async decode from anything with ``readexactly``."""
    shift = n = 0
    while True:
        b = (await reader.readexactly(1))[0]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n
        shift += 7
        if shift > max_shift:
            raise VarintError("varint too long")
