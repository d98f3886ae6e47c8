"""Snappy compression, the port's copy of the JAX package's ``compression/``.

Pure Python, no device work: :mod:`.snappy` provides ``compress`` /
``decompress`` (the raw block format gossip payloads use) and
``frame_compress`` / ``frame_decompress`` (the framed format with masked
CRC32C that req/resp bodies use).  Its output is the JAX package's, byte for
byte (``tests/test_torch_snappy.py``).
"""

from .snappy import (
    SnappyError,
    compress,
    decompress,
    frame_compress,
    frame_decompress,
)

__all__ = [
    "SnappyError",
    "compress",
    "decompress",
    "frame_compress",
    "frame_decompress",
]
