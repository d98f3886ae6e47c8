"""Hashing substrate for SSZ Merkleization.

The Merkleization engine is written against a tiny backend protocol so the
same tree algorithm runs on either substrate:

- :class:`HashlibBackend` — host CPU via ``hashlib.sha256`` (the correctness
  oracle, analogous to the reference's Rust ``tree_hash`` crate backing
  ``Ssz.hash_tree_root`` — ref: native/ssz_nif/src/lib.rs:26-153).
- the CUDA backend in :mod:`lambda_ethereum_consensus_tpu_torch.ops.sha256` —
  whole Merkle levels hashed as one kernel launch (installed explicitly, so
  ``ssz`` imports without touching the card).

A backend hashes one full tree level at a time: ``(N, 64)`` parent blocks →
``(N, 32)`` digests.  That batched shape gives the card one thread per node,
and it is the only primitive Merkleization needs.
"""

from __future__ import annotations

import hashlib
from typing import Protocol

import numpy as np

__all__ = [
    "HashBackend",
    "HashlibBackend",
    "ZERO_HASHES",
    "get_hash_backend",
    "set_hash_backend",
    "sha256",
    "hash_pair",
]

MAX_MERKLE_DEPTH = 64


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hash_pair(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(left + right).digest()


def _build_zero_hashes() -> list[bytes]:
    zh = [b"\x00" * 32]
    for _ in range(MAX_MERKLE_DEPTH):
        zh.append(hash_pair(zh[-1], zh[-1]))
    return zh


#: ZERO_HASHES[d] = root of a depth-d subtree of all-zero chunks.
ZERO_HASHES: list[bytes] = _build_zero_hashes()


class HashBackend(Protocol):
    def hash_level(self, blocks: np.ndarray) -> np.ndarray:
        """Hash a Merkle level: ``(N, 64) uint8`` → ``(N, 32) uint8``."""
        ...


def hashlib_level(blocks: np.ndarray) -> np.ndarray:
    """Hash one Merkle level on host: ``(N, 64) uint8`` → ``(N, 32) uint8``."""
    n = blocks.shape[0]
    out = np.empty((n, 32), dtype=np.uint8)
    buf = blocks.tobytes()
    digest = hashlib.sha256
    for i in range(n):
        out[i] = np.frombuffer(digest(buf[i * 64 : i * 64 + 64]).digest(), np.uint8)
    return out


class HashlibBackend:
    """Host backend: per-node hashlib.sha256. Correctness oracle."""

    name = "hashlib"

    def hash_level(self, blocks: np.ndarray) -> np.ndarray:
        return hashlib_level(blocks)


_backend: HashBackend = HashlibBackend()


def get_hash_backend() -> HashBackend:
    return _backend


def set_hash_backend(backend: HashBackend) -> HashBackend:
    """Install a new default backend; returns the previous one."""
    global _backend
    prev, _backend = _backend, backend
    return prev
