"""Batched SHA-256 for SSZ Merkleization on the card (PyTorch + CUDA).

The Merkleization hot path reduces to one primitive: hash N independent
64-byte nodes, ``(N, 64) uint8 → (N, 32) uint8``.  Every node is a single
64-byte message, so SHA-256 is exactly two compressions — one over the data
block and one over a constant padding block whose message schedule
(``_PAD_SCHEDULE``) is precomputed.

Layers:

- :func:`sha256_nodes` — the kernel's wrapper.  On a CUDA tensor it launches
  the hand-written kernel of ``csrc/sha256.cu`` (one thread per node) and
  counts the launch in :data:`sha256_kernel_launches` and, with its node count,
  in :mod:`.profile`'s cost table; on a CPU tensor it runs
  :func:`hash_blocks_torch`, the same function written as tensor ops.
- :func:`hash_blocks` — numpy in, numpy out, through the wrapper on a device.
- :func:`merkle_root_device` — a whole zero-padded subtree reduced on the
  device: one kernel launch per level, only the 32-byte root comes back.
- :class:`DeviceHashBackend` — plugs into the SSZ engine's backend protocol.

Entry points run on the card unless the caller passes ``device="cpu"``; they
never fall back to the CPU on their own.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ssz.hash import hashlib_level, set_hash_backend
from . import _build
from .profile import record_launch

__all__ = [
    "hash_blocks",
    "hash_blocks_torch",
    "sha256_nodes",
    "merkle_root_device",
    "DeviceHashBackend",
    "install_device_backend",
    "resolve_device",
]

# fmt: off
_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
# fmt: on

_MASK = 0xFFFFFFFF


def _py_rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _py_schedule(words: list[int]) -> list[int]:
    w = list(words)
    for t in range(16, 64):
        s0 = _py_rotr(w[t - 15], 7) ^ _py_rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _py_rotr(w[t - 2], 17) ^ _py_rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _MASK)
    return w


#: Message schedule of the constant second block of a 64-byte message:
#: 0x80 delimiter, zeros, and a 512-bit length field.
_PAD_SCHEDULE: list[int] = _py_schedule([0x80000000] + [0] * 14 + [512])

#: Launches of the CUDA kernel; the wrapper adds one per launch and nowhere
#: else, so a caller can zero it and read whether a path ran on the kernel.
sha256_kernel_launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version: (N, 64) uint8 -> (N, 32) uint8
#
# torch has no +, >>, << or ~ on uint32, so the words live in int64 and are
# masked back to 32 bits after every add and left shift.
# ---------------------------------------------------------------------------


def _rotr_xor(x: torch.Tensor, *amounts: int) -> torch.Tensor:
    """XOR of ``x`` rotated right by each amount.  ``x``'s low bits are copied
    above bit 32 once, so each rotation is one right shift of that 64-bit
    value (the copy stays below bit 63 for amounts up to 31)."""
    top = max(amounts)
    y = x | ((x & ((1 << top) - 1)) << 32)
    acc = y >> amounts[0]
    for n in amounts[1:]:
        acc = acc ^ (y >> n)
    return acc & _MASK


def _schedule(words: torch.Tensor) -> list[torch.Tensor]:
    """``(N, 16)`` message words → the 64 ``(N,)`` schedule columns."""
    w = list(words.unbind(1))
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr_xor(w15, 7, 18) ^ (w15 >> 3)
        s1 = _rotr_xor(w2, 17, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _MASK)
    return w


def _compress(state: list, schedule: list) -> list:
    """One compression over ``(N,)`` columns; ``schedule`` entries are
    columns or Python ints (the constant padding block)."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr_xor(e, 6, 11, 25)
        ch = g ^ (e & (f ^ g))  # (e & f) ^ (~e & g)
        t1 = h + s1 + ch + (schedule[t] + _K[t])
        s0 = _rotr_xor(a, 2, 13, 22)
        maj = (a & (b | c)) | (b & c)  # (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _MASK, c, b, a, (t1 + s0 + maj) & _MASK
    return [(x + y) & _MASK for x, y in zip(state, [a, b, c, d, e, f, g, h])]


def hash_blocks_torch(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each ``(N, 64) uint8`` row → ``(N, 32) uint8``, as tensor
    ops on the tensor's own device."""
    n = blocks.shape[0]
    b = blocks.to(torch.int64).reshape(n, 16, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    iv = [torch.full((n,), v, dtype=torch.int64, device=blocks.device) for v in _IV]
    mid = _compress(iv, _schedule(words))
    digest = torch.stack(_compress(mid, _PAD_SCHEDULE), dim=1)  # (N, 8)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=blocks.device)
    return ((digest.unsqueeze(-1) >> shifts) & 0xFF).to(torch.uint8).reshape(n, 32)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    fn = _build.library("sha256").sha256_nodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sha256_nodes(blocks: torch.Tensor) -> torch.Tensor:
    """``(N, 64) uint8`` nodes → ``(N, 32) uint8`` digests on the same device.

    A CUDA tensor goes through the CUDA kernel (or this raises); a CPU tensor
    through :func:`hash_blocks_torch`.
    """
    global sha256_kernel_launches
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 or blocks.shape[1] != 64:
        raise ValueError(f"expected (N, 64) uint8 nodes, got {tuple(blocks.shape)} {blocks.dtype}")
    if not blocks.is_contiguous():
        raise ValueError("nodes must be contiguous")
    if blocks.device.type == "cpu":
        return hash_blocks_torch(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if blocks.data_ptr() % 16:
        raise ValueError("nodes must be 16-byte aligned for the kernel's vector loads")
    n = blocks.shape[0]
    out = torch.empty((n, 32), dtype=torch.uint8, device=blocks.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    rc = _kernel()(blocks.data_ptr(), out.data_ptr(), n, blocks.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"sha256 kernel launch failed with CUDA error {rc}")
    sha256_kernel_launches += 1
    record_launch("sha256", n)
    return out


# ---------------------------------------------------------------------------
# numpy-facing entry points
# ---------------------------------------------------------------------------


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Raises where the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for the plain PyTorch version")
    return dev


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def hash_blocks(blocks: np.ndarray, device: str | torch.device | None = None) -> np.ndarray:
    """Batched node hash ``(N, 64) uint8 → (N, 32) uint8`` on ``device``."""
    dev = resolve_device(device)
    return sha256_nodes(_to_device(blocks, dev)).cpu().numpy()


def merkle_root_device(
    chunks: np.ndarray, device: str | torch.device | None = None
) -> tuple[bytes, int]:
    """Root of ``(N, 32) uint8`` chunks padded to the next power of two with
    zero chunks.  Returns ``(root, depth_of_padded_subtree)`` — the caller
    extends with precomputed zero-subtree hashes up to the SSZ limit depth.

    The chunks cross to the device once.  Children ``2j`` and ``2j+1`` are
    adjacent rows, so each level's ``(2m, 32)`` digests viewed as ``(m, 64)``
    are the next level's nodes: one kernel launch per level.
    """
    dev = resolve_device(device)
    n = chunks.shape[0]
    pairs = max(1, -(-n // 2))
    m = 1 << (pairs - 1).bit_length()  # nodes at the leaf level, power of two
    level = torch.zeros((2 * m, 32), dtype=torch.uint8, device=dev)
    if n:
        level[:n] = _to_device(chunks, dev)
    while level.shape[0] > 1:
        level = sha256_nodes(level.view(-1, 64))
    return level[0].cpu().numpy().tobytes(), m.bit_length()


# ---------------------------------------------------------------------------
# SSZ HashBackend integration
# ---------------------------------------------------------------------------


class DeviceHashBackend:
    """SSZ hash backend dispatching large batches to the device.

    Below ``threshold`` nodes a level is hashed on the host with hashlib: the
    per-call copy and launch cost more than the hashing.  Subtrees of at least
    ``tree_threshold`` chunks are reduced whole on the device
    (:func:`merkle_root_device`).
    """

    name = "cuda-device"

    def __init__(
        self,
        device: str | torch.device | None = None,
        threshold: int = 256,
        tree_threshold: int = 512,
    ):
        self.device = resolve_device(device)
        self.threshold = int(threshold)
        self.tree_threshold = int(tree_threshold)
        #: whole-subtree reductions served, so a caller can see the route ran
        self.subtree_calls = 0

    def hash_level(self, blocks: np.ndarray) -> np.ndarray:
        if blocks.shape[0] < self.threshold:
            return hashlib_level(blocks)
        return hash_blocks(blocks, self.device)

    def merkle_subtree_root(self, chunks: np.ndarray) -> tuple[bytes, int]:
        """Whole-subtree device reduction; see :func:`merkle_root_device`."""
        self.subtree_calls += 1
        return merkle_root_device(chunks, self.device)


def install_device_backend(
    device: str | torch.device | None = None, **kwargs
) -> DeviceHashBackend:
    """Create a :class:`DeviceHashBackend` and make it the SSZ default."""
    backend = DeviceHashBackend(device, **kwargs)
    set_hash_backend(backend)
    return backend
