"""BLS12-381 base-field ops over limb planes: the three CUDA kernels'
wrappers and their plain PyTorch versions.

The module keeps the name of the JAX package's ``ops/bigint_pallas.py``,
whose three Pallas kernels (``_mul_mod_kernel``, ``_add_mod_kernel``,
``_sub_mod_kernel``) ``csrc/fq.cu`` replaces.  Layout, as there: limb planes
outermost, ``(32, ...)`` int32, 12-bit canonical limbs; the trailing axes
(tower components, then the batch) broadcast between the operands and are
flattened into one batch of ``M`` elements.

Layers:

- :func:`mul_mod`, :func:`add_mod`, :func:`sub_mod` — the wrappers.  On CUDA
  tensors each launches its kernel (or raises) and adds one to its entry of
  :data:`kernel_launches`; on CPU tensors each runs its plain version.  The
  launch geometry comes from :func:`_geometry`: ``mul_mod`` runs its group
  body (``MUL_GROUP`` threads per element) below ``MUL_GROUP_THRESHOLD``
  lanes and its one-thread body from there on; ``add_mod`` runs
  ``ADD_GROUP`` and ``sub_mod`` ``SUB_GROUP`` threads per element (one
  shared body with carry lookahead); each body has its block size in
  ``BLOCK_THREADS``.
- :func:`mul_mod_torch`, :func:`add_mod_torch`, :func:`sub_mod_torch` — the
  plain versions, tensor ops on the operands' own device.  They compute the
  same canonical residues by another exact method, written to cost few
  tensor ops per call (the CPU tests make on the order of 10^5 calls):

  * the multiply forms ``y = sum_ij a_i b_j (2^(12(i+j)) mod p)`` as one
    float64 matrix product (every partial sum is an integer below 2^46, so
    float64 is exact on any summation order), estimates ``q = y // p`` in
    float64, and picks the exact ``y - q p`` of two candidates;
  * add and sub form their two candidate results side by side and keep the
    one whose carry out of bit 384 says it is in range;
  * carries resolve in a few vectorised passes plus one exact
    carry-lookahead (``torch.cummax`` over the limbs that pass a carry on).
- :func:`make_plane_ops` — the ``{"mul_mod", "add_mod", "sub_mod"}`` dict the
  tower and the ladders are built on.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..crypto.bls.fields import P
from . import _build
from . import bigint as BI

__all__ = [
    "add_mod",
    "add_mod_torch",
    "from_planes",
    "kernel_launches",
    "make_plane_ops",
    "mul_mod",
    "mul_mod_torch",
    "sub_mod",
    "sub_mod_torch",
    "to_planes",
]

_N = BI.NLIMBS  # 32
_BITS = BI.LIMB_BITS
_MASK = BI.LIMB_MASK

#: Launches of each CUDA kernel; a wrapper adds one per launch and nowhere
#: else, so a caller can zero the counts and read which kernels a path ran.
kernel_launches = {"mul_mod": 0, "add_mod": 0, "sub_mod": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _limbs_i64(x: int, n: int = _N) -> list[int]:
    return [(x >> (_BITS * i)) & _MASK for i in range(n)]


@functools.cache
def _consts(device: torch.device) -> dict:
    i64 = dict(dtype=torch.int64, device=device)
    # W[(i, j), l]: limb l of 2^(12(i+j)) mod p (a unit vector below limb 32)
    fold = np.array(
        [_limbs_i64(pow(2, _BITS * k, P)) for k in range(2 * _N - 1)], np.float64
    )  # (63, 32)
    pair = (np.arange(_N)[:, None] + np.arange(_N)[None, :]).reshape(-1)
    return {
        "w_t": torch.tensor(fold[pair].T.copy(), dtype=torch.float64, device=device),
        "pow": torch.tensor([2.0 ** (_BITS * i) for i in range(_N)], dtype=torch.float64,
                            device=device),
        "p_f": float(P),
        "p": torch.tensor(_limbs_i64(P), dtype=torch.int32, device=device)[:, None],
        # 2^384 - p: adding it subtracts p and sets bit 384 exactly when no
        # borrow occurred
        "p_comp": torch.tensor(_limbs_i64((1 << (_BITS * _N)) - P), **i64)[:, None],
        "p_comp32": torch.tensor(_limbs_i64((1 << (_BITS * _N)) - P), dtype=torch.int32,
                                 device=device)[:, None],
        "k2": torch.arange(2, **i64)[:, None],
        "top_w": torch.tensor([1 << (_BITS * i) for i in range(4)], **i64)[:, None],
        "idx": {},
    }


def _carry(v: torch.Tensor, passes: int) -> torch.Tensor:
    """Non-negative limbs ``(K, L, M)`` (int32 or int64) -> canonical limbs of the same
    value mod 2^(12 L), in place.  ``passes`` bounded passes must leave every
    limb in [0, 2^12]; the lookahead then resolves the remaining 0/1 carries
    exactly: the carry into limb i is the generate bit of the nearest limb
    below i that does not pass a carry on (is not 0xFFF)."""
    for _ in range(passes):
        c = v >> _BITS
        v &= _MASK
        v[:, 1:] += c[:, :-1]
    k, n, m = v.shape
    cache = _consts(v.device)["idx"]
    idx = cache.get(n)
    if idx is None:
        idx = cache[n] = torch.arange(n, dtype=torch.int64, device=v.device).view(1, n, 1)
    last = torch.cummax(torch.where(v == _MASK, -1, idx), dim=1).values
    gen = torch.zeros((k, n + 1, m), dtype=v.dtype, device=v.device)
    gen[:, 1:] = v >> _BITS
    carry_out = torch.gather(gen, 1, last + 1)  # carry out of limb i
    v[:, 1:] += carry_out[:, :-1]
    v &= _MASK
    return v


def _check(a: torch.Tensor, b: torch.Tensor) -> tuple[int, ...]:
    """Broadcast shape of two plane operands; raises on what the kernels
    do not take."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"expected int32 limb planes, got {a.dtype} and {b.dtype}")
    if a.dim() != b.dim() or a.dim() < 1 or a.shape[0] != _N or b.shape[0] != _N:
        raise ValueError(
            f"expected (32, ...) limb planes of one rank, got {tuple(a.shape)} and "
            f"{tuple(b.shape)}"
        )
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    return tuple(torch.broadcast_shapes(a.shape, b.shape))


def _flat(a, b, shape):
    m = math.prod(shape[1:])
    return a.expand(shape).reshape(_N, m), b.expand(shape).reshape(_N, m), m


def mul_mod_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b) mod p`` over broadcast ``(32, ...)`` int32 planes, as tensor
    ops on the operands' device."""
    shape = _check(a, b)
    c = _consts(a.device)
    m = math.prod(shape[1:])
    fa = a.expand(shape).reshape(_N, m).to(torch.float64)
    fb = b.expand(shape).reshape(_N, m).to(torch.float64)
    outer = (fa[:, None, :] * fb[None, :, :]).reshape(_N * _N, m)
    y = c["w_t"] @ outer  # (32, m): y == a*b mod p, limbs < 2^46, exact
    # q = y // p is q0 or q0 + 1: the float64 estimate of y / p is within
    # 2^-9.7 of it, so flooring it less 2^-9 lands on q or q - 1
    est = (c["pow"] @ y) / c["p_f"]
    q0 = torch.floor(est - 2.0**-9).clamp_(min=0).to(torch.int64)
    q = q0[None, :] + c["k2"]  # (2, m) candidate quotients
    # s_k = y - q_k p + q_k 2^384: limbs < 2^50, value below 2^432
    s = torch.zeros((2, _N + 4, m), dtype=torch.int64, device=a.device)
    s[:, :_N] = y.to(torch.int64)[None] + q[:, None, :] * c["p_comp"][None]
    s = _carry(s, 5)
    # floor(s_k / 2^384) == q_k exactly when y - q_k p did not go negative
    top = (s[:, _N:] * c["top_w"][None]).sum(1)
    k = (top == q).sum(0) - 1
    out = torch.gather(s[:, :_N], 0, k.view(1, 1, m).expand(1, _N, m))[0]
    return out.to(torch.int32).reshape(shape)


def add_mod_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a + b) mod p`` over broadcast ``(32, ...)`` int32 planes."""
    shape = _check(a, b)
    c = _consts(a.device)
    x, y, m = _flat(a, b, shape)
    v = torch.zeros((2, _N + 1, m), dtype=torch.int32, device=a.device)
    v[:, :_N] = x + y
    v[1, :_N] += c["p_comp32"]  # a + b - p + 2^384
    v = _carry(v, 2)
    return torch.where(v[1, _N] != 0, v[1, :_N], v[0, :_N]).reshape(shape)


def sub_mod_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a - b) mod p`` over broadcast ``(32, ...)`` int32 planes."""
    shape = _check(a, b)
    c = _consts(a.device)
    x, y, m = _flat(a, b, shape)
    v = torch.zeros((2, _N + 1, m), dtype=torch.int32, device=a.device)
    v[:, :_N] = x + (_MASK - y)  # a + (2^384 - 1 - b)
    v[:, 0] += 1  # a - b + 2^384
    v[1, :_N] += c["p"]  # a - b + p + 2^384
    v = _carry(v, 2)
    return torch.where(v[0, _N] != 0, v[0, :_N], v[1, :_N]).reshape(shape)  # a >= b: a - b


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

_PLAIN = {"mul_mod": mul_mod_torch, "add_mod": add_mod_torch, "sub_mod": sub_mod_torch}

#: Threads per element of ``fq_mul_mod``'s group body (``kMulGroup`` in
#: ``csrc/fq.cu``): each thread takes a share of every product's rows.
MUL_GROUP = 2
#: ``mul_mod`` runs its group body below this many lanes and its one-thread
#: body from there on, where the one-thread body fills the card and is held
#: by bytes (``chip_smoke.py`` phase 9 times both bodies; ``PERF.md``).
MUL_GROUP_THRESHOLD = 9216
#: Threads per element of ``fq_add_mod`` (``kAddGroup``): each adds 16 limbs.
ADD_GROUP = 2
#: Threads per element of ``fq_sub_mod`` (``kSubGroup``; its launcher also
#: takes 1 and 4, which ``chip_smoke.py`` phase 9 sweeps).
SUB_GROUP = 2
#: Threads per block of each kernel (both of mul_mod's bodies).  Small
#: blocks spread the paths' launches (2,000-25,000 lanes) over the card's
#: 132 SMs.
BLOCK_THREADS = {"mul_mod": 64, "add_mod": 128, "sub_mod": 128}


def _geometry(name: str, m: int) -> tuple[int, int, int]:
    """``(threads per element, threads per block, blocks)`` of the launch of
    kernel ``name`` over ``m`` lanes: thread ``g`` takes element
    ``g // group``; the last block's threads past ``m * group`` store
    nothing."""
    if name == "mul_mod":
        group = MUL_GROUP if m < MUL_GROUP_THRESHOLD else 1
    else:
        group = ADD_GROUP if name == "add_mod" else SUB_GROUP
    threads = BLOCK_THREADS[name]
    return group, threads, -(-m * group // threads)


@functools.cache
def _kernel(name: str):
    fn = getattr(_build.library("fq"), f"fq_{name}")
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _operand(x: torch.Tensor, shape: tuple, m: int):
    """``(tensor, limb stride, lane stride)`` for the kernel: an operand with
    every batch axis broadcast is read with lane stride 0; any other
    broadcast is materialised."""
    if x.numel() == _N:
        x = x.reshape(_N).contiguous()
        return x, 1, 0
    if tuple(x.shape) != shape:
        x = x.expand(shape)
    x = x.contiguous()
    return x, m, 1


def _run(name: str, a: torch.Tensor, b: torch.Tensor, shape: tuple,
         geometry: tuple[int, int, int]) -> torch.Tensor:
    """Launch ``fq_<name>`` on CUDA operands of broadcast ``shape`` with the
    given geometry; raises if the launch did not run."""
    m = math.prod(shape[1:])
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if m == 0:
        return out
    xa, als, aes = _operand(a, shape, m)
    xb, bls, bes = _operand(b, shape, m)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _kernel(name)(xa.data_ptr(), als, aes, xb.data_ptr(), bls, bes, out.data_ptr(), m,
                       *geometry, a.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"fq {name} kernel launch failed with CUDA error {rc}")
    return out


def _launch(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = _check(a, b)
    if a.device.type == "cpu":
        return _PLAIN[name](a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    m = math.prod(shape[1:])
    out = _run(name, a, b, shape, _geometry(name, m))
    if m:
        kernel_launches[name] += 1
    return out


def mul_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b) mod p`` over broadcast ``(32, ...)`` int32 limb planes: the
    CUDA kernel on CUDA tensors, :func:`mul_mod_torch` on CPU tensors."""
    return _launch("mul_mod", a, b)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a + b) mod p``; see :func:`mul_mod`."""
    return _launch("add_mod", a, b)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a - b) mod p``; see :func:`mul_mod`."""
    return _launch("sub_mod", a, b)


def make_plane_ops() -> dict:
    """``{"mul_mod", "add_mod", "sub_mod"}`` over ``(32, ...)`` operands."""
    return {"mul_mod": mul_mod, "add_mod": add_mod, "sub_mod": sub_mod}


# ------------------------------------------------------- host marshalling


def to_planes(xs: list) -> np.ndarray:
    """ints -> ``(32, len(xs))`` int32 planes."""
    from .bls_g1 import _limbs_batch

    return np.ascontiguousarray(_limbs_batch(xs).T)


def from_planes(planes, n: int | None = None) -> list:
    """``(32, ...)`` planes -> list of ints (the first ``n``, flattened)."""
    from .bls_g1 import _ints_batch

    flat = np.asarray(planes).reshape(_N, -1).T
    return _ints_batch(np.ascontiguousarray(flat[:n] if n is not None else flat))
