"""Batched G1 scalar multiplication over limb planes.

The port's counterpart of the JAX package's ``ops/bls_g1.py``: the
vectorised int <-> limb packers, :func:`g1_plane_field` (the Fq field dict
:mod:`.ladder` consumes; elements are ``(32, ...B)`` int32 limb planes with
the batch trailing), and :func:`batch_g1_mul`, ``[k_i * P_i]`` as one
double-and-add ladder over the whole batch on the card.

Host boundary: affine int pairs in; the Jacobian planes come back in one
copy and turn affine on the host with one batched inversion
(:func:`batch_inv_mod`); ``k = 0`` lanes and infinity results come back as
``None``.  The JAX package pads every plane batch to a 1,024-lane multiple
(``_PLANE_QUANTUM``), the TPU's tile of 8 sublanes x 128 lanes; that is a TPU
layout rule and is not carried over: the CUDA kernels take any lane count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls.fields import P
from . import bigint as BI
from .bigint_pallas import make_plane_ops
from .ladder import _many, make_jacobian_ops
from .sha256 import resolve_device

SCALAR_BITS = 256


def _scalar_bits_batch(ks: list, nbits: int = SCALAR_BITS) -> np.ndarray:
    """ints -> (N, nbits) int32 bits, MSB first (vectorized)."""
    raw = b"".join(int(k).to_bytes(nbits // 8, "big") for k in ks)
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    return bits.reshape(len(ks), nbits).astype(np.int32)


def _ints_batch(limbs: np.ndarray) -> list:
    """(N, 32) int32 little-endian 12-bit limbs -> list of N ints."""
    n = len(limbs)
    # big-endian bitstream: most-significant limb first, bits MSB-first
    bits = (limbs[:, ::-1, None] >> np.arange(BI.LIMB_BITS - 1, -1, -1)) & 1
    packed = np.packbits(bits.astype(np.uint8).reshape(n, -1), axis=1)
    return [int.from_bytes(row.tobytes(), "big") for row in packed]


def _limbs_batch(xs: list) -> np.ndarray:
    """ints -> (N, NLIMBS) int32 12-bit limbs (vectorized)."""
    raw = b"".join(int(x).to_bytes(BI.NLIMBS * BI.LIMB_BITS // 8, "big") for x in xs)
    bits = np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(
        len(xs), BI.NLIMBS, BI.LIMB_BITS
    )
    weights = 1 << np.arange(BI.LIMB_BITS - 1, -1, -1, dtype=np.int32)
    limbs_be = bits.astype(np.int32) @ weights  # (N, NLIMBS) most-significant first
    return limbs_be[:, ::-1].copy()  # little-endian limb order


def g1_plane_field(device: torch.device) -> dict:
    """The plane-layout Fq field dict (elements ``(32, ...B)``) consumed by
    :mod:`.ladder`; ``mul_many`` stacks independent products into one
    ``mul_mod`` call, constants live on ``device``."""
    ops = make_plane_ops()
    one = torch.tensor(BI.to_limbs(1)[:, None], device=device)
    return {
        "mul_many": lambda pairs: _many(ops["mul_mod"], pairs),
        "add": ops["add_mod"],
        "sub": ops["sub_mod"],
        "one": one,
        "zero": torch.zeros((BI.NLIMBS, 1), dtype=torch.int32, device=device),
        "eq": lambda a, b: torch.all(a == b, dim=0),
        "flags": lambda bx: torch.zeros(bx.shape[1:], dtype=torch.bool, device=bx.device),
    }


_JACOBIAN: dict = {}


def g1_jacobian_ops(device: torch.device) -> dict:
    """:func:`.ladder.make_jacobian_ops` over :func:`g1_plane_field` on
    ``device``, built once per device."""
    ops = _JACOBIAN.get(device)
    if ops is None:
        ops = _JACOBIAN[device] = make_jacobian_ops(g1_plane_field(device))
    return ops


def _planes(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def g1_ladder(points: list, scalars: list, nbits: int, device: torch.device) -> tuple:
    """Affine int points and scalars in ``[0, 2^nbits)`` -> the ladder's
    Jacobian ``(X, Y, Z, inf)``: ``(32, n)`` planes and ``(n,)`` flags on
    ``device``."""
    bx = _limbs_batch([p[0] for p in points])
    by = _limbs_batch([p[1] for p in points])
    kbits = _scalar_bits_batch(scalars, nbits)
    ladder = g1_jacobian_ops(device)["ladder"]
    return ladder((_planes(bx.T, device), _planes(by.T, device)), _planes(kbits.T, device))


def batch_inv_mod(values: list, modulus: int) -> list:
    """Montgomery prefix-product batch inversion: one modexp for any number
    of nonzero residues (shared by the G1/G2 affine conversions)."""
    if any(v % modulus == 0 for v in values):
        raise ValueError("batch_inv_mod: zero residue has no inverse")
    prefix = []
    acc = 1
    for v in values:
        acc = acc * v % modulus
        prefix.append(acc)
    inv_all = pow(acc, modulus - 2, modulus)
    out = [0] * len(values)
    for idx in range(len(values) - 1, -1, -1):
        before = prefix[idx - 1] if idx > 0 else 1
        out[idx] = inv_all * before % modulus
        inv_all = inv_all * values[idx] % modulus
    return out


def g1_affine(jac: tuple) -> list:
    """Jacobian planes -> affine int pairs, ``None`` where the flag says
    infinity.  One device->host copy; every live ``z`` is inverted by one
    :func:`batch_inv_mod`."""
    X, Y, Z, inf = jac
    flat = torch.cat([X, Y, Z, inf[None].to(torch.int32)]).cpu().numpy()
    n = flat.shape[1]
    nl = BI.NLIMBS
    xs, ys, zs = (_ints_batch(flat[i * nl : (i + 1) * nl].T) for i in range(3))
    live = [i for i in range(n) if not flat[3 * nl, i]]
    out: list = [None] * n
    # the ladder's infinity flag guarantees a nonzero z on every live lane
    for i, zinv in zip(live, batch_inv_mod([zs[i] for i in live], P)):
        zinv2 = zinv * zinv % P
        out[i] = (xs[i] * zinv2 % P, ys[i] * zinv2 % P * zinv % P)
    return out


def batch_g1_mul(
    points: list,
    scalars: list,
    bits: int = SCALAR_BITS,
    device: str | torch.device | None = None,
) -> list:
    """``[k_i * P_i]`` on ``device`` (default: the card).

    ``points``: affine ``(x, y)`` int pairs (no Nones); ``scalars``: ints in
    ``[0, 2^bits)`` — callers with short scalars (the 64-bit RLC
    coefficients) pass the width so the ladder runs fewer steps.  Returns
    affine int pairs, or ``None`` for infinity results.
    """
    dev = resolve_device(device)
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points for {len(scalars)} scalars")
    if not points:
        return []
    return g1_affine(g1_ladder(points, scalars, bits, dev))
