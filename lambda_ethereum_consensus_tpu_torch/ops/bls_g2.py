"""Batched G2 scalar multiplication over limb planes.

The port's counterpart of the JAX package's ``ops/bls_g2.py``:
:func:`fq2_limbs_batch`, :func:`g2_plane_field` (the Fq2 field dict
:mod:`.ladder` consumes over the shared tower, :mod:`.bls_fq12`; elements are
``(32, 2, ...B)`` limb planes) and :func:`batch_g2_mul`.  The twist's curve
parameters never enter the ladder, so the G1 formulas serve as they are.

Host boundary, as :mod:`.bls_g1`'s: affine Fq2 int pairs in; the Jacobian
planes come back in one copy, and every ``z`` is inverted as its conjugate
over its Fp norm, all norms through one :func:`.bls_g1.batch_inv_mod`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls import fields as F
from ..crypto.bls.fields import P
from . import bigint as BI
from .bls_fq12 import get_fq12_plane_ops
from .bls_g1 import SCALAR_BITS, _ints_batch, _limbs_batch, _planes, _scalar_bits_batch, batch_inv_mod
from .ladder import make_jacobian_ops
from .sha256 import resolve_device


def fq2_limbs_batch(values: list) -> np.ndarray:
    """[(c0, c1) int pairs] -> (N, 2, 32) limb arrays (shared packer)."""
    c0 = _limbs_batch([v[0] for v in values])
    c1 = _limbs_batch([v[1] for v in values])
    return np.stack([c0, c1], axis=1)


def g2_plane_field(device: torch.device) -> dict:
    """Plane-layout Fq2 field dict (elements ``(32, 2, ...B)``) for
    :mod:`.ladder`."""
    fq = get_fq12_plane_ops(device)
    one = np.zeros((BI.NLIMBS, 2, 1), np.int32)
    one[:, 0, 0] = BI.to_limbs(1)
    return {
        "mul_many": fq["fq2_mul_many"],
        "add": fq["add"],  # Fq2 sums are elementwise base-field sums
        "sub": fq["sub"],
        "one": torch.tensor(one, device=device),
        "zero": torch.zeros((BI.NLIMBS, 2, 1), dtype=torch.int32, device=device),
        "eq": lambda a, b: torch.all(torch.all(a == b, dim=0), dim=0),
        "flags": lambda bx: torch.zeros(bx.shape[2:], dtype=torch.bool, device=bx.device),
    }


_JACOBIAN: dict = {}


def g2_jacobian_ops(device: torch.device) -> dict:
    """:func:`.ladder.make_jacobian_ops` over :func:`g2_plane_field` on
    ``device``, built once per device."""
    ops = _JACOBIAN.get(device)
    if ops is None:
        ops = _JACOBIAN[device] = make_jacobian_ops(g2_plane_field(device))
    return ops


def g2_ladder(points: list, scalars: list, nbits: int, device: torch.device) -> tuple:
    """Affine Fq2 points and scalars in ``[0, 2^nbits)`` -> the ladder's
    Jacobian ``(X, Y, Z, inf)``: ``(32, 2, n)`` planes and ``(n,)`` flags on
    ``device``."""
    bx = fq2_limbs_batch([p[0] for p in points]).transpose(2, 1, 0)
    by = fq2_limbs_batch([p[1] for p in points]).transpose(2, 1, 0)
    kbits = _scalar_bits_batch(scalars, nbits)
    ladder = g2_jacobian_ops(device)["ladder"]
    return ladder((_planes(bx, device), _planes(by, device)), _planes(kbits.T, device))


def g2_affine(jac: tuple) -> list:
    """Jacobian planes -> affine Fq2 pairs, ``None`` where the flag says
    infinity; one device->host copy and one batched inversion of the ``z``
    norms."""
    X, Y, Z, inf = jac
    n = X.shape[-1]
    flat = torch.cat([X.reshape(-1, n), Y.reshape(-1, n), Z.reshape(-1, n),
                      inf[None].to(torch.int32)]).cpu().numpy()
    nl = BI.NLIMBS
    # rows: limb-major (32, 2) per coordinate, so component c of limb l is
    # row 2 l + c of its block
    coords = [
        tuple(_ints_batch(flat[b * 2 * nl + c : (b + 1) * 2 * nl : 2].T) for c in range(2))
        for b in range(3)
    ]
    xs, ys, zs = coords
    live = [i for i in range(n) if not flat[6 * nl, i]]
    norms = [(zs[0][i] * zs[0][i] + zs[1][i] * zs[1][i]) % P for i in live]
    out: list = [None] * n
    for i, ninv in zip(live, batch_inv_mod(norms, P)):
        zinv = (zs[0][i] * ninv % P, (P - zs[1][i]) * ninv % P)
        zinv2 = F.fq2_sq(zinv)
        zinv3 = F.fq2_mul(zinv2, zinv)
        out[i] = (
            F.fq2_mul((xs[0][i], xs[1][i]), zinv2),
            F.fq2_mul((ys[0][i], ys[1][i]), zinv3),
        )
    return out


def batch_g2_mul(
    points: list,
    scalars: list,
    bits: int = SCALAR_BITS,
    device: str | torch.device | None = None,
) -> list:
    """``[k_i * Q_i]`` on ``device`` (default: the card) for affine G2
    points ``((x0, x1), (y0, y1))`` (no Nones) and scalars in
    ``[0, 2^bits)``.  Returns the same tuple form, or ``None`` for infinity
    results."""
    dev = resolve_device(device)
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points for {len(scalars)} scalars")
    if not points:
        return []
    return g2_affine(g2_ladder(points, scalars, bits, dev))
