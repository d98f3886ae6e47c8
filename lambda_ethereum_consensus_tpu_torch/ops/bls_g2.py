"""G2 over limb planes: host marshalling and the plane field of the ladders.

The port's counterpart of the JAX package's ``ops/bls_g2.py`` (the parts the
attestation drain runs): :func:`fq2_limbs_batch` and :func:`g2_plane_field`,
the Fq2 field dict :mod:`.ladder` consumes over the shared tower
(:mod:`.bls_fq12`).  Elements are ``(32, 2, ...B)`` limb planes; the twist's
curve parameters never enter the ladder, so the G1 formulas serve as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bigint as BI
from .bls_fq12 import get_fq12_plane_ops
from .bls_g1 import _limbs_batch


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
