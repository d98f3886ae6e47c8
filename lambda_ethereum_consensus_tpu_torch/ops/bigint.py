"""Limb constants and marshalling of the 384-bit field elements.

An Fq element is 32 little-endian limbs of 12 bits in ``int32``, canonical
(limbs < 2^12, value < p) — the layout of the JAX package's ``ops/bigint.py``,
whose constants and host marshalling these are.  The arithmetic itself lives
in :mod:`.bigint_pallas` (the kernels' wrappers and their plain versions).
"""

from __future__ import annotations

import numpy as np

from ..crypto.bls.fields import P

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1
NLIMBS = 32  # 32 * 12 = 384 bits
# Barrett constant: floor(b^(2k) / p) with b = 2^12, k = 32 -> 33 limbs
MU = (1 << (LIMB_BITS * 2 * NLIMBS)) // P


def to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    """int -> (n,) int32 little-endian 12-bit limbs."""
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    assert x == 0, "value exceeds limb capacity"
    return out


def from_limbs(limbs) -> int:
    """limb array -> int (host)."""
    arr = np.asarray(limbs)
    x = 0
    for i in reversed(range(arr.shape[-1])):
        x = (x << LIMB_BITS) + int(arr[..., i])
    return x
