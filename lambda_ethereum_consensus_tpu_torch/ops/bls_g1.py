"""G1 over limb planes: host marshalling and the plane field of the ladders.

The port's counterpart of the JAX package's ``ops/bls_g1.py`` (the parts the
attestation drain runs): the vectorised int <-> limb packers and
:func:`g1_plane_field`, the Fq field dict :mod:`.ladder` consumes.  Elements
are ``(32, ...B)`` int32 limb planes with the batch trailing.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bigint as BI
from .bigint_pallas import make_plane_ops
from .ladder import _many

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
