"""EXPERIMENTAL: width-256 Pedersen vector commitment on the G1 stack.

A Verkle-style vector commitment replaces a 40-deep hash path with one
group element per tree level (TS-Verkle, arXiv:2605.08682; the
stateless-client benchmarking in arXiv:2504.14069 measures exactly this
trade).  This module prototypes the PRIMITIVE on the repo's existing
381-bit field machinery: a width-:data:`WIDTH` Pedersen commitment

    C = sum_i  v_i * G_i

over independently derived BLS12-381 G1 generators, with subset openings
verified as ONE batched MSM check after random-linear-combination
folding (the same RLC discipline the chained BLS verify uses):

    sum_j r_j * C_j  ==  sum_j r_j * C_rest_j
                         + sum_i (sum_j r_j * v_{j,i}) * G_i

where an opening of commitment ``C_j`` at indices ``S_j`` reveals the
values there plus ``C_rest_j = sum_{i not in S_j} v_{j,i} * G_i``.  One
Fiat-Shamir-seeded RLC collapse means B openings cost one MSM of at
most ``B + WIDTH`` points, whatever B is.

**Prototype caveats — read before depending on this:**

- Openings are NOT succinct: the proof is one G1 point per opening
  (48 bytes compressed), with no IPA/KZG-style aggregation across tree
  levels.  Production Verkle needs the inner-product argument on top.
- Generator derivation is deterministic try-and-increment from SHA-256
  (cofactor-cleared, subgroup-checked at derivation); binding rests on
  the discrete logs between the ``G_i`` being unknown, which
  try-and-increment gives under standard assumptions, but the DST has
  seen no external review.
- No blinding term: commitments are binding but NOT hiding (fine for
  state witnesses, which are public data).

Every MSM's scalar products run as one G1 plane ladder
(:func:`..ops.bls_g1.batch_g1_mul`, on the three field kernels) on the card
for ``device=None``, on its plain PyTorch version for ``device="cpu"``;
the products are summed on the host.  ``host=True`` takes the oracle
instead: ``g1.multiply`` per term (natively hooked).  Affine coordinates
are unique, so every route gives the same points and the same verdicts.

The port's copy of the JAX package's ``witness/vector_commitment.py``,
without ``WITNESS_VC_NO_DEVICE`` (the caller picks the route) and with no
drop to the host when the card is missing or fails (it raises).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..crypto.bls.curve import g1
from ..crypto.bls.fields import P, R
from ..ops.bls_g1 import SCALAR_BITS, batch_g1_mul

__all__ = [
    "WIDTH",
    "VcOpening",
    "commit",
    "generators",
    "open_indices",
    "verify_openings",
]

#: Verkle node width: 256 children per commitment level.
WIDTH = 256

#: BLS12-381 G1 cofactor (multiplying by it lands any curve point in the
#: R-torsion subgroup).
_G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB

_DST = b"lambda_ethereum_consensus_tpu/witness-vc/g1-gen/v1"


class VcError(ValueError):
    """Malformed vector-commitment opening."""


def _sqrt_fq(v: int) -> int | None:
    """Square root in Fq (p ≡ 3 mod 4: one modexp), or None."""
    c = pow(v, (P + 1) // 4, P)
    return c if c * c % P == v else None


def _derive_generator(i: int):
    """Deterministic try-and-increment: hash to an x-coordinate, lift to
    the curve, clear the cofactor.  No known discrete log relation to
    ``G1_GENERATOR`` or between outputs."""
    ctr = 0
    while True:
        seed = hashlib.sha256(
            _DST + i.to_bytes(4, "big") + ctr.to_bytes(4, "big")
        ).digest()
        x = int.from_bytes(seed + hashlib.sha256(seed).digest()[:16], "big") % P
        y2 = (x * x % P * x + 4) % P
        y = _sqrt_fq(y2)
        if y is not None:
            pt = g1.multiply_raw((x, min(y, P - y)), _G1_COFACTOR)
            if pt is not None and g1.in_subgroup(pt):
                return pt
        ctr += 1


_GENERATORS: list | None = None


def generators(width: int = WIDTH) -> list:
    """The first ``width`` commitment generators (derived once, cached)."""
    global _GENERATORS
    if _GENERATORS is None or len(_GENERATORS) < width:
        _GENERATORS = [_derive_generator(i) for i in range(width)]
    return _GENERATORS[:width]


def _msm(points, scalars, device=None, host: bool = False):
    """``sum_i k_i * P_i``: the live terms' products as one
    :func:`batch_g1_mul` ladder on ``device`` (default: the card), or
    ``g1.multiply`` per term with ``host=True``; summed on the host."""
    pairs = [
        (pt, k % R) for pt, k in zip(points, scalars)
        if pt is not None and k % R != 0
    ]
    if not pairs:
        return None
    if host:
        parts = [g1.multiply(pt, k) for pt, k in pairs]
    else:
        parts = batch_g1_mul(
            [pt for pt, _ in pairs], [k for _, k in pairs], SCALAR_BITS, device
        )
    acc = g1.to_jacobian(None)
    for pt in parts:
        if pt is not None:
            acc = g1.jac_add(acc, g1.to_jacobian(pt))
    return g1.from_jacobian(acc)


def commit(values, device=None, host: bool = False):
    """Pedersen commitment to ``values`` (ints, len <= WIDTH; shorter
    vectors are implicitly zero-padded — zero scalars drop out)."""
    if len(values) > WIDTH:
        raise VcError(f"vector of {len(values)} exceeds width {WIDTH}")
    return _msm(generators(len(values) or 1), [int(v) for v in values], device, host)


@dataclass(frozen=True)
class VcOpening:
    """Opening of one commitment at a set of indices: the revealed
    values plus the complement commitment (the 'proof' — one G1 point).
    """

    indices: tuple  # ascending positions into the committed vector
    values: tuple  # ints revealed at those positions
    rest: object  # AffinePoint: commitment to everything else


def open_indices(values, indices, device=None, host: bool = False) -> VcOpening:
    """Open ``commit(values)`` at ``indices``."""
    if not indices:
        raise VcError("empty opening index set")
    idx = tuple(sorted({int(i) for i in indices}))
    if len(idx) != len(tuple(indices)):
        raise VcError("duplicated opening index")
    if idx[0] < 0 or idx[-1] >= len(values):
        raise VcError("opening index out of range")
    shown = set(idx)
    rest = _msm(
        [g for i, g in enumerate(generators(len(values))) if i not in shown],
        [int(v) for i, v in enumerate(values) if i not in shown],
        device,
        host,
    )
    return VcOpening(
        indices=idx,
        values=tuple(int(values[i]) for i in idx),
        rest=rest,
    )


def _fold_scalars(commitments, openings) -> list[int]:
    """Fiat-Shamir RLC coefficients: one 128-bit scalar per opening,
    bound to the full transcript (commitments, indices, values, rests)."""
    h = hashlib.sha256(b"witness-vc-rlc/v1")
    for c, o in zip(commitments, openings):
        for pt in (c, o.rest):
            if pt is None:
                h.update(b"\x00" * 96)
            else:
                h.update(int(pt[0]).to_bytes(48, "big"))
                h.update(int(pt[1]).to_bytes(48, "big"))
        for i, v in zip(o.indices, o.values):
            h.update(int(i).to_bytes(4, "big"))
            h.update((int(v) % R).to_bytes(32, "big"))
    seed = h.digest()
    out = []
    for j in range(len(openings)):
        out.append(
            int.from_bytes(
                hashlib.sha256(seed + j.to_bytes(4, "big")).digest()[:16], "big"
            )
            | 1  # never zero: every opening must stay bound
        )
    return out


def verify_openings(commitments, openings, device=None, host: bool = False) -> bool:
    """Verify B openings against their commitments as ONE folded MSM
    check.  Width/index shape violations reject; a single tampered
    value, rest-point or commitment fails the whole fold (callers
    bisect, exactly like the BLS batch verify)."""
    if len(commitments) != len(openings):
        raise VcError(f"{len(commitments)} commitments for {len(openings)} openings")
    if not openings:
        raise VcError("empty opening batch")
    for o in openings:
        if not o.indices or len(o.indices) != len(o.values):
            return False
        if len(set(o.indices)) != len(o.indices):
            return False
        if min(o.indices) < 0 or max(o.indices) >= WIDTH:
            return False
    rs = _fold_scalars(commitments, openings)
    gens = generators(WIDTH)
    # lhs = sum_j r_j * C_j ; rhs = sum_j r_j * C_rest_j + folded shown part
    folded: dict[int, int] = {}
    for r_j, o in zip(rs, openings):
        for i, v in zip(o.indices, o.values):
            folded[i] = (folded.get(i, 0) + r_j * int(v)) % R
    points = list(commitments) + [o.rest for o in openings] + [
        gens[i] for i in sorted(folded)
    ]
    scalars = (
        [r % R for r in rs]
        + [(R - r % R) % R for r in rs]
        + [(R - folded[i]) % R for i in sorted(folded)]
    )
    # C_j - C_rest_j - shown_j must fold to the identity
    return _msm(points, scalars, device, host) is None
