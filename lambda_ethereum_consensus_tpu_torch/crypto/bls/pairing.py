"""Optimal ate pairing for BLS12-381.

The port's own copy of the JAX package's ``crypto/bls/pairing.py``: the host
pairing, the oracle the port's device pairing is held against.
:func:`pairing_check` takes the native library (:mod:`.native`, bound after
its self-check) unless :func:`.native.enabled` is off; the device route of
the JAX package is not ported.

Replaces the pairing hidden inside the reference's blst dependency (ref:
native/bls_nif/src/lib.rs — ``verify``/``fast_aggregate_verify`` all bottom
out in pairings).  Design choices for a from-scratch host implementation:

- G2 points are *untwisted* into Fq12 affine coordinates once per pairing
  (x' * w^-2, y' * w^-3 — derived numerically at import, no magic constants),
  then the Miller loop runs with one combined slope-inversion per step.
- Verification only needs a *product* of pairings compared against one, so
  :func:`pairing_check` multiplies Miller-loop outputs and performs a single
  final exponentiation.
- The final exponentiation uses the standard easy part plus the
  ``(x-1)^2 (x+p)(x^2+p^2-1)+3`` addition-chain for the hard part.  That chain
  computes the hard part *cubed*; since gcd(3, R) = 1 this is a bijection on
  the R-th roots of unity and preserves every ``== 1`` check (the same trick
  production pairing libraries use).  A naive-exponent cross-check lives in
  the tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import fields as F
from . import native
from .curve import AffinePoint, g1, g2
from .fields import BLS_X, BLS_X_IS_NEG, P, R

Fq12Point = Optional[Tuple[F.Fq12, F.Fq12]]

# w is the Fq12 tower generator (w^2 = v).  Untwist divides x by w^2 and y by
# w^3; both inverse powers are computed here rather than transcribed.
_W: F.Fq12 = (F.FQ6_ZERO, F.FQ6_ONE)
with native.pure_python():  # importing builds nothing
    _W2_INV = F.fq12_inv(F.fq12_mul(_W, _W))
    _W3_INV = F.fq12_inv(F.fq12_mul(F.fq12_mul(_W, _W), _W))


def _embed_fq(a: int) -> F.Fq12:
    return (((a % P, 0), F.FQ2_ZERO, F.FQ2_ZERO), F.FQ6_ZERO)


def _embed_fq2(a: F.Fq2) -> F.Fq12:
    return ((a, F.FQ2_ZERO, F.FQ2_ZERO), F.FQ6_ZERO)


def untwist(q: AffinePoint) -> Fq12Point:
    """Map a G2 point on the twist into E(Fq12) coordinates."""
    if q is None:
        return None
    x, y = q
    return (
        F.fq12_mul(_embed_fq2(x), _W2_INV),
        F.fq12_mul(_embed_fq2(y), _W3_INV),
    )


def _line_and_step(
    r: Tuple[F.Fq12, F.Fq12],
    q: Tuple[F.Fq12, F.Fq12],
    px: F.Fq12,
    py: F.Fq12,
    doubling: bool,
) -> tuple[F.Fq12, Tuple[F.Fq12, F.Fq12] | None]:
    """Evaluate the line through r,q at P and advance r (r+q or 2r)."""
    x1, y1 = r
    x2, y2 = q
    if doubling or (x1 == x2 and y1 == y2):
        # slope = 3 x1^2 / (2 y1)
        num = F.fq12_mul(_embed_fq(3), F.fq12_mul(x1, x1))
        den = F.fq12_mul(_embed_fq(2), y1)
    elif x1 == x2:
        # vertical line: l(P) = px - x1, result point is infinity
        return F.fq12_sub(px, x1), None
    else:
        num = F.fq12_sub(y2, y1)
        den = F.fq12_sub(x2, x1)
    slope = F.fq12_mul(num, F.fq12_inv(den))
    line = F.fq12_sub(
        F.fq12_sub(py, y1),
        F.fq12_mul(slope, F.fq12_sub(px, x1)),
    )
    x3 = F.fq12_sub(F.fq12_sub(F.fq12_mul(slope, slope), x1), x2)
    y3 = F.fq12_sub(F.fq12_mul(slope, F.fq12_sub(x1, x3)), y1)
    return line, (x3, y3)


_X_BITS = bin(BLS_X)[3:]  # bits after the MSB


def miller_loop(p: AffinePoint, q: AffinePoint) -> F.Fq12:
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter."""
    if p is None or q is None:
        return F.FQ12_ONE
    q12 = untwist(q)
    assert q12 is not None
    px = _embed_fq(p[0])
    py = _embed_fq(p[1])
    f = F.FQ12_ONE
    r = q12
    for bit in _X_BITS:
        line, r2 = _line_and_step(r, r, px, py, doubling=True)
        f = F.fq12_mul(F.fq12_sq(f), line)
        assert r2 is not None
        r = r2
        if bit == "1":
            line, r2 = _line_and_step(r, q12, px, py, doubling=False)
            f = F.fq12_mul(f, line)
            if r2 is None:
                break
            r = r2
    if BLS_X_IS_NEG:
        f = F.fq12_conj(f)
    return f


def _pow_x(a: F.Fq12) -> F.Fq12:
    """a^x for the (signed) BLS parameter x."""
    out = F.fq12_pow(a, BLS_X)
    # On the cyclotomic subgroup conjugation is inversion, so a^(-|x|) is the
    # conjugate of a^|x|.
    return F.fq12_conj(out) if BLS_X_IS_NEG else out


def final_exponentiation(f: F.Fq12) -> F.Fq12:
    """f^((p^12-1)/r) up to a cube (see module docstring)."""
    # Easy part: f^((p^6-1)(p^2+1))
    f = F.fq12_mul(F.fq12_conj(f), F.fq12_inv(f))
    f = F.fq12_mul(F.fq12_frobenius_n(f, 2), f)
    # Hard part (cubed): exponent (x-1)^2 (x+p) (x^2+p^2-1) + 3
    m = f
    a = F.fq12_mul(_pow_x(m), F.fq12_conj(m))  # m^(x-1)
    b = F.fq12_mul(_pow_x(a), F.fq12_conj(a))  # a^(x-1)
    c = F.fq12_mul(_pow_x(b), F.fq12_frobenius(b))  # b^(x+p)
    d = F.fq12_mul(
        F.fq12_mul(_pow_x(_pow_x(c)), F.fq12_frobenius_n(c, 2)),
        F.fq12_conj(c),
    )  # c^(x^2+p^2-1)
    return F.fq12_mul(d, F.fq12_mul(F.fq12_sq(m), m))  # * m^3


def final_exponentiation_naive(f: F.Fq12) -> F.Fq12:
    """Reference final exponentiation by the literal exponent (slow; tests)."""
    return F.fq12_pow(f, (P**12 - 1) // R)


def pairing(p: AffinePoint, q: AffinePoint) -> F.Fq12:
    """e(P, Q) for P in G1, Q in G2 (up to the fixed cube; see module doc)."""
    return final_exponentiation(miller_loop(p, q))


def pairing_check(pairs: list[tuple[AffinePoint, AffinePoint]]) -> bool:
    """True iff prod e(P_i, Q_i) == 1, with a single final exponentiation.

    The host oracle of the port's device pairing: the native library's
    lockstep Miller loops, or pure Python when :func:`.native.enabled` is
    off.  Points must be in the prime-order subgroups."""
    live = []
    for p, q in pairs:
        if p is None or q is None:
            continue
        if not g1.on_curve(p) or not g2.on_curve(q):
            return False
        live.append((p, q))
    if not live:
        return True
    if native.enabled():
        return native.pairing_check(live)
    f = F.FQ12_ONE
    for p, q in live:
        f = F.fq12_mul(f, miller_loop(p, q))
    return F.fq12_is_one(final_exponentiation(f))
