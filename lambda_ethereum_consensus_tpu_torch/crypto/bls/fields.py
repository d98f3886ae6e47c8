"""BLS12-381 extension-field tower: Fq, Fq2, Fq6, Fq12.

The port's own copy of the JAX package's ``crypto/bls/fields.py``: host
arithmetic over the tower

    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - (1 + u))
    Fq12 = Fq6[w] / (w^2 - v)

represented as nested tuples of Python ints (no classes in the hot loops).
Frobenius coefficients are *computed* at import time rather than hardcoded, so
there are no long unverifiable constants here; structural self-checks live in
the curve/pairing modules.

Conventions: an Fq element is an int in [0, P); Fq2 is ``(c0, c1)`` meaning
``c0 + c1*u``; Fq6 is a 3-tuple of Fq2; Fq12 is a 2-tuple of Fq6.
"""

from __future__ import annotations

from . import native

# Base field modulus and main subgroup order of BLS12-381.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# |x| for the BLS parameter x = -0xD201000000010000 (the curve is D-type
# parameterised with negative x; sign handled at use sites).
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

Fq2 = tuple  # (int, int)
Fq6 = tuple  # (Fq2, Fq2, Fq2)
Fq12 = tuple  # (Fq6, Fq6)

FQ2_ZERO: Fq2 = (0, 0)
FQ2_ONE: Fq2 = (1, 0)
FQ6_ZERO: Fq6 = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE: Fq6 = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)
FQ12_ZERO: Fq12 = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE: Fq12 = (FQ6_ONE, FQ6_ZERO)


# ---------------------------------------------------------------- Fq2

def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a: Fq2) -> Fq2:
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0b1 + a1b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fq2_sq(a: Fq2) -> Fq2:
    a0, a1 = a
    return ((a0 - a1) * (a0 + a1) % P, 2 * a0 * a1 % P)


def fq2_scalar(a: Fq2, k: int) -> Fq2:
    return (a[0] * k % P, a[1] * k % P)


def _fq_powmod(base: int, exp: int) -> int:
    """base^exp mod P (the hot primitive under square roots, Legendre
    symbols and inversions): the native library's Montgomery exponentiation,
    bound after its self-check, unless :func:`.native.enabled` is off."""
    if native.enabled():
        return native.fp_powmod(base, exp)
    return pow(base, exp, P)


def fq2_inv(a: Fq2) -> Fq2:
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    if norm == 0:
        raise ZeroDivisionError("Fq2 inverse of zero")
    ninv = _fq_powmod(norm, P - 2)
    return (a0 * ninv % P, -a1 * ninv % P)


def fq2_conj(a: Fq2) -> Fq2:
    return (a[0], -a[1] % P)


def fq2_mul_by_xi(a: Fq2) -> Fq2:
    """Multiply by xi = 1 + u (the Fq6 non-residue)."""
    a0, a1 = a
    return ((a0 - a1) % P, (a0 + a1) % P)


def fq2_pow(a: Fq2, e: int) -> Fq2:
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sq(base)
        e >>= 1
    return result


def fq2_is_zero(a: Fq2) -> bool:
    return a[0] == 0 and a[1] == 0


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (P = 3 mod 4), or None if a is not a QR."""
    c = _fq_powmod(a, (P + 1) // 4)
    return c if c * c % P == a % P else None


def fq2_sqrt(a: Fq2) -> Fq2 | None:
    """Square root in Fq2 via the complex method, or None when none exists."""
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        s = fq_sqrt(a0)
        if s is not None:
            return (s, 0)
        s = fq_sqrt(-a0 % P)
        return None if s is None else (0, s)
    alpha = (a0 * a0 + a1 * a1) % P  # norm
    s = fq_sqrt(alpha)
    if s is None:
        return None
    inv2 = (P + 1) // 2
    delta = (a0 + s) * inv2 % P
    x0 = fq_sqrt(delta)
    if x0 is None:
        delta = (a0 - s) * inv2 % P
        x0 = fq_sqrt(delta)
        if x0 is None:
            return None
    x1 = a1 * inv2 % P * _fq_powmod(x0, P - 2) % P
    cand = (x0, x1)
    return cand if fq2_sq(cand) == (a0, a1) else None


# ---------------------------------------------------------------- Fq6

def fq6_add(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a: Fq6) -> Fq6:
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a: Fq6, b: Fq6) -> Fq6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # Karatsuba-style interpolation (Devegili et al.)
    c0 = fq2_add(t0, fq2_mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)),
        fq2_mul_by_xi(t2),
    )
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sq(a: Fq6) -> Fq6:
    return fq6_mul(a, a)


def fq6_mul_by_v(a: Fq6) -> Fq6:
    """Multiply by v (shifts coefficients, wrapping through xi)."""
    return (fq2_mul_by_xi(a[2]), a[0], a[1])


def fq6_inv(a: Fq6) -> Fq6:
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_by_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_by_xi(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_mul_by_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))),
        fq2_mul(a0, c0),
    )
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# ---------------------------------------------------------------- Fq12

def fq12_add(a: Fq12, b: Fq12) -> Fq12:
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a: Fq12, b: Fq12) -> Fq12:
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a: Fq12) -> Fq12:
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sq(a: Fq12) -> Fq12:
    a0, a1 = a
    t = fq6_mul(a0, a1)
    c0 = fq6_sub(
        fq6_mul(fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_v(a1))),
        fq6_add(t, fq6_mul_by_v(t)),
    )
    return (c0, fq6_add(t, t))


def fq12_inv(a: Fq12) -> Fq12:
    a0, a1 = a
    t = fq6_sub(fq6_sq(a0), fq6_mul_by_v(fq6_sq(a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_conj(a: Fq12) -> Fq12:
    """Conjugation = the p^6 Frobenius; equals inversion on the cyclotomic
    subgroup (unit-norm elements), which is where pairing values live."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a: Fq12, e: int) -> Fq12:
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result


def fq12_is_one(a: Fq12) -> bool:
    return a == FQ12_ONE


# ------------------------------------------------------- Frobenius maps
#
# frob(x) = x^P.  On Fq2 it is conjugation; on the towers each coefficient
# picks up a power of xi.  The gamma constants are derived numerically here —
# xi^((P-1)/6) and friends — so a transcription error is impossible.

_XI: Fq2 = (1, 1)
_GAMMA12 = fq2_pow(_XI, (P - 1) // 6)  # for the w-coefficient of Fq12
_GAMMA6_1 = fq2_pow(_XI, (P - 1) // 3)  # for the v-coefficient of Fq6
_GAMMA6_2 = fq2_sq(_GAMMA6_1)  # for the v^2 coefficient


def fq6_frobenius(a: Fq6) -> Fq6:
    return (
        fq2_conj(a[0]),
        fq2_mul(fq2_conj(a[1]), _GAMMA6_1),
        fq2_mul(fq2_conj(a[2]), _GAMMA6_2),
    )


def fq12_frobenius(a: Fq12) -> Fq12:
    c0 = fq6_frobenius(a[0])
    c1 = fq6_frobenius(a[1])
    return (c0, tuple(fq2_mul(c, _GAMMA12) for c in c1))


def fq12_frobenius_n(a: Fq12, n: int) -> Fq12:
    for _ in range(n):
        a = fq12_frobenius(a)
    return a
