"""hash_to_G2: the BLS12381G2_XMD:SHA-256_SSWU_RO ciphersuite (RFC 9380).

The beacon chain signs ``hash_to_G2(message)`` with the proof-of-possession
DST; the reference gets this from blst via Lighthouse's ``bls`` crate (ref:
native/bls_nif/src/lib.rs:33-47).  Pipeline implemented here:

    expand_message_xmd(SHA-256) -> hash_to_field(Fq2, count=2)
    -> simplified SWU on the 3-isogenous curve E2'
    -> 3-isogeny map to E2  -> point add -> clear cofactor (h_eff)

The port's own copy of the JAX package's ``crypto/bls/hash_to_curve.py``.
:func:`hash_to_g2` and :func:`hash_to_g2_many` take the native library's
batch hasher (:mod:`.native`, bound after its self-check) unless
:func:`.native.enabled` is off; the pure-Python pipeline stays as the oracle.

Every long constant block below (isogeny coefficients, h_eff) is verified by
import-time self-checks: a sample input must land on E2' after SSWU, on E2
after the isogeny, and in the R-torsion after cofactor clearing — so a wrong
constant cannot survive import.
"""

from __future__ import annotations

import hashlib

from . import fields as F
from . import native
from .curve import AffinePoint, g2
from .fields import P, R

DST_POP = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# SSWU curve E2': y^2 = x^3 + A'x + B' (3-isogenous to the M-twist E2)
_A = (0, 240)
_B = (1012, 1012)
_Z = (-2 % P, -1 % P)

# Effective cofactor for G2 cofactor clearing (RFC 9380 §8.8.2).
_H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


# --------------------------------------------------- expand/hash to field

def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """expand_message_xmd with SHA-256 (RFC 9380 §5.3.1)."""
    if len(dst) > 255:
        dst = b"H2C-OVERSIZE-DST-" + hashlib.sha256(dst).digest()
    b_in_bytes = 32
    r_in_bytes = 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255:
        raise ValueError("requested output too long")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * r_in_bytes
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b_prev = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b_prev]
    for i in range(2, ell + 1):
        mixed = bytes(x ^ y for x, y in zip(b0, b_prev))
        b_prev = hashlib.sha256(mixed + i.to_bytes(1, "big") + dst_prime).digest()
        out.append(b_prev)
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes) -> list[F.Fq2]:
    """hash_to_field for Fq2 elements (m=2, L=64; RFC 9380 §5.2)."""
    l_param = 64
    data = expand_message_xmd(msg, dst, count * 2 * l_param)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = l_param * (j + i * 2)
            coords.append(int.from_bytes(data[off : off + l_param], "big") % P)
        out.append(tuple(coords))
    return out


# --------------------------------------------------------------- SSWU map

def _sgn0(x: F.Fq2) -> int:
    """sgn0 for m=2 (RFC 9380 §4.1)."""
    sign_0 = x[0] % 2
    zero_0 = x[0] == 0
    sign_1 = x[1] % 2
    return sign_0 | (zero_0 & sign_1)


def _sswu(u: F.Fq2) -> AffinePoint:
    """Simplified SWU for AB != 0, mapping Fq2 -> E2' (RFC 9380 §6.6.2)."""
    zu2 = F.fq2_mul(_Z, F.fq2_sq(u))
    tv = F.fq2_add(F.fq2_sq(zu2), zu2)  # Z^2 u^4 + Z u^2
    if F.fq2_is_zero(tv):
        # exceptional case: x1 = B / (Z A)
        x1 = F.fq2_mul(_B, F.fq2_inv(F.fq2_mul(_Z, _A)))
    else:
        tv1 = F.fq2_inv(tv)
        x1 = F.fq2_mul(
            F.fq2_mul(F.fq2_neg(_B), F.fq2_inv(_A)),
            F.fq2_add(F.FQ2_ONE, tv1),
        )
    gx1 = F.fq2_add(F.fq2_add(F.fq2_mul(F.fq2_sq(x1), x1), F.fq2_mul(_A, x1)), _B)
    y = F.fq2_sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x = F.fq2_mul(zu2, x1)
        gx2 = F.fq2_add(F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), F.fq2_mul(_A, x)), _B)
        y = F.fq2_sqrt(gx2)
        assert y is not None, "SSWU: neither gx1 nor gx2 is square (impossible)"
    if _sgn0(u) != _sgn0(y):
        y = F.fq2_neg(y)
    return (x, y)


# ------------------------------------------------------- 3-isogeny to E2
#
# Instead of transcribing the RFC 9380 Appendix E.3 coefficient tables, the
# isogeny is *derived* at import time with Vélu's formulas.  The kernel of the
# 3-isogeny E2' -> E2 is {O, ±T} with x_T = -6 + 6u (verified below against
# the 3-division polynomial of E2').  Vélu gives a normalized isogeny onto
# y^2 = x^3 + 2916(1+u); composing with the isomorphism (x, y) ->
# (x/9, -y/27) lands exactly on E2: y^2 = x^3 + 4(1+u).  The sign/scaling
# choice (c^2 = 1/9, c^3 = -1/27) is the one that reproduces the RFC
# coefficient tables, so hash outputs are ciphersuite-exact.


def _derive_isogeny():
    x0 = (-6 % P, 6)
    x0sq = F.fq2_sq(x0)
    # psi3(x0) = 3x^4 + 6Ax^2 + 12Bx - A^2 must vanish: x0 generates the kernel
    psi3 = F.fq2_sub(
        F.fq2_add(
            F.fq2_add(
                F.fq2_scalar(F.fq2_sq(x0sq), 3), F.fq2_scalar(F.fq2_mul(_A, x0sq), 6)
            ),
            F.fq2_scalar(F.fq2_mul(_B, x0), 12),
        ),
        F.fq2_sq(_A),
    )
    assert F.fq2_is_zero(psi3), "x0 is not in the 3-torsion of E2'"
    # Vélu sums over the single ± representative T
    t = F.fq2_add(F.fq2_scalar(x0sq, 6), F.fq2_scalar(_A, 2))  # 2(3x0^2 + A)
    u = F.fq2_scalar(
        F.fq2_add(F.fq2_add(F.fq2_mul(x0sq, x0), F.fq2_mul(_A, x0)), _B), 4
    )  # 4 y0^2
    # phi(x) = [x(x-x0)^2 + t(x-x0) + u] / (x-x0)^2 ; phi_y = y phi'(x)
    c2 = pow(9, P - 2, P)  # 1/9
    c3 = P - pow(27, P - 2, P)  # -1/27
    x_num = [
        F.fq2_scalar(F.fq2_sub(u, F.fq2_mul(t, x0)), c2),
        F.fq2_scalar(F.fq2_add(x0sq, t), c2),
        F.fq2_scalar(F.fq2_scalar(x0, P - 2), c2),
        (c2, 0),
    ]
    x_den = [  # (x - x0)^2
        x0sq,
        F.fq2_scalar(x0, P - 2),
        F.FQ2_ONE,
    ]
    y_num = [  # c3 * [(x-x0)^3 - t(x-x0) - 2u]
        F.fq2_scalar(
            F.fq2_add(
                F.fq2_sub(F.fq2_mul(t, x0), F.fq2_mul(x0sq, x0)),
                F.fq2_scalar(u, P - 2),
            ),
            c3,
        ),
        F.fq2_scalar(F.fq2_sub(F.fq2_scalar(x0sq, 3), t), c3),
        F.fq2_scalar(F.fq2_scalar(x0, P - 3), c3),
        (c3, 0),
    ]
    y_den = [  # (x - x0)^3
        F.fq2_scalar(F.fq2_mul(x0sq, x0), P - 1),
        F.fq2_scalar(x0sq, 3),
        F.fq2_scalar(x0, P - 3),
        F.FQ2_ONE,
    ]
    return x_num, x_den, y_num, y_den


with native.pure_python():  # importing builds nothing
    _ISO_X_NUM, _ISO_X_DEN, _ISO_Y_NUM, _ISO_Y_DEN = _derive_isogeny()


def _horner(coeffs: list[F.Fq2], x: F.Fq2) -> F.Fq2:
    acc = F.FQ2_ZERO
    for c in reversed(coeffs):
        acc = F.fq2_add(F.fq2_mul(acc, x), c)
    return acc


def iso_map(pt: AffinePoint) -> AffinePoint:
    """3-isogeny E2' -> E2."""
    if pt is None:
        return None
    x, y = pt
    x_num = _horner(_ISO_X_NUM, x)
    x_den = _horner(_ISO_X_DEN, x)
    y_num = _horner(_ISO_Y_NUM, x)
    y_den = _horner(_ISO_Y_DEN, x)
    if F.fq2_is_zero(x_den) or F.fq2_is_zero(y_den):
        return None
    return (
        F.fq2_mul(x_num, F.fq2_inv(x_den)),
        F.fq2_mul(y, F.fq2_mul(y_num, F.fq2_inv(y_den))),
    )


def clear_cofactor(pt: AffinePoint) -> AffinePoint:
    return g2.multiply_raw(pt, _H_EFF)


def hash_to_g2(msg: bytes, dst: bytes = DST_POP) -> AffinePoint:
    """hash_to_curve for G2 (random-oracle variant)."""
    if native.enabled():
        return native.hash_to_g2_batch([msg], dst)[0]
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = iso_map(_sswu(u0))
    q1 = iso_map(_sswu(u1))
    return clear_cofactor(g2.affine_add(q0, q1))


def hash_to_g2_many(msgs, dst: bytes = DST_POP) -> list[AffinePoint]:
    """:func:`hash_to_g2` of each message, in order: one native batch
    across a C++ thread pool, or the Python pipeline per message."""
    if msgs and native.enabled():
        return native.hash_to_g2_batch(list(msgs), dst)
    return [hash_to_g2(m, dst) for m in msgs]


# ----------------------------------------------------- import self-checks
#
# A fixed sample must land on E2' after SSWU, on E2 after the isogeny, and in
# the R-torsion after clearing the cofactor; otherwise a constant above is
# mistranscribed and we refuse to import.

_sswu_ops_curve = type(g2)(
    b=_B,
    add=F.fq2_add,
    sub=F.fq2_sub,
    mul=F.fq2_mul,
    sq=F.fq2_sq,
    inv=F.fq2_inv,
    neg=F.fq2_neg,
    zero=F.FQ2_ZERO,
    one=F.FQ2_ONE,
    is_zero=F.fq2_is_zero,
)


def _on_sswu_curve(pt: AffinePoint) -> bool:
    if pt is None:
        return False
    x, y = pt
    rhs = F.fq2_add(F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), F.fq2_mul(_A, x)), _B)
    return F.fq2_sq(y) == rhs


def _self_check() -> None:
    sample = _sswu((5, 7))
    assert _on_sswu_curve(sample), "SSWU output not on E2' (A/B/Z wrong)"
    mapped = iso_map(sample)
    assert g2.on_curve(mapped), "isogeny output not on E2 (iso constants wrong)"
    cleared = clear_cofactor(mapped)
    assert cleared is not None and g2.multiply_raw(cleared, R) is None, (
        "cofactor-cleared point not in G2 subgroup (h_eff wrong)"
    )


with native.pure_python():
    _self_check()
