"""BLS12-381 curve groups G1 (over Fq) and G2 (over Fq2, on the M-twist).

Points are affine pairs ``(x, y)`` or ``None`` for the identity; scalar
multiplication runs in Jacobian coordinates internally.  Serialization follows
the ZCash 48/96-byte compressed format the beacon-chain spec mandates
(compression / infinity / sign flags in the top three bits of byte 0), which
is the wire format the reference's NIF consumes (ref: native/bls_nif/src/
lib.rs:26-60 — pubkeys as 48-byte binaries, signatures as 96-byte binaries).

Generator coordinates are the standard published values; import-time asserts
verify they satisfy the curve equations and have order R, so a transcription
error cannot survive module import.

The port's own copy of the JAX package's ``crypto/bls/curve.py``.  Scalar
multiplication and the batch decoders take the native library
(:mod:`.native`, bound after its self-check) unless :func:`.native.enabled`
is off; the pure-Python path stays as the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from . import fields as F
from . import native as _native
from .fields import P, R

AffinePoint = Optional[Tuple[Any, Any]]


@dataclass(frozen=True)
class GroupOps:
    """Affine/Jacobian arithmetic for one curve y^2 = x^3 + b over one field."""

    b: Any
    add: Callable
    sub: Callable
    mul: Callable
    sq: Callable
    inv: Callable
    neg: Callable
    zero: Any
    one: Any
    is_zero: Callable
    # the native library's scalar multiplication, same (pt, k) -> pt
    # contract as _multiply_py; taken while native.enabled()
    native_mul: Callable | None = None

    def scalar(self, a, k: int):
        if isinstance(a, int):
            return a * k % P
        return F.fq2_scalar(a, k)

    # -- curve predicates
    def on_curve(self, pt: AffinePoint) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self.sq(y) == self.add(self.mul(self.sq(x), x), self.b)

    # -- affine group law (used sparingly; hot paths go through Jacobian)
    def affine_neg(self, pt: AffinePoint) -> AffinePoint:
        return None if pt is None else (pt[0], self.neg(pt[1]))

    def affine_add(self, p1: AffinePoint, p2: AffinePoint) -> AffinePoint:
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 == y2:
                if self.is_zero(y1):
                    return None
                s = self.mul(self.scalar(self.sq(x1), 3), self.inv(self.scalar(y1, 2)))
            else:
                return None
        else:
            s = self.mul(self.sub(y2, y1), self.inv(self.sub(x2, x1)))
        x3 = self.sub(self.sub(self.sq(s), x1), x2)
        y3 = self.sub(self.mul(s, self.sub(x1, x3)), y1)
        return (x3, y3)

    # -- Jacobian core: (X, Y, Z) represents (X/Z^2, Y/Z^3)
    def to_jacobian(self, pt: AffinePoint):
        if pt is None:
            return (self.one, self.one, self.zero)
        return (pt[0], pt[1], self.one)

    def from_jacobian(self, pt) -> AffinePoint:
        x, y, z = pt
        if self.is_zero(z):
            return None
        zinv = self.inv(z)
        zinv2 = self.sq(zinv)
        return (self.mul(x, zinv2), self.mul(y, self.mul(zinv2, zinv)))

    def jac_double(self, pt):
        x, y, z = pt
        if self.is_zero(z) or self.is_zero(y):
            return (self.one, self.one, self.zero)
        a = self.sq(x)
        b = self.sq(y)
        c = self.sq(b)
        d = self.scalar(self.sub(self.sub(self.sq(self.add(x, b)), a), c), 2)
        e = self.scalar(a, 3)
        f = self.sq(e)
        x3 = self.sub(f, self.scalar(d, 2))
        y3 = self.sub(self.mul(e, self.sub(d, x3)), self.scalar(c, 8))
        z3 = self.scalar(self.mul(y, z), 2)
        return (x3, y3, z3)

    def jac_add(self, p1, p2):
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        if self.is_zero(z1):
            return p2
        if self.is_zero(z2):
            return p1
        z1z1 = self.sq(z1)
        z2z2 = self.sq(z2)
        u1 = self.mul(x1, z2z2)
        u2 = self.mul(x2, z1z1)
        s1 = self.mul(self.mul(y1, z2), z2z2)
        s2 = self.mul(self.mul(y2, z1), z1z1)
        if u1 == u2:
            if s1 == s2:
                return self.jac_double(p1)
            return (self.one, self.one, self.zero)
        h = self.sub(u2, u1)
        i = self.sq(self.scalar(h, 2))
        j = self.mul(h, i)
        rr = self.scalar(self.sub(s2, s1), 2)
        v = self.mul(u1, i)
        x3 = self.sub(self.sub(self.sq(rr), j), self.scalar(v, 2))
        y3 = self.sub(self.mul(rr, self.sub(v, x3)), self.scalar(self.mul(s1, j), 2))
        z3 = self.mul(self.scalar(self.mul(z1, z2), 2), h)
        return (x3, y3, z3)

    def multiply(self, pt: AffinePoint, k: int) -> AffinePoint:
        """Scalar multiplication with the scalar reduced mod R."""
        return self.multiply_raw(pt, k % R)

    def multiply_raw(self, pt: AffinePoint, k: int) -> AffinePoint:
        """Scalar multiplication WITHOUT reducing k mod R (cofactor clearing)."""
        if pt is None or k == 0:
            return None
        if self.native_mul is not None and _native.enabled():
            return self.native_mul(pt, k)
        return self._multiply_py(pt, k)

    def _multiply_py(self, pt: AffinePoint, k: int) -> AffinePoint:
        acc = (self.one, self.one, self.zero)
        base = self.to_jacobian(pt)
        while k:
            if k & 1:
                acc = self.jac_add(acc, base)
            base = self.jac_double(base)
            k >>= 1
        return self.from_jacobian(acc)

    def in_subgroup(self, pt: AffinePoint) -> bool:
        return self.on_curve(pt) and self.multiply_raw(pt, R) is None


def _int_is_zero(a: int) -> bool:
    return a % P == 0


g1 = GroupOps(
    b=4,
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    sq=lambda a: a * a % P,
    inv=lambda a: F._fq_powmod(a, P - 2),
    neg=lambda a: -a % P,
    zero=0,
    one=1,
    is_zero=_int_is_zero,
    native_mul=_native.g1_mul,
)

# The M-twist E': y^2 = x^3 + 4(1+u)
g2 = GroupOps(
    b=(4, 4),
    add=F.fq2_add,
    sub=F.fq2_sub,
    mul=F.fq2_mul,
    sq=F.fq2_sq,
    inv=F.fq2_inv,
    neg=F.fq2_neg,
    zero=F.FQ2_ZERO,
    one=F.FQ2_ONE,
    is_zero=F.fq2_is_zero,
    native_mul=_native.g2_mul,
)

G1_GENERATOR: AffinePoint = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GENERATOR: AffinePoint = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# Transcription-error firewall: the published generators must be on-curve and
# of order R, or this module refuses to import (on the pure-Python path:
# importing builds nothing).
with _native.pure_python():
    assert g1.on_curve(G1_GENERATOR), "G1 generator not on y^2 = x^3 + 4"
    assert g2.on_curve(G2_GENERATOR), "G2 generator not on the twist"
    assert g1.multiply_raw(G1_GENERATOR, R) is None, "G1 generator order != R"
    assert g2.multiply_raw(G2_GENERATOR, R) is None, "G2 generator order != R"


# ------------------------------------------------------------ serialization
#
# ZCash compressed encoding: 48 bytes (G1) / 96 bytes (G2), big-endian x with
# three flag bits folded into the most significant byte:
#   bit7 C: compression flag (always 1 here)
#   bit6 I: infinity flag
#   bit5 S: sign flag (y is the lexicographically larger of {y, -y})

_C_FLAG = 0x80
_I_FLAG = 0x40
_S_FLAG = 0x20
_HALF_P = (P - 1) // 2


class DeserializationError(ValueError):
    """Input is not a valid compressed point encoding."""


def _fq_is_larger(y: int) -> bool:
    return y > _HALF_P


def _fq2_is_larger(y: F.Fq2) -> bool:
    if y[1] != 0:
        return y[1] > _HALF_P
    return y[0] > _HALF_P


def g1_to_bytes(pt: AffinePoint) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 47
    x, y = pt
    flags = _C_FLAG | (_S_FLAG if _fq_is_larger(y) else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_to_bytes(pt: AffinePoint) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 95
    (x0, x1), y = pt
    flags = _C_FLAG | (_S_FLAG if _fq2_is_larger(y) else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def _split_flags(data: bytes, size: int) -> tuple[int, bool, bool]:
    if len(data) != size:
        raise DeserializationError(f"expected {size} bytes, got {len(data)}")
    byte0 = data[0]
    if not byte0 & _C_FLAG:
        raise DeserializationError("uncompressed encodings not supported")
    infinity = bool(byte0 & _I_FLAG)
    sign = bool(byte0 & _S_FLAG)
    if infinity and sign:
        # non-canonical: the ZCash format forbids S with I (blst rejects too)
        raise DeserializationError("sign flag set on infinity encoding")
    return byte0 & 0x1F, infinity, sign


def g1_from_bytes(data: bytes, subgroup_check: bool = True) -> AffinePoint:
    """Decompress a G1 point.

    ``subgroup_check=False`` skips the prime-order check and is ONLY safe
    for points that never reach a pairing: the branch-free device pairing
    route assumes prime-order inputs (small-order points yield silently
    wrong results there, unlike the host loop).  See pairing.pairing_check
    and the BLS_DEBUG_SUBGROUP probe.
    """
    top, infinity, sign = _split_flags(data, 48)
    body = bytes([top]) + data[1:]
    if infinity:
        if any(body):
            raise DeserializationError("non-zero bytes in infinity encoding")
        return None
    x = int.from_bytes(body, "big")
    if x >= P:
        raise DeserializationError("x out of range")
    y2 = (x * x % P * x + 4) % P
    y = F.fq_sqrt(y2)
    if y is None:
        raise DeserializationError("x not on curve")
    if _fq_is_larger(y) != sign:
        y = -y % P
    pt = (x, y)
    if subgroup_check and g1.multiply_raw(pt, R) is not None:
        raise DeserializationError("point not in G1 subgroup")
    return pt


def g2_from_bytes(data: bytes, subgroup_check: bool = True) -> AffinePoint:
    """Decompress a G2 point (twist coordinates).

    ``subgroup_check=False`` is ONLY safe for points that never reach a
    pairing — see :func:`g1_from_bytes`.
    """
    top, infinity, sign = _split_flags(data, 96)
    body = bytes([top]) + data[1:]
    if infinity:
        if any(body):
            raise DeserializationError("non-zero bytes in infinity encoding")
        return None
    x1 = int.from_bytes(body[:48], "big")
    x0 = int.from_bytes(body[48:], "big")
    if x0 >= P or x1 >= P:
        raise DeserializationError("x out of range")
    x = (x0, x1)
    y2 = F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), (4, 4))
    y = F.fq2_sqrt(y2)
    if y is None:
        raise DeserializationError("x not on twist")
    if _fq2_is_larger(y) != sign:
        y = F.fq2_neg(y)
    pt = (x, y)
    if subgroup_check and g2.multiply_raw(pt, R) is not None:
        raise DeserializationError("point not in G2 subgroup")
    return pt


def _from_bytes_batch(decode, blobs, subgroup_check: bool) -> list:
    res = []
    for b in blobs:
        try:
            res.append(decode(bytes(b), subgroup_check))
        except DeserializationError:
            res.append(False)
    return res


def g1_from_bytes_batch(blobs, subgroup_check: bool = True) -> list:
    """Batch :func:`g1_from_bytes`: the native library's thread-pool
    decompression with the endomorphism subgroup check, or point by point
    when :func:`.native.enabled` is off.  Per item: affine point | ``None``
    (canonical infinity) | ``False`` (invalid encoding, length, point or
    subgroup) — batch callers need per-item verdicts, not a first-failure
    exception."""
    if _native.enabled():
        return _native.g1_decompress_batch(blobs, subgroup_check)
    return _from_bytes_batch(g1_from_bytes, blobs, subgroup_check)


def g2_from_bytes_batch(blobs, subgroup_check: bool = True) -> list:
    """Batch :func:`g2_from_bytes`; same conventions as the G1 batch."""
    if _native.enabled():
        return _native.g2_decompress_batch(blobs, subgroup_check)
    return _from_bytes_batch(g2_from_bytes, blobs, subgroup_check)
