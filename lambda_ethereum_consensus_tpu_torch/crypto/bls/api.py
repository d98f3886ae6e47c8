"""Eth2 BLS signature API (minimal-pubkey-size scheme: pubkeys G1, sigs G2).

Mirrors the reference's ``Bls`` module surface — ``sign/2``, ``verify/3``,
``aggregate/1``, ``aggregate_verify/3``, ``fast_aggregate_verify/3``,
``eth_fast_aggregate_verify/3``, ``eth_aggregate_pubkeys/1``, ``key_validate/1``
(ref: lib/bls.ex:7-50 and native/bls_nif/src/lib.rs:14-145).  All byte-level
inputs; failures return ``False``/raise :class:`BlsError` the way the NIF
returns ``{:error, reason}`` tuples.

The port's own copy of the JAX package's ``crypto/bls/api.py``: the
pure-Python host backend.  It is the oracle the port's device signing
(:mod:`...ops.bls_sign`) and byte-level batch verification (:mod:`.batch`)
are held against.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Sequence

from . import curve as C
from .curve import DeserializationError
from .hash_to_curve import DST_POP, hash_to_g2
from .pairing import pairing_check
from .fields import R

__all__ = [
    "BlsError",
    "sign",
    "verify",
    "aggregate",
    "aggregate_verify",
    "fast_aggregate_verify",
    "eth_fast_aggregate_verify",
    "eth_aggregate_pubkeys",
    "key_validate",
    "sk_to_pk",
    "keygen",
]

G2_POINT_AT_INFINITY = bytes([0xC0]) + b"\x00" * 95


class BlsError(ValueError):
    """Invalid key/signature material."""


def _sk_scalar(private_key: bytes) -> int:
    if len(private_key) != 32:
        raise BlsError("private key must be 32 bytes")
    sk = int.from_bytes(private_key, "big")
    if sk == 0 or sk >= R:
        raise BlsError("private key out of range")
    return sk


def sk_to_pk(private_key: bytes) -> bytes:
    """Compressed 48-byte public key for a 32-byte big-endian secret key."""
    return C.g1_to_bytes(C.g1.multiply(C.G1_GENERATOR, _sk_scalar(private_key)))


def keygen(ikm: bytes, key_info: bytes = b"") -> bytes:
    """KeyGen per draft-irtf-cfrg-bls-signature-05 §2.3 (HKDF mod r)."""
    if len(ikm) < 32:
        raise BlsError("IKM must be at least 32 bytes")
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk.to_bytes(32, "big")


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    import hmac

    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    import hmac

    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def sign(private_key: bytes, message: bytes, dst: bytes = DST_POP) -> bytes:
    """Sign: sk * hash_to_G2(message), compressed (ref: lib/bls.ex:8-11)."""
    sk = _sk_scalar(private_key)
    return C.g2_to_bytes(C.g2.multiply(hash_to_g2(message, dst), sk))


@functools.lru_cache(maxsize=65536)
def _pubkey_point(public_key: bytes) -> C.AffinePoint:
    """Decompression+subgroup check cached per pubkey — the validator set
    recurs on every attestation, the ~1.5 ms subgroup check need not."""
    return C.g1_from_bytes(public_key)


def _load_pubkey(public_key: bytes) -> C.AffinePoint:
    pt = _pubkey_point(bytes(public_key))
    if pt is None:
        raise BlsError("public key is the identity")
    return pt


def verify(public_key: bytes, message: bytes, signature: bytes, dst: bytes = DST_POP) -> bool:
    """e(pk, H(m)) == e(g1, sig) (ref: lib/bls.ex:19-22)."""
    try:
        pk = _load_pubkey(public_key)
        sig = C.g2_from_bytes(signature)
    except (DeserializationError, BlsError):
        return False
    if sig is None:
        return False
    return pairing_check(
        [
            (pk, hash_to_g2(message, dst)),
            (C.g1.affine_neg(C.G1_GENERATOR), sig),
        ]
    )


def aggregate(signatures: Sequence[bytes]) -> bytes:
    """Sum signatures in G2; errors on empty input (ref: lib/bls.ex:24-27)."""
    if not signatures:
        raise BlsError("cannot aggregate empty signature list")
    acc: C.AffinePoint = None
    for raw in signatures:
        try:
            acc = C.g2.affine_add(acc, C.g2_from_bytes(raw))
        except DeserializationError as e:
            raise BlsError(f"invalid signature in aggregate: {e}") from None
    return C.g2_to_bytes(acc)


def aggregate_verify(
    pubkeys: Sequence[bytes],
    messages: Sequence[bytes],
    signature: bytes,
    dst: bytes = DST_POP,
) -> bool:
    """prod e(pk_i, H(m_i)) == e(g1, sig) (ref: lib/bls.ex:29-33)."""
    if len(pubkeys) != len(messages) or not pubkeys:
        return False
    try:
        pks = [_load_pubkey(pk) for pk in pubkeys]
        sig = C.g2_from_bytes(signature)
    except (DeserializationError, BlsError):
        return False
    if sig is None:
        return False
    pairs = [(pk, hash_to_g2(msg, dst)) for pk, msg in zip(pks, messages)]
    pairs.append((C.g1.affine_neg(C.G1_GENERATOR), sig))
    return pairing_check(pairs)


def fast_aggregate_verify(
    pubkeys: Sequence[bytes],
    message: bytes,
    signature: bytes,
    dst: bytes = DST_POP,
) -> bool:
    """All pubkeys sign the same message: aggregate pubkeys first
    (ref: lib/bls.ex:35-39)."""
    if not pubkeys:
        return False
    try:
        agg: C.AffinePoint = None
        for pk in pubkeys:
            agg = C.g1.affine_add(agg, _load_pubkey(pk))
        sig = C.g2_from_bytes(signature)
    except (DeserializationError, BlsError):
        return False
    if sig is None or agg is None:
        return False
    return pairing_check(
        [
            (agg, hash_to_g2(message, dst)),
            (C.g1.affine_neg(C.G1_GENERATOR), sig),
        ]
    )


def eth_fast_aggregate_verify(
    pubkeys: Sequence[bytes],
    message: bytes,
    signature: bytes,
    dst: bytes = DST_POP,
) -> bool:
    """Consensus-spec variant: vacuously true for no signers + infinity sig
    (ref: lib/bls.ex:41-45; spec: eth_fast_aggregate_verify)."""
    if not pubkeys and signature == G2_POINT_AT_INFINITY:
        return True
    return fast_aggregate_verify(pubkeys, message, signature, dst)


def eth_aggregate_pubkeys(pubkeys: Sequence[bytes]) -> bytes:
    """Sum pubkeys in G1; errors on empty/invalid input
    (ref: lib/bls.ex:47-50; spec: eth_aggregate_pubkeys)."""
    if not pubkeys:
        raise BlsError("cannot aggregate empty pubkey list")
    acc: C.AffinePoint = None
    for raw in pubkeys:
        try:
            acc = C.g1.affine_add(acc, _load_pubkey(raw))
        except DeserializationError as e:
            raise BlsError(f"invalid pubkey: {e}") from None
    return C.g1_to_bytes(acc)


def key_validate(public_key: bytes) -> bool:
    """KeyValidate: deserializes, not identity, in subgroup
    (ref: native/bls_nif/src/lib.rs:139-145 ``validate_key``)."""
    try:
        return C.g1_from_bytes(public_key) is not None
    except DeserializationError:
        return False
