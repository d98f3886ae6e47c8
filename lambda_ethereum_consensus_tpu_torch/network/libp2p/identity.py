"""libp2p peer identities: ed25519 keys, peer IDs, the noise payload.

Wire formats from the libp2p specs (peer-ids + noise):

- ``PublicKey`` protobuf: ``field 1 = KeyType (varint)``, ``field 2 =
  Data (bytes)``; ed25519 ``Data`` is the raw 32-byte public key.
- Peer ID: a multihash of the serialized ``PublicKey``.  Keys whose
  serialization is <= 42 bytes (ed25519's is 36) use the *identity*
  multihash ``0x00 || len || bytes``; longer keys hash with sha2-256
  (``0x12 0x20 || digest``).  Text form is base58btc.
- ``NoiseHandshakePayload`` protobuf: ``identity_key = 1`` (the
  serialized PublicKey), ``identity_sig = 2`` — an ed25519 signature by
  the identity key over ``"noise-libp2p-static-key:" || noise_static_pub``,
  binding the long-term libp2p identity to the ephemeral noise key.

The reference gets all of this from go-libp2p's crypto package; here it
is implemented directly (the two protobuf messages are hand-coded — two
fields each — so no codegen dependency).

The port's copy of the JAX package's ``network/libp2p/identity.py``; the
bytes it puts on the wire are the JAX module's.
"""

from __future__ import annotations

import hashlib

try:
    # optional: only key generation/signing/verification need it — the
    # PeerId/multihash/base58/protobuf layers are pure and stay
    # importable so the pure-frame wire modules (yamux, gossipsub
    # control plane) can be exercised without the crypto stack
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
except ImportError:  # pragma: no cover - environment-dependent
    serialization = None  # type: ignore[assignment]
    Ed25519PrivateKey = None  # type: ignore[assignment]
    Ed25519PublicKey = None  # type: ignore[assignment]

KEY_ED25519 = 1  # enum KeyType { RSA=0; Ed25519=1; Secp256k1=2; ECDSA=3 }

NOISE_SIG_PREFIX = b"noise-libp2p-static-key:"

_B58_ALPHABET = b"123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


class IdentityError(Exception):
    pass


# ---------------------------------------------------------------- base58btc

def base58_encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = bytearray()
    while n:
        n, rem = divmod(n, 58)
        out.append(_B58_ALPHABET[rem])
    # leading zero bytes encode as '1's
    for b in data:
        if b:
            break
        out.append(_B58_ALPHABET[0])
    return bytes(reversed(out)).decode()


def base58_decode(text: str) -> bytes:
    n = 0
    for ch in text.encode():
        idx = _B58_ALPHABET.find(bytes([ch]))
        if idx < 0:
            raise IdentityError(f"invalid base58 character {ch!r}")
        n = n * 58 + idx
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
    pad = 0
    for ch in text:
        if ch != "1":
            break
        pad += 1
    return b"\x00" * pad + raw


# ----------------------------------------------------- minimal protobuf I/O

from . import varint


def _pb_varint(n: int) -> bytes:
    return varint.encode(n)


def _pb_read_varint(data: bytes, pos: int) -> tuple[int, int]:
    try:
        return varint.decode(data, pos)
    except varint.VarintError as e:
        raise IdentityError(str(e)) from None


def _pb_fields(data: bytes) -> dict[int, bytes | int]:
    """Parse a flat protobuf message into {field_number: value} (last one
    wins; only varint and length-delimited wire types appear in the two
    libp2p messages handled here)."""
    fields: dict[int, bytes | int] = {}
    pos = 0
    while pos < len(data):
        key, pos = _pb_read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _pb_read_varint(data, pos)
            fields[field] = value
        elif wire == 2:
            length, pos = _pb_read_varint(data, pos)
            if pos + length > len(data):
                raise IdentityError("truncated length-delimited field")
            fields[field] = data[pos : pos + length]
            pos += length
        else:
            raise IdentityError(f"unsupported wire type {wire}")
    return fields


def encode_public_key_pb(key_type: int, data: bytes) -> bytes:
    return b"\x08" + _pb_varint(key_type) + b"\x12" + _pb_varint(len(data)) + data


def decode_public_key_pb(raw: bytes) -> tuple[int, bytes]:
    fields = _pb_fields(raw)
    if 1 not in fields or 2 not in fields:
        raise IdentityError("PublicKey missing Type/Data")
    return int(fields[1]), bytes(fields[2])


# ------------------------------------------------------------------ peer id

class PeerId:
    """A libp2p peer ID (multihash bytes + base58 text form)."""

    __slots__ = ("bytes",)

    def __init__(self, raw: bytes):
        self.bytes = raw

    @classmethod
    def from_public_key_pb(cls, pub_pb: bytes) -> "PeerId":
        if len(pub_pb) <= 42:  # identity multihash
            return cls(b"\x00" + _pb_varint(len(pub_pb)) + pub_pb)
        digest = hashlib.sha256(pub_pb).digest()
        return cls(b"\x12\x20" + digest)

    def pretty(self) -> str:
        return base58_encode(self.bytes)

    def __eq__(self, other) -> bool:
        return isinstance(other, PeerId) and self.bytes == other.bytes

    def __hash__(self) -> int:
        return hash(self.bytes)

    def __repr__(self) -> str:
        return f"PeerId({self.pretty()})"


# ----------------------------------------------------------------- identity

class Identity:
    """Local ed25519 identity: signs noise payloads, derives the peer ID."""

    def __init__(self, private: Ed25519PrivateKey | None = None):
        if Ed25519PrivateKey is None:
            raise IdentityError(
                "libp2p identities need the optional 'cryptography' module"
            )
        self.private = private or Ed25519PrivateKey.generate()
        pub = self.private.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
        self.public_pb = encode_public_key_pb(KEY_ED25519, pub)
        self.peer_id = PeerId.from_public_key_pb(self.public_pb)

    @classmethod
    def from_seed(cls, seed: bytes) -> "Identity":
        if Ed25519PrivateKey is None:  # same clear error as __init__
            raise IdentityError(
                "libp2p identities need the optional 'cryptography' module"
            )
        return cls(Ed25519PrivateKey.from_private_bytes(seed))

    def private_bytes(self) -> bytes:
        return self.private.private_bytes(
            serialization.Encoding.Raw,
            serialization.PrivateFormat.Raw,
            serialization.NoEncryption(),
        )

    def noise_payload(self, noise_static_pub: bytes) -> bytes:
        """The NoiseHandshakePayload proving this identity owns the noise
        static key (sent encrypted inside XX messages 2/3)."""
        sig = self.private.sign(NOISE_SIG_PREFIX + noise_static_pub)
        return (
            b"\x0a" + _pb_varint(len(self.public_pb)) + self.public_pb
            + b"\x12" + _pb_varint(len(sig)) + sig
        )


def verify_noise_payload(payload: bytes, noise_static_pub: bytes) -> PeerId:
    """Verify a remote NoiseHandshakePayload against the noise static key
    actually authenticated by the handshake; returns the proven PeerId."""
    fields = _pb_fields(payload)
    if 1 not in fields or 2 not in fields:
        raise IdentityError("noise payload missing identity_key/identity_sig")
    pub_pb, sig = bytes(fields[1]), bytes(fields[2])
    key_type, key_data = decode_public_key_pb(pub_pb)
    if key_type != KEY_ED25519:
        raise IdentityError(f"unsupported identity key type {key_type}")
    if Ed25519PublicKey is None:
        raise IdentityError(
            "verifying noise payloads needs the optional 'cryptography' module"
        )
    try:
        Ed25519PublicKey.from_public_bytes(key_data).verify(
            sig, NOISE_SIG_PREFIX + noise_static_pub
        )
    except Exception:
        raise IdentityError("bad identity signature over noise static key") from None
    return PeerId.from_public_key_pb(pub_pb)
