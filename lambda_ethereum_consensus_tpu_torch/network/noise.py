"""Noise_XX_25519_ChaChaPoly_SHA256 transport for the sidecar; the port's copy
of the JAX package's ``network/noise.py``, whose transcripts it matches byte
for byte under the same keys (``tests/test_torch_noise.py``).

The role of the reference's libp2p noise security layer (ref:
native/libp2p_port/internal/reqresp/reqresp.go:32-41 — go-libp2p dials
with noise + TCP): after the TCP connect and BEFORE any protocol frame,
both sides run the Noise XX handshake (mutual static-key authentication,
ephemeral forward secrecy), then every length-prefixed frame's payload is
AEAD-sealed with per-direction keys and counter nonces.

Implemented from the Noise Protocol Framework specification (rev 34):
HKDF chaining over the ck/h transcript, message patterns

    -> e
    <- e, ee, s, es
    -> s, se

with ChaCha20-Poly1305 AEAD and SHA-256.  The static x25519 key doubles
as the peer's transport identity: the HELLO frame that follows is bound
to the authenticated channel, so a fork-digest HELLO cannot be replayed
by a different key holder.

Primitives come from the `cryptography` package (X25519,
ChaCha20Poly1305); the handshake state machine itself is this module.  The
module imports without `cryptography` (its imports are gated at their
sites); opening a session then raises :class:`NoiseError`, and the port's
sidecar refuses to start rather than run in plaintext.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import struct

try:
    # optional: the module (incl. NoiseError, which frame-layer modules
    # catch in their teardown tuples) stays importable without the
    # crypto stack; actually opening a noise session raises below
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # pragma: no cover - environment-dependent
    X25519PrivateKey = None  # type: ignore[assignment]
    X25519PublicKey = None  # type: ignore[assignment]
    ChaCha20Poly1305 = None  # type: ignore[assignment]

PROTOCOL_NAME = b"Noise_XX_25519_ChaChaPoly_SHA256"
_MAX_NONCE = (1 << 64) - 1


class NoiseError(Exception):
    pass


def _hmac(key: bytes, data: bytes) -> bytes:
    return hmac_mod.new(key, data, hashlib.sha256).digest()


def _hkdf2(chaining_key: bytes, ikm: bytes) -> tuple[bytes, bytes]:
    temp = _hmac(chaining_key, ikm)
    out1 = _hmac(temp, b"\x01")
    out2 = _hmac(temp, out1 + b"\x02")
    return out1, out2


def _nonce_bytes(n: int) -> bytes:
    # Noise ChaChaPoly nonce: 4 zero bytes || little-endian counter
    return b"\x00\x00\x00\x00" + struct.pack("<Q", n)


class _CipherState:
    def __init__(self, key: bytes | None = None):
        self.key = key
        # construct the AEAD once — the key is fixed for this state's
        # lifetime and this sits on the per-frame hot path
        self._aead = ChaCha20Poly1305(key) if key is not None else None
        self.nonce = 0

    def encrypt(self, ad: bytes, plaintext: bytes) -> bytes:
        if self._aead is None:
            return plaintext
        if self.nonce >= _MAX_NONCE:
            raise NoiseError("nonce exhausted")
        out = self._aead.encrypt(_nonce_bytes(self.nonce), plaintext, ad)
        self.nonce += 1
        return out

    def decrypt(self, ad: bytes, ciphertext: bytes) -> bytes:
        if self._aead is None:
            return ciphertext
        if self.nonce >= _MAX_NONCE:
            raise NoiseError("nonce exhausted")
        try:
            out = self._aead.decrypt(_nonce_bytes(self.nonce), ciphertext, ad)
        except Exception as e:  # InvalidTag
            raise NoiseError(f"AEAD decrypt failed: {type(e).__name__}") from None
        self.nonce += 1
        return out


class _SymmetricState:
    def __init__(self):
        self.ck = hashlib.sha256(PROTOCOL_NAME).digest() if len(
            PROTOCOL_NAME
        ) > 32 else PROTOCOL_NAME.ljust(32, b"\x00")
        self.h = self.ck
        self.cipher = _CipherState()

    def mix_hash(self, data: bytes) -> None:
        self.h = hashlib.sha256(self.h + data).digest()

    def mix_key(self, ikm: bytes) -> None:
        self.ck, temp_k = _hkdf2(self.ck, ikm)
        self.cipher = _CipherState(temp_k)

    def encrypt_and_hash(self, plaintext: bytes) -> bytes:
        out = self.cipher.encrypt(self.h, plaintext)
        self.mix_hash(out)
        return out

    def decrypt_and_hash(self, ciphertext: bytes) -> bytes:
        out = self.cipher.decrypt(self.h, ciphertext)
        self.mix_hash(ciphertext)
        return out

    def split(self) -> tuple[_CipherState, _CipherState]:
        temp1 = _hmac(self.ck, b"")
        k1 = _hmac(temp1, b"\x01")
        k2 = _hmac(temp1, k1 + b"\x02")
        return _CipherState(k1), _CipherState(k2)


def _dh(priv: X25519PrivateKey, pub_bytes: bytes) -> bytes:
    out = priv.exchange(X25519PublicKey.from_public_bytes(pub_bytes))
    # contributory-behavior check: a low-order public point yields the
    # all-zero shared secret and attacker-predictable session keys;
    # `cryptography` rejects some such points but not all across versions
    # (ADVICE r2)
    if out == b"\x00" * 32:
        raise NoiseError("low-order X25519 public key (all-zero DH output)")
    return out


def _pub(priv: X25519PrivateKey) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return priv.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )


def _priv_bytes(priv: X25519PrivateKey) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return priv.private_bytes(
        serialization.Encoding.Raw,
        serialization.PrivateFormat.Raw,
        serialization.NoEncryption(),
    )


class NoiseSession:
    """One XX handshake + transport session.

    Usage: construct with the local static key, run
    ``write_message_1/read_message_1/...`` in pattern order (initiator:
    write1, read2, write3; responder: read1, write2, read3), then
    ``finalize()`` and use ``encrypt``/``decrypt``.
    """

    def __init__(self, static: X25519PrivateKey, initiator: bool):
        if ChaCha20Poly1305 is None:
            raise NoiseError(
                "noise transport needs the optional 'cryptography' module"
            )
        self.s = static
        self.initiator = initiator
        self.e: X25519PrivateKey | None = None
        self.re: bytes | None = None
        self.rs: bytes | None = None  # authenticated remote static key
        self.ss = _SymmetricState()
        self.ss.mix_hash(b"")  # empty prologue
        self._send: _CipherState | None = None
        self._recv: _CipherState | None = None

    # ---- message 1: -> e ------------------------------------------------
    def write_message_1(self) -> bytes:
        assert self.initiator
        self.e = X25519PrivateKey.generate()
        e_pub = _pub(self.e)
        self.ss.mix_hash(e_pub)
        return e_pub + self.ss.encrypt_and_hash(b"")

    def read_message_1(self, msg: bytes) -> None:
        assert not self.initiator
        if len(msg) < 32:
            raise NoiseError("short handshake message 1")
        self.re = msg[:32]
        self.ss.mix_hash(self.re)
        self.ss.decrypt_and_hash(msg[32:])

    # ---- message 2: <- e, ee, s, es ------------------------------------
    def write_message_2(self, payload: bytes = b"") -> bytes:
        """``payload`` rides encrypted under the es key — libp2p puts the
        responder's identity proof (NoiseHandshakePayload) here."""
        assert not self.initiator
        self.e = X25519PrivateKey.generate()
        e_pub = _pub(self.e)
        self.ss.mix_hash(e_pub)
        self.ss.mix_key(_dh(self.e, self.re))  # ee
        s_enc = self.ss.encrypt_and_hash(_pub(self.s))  # s
        self.ss.mix_key(_dh(self.s, self.re))  # es (responder: dh(s, re))
        return e_pub + s_enc + self.ss.encrypt_and_hash(payload)

    def read_message_2(self, msg: bytes) -> bytes:
        assert self.initiator
        if len(msg) < 32 + 48:
            raise NoiseError("short handshake message 2")
        self.re = msg[:32]
        self.ss.mix_hash(self.re)
        self.ss.mix_key(_dh(self.e, self.re))  # ee
        self.rs = self.ss.decrypt_and_hash(msg[32 : 32 + 48])  # s
        self.ss.mix_key(_dh(self.e, self.rs))  # es (initiator: dh(e, rs))
        return self.ss.decrypt_and_hash(msg[32 + 48 :])

    # ---- message 3: -> s, se -------------------------------------------
    def write_message_3(self, payload: bytes = b"") -> bytes:
        """``payload``: the initiator's identity proof in libp2p."""
        assert self.initiator
        s_enc = self.ss.encrypt_and_hash(_pub(self.s))  # s
        self.ss.mix_key(_dh(self.s, self.re))  # se (initiator: dh(s, re))
        return s_enc + self.ss.encrypt_and_hash(payload)

    def read_message_3(self, msg: bytes) -> bytes:
        assert not self.initiator
        if len(msg) < 48:
            raise NoiseError("short handshake message 3")
        self.rs = self.ss.decrypt_and_hash(msg[:48])  # s
        self.ss.mix_key(_dh(self.e, self.rs))  # se (responder: dh(e, rs))
        return self.ss.decrypt_and_hash(msg[48:])

    # ---- transport ------------------------------------------------------
    def finalize(self) -> None:
        c1, c2 = self.ss.split()
        # initiator sends with c1, responder with c2
        self._send, self._recv = (c1, c2) if self.initiator else (c2, c1)

    @property
    def remote_static(self) -> bytes:
        if self.rs is None:
            raise NoiseError("handshake incomplete")
        return self.rs

    def encrypt(self, plaintext: bytes) -> bytes:
        if self._send is None:
            raise NoiseError("session not finalized")
        return self._send.encrypt(b"", plaintext)

    def decrypt(self, ciphertext: bytes) -> bytes:
        if self._recv is None:
            raise NoiseError("session not finalized")
        return self._recv.decrypt(b"", ciphertext)


async def send_framed(writer, msg: bytes) -> None:
    """Write one ``uint16_be(len) || data`` noise message (the libp2p noise
    framing; shared by the sidecar handshake and the libp2p transport)."""
    writer.write(struct.pack(">H", len(msg)) + msg)
    await writer.drain()


async def recv_framed(reader) -> bytes:
    head = await reader.readexactly(2)
    (length,) = struct.unpack(">H", head)
    return await reader.readexactly(length)


async def handshake(reader, writer, static: X25519PrivateKey, initiator: bool):
    """Run the XX handshake over 2-byte-length-framed messages; returns a
    finalized :class:`NoiseSession`."""

    async def send(msg: bytes) -> None:
        await send_framed(writer, msg)

    async def recv() -> bytes:
        return await recv_framed(reader)

    session = NoiseSession(static, initiator)
    if initiator:
        await send(session.write_message_1())
        session.read_message_2(await recv())
        await send(session.write_message_3())
    else:
        session.read_message_1(await recv())
        await send(session.write_message_2())
        session.read_message_3(await recv())
    session.finalize()
    return session
