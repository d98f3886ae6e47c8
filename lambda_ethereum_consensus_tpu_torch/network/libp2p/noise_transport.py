"""libp2p-noise channel: the ``/noise`` security protocol.

Composition of the generic Noise XX core (``network/noise.py`` — the
exact libp2p pattern ``Noise_XX_25519_ChaChaPoly_SHA256``) with the
libp2p-specific parts (libp2p noise spec; what go-libp2p's
``noise.New`` provides — ref: reqresp.go:39):

- every handshake AND transport message is framed ``uint16_be(len) || data``
  with len <= 65535;
- XX messages 2 (responder) and 3 (initiator) carry an encrypted
  ``NoiseHandshakePayload`` binding an ed25519 libp2p identity to the
  noise static key (:func:`identity.verify_noise_payload`);
- a fresh noise static key per connection is permitted (identity lives
  in the ed25519 key, not the noise key) — this implementation generates
  one per process.

:class:`NoiseChannel` then exposes the decrypted byte stream with the
``readexactly``/``write``/``drain`` interface the muxer layer consumes,
re-chunking writes to the 65519-byte plaintext limit.

The port's copy of the JAX package's
``network/libp2p/noise_transport.py``; the bytes it puts on the wire are
the JAX module's. Built on the port's own ``network/noise.py``.
"""

from __future__ import annotations

import struct

# ..noise is importable without 'cryptography' (its own crypto imports
# are gated), so NoiseError stays ONE class repo-wide — the teardown
# tuples in yamux/mplex/sidecar must catch what we raise here
from ..noise import NoiseError, NoiseSession, _pub, recv_framed, send_framed

try:
    # optional: a host without 'cryptography' can still import this
    # module (and everything that composes it — host, gossipsub); only
    # actually securing a connection requires the crypto stack
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey
except ImportError:  # pragma: no cover - environment-dependent
    X25519PrivateKey = None  # type: ignore[assignment]

from .identity import Identity, IdentityError, PeerId, verify_noise_payload

MAX_PLAINTEXT = 65535 - 16  # AEAD tag rides inside the 2-byte length budget


class NoiseChannel:
    """Decrypted byte-stream view of a noise transport session."""

    def __init__(self, reader, writer, session: NoiseSession, peer_id: PeerId):
        self._reader = reader
        self._writer = writer
        self._session = session
        self.peer_id = peer_id
        self._buf = bytearray()

    # -- reader side ------------------------------------------------------
    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            head = await self._reader.readexactly(2)
            (length,) = struct.unpack(">H", head)
            frame = await self._reader.readexactly(length)
            self._buf += self._session.decrypt(frame)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    # -- writer side ------------------------------------------------------
    def write(self, data: bytes) -> None:
        for off in range(0, len(data), MAX_PLAINTEXT):
            sealed = self._session.encrypt(data[off : off + MAX_PLAINTEXT])
            self._writer.write(struct.pack(">H", len(sealed)) + sealed)

    async def drain(self) -> None:
        await self._writer.drain()

    def close(self) -> None:
        self._writer.close()


async def secure_connection(
    reader, writer, identity: Identity, initiator: bool,
    static: X25519PrivateKey | None = None,
) -> NoiseChannel:
    """Run the libp2p-noise handshake; returns the encrypted channel with
    the remote's PROVEN peer id (payload signature checked against the
    noise-authenticated static key)."""
    if X25519PrivateKey is None:
        raise NoiseError(
            "libp2p-noise needs the optional 'cryptography' module"
        )
    static = static or X25519PrivateKey.generate()
    session = NoiseSession(static, initiator)
    payload = identity.noise_payload(_pub(static))
    if initiator:
        await send_framed(writer, session.write_message_1())
        remote_payload = session.read_message_2(await recv_framed(reader))
        await send_framed(writer, session.write_message_3(payload))
    else:
        session.read_message_1(await recv_framed(reader))
        await send_framed(writer, session.write_message_2(payload))
        remote_payload = session.read_message_3(await recv_framed(reader))
    try:
        peer_id = verify_noise_payload(remote_payload, session.remote_static)
    except IdentityError as e:
        writer.close()
        raise NoiseError(f"identity verification failed: {e}") from None
    session.finalize()
    return NoiseChannel(reader, writer, session, peer_id)
