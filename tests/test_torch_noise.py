"""The port's Noise_XX transport against the JAX package's, byte for byte.

Static keys come from a seed; the ephemeral keys are seeded too, by
monkeypatching each module's ``X25519PrivateKey`` (in this test only) with
a class whose ``generate()`` hands out seeded keys.  Then handshake
messages 1-3 and the sealed transport frames of the two packages must be
equal, a port session must talk to a JAX session, and the tamper, nonce and
static-key cases of ``tests/unit/test_noise.py`` hold for the port.
"""

import random

import pytest

pytest.importorskip(
    "cryptography",
    reason="the noise transport needs the optional 'cryptography' module",
)

from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

from lambda_ethereum_consensus_tpu.network import noise as jax_noise
from lambda_ethereum_consensus_tpu_torch.network import noise as port_noise


def _key(rng: random.Random) -> X25519PrivateKey:
    return X25519PrivateKey.from_private_bytes(bytes(rng.getrandbits(8) for _ in range(32)))


def _seeded_generate(monkeypatch, module, seed: int) -> None:
    rng = random.Random(seed)

    class Seeded:
        @staticmethod
        def generate():
            return _key(rng)

        from_private_bytes = staticmethod(X25519PrivateKey.from_private_bytes)

    monkeypatch.setattr(module, "X25519PrivateKey", Seeded)


def _transcript(module, si, sr, frames=(b"ping", b"", b"x" * 1000)):
    ini = module.NoiseSession(si, initiator=True)
    res = module.NoiseSession(sr, initiator=False)
    m1 = ini.write_message_1()
    res.read_message_1(m1)
    m2 = res.write_message_2()
    ini.read_message_2(m2)
    m3 = ini.write_message_3()
    res.read_message_3(m3)
    ini.finalize()
    res.finalize()
    sealed = [ini.encrypt(f) for f in frames] + [res.encrypt(f) for f in frames]
    return [m1, m2, m3, *sealed], ini, res


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_transcripts_equal_jax_under_seeded_keys(monkeypatch, seed):
    rng = random.Random(seed)
    si, sr = _key(rng), _key(rng)
    _seeded_generate(monkeypatch, port_noise, 100 + seed)
    _seeded_generate(monkeypatch, jax_noise, 100 + seed)
    ours, ini, res = _transcript(port_noise, si, sr)
    theirs, _, _ = _transcript(jax_noise, si, sr)
    assert ours == theirs
    assert len(ours[0]) == 32 and len(ours[1]) == 32 + 48 + 16 and len(ours[2]) == 48 + 16
    assert ini.ss.h == res.ss.h
    assert ini.remote_static == port_noise._pub(sr)
    assert res.remote_static == port_noise._pub(si)


@pytest.mark.parametrize("port_initiates", [True, False])
def test_port_session_talks_to_jax_session(port_initiates):
    rng = random.Random(7)
    si, sr = _key(rng), _key(rng)
    ini_mod, res_mod = (port_noise, jax_noise) if port_initiates else (jax_noise, port_noise)
    ini = ini_mod.NoiseSession(si, initiator=True)
    res = res_mod.NoiseSession(sr, initiator=False)
    res.read_message_1(ini.write_message_1())
    ini.read_message_2(res.write_message_2(b"responder payload"))
    assert res.read_message_3(ini.write_message_3(b"initiator payload")) == b"initiator payload"
    ini.finalize()
    res.finalize()
    assert res.decrypt(ini.encrypt(b"ping")) == b"ping"
    assert ini.decrypt(res.encrypt(b"pong")) == b"pong"


def _handshake(module):
    si, sr = X25519PrivateKey.generate(), X25519PrivateKey.generate()
    _, ini, res = _transcript(module, si, sr, frames=())
    return si, sr, ini, res


def test_nonce_sequencing_and_replay():
    _, _, ini, res = _handshake(port_noise)
    msgs = [b"m%d" % i for i in range(5)]
    wires = [ini.encrypt(m) for m in msgs]
    assert [res.decrypt(w) for w in wires] == msgs
    with pytest.raises(port_noise.NoiseError):
        res.decrypt(wires[0])


def test_tampered_ciphertext_rejected():
    _, _, ini, res = _handshake(port_noise)
    wire = bytearray(ini.encrypt(b"payload"))
    wire[0] ^= 1
    with pytest.raises(port_noise.NoiseError):
        res.decrypt(bytes(wire))


def test_tampered_handshake_fails():
    si, sr = X25519PrivateKey.generate(), X25519PrivateKey.generate()
    ini = port_noise.NoiseSession(si, initiator=True)
    res = port_noise.NoiseSession(sr, initiator=False)
    res.read_message_1(ini.write_message_1())
    msg2 = bytearray(res.write_message_2())
    msg2[40] ^= 1  # corrupt the encrypted static key
    with pytest.raises(port_noise.NoiseError):
        ini.read_message_2(bytes(msg2))


def test_static_keys_authenticated_and_sessions_differ():
    si, sr, ini1, res1 = _handshake(port_noise)
    assert ini1.remote_static == port_noise._pub(sr)
    assert res1.remote_static == port_noise._pub(si)
    _, _, ini2, res2 = _handshake(port_noise)
    assert ini1.encrypt(b"x") != ini2.encrypt(b"x")
    with pytest.raises(port_noise.NoiseError):
        res2.decrypt(ini1.encrypt(b"y"))


def test_unfinalized_session_refuses_transport():
    session = port_noise.NoiseSession(X25519PrivateKey.generate(), initiator=True)
    with pytest.raises(port_noise.NoiseError):
        session.encrypt(b"early")
    with pytest.raises(port_noise.NoiseError):
        session.remote_static
