"""The port's batched duty signing against the JAX package and the host
oracle, byte for byte.

``sign_batch`` on the ladder path (the port on the CPU through the field
kernels' plain versions, ``DUTY_SIGN_MIN`` at 0; the JAX package's device
plane in its interpret mode) at 16-bit keys over 3, 8 and 11 signatures,
with the port's chunk pinned to 8 (11 = 8 + 3) and the JAX package's
``duty_sign`` buckets to 4 and 8 to keep its interpret-mode work small; the
host route at full-width keys, through the native library and through the
pure-Python comb; the guards, which raise the same ``BlsError``.
Tolerance: none, signatures are bytes.
"""

import contextlib

import pytest
import torch

from lambda_ethereum_consensus_tpu.ops import aot as JAOT
from lambda_ethereum_consensus_tpu.ops import bls_sign as JS
from lambda_ethereum_consensus_tpu_torch.crypto.bls import api, native
from lambda_ethereum_consensus_tpu_torch.ops import bls_g2 as G2
from lambda_ethereum_consensus_tpu_torch.ops import bls_sign as S

BITS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_buckets(monkeypatch):
    monkeypatch.setattr(S, "SIGN_CHUNK", 8)
    monkeypatch.setitem(JAOT._SHAPE_BUCKETS, "duty_sign", {4, 8})


def _keys(n):
    sks = [(i + 3).to_bytes(32, "big") for i in range(n)]
    tampered = bytearray(sks[1])
    tampered[-2] ^= 0x01  # +256: still in (0, R) and below 2^16
    sks[1] = bytes(tampered)
    return sks, [b"duty-shape-%d" % (i % 3) for i in range(n)]


def test_sign_batch_ladder_matches_jax_and_oracle(tiny_buckets, monkeypatch):
    # every flush on the ladder, whatever its size
    monkeypatch.setattr(S, "DUTY_SIGN_MIN", 0)
    sks, msgs = _keys(11)
    dispatched = []
    real = G2.g2_ladder

    def spy(points, scalars, nbits, device):
        dispatched.append(len(points))
        return real(points, scalars, nbits, device)

    monkeypatch.setattr(S, "g2_ladder", spy)
    for n in (3, 8, 11):
        got = S.sign_batch(sks[:n], msgs[:n], device="cpu", nbits=BITS)
        assert got == [api.sign(sk, m) for sk, m in zip(sks[:n], msgs[:n])], n
        assert got == JS.sign_batch(sks[:n], msgs[:n], device=True, nbits=BITS), n
    # the ladder runs on the live lanes only, chunked at SIGN_CHUNK
    assert dispatched == [3, 8, 8, 3]


def test_sign_batch_host_comb_full_width_matches_jax_and_oracle():
    # three signers per message build the comb tables (the native library
    # off); one signs alone
    sks = [(0x1234567 * (i + 1) ** 7 + 1).to_bytes(32, "big") for i in range(7)]
    msgs = [b"comb-a"] * 3 + [b"comb-b"] * 3 + [b"comb-c"]
    with native.pure_python():
        got = S.sign_batch(sks, msgs, host=True)
    assert got == [api.sign(sk, m) for sk, m in zip(sks, msgs)]
    assert got == JS.sign_batch(sks, msgs, device=False)


@pytest.mark.parametrize("pure", [False, True], ids=["native", "pure-python"])
def test_sign_batch_host_route_branches_match_jax_and_oracle(pure, monkeypatch):
    # the native library's multiply per signature, or without it the comb
    # tables for the two three-signer messages and a plain multiply for the
    # lone one
    sks = [(0x7654321 * (i + 2) ** 9 + 5).to_bytes(32, "big") for i in range(7)]
    msgs = [b"route-a"] * 3 + [b"route-b"] * 3 + [b"route-c"]
    tables = []
    real = S._comb_tables

    def spy(pt):
        tables.append(pt)
        return real(pt)

    monkeypatch.setattr(S, "_comb_tables", spy)
    with native.pure_python() if pure else contextlib.nullcontext():
        assert native.enabled() is not pure
        got = S.sign_batch(sks, msgs, host=True)
    assert len(tables) == (2 if pure else 0)
    assert got == [api.sign(sk, m) for sk, m in zip(sks, msgs)]
    assert got == JS.sign_batch(sks, msgs, device=False)


def _error(fn, cls=api.BlsError):
    with pytest.raises(cls) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize(
    "keys, messages, nbits",
    [
        ([b"\x00" * 32], [b"m"], 256),  # zero key
        ([b"\xff" * 32], [b"m"], 256),  # key >= R
        ([b"\x01" * 31], [b"m"], 256),  # short key
        ([b"\x01" * 32], [b"a", b"b"], 256),  # length mismatch
        ([(3).to_bytes(32, "big")], [b"m"], 12),  # width not a multiple of 8
        ([(1 << 20).to_bytes(32, "big")], [b"m"], 16),  # key wider than the ladder
    ],
    ids=["zero", "over-r", "short", "mismatch", "width", "wide-key"],
)
def test_guards_raise_like_jax(keys, messages, nbits, monkeypatch):
    # guards precede any device work: no card is needed to reach them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = _error(lambda: S.sign_batch(keys, messages, nbits=nbits))
    assert got == _error(lambda: JS.sign_batch(keys, messages, device=True, nbits=nbits),
                         JS.BlsError)


def test_buckets_and_default_device(monkeypatch):
    # one flush of the largest duty size is one dispatch
    assert S.SIGN_CHUNK == 1024
    assert S.warm_sign_programs(device="cpu") >= 0
    assert S.sign_batch([], []) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.sign_batch([(5).to_bytes(32, "big")], [b"m"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.warm_sign_programs()
    # the host comb needs no card
    assert S.sign_batch([(5).to_bytes(32, "big")], [b"m"], host=True) == [
        api.sign((5).to_bytes(32, "big"), b"m")
    ]
