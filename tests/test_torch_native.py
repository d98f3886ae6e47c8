"""The port's native host backend against its pure-Python path and the JAX
package's pure-Python functions.

The library is ``native/bls381/bls381.cpp``, compiled once per module with
``g++`` by ``ops._build.build_host`` into the port's ``_build/`` (never
into ``native/build/``, whose presence would switch the JAX package's own
tests onto its native path: the JAX side here is pure Python).  Every hook
is compared on the same seeded inputs: Fq exponentiation, G1/G2 scalar
multiplication (0, 1, r and the point at infinity included), batched
hash-to-G2, batched G1/G2 decompression (invalid, infinity and
wrong-length items included), the RLC check on valid and tampered sets,
the pairing product check, and the batched final exponentiation of Miller
products (the hybrid pairing tail's host half).  A library that fails to build, load or pass its
self-check raises; ``BLS_DISABLE_NATIVE=1`` selects the pure-Python path.
Tolerance: none, every value is exact.
"""

import os
import random
from pathlib import Path

import pytest

from lambda_ethereum_consensus_tpu.crypto.bls import batch as jbatch
from lambda_ethereum_consensus_tpu.crypto.bls import curve as JC
from lambda_ethereum_consensus_tpu.crypto.bls import fields as JF
from lambda_ethereum_consensus_tpu.crypto.bls import hash_to_curve as JH
from lambda_ethereum_consensus_tpu.crypto.bls import native as jnative
from lambda_ethereum_consensus_tpu.crypto.bls import pairing as JP
from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B
from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
from lambda_ethereum_consensus_tpu_torch.crypto.bls import fields as F
from lambda_ethereum_consensus_tpu_torch.crypto.bls import hash_to_curve as H
from lambda_ethereum_consensus_tpu_torch.crypto.bls import native
from lambda_ethereum_consensus_tpu_torch.crypto.bls import pairing as PR
from lambda_ethereum_consensus_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
P, R = F.P, F.R
DST = H.DST_POP


@pytest.fixture(scope="module")
def lib():
    """The library built once with g++ into the port's _build/, loaded and
    self-checked."""
    path = _build.build_host("bls381")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert not (ROOT / "native" / "build").exists()
    assert not jnative.available()  # the JAX side stays pure Python
    return native.library()


@pytest.fixture
def pure(monkeypatch):
    """Run a callable on the port's pure-Python path."""
    def run(fn, *args):
        monkeypatch.setenv("BLS_DISABLE_NATIVE", "1")
        try:
            return fn(*args)
        finally:
            monkeypatch.delenv("BLS_DISABLE_NATIVE")
    return run


@pytest.fixture(scope="module")
def rng():
    return random.Random(20261017)


def test_powmod(lib, rng, pure):
    cases = [(0, 0), (0, 5), (1, P - 2), (P - 1, 2), (P - 1, P - 2), (2, (P + 1) // 4)]
    cases += [(rng.randrange(P), rng.randrange(P)) for _ in range(6)]
    for base, exp in cases:
        want = pow(base, exp, P)
        assert lib.fp_powmod(base, exp) == want
        assert F._fq_powmod(base, exp) == want
        assert pure(F._fq_powmod, base, exp) == want
        assert JF._fq_powmod(base, exp) == want


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_multiplication(lib, rng, pure, group):
    ops, jops = getattr(C, group), getattr(JC, group)
    gen = C.G1_GENERATOR if group == "g1" else C.G2_GENERATOR
    pt = ops.multiply_raw(gen, rng.randrange(1, R))
    scalars = [0, 1, 2, R - 1, R, R + 1, rng.randrange(R), rng.getrandbits(64) | 1,
               1 << 300]
    for k in scalars:
        want = jops.multiply_raw(pt, k)
        assert ops._multiply_py(pt, k) == want if k else want is None
        assert getattr(lib, f"{group}_mul")(pt, k) == want
        assert ops.multiply_raw(pt, k) == want
        assert pure(ops.multiply_raw, pt, k) == want
        assert ops.multiply(pt, k) == jops.multiply(pt, k)
    assert getattr(lib, f"{group}_mul")(None, 5) is None
    assert ops.multiply_raw(None, 5) is None
    assert getattr(lib, f"{group}_mul")(gen, R) is None


def test_hash_to_g2_many(lib, rng, pure):
    msgs = [b"", b"abc", bytes(rng.getrandbits(8) for _ in range(200))]
    msgs += [b"msg %d" % i for i in range(5)]
    want = JH.hash_to_g2_many(msgs, DST)
    assert lib.hash_to_g2_batch(msgs, DST) == want
    assert H.hash_to_g2_many(msgs, DST) == want
    assert pure(H.hash_to_g2_many, msgs, DST) == want
    assert H.hash_to_g2(msgs[1], DST) == JH.hash_to_g2(msgs[1], DST)
    assert H.hash_to_g2_many([], DST) == []
    other = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"
    assert H.hash_to_g2_many(msgs[:2], other) == JH.hash_to_g2_many(msgs[:2], other)


def _blobs(rng, ops, to_bytes, size):
    gen = C.G1_GENERATOR if size == 48 else C.G2_GENERATOR
    good = [to_bytes(ops.multiply_raw(gen, rng.randrange(1, R))) for _ in range(3)]
    flipped = bytes([good[0][0] ^ 0x20]) + good[0][1:]  # the other y: still valid
    bad_x = bytes([0x80 | 0x1F]) + b"\xff" * (size - 1)  # x >= p
    return good + [
        flipped,
        to_bytes(None),                    # infinity
        bytes([0xC0]) + b"\x01" * (size - 1),  # infinity flag with junk
        b"\x00" * size,                    # compression flag missing
        bad_x,
        good[1][:-1],                      # wrong length
        good[2] + b"\x00",                 # wrong length
        b"",
    ]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_batch_decompression(lib, rng, pure, group):
    ops = getattr(C, group)
    size = 48 if group == "g1" else 96
    to_bytes = C.g1_to_bytes if group == "g1" else C.g2_to_bytes
    blobs = _blobs(rng, ops, to_bytes, size)
    # a point on the curve outside the subgroup (G1: x = 4 works for y^2 = 68)
    if group == "g1":
        for x in range(1, 50):
            y = F.fq_sqrt((x ** 3 + 4) % P)
            if y is not None and not ops.in_subgroup((x, y)):
                blobs.append(to_bytes((x, y)))
                break
    batch = getattr(C, f"{group}_from_bytes_batch")
    jbatch_fn = getattr(JC, f"{group}_from_bytes_batch")
    want = jbatch_fn(blobs)
    assert [w is False for w in want][:4] == [False] * 4
    assert want[4] is None and all(w is False for w in want[5:])
    assert getattr(lib, f"{group}_decompress_batch")(blobs) == want
    assert batch(blobs) == want
    assert pure(batch, blobs) == want
    assert batch(blobs, False)[:5] == jbatch_fn(blobs, False)[:5]
    assert batch([]) == []


def _rlc_entries(rng, n_msgs: int, per: int):
    """Valid (pk, message, sig) point entries over ``n_msgs`` messages."""
    out = []
    for m in range(n_msgs):
        msg = b"native rlc %d" % m
        h = JH.hash_to_g2(msg, DST)
        for _ in range(per):
            sk = rng.randrange(1, R)
            out.append((JC.g1.multiply(JC.G1_GENERATOR, sk), msg, JC.g2.multiply(h, sk)))
    return out


def test_rlc_verify_true_and_false(lib, rng, pure):
    entries = _rlc_entries(rng, 2, 2)
    swapped = list(entries)
    swapped[1] = (entries[1][0], entries[1][1], entries[0][2])
    for case, want in ((entries, True), (swapped, False)):
        assert jbatch._verify_points_host(case, DST, {}) is want
        assert B._verify_points_host(case, DST, {}) is want
        assert pure(B._verify_points_host, case, DST, {}) is want
        packed, h_points, gids = B._pack_check(case, DST, {})
        assert lib.rlc_verify(packed, h_points, gids, B.COEFF_BITS) is want
        assert B.verify_points(case, DST, host=True) is want
    assert lib.rlc_verify([], [], [], 64) is True


def test_native_rlc_is_the_host_tail(lib, rng, monkeypatch):
    """``_verify_points_host`` takes the native RLC first, and the Python
    pairing under ``BLS_NO_NATIVE_RLC``."""
    entries = _rlc_entries(rng, 1, 2)
    calls = []
    real = native.rlc_verify
    monkeypatch.setattr(native, "rlc_verify", lambda *a: calls.append(1) or real(*a))
    assert B._verify_points_host(entries, DST, {}) is True and calls == [1]
    monkeypatch.setenv("BLS_NO_NATIVE_RLC", "1")
    assert B._verify_points_host(entries, DST, {}) is True and calls == [1]


def test_pairing_check(lib, rng, pure):
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    p, q = C.g1.multiply(C.G1_GENERATOR, a), C.g2.multiply(C.G2_GENERATOR, b)
    ab_q = C.g2.multiply(C.G2_GENERATOR, a * b % R)
    neg_g1 = C.g1.affine_neg(C.G1_GENERATOR)
    for pairs, want in (
        ([(p, q), (neg_g1, ab_q)], True),
        ([(p, q), (neg_g1, q)], False),
        ([(p, q)], False),
        ([(None, q), (p, None)], True),
    ):
        assert JP.pairing_check(pairs) is want
        assert PR.pairing_check(pairs) is want
        assert pure(PR.pairing_check, pairs) is want
        live = [(x, y) for x, y in pairs if x is not None and y is not None]
        if live:
            assert lib.pairing_check(live) is want


def test_final_exp_is_one(lib, rng, pure):
    """The library's batched final exponentiation against both packages'
    pure-Python ones, on Miller products that pair to one and that do not."""
    a = rng.randrange(1, R)
    p, q = C.g1.multiply(C.G1_GENERATOR, a), C.g2.multiply(C.G2_GENERATOR, rng.randrange(1, R))
    f = PR.miller_loop(p, q)
    products = [
        F.fq12_mul(f, PR.miller_loop(C.g1.affine_neg(p), q)),  # e(P,Q) e(-P,Q) == 1
        F.fq12_mul(f, f),
        f,
        F.FQ12_ONE,
        F.fq12_mul(PR.miller_loop(C.G1_GENERATOR, C.g2.multiply(q, a)),
                   PR.miller_loop(C.g1.affine_neg(p), q)),  # e(g, aQ) e(-aG, Q) == 1
    ]
    want = [True, False, False, True, True]
    assert [F.fq12_is_one(PR.final_exponentiation(m)) for m in products] == want
    assert [JF.fq12_is_one(JP.final_exponentiation(m)) for m in products] == want
    assert lib.final_exp_is_one(products) == want
    assert native.final_exp_is_one(products) == want
    assert lib.final_exp_is_one([]) == []


def test_hooks_take_the_library_unless_disabled(lib, monkeypatch):
    """With native on, the hooks never reach the pure-Python bodies; with
    ``BLS_DISABLE_NATIVE=1`` they never reach the library."""
    def boom(*_):
        raise AssertionError("wrong path")

    monkeypatch.setattr(type(C.g1), "_multiply_py", boom)
    monkeypatch.setattr(C, "_from_bytes_batch", boom)
    pt = C.g1.multiply(C.G1_GENERATOR, 12345)
    assert C.g1_from_bytes_batch([C.g1_to_bytes(pt)]) == [pt]
    monkeypatch.undo()
    monkeypatch.setenv("BLS_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "library", boom)
    assert not native.enabled()
    assert C.g1.multiply(C.G1_GENERATOR, 12345) == pt
    assert C.g1_from_bytes_batch([C.g1_to_bytes(pt)]) == [pt]
    assert F._fq_powmod(3, 5) == 243


CORRUPT = {
    "g1_mul": lambda real: lambda self, pt, k: real(self, pt, k + 1) if k > 1 else real(self, pt, k),
    "final_exp_is_one": lambda real: lambda self, fs: [not v for v in real(self, fs)],
}


@pytest.mark.parametrize("entry", list(CORRUPT))
def test_corrupt_self_check_raises(lib, monkeypatch, entry):
    monkeypatch.setattr(native.Library, entry, CORRUPT[entry](getattr(native.Library, entry)))
    with pytest.raises(native.NativeError, match=entry):
        native.load()


def test_failed_build_and_load_raise(lib, tmp_path, monkeypatch):
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"not a shared library")
    with pytest.raises(native.NativeError, match="unavailable"):
        native.load(junk)
    broken = tmp_path / "broken.cpp"
    broken.write_text("int broken( {\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "bls381", broken)
    with pytest.raises(native.NativeError, match="host build"):
        native.load()
    assert not list(_build.BUILD_DIR.glob("*.tmp"))


def test_nothing_builds_at_import_and_native_build_stays_absent():
    """A fresh interpreter imports the port's crypto without loading the
    library, and no test leaves ``native/build/`` behind."""
    import subprocess
    import sys

    probe = (
        "import lambda_ethereum_consensus_tpu_torch.crypto.bls as b\n"
        "from lambda_ethereum_consensus_tpu_torch.crypto.bls import native\n"
        "import lambda_ethereum_consensus_tpu_torch.fork_choice\n"
        "assert native._loaded is None\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ})
    assert out.returncode == 0, out.stderr
    assert not (ROOT / "native" / "build").exists()
