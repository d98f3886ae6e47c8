"""The port's KZG plane against the JAX package and the host oracle, at the
minimal-preset width 4.

Commitments, proofs and fold verdicts from the port's ladder path (on the
CPU through the field kernels' plain versions, full 256-bit scalars) equal
the JAX package's bytes and verdicts (its host path, ``device=False``) and
the port's own per-term host oracle (``_msm(..., host=True)``); tampered and malformed inputs
reject identically; MSM dispatches carry only the live terms, chunked at
the port's ``MSM_CHUNK`` (pinned to 8 here, as the JAX package's
``kzg_msm`` buckets are pinned to 4 and 8 to keep its interpret-mode work
small), and 16-bit products equal the JAX package's device MSM in its
interpret mode.  Tolerance: none, every
value is exact.
"""

import random

import pytest
import torch

from lambda_ethereum_consensus_tpu.da import kzg as JK
from lambda_ethereum_consensus_tpu.ops import aot as JAOT
from lambda_ethereum_consensus_tpu_torch import da
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec
from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
from lambda_ethereum_consensus_tpu_torch.crypto.bls.fields import R
from lambda_ethereum_consensus_tpu_torch.da import kzg as K
from lambda_ethereum_consensus_tpu_torch.ops import bls_g1 as G1

RNG = random.Random(4844)
WIDTH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tiny_buckets(monkeypatch):
    monkeypatch.setattr(K, "MSM_CHUNK", 8)
    monkeypatch.setitem(JAOT._SHAPE_BUCKETS, "kzg_msm", {4, 8})


def _blob(vals):
    return b"".join(int(v).to_bytes(32, "big") for v in vals)


@pytest.fixture(scope="module")
def setups():
    return K.dev_setup(WIDTH), JK.dev_setup(WIDTH)


@pytest.fixture(scope="module")
def sample(setups):
    """Two seeded blobs with the port's device-path commitments and proofs."""
    setup, _ = setups
    blobs = [_blob([RNG.randrange(R) for _ in range(WIDTH)]) for _ in range(2)]
    commitments = [K.blob_to_commitment(b, setup, device="cpu") for b in blobs]
    proofs = [K.compute_blob_proof(b, c, setup, device="cpu") for b, c in zip(blobs, commitments)]
    return blobs, commitments, proofs


def test_setup_matches_jax(setups):
    setup, ref = setups
    assert setup.domain == ref.domain and setup.g2_tau == ref.g2_tau
    assert setup.g1_lagrange == ref.g1_lagrange
    assert K.trusted_setup(minimal_spec()) is setup
    # the dev setup's points are [L_i(tau)] G1
    scalars = K._lagrange_at(K._dev_tau(WIDTH), setup.domain)
    assert list(setup.g1_lagrange) == [C.g1.multiply(C.G1_GENERATOR, s) for s in scalars]


def test_commitments_and_proofs_match_jax_and_host(setups, sample):
    setup, ref = setups
    blobs, commitments, proofs = sample
    for b, c, p in zip(blobs, commitments, proofs):
        assert c == JK.blob_to_commitment(b, ref, device=False)
        evals = K.blob_to_field_elements(b, WIDTH)
        assert c == C.g1_to_bytes(K._msm(setup.g1_lagrange, evals, host=True))
        assert p == JK.compute_blob_proof(b, c, ref, device=False)
        assert K.versioned_hash(c) == JK.versioned_hash(c)
    z = RNG.randrange(R)
    proof, y = K.compute_proof(blobs[0], z, setup, device="cpu")
    assert (proof, y) == JK.compute_proof(blobs[0], z, ref, device=False)
    assert K.verify_proof(commitments[0], z, y, proof, setup)
    assert not K.verify_proof(commitments[0], z, (y + 1) % R, proof, setup)


def test_fold_verdicts_and_tampering_match_jax(setups, sample):
    setup, ref = setups
    blobs, commitments, proofs = sample
    assert K.verify_blob_batch(blobs, commitments, proofs, setup, device="cpu")
    assert JK.verify_blob_batch(blobs, commitments, proofs, ref, device=False)
    for slot in ("blob", "commitment", "proof"):
        bl, cm, pr = list(blobs), list(commitments), list(proofs)
        if slot == "blob":
            bad = bytearray(bl[1])
            bad[-1] ^= 1
            bl[1] = bytes(bad)
        elif slot == "commitment":
            cm[1] = cm[0]
        else:
            pr[1] = pr[0]
        assert not K.verify_blob_batch(bl, cm, pr, setup, device="cpu"), slot
        assert not JK.verify_blob_batch(bl, cm, pr, ref, device=False), slot
        per_item = [K.verify_blob_proof(b, c, p, setup) for b, c, p in zip(bl, cm, pr)]
        assert per_item == [JK.verify_blob_proof(b, c, p, ref, device=False)
                            for b, c, p in zip(bl, cm, pr)] == [True, False]


def test_zero_blob_and_malformed_inputs_match_jax(setups):
    setup, ref = setups
    zb = _blob([0] * WIDTH)
    cb = K.blob_to_commitment(zb, setup, device="cpu")  # no live lane: no dispatch
    assert cb == JK.blob_to_commitment(zb, ref, device=False)
    assert C.g1_from_bytes(cb) is None
    bp = K.compute_blob_proof(zb, cb, setup, device="cpu")
    assert K.verify_blob_proof(zb, cb, bp, setup)
    for mk in (K, JK):
        with pytest.raises(mk.KzgError):
            mk.blob_to_field_elements(_blob([R] + [0] * (WIDTH - 1)), WIDTH)
        with pytest.raises(mk.KzgError):
            mk.blob_to_field_elements(b"\x00" * 31, WIDTH)
        with pytest.raises(mk.KzgError):
            mk.verify_blob_batch([b"\x00" * 128], [], [])
        with pytest.raises(mk.KzgError):
            mk.versioned_hash(b"\x00" * 47)
    garbage = b"\xff" * 48
    assert K.verify_blob_proof(zb, garbage, bp, setup) is JK.verify_blob_proof(
        zb, garbage, bp, ref) is False
    assert K.verify_blob_batch([zb], [cb], [garbage], setup) is JK.verify_blob_batch(
        [zb], [cb], [garbage], ref) is False
    non_canonical = _blob([R] + [0] * (WIDTH - 1))
    assert K.verify_blob_batch([non_canonical], [cb], [bp], setup) is False
    assert K.verify_blob_batch([], [], []) is True
    loaded = K.load_trusted_setup([C.g1_to_bytes(pt) for pt in setup.g1_lagrange],
                                  C.g2_to_bytes(setup.g2_tau))
    assert loaded.domain == setup.domain
    for bad in ([C.g1_to_bytes(setup.g1_lagrange[0])] * 3, [C.g1_to_bytes(None)] * 4):
        with pytest.raises(K.KzgError):
            K.load_trusted_setup(bad, C.g2_to_bytes(setup.g2_tau))


def test_msm_snaps_to_buckets_and_matches_jax_device_plane(monkeypatch):
    pts = [C.g1.multiply(C.G1_GENERATOR, RNG.randrange(1, R)) for _ in range(11)]
    ks = [RNG.getrandbits(16) for _ in range(11)]
    ks[2] = 0  # a zero scalar never reaches the ladder
    pts[5] = None  # nor does an infinity point
    seen = []
    real = G1.g1_ladder

    def spy(points, scalars, nbits, device):
        seen.append(len(points))
        return real(points, scalars, nbits, device)

    monkeypatch.setattr(K, "g1_ladder", spy)
    live = [(pt, k) for pt, k in zip(pts, ks) if pt is not None]
    want = JK._mul_batch(live, device=True, nbits=16)
    for shape in (3, 8, 11):
        pairs = list(zip(pts[:shape], ks[:shape]))
        got = K._mul_batch(pairs, device="cpu", nbits=16)
        assert got == [C.g1.multiply(p, k) if p is not None else None for p, k in pairs]
        assert [g for g, (p, _) in zip(got, pairs) if p is not None] == want[: len(
            [p for p, _ in pairs if p is not None])]
    # 2, 6 and 9 live lanes: no padding, chunked at MSM_CHUNK
    assert seen == [2, 6, 8, 1]
    seen.clear()
    assert K._mul_batch([], device="cpu") == [] and seen == []
    for nbits, k in ((12, 1), (16, 1 << 20)):
        with pytest.raises(K.KzgError):
            K._mul_batch([(C.G1_GENERATOR, k)], device="cpu", nbits=nbits)
    assert K.warm_kzg_programs(device="cpu") >= 0
    assert seen == [1]


def test_entry_points_default_to_the_card(setups, monkeypatch):
    setup, _ = setups
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = _blob([1, 2, 3, 4])
    cb = C.g1_to_bytes(K._msm(setup.g1_lagrange, [1, 2, 3, 4], host=True))
    for call in (
        lambda: da.blob_to_commitment(blob, setup),
        lambda: K.compute_proof(blob, 5, setup),
        lambda: da.compute_blob_proof(blob, cb, setup),
        lambda: da.verify_blob_batch([blob], [cb], [cb], setup),
        lambda: da.warm_kzg_programs(),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
