"""The port's BLS leg as a whole, at a tiny size, against the JAX package and
the host oracle.

``chain_verify`` on valid, invalid and empty checks; ``chain_verify_cached``
over an 8-committee x 8-member registry, against the JAX package's verdicts
(its interpret-mode chain, run once here) and the host sums; and the
attestation drain, ``batch_verify_each_cached``, blaming exactly the tampered
entry.  The parity cases run on both pairing tails (``DEVICE_TAIL_MIN`` at 0:
composed; at 64: hybrid), the blame on the composed one.  RLC coefficients are 16 bits wide to keep the ladders short; every
field op runs through the kernels' plain versions on the CPU.
"""

import secrets

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu.ops import bls_batch as JBB
from lambda_ethereum_consensus_tpu_torch.convert import planes_from_torch
from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as HB
from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import DST_POP, hash_to_g2
from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as BB
from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair
from lambda_ethereum_consensus_tpu_torch.ops.bigint_pallas import from_planes

MSGS = [b"chain-msg-a", b"chain-msg-b", b"chain-msg-c"]
BITS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hs():
    return [hash_to_g2(m, DST_POP) for m in MSGS]


def _coeff():
    return secrets.randbits(BITS) | 1


def _mk_check(hs, n, n_msgs, bad_index=None):
    """n entries over n_msgs messages; entry bad_index is signed by the
    wrong key."""
    entries, gids = [], []
    for i in range(n):
        sk = secrets.randbits(96) | 1
        g = i % n_msgs
        pk = C.g1.multiply_raw(C.G1_GENERATOR, sk)
        sig = C.g2.multiply_raw(hs[g], sk + 1 if i == bad_index else sk)
        entries.append((pk, sig, _coeff()))
        gids.append(g)
    return (entries, hs[:n_msgs], gids)


# the pairing tail's constant: at 0 every chained call takes the composed
# tail, at 64 these calls of at most 4 checks the hybrid one
TAIL_MIN = {"composed": 0, "hybrid": 64}


@pytest.mark.parametrize("tail", list(TAIL_MIN))
def test_chain_verify_valid_invalid_empty(hs, monkeypatch, tail):
    monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", TAIL_MIN[tail])
    res = BB.chain_verify(
        [
            _mk_check(hs, n=4, n_msgs=2),
            _mk_check(hs, n=3, n_msgs=3, bad_index=1),
            _mk_check(hs, n=1, n_msgs=1),
            ([], [], []),
        ],
        device="cpu",
        coeff_bits=BITS,
    )
    assert res == [True, False, True, True]


SKS = [3 + 5 * i for i in range(64)]


@pytest.fixture(scope="module")
def registry():
    reg = [C.g1.multiply_raw(C.G1_GENERATOR, sk) for sk in SKS]
    rx, ry = BB._g1_planes(reg)
    committees = np.random.default_rng(8).permutation(64).astype(np.int32).reshape(8, 8)
    return reg, rx, ry, committees


def _sig(hs, committees, comm, missing, g, corrupt=False):
    sk = sum(SKS[i] for i in committees[comm]) - sum(SKS[i] for i in missing)
    return C.g2.multiply_raw(hs[g], sk + (1 if corrupt else 0))


def test_chain_verify_cached_matches_jax_and_host(hs, registry, monkeypatch):
    reg, rx, ry, committees = registry
    lengths = [8] * 7 + [5]  # committee 7 is ragged
    port = BB.DeviceCommitteeCache(
        (rx, ry), committees, device="cpu", chunk=4, lengths=lengths, mmax=4
    )
    assert port.mmax == 4
    host = []
    for c in range(8):
        acc = None
        for i in committees[c][: lengths[c]]:
            acc = C.g1.affine_add(acc, reg[int(i)])
        host.append(acc)
    sx = from_planes(planes_from_torch(port.sum_x))
    sy = from_planes(planes_from_torch(port.sum_y))
    assert list(zip(sx, sy)) == host

    m0, m2 = [int(committees[2][1]), int(committees[2][4])], [int(committees[7][0])]
    ragged = committees[7][:5]
    valid = (
        [
            (2, m0, _sig(hs, committees, 2, m0, 0), _coeff()),
            (7, m2, _sig(hs, [ragged if c == 7 else committees[c] for c in range(8)], 7, m2, 1),
             _coeff()),
            (4, [], _sig(hs, committees, 4, [], 0), _coeff()),
        ],
        hs[:2],
        [0, 1, 0],
    )
    miss = [int(committees[5][3])]
    invalid = ([(5, miss, _sig(hs, committees, 5, miss, 0, corrupt=True), _coeff())], hs[:1], [0])
    ref = JBB.DeviceCommitteeCache(
        (rx, ry), committees, interpret=True, chunk=4, lengths=lengths, mmax=4
    )
    want = JBB.chain_verify_cached(ref, [valid, invalid], interpret=True, coeff_bits=BITS)
    assert want == [True, False]
    for tail in TAIL_MIN.values():
        monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", tail)
        assert BB.chain_verify_cached(port, [valid, invalid], coeff_bits=BITS) == want

    # over-capacity corrections are refused, not truncated
    with pytest.raises(ValueError):
        BB.chain_verify_cached(
            port, [([(0, [1, 2, 3, 4, 5], valid[0][0][2], _coeff())], hs[:1], [0])], BITS
        )


def test_batch_verify_each_cached_blames_the_tampered_entry(hs, registry, monkeypatch):
    monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", TAIL_MIN["composed"])
    _, rx, ry, committees = registry
    cache = BB.DeviceCommitteeCache((rx, ry), committees, device="cpu", chunk=8, mmax=2)
    bad = 2
    entries = []
    for i, comm in enumerate([1, 3, 6, 0]):
        missing = [int(committees[comm][i])]
        g = i % 2
        sig = _sig(hs, committees, comm, missing, g, corrupt=i == bad)
        entries.append((comm, missing, MSGS[g], sig))
    calls = []
    real = BB.chain_verify_cached

    def spy(cache, checks, coeff_bits):
        calls.append(len(checks))
        return real(cache, checks, coeff_bits)

    monkeypatch.setattr(BB, "chain_verify_cached", spy)
    flags = HB.batch_verify_each_cached(cache, entries, coeff_bits=BITS)
    assert flags == [True, True, False, True]
    # level-synchronous: the whole drain, then both halves, then the two
    # entries of the failing half, each level one chained call
    assert calls == [1, 2, 2]
    # an undecodable signature fails its range without reaching the device
    calls.clear()
    assert HB.batch_verify_each_cached(cache, [(1, [], MSGS[0], None)], coeff_bits=BITS) == [False]
    assert calls == []


def test_aggregate_g1_chain_matches_host_sum(registry):
    reg, rx, ry, _ = registry
    for k in (8, 3):  # k = 3 pads the reduce axis with infinity
        ax, ay = BB.aggregate_g1_chain((rx[:, :k].reshape(32, 1, k), ry[:, :k].reshape(32, 1, k)),
                                       device="cpu")
        want = None
        for p in reg[:k]:
            want = C.g1.affine_add(want, p)
        got = (from_planes(planes_from_torch(ax))[0], from_planes(planes_from_torch(ay))[0])
        assert got == want


def test_registry_plane_store_growth_and_invalidation(registry):
    _, rx, ry, committees = registry
    store = BB.RegistryPlaneStore(device="cpu", min_capacity=16)
    bx, by = store.update(rx[:, :10], ry[:, :10])
    assert store.capacity == 16 and store.count == 10 and store.uploaded_cols == 10
    same = store.rx
    store.update(rx[:, :14], ry[:, :14])  # within capacity: in place
    assert store.rx is same and store.uploaded_cols == 14
    store.update(rx, ry)  # past capacity: a doubled buffer, prefix kept
    assert store.capacity == 64 and store.rx is not same and store.uploaded_cols == 64
    assert np.array_equal(planes_from_torch(store.rx), rx)
    assert store.update(rx[:, :5], ry[:, :5])[0] is store.rx  # an older, consistent view
    cache = BB.DeviceCommitteeCache(store, committees, chunk=8)
    full = BB.DeviceCommitteeCache((rx, ry), committees, device="cpu", chunk=8)
    assert torch.equal(cache.sum_x, full.sum_x) and torch.equal(cache.sum_y, full.sum_y)
    mutated = rx.copy()
    mutated[0, 0] ^= 1
    store.update(mutated, ry)
    assert store.version == 1 and cache.rx is not store.rx
    cache._refresh_planes()  # a cache built before the invalidation keeps its buffer
    assert np.array_equal(planes_from_torch(cache.rx)[:, :64], rx)


def test_entry_points_default_to_the_card(monkeypatch, registry):
    _, rx, ry, committees = registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BB.chain_verify([([], [], [])])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BB.DeviceCommitteeCache((rx, ry), committees)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BB.RegistryPlaneStore()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BB.aggregate_g1_chain((rx[:, :2], ry[:, :2]))
    assert BB.get_chain_ops("cpu")["device"].type == "cpu"


@pytest.mark.cuda
def test_chain_verify_on_card(hs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py drives the drain on the card")
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    before = dict(BP.kernel_launches)
    res = BB.chain_verify(
        [_mk_check(hs, n=4, n_msgs=2), _mk_check(hs, n=3, n_msgs=3, bad_index=1)],
        coeff_bits=BITS,
    )
    assert res == [True, False]
    assert all(BP.kernel_launches[k] > before[k] for k in before)
