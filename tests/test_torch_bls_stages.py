"""The port's BLS stages against the JAX package in interpret mode, bit for bit.

Each stage gets the same seeded inputs in both packages (numpy limb planes,
moved into the port with ``convert.planes_to_torch``): the tower ops, Fermat
inversion and Frobenius; the G1 and G2 ladders at 8 bits; the committee
cache's sums and corrected aggregates; the Miller loop for two pairs; and the
verdicts of both pairing tails (the composed tail on the device, the hybrid
tail's native and pure-Python host halves), with the composed final
exponentiation's field calls pinned.  The JAX side is
``get_fq12_plane_ops(interpret=True)``, ``bls_batch._get_chain_ops(True)``
(eager ladders over the plane fields) and
``bls_pairing._get_ops(plane=True, interpret=True)``.  Host oracles
(``crypto/bls``) check the values as well.  Everything runs on the CPU
through the field kernels' plain versions.
"""

import contextlib
import random
from collections import Counter

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu.crypto.bls import pairing as JP
from lambda_ethereum_consensus_tpu.ops import bls_batch as JBB
from lambda_ethereum_consensus_tpu.ops import bls_pairing as JBPair
from lambda_ethereum_consensus_tpu.ops.bls_fq12 import get_fq12_plane_ops as jax_tower
from lambda_ethereum_consensus_tpu_torch.convert import planes_from_torch, planes_to_torch
from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
from lambda_ethereum_consensus_tpu_torch.crypto.bls import fields as F
from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as BB
from lambda_ethereum_consensus_tpu_torch.ops import bls_fq12 as FQ
from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair
from lambda_ethereum_consensus_tpu_torch.ops.bigint_pallas import from_planes, to_planes

P = F.P
RNG = random.Random(2026)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(arr):
    return planes_to_torch(arr, device="cpu")


def _jnp(arr):
    import jax.numpy as jnp

    return jnp.asarray(arr)


def _same(port, ref) -> bool:
    return np.array_equal(planes_from_torch(port), np.asarray(ref))


def _fq2s(n):
    return [(RNG.randrange(P), RNG.randrange(P)) for _ in range(n)]


def _fq12s(n):
    return [tuple(tuple(_fq2s(3)) for _ in range(2)) for _ in range(n)]


def _fq12_planes(fs) -> np.ndarray:
    """host Fq12 tuples -> (32, 2, 3, 2, n) planes"""
    return np.ascontiguousarray(np.stack([FQ.fq12_to_limbs(f) for f in fs], -1).transpose(3, 0, 1, 2, 4))


def _fq2_planes(xs) -> np.ndarray:
    """host Fq2 pairs -> (32, 2, n) planes"""
    return np.ascontiguousarray(np.stack([FQ.fq2_to_limbs(x) for x in xs], -1).transpose(1, 0, 2))


def _fq6_planes(xs) -> np.ndarray:
    return np.ascontiguousarray(
        np.stack([np.stack([FQ.fq2_to_limbs(c) for c in x]) for x in xs], -1).transpose(2, 0, 1, 3)
    )


@pytest.fixture(scope="module")
def towers():
    return FQ.get_fq12_plane_ops("cpu"), jax_tower(interpret=True)


FQ12_CASES = {
    "fq12_mul": (2, lambda a, b: F.fq12_mul(a, b)),
    "fq12_sq": (1, F.fq12_sq),
    "fq12_inv": (1, F.fq12_inv),
    "fq12_frobenius": (1, F.fq12_frobenius),
    "fq12_conj": (1, F.fq12_conj),
}


@pytest.mark.parametrize("name", list(FQ12_CASES))
def test_fq12_ops_match_jax_and_host(name, towers):
    port, ref = towers
    arity, host = FQ12_CASES[name]
    args = [_fq12s(3) for _ in range(arity)]
    planes = [_fq12_planes(a) for a in args]
    got = port[name](*[_t(p) for p in planes])
    assert _same(got, ref[name](*[_jnp(p) for p in planes]))
    assert FQ.fq12_batch_from_limbs(planes_from_torch(got)) == [host(*xs) for xs in zip(*args)]


FQ2_CASES = {
    "fq2_mul": (2, F.fq2_mul),
    "fq2_sq": (1, F.fq2_sq),
    "fq2_inv": (1, F.fq2_inv),
    "fq2_mul_by_xi": (1, F.fq2_mul_by_xi),
    "fq2_conj": (1, F.fq2_conj),
}


@pytest.mark.parametrize("name", list(FQ2_CASES))
def test_fq2_ops_match_jax_and_host(name, towers):
    port, ref = towers
    arity, host = FQ2_CASES[name]
    args = [_fq2s(4) for _ in range(arity)]
    planes = [_fq2_planes(a) for a in args]
    got = planes_from_torch(port[name](*[_t(p) for p in planes]))
    assert np.array_equal(got, np.asarray(ref[name](*[_jnp(p) for p in planes])))
    pairs = list(zip(from_planes(got[:, 0]), from_planes(got[:, 1])))
    assert pairs == [host(*xs) for xs in zip(*args)]


def test_fq6_mul_matches_jax_and_inv_matches_host(towers):
    port, ref = towers
    a, b = [tuple(_fq2s(3)) for _ in range(2)], [tuple(_fq2s(3)) for _ in range(2)]
    pa, pb = _fq6_planes(a), _fq6_planes(b)
    assert _same(port["fq6_mul"](_t(pa), _t(pb)), ref["fq6_mul"](_jnp(pa), _jnp(pb)))
    inv = port["fq6_inv"](_t(pa))
    prod = planes_from_torch(port["fq6_mul"](inv, _t(pa)))
    one6 = _fq6_planes([F.FQ6_ONE, F.FQ6_ONE])
    assert np.array_equal(prod, one6)


def test_fp_inv_matches_jax_and_host(towers):
    port, ref = towers
    xs = [0, 1, P - 1] + [RNG.randrange(P) for _ in range(5)]
    planes = to_planes(xs)
    got = port["fp_inv"](_t(planes))
    assert _same(got, ref["fp_inv"](_jnp(planes)))
    assert from_planes(planes_from_torch(got)) == [pow(x, P - 2, P) for x in xs]


@pytest.fixture(scope="module")
def chains():
    return BB.get_chain_ops("cpu"), JBB._get_chain_ops(True)


def _bits(ks, nbits):
    return np.ascontiguousarray(JBB._scalar_bits_batch(ks, nbits).T)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladders_match_jax_and_host(group, chains):
    port, ref = chains
    host = C.g1 if group == "g1" else C.g2
    gen = C.G1_GENERATOR if group == "g1" else C.G2_GENERATOR
    pts = [host.multiply_raw(gen, 5 + 7 * i) for i in range(8)]
    ks = [0, 1, 2, 3, 255, 128, 77, 200]  # zero, identity, doubling edges
    if group == "g1":
        bx, by = JBB._g1_planes(pts)
    else:
        bx, by = JBB._g2_planes(pts)
    bits = _bits(ks, 8)
    live = np.ones(8, bool)
    live[6] = False  # a dead lane comes back flagged infinity
    name = f"ladder_{group}"
    got = port[name](_t(bx), _t(by), torch.from_numpy(bits), torch.from_numpy(live))
    want = ref[name](_jnp(bx), _jnp(by), _jnp(bits), _jnp(live))
    for g, w in zip(got[:3], want[:3]):
        assert _same(g, w)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    inf = got[3].numpy()
    assert list(inf) == [True, False, False, False, False, False, True, False]
    # the live lanes hold k * P in Jacobian coordinates
    X, Y, Z = (planes_from_torch(v) for v in got[:3])
    for i in (1, 4, 7):
        if group == "g1":
            x, y, z = (from_planes(v[:, i : i + 1])[0] for v in (X, Y, Z))
            zi = pow(z, P - 2, P)
            aff = (x * zi * zi % P, y * zi * zi * zi % P)
        else:
            x, y, z = (
                tuple(from_planes(v[:, c, i : i + 1])[0] for c in range(2)) for v in (X, Y, Z)
            )
            zi = F.fq2_inv(z)
            zi2 = F.fq2_sq(zi)
            aff = (F.fq2_mul(x, zi2), F.fq2_mul(y, F.fq2_mul(zi2, zi)))
        assert aff == host.multiply_raw(pts[i], ks[i])


def test_committee_sums_and_corrections_match_jax_and_host():
    reg = [C.g1.multiply_raw(C.G1_GENERATOR, 3 + 5 * i) for i in range(64)]
    rx, ry = JBB._g1_planes(reg)
    committees = np.random.default_rng(5).permutation(64).astype(np.int32).reshape(8, 8)
    port = BB.DeviceCommitteeCache((rx, ry), committees, device="cpu", chunk=8)
    ref = JBB.DeviceCommitteeCache((rx, ry), committees, interpret=True, chunk=8)
    assert _same(port.sum_x, ref.sum_x) and _same(port.sum_y, ref.sum_y)

    def host_sum(idxs):
        acc = None
        for i in idxs:
            acc = C.g1.affine_add(acc, reg[int(i)])
        return acc

    sx = from_planes(planes_from_torch(port.sum_x))
    sy = from_planes(planes_from_torch(port.sum_y))
    assert [(sx[c], sy[c]) for c in range(8)] == [host_sum(committees[c]) for c in range(8)]

    # entry 0: committee 3 missing two members; entry 1: committee 5, full
    # participation; entry 2: committee 0 with every member missing
    mm = 8
    comm_ids = np.array([3, 5, 0], np.int32)
    miss_idx = np.zeros((3, mm), np.int32)
    miss_inf = np.ones((3, mm), bool)
    miss_idx[0, :2] = committees[3, [1, 6]]
    miss_inf[0, :2] = False
    miss_idx[2] = committees[0]
    miss_inf[2] = False
    got = port.aggregate(comm_ids, miss_idx, miss_inf)
    want = ref.aggregate(comm_ids, miss_idx, miss_inf)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert list(got[2].numpy()) == list(np.asarray(want[2])) == [False, False, True]
    ax = from_planes(planes_from_torch(got[0]))
    ay = from_planes(planes_from_torch(got[1]))
    keep = [m for j, m in enumerate(committees[3]) if j not in (1, 6)]
    assert (ax[0], ay[0]) == host_sum(keep)
    assert (ax[1], ay[1]) == host_sum(committees[5])


@pytest.fixture(scope="module")
def miller_pair():
    """Miller outputs of (Pt, Q) and (-Pt, Q) from both packages."""
    pt = C.g1.multiply_raw(C.G1_GENERATOR, 1234567)
    q = C.g2.multiply_raw(C.G2_GENERATOR, 7654321)
    pairs = [(pt, q), (C.g1.affine_neg(pt), q)]
    packed = BPair.pack_pairs(pairs)
    port = BPair.get_pairing_ops("cpu")["miller"](*[_t(v) for v in packed])
    ref = JBPair._get_ops(True, True)["miller"](*[_jnp(v) for v in packed])
    return pairs, port, ref


def test_miller_matches_jax_and_host(miller_pair):
    pairs, port, ref = miller_pair
    assert _same(port, ref)
    # the projective loop's values differ from the host loop's by factors
    # that the final exponentiation kills
    got = FQ.fq12_batch_from_limbs(planes_from_torch(port))
    for f, (p, q) in zip(got, pairs):
        assert JP.final_exponentiation(f) == JP.final_exponentiation(JP.miller_loop(p, q))


@pytest.fixture(scope="module")
def tail_inputs(miller_pair):
    """Four checks of two Miller outputs each, in both packages, and the JAX
    package's verdicts (its composed tail):
    [e(Pt,Q) e(-Pt,Q)] -> 1; [e(Pt,Q) e(Pt,Q)] -> not 1;
    [e(Pt,Q), masked] -> not 1; [masked, masked] -> 1."""
    _, port_f, ref_f = miller_pair
    order = np.array([[0, 1], [0, 0], [0, 1], [0, 1]])
    mask = np.array([[True, True], [True, True], [True, False], [False, False]])
    port_in = port_f[..., torch.from_numpy(order.reshape(-1))].reshape(32, 2, 3, 2, 4, 2)
    ref_in = np.asarray(ref_f)[..., order.reshape(-1)].reshape(32, 2, 3, 2, 4, 2)
    want = JBPair._get_ops(True, True)["check_tail"](_jnp(ref_in), _jnp(mask))
    return port_in, torch.from_numpy(mask), [bool(v) for v in np.asarray(want)]


# each tail forced through the constant: at 0 every batch takes the composed
# tail, at 64 these 4 checks take the hybrid one (native, or pure Python)
TAILS = {"composed": (0, False), "hybrid": (64, False), "hybrid-pure-python": (64, True)}


@pytest.mark.parametrize("tail", list(TAILS))
def test_check_tail_verdicts_match_jax(tail_inputs, monkeypatch, tail):
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import native

    port_in, mask, want = tail_inputs
    constant, pure = TAILS[tail]
    monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", constant)
    with native.pure_python() if pure else contextlib.nullcontext():
        assert native.enabled() is not pure
        got = BPair.get_pairing_ops("cpu")["check_tail"](port_in, mask)
    assert got.device.type == "cpu" and got.dtype == torch.bool
    assert got.tolist() == want == [True, False, False, True]


@pytest.mark.parametrize("checks", [1, 4])
def test_composed_final_exp_launches_are_pinned(miller_pair, monkeypatch, checks):
    """The composed tail's final exponentiation makes the same field calls
    at any number of checks: ``FINAL_EXP_LAUNCHES``, which ``chip_smoke.py``
    holds the card's launch counts to (composed route minus default route)."""
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    _, port_f, _ = miller_pair
    calls = Counter()
    for name, plain in list(BP._PLAIN.items()):
        monkeypatch.setitem(BP._PLAIN, name,
                            lambda a, b, name=name, plain=plain: calls.update([name]) or plain(a, b))
    product = port_f[..., :1].expand(*port_f.shape[:4], checks)
    out = BPair.get_pairing_ops("cpu")["final_exp"](product)
    assert out.shape == product.shape
    assert dict(calls) == BPair.FINAL_EXP_LAUNCHES
