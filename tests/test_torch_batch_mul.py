"""The port's batched scalar multiplication and pairing-product API against
the JAX package and the host oracle, bit for bit.

``batch_g1_mul`` / ``batch_g2_mul`` at 16-bit scalars over 1, 3 and 9 lanes
(``k = 0`` lanes included) against the JAX package's plane ladders in
interpret mode (``planes=True, interpret=True``: eager ops over the jitted
einsum field, padded to its 1,024-lane tile, so one 9-lane call covers the
three shapes) and the host ``multiply_raw``; ``batch_inv_mod`` against the
JAX package's; ``miller_loop_batch`` and ``pairing_products_are_one``
against the JAX package's, run through its eager interpret-mode pairing ops
(``bls_pairing._get_ops(True, True)``, since its default CPU route compiles
the whole loop for minutes).  The port runs on the CPU through the field
kernels' plain versions.  Tolerance: none, every value is exact.
"""

import random

import pytest
import torch

from lambda_ethereum_consensus_tpu.ops import bls_g1 as JG1
from lambda_ethereum_consensus_tpu.ops import bls_g2 as JG2
from lambda_ethereum_consensus_tpu.ops import bls_pairing as JBPair
from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
from lambda_ethereum_consensus_tpu_torch.crypto.bls import pairing as HP
from lambda_ethereum_consensus_tpu_torch.crypto.bls.fields import P, R
from lambda_ethereum_consensus_tpu_torch.ops import bls_g1 as G1
from lambda_ethereum_consensus_tpu_torch.ops import bls_g2 as G2
from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

RNG = random.Random(3141)
BITS = 16
# 9 lanes: two k = 0 lanes, the edges 1 and 2^16 - 1, and random scalars
SCALARS = [0, 1, RNG.getrandbits(BITS), 0, (1 << BITS) - 1] + [RNG.getrandbits(BITS) for _ in range(4)]
GROUPS = {
    "g1": (C.g1, C.G1_GENERATOR, G1.batch_g1_mul, JG1.batch_g1_mul),
    "g2": (C.g2, C.G2_GENERATOR, G2.batch_g2_mul, JG2.batch_g2_mul),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("group", list(GROUPS))
def test_batch_mul_matches_jax_and_host(group):
    host, gen, port_mul, jax_mul = GROUPS[group]
    pts = [host.multiply_raw(gen, RNG.randrange(1, R)) for _ in SCALARS]
    want = [host.multiply_raw(pt, k) for pt, k in zip(pts, SCALARS)]
    ref = jax_mul(pts, SCALARS, BITS, planes=True, interpret=True)
    assert ref == want
    for n in (1, 3, 9):
        got = port_mul(pts[:n], SCALARS[:n], BITS, device="cpu")
        assert got == ref[:n], f"{group} diverged at {n} lanes"
    assert [v is None for v in want] == [k == 0 for k in SCALARS]
    assert port_mul([], [], BITS, device="cpu") == []
    with pytest.raises(ValueError):
        port_mul(pts[:2], SCALARS[:1], BITS, device="cpu")


def test_batch_inv_mod_matches_jax():
    values = [1, P - 1, 2] + [RNG.randrange(1, P) for _ in range(6)]
    got = G1.batch_inv_mod(values, P)
    assert got == JG1.batch_inv_mod(values, P) == [pow(v, P - 2, P) for v in values]
    assert G1.batch_inv_mod([], P) == []
    with pytest.raises(ValueError):
        G1.batch_inv_mod([3, 0], P)


def _jax_pairing_ops(monkeypatch):
    """The JAX package's eager interpret-mode plane pairing, in place of
    its default CPU route."""
    real = JBPair._get_ops
    monkeypatch.setattr(JBPair, "_get_ops", lambda plane=False, interpret=False, eager=None:
                        real(True, True, True))


def test_miller_loop_batch_and_product_checks_match_jax(monkeypatch):
    _jax_pairing_ops(monkeypatch)
    a = RNG.getrandbits(64)
    a_p = C.g1.multiply_raw(C.G1_GENERATOR, a)
    a_q = C.g2.multiply_raw(C.G2_GENERATOR, a)
    neg_g = C.g1.affine_neg(C.G1_GENERATOR)
    # three pairs pad to four Miller lanes, the shape of the checks below
    pairs = [(a_p, C.G2_GENERATOR), (neg_g, a_q), (C.G1_GENERATOR, a_q)]
    got = BPair.miller_loop_batch(pairs, device="cpu")
    assert got == JBPair.miller_loop_batch(pairs, plane=True)
    for f, (p, q) in zip(got, pairs):
        assert HP.final_exponentiation(f) == HP.final_exponentiation(HP.miller_loop(p, q))

    bad = C.g1.multiply_raw(C.G1_GENERATOR, a + 1)
    checks = [[(a_p, C.G2_GENERATOR), (neg_g, a_q)], [(bad, C.G2_GENERATOR), (neg_g, a_q)]]
    verdicts = BPair.pairing_products_are_one(checks, device="cpu")
    assert verdicts == JBPair.pairing_products_are_one(checks, plane=True) == [True, False]
    assert verdicts == [HP.pairing_check(c) for c in checks]
    assert BPair.miller_loop_batch([], device="cpu") == []
    assert BPair.pairing_products_are_one([], device="cpu") == []


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pair = (C.G1_GENERATOR, C.G2_GENERATOR)
    for call in (
        lambda: G1.batch_g1_mul([C.G1_GENERATOR], [3]),
        lambda: G2.batch_g2_mul([C.G2_GENERATOR], [3]),
        lambda: BPair.miller_loop_batch([pair]),
        lambda: BPair.pairing_product_is_one([pair]),
        lambda: BPair.pairing_products_are_one([[pair]]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
