"""The port's size routes against the JAX package's.

``verify_points``, ``batch_verify`` and ``batch_verify_each_points`` pick
their route by size alone: from ``DEVICE_CHAIN_MIN`` entries up the chained
device check (``ops.bls_batch.chain_verify``, here on the CPU through the
field kernels' plain versions), below it the host tail
(``_verify_points_host``, the native ``rlc_verify``).  The constant is
monkeypatched to 4, so sets of 3 and 5 entries (keys ``(i + 1).to_bytes(32,
"big")``) fall on either side of it; each case counts the calls of both
routes and holds the verdicts, and the blame, equal to the JAX package's on
the same entries (its CPU route: the host RLC).  ``attestation_batch_target``
(which reads the drain's own constant, ``fork_choice/handlers.py``
``DRAIN_DEVICE_MIN``) is held against the JAX package's, and ``device=None``
must raise without a card on the host side of the gate too.

The pairing tail of every chained call routes by its number of checks
(``ops/bls_pairing.py`` ``DEVICE_TAIL_MIN``): below it the hybrid tail (the
native ``final_exp_is_one``), from it on the composed tail (the final
exponentiation on the device, here the plain versions).  With the set gate
at 0, ``verify_points`` (one check) runs each tail as the tail constant
puts it on either side, and a bisection, through ``verify_points``' entries
and through a committee cache, runs its first level (one check) on the
hybrid tail and its later levels (two checks) on the composed one at a tail
constant of 2; calls of both tails are counted, verdicts and blame held to
the JAX package's.  Tolerance: none, every check is exact.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu.crypto.bls import batch as JB
from lambda_ethereum_consensus_tpu.crypto.bls import pairing as JP
from lambda_ethereum_consensus_tpu.fork_choice import handlers as jhandlers
from lambda_ethereum_consensus_tpu_torch import fork_choice as pfc
from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B
from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
from lambda_ethereum_consensus_tpu_torch.crypto.bls import native
from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import DST_POP, hash_to_g2
from lambda_ethereum_consensus_tpu_torch.fork_choice import handlers as phandlers
from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as BB
from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

GATE = 4
SKS = [(i + 1).to_bytes(32, "big") for i in range(5)]
MSGS = [b"size-routes-a", b"size-routes-b"]
BITS = 16
FORGED = 1  # signed with the next key's scalar
# the module constant attestation_batch_target reads
DRAIN_CONSTANT = (phandlers, "DRAIN_DEVICE_MIN")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _gate(monkeypatch):
    monkeypatch.setattr(B, "DEVICE_CHAIN_MIN", GATE)


@pytest.fixture(scope="module")
def memo():
    return {(m, DST_POP): hash_to_g2(m, DST_POP) for m in MSGS}


def _entries(memo, n: int, case: str):
    """``n`` (pk, message, sig) entries over two messages: all valid, one
    forged (entry FORGED signed by another key), or entry FORGED's key
    undecodable (``None``)."""
    out = []
    for i, sk in enumerate(SKS[:n]):
        k = int.from_bytes(sk, "big")
        msg = MSGS[i % 2]
        signer = k + 1 if case == "forged" and i == FORGED else k
        pk = None if case == "none" and i == FORGED else C.g1.multiply_raw(C.G1_GENERATOR, k)
        out.append((pk, msg, C.g2.multiply_raw(memo[(msg, DST_POP)], signer)))
    return out


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of each route: ``chain`` (the number of checks in
    each ``chain_verify`` call), ``host`` (``_verify_points_host``) and
    ``rlc`` (the native ``rlc_verify`` under it)."""
    seen = {"chain": [], "host": Counter()}
    chain, host, rlc = BB.chain_verify, B._verify_points_host, native.rlc_verify

    def chain_spy(checks, *args, **kwargs):
        seen["chain"].append(len(checks))
        return chain(checks, *args, **kwargs)

    def host_spy(*args, **kwargs):
        seen["host"]["host"] += 1
        return host(*args, **kwargs)

    def rlc_spy(*args, **kwargs):
        seen["host"]["rlc"] += 1
        return rlc(*args, **kwargs)

    monkeypatch.setattr(BB, "chain_verify", chain_spy)
    monkeypatch.setattr(B, "_verify_points_host", host_spy)
    monkeypatch.setattr(native, "rlc_verify", rlc_spy)
    return seen


def _host_calls_took_native(seen) -> None:
    if native.enabled():
        assert seen["host"]["rlc"] == seen["host"]["host"]


@pytest.mark.parametrize("case", ["valid", "forged", "none"])
@pytest.mark.parametrize("n", [GATE - 1, GATE + 1])
def test_verify_points_routes_by_size(memo, routes, n, case):
    entries = _entries(memo, n, case)
    want = case == "valid"
    assert JB.verify_points(entries) is want
    got = B.verify_points(entries, message_points=dict(memo), device="cpu", coeff_bits=BITS)
    assert got is want
    live = case != "none"  # a None point fails the set before any route
    assert routes["chain"] == ([1] if live and n >= GATE else [])
    assert routes["host"]["host"] == (1 if live and n < GATE else 0)
    _host_calls_took_native(routes)


@pytest.mark.parametrize("case", ["valid", "forged", "none"])
@pytest.mark.parametrize("n", [GATE - 1, GATE + 1])
def test_batch_verify_each_points_routes_each_level(memo, routes, n, case):
    """A level goes to the device only while its longest range reaches the
    gate: at 5 entries the first level is one chained call and every later
    level (ranges of at most 3) runs on the host tail."""
    entries = _entries(memo, n, case)
    want = JB.batch_verify_each_points(entries)
    assert want == [case == "valid" or i != FORGED for i in range(n)]
    got = B.batch_verify_each_points(entries, message_points=dict(memo), device="cpu",
                                     coeff_bits=BITS)
    assert got == want
    assert routes["chain"] == ([1] if case != "none" and n >= GATE else [])
    assert (routes["host"]["host"] > 0) == (n < GATE or case != "valid")
    _host_calls_took_native(routes)


@pytest.mark.parametrize("case", ["valid", "forged", "none"])
@pytest.mark.parametrize("n", [GATE - 1, GATE + 1])
def test_batch_verify_routes_by_size(routes, n, case):
    """Byte triples through ``batch_verify``: the route of the
    ``verify_points`` it ends in; an infinity signature decodes to ``None``
    and fails the set before any route."""
    from lambda_ethereum_consensus_tpu.crypto import bls as jbls
    from lambda_ethereum_consensus_tpu_torch.crypto import bls

    items = [(bls.sk_to_pk(sk), MSGS[i % 2], bls.sign(sk, MSGS[i % 2]))
             for i, sk in enumerate(SKS[:n])]
    if case == "forged":
        items[FORGED] = (*items[FORGED][:2], bls.sign(SKS[FORGED + 1], MSGS[FORGED % 2]))
    elif case == "none":
        items[FORGED] = (*items[FORGED][:2], b"\xc0" + b"\x00" * 95)
    want = case == "valid"
    assert jbls.batch_verify(items) is want
    assert B.batch_verify(items, device="cpu", coeff_bits=BITS) is want
    live = case != "none"
    assert routes["chain"] == ([1] if live and n >= GATE else [])
    assert routes["host"]["host"] == (1 if live and n < GATE else 0)
    _host_calls_took_native(routes)


@pytest.mark.parametrize("constant", [0, 1, 128])
def test_attestation_batch_target_matches_jax(monkeypatch, constant):
    monkeypatch.setattr(*DRAIN_CONSTANT, constant)
    assert pfc.attestation_batch_target() == max(1, constant)
    monkeypatch.setenv("BLS_DEVICE_CHAIN_MIN", str(constant))
    assert jhandlers.attestation_batch_target() == pfc.attestation_batch_target()


def test_small_sets_resolve_the_card_first(memo, routes, monkeypatch):
    """Below the gate the host tail would answer, but ``device=None`` still
    means the card: without one every entry point raises before a check."""
    from lambda_ethereum_consensus_tpu_torch.crypto import bls

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entries = _entries(memo, GATE - 1, "valid")
    items = [(bls.sk_to_pk(sk), MSGS[i % 2], bls.sign(sk, MSGS[i % 2]))
             for i, sk in enumerate(SKS[:GATE - 1])]
    for call in (
        lambda: B.verify_points(entries, message_points=dict(memo)),
        lambda: B.batch_verify_each_points(entries, message_points=dict(memo)),
        lambda: B.batch_verify(items),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert routes["chain"] == [] and not routes["host"]
    # the host tail asked for by name needs no card
    assert B.verify_points(entries, message_points=dict(memo), host=True) is True


@pytest.fixture
def tails(monkeypatch):
    """Counts the calls of each pairing tail: ``hybrid`` (the native
    ``final_exp_is_one`` of its host half) and ``composed`` (the device
    final exponentiation)."""
    seen = Counter()
    host, ops = native.final_exp_is_one, BPair.get_pairing_ops("cpu")
    device = ops["final_exp"]

    def host_spy(values):
        seen["hybrid"] += 1
        return host(values)

    def device_spy(f):
        seen["composed"] += 1
        return device(f)

    monkeypatch.setattr(native, "final_exp_is_one", host_spy)
    monkeypatch.setitem(ops, "final_exp", device_spy)
    monkeypatch.setattr(B, "DEVICE_CHAIN_MIN", 0)
    return seen


@pytest.mark.parametrize("case", ["valid", "forged"])
@pytest.mark.parametrize("tail_min", [1, 2], ids=["composed", "hybrid"])
def test_tail_routes_by_checks(memo, tails, monkeypatch, tail_min, case):
    """One check: at a tail constant of 1 the composed tail, at 2 the
    hybrid one."""
    monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", tail_min)
    entries = _entries(memo, 3, case)
    want = case == "valid"
    assert JB.verify_points(entries) is want
    got = B.verify_points(entries, message_points=dict(memo), device="cpu", coeff_bits=BITS)
    assert got is want
    assert tails == Counter({"composed" if tail_min == 1 else "hybrid": 1})


def test_bisection_levels_take_both_tails(memo, tails, monkeypatch):
    monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", 2)
    entries = _entries(memo, 5, "forged")
    want = JB.batch_verify_each_points(entries)
    assert want == [i != FORGED for i in range(5)]
    got = B.batch_verify_each_points(entries, message_points=dict(memo), device="cpu",
                                     coeff_bits=BITS)
    assert got == want
    # levels of 1, 2 and 2 checks: [0, 5); [0, 2) [2, 5); [0, 1) [1, 2)
    assert tails == Counter({"hybrid": 1, "composed": 2})


def test_cached_drain_levels_take_both_tails(memo, tails, monkeypatch):
    """A drain over a 4-committee x 4-member cache with one aggregate signed
    by the wrong key, blamed as the JAX package's pure-Python pairing check
    of each aggregate blames it."""
    monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", 2)
    sks = [int.from_bytes(sk, "big") for sk in SKS[:4]] * 4
    keys = [C.g1.multiply_raw(C.G1_GENERATOR, k) for k in sks]
    committees = np.arange(16, dtype=np.int32).reshape(4, 4)
    cache = BB.DeviceCommitteeCache(BB._g1_planes(keys), committees, device="cpu", chunk=4, mmax=1)
    neg_g1 = C.g1.affine_neg(C.G1_GENERATOR)
    entries, oracle = [], []
    for comm in range(4):
        missing = [int(committees[comm][comm])]
        members = [int(v) for v in committees[comm] if int(v) not in missing]
        msg = MSGS[comm % 2]
        h = memo[(msg, DST_POP)]
        agg_sk = sum(sks[v] for v in members) + (1 if comm == FORGED else 0)
        sig = C.g2.multiply_raw(h, agg_sk)
        entries.append((comm, missing, msg, sig))
        agg_pk = C.g1.multiply_raw(C.G1_GENERATOR, sum(sks[v] for v in members))
        oracle.append(JP.pairing_check([(agg_pk, h), (neg_g1, sig)]))
    assert oracle == [i != FORGED for i in range(4)]
    got = B.batch_verify_each_cached(cache, entries, message_points=dict(memo), coeff_bits=BITS)
    assert got == oracle
    assert tails == Counter({"hybrid": 1, "composed": 2})
