"""The port's witness plane against the JAX package's.

The same minimal-spec genesis state of 16 validators, built by the JAX
package and carried across as SSZ bytes, goes through both packages: the
engines' retained rows, proof bytes, plans and errors, and the verdicts of
the port's plane (``device="cpu"``: its plain PyTorch version, one
``sha256_nodes`` call per round) held against the JAX package's host
oracle ``verify_host``, its host plane ``_verify_plane_host``, its
``verify_batch(..., device=False)`` and its jitted round body
``_verify_rounds_body`` (called through ``jax.jit`` directly, so nothing
goes through the JAX package's on-disk executable cache).  Tolerance:
none, bytes and booleans are exact.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.ssz.incremental import IncrementalStateRoot as JaxEngine
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.types.beacon import BeaconState as JaxBeaconState
from lambda_ethereum_consensus_tpu.witness import multiproof as jmp
from lambda_ethereum_consensus_tpu.witness import verify as jverify
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch.config import ChainSpec, minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.ssz.incremental import IncrementalStateRoot
from lambda_ethereum_consensus_tpu_torch.types import BeaconState
from lambda_ethereum_consensus_tpu_torch.witness import multiproof as mp
from lambda_ethereum_consensus_tpu_torch.witness import verify as V

N = 16
SKS = [(i + 1).to_bytes(32, "big") for i in range(N)]
FIELDS = ("balances", "validators", "inactivity_scores",
          "previous_epoch_participation", "current_epoch_participation")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def states():
    """(jax spec, jax state, port spec, port state), both chain specs active."""
    jspec, pspec = jax_minimal_spec(), minimal_spec()
    with jax_use_chain_spec(jspec), use_chain_spec(pspec):
        jstate = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=jspec)
        pstate = convert.state_from_ssz(jstate.encode(jspec), pspec)
        yield jspec, jstate, pspec, pstate


@pytest.fixture(scope="module")
def planners(states):
    return jmp.WitnessPlanner(), mp.WitnessPlanner()


def _to_jax(proof):
    """The same proof as a JAX-package object (plain tuples of ints and bytes)."""
    return jmp.WitnessProof(proof.state_root, proof.indices, proof.leaves, proof.siblings)


def _prove_both(states, planners, requests):
    jspec, jstate, pspec, pstate = states
    jplanner, pplanner = planners
    return jplanner.prove(jstate, requests, jspec), pplanner.prove(pstate, requests, pspec)


def _adversaries(proof, cls):
    """The six rejection cases of the JAX package's witness tests, built as
    ``cls`` objects: (name, proof, expected root override)."""
    g, chunk = proof.leaves[0]
    return [
        ("corrupted sibling", cls(proof.state_root, proof.indices, proof.leaves,
                                  tuple([b"\x5a" * 32] + list(proof.siblings[1:]))), None),
        ("truncated proof", cls(proof.state_root, proof.indices, proof.leaves,
                                proof.siblings[:-1]), None),
        ("padded proof", cls(proof.state_root, proof.indices, proof.leaves,
                             proof.siblings + (b"\x00" * 32,)), None),
        ("duplicated gindex", cls(proof.state_root, proof.indices,
                                  ((g, chunk), (g, chunk)) + proof.leaves[1:], proof.siblings), None),
        ("empty index set", cls(proof.state_root, (), (), proof.siblings), None),
        ("wrong root", proof, b"\x13" * 32),
    ]


def _mixed_requests(rng, count: int) -> list:
    """Seeded requests of 1, 4 and 16 indices over the witness fields."""
    out = []
    for k in range(count):
        width = (1, 4, 16)[k % 3]
        out.append([(FIELDS[int(rng.integers(len(FIELDS)))], int(rng.integers(N)))
                    for _ in range(width)])
    return out


def _jit_verdicts(packed) -> list:
    """The JAX package's round body, jitted directly (no on-disk cache),
    over the port's assembled plane."""
    import jax
    import jax.numpy as jnp

    words = np.ascontiguousarray(packed["nodes"]).view(">u4").astype(np.uint32)
    expected = np.ascontiguousarray(packed["expected"]).view(">u4").astype(np.uint32)
    out = jax.jit(jverify._verify_rounds_body)(
        jnp.asarray(words), jnp.asarray(packed["lidx"]), jnp.asarray(packed["ridx"]),
        jnp.asarray(packed["oidx"]), jnp.asarray(packed["root_idx"]), jnp.asarray(expected))
    return [bool(x) for x in np.asarray(out)[: packed["n"]]]


# ------------------------------------------------------------ engine rows


def _rows_equal(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_engine_rows_match_jax_before_and_after_a_mutation(states):
    jspec, jstate, pspec, pstate = states
    jeng, peng = JaxEngine(JaxBeaconState), IncrementalStateRoot(BeaconState)
    assert peng.top_levels() is None and peng.retained_bytes() == 0
    for step in range(2):
        assert peng.root(pstate, pspec) == jeng.root(jstate, jspec)
        assert _rows_equal(peng.top_levels(), jeng.top_levels())
        assert peng.top_levels()[0].shape[0] == len(BeaconState.__ssz_schema__)
        for fname in mp.witness_fields(BeaconState, pspec):
            jrows, prows = jeng.field_levels(fname), peng.field_levels(fname)
            assert (prows is None) == (jrows is None), fname
            if prows is not None:
                assert _rows_equal(prows, jrows), fname
        assert peng.field_levels("slot") is None  # small field: uncached
        assert peng.retained_bytes() == jeng.retained_bytes()
        if step == 0:
            bal = list(pstate.balances)
            bal[3] += 12345
            vals = list(pstate.validators)
            vals[5] = vals[5].copy(effective_balance=int(vals[5].effective_balance) - 10**9)
            jvals = list(jstate.validators)
            jvals[5] = jvals[5].copy(effective_balance=int(jvals[5].effective_balance) - 10**9)
            pstate = pstate.copy(balances=bal, validators=vals)
            jstate = jstate.copy(balances=bal, validators=jvals)


def test_engine_spec_swap_resets_the_rows(states):
    _, _, pspec, pstate = states
    eng = IncrementalStateRoot(BeaconState)
    root = eng.root(pstate, pspec)
    top, balances = eng.top_levels(), eng.field_levels("balances")
    assert eng.root(pstate, pspec) == root and eng.field_levels("balances") is balances
    renamed = ChainSpec(pspec.name + "-renamed", pspec)
    assert eng.root(pstate, renamed) == root
    assert eng.top_levels() is not top and _rows_equal(eng.top_levels(), top)
    assert eng.field_levels("balances") is not balances
    assert _rows_equal(eng.field_levels("balances"), balances)


# ------------------------------------------------------------ proof bytes

REQUESTS = {
    "one balance": [("balances", 0)],
    "every field, last index": [(f, N - 1) for f in FIELDS],
    "duplicates": [("balances", 1), ("balances", 2), ("balances", 1)],
    "out of order": [("validators", 9), ("balances", 14), ("validators", 2), ("balances", 0)],
    "adjacent chunks": [("balances", 0), ("balances", 4), ("inactivity_scores", 7)],
    "sixteen validators": [("validators", i) for i in range(N)],
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_proof_bytes_equal_jax(states, planners, name):
    jproof, pproof = _prove_both(states, planners, REQUESTS[name])
    assert pproof.encode() == jproof.encode()
    assert pproof.to_json() == jproof.to_json()
    assert pproof.state_root == states[3].hash_tree_root(states[2])
    assert mp.verify_host(pproof, pproof.state_root)


@pytest.mark.parametrize("fname", FIELDS)
def test_every_witness_field_proves_like_jax(states, planners, fname):
    jproof, pproof = _prove_both(states, planners, [(fname, N - 1), (fname, 0)])
    assert pproof.encode() == jproof.encode()
    assert mp.witness_fields(BeaconState, states[2]).keys() == \
        jmp.witness_fields(JaxBeaconState, states[0]).keys()


@pytest.mark.parametrize("requests", [
    [("slot", 0)],                      # not witness-enabled
    [("balances", N)],                  # out of range
    [("balances", 0)] * (mp.MAX_PROOF_INDICES + 1),  # over the cap
    [],                                 # empty
])
def test_proof_errors_match_jax(states, planners, requests):
    with pytest.raises(jmp.WitnessError) as jerr:
        planners[0].prove(states[1], requests, states[0])
    with pytest.raises(mp.WitnessError) as perr:
        planners[1].prove(states[3], requests, states[2])
    assert str(perr.value) == str(jerr.value)


def _plan_fields(plan) -> tuple:
    return (plan.leaf_gindices, plan.helper_count, plan.n_slots, plan.rounds, plan.root_slot)


@pytest.mark.parametrize("seed", range(4))
def test_plan_rounds_agrees_on_seeded_leaf_sets(seed):
    rng = np.random.default_rng(seed)
    depth = int(rng.integers(4, 48))
    k = int(rng.integers(1, 24))
    leaves = sorted({int(x) for x in rng.integers(1 << depth, 1 << (depth + 1), size=k)})
    assert _plan_fields(mp.plan_rounds(leaves)) == _plan_fields(jmp.plan_rounds(leaves))
    assert mp.helper_gindices(leaves) == jmp.helper_gindices(leaves)


@pytest.mark.parametrize("leaves", [[], [8, 8], [9, 8], [4, 8], [1 << 70]])
def test_plan_rejects_malformed_leaf_sets_like_jax(leaves):
    with pytest.raises(jmp.WitnessError) as jerr:
        jmp.plan_rounds(leaves)
    with pytest.raises(mp.WitnessError) as perr:
        mp.plan_rounds(leaves)
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------------------ verdicts


def _all_paths(proofs, roots) -> dict:
    """Every route's verdicts on one batch: the port's plane (plain
    version) and its host plane, the JAX package's oracle, its
    ``verify_batch(device=False)`` and its host plane over the port's
    assembled plane."""
    is_proof = [isinstance(p, mp.WitnessProof) for p in proofs]
    jproofs = [_to_jax(p) if ok else p for p, ok in zip(proofs, is_proof)]
    out = {
        "port verify_batch": V.verify_batch(proofs, roots, device="cpu"),
        # the per-proof oracles take proofs only; verify_batch rejects the rest
        "port verify_host": [ok and mp.verify_host(p, r)
                             for p, r, ok in zip(proofs, roots, is_proof)],
        "jax verify_host": [ok and jmp.verify_host(p, r)
                            for p, r, ok in zip(jproofs, roots, is_proof)],
        "jax verify_batch": jverify.verify_batch(jproofs, roots, device=False),
    }
    live = [i for i, p in enumerate(proofs) if _plannable(p)]
    packed = V._assemble([proofs[i] for i in live], [roots[i] for i in live],
                         [mp.plan_for(proofs[i]) for i in live])
    for name, plane in (("jax _verify_plane_host", jverify._verify_plane_host),
                        ("port _verify_plane_host", V._verify_plane_host),
                        ("port _verify_plane", lambda pk: V._verify_plane(pk, "cpu"))):
        got = [False] * len(proofs)
        for i, ok in zip(live, plane({**packed, "nodes": packed["nodes"].copy()})):
            got[i] = bool(ok)
        out[name] = got
    return out


def _plannable(proof) -> bool:
    if not isinstance(proof, mp.WitnessProof):
        return False
    try:
        mp.plan_for(proof)
    except mp.WitnessError:
        return False
    return True


def test_mixed_width_batch_with_adversaries_agrees_on_every_path(states, planners):
    rng = np.random.default_rng(7)
    proofs = [_prove_both(states, planners, req)[1] for req in _mixed_requests(rng, 12)]
    root = proofs[0].state_root
    batch, roots = list(proofs), [root] * len(proofs)
    for name, bad, override in _adversaries(proofs[2], mp.WitnessProof):
        batch.append(bad)
        roots.append(override or root)
    batch.append("not a proof")
    roots.append(root)
    paths = _all_paths(batch, roots)
    expected = [True] * len(proofs) + [False] * 7
    for name, got in paths.items():
        assert got == expected, name
    live = [i for i, p in enumerate(batch) if _plannable(p)]
    packed = V._assemble([batch[i] for i in live], [roots[i] for i in live],
                         [mp.plan_for(batch[i]) for i in live])
    assert _jit_verdicts(packed) == [expected[i] for i in live]


@pytest.mark.parametrize("case", range(6))
def test_each_adversary_rejects_in_a_batch_of_valid_proofs(states, planners, case):
    proof = _prove_both(states, planners, [("balances", 2), ("validators", 5)])[1]
    root = proof.state_root
    name, bad, override = _adversaries(proof, mp.WitnessProof)[case]
    batch = [proof] * (V.DEVICE_MIN - 1) + [bad]
    roots = [root] * (V.DEVICE_MIN - 1) + [override or root]
    jbad = _adversaries(_to_jax(proof), jmp.WitnessProof)[case][1]
    assert jmp.verify_host(jbad, override or root) is False, name
    got = V.verify_batch(batch, roots, device="cpu")
    assert got == [True] * (V.DEVICE_MIN - 1) + [False], name
    assert got == [jmp.verify_host(_to_jax(p) if p is not bad else jbad, r)
                   for p, r in zip(batch, roots)]


def test_size_route_and_launch_count(states, planners, monkeypatch):
    """Below DEVICE_MIN live proofs the oracle answers (no SHA-256 call);
    a plane calls ``sha256_nodes`` once per round of its deepest plan."""
    calls = []
    real = V.sha256_nodes

    def counting(blocks):
        calls.append(int(blocks.shape[0]))
        return real(blocks)

    monkeypatch.setattr(V, "sha256_nodes", counting)
    proofs = [_prove_both(states, planners, [("balances", i)])[1] for i in range(V.DEVICE_MIN)]
    root = proofs[0].state_root
    assert V.verify_batch(proofs[:-1], root, device="cpu") == [True] * (V.DEVICE_MIN - 1)
    assert calls == []
    wide = _prove_both(states, planners, [("validators", i) for i in range(0, N, 3)])[1]
    batch = proofs[:-1] + [wide]
    assert V.verify_batch(batch, root, device="cpu") == [True] * V.DEVICE_MIN
    plans = [mp.plan_for(p) for p in batch]
    assert len(calls) == max(len(p.rounds) for p in plans)
    assert set(calls) == {V.DEVICE_MIN * max(p.max_round_ops for p in plans)}


def test_guard_splits_a_batch_into_planes(states, planners, monkeypatch):
    requests = [[(FIELDS[k % 5], (3 * k) % N), (FIELDS[k % 5], (3 * k + 1) % N)][: 1 + k % 2]
                for k in range(9)]
    proofs = [_prove_both(states, planners, req)[1] for req in requests]
    wide = _prove_both(states, planners, [(f, i) for f in FIELDS for i in range(N)])[1]
    proofs.insert(4, wide)
    root = proofs[0].state_root
    plans = [mp.plan_for(p) for p in proofs]
    # planes of at most the wide proof's padded slots: it is too wide for a
    # plane of two and goes to the oracle, the rest fill several planes
    limit = V._pow2(plans[4].n_slots)
    assert max(V._pow2(p.n_slots) for i, p in enumerate(plans) if i != 4) < limit
    monkeypatch.setattr(V, "MAX_PLANE_SLOTS", limit)
    monkeypatch.setattr(V, "MIN_PLANE_BATCH", 2)
    planes, oracle = V.split_planes(list(range(len(proofs))), plans)
    assert oracle == [4]
    assert len(planes) > 1
    for plane in planes:
        assert len(plane) * max(V._pow2(plans[i].n_slots) for i in plane) <= limit
    seen = []
    real = V._verify_plane
    monkeypatch.setattr(V, "_verify_plane", lambda pk, dev: seen.append(pk["n"]) or real(pk, dev))
    bad = mp.WitnessProof(proofs[6].state_root, proofs[6].indices, proofs[6].leaves,
                          tuple([b"\x01" * 32] + list(proofs[6].siblings[1:])))
    proofs[6] = bad
    expected = [jmp.verify_host(_to_jax(p), root) for p in proofs]
    assert expected.count(False) == 1
    assert V.verify_batch(proofs, root, device="cpu") == expected
    assert seen == [len(p) for p in planes]


def test_split_planes_at_the_mainnet_shapes():
    """2,048 proofs of the widest mainnet shape (576 slots, 1,024 padded)
    fill one plane of 2^21 slots; 4,096 make two; a proof past 32,768
    padded slots goes to the oracle."""

    class Plan:
        def __init__(self, n_slots):
            self.n_slots = n_slots

    mixed = [Plan((90, 94, 510, 576)[i % 4]) for i in range(4096)]
    planes, oracle = V.split_planes(list(range(2048)), mixed)
    assert [len(p) for p in planes] == [2048] and oracle == []
    planes, oracle = V.split_planes(list(range(4096)), mixed)
    assert [len(p) for p in planes] == [2048, 2048] and oracle == []
    planes, oracle = V.split_planes([0, 1], [Plan(32769), Plan(90)])
    assert planes == [[1]] and oracle == [0]


def test_verify_batch_shapes(states, planners):
    proof = _prove_both(states, planners, [("balances", 0)])[1]
    assert V.verify_batch([], b"\x00" * 32, device="cpu") == []
    with pytest.raises(mp.WitnessError):
        V.verify_batch([proof, proof], [proof.state_root], device="cpu")
    assert V.verify_batch([object()] * V.DEVICE_MIN, proof.state_root, device="cpu") == \
        [False] * V.DEVICE_MIN


def test_verify_batch_reports_to_a_metrics_sink(states, planners):
    calls = []

    class Sink:
        def inc(self, name, value=1, **labels):
            calls.append(("inc", name, value, labels))

        def observe(self, name, value, **labels):
            calls.append(("observe", name, labels))

        @contextlib.contextmanager
        def span(self, name, slow=None, **labels):
            yield
            self.observe(name + "_seconds", 0.0, **labels)

    proof = _prove_both(states, planners, [("balances", 0)])[1]
    V.verify_batch([proof, "junk"], proof.state_root, device="cpu", metrics=Sink())
    assert calls == [("observe", "witness_verify_seconds", {}),
                     ("inc", "witness_verified_total", 1, {"result": "ok"}),
                     ("inc", "witness_verified_total", 1, {"result": "invalid"})]


# ------------------------------------------------------------ encodings


def test_jax_proof_bytes_decode_in_the_port(states, planners):
    jproof, pproof = _prove_both(states, planners, [("balances", 1), ("inactivity_scores", 3),
                                                    ("validators", 12)])
    blob = jproof.encode()
    got = convert.witness_proof_from_ssz(blob)
    assert got == pproof
    assert got.encode() == blob
    assert mp.WitnessProof.from_json(json.loads(json.dumps(jproof.to_json()))) == pproof
    assert mp.WitnessProof.decode(pproof.encode()) == pproof


def test_truncated_and_malformed_encodings_reject_like_jax(states, planners):
    jproof, pproof = _prove_both(states, planners, [("balances", 1)])
    blob = pproof.encode()
    cases = [blob[:-7], blob + b"\x00", b"", blob[:31]]
    rng = np.random.default_rng(3)
    for _ in range(24):
        raw = bytearray(blob)
        at = int(rng.integers(len(raw)))
        raw[at] ^= 1 << int(rng.integers(8))
        cases.append(bytes(raw[: int(rng.integers(len(raw) // 2, len(raw) + 1))]))
    for data in cases:
        try:
            want = jmp.WitnessProof.decode(data)
        except jmp.WitnessError as e:
            with pytest.raises(mp.WitnessError) as perr:
                convert.witness_proof_from_ssz(data)
            assert str(perr.value) == str(e)
        else:
            got = convert.witness_proof_from_ssz(data)
            assert got.encode() == want.encode()
    for obj in ({"leaves": [], "siblings": []},
                {**pproof.to_json(), "siblings": ["0x1234"] + pproof.to_json()["siblings"][1:]}):
        with pytest.raises(jmp.WitnessError):
            jmp.WitnessProof.from_json(obj)
        with pytest.raises(mp.WitnessError):
            mp.WitnessProof.from_json(obj)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_plane_on_card_matches_cpu(states, planners):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the witness plane on the card")
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops

    rng = np.random.default_rng(5)
    proofs = [_prove_both(states, planners, req)[1] for req in _mixed_requests(rng, 12)]
    root = proofs[0].state_root
    proofs[3] = _adversaries(proofs[3], mp.WitnessProof)[0][1]
    sops.sha256_kernel_launches = 0
    card = V.verify_batch(proofs, root)
    assert sops.sha256_kernel_launches == max(len(mp.plan_for(p).rounds) for p in proofs)
    assert card == V.verify_batch(proofs, root, device="cpu")
    assert card.count(False) == 1 and not card[3]
