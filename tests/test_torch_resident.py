"""The port's resident epoch plane against the JAX package's host path.

Every slot walk starts from one seeded minimal-preset state, carried across
as SSZ bytes, and goes through the port's ``process_slots`` twice
(``device="cpu"``): on its host path and on its resident plane (the plain
PyTorch columns on the CPU).  Every slot's state root, and the final root,
must equal the JAX package's, which runs its host path: the switch
``GRAFT_RESIDENT_EPOCH`` is set to ``0`` around each JAX call, so the JAX
package's own plane never runs here.  Tolerance: none, roots are exact.

The bodies (``sweep``, ``epoch_sums``, ``hysteresis``, ``scatter``,
``gather``) are also held against direct Python-int formulas at edge
values: a balance saturating at 0 flag by flag, scores at the guard, an
inactivity leak.
"""

import contextlib

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.state_transition import process_slots as jax_process_slots
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.state_transition.mutable import BeaconStateMut as JaxStateMut
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch.config import constants, minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.state_transition import process_slots
from lambda_ethereum_consensus_tpu_torch.state_transition import resident as R
from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut

N = 32
SKS = [(i + 1).to_bytes(32, "big") for i in range(N)]


@pytest.fixture(scope="module")
def specs():
    return jax_minimal_spec(), minimal_spec()


@pytest.fixture(scope="module")
def jax_genesis(specs):
    jspec, _ = specs
    with jax_use_chain_spec(jspec):
        return jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=jspec)


@contextlib.contextmanager
def _resident(monkeypatch, on: bool):
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "1" if on else "0")
    try:
        yield
    finally:
        monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")


def _jax_walk(state, slot, jspec, monkeypatch):
    with _resident(monkeypatch, False), jax_use_chain_spec(jspec):
        return jax_process_slots(state, slot, jspec)


def _port_walk(state, slot, pspec, monkeypatch, resident: bool):
    with _resident(monkeypatch, resident), use_chain_spec(pspec):
        out = process_slots(state, slot, pspec, device="cpu")
    assert (getattr(out, "_resident_plane", None) is not None) == resident
    return out


def _assert_walks_agree(jstate, slot, specs, monkeypatch, expect_sweeps: int):
    """Walk the JAX state's bytes on both of the port's routes and compare
    every history root and the final root with the JAX host walk."""
    jspec, pspec = specs
    start = int(jstate.slot)
    want = _jax_walk(jstate, slot, jspec, monkeypatch)
    ported = convert.state_from_ssz(jstate.encode(jspec), pspec)
    for resident in (False, True):
        got = _port_walk(ported, slot, pspec, monkeypatch, resident)
        for s in range(start, slot):
            i = s % pspec.SLOTS_PER_HISTORICAL_ROOT
            assert bytes(got.state_roots[i]) == bytes(want.state_roots[i]), (resident, s)
            assert bytes(got.block_roots[i]) == bytes(want.block_roots[i]), (resident, s)
        assert got.hash_tree_root(pspec) == want.hash_tree_root(jspec), resident
        if resident:
            stats = got._resident_plane.stats
            assert stats["sweeps"] == expect_sweeps and stats["fallbacks"] == 0, stats
    return got, want


def _staged(jax_genesis, jspec, monkeypatch, stage):
    """A JAX state two slots in, with ``stage(ws)`` applied to it."""
    ws = JaxStateMut(_jax_walk(jax_genesis, 2, jspec, monkeypatch))
    ws._root_engine = None
    stage(ws)
    return ws.freeze()


def test_walk_across_two_boundaries_matches_jax(jax_genesis, specs, monkeypatch):
    """Seeded participation flags and scores, then every slot's root across
    two epoch boundaries on both routes."""
    jspec, _ = specs
    rng = np.random.default_rng(7)

    def stage(ws):
        for i in range(N):
            ws.previous_epoch_participation[i] = int(rng.integers(0, 8))
            ws.current_epoch_participation[i] = int(rng.integers(0, 8))
            ws.inactivity_scores[i] = int(rng.integers(0, 40))

    staged = _staged(jax_genesis, jspec, monkeypatch, stage)
    target = 2 * jspec.SLOTS_PER_EPOCH + 2
    _assert_walks_agree(staged, target, specs, monkeypatch, expect_sweeps=2)


def test_walk_with_slashings_and_registry_churn(jax_genesis, specs, monkeypatch):
    """One pass of every registry-coupled step: a slashing-penalty target,
    an ejection, a new eligibility mark, a churn-queue activation and both
    hysteresis directions, with nonzero scores in the inactivity product."""
    jspec, _ = specs
    epv = jspec.EPOCHS_PER_SLASHINGS_VECTOR

    def stage(ws):
        ws.update_validator(1, slashed=True, exit_epoch=1, withdrawable_epoch=epv // 2)
        ws.slashings[0] = 64 * 10**9
        ws.update_validator(2, effective_balance=jspec.EJECTION_BALANCE)
        ws.update_validator(
            3,
            effective_balance=jspec.MAX_EFFECTIVE_BALANCE,
            activation_eligibility_epoch=constants.FAR_FUTURE_EPOCH,
            activation_epoch=constants.FAR_FUTURE_EPOCH,
        )
        ws.update_validator(
            4, activation_eligibility_epoch=0, activation_epoch=constants.FAR_FUTURE_EPOCH
        )
        ws.balances[5] = 15 * 10**9
        ws.balances[6] = 40 * 10**9
        ws.update_validator(6, effective_balance=31 * 10**9)
        for i in range(8):
            ws.inactivity_scores[i] = 7 + i
            ws.previous_epoch_participation[i + 8] = 7

    staged = _staged(jax_genesis, jspec, monkeypatch, stage)
    got, _ = _assert_walks_agree(
        staged, 2 * jspec.SLOTS_PER_EPOCH + 1, specs, monkeypatch, expect_sweeps=2
    )
    assert got.validators[2].exit_epoch != constants.FAR_FUTURE_EPOCH
    assert got.validators[3].activation_eligibility_epoch != constants.FAR_FUTURE_EPOCH
    assert got.validators[5].effective_balance == 15 * 10**9
    assert got.balances[1] < staged.balances[1]


def test_inactivity_leak_walk(jax_genesis, specs, monkeypatch):
    """Seven empty epochs: finality stalls, the leak engages, scores grow and
    the score-scaled penalties drain balances, identically on every route."""
    jspec, _ = specs
    got, _ = _assert_walks_agree(
        jax_genesis, 7 * jspec.SLOTS_PER_EPOCH + 1, specs, monkeypatch, expect_sweeps=7
    )
    assert max(got.inactivity_scores) > 0
    assert sum(got.balances) < sum(jax_genesis.balances)


@pytest.mark.parametrize("field,value", [
    ("inactivity_scores", 1 << 40),  # the score guard, as in the JAX package
    ("inactivity_scores", R._MAX_SCORE),
    ("balances", R._MAX_BAL),  # int64 headroom for the rewards
])
def test_guard_refuses_and_host_path_answers(jax_genesis, specs, monkeypatch, field, value):
    """A value outside the int64 sweep's range routes the whole epoch to the
    host path, counted as a fallback, and the roots stay the JAX
    package's."""
    jspec, pspec = specs

    def stage(ws):
        getattr(ws, field)[0] = value

    staged = _staged(jax_genesis, jspec, monkeypatch, stage)
    target = jspec.SLOTS_PER_EPOCH + 1
    want = _jax_walk(staged, target, jspec, monkeypatch)
    ported = convert.state_from_ssz(staged.encode(jspec), pspec)
    got = _port_walk(ported, target, pspec, monkeypatch, resident=True)
    assert got._resident_plane.stats["fallbacks"] == 1
    assert got._resident_plane.stats["sweeps"] == 0
    assert got.hash_tree_root(pspec) == want.hash_tree_root(jspec)


def test_reward_table_guard_refuses(specs):
    _, pspec = specs
    assert R._reward_tables(pspec, 1 << 40, False, 1, [1 << 30] * 3) is None
    assert R._reward_tables(pspec, 1000, False, 100, [50, 60, 70]) is not None


def test_inactivity_factors_are_exact(specs):
    """``efb * score // (bias * quotient) == (efb_incr * mult * score) >>
    shift`` for every increment count and scores up to the guard."""
    for spec in specs:
        mult, shift = R._inactivity_factors(spec)
        inc = spec.EFFECTIVE_BALANCE_INCREMENT
        denom = spec.INACTIVITY_SCORE_BIAS * spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
        for j in range(spec.MAX_EFFECTIVE_BALANCE // inc + 1):
            for score in (0, 1, 3, 1000, R._MAX_SCORE - 1):
                assert j * inc * score // denom == (j * mult * score) >> shift
                assert j * mult * score < 1 << 63


# ------------------------------------------------------------------ bodies


def _cols(**kw):
    return {k: torch.tensor(v, dtype=torch.bool if isinstance(v[0], bool) else torch.int64)
            for k, v in kw.items()}


def _sweep_reference(bal, scores, efb_incr, part, eligible, active, slashed, params, luts):
    """The spec's sequence in Python ints, validator by validator."""
    in_leak, _, bias, recovery, mult, shift = params
    out_b, out_s = [], []
    for b, s, e, p, el, a, sl in zip(bal, scores, efb_incr, part, eligible, active, slashed):
        unsl = a and not sl
        target = unsl and bool(p & 2)
        if el and target:
            s -= min(1, s)
        if el and not target:
            s += bias
        if el and not in_leak:
            s -= min(recovery, s)
        for f in range(3):
            part_f = unsl and bool(p & (1 << f))
            if el and part_f:
                b += luts[f][e]
            if f != constants.TIMELY_HEAD_FLAG_INDEX and el and not part_f:
                b = max(0, b - luts[3 + f][e])
        if el and not target:
            b = max(0, b - ((e * mult * s) >> shift))
        out_b.append(b)
        out_s.append(s)
    return out_b, out_s


@pytest.mark.parametrize("in_leak", [False, True])
def test_sweep_matches_python_ints_at_edges(in_leak):
    """Balances that hit 0 after the source penalty and are then rewarded
    (a single clamp over the summed deltas would differ), scores at the
    guard, a slashed validator, an ineligible one, and max increments."""
    max_incr = 32
    luts = [[j * (f + 3) for j in range(max_incr + 1)] for f in range(3)]
    luts += [[j * 50 for j in range(max_incr + 1)], [j * 90 for j in range(max_incr + 1)]]
    if in_leak:
        luts[:3] = [[0] * (max_incr + 1)] * 3
    bal = [0, 10, 49 * 32, 1, 10**9, 2**61, 5000, 0]
    scores = [0, 1, R._MAX_SCORE - 1, 5, 16, 3, 0, 2]
    efb_incr = [32, 1, 32, 32, 17, 32, 0, 32]
    part = [0, 7, 5, 6, 1, 2, 7, 4]
    eligible = [True, True, True, True, True, True, False, True]
    active = [True, True, True, True, True, True, False, True]
    slashed = [False, False, False, False, True, False, False, False]
    params = (in_leak, True, 4, 16, 1953125, 17)
    want_b, want_s = _sweep_reference(bal, scores, efb_incr, part, eligible, active,
                                      slashed, params, luts)
    c = _cols(bal=bal, scores=scores, efb_incr=efb_incr, part=part, eligible=eligible,
              active=active, slashed=slashed)
    R.sweep(c["bal"], c["scores"], c["efb_incr"], c["part"].to(torch.uint8), c["eligible"],
            c["active"], c["slashed"], params, torch.tensor(luts, dtype=torch.int64))
    assert c["bal"].tolist() == want_b
    assert c["scores"].tolist() == want_s
    assert want_b[0] == 0  # saturated at 0
    if not in_leak:
        # validator 7 hits 0 after the source penalty and keeps its head
        # reward: one clamp over the summed deltas would give 0
        assert want_b[7] == luts[2][32] > 0


def test_sweep_skips_the_genesis_epoch():
    c = _cols(bal=[5, 6], scores=[1, 2], efb_incr=[32, 32], part=[0, 0],
              eligible=[True, True], active=[True, True], slashed=[False, False])
    R.sweep(c["bal"], c["scores"], c["efb_incr"], c["part"].to(torch.uint8), c["eligible"],
            c["active"], c["slashed"], (False, False, 4, 16, 1, 1),
            torch.ones((5, 33), dtype=torch.int64))
    assert c["bal"].tolist() == [5, 6] and c["scores"].tolist() == [1, 2]


def test_epoch_sums_hysteresis_scatter_gather_match_python_ints():
    rng = np.random.default_rng(3)
    n = 257
    efb = rng.integers(0, 33, n)
    pp = rng.integers(0, 8, n)
    pc = rng.integers(0, 8, n)
    ap, ac, sl = (rng.random(n) < q for q in (0.9, 0.9, 0.05))

    def t(a, d=torch.int64):
        return torch.from_numpy(np.asarray(a)).to(d)

    got = R.epoch_sums(t(efb), t(pp, torch.uint8), t(pc, torch.uint8),
                       t(ap, torch.bool), t(ac, torch.bool), t(sl, torch.bool)).tolist()
    want = [
        sum(int(e) for e, a in zip(efb, ac) if a),
        *[sum(int(e) for e, p, a, s in zip(efb, pp, ap, sl) if a and not s and p & (1 << f))
          for f in range(3)],
        sum(int(e) for e, p, a, s in zip(efb, pc, ac, sl) if a and not s and p & 2),
    ]
    assert got == want

    inc, down, up = 10**9, 25 * 10**7, 125 * 10**7
    bal = rng.integers(0, 40 * inc, n)
    bal[:4] = [32 * inc - down, 32 * inc - down - 1, 31 * inc + up, 31 * inc + up + 1]
    efb[:4] = [32, 32, 31, 31]
    mask = R.hysteresis(t(bal), t(efb), down, up, inc).tolist()
    assert mask == [int(b) + down < int(e) * inc or int(e) * inc + up < int(b)
                    for b, e in zip(bal, efb)]
    assert mask[:4] == [False, True, False, True]

    col = t(bal)
    idx = t([3, 0, 200])
    R.scatter(col, idx, t([7, 8, 9]))
    assert R.gather(col, idx).tolist() == [7, 8, 9]
    assert col[1].item() == int(bal[1])


def test_routing_polarity(monkeypatch):
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")
    assert not R.resident_enabled(1 << 20)
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "1")
    assert R.resident_enabled(4)
    monkeypatch.delenv("GRAFT_RESIDENT_EPOCH")
    assert not R.resident_enabled(64)
    assert R.resident_enabled(1 << 20)


def test_entry_points_raise_without_a_card(jax_genesis, specs, monkeypatch):
    """``device=None`` means the card: with none, the entry points raise
    instead of carrying on on the CPU."""
    jspec, pspec = specs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ported = convert.state_from_ssz(jax_genesis.encode(jspec), pspec)
    with use_chain_spec(pspec):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            R.ensure_plane(BeaconStateMut(ported), pspec)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            process_slots(ported, 1, pspec)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            R.ResidentEpochPlane(N)


@pytest.mark.cuda
def test_plane_on_card_matches_cpu(jax_genesis, specs, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the plane on the card")
    jspec, pspec = specs
    ported = convert.state_from_ssz(jax_genesis.encode(jspec), pspec)
    target = 3 * pspec.SLOTS_PER_EPOCH + 1
    cpu = _port_walk(ported, target, pspec, monkeypatch, resident=True)
    with _resident(monkeypatch, True), use_chain_spec(pspec):
        card = process_slots(ported, target, pspec, device="cuda")
    assert card._resident_plane.device.type == "cuda"
    assert card._resident_plane.stats["fallbacks"] == 0
    assert card.hash_tree_root(pspec) == cpu.hash_tree_root(pspec)
