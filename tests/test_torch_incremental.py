"""The port's incremental state root against the plain ``hash_tree_root``
and the JAX package's root.

Every mutation class the slot and epoch transitions perform is replayed
through one ``IncrementalStateRoot`` and pinned against the full rehash of
the same state, in the pattern of the JAX package's
``tests/unit/test_incremental.py``; the state starts from a JAX-built
genesis carried across as SSZ bytes, and its root is also held against the
JAX package's.  The engine's dirty-path updates go level by level through
the hash backend, so the mutations run twice: through hashlib, and through
the port's device backend on the CPU with its thresholds at 0 (every level
through ``sha256_nodes``'s plain version).  Tolerance: none, roots are
exact.
"""

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto.bls import curve as JC
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.ops.sha256 import DeviceHashBackend
from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend
from lambda_ethereum_consensus_tpu_torch.ssz import incremental as inc
from lambda_ethereum_consensus_tpu_torch.ssz.core import SSZError
from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
from lambda_ethereum_consensus_tpu_torch.types import BeaconState, Checkpoint, Validator

N = 64


@pytest.fixture(scope="module")
def specs():
    return jax_minimal_spec(), minimal_spec()


@pytest.fixture(scope="module")
def jax_genesis(specs):
    jspec, _ = specs
    with jax_use_chain_spec(jspec):
        base = [JC.g1_to_bytes(JC.g1.multiply_raw(JC.G1_GENERATOR, 3 + i)) for i in range(8)]
        return jax_build_genesis_state([base[i % 8] for i in range(N)], spec=jspec)


@pytest.fixture()
def state(specs, jax_genesis):
    jspec, pspec = specs
    return convert.state_from_ssz(jax_genesis.encode(jspec), pspec)


def _backends():
    return {
        "hashlib": lambda: HashlibBackend(),
        "device-plain": lambda: DeviceHashBackend(device="cpu", threshold=0, tree_threshold=0),
    }


@pytest.fixture(params=sorted(_backends()))
def backend(request):
    return _backends()[request.param]()


def _check(eng, ws, spec):
    assert eng.root(ws, spec) == ws.freeze().hash_tree_root(spec, backend=HashlibBackend())


def test_genesis_root_matches_jax(state, specs, jax_genesis):
    jspec, pspec = specs
    eng = inc.IncrementalStateRoot(BeaconState)
    assert eng.root(BeaconStateMut(state), pspec) == jax_genesis.hash_tree_root(jspec)


def test_incremental_matches_oracle_through_mutations(state, specs, backend):
    _, spec = specs
    with use_chain_spec(spec):
        eng = inc.IncrementalStateRoot(BeaconState, backend)
        ws = BeaconStateMut(state)
        _check(eng, ws, spec)
        _check(eng, ws, spec)  # no change: cache hit

        ws.state_roots[3] = b"\x11" * 32  # history rows (process_slot)
        ws.block_roots[5] = b"\x22" * 32
        _check(eng, ws, spec)

        ws.update_validator(7, effective_balance=17 * 10**9)  # operations
        ws.balances[7] = 17 * 10**9 + 12345
        _check(eng, ws, spec)

        ws.set_balances([b + 7 for b in ws.balances])  # epoch sweep: rebuild
        _check(eng, ws, spec)

        ws.previous_epoch_participation = [p | 1 for p in ws.previous_epoch_participation]
        ws.inactivity_scores[0] = 4
        _check(eng, ws, spec)

        v = ws.validators[0].copy(withdrawal_credentials=b"\x01" + b"\x00" * 31)
        assert isinstance(v, Validator)
        ws.append_validator(v, 32 * 10**9)  # deposit: element count changes
        _check(eng, ws, spec)

        ws.randao_mixes[2] = b"\x33" * 32
        _check(eng, ws, spec)

        ws.slot = ws.slot + 5
        ws.finalized_checkpoint = Checkpoint(epoch=1, root=b"\x44" * 32)
        _check(eng, ws, spec)

        # many scattered point writes: dirty paths of several leaves per level
        for i in range(0, N, 5):
            ws.balances[i] += i
            ws.current_epoch_participation[i] |= 2
        ws.update_validator(N - 1, slashed=True)
        _check(eng, ws, spec)


def test_incremental_rejects_out_of_range(state, specs):
    _, spec = specs
    eng = inc.IncrementalStateRoot(BeaconState)
    ws = BeaconStateMut(state)
    eng.root(ws, spec)
    ws.balances[0] = 1 << 64
    with pytest.raises(SSZError):
        eng.root(ws, spec)


def test_pushed_deltas_survive_branched_lineage(state, specs, backend):
    """Two divergent copies of one state rooted alternately through one
    engine: the chain refuses the branch it didn't stamp and diffs."""
    _, spec = specs
    eng = inc.IncrementalStateRoot(BeaconState, backend)
    ws_a = BeaconStateMut(state)
    ws_a.balances[3] = 77 * 10**7
    _check(eng, ws_a, spec)
    ws_b = BeaconStateMut(state)
    ws_b.balances[5] = 55 * 10**7
    ws_b.update_validator(9, effective_balance=9 * 10**9)
    _check(eng, ws_b, spec)
    ws_a.balances[7] += 1
    _check(eng, ws_a, spec)


def test_copied_engine_roots_a_second_lineage(state, specs, backend, monkeypatch):
    """A copy of an engine that rooted a parent roots a second child of that
    parent by its pushed deltas (no field rebuilt: the one ``_build_levels``
    is the container's own) while the original roots the first; the updates
    of neither reach the other."""
    _, spec = specs
    builds = []
    real = inc._build_levels
    monkeypatch.setattr(inc, "_build_levels", lambda *a: builds.append(1) or real(*a))
    eng = inc.IncrementalStateRoot(BeaconState, backend)
    parent = BeaconStateMut(state)
    parent.balances[1] = 11 * 10**9
    _check(eng, parent, spec)
    parent = parent.freeze()
    twin = eng.copy()
    # the second child thaws a frozen copy of the parent, as an import on a
    # fork of it does
    ws_a, ws_b = BeaconStateMut(parent), BeaconStateMut(BeaconStateMut(parent).freeze())
    ws_a.balances[3] = 77 * 10**7
    ws_a.update_validator(2, slashed=True)
    ws_b.balances[5] = 55 * 10**7
    ws_b.block_roots[4] = b"\x66" * 32
    _check(eng, ws_a, spec)
    builds.clear()
    _check(twin, ws_b, spec)
    assert len(builds) == 1
    assert twin.field_levels("balances")[0] is not eng.field_levels("balances")[0]
    _check(twin.copy(), BeaconStateMut(ws_b.freeze()), spec)
    _check(eng, ws_a, spec)


def test_structural_mutations_degrade_safely(state, specs):
    _, spec = specs
    eng = inc.IncrementalStateRoot(BeaconState)
    ws = BeaconStateMut(state)
    eng.root(ws, spec)
    ws.balances[0:4] = [1, 2, 3, 4]  # slice: structural
    _check(eng, ws, spec)
    ws.inactivity_scores = [11] * len(ws.validators)  # replacement
    _check(eng, ws, spec)
    ws.balances.reverse()  # structural in the port's TrackedList
    _check(eng, ws, spec)
    ws.balances[2] = 999
    _check(eng, ws, spec)


def test_participation_rotation_is_structural(state, specs):
    from lambda_ethereum_consensus_tpu_torch.state_transition.epoch import (
        process_participation_flag_updates,
    )

    _, spec = specs
    eng = inc.IncrementalStateRoot(BeaconState)
    ws = BeaconStateMut(state)
    ws._root_engine = eng
    for i in range(0, len(ws.validators), 3):
        ws.current_epoch_participation[i] = 7
    eng.root(ws, spec)
    process_participation_flag_updates(ws, spec)
    _check(eng, ws, spec)
    ws.current_epoch_participation[1] = 3
    ws.previous_epoch_participation[2] |= 4
    _check(eng, ws, spec)


def test_rotation_without_movable_cache_falls_back(state, specs):
    _, spec = specs
    eng = inc.IncrementalStateRoot(BeaconState)
    assert eng.rotate_participation([0] * len(state.validators)) is False
    _check(eng, BeaconStateMut(state), spec)


def test_update_paths_batches_each_level_through_the_backend():
    """One backend call per level, each with that level's dirty parents."""
    calls = []

    class Recording(HashlibBackend):
        def hash_level(self, blocks):
            calls.append(blocks.shape[0])
            return super().hash_level(blocks)

    rng = np.random.default_rng(1)
    chunks = rng.integers(0, 256, (37, 32), dtype=np.uint8)
    levels = inc._build_levels(chunks.copy(), HashlibBackend())
    chunks[[0, 5, 36]] ^= 1
    want = inc._build_levels(chunks.copy(), HashlibBackend())
    levels[0][[0, 5, 36]] = chunks[[0, 5, 36]]
    inc._update_paths(levels, np.array([0, 5, 36]), Recording())
    assert calls == [3, 3, 2, 2, 2, 1]
    for got, exp in zip(levels, want):
        assert np.array_equal(got, exp)
