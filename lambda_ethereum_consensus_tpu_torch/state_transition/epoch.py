"""Epoch-boundary processing, capella-complete and registry-vectorized.

The port's copy of the JAX package's ``state_transition/epoch.py``; the
host path below is the bit-exact oracle the resident plane is held against.

The reference implements most passes but stubs justification/finalization
(ref: lib/.../state_transition/epoch_processing.ex:346-349); this module
implements the full capella sequence.  Every O(n_validators) pass operates on
numpy registry columns (:class:`~.mutable.BeaconStateMut.registry`) instead of
per-validator loops — rewards, inactivity, effective-balance hysteresis and
slashing penalties are single array expressions, the shape a device backend
consumes directly.
"""

from __future__ import annotations

import numpy as np

from ..config import ChainSpec, constants, get_chain_spec
from ..telemetry import span
from ..types.beacon import Checkpoint, HistoricalSummary
from . import accessors, misc
from .math import integer_squareroot
from .mutable import BeaconStateMut, TrackedList
from .mutators import initiate_validator_exit
from .predicates import is_eligible_for_activation


def process_epoch(state: BeaconStateMut, spec: ChainSpec | None = None) -> None:
    """One epoch boundary.  When a resident plane rides the lineage
    (state_transition/resident), the O(n) sweeps run as torch ops on its
    columns on the device; any representability guard failing falls back
    to the bit-exact host path below — same results either way, pinned by
    tests/test_torch_resident.py.  A device error raises.  Either path is
    timed by the ``epoch_transition`` span."""
    spec = spec or get_chain_spec()
    with span("epoch_transition"):
        plane = getattr(state, "_resident_plane", None)
        if plane is not None:
            from .resident import process_epoch_resident

            if process_epoch_resident(state, plane, spec):
                return
        _process_epoch_host(state, spec)


def _process_epoch_host(state: BeaconStateMut, spec: ChainSpec) -> None:
    process_justification_and_finalization(state, spec)
    process_inactivity_updates(state, spec)
    process_rewards_and_penalties(state, spec)
    process_registry_updates(state, spec)
    process_slashings(state, spec)
    process_eth1_data_reset(state, spec)
    process_effective_balance_updates(state, spec)
    process_slashings_reset(state, spec)
    process_randao_mixes_reset(state, spec)
    process_historical_summaries_update(state, spec)
    process_participation_flag_updates(state, spec)
    process_sync_committee_updates(state, spec)


# ----------------------------------------------- eligibility / participation

def _eligible_mask(state: BeaconStateMut, spec: ChainSpec) -> np.ndarray:
    """Validators receiving rewards/penalties for the previous epoch."""
    prev = accessors.get_previous_epoch(state, spec)
    reg = state.registry()
    active_prev = (reg["activation_epoch"] <= prev) & (prev < reg["exit_epoch"])
    return active_prev | (reg["slashed"] & (prev + 1 < reg["withdrawable_epoch"]))


def get_eligible_validator_indices(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> np.ndarray:
    spec = spec or get_chain_spec()
    return np.nonzero(_eligible_mask(state, spec))[0]


def _unslashed_participating_mask(
    state: BeaconStateMut, flag_index: int, epoch: int, spec: ChainSpec
) -> np.ndarray:
    reg = state.registry()
    which = "current" if epoch == accessors.get_current_epoch(state, spec) else "previous"
    participation = state.participation_array(which)
    active = (reg["activation_epoch"] <= epoch) & (epoch < reg["exit_epoch"])
    return active & ~reg["slashed"] & ((participation & (1 << flag_index)) != 0)


# ------------------------------------------ justification and finalization

def process_justification_and_finalization(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    spec = spec or get_chain_spec()
    if accessors.get_current_epoch(state, spec) <= constants.GENESIS_EPOCH + 1:
        return
    reg = state.registry()
    prev_epoch = accessors.get_previous_epoch(state, spec)
    curr_epoch = accessors.get_current_epoch(state, spec)
    ebs = reg["effective_balance"]
    prev_mask = _unslashed_participating_mask(
        state, constants.TIMELY_TARGET_FLAG_INDEX, prev_epoch, spec
    )
    curr_mask = _unslashed_participating_mask(
        state, constants.TIMELY_TARGET_FLAG_INDEX, curr_epoch, spec
    )
    total = accessors.get_total_active_balance(state, spec)
    prev_target = max(spec.EFFECTIVE_BALANCE_INCREMENT, int(ebs[prev_mask].sum()))
    curr_target = max(spec.EFFECTIVE_BALANCE_INCREMENT, int(ebs[curr_mask].sum()))
    weigh_justification_and_finalization(state, total, prev_target, curr_target, spec)


def weigh_justification_and_finalization(
    state: BeaconStateMut,
    total_active_balance: int,
    previous_epoch_target_balance: int,
    current_epoch_target_balance: int,
    spec: ChainSpec | None = None,
) -> None:
    spec = spec or get_chain_spec()
    previous_epoch = accessors.get_previous_epoch(state, spec)
    current_epoch = accessors.get_current_epoch(state, spec)
    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = state.justification_bits.shift_higher(1)
    if previous_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=previous_epoch,
            root=accessors.get_block_root(state, previous_epoch, spec),
        )
        bits = bits.set(1)
    if current_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=current_epoch,
            root=accessors.get_block_root(state, current_epoch, spec),
        )
        bits = bits.set(0)
    state.justification_bits = bits

    # finalization: 2nd/3rd/4th most recent epochs justified as source
    if bits.all_set_range(1, 4) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if bits.all_set_range(1, 3) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if bits.all_set_range(0, 3) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if bits.all_set_range(0, 2) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


# ------------------------------------------------------ inactivity updates

def process_inactivity_updates(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    spec = spec or get_chain_spec()
    if accessors.get_current_epoch(state, spec) == constants.GENESIS_EPOCH:
        return
    prev = accessors.get_previous_epoch(state, spec)
    eligible = _eligible_mask(state, spec)
    participating = _unslashed_participating_mask(
        state, constants.TIMELY_TARGET_FLAG_INDEX, prev, spec
    )
    scores = np.asarray(state.inactivity_scores, dtype=np.uint64).astype(np.int64)
    # participating: score -= min(1, score); else: score += bias
    scores = np.where(
        eligible & participating,
        scores - np.minimum(1, scores),
        scores,
    )
    scores = np.where(
        eligible & ~participating, scores + spec.INACTIVITY_SCORE_BIAS, scores
    )
    if not accessors.is_in_inactivity_leak(state, spec):
        scores = np.where(
            eligible,
            scores - np.minimum(spec.INACTIVITY_SCORE_RECOVERY_RATE, scores),
            scores,
        )
    state.inactivity_scores = [int(s) for s in scores]


# -------------------------------------------------- rewards and penalties

def process_rewards_and_penalties(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    spec = spec or get_chain_spec()
    if accessors.get_current_epoch(state, spec) == constants.GENESIS_EPOCH:
        return
    reg = state.registry()

    prev = accessors.get_previous_epoch(state, spec)
    eligible = _eligible_mask(state, spec)
    total_active = accessors.get_total_active_balance(state, spec)
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    active_increments = total_active // increment
    base_reward_per_increment = (
        increment * spec.BASE_REWARD_FACTOR // integer_squareroot(total_active)
    )
    base_rewards = (
        reg["effective_balance"].astype(np.int64) // increment
    ) * base_reward_per_increment
    in_leak = accessors.is_in_inactivity_leak(state, spec)

    # Spec applies each (rewards, penalties) delta pair sequentially with
    # decrease_balance saturating at zero *per pair* — netting everything and
    # flooring once diverges for near-zero balances, so keep one vector
    # increase+saturating-decrease per pair.
    balances = state.balances_array().astype(np.int64)

    def apply(rewards: np.ndarray, penalties: np.ndarray) -> None:
        nonlocal balances
        balances = np.maximum(0, balances + rewards - penalties)

    for flag_index, weight in enumerate(constants.PARTICIPATION_FLAG_WEIGHTS):
        participating = _unslashed_participating_mask(state, flag_index, prev, spec)
        participating_balance = int(reg["effective_balance"][participating].sum())
        participating_increments = (
            max(spec.EFFECTIVE_BALANCE_INCREMENT, participating_balance) // increment
        )
        rewards = np.zeros_like(balances)
        penalties = np.zeros_like(balances)
        if not in_leak:
            flag_rewards = (
                base_rewards
                * weight
                * participating_increments
                // (active_increments * constants.WEIGHT_DENOMINATOR)
            )
            rewards = np.where(eligible & participating, flag_rewards, 0)
        if flag_index != constants.TIMELY_HEAD_FLAG_INDEX:
            penalties = np.where(
                eligible & ~participating,
                base_rewards * weight // constants.WEIGHT_DENOMINATOR,
                0,
            )
        apply(rewards, penalties)

    # inactivity penalties (target non-participants pay score-scaled penalty)
    target_participating = _unslashed_participating_mask(
        state, constants.TIMELY_TARGET_FLAG_INDEX, prev, spec
    )
    scores = np.asarray(state.inactivity_scores, dtype=np.uint64).astype(np.int64)
    denom = spec.INACTIVITY_SCORE_BIAS * spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    inactivity_penalties = np.where(
        eligible & ~target_participating,
        reg["effective_balance"].astype(np.int64) * scores // denom,
        0,
    )
    apply(np.zeros_like(balances), inactivity_penalties)

    state.set_balances(balances.astype(np.uint64))


# ------------------------------------------------------- registry updates

def process_registry_updates(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    spec = spec or get_chain_spec()
    current_epoch = accessors.get_current_epoch(state, spec)
    reg = state.registry()

    # activation eligibility
    eligibility = np.nonzero(
        (reg["activation_eligibility_epoch"] == constants.FAR_FUTURE_EPOCH)
        & (reg["effective_balance"] == spec.MAX_EFFECTIVE_BALANCE)
    )[0]
    for i in eligibility:
        state.update_validator(int(i), activation_eligibility_epoch=current_epoch + 1)

    # ejections
    reg = state.registry()
    ejectable = np.nonzero(
        (reg["activation_epoch"] <= current_epoch)
        & (current_epoch < reg["exit_epoch"])
        & (reg["effective_balance"] <= spec.EJECTION_BALANCE)
    )[0]
    for i in ejectable:
        initiate_validator_exit(state, int(i), spec)

    # dequeue activations up to the churn limit
    activation_queue = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if is_eligible_for_activation(state, v)
        ),
        key=lambda i: (state.validators[i].activation_eligibility_epoch, i),
    )
    for i in activation_queue[: accessors.get_validator_churn_limit(state, spec)]:
        state.update_validator(
            i, activation_epoch=misc.compute_activation_exit_epoch(current_epoch, spec)
        )


# ------------------------------------------------------------- slashings

def process_slashings(state: BeaconStateMut, spec: ChainSpec | None = None) -> None:
    spec = spec or get_chain_spec()
    epoch = accessors.get_current_epoch(state, spec)
    total_balance = accessors.get_total_active_balance(state, spec)
    adjusted_total = min(
        sum(state.slashings) * spec.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,
        total_balance,
    )
    reg = state.registry()
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    target = reg["slashed"] & (
        epoch + spec.EPOCHS_PER_SLASHINGS_VECTOR // 2 == reg["withdrawable_epoch"]
    )
    if not target.any():
        return
    ebs = reg["effective_balance"].astype(object)  # python ints: no overflow
    balances = state.balances_array().astype(object)
    for i in np.nonzero(target)[0]:
        penalty_numerator = int(ebs[i]) // increment * adjusted_total
        penalty = penalty_numerator // total_balance * increment
        balances[i] = max(0, int(balances[i]) - penalty)
    state.set_balances(balances)


# ----------------------------------------------------------------- resets

def process_eth1_data_reset(state: BeaconStateMut, spec: ChainSpec | None = None) -> None:
    spec = spec or get_chain_spec()
    next_epoch = accessors.get_current_epoch(state, spec) + 1
    if next_epoch % spec.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    spec = spec or get_chain_spec()
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    hysteresis_increment = increment // spec.HYSTERESIS_QUOTIENT
    downward = hysteresis_increment * spec.HYSTERESIS_DOWNWARD_MULTIPLIER
    upward = hysteresis_increment * spec.HYSTERESIS_UPWARD_MULTIPLIER
    reg = state.registry()
    balances = state.balances_array()
    ebs = reg["effective_balance"]
    needs_update = (balances + downward < ebs) | (ebs + upward < balances)
    for i in np.nonzero(needs_update)[0]:
        b = int(balances[i])
        state.update_validator(
            int(i),
            effective_balance=min(b - b % increment, spec.MAX_EFFECTIVE_BALANCE),
        )


def process_slashings_reset(state: BeaconStateMut, spec: ChainSpec | None = None) -> None:
    spec = spec or get_chain_spec()
    next_epoch = accessors.get_current_epoch(state, spec) + 1
    state.slashings[next_epoch % spec.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    spec = spec or get_chain_spec()
    current_epoch = accessors.get_current_epoch(state, spec)
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % spec.EPOCHS_PER_HISTORICAL_VECTOR] = (
        accessors.get_randao_mix(state, current_epoch, spec)
    )


def process_historical_summaries_update(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    from ..ssz import Vector
    from ..types.base import Root

    spec = spec or get_chain_spec()
    next_epoch = accessors.get_current_epoch(state, spec) + 1
    if next_epoch % (spec.SLOTS_PER_HISTORICAL_ROOT // spec.SLOTS_PER_EPOCH) == 0:
        roots_t = Vector(Root, "SLOTS_PER_HISTORICAL_ROOT")
        state.historical_summaries = state.historical_summaries + [
            HistoricalSummary(
                block_summary_root=roots_t.hash_tree_root(state.block_roots, spec),
                state_summary_root=roots_t.hash_tree_root(state.state_roots, spec),
            )
        ]


def process_participation_flag_updates(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    """Participation rotation as a structural delta: previous aliases
    current's list (its incremental subtree moves with it), and the new
    current gets a claimed zero subtree — the root engine hashes nothing
    at all for either field at the boundary."""
    state.previous_epoch_participation = state.current_epoch_participation
    new_current = TrackedList([0] * len(state.validators))
    engine = getattr(state, "_root_engine", None)
    if engine is not None and hasattr(engine, "rotate_participation"):
        engine.rotate_participation(new_current)
    state.current_epoch_participation = new_current


def process_sync_committee_updates(
    state: BeaconStateMut, spec: ChainSpec | None = None
) -> None:
    spec = spec or get_chain_spec()
    next_epoch = accessors.get_current_epoch(state, spec) + 1
    if next_epoch % spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = accessors.get_next_sync_committee(state, spec)
