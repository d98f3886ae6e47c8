"""Spec state mutators (ref: lib/.../state_transition/mutators.ex:15-163).

All operate on a :class:`~.mutable.BeaconStateMut`.
"""

from __future__ import annotations

from ..config import ChainSpec, constants, get_chain_spec
from . import accessors, misc
from .mutable import BeaconStateMut


def increase_balance(state: BeaconStateMut, index: int, delta: int) -> None:
    state.balances[index] += delta


def decrease_balance(state: BeaconStateMut, index: int, delta: int) -> None:
    state.balances[index] = max(0, state.balances[index] - delta)


def initiate_validator_exit(
    state: BeaconStateMut, index: int, spec: ChainSpec | None = None
) -> None:
    """Queue an exit behind the churn limit (ref: mutators.ex:36-94)."""
    spec = spec or get_chain_spec()
    validator = state.validators[index]
    if validator.exit_epoch != constants.FAR_FUTURE_EPOCH:
        return
    reg = state.registry()
    exit_epochs = reg["exit_epoch"][reg["exit_epoch"] != constants.FAR_FUTURE_EPOCH]
    exit_queue_epoch = max(
        int(exit_epochs.max()) if exit_epochs.size else 0,
        misc.compute_activation_exit_epoch(
            accessors.get_current_epoch(state, spec), spec
        ),
    )
    exit_queue_churn = int((reg["exit_epoch"] == exit_queue_epoch).sum())
    if exit_queue_churn >= accessors.get_validator_churn_limit(state, spec):
        exit_queue_epoch += 1
    state.update_validator(
        index,
        exit_epoch=exit_queue_epoch,
        withdrawable_epoch=exit_queue_epoch + spec.MIN_VALIDATOR_WITHDRAWABILITY_DELAY,
    )


def slash_validator(
    state: BeaconStateMut,
    slashed_index: int,
    whistleblower_index: int | None = None,
    spec: ChainSpec | None = None,
) -> None:
    """Slash + penalize + reward whistleblower/proposer (ref: mutators.ex:96-163);
    capella uses the bellatrix quotients."""
    spec = spec or get_chain_spec()
    epoch = accessors.get_current_epoch(state, spec)
    initiate_validator_exit(state, slashed_index, spec)
    validator = state.validators[slashed_index]
    state.update_validator(
        slashed_index,
        slashed=True,
        withdrawable_epoch=max(
            validator.withdrawable_epoch, epoch + spec.EPOCHS_PER_SLASHINGS_VECTOR
        ),
    )
    eff = state.validators[slashed_index].effective_balance
    state.slashings[epoch % spec.EPOCHS_PER_SLASHINGS_VECTOR] += eff
    decrease_balance(
        state, slashed_index, eff // spec.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX
    )

    proposer_index = accessors.get_beacon_proposer_index(state, spec)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = eff // spec.WHISTLEBLOWER_REWARD_QUOTIENT
    proposer_reward = (
        whistleblower_reward * constants.PROPOSER_WEIGHT // constants.WEIGHT_DENOMINATOR
    )
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)
