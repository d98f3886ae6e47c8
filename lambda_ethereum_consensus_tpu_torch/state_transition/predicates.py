"""Spec predicates (ref: lib/.../state_transition/predicates.ex:16-136)."""

from __future__ import annotations

from ..config import ChainSpec, constants, get_chain_spec
from ..crypto import bls
from ..types.beacon import AttestationData, IndexedAttestation, Validator
from . import misc


def is_active_validator(validator: Validator, epoch: int) -> bool:
    return validator.activation_epoch <= epoch < validator.exit_epoch


def is_eligible_for_activation_queue(
    validator: Validator, spec: ChainSpec | None = None
) -> bool:
    spec = spec or get_chain_spec()
    return (
        validator.activation_eligibility_epoch == constants.FAR_FUTURE_EPOCH
        and validator.effective_balance == spec.MAX_EFFECTIVE_BALANCE
    )


def is_eligible_for_activation(state, validator: Validator) -> bool:
    return (
        validator.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
        and validator.activation_epoch == constants.FAR_FUTURE_EPOCH
    )


def is_slashable_validator(validator: Validator, epoch: int) -> bool:
    return not validator.slashed and (
        validator.activation_epoch <= epoch < validator.withdrawable_epoch
    )


def is_slashable_attestation_data(d1: AttestationData, d2: AttestationData) -> bool:
    """Double vote or surround vote."""
    return (d1 != d2 and d1.target.epoch == d2.target.epoch) or (
        d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    )


def indexed_attestation_signature_inputs(
    state, indexed_attestation: IndexedAttestation, spec: ChainSpec | None = None
) -> tuple[list[bytes], bytes]:
    """Structural validation + ``(pubkeys, signing_root)`` for the signature
    check — shared by the per-item and batched verification paths so the two
    can never drift.  Raises :class:`~.errors.OperationError` on bad indices.
    """
    from .accessors import get_domain  # local import to avoid cycle
    from .errors import OperationError

    spec = spec or get_chain_spec()
    indices = list(indexed_attestation.attesting_indices)
    if not indices or indices != sorted(set(indices)):
        raise OperationError("attesting indices not sorted-unique or empty")
    if any(i >= len(state.validators) for i in indices):
        raise OperationError("attesting index out of range")
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    domain = get_domain(
        state,
        constants.DOMAIN_BEACON_ATTESTER,
        indexed_attestation.data.target.epoch,
        spec,
    )
    signing_root = misc.compute_signing_root(indexed_attestation.data, domain)
    return pubkeys, signing_root


def is_valid_indexed_attestation(
    state, indexed_attestation: IndexedAttestation, spec: ChainSpec | None = None
) -> bool:
    """Sorted-unique index check + aggregate signature check (the BLS hot path
    — ref: predicates.ex:109-136)."""
    from .errors import OperationError

    try:
        pubkeys, signing_root = indexed_attestation_signature_inputs(
            state, indexed_attestation, spec
        )
    except OperationError:
        return False
    return bls.fast_aggregate_verify(
        pubkeys, signing_root, bytes(indexed_attestation.signature)
    )


# ------------------------------------------------------ withdrawal predicates

def has_eth1_withdrawal_credential(validator: Validator) -> bool:
    return bytes(validator.withdrawal_credentials)[:1] == (
        constants.ETH1_ADDRESS_WITHDRAWAL_PREFIX
    )


def is_fully_withdrawable_validator(
    validator: Validator, balance: int, epoch: int
) -> bool:
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator(
    validator: Validator, balance: int, spec: ChainSpec | None = None
) -> bool:
    spec = spec or get_chain_spec()
    max_eb = spec.MAX_EFFECTIVE_BALANCE
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.effective_balance == max_eb
        and balance > max_eb
    )


# ------------------------------------------------------------- merge status

def is_merge_transition_complete(state) -> bool:
    from ..types.beacon import ExecutionPayloadHeader

    return state.latest_execution_payload_header != ExecutionPayloadHeader()
