"""Genesis / anchor state construction (capella).

The reference only ever obtains states via checkpoint sync or its DB (ref:
lib/.../fork_choice/supervisor.ex:16-44); a from-scratch framework also needs
to *mint* a valid state — for devnets, spec tests and unit fixtures.  This
builds a capella genesis state directly (the condensed equivalent of phase0
``initialize_beacon_state_from_eth1`` + the altair/bellatrix/capella upgrade
functions applied at genesis).
"""

from __future__ import annotations

from ..config import ChainSpec, constants, get_chain_spec
from ..types.beacon import (
    BeaconBlockBody,
    BeaconBlockHeader,
    BeaconState,
    Eth1Data,
    ExecutionPayloadHeader,
    Fork,
    Validator,
)
from . import accessors
from .mutable import BeaconStateMut


def genesis_validator(pubkey: bytes, balance: int, spec: ChainSpec) -> Validator:
    effective = min(
        balance - balance % spec.EFFECTIVE_BALANCE_INCREMENT,
        spec.MAX_EFFECTIVE_BALANCE,
    )
    return Validator(
        pubkey=pubkey,
        # eth1-style credentials so withdrawals are exercisable
        withdrawal_credentials=constants.ETH1_ADDRESS_WITHDRAWAL_PREFIX
        + b"\x00" * 11
        + pubkey[:20],
        effective_balance=effective,
        slashed=False,
        activation_eligibility_epoch=constants.GENESIS_EPOCH,
        activation_epoch=constants.GENESIS_EPOCH,
        exit_epoch=constants.FAR_FUTURE_EPOCH,
        withdrawable_epoch=constants.FAR_FUTURE_EPOCH,
    )


def build_genesis_state(
    pubkeys: list[bytes],
    balances: list[int] | None = None,
    genesis_time: int = 0,
    eth1_block_hash: bytes = b"\x42" * 32,
    spec: ChainSpec | None = None,
) -> BeaconState:
    """A fully valid capella genesis state for the given validator set."""
    spec = spec or get_chain_spec()
    n = len(pubkeys)
    if balances is None:
        balances = [spec.MAX_EFFECTIVE_BALANCE] * n
    version = spec.CAPELLA_FORK_VERSION
    validators = [
        genesis_validator(pk, bal, spec) for pk, bal in zip(pubkeys, balances)
    ]

    payload_header = ExecutionPayloadHeader(
        block_hash=eth1_block_hash,
        timestamp=genesis_time,
        prev_randao=eth1_block_hash,
    )
    state = BeaconState(
        genesis_time=genesis_time,
        genesis_validators_root=b"\x00" * 32,  # filled below
        slot=constants.GENESIS_SLOT,
        fork=Fork(
            previous_version=version, current_version=version, epoch=constants.GENESIS_EPOCH
        ),
        latest_block_header=BeaconBlockHeader(
            body_root=BeaconBlockBody().hash_tree_root(spec)
        ),
        eth1_data=Eth1Data(
            deposit_root=b"\x00" * 32, deposit_count=n, block_hash=eth1_block_hash
        ),
        eth1_deposit_index=n,
        validators=validators,
        balances=list(balances),
        randao_mixes=[eth1_block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
        previous_epoch_participation=[0] * n,
        current_epoch_participation=[0] * n,
        inactivity_scores=[0] * n,
        latest_execution_payload_header=payload_header,
    )

    # genesis_validators_root = root of the registry list
    registry_root = BeaconState.fields()["validators"].hash_tree_root(
        validators, spec
    )
    ws = BeaconStateMut(state)
    ws.genesis_validators_root = registry_root

    # genesis sync committees: current and next are the same epoch-1 sample
    committee = accessors.get_next_sync_committee(ws, spec)
    ws.current_sync_committee = committee
    ws.next_sync_committee = committee
    return ws.freeze()
