"""Beacon-chain containers, capella fork (ref: lib/ssz_types/beacon_chain/*.ex).

One config-late-bound definition per container: list limits and vector lengths
name ChainSpec constants, so the same classes serve mainnet and minimal
presets (where the reference mirrors every container twice through Rust
type-level configs — native/ssz_nif/src/elx_types/beacon_chain.rs).

Field order follows the consensus spec exactly — it defines both the
serialization layout and the Merkle tree shape.
"""

from ..ssz import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Vector,
    boolean,
    uint64,
    uint256,
)
from .base import (
    BLSPubkey,
    BLSSignature,
    Bytes32,
    CommitteeIndex,
    Epoch,
    ExecutionAddress,
    Gwei,
    Hash32,
    ParticipationFlags,
    Root,
    Slot,
    Transaction,
    ValidatorIndex,
    Version,
    WithdrawalIndex,
)


class Fork(Container):
    previous_version: Version
    current_version: Version
    epoch: Epoch


class ForkData(Container):
    current_version: Version
    genesis_validators_root: Root


class Checkpoint(Container):
    epoch: Epoch
    root: Root


class Validator(Container):
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    effective_balance: Gwei
    slashed: boolean
    activation_eligibility_epoch: Epoch
    activation_epoch: Epoch
    exit_epoch: Epoch
    withdrawable_epoch: Epoch


class AttestationData(Container):
    slot: Slot
    index: CommitteeIndex
    beacon_block_root: Root
    source: Checkpoint
    target: Checkpoint


class IndexedAttestation(Container):
    attesting_indices: List(ValidatorIndex, "MAX_VALIDATORS_PER_COMMITTEE")
    data: AttestationData
    signature: BLSSignature


class PendingAttestation(Container):
    aggregation_bits: Bitlist("MAX_VALIDATORS_PER_COMMITTEE")
    data: AttestationData
    inclusion_delay: Slot
    proposer_index: ValidatorIndex


class Eth1Data(Container):
    deposit_root: Root
    deposit_count: uint64
    block_hash: Hash32


class HistoricalBatch(Container):
    block_roots: Vector(Root, "SLOTS_PER_HISTORICAL_ROOT")
    state_roots: Vector(Root, "SLOTS_PER_HISTORICAL_ROOT")


class HistoricalSummary(Container):
    block_summary_root: Root
    state_summary_root: Root


class DepositMessage(Container):
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    amount: Gwei


class DepositData(Container):
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    amount: Gwei
    signature: BLSSignature


class Deposit(Container):
    proof: Vector(Bytes32, 33)  # DEPOSIT_CONTRACT_TREE_DEPTH + 1
    data: DepositData


class BeaconBlockHeader(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body_root: Root


class SignedBeaconBlockHeader(Container):
    message: BeaconBlockHeader
    signature: BLSSignature


class SigningData(Container):
    object_root: Root
    domain: Bytes32


class ProposerSlashing(Container):
    signed_header_1: SignedBeaconBlockHeader
    signed_header_2: SignedBeaconBlockHeader


class AttesterSlashing(Container):
    attestation_1: IndexedAttestation
    attestation_2: IndexedAttestation


class Attestation(Container):
    aggregation_bits: Bitlist("MAX_VALIDATORS_PER_COMMITTEE")
    data: AttestationData
    signature: BLSSignature


class VoluntaryExit(Container):
    epoch: Epoch
    validator_index: ValidatorIndex


class SignedVoluntaryExit(Container):
    message: VoluntaryExit
    signature: BLSSignature


class SyncAggregate(Container):
    sync_committee_bits: Bitvector("SYNC_COMMITTEE_SIZE")
    sync_committee_signature: BLSSignature


class SyncCommittee(Container):
    pubkeys: Vector(BLSPubkey, "SYNC_COMMITTEE_SIZE")
    aggregate_pubkey: BLSPubkey


class Withdrawal(Container):
    index: WithdrawalIndex
    validator_index: ValidatorIndex
    address: ExecutionAddress
    amount: Gwei


class BLSToExecutionChange(Container):
    validator_index: ValidatorIndex
    from_bls_pubkey: BLSPubkey
    to_execution_address: ExecutionAddress


class SignedBLSToExecutionChange(Container):
    message: BLSToExecutionChange
    signature: BLSSignature


class ExecutionPayload(Container):
    parent_hash: Hash32
    fee_recipient: ExecutionAddress
    state_root: Bytes32
    receipts_root: Bytes32
    logs_bloom: ByteVector("BYTES_PER_LOGS_BLOOM")
    prev_randao: Bytes32
    block_number: uint64
    gas_limit: uint64
    gas_used: uint64
    timestamp: uint64
    extra_data: ByteList("MAX_EXTRA_DATA_BYTES")
    base_fee_per_gas: uint256
    block_hash: Hash32
    transactions: List(Transaction, "MAX_TRANSACTIONS_PER_PAYLOAD")
    withdrawals: List(Withdrawal, "MAX_WITHDRAWALS_PER_PAYLOAD")


class ExecutionPayloadHeader(Container):
    parent_hash: Hash32
    fee_recipient: ExecutionAddress
    state_root: Bytes32
    receipts_root: Bytes32
    logs_bloom: ByteVector("BYTES_PER_LOGS_BLOOM")
    prev_randao: Bytes32
    block_number: uint64
    gas_limit: uint64
    gas_used: uint64
    timestamp: uint64
    extra_data: ByteList("MAX_EXTRA_DATA_BYTES")
    base_fee_per_gas: uint256
    block_hash: Hash32
    transactions_root: Root
    withdrawals_root: Root


class BeaconBlockBody(Container):
    randao_reveal: BLSSignature
    eth1_data: Eth1Data
    graffiti: Bytes32
    proposer_slashings: List(ProposerSlashing, "MAX_PROPOSER_SLASHINGS")
    attester_slashings: List(AttesterSlashing, "MAX_ATTESTER_SLASHINGS")
    attestations: List(Attestation, "MAX_ATTESTATIONS")
    deposits: List(Deposit, "MAX_DEPOSITS")
    voluntary_exits: List(SignedVoluntaryExit, "MAX_VOLUNTARY_EXITS")
    sync_aggregate: SyncAggregate
    execution_payload: ExecutionPayload
    bls_to_execution_changes: List(SignedBLSToExecutionChange, "MAX_BLS_TO_EXECUTION_CHANGES")


class BeaconBlock(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body: BeaconBlockBody


class SignedBeaconBlock(Container):
    message: BeaconBlock
    signature: BLSSignature


class BeaconState(Container):
    # Versioning
    genesis_time: uint64
    genesis_validators_root: Root
    slot: Slot
    fork: Fork
    # History
    latest_block_header: BeaconBlockHeader
    block_roots: Vector(Root, "SLOTS_PER_HISTORICAL_ROOT")
    state_roots: Vector(Root, "SLOTS_PER_HISTORICAL_ROOT")
    historical_roots: List(Root, "HISTORICAL_ROOTS_LIMIT")
    # Eth1
    eth1_data: Eth1Data
    eth1_data_votes: List(
        Eth1Data, lambda spec: spec.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.SLOTS_PER_EPOCH
    )
    eth1_deposit_index: uint64
    # Registry
    validators: List(Validator, "VALIDATOR_REGISTRY_LIMIT")
    balances: List(Gwei, "VALIDATOR_REGISTRY_LIMIT")
    # Randomness
    randao_mixes: Vector(Bytes32, "EPOCHS_PER_HISTORICAL_VECTOR")
    # Slashings
    slashings: Vector(Gwei, "EPOCHS_PER_SLASHINGS_VECTOR")
    # Participation
    previous_epoch_participation: List(ParticipationFlags, "VALIDATOR_REGISTRY_LIMIT")
    current_epoch_participation: List(ParticipationFlags, "VALIDATOR_REGISTRY_LIMIT")
    # Finality
    justification_bits: Bitvector(4)  # JUSTIFICATION_BITS_LENGTH
    previous_justified_checkpoint: Checkpoint
    current_justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint
    # Inactivity
    inactivity_scores: List(uint64, "VALIDATOR_REGISTRY_LIMIT")
    # Sync
    current_sync_committee: SyncCommittee
    next_sync_committee: SyncCommittee
    # Execution
    latest_execution_payload_header: ExecutionPayloadHeader
    # Withdrawals
    next_withdrawal_index: WithdrawalIndex
    next_withdrawal_validator_index: ValidatorIndex
    # Deep history (capella)
    historical_summaries: List(HistoricalSummary, "HISTORICAL_ROOTS_LIMIT")


class Eth1Block(Container):
    timestamp: uint64
    deposit_root: Root
    deposit_count: uint64
