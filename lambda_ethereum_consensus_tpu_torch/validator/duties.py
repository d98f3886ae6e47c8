"""Block and attestation production.

``build_signed_block`` produces a fully valid signed block on top of a state:
randao reveal, execution payload consistent with the state's payload header,
expected withdrawals, the post-state root (computed by dry-running the
transition) and the proposer signature.  This is the write-side counterpart
of :mod:`..state_transition` and what devnets and integration tests use to
mint chains.

The port's copy of the JAX package's ``validator/duties.py``;
``build_signed_block`` takes the ``device`` its dry-run transition checks
the block's attestations on.
"""

from __future__ import annotations

from typing import Sequence

from ..config import ChainSpec, constants, get_chain_spec
from ..crypto import bls
from ..state_transition import accessors, misc, process_slots
from ..state_transition.mutable import BeaconStateMut
from ..types.beacon import (
    Attestation,
    AttestationData,
    BeaconBlock,
    BeaconBlockBody,
    BeaconState,
    Checkpoint,
    ExecutionPayload,
    SignedBeaconBlock,
    SyncAggregate,
)
from ..types.validator import AggregateAndProof, SignedAggregateAndProof


def sign_block(
    state, block: BeaconBlock, secret_key: bytes, spec: ChainSpec
) -> SignedBeaconBlock:
    domain = accessors.get_domain(state, constants.DOMAIN_BEACON_PROPOSER, spec=spec)
    signature = bls.sign(secret_key, misc.compute_signing_root(block, domain))
    return SignedBeaconBlock(message=block, signature=signature)


def build_signed_block(
    state: BeaconState,
    slot: int,
    secret_keys: Sequence[bytes],
    attestations: Sequence[Attestation] = (),
    proposer_slashings: Sequence["ProposerSlashing"] = (),
    attester_slashings: Sequence["AttesterSlashing"] = (),
    voluntary_exits: Sequence["SignedVoluntaryExit"] = (),
    bls_to_execution_changes: Sequence["SignedBLSToExecutionChange"] = (),
    graffiti: bytes = b"\x00" * 32,
    spec: ChainSpec | None = None,
    sync_secret_keys=None,
    device=None,
) -> tuple[SignedBeaconBlock, BeaconState]:
    """Produce ``(signed_block, post_state)`` for ``slot`` on top of ``state``.

    ``secret_keys[i]`` must be validator ``i``'s key (devnet-style registry).
    ``sync_secret_keys`` (pubkey bytes -> secret key) switches the sync
    aggregate from the empty infinity-point default to a LIVE
    full-participation aggregate over the current sync committee — the
    shape every real mainnet block carries.  The transition runs with its
    device work on ``device`` (default: the card).
    """
    spec = spec or get_chain_spec()
    pre = process_slots(state, slot, spec, device) if state.slot < slot else state
    ws = BeaconStateMut(pre)
    proposer = accessors.get_beacon_proposer_index(ws, spec)
    epoch = accessors.get_current_epoch(ws, spec)

    randao_domain = accessors.get_domain(ws, constants.DOMAIN_RANDAO, epoch, spec)
    randao_reveal = bls.sign(
        secret_keys[proposer], misc.compute_signing_root_epoch(epoch, randao_domain)
    )
    payload = ExecutionPayload(
        parent_hash=bytes(pre.latest_execution_payload_header.block_hash),
        prev_randao=accessors.get_randao_mix(ws, epoch, spec),
        timestamp=misc.compute_timestamp_at_slot(ws, slot, spec),
        block_number=slot,
        block_hash=misc.hash_bytes(
            bytes(pre.latest_execution_payload_header.block_hash) + graffiti
        ),
        withdrawals=accessors.get_expected_withdrawals(ws, spec),
    )
    body = BeaconBlockBody(
        randao_reveal=randao_reveal,
        eth1_data=pre.eth1_data,
        graffiti=graffiti,
        proposer_slashings=list(proposer_slashings),
        attester_slashings=list(attester_slashings),
        attestations=list(attestations),
        voluntary_exits=list(voluntary_exits),
        bls_to_execution_changes=list(bls_to_execution_changes),
        sync_aggregate=(
            make_sync_aggregate(ws, sync_secret_keys, spec)
            if sync_secret_keys is not None
            else SyncAggregate(sync_committee_signature=bls.G2_POINT_AT_INFINITY)
        ),
        execution_payload=payload,
    )
    from ..state_transition.core import state_root

    header = pre.latest_block_header
    if bytes(header.state_root) == b"\x00" * 32:
        header = header.copy(state_root=state_root(pre, spec))
    block = BeaconBlock(
        slot=slot,
        proposer_index=proposer,
        parent_root=header.hash_tree_root(spec),
        state_root=b"\x00" * 32,
        body=body,
    )
    # apply block processing on the already-advanced pre-state (running the
    # full state_transition would redo the slot/epoch advance a second time)
    from ..state_transition.core import process_block

    post_ws = BeaconStateMut(pre)
    process_block(post_ws, block, None, spec, device)
    post = post_ws.freeze()
    block = block.copy(state_root=state_root(post, spec))
    signed = sign_block(ws, block, secret_keys[proposer], spec)
    return signed, post


def make_sync_aggregate(state, sync_secret_keys, spec: ChainSpec | None = None):
    """Full-participation sync aggregate over ``state``'s CURRENT sync
    committee, signing the previous slot's block root exactly as
    ``process_sync_aggregate`` verifies it (operations.py:499-523).
    ``sync_secret_keys`` maps pubkey bytes -> secret key; the aggregate
    signature is minted as H(m)^(sum sk) — one scalar multiply instead
    of 512 signatures (bench/devnet registries cycle few distinct keys).
    """
    from ..crypto.bls import curve as C
    from ..crypto.bls.hash_to_curve import DST_POP, hash_to_g2

    spec = spec or get_chain_spec()
    previous_slot = max(int(state.slot), 1) - 1
    domain = accessors.get_domain(
        state,
        constants.DOMAIN_SYNC_COMMITTEE,
        misc.compute_epoch_at_slot(previous_slot, spec),
        spec,
    )
    signing_root = misc.compute_signing_root_bytes(
        accessors.get_block_root_at_slot(state, previous_slot, spec), domain
    )
    total_sk = 0
    for pk in state.current_sync_committee.pubkeys:
        total_sk += int.from_bytes(sync_secret_keys[bytes(pk)], "big")
    h = hash_to_g2(signing_root, DST_POP)
    sig_pt = C.g2.multiply_raw(h, total_sk % C.R)
    return SyncAggregate(
        sync_committee_bits=[True] * spec.SYNC_COMMITTEE_SIZE,
        sync_committee_signature=C.g2_to_bytes(sig_pt),
    )


def get_slot_signature(state, slot: int, secret_key: bytes, spec: ChainSpec) -> bytes:
    """Selection proof: signature over the slot (validator spec)."""
    domain = accessors.get_domain(
        state, constants.DOMAIN_SELECTION_PROOF, misc.compute_epoch_at_slot(slot, spec), spec
    )
    # slot is a uint64; the epoch-root helper is generic over any uint64
    return bls.sign(secret_key, misc.compute_signing_root_epoch(int(slot), domain))


def is_aggregator_hash(selection_proof: bytes, committee_len: int) -> bool:
    """The pure lottery: ``hash(proof)[:8] % max(1, len // TARGET) == 0``
    (validator spec ``is_aggregator``).  Split out so the boundary cases
    — modulo-1 committees (every member aggregates), the exact-threshold
    digest — are testable without minting a committee-shaped state, and
    so the duty scheduler can run the lottery straight off its derived
    committee sizes."""
    modulo = max(
        1, int(committee_len) // constants.TARGET_AGGREGATORS_PER_COMMITTEE
    )
    digest = misc.hash_bytes(selection_proof)
    return int.from_bytes(digest[:8], "little") % modulo == 0


def is_aggregator(
    state, slot: int, committee_index: int, selection_proof: bytes, spec: ChainSpec
) -> bool:
    """Hash-of-proof lottery selecting ~TARGET_AGGREGATORS_PER_COMMITTEE
    members (validator spec)."""
    committee = accessors.get_beacon_committee(state, slot, committee_index, spec)
    return is_aggregator_hash(selection_proof, len(committee))


def proposer_index_at_slot(state, slot: int, spec: ChainSpec | None = None) -> int:
    """Proposer for any ``slot`` answerable by ``state`` WITHOUT
    advancing it — one spec recipe: this simply names the accessor's
    explicit-slot mode (equal to the plain accessor on a state advanced
    to ``slot``, pinned in tests).  Mind the epoch-boundary caveat the
    scheduler handles: effective balances weight the sampling, so
    cross-boundary schedules want the epoch-advanced state."""
    return accessors.get_beacon_proposer_index(state, spec, slot=int(slot))


def attestation_data_from_state(
    state,
    slot: int,
    committee_index: int,
    head_root: bytes,
    spec: ChainSpec | None = None,
) -> AttestationData:
    """Spec-correct ``AttestationData`` an honest validator signs at
    ``slot`` given a head state: source = the state's current justified
    checkpoint, target = the attestation epoch's boundary block (the
    head itself when the state has not moved past the boundary)."""
    spec = spec or get_chain_spec()
    epoch = misc.compute_epoch_at_slot(int(slot), spec)
    start = misc.compute_start_slot_at_epoch(epoch, spec)
    if int(state.slot) <= start:
        target_root = bytes(head_root)
    else:
        target_root = accessors.get_block_root_at_slot(state, start, spec)
    return AttestationData(
        slot=int(slot),
        index=int(committee_index),
        beacon_block_root=bytes(head_root),
        source=state.current_justified_checkpoint,
        target=Checkpoint(epoch=epoch, root=target_root),
    )


def build_aggregate_and_proof(
    state,
    aggregator_index: int,
    aggregate: Attestation,
    secret_key: bytes,
    spec: ChainSpec,
) -> SignedAggregateAndProof:
    """SignedAggregateAndProof for gossip publication (validator spec)."""
    proof = AggregateAndProof(
        aggregator_index=aggregator_index,
        aggregate=aggregate,
        selection_proof=get_slot_signature(
            state, aggregate.data.slot, secret_key, spec
        ),
    )
    domain = accessors.get_domain(
        state,
        constants.DOMAIN_AGGREGATE_AND_PROOF,
        misc.compute_epoch_at_slot(aggregate.data.slot, spec),
        spec,
    )
    signature = bls.sign(secret_key, misc.compute_signing_root(proof, domain))
    return SignedAggregateAndProof(message=proof, signature=signature)


def make_attestation(
    state: BeaconState,
    slot: int,
    committee_index: int,
    head_root: bytes,
    target: Checkpoint,
    source: Checkpoint,
    secret_keys: Sequence[bytes],
    spec: ChainSpec | None = None,
    only_position: int | None = None,
) -> Attestation:
    """Aggregate attestation signed by the full committee of ``slot`` —
    or, with ``only_position``, the unaggregated single-validator vote the
    ``beacon_attestation_{subnet}`` topics carry (exactly one aggregation
    bit set, the p2p-spec REJECT condition for those topics)."""
    spec = spec or get_chain_spec()
    committee = accessors.get_beacon_committee(state, slot, committee_index, spec)
    data = AttestationData(
        slot=slot,
        index=committee_index,
        beacon_block_root=head_root,
        source=source,
        target=target,
    )
    domain = accessors.get_domain(
        state, constants.DOMAIN_BEACON_ATTESTER, target.epoch, spec
    )
    signing_root = misc.compute_signing_root(data, domain)
    positions = (
        range(len(committee)) if only_position is None else [only_position]
    )
    sigs = [bls.sign(secret_keys[committee[p]], signing_root) for p in positions]
    bits = [False] * len(committee)
    for p in positions:
        bits[p] = True
    return Attestation(
        aggregation_bits=bits,
        data=data,
        signature=bls.aggregate(sigs),
    )
