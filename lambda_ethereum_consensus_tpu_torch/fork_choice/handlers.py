"""Fork-choice handlers (ref: lib/.../fork_choice/handlers.ex:28-350).

The port's copy of the JAX package's ``fork_choice/handlers.py``.
``on_block`` runs the full state transition; unrealized-checkpoint pull-ups
follow spec v1.3.  ``on_attestation_batch`` picks its body by batch size
alone, before anything launches: from :func:`attestation_batch_target`
attestations up, the epoch committee cache on the device
(:func:`_attestation_batch_cached`); below it, the host body
(:func:`_attestation_batch_host`: each aggregate pubkey summed on the host,
one :func:`..crypto.bls.batch.batch_verify_each_points`, which routes by its
own size constant).

The entry points that reach the device (``on_block``, ``on_attestation``,
``on_attestation_batch``) take ``device``: ``None`` means the card, resolved
first at every batch size, and they raise where it is absent; ``"cpu"``
runs the plain PyTorch versions.

Observability, as in the JAX package: the drain runs inside the
``attestation_batch_verify`` span, links its member item traces to the
batch (``traces=``, :func:`..tracing.record_verify_batch`) and logs the
batch as a weight event on the store's forensics plane, which also hears
every checkpoint advance, accepted block and attester slashing.  One bad
item's unexpected exception becomes that item's ignore verdict
(:class:`_DrainContainment`), counted in ``gossip_batch_error_count``,
and the rest of the drain goes on — except a device fault (a
``RuntimeError``: a kernel, native or CUDA fault; ``faults.is_device_fault``),
which raises: the port surfaces device faults where the JAX package
contains them too.  Left out of the JAX package's module:
the sharded drain and the device-fault fallback (nothing is retried on the
host).
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np

from ..config import ChainSpec, constants, get_chain_spec
from ..faults import is_device_fault
from ..ops.sha256 import resolve_device
from ..state_transition import accessors, misc
from ..state_transition.core import process_slots, state_transition
from ..state_transition.epoch import process_justification_and_finalization
from ..state_transition.errors import SpecError
from ..state_transition.mutable import BeaconStateMut
from ..state_transition.predicates import (
    is_slashable_attestation_data,
    is_valid_indexed_attestation,
)
from ..telemetry import get_metrics, span
from ..tracing import record_verify_batch
from ..types.beacon import Attestation, AttesterSlashing, Checkpoint, SignedBeaconBlock
from .store import ForkChoiceError, LatestMessage, Store, checkpoint_key

__all__ = [
    "DRAIN_DEVICE_MIN",
    "attestation_batch_target",
    "compute_pulled_up_tip",
    "on_attestation",
    "on_attestation_batch",
    "on_attester_slashing",
    "on_block",
    "on_tick",
    "store_target_checkpoint_state",
    "update_checkpoints",
    "update_latest_messages",
    "update_latest_messages_batch",
    "validate_on_attestation",
]

log = logging.getLogger("fork_choice")


def expect(cond: bool, reason: str) -> None:
    if not cond:
        raise ForkChoiceError(reason)


# -------------------------------------------------------------------- tick

def on_tick(store: Store, time: int, spec: ChainSpec | None = None) -> None:
    """Advance wall-clock time slot by slot (ref: handlers.ex:28-42)."""
    spec = spec or get_chain_spec()
    tick_slot = (time - store.genesis_time) // spec.SECONDS_PER_SLOT
    while store.current_slot(spec) < tick_slot:
        previous_time = store.genesis_time + (store.current_slot(spec) + 1) * spec.SECONDS_PER_SLOT
        _on_tick_per_slot(store, previous_time, spec)
    _on_tick_per_slot(store, time, spec)


def _on_tick_per_slot(store: Store, time: int, spec: ChainSpec) -> None:
    previous_slot = store.current_slot(spec)
    store.time = time
    current_slot = store.current_slot(spec)
    if current_slot > previous_slot:
        store.proposer_boost_root = b"\x00" * 32
        store.bump()
        if store.slots_since_epoch_start(spec) == 0:
            update_checkpoints(
                store,
                store.unrealized_justified_checkpoint,
                store.unrealized_finalized_checkpoint,
            )


def update_checkpoints(store: Store, justified: Checkpoint, finalized: Checkpoint) -> None:
    forensics = getattr(store, "forensics", None)
    if justified.epoch > store.justified_checkpoint.epoch:
        store.justified_checkpoint = justified
        store.bump()
        if forensics is not None:
            forensics.note_justified(int(justified.epoch), bytes(justified.root))
    if finalized.epoch > store.finalized_checkpoint.epoch:
        store.finalized_checkpoint = finalized
        store.bump()
        if forensics is not None:
            forensics.note_finalized(int(finalized.epoch), bytes(finalized.root))
        if store.head_cache is not None:
            store.head_cache.prune(bytes(finalized.root))
        # checkpoint states + attestation contexts below the finalized
        # epoch can never be referenced again — free the states, committee
        # tables and device caches they pin
        store.prune_checkpoint_caches(int(finalized.epoch))


def update_unrealized_checkpoints(
    store: Store, justified: Checkpoint, finalized: Checkpoint
) -> None:
    if justified.epoch > store.unrealized_justified_checkpoint.epoch:
        store.unrealized_justified_checkpoint = justified
    if finalized.epoch > store.unrealized_finalized_checkpoint.epoch:
        store.unrealized_finalized_checkpoint = finalized


# ------------------------------------------------------------------- block

def on_block(
    store: Store,
    signed_block: SignedBeaconBlock,
    execution_engine=None,
    spec: ChainSpec | None = None,
    device=None,
) -> bytes:
    """Validate + apply a block, with the state transition's device work
    (the resident epoch plane, the attestation signatures) on ``device``
    (default: the card); returns its root (ref: handlers.ex:51-90)."""
    spec = spec or get_chain_spec()
    dev = resolve_device(device)
    block = signed_block.message
    parent_root = bytes(block.parent_root)
    expect(parent_root in store.block_states, "unknown parent block")
    pre_state = store.block_states[parent_root]
    expect(store.current_slot(spec) >= block.slot, "block is from the future")
    finalized_slot = misc.compute_start_slot_at_epoch(store.finalized_checkpoint.epoch, spec)
    expect(block.slot > finalized_slot, "block slot not after finalized slot")
    expect(
        store.get_checkpoint_block(parent_root, store.finalized_checkpoint.epoch, spec)
        == bytes(store.finalized_checkpoint.root),
        "block does not descend from finalized checkpoint",
    )

    state = state_transition(
        pre_state, signed_block, validate_result=True,
        execution_engine=execution_engine, spec=spec, device=dev,
    )
    root = block.hash_tree_root(spec)
    store.add_block(root, block, state)
    forensics = getattr(store, "forensics", None)
    if forensics is not None:
        # evidence ledger: a second distinct root for (slot, proposer)
        # is a double proposal — observed here, AFTER full validation,
        # so only blocks that actually entered fork choice count
        forensics.note_block(root, int(block.slot), int(block.proposer_index))

    # proposer boost for timely blocks (first 1/INTERVALS_PER_SLOT of the slot)
    time_into_slot = (store.time - store.genesis_time) % spec.SECONDS_PER_SLOT
    is_before_attesting_interval = time_into_slot < (
        spec.SECONDS_PER_SLOT // constants.INTERVALS_PER_SLOT
    )
    if store.current_slot(spec) == block.slot and is_before_attesting_interval:
        store.proposer_boost_root = root
        store.bump()

    update_checkpoints(store, state.current_justified_checkpoint, state.finalized_checkpoint)
    compute_pulled_up_tip(store, root, state, spec)
    return root


def compute_pulled_up_tip(store: Store, block_root: bytes, state, spec: ChainSpec) -> None:
    """Unrealized justification: run the FFG pass one epoch early
    (ref: handlers.ex compute_pulled_up_tip / spec v1.3)."""
    ws = BeaconStateMut(state)
    process_justification_and_finalization(ws, spec)
    unrealized_justified = ws.current_justified_checkpoint
    unrealized_finalized = ws.finalized_checkpoint
    store.unrealized_justifications[block_root] = unrealized_justified
    update_unrealized_checkpoints(store, unrealized_justified, unrealized_finalized)

    block = store.blocks[block_root]
    block_epoch = misc.compute_epoch_at_slot(block.slot, spec)
    current_epoch = misc.compute_epoch_at_slot(store.current_slot(spec), spec)
    if block_epoch < current_epoch:
        update_checkpoints(store, unrealized_justified, unrealized_finalized)


# ------------------------------------------------------------- attestation

# attestations from which on_attestation_batch takes the cached device body;
# below it the host body.  The smallest drain at which the cached body was at
# or below the host body on an H100 (PERF.md, the median of six runs on
# the hybrid pairing tail: 1.36 against 2.62 s at 8 aggregates, 1.34
# against 1.30 s at 4).  The JAX
# package reads its set gate here; on the card the drain and the set cross
# three orders of magnitude apart.
DRAIN_DEVICE_MIN = 8


def attestation_batch_target() -> int:
    """The smallest attestation batch that takes the device body of
    :func:`on_attestation_batch`, and the ingest scheduler's coalescing
    target for the attestation lanes: both read :data:`DRAIN_DEVICE_MIN`,
    at least 1."""
    return max(1, DRAIN_DEVICE_MIN)


def validate_target_epoch_against_current_time(
    store: Store, attestation: Attestation, spec: ChainSpec
) -> None:
    target = attestation.data.target
    current_epoch = misc.compute_epoch_at_slot(store.current_slot(spec), spec)
    previous_epoch = max(current_epoch - 1, constants.GENESIS_EPOCH)
    expect(
        target.epoch in (current_epoch, previous_epoch),
        "attestation target epoch not current or previous",
    )


def validate_on_attestation(
    store: Store, attestation: Attestation, is_from_block: bool, spec: ChainSpec
) -> None:
    target = attestation.data.target
    if not is_from_block:
        validate_target_epoch_against_current_time(store, attestation, spec)
    expect(
        target.epoch == misc.compute_epoch_at_slot(attestation.data.slot, spec),
        "attestation target epoch does not match slot",
    )
    expect(bytes(target.root) in store.blocks, "unknown attestation target block")
    beacon_block_root = bytes(attestation.data.beacon_block_root)
    expect(beacon_block_root in store.blocks, "unknown attestation head block")
    expect(
        store.blocks[beacon_block_root].slot <= attestation.data.slot,
        "attestation head block is newer than attestation",
    )
    expect(
        store.get_checkpoint_block(beacon_block_root, target.epoch, spec)
        == bytes(target.root),
        "attestation target does not match head block's checkpoint",
    )
    expect(
        store.current_slot(spec) >= attestation.data.slot + 1,
        "attestation is for a future slot",
    )


def store_target_checkpoint_state(
    store: Store, target: Checkpoint, spec: ChainSpec, device=None
) -> None:
    """Materialize the target's checkpoint state, advancing the target
    block's state on ``device`` (default: the card) when it lies before the
    epoch start."""
    key = checkpoint_key(target)
    if key not in store.checkpoint_states:
        base = store.block_states[bytes(target.root)]
        start_slot = misc.compute_start_slot_at_epoch(target.epoch, spec)
        if base.slot < start_slot:
            base = process_slots(base, start_slot, spec, device)
        store.checkpoint_states[key] = base


def update_latest_messages(store: Store, attesting_indices, attestation: Attestation) -> None:
    target = attestation.data.target
    beacon_block_root = bytes(attestation.data.beacon_block_root)
    non_equivocating = [i for i in attesting_indices if i not in store.equivocating_indices]
    cache = store.head_cache
    target_state = (
        store.checkpoint_states.get(checkpoint_key(target)) if cache is not None else None
    )
    updated = False
    for i in non_equivocating:
        prev = store.latest_messages.get(i)
        if prev is None or target.epoch > prev.epoch:
            store.latest_messages[i] = LatestMessage(epoch=int(target.epoch), root=beacon_block_root)
            store.note_vote(i, int(target.epoch))
            updated = True
            if cache is not None and target_state is not None:
                cache.on_vote(
                    i, beacon_block_root, int(target_state.validators[i].effective_balance)
                )
    if updated:
        # one memo invalidation per attestation, not per validator
        store.bump()


def on_attestation(
    store: Store,
    attestation: Attestation,
    is_from_block: bool = False,
    spec: ChainSpec | None = None,
    device=None,
) -> None:
    """Validate and record one attestation's LMD vote (ref:
    handlers.ex:100-119); its signature is checked on the host, the
    checkpoint state advanced on ``device`` (default: the card)."""
    spec = spec or get_chain_spec()
    dev = resolve_device(device)
    try:
        validate_on_attestation(store, attestation, is_from_block, spec)
        store_target_checkpoint_state(store, attestation.data.target, spec, dev)
        target_state = store.checkpoint_states[checkpoint_key(attestation.data.target)]
        indexed = accessors.get_indexed_attestation(target_state, attestation, spec)
        expect(
            is_valid_indexed_attestation(target_state, indexed, spec),
            "invalid attestation signature",
        )
    except SpecError as e:
        raise ForkChoiceError(str(e)) from None
    update_latest_messages(store, indexed.attesting_indices, attestation)


def on_attestation_batch(
    store: Store,
    attestations: list[Attestation],
    is_from_block: bool = False,
    spec: ChainSpec | None = None,
    traces: list | None = None,
    device=None,
) -> list[ForkChoiceError | None]:
    """Record many attestations with batched signature checks, ``device``
    (default: the card) resolved first.

    Structural validation runs per item.  From
    :func:`attestation_batch_target` attestations up, aggregate pubkeys come
    from the epoch-scoped ``DeviceCommitteeCache`` as ``full_sum[committee]
    - sum(missing members)`` on the device, each target context's
    signatures checked as one random-linear-combination chain with
    bisection blame (one bad item costs O(log N) sub-batch levels, not 2N
    pairings), and accepted votes land through the vectorized
    latest-message/head-cache batch path.  A smaller batch takes the host
    body.  Returns one ``None`` (accepted) or ``ForkChoiceError``
    (rejected; ``reject`` True for a protocol violation) per input.

    The body runs inside ``span("attestation_batch_verify", path=...,
    n_devices=1)``, ``path`` the body taken (``"cached"`` or ``"host"``).
    ``traces`` (position-aligned with ``attestations``, entries may be
    None) links this batched verify back to its member item traces: the
    batch span carries the member trace ids, each member records the batch
    id plus its outcome (``apply`` + the admission→apply latency histogram,
    or ``drop`` with the error).  A store with a forensics plane logs the
    batch as a weight event carrying that batch id (None without live
    traces).
    """
    spec = spec or get_chain_spec()
    dev = resolve_device(device)
    results: list[ForkChoiceError | None] = [None] * len(attestations)
    cached = bool(attestations) and len(attestations) >= attestation_batch_target()
    path = "cached" if cached else "host"
    live_traces = traces is not None and any(t is not None for t in traces)
    t0 = _time.monotonic() if live_traces else 0.0
    with span("attestation_batch_verify", path=path, n_devices=1):
        if attestations:
            body = _attestation_batch_cached if cached else _attestation_batch_host
            body(store, attestations, is_from_block, spec, results, dev)
    batch_id = None
    if live_traces:
        batch_id = record_verify_batch(
            traces, results, path, t0, _time.monotonic() - t0, n_devices=1
        )
    forensics = getattr(store, "forensics", None)
    if forensics is not None and attestations:
        # weight-event log: this batch is a reorg-attribution candidate;
        # batch_id joins it to the flight recorder's batch span (None
        # when tracing was off — the forensic record still lands)
        forensics.note_attestation_batch(batch_id, path, len(attestations))
    return results


class _DrainContainment:
    """Per-item containment for UNEXPECTED drain errors: wrap the
    exception into an ignore-polarity verdict so one bad message never
    drops the whole gossip batch, count it, and log the first traceback per
    drain — a systemic failure stays diagnosable without thousands of
    traceback copies.  A ``RuntimeError`` (a kernel, native or CUDA fault,
    ``torch.OutOfMemoryError``) is never contained: the drain bodies
    re-raise it before they reach :meth:`verdict`."""

    def __init__(self, where: str):
        self.where = where
        self.logged = False

    def verdict(self, e: Exception, count: int = 1, stage: str = "item"):
        if not self.logged:
            self.logged = True
            log.exception("unexpected error in %s", self.where)
        get_metrics().inc("gossip_batch_error_count", value=count, stage=stage)
        return ForkChoiceError(f"attestation drain internal error: {type(e).__name__}: {e}")


def _attestation_batch_host(store, attestations, is_from_block, spec, results, dev) -> None:
    """The host drain body: per item, fork-choice validation, the target
    checkpoint state, the indexed attestation and its signature inputs; the
    aggregate pubkey summed on the host from the cached pubkey points; then
    ONE ``batch_verify_each_points`` over the prepared entries (routed by
    its own size constant).  Accepted votes apply per item through
    :func:`update_latest_messages`."""
    from ..crypto.bls import BlsError
    from ..crypto.bls.batch import batch_verify_each_points
    from ..crypto.bls.curve import DeserializationError, g2_from_bytes
    from ..state_transition.operations import _sum_points
    from ..state_transition.predicates import indexed_attestation_signature_inputs

    prepared = []  # (i, attestation, indexed, point entry)
    contain = _DrainContainment("host attestation drain")
    for i, attestation in enumerate(attestations):
        try:
            validate_on_attestation(store, attestation, is_from_block, spec)
            store_target_checkpoint_state(store, attestation.data.target, spec, dev)
            target_state = store.checkpoint_states[checkpoint_key(attestation.data.target)]
            indexed = accessors.get_indexed_attestation(target_state, attestation, spec)
            pubkeys, signing_root = indexed_attestation_signature_inputs(
                target_state, indexed, spec)
            # a sum of individually subgroup-checked (cached) points is in
            # the subgroup: no compress/decompress/re-check round trip
            agg_pk = _sum_points(pubkeys)
            if agg_pk is None:
                raise ForkChoiceError("identity pubkey in committee")
            sig_pt = g2_from_bytes(bytes(indexed.signature))
            prepared.append((i, attestation, indexed, (agg_pk, signing_root, sig_pt)))
        except ForkChoiceError as e:
            # keep the original verdict (its reject polarity matters)
            results[i] = e
        except (BlsError, DeserializationError) as e:
            # undecodable signature / bad point: protocol violation
            results[i] = ForkChoiceError(str(e), reject=True)
        except SpecError as e:
            # unknown block, timing, committee mismatch: could be a race
            # or missing context — ignore, don't penalize
            results[i] = ForkChoiceError(str(e))
        except Exception as e:
            if is_device_fault(e):
                raise  # a device or native fault is surfaced, never contained
            # unexpected (e.g. an IndexError from a malformed bitfield)
            results[i] = contain.verdict(e)
    if not prepared:
        return
    flags = batch_verify_each_points([entry for _, _, _, entry in prepared], device=dev)
    for (i, attestation, indexed, _), ok in zip(prepared, flags):
        if ok:
            update_latest_messages(store, indexed.attesting_indices, attestation)
        else:
            results[i] = ForkChoiceError("invalid attestation signature", reject=True)


def _attestation_batch_cached(store, attestations, is_from_block, spec, results, dev) -> None:
    """The epoch-cache device drain (module doc: fork_choice/attestation).

    Per item: fork-choice validation + numpy participation split + signing
    root; then ONE ``batch_verify_each_cached`` chain per target context
    (aggregate pubkeys never touch the host).  Entries whose missing-member
    count exceeds the cache's correction capacity take the sparse route:
    their participants are summed on the host and checked together through
    ``batch_verify_each_points`` (routed by its own size constant).
    Accepted votes apply through the vectorized batch updater.
    """
    from ..crypto.bls import BlsError
    from ..crypto.bls.batch import batch_verify_each_cached, batch_verify_each_points
    from ..crypto.bls.curve import DeserializationError, g2_from_bytes_batch
    from ..state_transition.operations import _sum_points
    from .attestation import get_attestation_context

    pending = []  # (i, att, ctx, cid, attesting, missing, sroot, target_state)
    contain = _DrainContainment("cached attestation drain")
    for i, attestation in enumerate(attestations):
        try:
            validate_on_attestation(store, attestation, is_from_block, spec)
            store_target_checkpoint_state(store, attestation.data.target, spec, dev)
            target_state = store.checkpoint_states[checkpoint_key(attestation.data.target)]
            ctx = get_attestation_context(store, attestation.data.target, target_state, spec, dev)
            cid, attesting, missing = ctx.participation(attestation)
            if len(attesting) == 0:
                raise ForkChoiceError("attestation has no participants", reject=True)
            signing_root = ctx.signing_root(attestation.data)
            pending.append(
                (i, attestation, ctx, cid, attesting, missing, signing_root, target_state)
            )
        except ForkChoiceError as e:
            results[i] = e
        except (BlsError, DeserializationError) as e:
            results[i] = ForkChoiceError(str(e), reject=True)
        except (SpecError, ValueError) as e:
            # unknown block, timing, committee mismatch, a bad bitfield
            # buffer: could be a race or missing context — ignore
            results[i] = ForkChoiceError(str(e))
        except Exception as e:
            if is_device_fault(e):
                raise  # a device or native fault is surfaced, never contained
            # unexpected (e.g. a TypeError from a malformed bitfield)
            results[i] = contain.verdict(e)

    # one decompression pass (the native thread pool) — AFTER validation,
    # so junk that fork choice rejects anyway costs nothing
    sig_points = g2_from_bytes_batch([bytes(p[1].signature) for p in pending])

    by_ctx: dict[int, list] = {}  # id(ctx) -> [(i, att, attesting, entry)]
    ctxs: dict[int, object] = {}
    host_entries = []  # (i, att, ctx, attesting, point entry) — over capacity
    for (i, attestation, ctx, cid, attesting, missing, signing_root,
         target_state), sig_pt in zip(pending, sig_points):
        try:
            if sig_pt is False:
                raise ForkChoiceError("undecodable signature", reject=True)
            if sig_pt is None:
                raise ForkChoiceError("infinity signature", reject=True)
            cache = ctx.device_cache()
            if len(missing) <= cache.mmax:
                entry = (cid, missing.tolist(), signing_root, sig_pt)
                by_ctx.setdefault(id(ctx), []).append((i, attestation, attesting, entry))
                ctxs[id(ctx)] = ctx
            else:
                # sparse aggregate: summing the participants beats
                # correcting the full sum
                agg_pk = _sum_points([bytes(target_state.validators[v].pubkey)
                                      for v in attesting])
                if agg_pk is None:
                    raise ForkChoiceError("identity pubkey in committee")
                host_entries.append(
                    (i, attestation, ctx, attesting, (agg_pk, signing_root, sig_pt))
                )
        except ForkChoiceError as e:
            results[i] = e
        except (BlsError, DeserializationError) as e:
            results[i] = ForkChoiceError(str(e), reject=True)
        except (SpecError, ValueError) as e:
            # ctx.device_cache() can raise here (an invalid registry pubkey,
            # inconsistent cache shapes): fail the item, not the batch
            get_metrics().inc("gossip_batch_error_count", stage="item")
            results[i] = ForkChoiceError(str(e))
        except Exception as e:  # unexpected: contain to the item
            if is_device_fault(e):
                raise
            results[i] = contain.verdict(e)

    accepted = []  # (batch index, ctx, attestation, attesting array)
    for ctx_id, group in by_ctx.items():
        ctx = ctxs[ctx_id]
        try:
            flags = batch_verify_each_cached(
                ctx.device_cache(),
                [entry for _, _, _, entry in group],
                message_points=ctx.message_points,
            )
        except (SpecError, ValueError) as e:
            # fail THIS context's items, not the whole batch
            get_metrics().inc("gossip_batch_error_count", value=len(group), stage="context")
            for i, _, _, _ in group:
                results[i] = ForkChoiceError(str(e))
            continue
        for (i, attestation, attesting, _), ok in zip(group, flags):
            if ok:
                accepted.append((i, ctx, attestation, attesting))
            else:
                results[i] = ForkChoiceError("invalid attestation signature", reject=True)
    if host_entries:
        flags = batch_verify_each_points([e[4] for e in host_entries], device=dev)
        for (i, attestation, ctx, attesting, _), ok in zip(host_entries, flags):
            if ok:
                accepted.append((i, ctx, attestation, attesting))
            else:
                results[i] = ForkChoiceError("invalid attestation signature", reject=True)

    update_latest_messages_batch(store, accepted)


def update_latest_messages_batch(store, accepted) -> None:
    """Vectorized LMD vote application for a drain's accepted
    attestations — ``accepted`` is ``[(batch_index, ctx, attestation,
    attesting_array)]``.  Semantics match per-item
    :func:`update_latest_messages` EXACTLY, including within-batch
    ordering: a claim pass in batch-index order decides which attestation
    a validator's same-epoch vote came from (first valid wins; a strictly
    newer epoch later in the batch still overrides), then per-(epoch,
    root) buckets apply epoch-ascending through one numpy filter, one
    shared ``LatestMessage``, and ``HeadCache.on_votes_batch``."""
    if not accepted:
        return
    n = max(ctx.n_validators for _, ctx, _, _ in accepted)
    claim_epoch = np.full(n, -1, np.int64)  # within-batch claims only
    buckets: dict[tuple[int, bytes], list] = {}
    bucket_ctx: dict[tuple[int, bytes], object] = {}
    for _, ctx, attestation, attesting in sorted(accepted, key=lambda t: t[0]):
        epoch = int(attestation.data.target.epoch)
        root = bytes(attestation.data.beacon_block_root)
        attesting = np.asarray(attesting, np.int64)
        newly = attesting[claim_epoch[attesting] < epoch]
        if not len(newly):
            continue
        claim_epoch[newly] = epoch
        buckets.setdefault((epoch, root), []).append(newly)
        bucket_ctx[(epoch, root)] = ctx

    updated = False
    for (epoch, root) in sorted(buckets, key=lambda k: k[0]):
        ctx = bucket_ctx[(epoch, root)]
        uniq = np.unique(np.concatenate(buckets[(epoch, root)]))
        if store.equivocating_indices:
            uniq = uniq[~np.isin(uniq, np.fromiter(store.equivocating_indices, np.int64))]
        epochs = store.vote_epoch_array(ctx.n_validators)
        moved = uniq[epochs[uniq] < epoch]
        if not len(moved):
            continue
        epochs[moved] = epoch
        lm = LatestMessage(epoch=epoch, root=root)
        store.latest_messages.update(dict.fromkeys(moved.tolist(), lm))
        if store.head_cache is not None:
            store.head_cache.on_votes_batch(moved, ctx.eff_balance[moved], root)
        updated = True
    if updated:
        store.bump()


# -------------------------------------------------------- attester slashing

def on_attester_slashing(
    store: Store, attester_slashing: AttesterSlashing, spec: ChainSpec | None = None
) -> None:
    """Track equivocating validators (ref: handlers.ex:127-154); both
    signatures are checked on the host."""
    spec = spec or get_chain_spec()
    att1 = attester_slashing.attestation_1
    att2 = attester_slashing.attestation_2
    expect(is_slashable_attestation_data(att1.data, att2.data), "attestations are not slashable")
    state = store.block_states[bytes(store.justified_checkpoint.root)]
    expect(is_valid_indexed_attestation(state, att1, spec), "attestation 1 invalid")
    expect(is_valid_indexed_attestation(state, att2, spec), "attestation 2 invalid")
    equivocators = set(att1.attesting_indices) & set(att2.attesting_indices)
    store.equivocating_indices.update(equivocators)
    store.bump()
    if store.head_cache is not None:
        for i in equivocators:
            store.head_cache.on_equivocation(i)
    forensics = getattr(store, "forensics", None)
    if forensics is not None:
        forensics.note_attester_slashing(equivocators)
