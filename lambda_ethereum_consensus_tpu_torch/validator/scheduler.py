"""Duty engine: per-epoch assignments fired against slot-phase deadlines.

The read side of the node verifies at scale; this is the write side — a
staking-provider-shaped operator holding 10^4-10^5 keys on one node owes
every one of them an attestation each epoch, a selection-proof lottery
ticket each duty, and occasionally a block.  The scheduler:

- **derives assignments** for an epoch straight off the epoch committee
  context (:func:`..fork_choice.attestation.get_state_attestation_context`
  — the same host table that backs the device committee caches, so duty
  derivation shares the shuffle the verify plane already paid for) plus
  the slot-keyed proposer schedule (``proposer_index_at_slot``);
- **produces batched**: one ``AttestationData``/signing root per
  committee, every managed member's signature in ONE
  :func:`..ops.bls_sign.sign_batch` flush (the card's G2 ladder from
  ``DUTY_SIGN_MIN`` signatures, the host route below it); selection
  proofs batch the same way (one message per slot); aggregate-and-proof
  wrappers batch across the elected aggregators;
- **pools**: own votes land in an :class:`.pool.AttestationPool`; the
  aggregation duty publishes the pool's widest aggregate per committee;
  the proposer duty assembles its block from the pooled set through
  ``build_signed_block``;
- **observes deadlines**: each phase's completion offset into its slot
  lands in ``duty_completion_offset_seconds{type}``, judged against the
  phase's BROADCAST boundary on the honest-validator timeline — a block
  must be out by 1/3 slot (attesters vote then), attestations by 2/3
  (aggregation opens then), aggregates by the slot end; misses count in
  ``duty_deadline_miss_total``.

The port's copy of the JAX package's ``validator/scheduler.py``.  The
scheduler's ``device`` (default: the card) carries its default signer, its
epoch advances, its committee contexts and its proposals.  A device or
native fault (``RuntimeError``, ``faults.is_device_fault``) propagates out
of every entry point,
``on_tick`` included; any other failure of a phase is logged and skipped
as in the JAX package.  Two host costs of a 10^6-validator registry are
cut without changing an answer: the proposer schedule reads one mutable
view's vectorized columns, and a proposal's inclusion screen counts the
committees once per target epoch.
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass, field

import numpy as np

from ..config import ChainSpec, constants, get_chain_spec, use_chain_spec
from ..faults import is_device_fault
from ..fork_choice.attestation import get_state_attestation_context
from ..ops.bls_sign import sign_batch
from ..state_transition import accessors, misc, process_slots
from ..state_transition.mutable import BeaconStateMut
from ..telemetry import get_metrics
from ..types.beacon import Attestation
from ..types.validator import AggregateAndProof, SignedAggregateAndProof
from .duties import (
    attestation_data_from_state,
    build_signed_block,
    is_aggregator_hash,
    proposer_index_at_slot,
)
from .pool import AttestationPool

__all__ = ["AttesterDuty", "EpochDuties", "DutyScheduler"]

log = logging.getLogger("duties")


@dataclass(frozen=True)
class AttesterDuty:
    validator_index: int
    slot: int
    committee_index: int
    committee_position: int
    committee_size: int


@dataclass
class EpochDuties:
    epoch: int
    committees_per_slot: int
    attesters_by_slot: dict = field(default_factory=dict)  # slot -> [duty]
    proposers: dict = field(default_factory=dict)  # slot -> validator index

    @property
    def attester_count(self) -> int:
        return sum(len(v) for v in self.attesters_by_slot.values())


class DutyScheduler:
    """Operate ``keymap`` (validator index -> 32-byte secret key) against
    a chain.  Pure-produce: callers (a node's tick loop, a bench)
    publish/apply what comes back.  ``sign(secret_keys, messages)`` signs
    a flush; by default :func:`..ops.bls_sign.sign_batch` on ``device``
    (default: the card), which also carries the epoch advances, the
    committee contexts and the proposals."""

    def __init__(
        self,
        keymap: dict[int, bytes],
        spec: ChainSpec | None = None,
        clock=None,
        pool: AttestationPool | None = None,
        sign=None,
        device=None,
    ):
        self.keymap = {int(k): bytes(v) for k, v in keymap.items()}
        self._spec = spec
        self.clock = clock
        self.pool = pool if pool is not None else AttestationPool(spec)
        self.device = device
        self._sign = sign if sign is not None else functools.partial(sign_batch, device=device)
        self._duties: dict[tuple, EpochDuties] = {}
        self._advanced: dict[tuple, tuple] = {}  # (epoch, id) -> (state, adv)
        self._fired: dict[str, int] = {}  # phase -> last fired slot
        get_metrics().set_gauge("duty_keys_managed", float(len(self.keymap)))

    @property
    def spec(self) -> ChainSpec:
        return self._spec if self._spec is not None else get_chain_spec()

    # ---------------------------------------------------------- derivation

    def _advanced_for_epoch(self, state, epoch: int):
        """``state`` advanced through empty slots into ``epoch`` — the
        honest-validator guide's ``process_slots`` before reading the
        justified checkpoint (attestation source) or the proposer
        schedule across an epoch boundary; the un-advanced head state
        carries the PRE-boundary values for both.  Attester committees
        never need this (MIN_SEED_LOOKAHEAD fixes them an epoch out).
        Tiny cache keyed on the exact state object: one boundary
        transition per (head, epoch), not one per duty phase."""
        spec = self.spec
        start = misc.compute_start_slot_at_epoch(int(epoch), spec)
        if int(state.slot) >= start:
            return state
        key = (int(epoch), id(state))
        hit = self._advanced.get(key)
        if hit is not None and hit[0] is state:
            return hit[1]
        advanced = process_slots(state, start, spec, self.device)
        if len(self._advanced) > 2:
            self._advanced.clear()  # two epochs live at once
        self._advanced[key] = (state, advanced)
        return advanced

    def duties_for_epoch(
        self, state, epoch: int, proposers: bool = True
    ) -> EpochDuties:
        """Assignments for every managed key at ``epoch``, derived from
        the shared epoch committee context and cached under the same
        identity (chain, epoch, shuffling seed, registry length)."""
        spec = self.spec
        epoch = int(epoch)
        seed = accessors.get_seed(
            state, epoch, constants.DOMAIN_BEACON_ATTESTER, spec
        )
        key = (
            bytes(state.genesis_validators_root),
            epoch,
            seed,
            len(state.validators),
        )
        hit = self._duties.get(key)
        if hit is not None:
            return hit
        ctx = get_state_attestation_context(state, epoch, spec, self.device)
        duties = EpochDuties(epoch=epoch, committees_per_slot=ctx.committees_per_slot)
        managed = np.zeros(ctx.n_validators, bool)
        own = [i for i in self.keymap if i < ctx.n_validators]
        managed[own] = True
        for cid in range(ctx.count):
            row = ctx.committee(cid)
            hits = np.nonzero(managed[row])[0]
            if not len(hits):
                continue
            slot = ctx.start_slot + cid // ctx.committees_per_slot
            index = cid % ctx.committees_per_slot
            bucket = duties.attesters_by_slot.setdefault(slot, [])
            for pos in hits:
                bucket.append(AttesterDuty(
                    validator_index=int(row[pos]),
                    slot=int(slot),
                    committee_index=int(index),
                    committee_position=int(pos),
                    committee_size=int(len(row)),
                ))
        if proposers:
            # the proposer schedule is eb-weighted, and effective
            # balances can move at the boundary: derive it from the
            # epoch-advanced state (the attester table above is fixed by
            # MIN_SEED_LOOKAHEAD and safely reads the un-advanced one).
            # Known limit: competing forks sharing this epoch's attester
            # seed but diverging in boundary eb updates would collide on
            # this cache key — per-dependent-root duty caching is the
            # heavier fix if that fork shape ever matters here
            # One mutable view answers every slot from its vectorized
            # registry columns; a frozen state rescans the registry's
            # Validator objects once per slot (about 2 s a slot at 10^6).
            adv = BeaconStateMut(self._advanced_for_epoch(state, epoch))
            start = misc.compute_start_slot_at_epoch(epoch, spec)
            for slot in range(start, start + spec.SLOTS_PER_EPOCH):
                duties.proposers[slot] = proposer_index_at_slot(
                    adv, slot, spec
                )
        if len(self._duties) > 4:
            self._duties.clear()  # two epochs live at once; 4 is slack
        self._duties[key] = duties
        return duties

    # ---------------------------------------------------------- production

    def produce_attestations(
        self, state, slot: int, head_root: bytes, now: float | None = None
    ) -> list[Attestation]:
        """Every managed attester duty of ``slot`` as single-bit gossip
        votes — one signing root per committee, ALL signatures in one
        batched dispatch — pooled for the later aggregation duty.
        ``now`` is the firing instant (see :meth:`_observe_phase`)."""
        t0 = time.perf_counter()
        spec = self.spec
        slot = int(slot)
        epoch = misc.compute_epoch_at_slot(slot, spec)
        duties = self.duties_for_epoch(state, epoch).attesters_by_slot.get(
            slot, []
        )
        if not duties:
            return []
        ctx = get_state_attestation_context(state, epoch, spec, self.device)
        # across an epoch boundary the un-advanced head state still
        # carries the PRE-boundary justified checkpoint: sign the data
        # an advanced state answers, or every vote of the epoch's first
        # slots is un-includable (source mismatch)
        duty_state = self._advanced_for_epoch(state, epoch)
        data_by_index: dict[int, object] = {}
        root_by_index: dict[int, bytes] = {}
        for duty in duties:
            if duty.committee_index not in data_by_index:
                data = attestation_data_from_state(
                    duty_state, slot, duty.committee_index, head_root, spec
                )
                data_by_index[duty.committee_index] = data
                root_by_index[duty.committee_index] = ctx.signing_root(data)
        sigs = self._sign(
            [self.keymap[d.validator_index] for d in duties],
            [root_by_index[d.committee_index] for d in duties],
        )
        votes = []
        for duty, sig in zip(duties, sigs):
            bits = [False] * duty.committee_size
            bits[duty.committee_position] = True
            att = Attestation(
                aggregation_bits=bits,
                data=data_by_index[duty.committee_index],
                signature=sig,
            )
            self.pool.add_vote(att)
            votes.append(att)
        # broadcast deadline: before the aggregation interval opens
        self._observe_phase("attest", slot, len(votes), now,
                            time.perf_counter() - t0, deadline_intervals=2)
        return votes

    def produce_aggregates(
        self, state, slot: int, now: float | None = None
    ) -> list[SignedAggregateAndProof]:
        """The aggregation duty: run the selection lottery for every
        managed member of ``slot``'s committees (proofs batch-signed —
        one shared message), and for each elected aggregator publish the
        pool's widest aggregate wrapped in a SignedAggregateAndProof
        (wrapper signatures batched too)."""
        t0 = time.perf_counter()
        spec = self.spec
        slot = int(slot)
        epoch = misc.compute_epoch_at_slot(slot, spec)
        duties = self.duties_for_epoch(state, epoch).attesters_by_slot.get(
            slot, []
        )
        if not duties:
            return []
        sel_domain = accessors.get_domain(
            state, constants.DOMAIN_SELECTION_PROOF, epoch, spec
        )
        sel_root = misc.compute_signing_root_epoch(slot, sel_domain)
        proofs = self._sign(
            [self.keymap[d.validator_index] for d in duties],
            [sel_root] * len(duties),
        )
        winners = [
            (duty, proof)
            for duty, proof in zip(duties, proofs)
            if is_aggregator_hash(proof, duty.committee_size)
        ]
        messages, wrapped = [], []
        agg_domain = accessors.get_domain(
            state, constants.DOMAIN_AGGREGATE_AND_PROOF, epoch, spec
        )
        seen_index: set[int] = set()
        for duty, proof in winners:
            if duty.committee_index in seen_index:
                continue  # one published aggregate per committee is enough
            aggregate = self.pool.aggregate_for(slot, duty.committee_index)
            if aggregate is None:
                continue
            seen_index.add(duty.committee_index)
            proof_obj = AggregateAndProof(
                aggregator_index=duty.validator_index,
                aggregate=aggregate,
                selection_proof=proof,
            )
            wrapped.append((duty, proof_obj))
            messages.append(misc.compute_signing_root(proof_obj, agg_domain))
        if not wrapped:
            self._observe_phase("aggregate", slot, 0, now,
                                time.perf_counter() - t0, deadline_intervals=3)
            return []
        sigs = self._sign(
            [self.keymap[duty.validator_index] for duty, _p in wrapped],
            messages,
        )
        out = [
            SignedAggregateAndProof(message=proof_obj, signature=sig)
            for (_duty, proof_obj), sig in zip(wrapped, sigs)
        ]
        # broadcast deadline: aggregates are useful until the slot ends
        self._observe_phase("aggregate", slot, len(out), now,
                            time.perf_counter() - t0, deadline_intervals=3)
        return out

    def produce_block(
        self, state, slot: int, now: float | None = None
    ):
        """The proposer duty: when ``slot``'s proposer is a managed key,
        assemble a block from the pooled attestation set through
        ``build_signed_block``.  Returns ``(signed_block, post_state)``
        or ``None`` (unmanaged proposer / already-proposed slot)."""
        t0 = time.perf_counter()
        spec = self.spec
        slot = int(slot)
        if int(state.slot) >= slot:
            return None  # a block already advanced the head to this slot
        epoch = misc.compute_epoch_at_slot(slot, spec)
        proposer = self.duties_for_epoch(state, epoch).proposers.get(slot)
        if proposer is None:
            proposer = proposer_index_at_slot(
                self._advanced_for_epoch(state, epoch), slot, spec
            )
        if proposer not in self.keymap:
            return None
        # advance once, filter the pooled candidates against the actual
        # proposal pre-state (the pool never verifies), and keep a
        # no-attestation fallback: one bad candidate must cost its own
        # inclusion, never the whole proposal
        pre = (
            process_slots(state, slot, spec, self.device)
            if int(state.slot) < slot else state
        )
        counts: dict = {}  # target epoch -> committees per slot
        atts = [
            att
            for att in self.pool.block_attestations(slot)
            if self._includable(pre, att, counts)
        ]
        try:
            produced = build_signed_block(
                pre, slot, self.keymap, attestations=atts, spec=spec,
                device=self.device,
            )
        except Exception as exc:
            if is_device_fault(exc):
                raise  # a device or native fault is no bad candidate
            if not atts:
                raise
            log.exception(
                "pooled attestations broke the slot-%d proposal; "
                "rebuilding empty", slot,
            )
            produced = build_signed_block(
                pre, slot, self.keymap, spec=spec, device=self.device
            )
        self._observe_phase("propose", slot, 1, now,
                            time.perf_counter() - t0, deadline_intervals=1)
        return produced

    def _includable(self, pre, att, counts: dict) -> bool:
        """Cheap pre-state screen mirroring ``process_attestation``'s
        RAISING checks (epoch window, source-vs-justified, committee
        index bound) — target/head mismatches only lose flags and need
        no screen.  The pool's own inclusion-delay window already ran.
        ``counts`` memoizes the committee count per target epoch across
        one proposal's candidates (each count is a registry scan)."""
        spec = self.spec
        data = att.data
        current = accessors.get_current_epoch(pre, spec)
        target_epoch = int(data.target.epoch)
        if target_epoch not in (current, current - 1):
            return False
        just = (
            pre.current_justified_checkpoint
            if target_epoch == current
            else pre.previous_justified_checkpoint
        )
        if data.source != just:
            return False
        if target_epoch not in counts:
            counts[target_epoch] = accessors.get_committee_count_per_slot(
                pre, target_epoch, spec
            )
        return int(data.index) < counts[target_epoch]

    # ------------------------------------------------------------ deadlines

    def _observe_phase(
        self,
        kind: str,
        slot: int,
        count: int,
        now: float | None,
        elapsed: float,
        deadline_intervals: int,
    ) -> None:
        """One phase completion.  ``now`` is the instant the phase FIRED
        (``None`` = completion read off the wall clock); completion =
        firing instant + measured production ``elapsed`` — so the live
        node and the gate's virtual-instant replay share one deadline
        judgment, and the gate's quantiles never depend on when CI ran
        it.  Production counters always; offsets/misses need a clock."""
        m = get_metrics()
        if count:
            m.inc("duties_produced_total", value=count, type=kind)
        if self.clock is None:
            return
        completion = time.time() if now is None else now + elapsed
        offset = max(0.0, completion - self.clock.slot_start(slot))
        m.observe("duty_completion_offset_seconds", offset, type=kind)
        deadline = (
            deadline_intervals
            * self.clock.seconds_per_slot
            / self.clock.intervals_per_slot
        )
        if offset > deadline and count:
            m.inc("duty_deadline_miss_total", value=count, type=kind)

    # ------------------------------------------------------------ node tick

    def on_tick(self, store, now: float | None = None) -> dict:
        """Fire due phases once per slot against the store's head:
        propose at the slot boundary, attest after 1/3, aggregate after
        2/3 (the canonical honest-validator timeline).  Returns whatever
        was produced so the caller can publish it."""
        produced: dict = {}
        if self.clock is None:
            return produced
        if now is None:
            now = time.time()
        slot = self.clock.slot_at(now)
        if slot < 0:
            return produced
        interval = self.clock.interval_at(now)
        head = None
        cache = getattr(store, "head_cache", None)
        if cache is not None:
            head = cache.head()
        if head is None:
            from ..fork_choice import get_head

            head = get_head(store, self.spec)
        state = store.block_states.get(head)
        if state is None:
            return produced
        try:
            # the node fires this on an executor thread, where the
            # ContextVar-held ambient spec does NOT follow the loop's
            # context — default-constructed containers (SyncAggregate
            # bits in build_signed_block) would silently size for the
            # wrong preset.  Pin the scheduler's spec for the whole pass.
            with use_chain_spec(self.spec):
                return self._fire_phases(produced, state, head, slot, interval, now)
        except Exception as exc:
            if is_device_fault(exc):
                raise  # a device or native fault propagates, never skipped
            # a failed phase must not take the tick loop down with it;
            # the skipped-slot evidence is the missing production counter
            log.exception("duty phase failed at slot %d", slot)
        return produced

    def _fire_phases(
        self, produced: dict, state, head: bytes, slot: int,
        interval: int, now: float,
    ) -> dict:
        def attest():
            self._fired["attest"] = slot
            produced["attestations"] = self.produce_attestations(
                state, slot, head, now=now
            )
            # the publisher needs the epoch's committee count to map
            # each vote onto its subnet topic
            epoch = misc.compute_epoch_at_slot(slot, self.spec)
            produced["committees_per_slot"] = self.duties_for_epoch(
                state, epoch
            ).committees_per_slot

        if interval >= 1 and self._fired.get("attest", -1) < slot:
            # an attest due together with the proposal means we are
            # catching up mid-slot (cold boot, stalled tick): the
            # attestations' broadcast deadline is the nearest one, and a
            # block built this late precedes nothing — vote for the
            # current head before proposing.  On the normal timeline the
            # propose-only tick at interval 0 has already fired below.
            attest()
        if self._fired.get("propose", -1) < slot:
            self._fired["propose"] = slot
            block = self.produce_block(state, slot, now=now)
            if block is not None:
                produced["block"] = block
        if interval >= 2 and self._fired.get("aggregate", -1) < slot:
            self._fired["aggregate"] = slot
            produced["aggregates"] = self.produce_aggregates(
                state, slot, now=now
            )
            self.pool.prune(slot)
        return produced
