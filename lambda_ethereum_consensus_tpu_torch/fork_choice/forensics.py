"""Consensus forensics plane: fork-choice decision audit, reorg
post-mortems, and finality-lag decomposition.

The port's copy of the JAX package's ``fork_choice/forensics.py``.  Spans
and counters explain the *machinery*; this module retains the consensus
*decisions* themselves, in three organs, each a bounded ring with O(1)
work per event, like the flight recorder (``tracing.py``):

1. **Head-decision audit** — every COLD ``get_head`` recompute (memo
   hits stay free, see head.py) records the branch points it walked:
   per-candidate attestation weight, the proposer-boost contribution,
   and which stored blocks the viability filter rejected.  On a head
   flip, :meth:`ConsensusForensics.observe_transition` mints a
   :class:`ReorgRecord`: depth, common ancestor, the orphaned chain's
   roots, and a weight-swing attribution — which drained attestation
   batches (joined to their flight-recorder batch ids) and which
   late-arriving blocks (joined to the ``slot_block_arrival_offset_
   seconds`` phase) moved the balance since the previous transition.

2. **Finality-lag decomposition** — a per-epoch tracker splitting the
   justification/finality delay into participation by Altair flag
   (off the head state's ``previous_epoch_participation``) and
   missing votes by committee/subnet (off the EXISTING epoch committee
   tables in ``store.attestation_contexts`` — no extra shuffles), and
   emitting ``finality_lag_epochs``, ``participation_rate{flag}`` and
   ``subnet_missing_votes{subnet}``.

3. **Equivocation-evidence ledger** — double proposals, double votes
   and attester-slashing equivocations retained as structured,
   deduplicated evidence records instead of vanishing into a reject
   counter.

One :class:`ConsensusForensics` instance lives on each node and is
attached to its store as a dynamic attribute (``store.forensics``, like
``store.attestation_contexts``): co-resident nodes in one interpreter
keep their records apart.  Free functions (head.py, handlers.py) reach
the plane via ``getattr(store, "forensics", None)`` so hand-built stores
keep working unchanged.  Everything here runs on the host, over the
store's own structures; the port's context keys carry the context's
device as a third element, so the committee table is found by the key's
epoch alone.

Knobs: ``FORENSICS_RING_CAPACITY`` (entries per ring, default 512)
and ``FORENSICS_OFF`` (disable at construction); ``set_enabled``
flips at runtime, so both polarities can be measured in one process.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..config import constants
from ..state_transition import misc
from ..telemetry import get_metrics

__all__ = [
    "ConsensusForensics",
    "ReorgRecord",
    "DEFAULT_RING_CAPACITY",
    "REORG_DEPTH_BUCKETS",
    "FINALITY_LAG_BUCKETS",
]

DEFAULT_RING_CAPACITY = 512

# Integer-valued histograms: depth in blocks, lag in epochs.  Bounds are
# pinned at plane construction (register_histogram) so the SLO engine's
# quantile estimates land on block/epoch boundaries instead of the
# latency-shaped DEFAULT_BUCKETS.
REORG_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0, 32.0)
FINALITY_LAG_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0, 32.0, 64.0)

_PARTICIPATION_FLAGS = (
    ("source", constants.TIMELY_SOURCE_FLAG_INDEX),
    ("target", constants.TIMELY_TARGET_FLAG_INDEX),
    ("head", constants.TIMELY_HEAD_FLAG_INDEX),
)

_ZERO_ROOT = b"\x00" * 32

_hist_lock = threading.Lock()
_hists_pinned_on: "set[int]" = set()


def _pin_histograms() -> None:
    """Pin the integer bucket bounds once per metrics registry.  A
    registry that already holds observations (a long-lived process that
    emitted before any forensics plane existed) keeps its default
    bounds — quantiles degrade gracefully rather than erroring."""
    m = get_metrics()
    with _hist_lock:
        if id(m) in _hists_pinned_on:
            return
        _hists_pinned_on.add(id(m))
    for name, buckets in (
        ("reorg_depth", REORG_DEPTH_BUCKETS),
        ("finality_lag_epochs", FINALITY_LAG_BUCKETS),
    ):
        try:
            m.register_histogram(name, buckets)
        except ValueError:
            pass


def _hex(root) -> str | None:
    return None if root is None else "0x" + bytes(root).hex()


def _jsonable(value):
    if isinstance(value, (bytes, bytearray)):
        return "0x" + bytes(value).hex()
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (int, float, str, bool)) or value is None:
        return value
    return repr(value)


class _Ring:
    """Bounded overwrite-oldest ring with appended/dropped counters —
    the FlightRecorder containment contract, minus the byte clipping
    (forensic records are small, structured dicts)."""

    __slots__ = ("name", "capacity", "_items", "appended", "dropped")

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        self._items: deque = deque(maxlen=capacity)
        self.appended = 0
        self.dropped = 0

    def append(self, item) -> None:
        if len(self._items) == self.capacity:
            self.dropped += 1
        self.appended += 1
        self._items.append(item)

    def __len__(self) -> int:
        return len(self._items)

    def list(self) -> list:
        return list(self._items)

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "entries": len(self._items),
            "appended_total": self.appended,
            "dropped_total": self.dropped,
        }


@dataclass
class ReorgRecord:
    """One head transition's post-mortem.  ``depth`` counts the blocks
    orphaned off the previous head's chain (0 for a plain fast-forward
    onto a descendant — partitions heal that way, and the healed
    member's record still pins WHERE its stale view forked off via
    ``common_ancestor``).  ``attribution`` lists the weight events
    (drained attestation batches with their trace batch ids, block
    arrivals with their slot-phase offset) observed since the previous
    transition — the evidence for which balance move flipped the
    head."""

    ts: float
    slot: int
    prev_head: str
    new_head: str
    depth: int
    common_ancestor: str | None
    ancestor_slot: int | None
    orphaned: list = field(default_factory=list)
    attribution: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "ts": self.ts,
            "slot": self.slot,
            "prev_head": self.prev_head,
            "new_head": self.new_head,
            "depth": self.depth,
            "common_ancestor": self.common_ancestor,
            "ancestor_slot": self.ancestor_slot,
            "orphaned": list(self.orphaned),
            "attribution": list(self.attribution),
        }


class ConsensusForensics:
    """The per-node consensus audit plane: head-decision audits, reorg
    post-mortems, weight-event attribution, finality decomposition and
    the equivocation-evidence ledger — every organ a bounded ring,
    every hot-path note O(1)."""

    def __init__(self, capacity: int | None = None, enabled: bool | None = None):
        if capacity is None:
            try:
                capacity = int(
                    os.environ.get("FORENSICS_RING_CAPACITY", "")
                    or DEFAULT_RING_CAPACITY
                )
            except ValueError:
                capacity = DEFAULT_RING_CAPACITY
        self._capacity = max(1, capacity)
        if enabled is None:
            enabled = not os.environ.get("FORENSICS_OFF")
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._audits = _Ring("head_audit", self._capacity)
        self._reorgs = _Ring("reorgs", self._capacity)
        self._weight_events = _Ring("weight_events", self._capacity)
        self._evidence = _Ring("evidence", self._capacity)
        self._finality = _Ring("finality", self._capacity)
        self._rings = (
            self._audits, self._reorgs, self._weight_events,
            self._evidence, self._finality,
        )
        # weight-event attribution window: events with seq beyond the
        # previous transition's high-water mark belong to the next
        # ReorgRecord
        self._seq = 0
        self._last_transition_seq = 0
        # evidence dedup + first-seen maps, bounded (FIFO eviction) so a
        # spammy peer cannot grow them for the node's lifetime
        self._evidence_keys: dict = {}
        self._proposals: dict = {}
        self._votes: dict = {}
        self._map_cap = 8 * self._capacity
        self._finality_latest: dict | None = None
        self._last_epoch_observed: int | None = None
        self._drops_exported: dict[str, int] = {}
        if self._enabled:
            _pin_histograms()

    # ------------------------------------------------------------- control

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """Flip the plane at runtime (both polarities can be measured in
        one process; ``FORENSICS_OFF`` only sets the construction
        default)."""
        self._enabled = bool(enabled)
        if self._enabled:
            _pin_histograms()

    def _bound_map(self, mapping: dict) -> None:
        while len(mapping) > self._map_cap:
            mapping.pop(next(iter(mapping)))

    # --------------------------------------------------- head-decision audit

    def note_head_audit(
        self, slot: int, head: bytes, branch_points: list, filtered_out: list
    ) -> None:
        """One cold ``get_head`` recompute's decision record (appended
        by head.get_head — memo hits never reach here)."""
        if not self._enabled:
            return
        record = {
            "ts": time.time(),
            "slot": int(slot),
            "head": _hex(head),
            "branch_points": branch_points,
            "filtered_out": [_hex(r) for r in filtered_out],
        }
        with self._lock:
            self._audits.append(record)

    def last_audit(self) -> dict | None:
        with self._lock:
            items = self._audits.list()
        return items[-1] if items else None

    # ----------------------------------------------- weight-event attribution

    def note_attestation_batch(
        self, batch_id: int | None, path: str, n: int
    ) -> None:
        """One drained attestation batch entered fork choice.
        ``batch_id`` is record_verify_batch's ring id (the join key into
        flight recorder; None when tracing is off or no member trace was
        live)."""
        if not self._enabled:
            return
        with self._lock:
            self._seq += 1
            self._weight_events.append({
                "seq": self._seq,
                "ts": time.time(),
                "kind": "attestation_batch",
                "batch": batch_id,
                "path": path,
                "n": int(n),
            })

    def note_block_arrival(self, root: bytes, slot: int, offset_s: float) -> None:
        """One gossip block arrived; ``offset_s`` is its slot-phase
        arrival offset (the ``slot_block_arrival_offset_seconds``
        sample) — a reorg attributed to a block with a late offset IS
        the late-block post-mortem."""
        if not self._enabled:
            return
        with self._lock:
            self._seq += 1
            self._weight_events.append({
                "seq": self._seq,
                "ts": time.time(),
                "kind": "block_arrival",
                "root": _hex(root),
                "slot": int(slot),
                "offset_s": round(float(offset_s), 6),
            })

    # ------------------------------------------------------ reorg post-mortem

    def observe_transition(self, store, prev: bytes, new: bytes):
        """Mint a :class:`ReorgRecord` for one head flip.  Every
        transition is recorded — depth 0 covers the fast-forward case
        (a healed partition member jumping onto the majority chain
        never orphans anything, but its record still pins the common
        ancestor its stale view forked from).  Returns the record, or
        None when disabled/unknown roots."""
        if not self._enabled or prev == new:
            return None
        blocks = store.blocks
        if prev not in blocks or new not in blocks:
            return None
        # Lowest common ancestor: step whichever side sits at the higher
        # slot to its parent until the walks meet; clamp (ancestor None)
        # if history was pruned below the anchor mid-walk.
        a, b = prev, new
        orphaned: list[bytes] = []
        ancestor: bytes | None = None
        while True:
            if a == b:
                ancestor = a
                break
            sa = int(blocks[a].slot)
            sb = int(blocks[b].slot)
            if sa >= sb:
                orphaned.append(a)
                parent = bytes(blocks[a].parent_root)
                if parent not in blocks:
                    break
                a = parent
            else:
                parent = bytes(blocks[b].parent_root)
                if parent not in blocks:
                    break
                b = parent
        with self._lock:
            attribution = [
                dict(e) for e in self._weight_events.list()
                if e["seq"] > self._last_transition_seq
            ]
            self._last_transition_seq = self._seq
        record = ReorgRecord(
            ts=time.time(),
            slot=int(blocks[new].slot),
            prev_head=_hex(prev),
            new_head=_hex(new),
            depth=len(orphaned),
            common_ancestor=_hex(ancestor),
            ancestor_slot=(
                int(blocks[ancestor].slot) if ancestor is not None else None
            ),
            orphaned=[_hex(r) for r in orphaned],
            attribution=attribution,
        )
        with self._lock:
            self._reorgs.append(record)
        get_metrics().observe("reorg_depth", float(record.depth))
        return record

    def reorgs(self) -> list[dict]:
        with self._lock:
            records = self._reorgs.list()
        return [r.to_dict() for r in records]

    def reorg_count(self) -> int:
        return self._reorgs.appended

    # -------------------------------------------------- finality decomposition

    def observe_epoch(self, store, spec) -> dict | None:
        """One finality-lag decomposition sample, for the node's tick
        loop to call on its FIRST tick and on every epoch change (a
        repeat within one epoch returns the cached sample).  All inputs
        are existing store structures: the O(1) cached head, its state's
        participation lists, and the committee tables the attestation
        verify path already built."""
        if not self._enabled:
            return None
        current_slot = int(store.current_slot(spec))
        current_epoch = int(misc.compute_epoch_at_slot(current_slot, spec))
        if self._last_epoch_observed == current_epoch:
            return self._finality_latest
        self._last_epoch_observed = current_epoch
        finalized_epoch = int(store.finalized_checkpoint.epoch)
        justified_epoch = int(store.justified_checkpoint.epoch)
        lag = max(0, current_epoch - finalized_epoch)
        jlag = max(0, current_epoch - justified_epoch)
        m = get_metrics()

        # participation by Altair flag, off the cached head's state
        participation: dict[str, float] = {}
        head = None
        if store.head_cache is not None:
            head = store.head_cache.head()
        elif store.head_memo is not None:
            head = store.head_memo[1]
        state = store.block_states.get(head) if head is not None else None
        if state is not None and len(state.previous_epoch_participation):
            flags = [int(f) for f in state.previous_epoch_participation]
            n = len(flags)
            for flag_name, idx in _PARTICIPATION_FLAGS:
                hit = sum(1 for f in flags if f & (1 << idx))
                rate = hit / n
                participation[flag_name] = round(rate, 6)
                m.set_gauge("participation_rate", rate, flag=flag_name)

        # missing-vote attribution by committee/subnet, off the newest
        # committee table the attestation path already built (no extra
        # shuffle — an idle store with no contexts simply reports {})
        subnet_missing: dict[str, int] = {}
        ctx_epoch = None
        if store.attestation_contexts:
            # keyed (epoch, root, device): the newest epoch's table
            key, ctx = max(
                store.attestation_contexts.items(), key=lambda kv: kv[0][0]
            )
            ctx_epoch = key[0]
            voted = {
                i for i, lm in store.latest_messages.items()
                if int(lm.epoch) >= ctx_epoch
            }
            cps = int(ctx.committees_per_slot)
            n_committees = len(ctx.lengths)
            for cid in range(n_committees):
                length = int(ctx.lengths[cid])
                if not length:
                    continue
                slot = int(ctx.start_slot) + cid // cps
                index = cid % cps
                subnet = int(
                    misc.compute_subnet_for_attestation(cps, slot, index, spec)
                )
                missing = sum(
                    1 for v in ctx.committees[cid, :length] if int(v) not in voted
                )
                key = str(subnet)
                subnet_missing[key] = subnet_missing.get(key, 0) + missing
            for key, count in subnet_missing.items():
                m.set_gauge("subnet_missing_votes", float(count), subnet=key)

        record = {
            "kind": "epoch",
            "ts": time.time(),
            "epoch": current_epoch,
            "slot": current_slot,
            "finalized_epoch": finalized_epoch,
            "justified_epoch": justified_epoch,
            "finality_lag_epochs": lag,
            "justification_lag_epochs": jlag,
            "participation": participation,
            "subnet_missing_votes": subnet_missing,
            "committee_table_epoch": ctx_epoch,
        }
        with self._lock:
            self._finality.append(record)
            self._finality_latest = record
        m.observe("finality_lag_epochs", float(lag))
        return record

    def note_finalized(self, epoch: int, root: bytes) -> None:
        """A finalized-checkpoint advance (handlers.update_checkpoints)
        — the event that RESETS the lag the per-epoch samples measure."""
        if not self._enabled:
            return
        with self._lock:
            self._finality.append({
                "kind": "finalized",
                "ts": time.time(),
                "epoch": int(epoch),
                "root": _hex(root),
            })

    def note_justified(self, epoch: int, root: bytes) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._finality.append({
                "kind": "justified",
                "ts": time.time(),
                "epoch": int(epoch),
                "root": _hex(root),
            })

    def finality_view(self) -> dict:
        with self._lock:
            latest = self._finality_latest
            history = self._finality.list()
        return {"latest": latest, "history": history}

    # ------------------------------------------------ equivocation evidence

    def _mint_evidence(self, kind: str, key: tuple, detail: dict):
        """Dedup + append under the lock; metric inc outside it."""
        with self._lock:
            if key in self._evidence_keys:
                return None
            self._evidence_keys[key] = True
            self._bound_map(self._evidence_keys)
            record = {"kind": kind, "ts": time.time(), **detail}
            self._evidence.append(record)
        get_metrics().inc("forensics_evidence_total", kind=kind)
        return record

    def note_block(self, root: bytes, slot: int, proposer: int):
        """Every accepted block (handlers.on_block).  A second DISTINCT
        root for one ``(slot, proposer)`` cell is a double proposal."""
        if not self._enabled:
            return None
        cell = (int(slot), int(proposer))
        root = bytes(root)
        with self._lock:
            first = self._proposals.get(cell)
            if first is None:
                self._proposals[cell] = root
                self._bound_map(self._proposals)
                return None
        if first == root:
            return None
        return self._mint_evidence(
            "double_proposal",
            ("double_proposal", cell, root),
            {
                "slot": cell[0],
                "proposer": cell[1],
                "roots": [_hex(first), _hex(root)],
            },
        )

    def note_vote(self, cell: tuple, root: bytes):
        """Every admitted single-bit subnet vote, keyed by its dedup
        cell ``(slot, committee index, bit, discriminator)``.  The drain
        IGNOREs duplicate cells — correct for fork choice, but a
        duplicate carrying a DIFFERENT beacon block root is a double
        vote and must survive as evidence rather than vanish into the
        ignore counter."""
        if not self._enabled:
            return None
        root = bytes(root)
        with self._lock:
            first = self._votes.get(cell)
            if first is None:
                self._votes[cell] = root
                self._bound_map(self._votes)
                return None
        if first == root:
            return None
        return self._mint_evidence(
            "double_vote",
            ("double_vote", cell, root),
            {
                "cell": _jsonable(list(cell)),
                "roots": [_hex(first), _hex(root)],
            },
        )

    def note_attester_slashing(self, equivocators) -> None:
        """One on-chain attester slashing's equivocating index set
        (handlers.on_attester_slashing)."""
        if not self._enabled or not equivocators:
            return
        indices = tuple(sorted(int(i) for i in equivocators))
        self._mint_evidence(
            "attester_slashing",
            ("attester_slashing", indices),
            {"indices": list(indices)},
        )

    def evidence(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._evidence.list()]

    def evidence_count(self, kind: str | None = None) -> int:
        with self._lock:
            records = self._evidence.list()
        if kind is None:
            return len(records)
        return sum(1 for r in records if r["kind"] == kind)

    # -------------------------------------------------------------- export

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self._enabled,
                "capacity": self._capacity,
                "rings": {r.name: r.stats() for r in self._rings},
            }

    def export_ring_drops(self, metrics) -> None:
        """Counter-delta export of per-ring drop counts into
        ``forensics_ring_dropped_total{ring}`` — cursors live on THIS
        instance so co-resident fleet members never double-count.
        Cursors only advance when the inc actually records (a disabled
        registry must not silently consume the delta)."""
        if not getattr(metrics, "enabled", False):
            return
        deltas = {}
        with self._lock:
            for ring in self._rings:
                prev = self._drops_exported.get(ring.name, 0)
                if ring.dropped > prev:
                    deltas[ring.name] = ring.dropped - prev
                    self._drops_exported[ring.name] = ring.dropped
        for name, delta in deltas.items():
            metrics.inc("forensics_ring_dropped_total", value=delta, ring=name)

    def forkchoice_view(self, store, spec) -> dict:
        """The weighted DAG snapshot: every block in the O(1) head-cache
        tree with its cached subtree weight, plus the latest cold-walk
        audit — WITHOUT forcing an uncached LMD-GHOST recompute (reads of
        live dicts are snapshot-copied)."""
        from .head import head_candidates

        nodes = []
        cache = store.head_cache
        if cache is not None:
            tree = cache.tree
            for root, node in list(tree._nodes.items()):
                block = store.blocks.get(root)
                nodes.append({
                    "root": _hex(root),
                    "parent": _hex(node.parent),
                    "slot": int(block.slot) if block is not None else None,
                    "weight": int(node.subtree_weight),
                    "best_descendant": _hex(node.best_descendant),
                })
            cached_head = _hex(cache.head())
        else:
            cached_head = None
        return {
            "nodes": nodes,
            "tree_head": cached_head,
            "justified": _hex(bytes(store.justified_checkpoint.root)),
            "finalized": _hex(bytes(store.finalized_checkpoint.root)),
            "proposer_boost": (
                _hex(bytes(store.proposer_boost_root))
                if bytes(store.proposer_boost_root) != _ZERO_ROOT else None
            ),
            "head_memo": head_candidates(store, spec),
            "stats": self.stats(),
        }
