"""Causal tracing: per-item ingest traces, a flight-recorder ring, and
slot-phase delay metrics.

The port's copy of the JAX package's ``tracing.py``, whole:

- **Item traces** (:func:`new_trace` / :class:`ItemTrace`): one trace
  context minted per gossip message at admission and threaded through the
  pipeline, recording ``admit`` (begin), ``enqueue``, ``dequeue``,
  ``verify``, ``apply`` and a terminal event — ``done`` with the final
  verdict, or ``shed``/``decode_error``/``flush_error`` with the reason.
- **Flight recorder** (:class:`FlightRecorder`): a bounded ring buffer
  of trace events — fixed memory (``TRACE_RECORDER_CAPACITY`` entries,
  overwrite-oldest), thread-safe, and a TRUE no-op under
  ``TELEMETRY_OFF`` (one attribute check per call, zero allocations).
  Exportable as Chrome/Perfetto trace-event JSON (:meth:`FlightRecorder.chrome`);
  :func:`merge_chrome_traces` joins per-node exports into one document.
- **Batch fan-in** (:func:`record_verify_batch`): one batched verify
  span links back to its N member item traces — the span carries the
  member trace ids, each member records the batch id — so "which drain
  flush verified this vote, with whom, and how long did the batch take"
  is one Perfetto click.  ``fork_choice.on_attestation_batch`` calls it
  with the drain's ``traces``.
- **Slot-phase clock** (:class:`SlotClock`): pure slot/offset/interval
  math from ``genesis_time``/``SECONDS_PER_SLOT`` — what the duty
  scheduler fires its phases by — plus the observers of the slot-phase
  histograms: a block's arrival offset into its slot and the head-update
  delay after its slot's start, with half-second slot-shaped buckets
  (``SLOT_PHASE_BUCKETS``); the admission→apply latency
  (``attestation_admit_apply_seconds``, recorded by the fan-in) keeps the
  default log-spaced latency bounds.

The recorder is this package's own process singleton (:func:`get_recorder`)
and shares the telemetry polarity (``TELEMETRY_OFF``), so the whole
observability surface turns off with ONE flag; it flips at runtime via
:meth:`FlightRecorder.set_enabled`.  Nothing here touches the device: the
timestamps are host monotonic instants around the device work.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from collections import deque

from .telemetry import get_metrics, telemetry_enabled

__all__ = [
    "DEFAULT_RECORDER_CAPACITY",
    "SLOT_PHASE_BUCKETS",
    "FlightRecorder",
    "ItemTrace",
    "SlotClock",
    "get_recorder",
    "merge_chrome_traces",
    "new_trace",
    "record_verify_batch",
    "observe_block_arrival",
    "observe_head_update",
]

# Process-row label for events recorded without a node dimension — the
# single-node default, and the pid-1 row of every export.
DEFAULT_NODE = "beacon-node"

# Ring capacity in ENTRIES: one entry per TERMINATED item trace (its
# whole buffered walk rides in one composite slot), per batch span, per
# global instant.  The default window therefore holds the last ~16k
# items end to end — minutes of mainnet ingest.  Worst-case memory is
# still bounded by construction (entries x the per-trace event cap x
# clipped arg strings ≈ tens of MB at the default; size
# TRACE_RECORDER_CAPACITY down for tighter budgets).
DEFAULT_RECORDER_CAPACITY = 16384

# Slot-phase delay buckets: the default telemetry bounds are log-spaced
# for 100 us..105 s latencies and would fold a whole 12 s slot into two
# buckets.  Half-second steps across a mainnet slot keep "arrived in the
# attestation interval" vs "arrived at the deadline" resolvable, with a
# short geometric tail for late/catch-up outliers.
SLOT_PHASE_BUCKETS = tuple(0.5 * i for i in range(1, 25)) + (16.0, 24.0, 48.0, 96.0)

_SLOT_PHASE_FAMILIES = (
    "slot_block_arrival_offset_seconds",
    "head_update_delay_seconds",
)

# the admission->apply histogram's precomputed (name, labels) key: the
# per-accepted-item site in record_verify_batch observes through
# Metrics._observe_key (the span-exit fast path) so the per-call label
# sort is skipped without re-implementing histogram internals here
_ADMIT_APPLY_KEY = ("attestation_admit_apply_seconds", ())

# args strings are truncated at this length before entering the ring so
# "bounded by capacity" means bounded BYTES, not just bounded count
_MAX_ARG_CHARS = 200

# per-trace event cap: an item's full pipeline walk is ~6 events, so 24
# bounds a pathological re-queue loop without ever touching a real trace
_MAX_TRACE_EVENTS = 24


def _clip_args(args: dict | None) -> dict | None:
    """Clip oversized string args; returns ``args`` UNCHANGED (no copy)
    when nothing exceeds the limit — the hot-path common case."""
    if not args:
        return None
    for v in args.values():
        if type(v) is str and len(v) > _MAX_ARG_CHARS:
            return {
                k: (v[:_MAX_ARG_CHARS] if type(v) is str else v)
                for k, v in args.items()
            }
    return args


class FlightRecorder:
    """Bounded ring buffer of trace entries (overwrite-oldest).

    Entries are compact tuples ``(ts_us, kind, trace_id, name, dur_us,
    args, node)``: ``span`` is a complete batch-scoped slice with duration,
    ``trace_id`` 0 marks a global instant (degraded flips, drain
    restarts), and ``item`` is one COMPOSITE terminated item trace —
    its buffered ``(monotonic, name, args)`` stage events ride in the
    last slot and are expanded back into ``begin``/``inst``/``end``
    events at export.  Item traces buffer locally and land here in ONE
    append at termination: the hot path pays list appends, not a lock +
    ring append per stage; the trade is that a trace becomes visible
    when it TERMINATES, not while its item is in flight.
    Memory is bounded by construction: the deque's ``maxlen`` is the
    capacity, per-trace events are capped, and oversized strings are
    clipped."""

    __slots__ = ("_enabled", "_lock", "_events", "_capacity", "_appended",
                 "_dropped", "_ids")

    def __init__(self, capacity: int | None = None, enabled: bool | None = None):
        if capacity is None:
            try:
                capacity = int(
                    os.environ.get("TRACE_RECORDER_CAPACITY", "")
                    or DEFAULT_RECORDER_CAPACITY
                )
            except ValueError:
                capacity = DEFAULT_RECORDER_CAPACITY
        self._capacity = max(1, capacity)
        self._events: deque = deque(maxlen=self._capacity)
        self._enabled = telemetry_enabled() if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        self._appended = 0
        self._dropped = 0
        self._ids = itertools.count(1)  # next() is GIL-atomic

    # ------------------------------------------------------------- control

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """Flip recording at runtime (both polarities can be measured in
        one process; the env flag only sets the default)."""
        self._enabled = bool(enabled)

    def new_id(self) -> int:
        """A process-unique trace/batch id."""
        return next(self._ids)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # ----------------------------------------------------------- recording

    def record(
        self,
        kind: str,
        trace_id: int,
        name: str,
        args: dict | None = None,
        ts_us: int | None = None,
        dur_us: int | None = None,
        node: str | None = None,
    ) -> None:
        if not self._enabled:
            return
        if ts_us is None:
            ts_us = int(time.monotonic() * 1e6)
        args = _clip_args(args)
        with self._lock:
            if len(self._events) == self._capacity:
                self._dropped += 1
            self._appended += 1
            self._events.append((ts_us, kind, trace_id, name, dur_us, args, node))

    # composite item entries are appended by ItemTrace.end (inlined
    # there — the hot path's one ring touch per terminated item)

    # -------------------------------------------------------------- access

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._capacity,
                "events": len(self._events),
                "appended_total": self._appended,
                "dropped_total": self._dropped,
                "enabled": self._enabled,
            }

    def snapshot(self) -> list[dict]:
        """Flat events as dicts, ring order, with composite item
        entries expanded into ``begin``/``inst``/``end`` (test/debug
        access — the same expansion :meth:`chrome` renders)."""
        with self._lock:
            events = list(self._events)
        out = []
        for ts, kind, tid, name, dur, args, node in events:
            if kind != "item":
                out.append({"ts_us": ts, "kind": kind, "trace_id": tid,
                            "name": name, "dur_us": dur, "args": args,
                            "node": node})
                continue
            out.append({"ts_us": ts, "kind": "begin", "trace_id": tid,
                        "name": name, "dur_us": None, "args": None,
                        "node": node})
            for tm, ev_name, ev_args in args:
                if ev_name is _END:
                    # terminal events store (stage, shared_args): merge
                    # here, on the cold export path
                    stage, extra = ev_args
                    merged = {"stage": stage}
                    if extra:
                        merged.update(extra)
                    out.append({
                        "ts_us": int(tm * 1e6), "kind": "end",
                        "trace_id": tid, "name": name,
                        "dur_us": None, "args": merged, "node": node,
                    })
                else:
                    out.append({
                        "ts_us": int(tm * 1e6), "kind": "inst",
                        "trace_id": tid, "name": ev_name,
                        "dur_us": None, "args": ev_args, "node": node,
                    })
        return out

    def chrome(self, node: str | None = None) -> dict:
        """The ring as Chrome trace-event JSON (Perfetto-loadable).

        Item events render as nestable async slices keyed by trace id
        (``ph`` b/n/e share ``cat``+``id``); batch verify spans render
        as complete ``X`` slices on their own track, carrying member
        trace ids in ``args`` (the fan-in link — each member's
        ``verify`` instant carries the matching ``batch`` id); global
        events (trace id 0) render as scoped instants.  A trace whose
        ``begin`` was overwritten by the ring still exports its
        surviving events — Perfetto tolerates orphan async events.

        Every event lands on its node's OWN process row — the
        pid is a stable crc32 derivation of the node label (so two
        nodes' independent exports agree and a fleet merge never
        collides rows), node-less events keep the historical pid-1
        "beacon-node" row, and ``flow_s``/``flow_f`` entries render as
        Perfetto flow arrows (``ph`` s/f sharing a global id) linking a
        publish on the origin's row to the remote admit on the
        receiver's.  ``node=`` filters the export to one node's events
        (the per-member view the fleet aggregator scrapes)."""
        events = self.snapshot()
        if node is not None:
            events = [
                ev for ev in events
                if (ev.get("node") or DEFAULT_NODE) == node
            ]
        pids = _assign_pids({ev.get("node") for ev in events})
        out = [
            {"ph": "M", "name": "process_name", "pid": pid,
             "args": {"name": label if label is not None else DEFAULT_NODE}}
            for label, pid in sorted(
                pids.items(), key=lambda kv: kv[1]
            )
        ]
        ph_of = {"begin": "b", "inst": "n", "end": "e"}
        for ev in events:
            ts, kind, tid, name = (
                ev["ts_us"], ev["kind"], ev["trace_id"], ev["name"]
            )
            pid = pids[ev.get("node")]
            if kind == "span":
                e = {"ph": "X", "ts": ts, "dur": ev["dur_us"] or 1, "pid": pid,
                     "tid": "batch_verify", "name": name, "cat": "batch"}
            elif kind in ("flow_s", "flow_f"):
                # cross-node propagation arrow: origin publish (s) ->
                # remote admit (f); both ends share the global flow id
                e = {"ph": "s" if kind == "flow_s" else "f", "ts": ts,
                     "pid": pid, "tid": "gossip", "cat": "gossip_flow",
                     "id": (ev["args"] or {}).get("flow", format(tid, "x")),
                     "name": name}
                if kind == "flow_f":
                    e["bp"] = "e"  # bind to the enclosing slice's end
            elif tid == 0:  # global instant (no owning trace)
                e = {"ph": "i", "ts": ts, "pid": pid, "tid": "events",
                     "name": name, "s": "g"}
            else:  # item stage event (nestable async, keyed by trace id)
                e = {"ph": ph_of.get(kind, "n"), "ts": ts, "pid": pid,
                     "cat": "item", "id": format(tid, "x"), "name": name}
            if ev["args"]:
                e["args"] = ev["args"]
            out.append(e)
        return {"traceEvents": out, "displayTimeUnit": "ms"}


def _assign_pids(nodes) -> dict:
    """Stable pid per node label.  ``None`` (node-less events) keeps the
    historical pid 1; named nodes hash their label (crc32) into a wide
    pid space so INDEPENDENT exports — two nodes each exporting their
    own ring — assign the same pid to the same node and a fleet merge
    needs no renumbering.  Same-export collisions probe upward
    deterministically (sorted label order)."""
    pids = {None: 1}
    used = {1}
    for label in sorted(n for n in nodes if n is not None):
        pid = 2 + (zlib.crc32(label.encode()) % 1_000_000)
        while pid in used:
            pid += 1
        pids[label] = pid
        used.add(pid)
    return pids


def merge_chrome_traces(docs) -> dict:
    """Merge per-node Chrome exports into ONE fleet document.

    Because :meth:`FlightRecorder.chrome` derives pids from node labels
    (not process-local counters), a merge is a concatenation: process
    rows stay distinct per node, duplicate ``process_name`` metadata
    (the same node scraped twice, or pid-1 rows from several members)
    collapses to one, and cross-node flow arrows — whose global ids the
    wire trace context carried — connect across the member documents."""
    events: list = []
    seen_meta: set = set()
    for doc in docs:
        for ev in (doc or {}).get("traceEvents", ()):
            if ev.get("ph") == "M":
                key = (ev.get("pid"), ev.get("name"),
                       str((ev.get("args") or {}).get("name")))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# sentinel marking a trace's terminal buffered event (identity-compared
# at export; a private object() so no caller-supplied event name — not
# even the same literal — can ever be misread as a terminal entry)
_END = object()


class ItemTrace:
    """One gossip item's causal trace: a handle the pipeline threads
    from admission to termination.  Minted by :func:`new_trace` (which
    returns ``None`` when tracing is off, so every downstream site is a
    single ``is not None`` check); ``t0`` is the monotonic admission
    instant the admission→apply latency is measured from.

    Stage events buffer on the trace (bounded list appends — no lock,
    no ring traffic) and the whole walk lands in the flight recorder as
    ONE entry when the trace terminates."""

    __slots__ = ("trace_id", "label", "t0", "node", "_rec", "_ev", "_done")

    def __init__(
        self,
        rec: FlightRecorder,
        trace_id: int,
        label: str,
        t0: float,
        node: str | None = None,
    ):
        self._rec = rec
        self.trace_id = trace_id
        self.label = label
        self.t0 = t0
        self.node = node
        self._ev: list = []
        self._done = False

    def event(self, name: str, **args) -> None:
        """An intermediate stage event (``enqueue``, ``dequeue``,
        ``verify``, ``apply``, ...)."""
        if not self._done and len(self._ev) < _MAX_TRACE_EVENTS:
            self._ev.append((time.monotonic(), name, _clip_args(args)))

    def note(self, name: str, args: dict | None = None, ts: float | None = None) -> None:
        """:meth:`event` without the kwargs repack — ``args`` may be a
        prebuilt dict SHARED across a whole batch's traces, and ``ts``
        a monotonic instant read ONCE per batch (the flush / fan-in hot
        loops use both; callers must not mutate a shared dict after)."""
        if not self._done and len(self._ev) < _MAX_TRACE_EVENTS:
            self._ev.append(
                (time.monotonic() if ts is None else ts, name, args)
            )

    def end(self, stage: str, args: dict | None = None, ts: float | None = None) -> None:
        """Terminate the trace: ``stage`` names why (``done``, ``shed``,
        ``decode_error``, ``flush_error``), ``args`` carries the reason/
        verdict (may be a dict SHARED across items — it is stored, not
        mutated).  Idempotent — the first termination wins, so a shed
        item whose verdict still gets dispatched never double-ends.
        Flushes the buffered walk into the recorder ring."""
        if self._done:
            return
        self._done = True
        self._ev.append((
            time.monotonic() if ts is None else ts,
            _END,
            (stage, _clip_args(args)),
        ))
        # inlined record_trace: every terminated item pays this once,
        # and the method hop costs as much as the lock on this path
        rec = self._rec
        if rec._enabled:
            with rec._lock:
                if len(rec._events) == rec._capacity:
                    rec._dropped += 1
                rec._appended += 1
                rec._events.append((
                    int(self.t0 * 1e6), "item", self.trace_id, self.label,
                    None, self._ev, self.node,
                ))


# ------------------------------------------------------- default recorder

_RECORDER: FlightRecorder | None = None
_RECORDER_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _RECORDER
    rec = _RECORDER
    if rec is None:
        with _RECORDER_LOCK:
            rec = _RECORDER
            if rec is None:
                rec = _RECORDER = FlightRecorder()
    return rec


def new_trace(label: str, node: str | None = None) -> ItemTrace | None:
    """Mint one item trace at gossip admission.  The admission instant
    (``t0``) and label become the trace's ``begin`` event when the
    composite entry lands in the ring at termination.  ``node`` places
    the trace on that node's process row at export (in-process fleets
    share one recorder; the label keeps their walks apart).  Returns
    ``None`` when tracing is off: the hot path pays one module-global
    read and one attribute check, nothing else."""
    rec = _RECORDER
    if rec is None:
        rec = get_recorder()
    if not rec._enabled:
        return None
    return ItemTrace(rec, next(rec._ids), label, time.monotonic(), node)


def record_verify_batch(
    traces, errors, path: str, t0: float, dur_s: float,
    span_name: str = "attestation_batch_verify",
    n_devices: int = 1,
) -> int | None:
    """Fan-in bookkeeping for ONE batched verify over many item traces.

    Records the batch span (a ``span`` slice carrying the member trace
    ids), a ``verify`` event on every member with the batch id (the
    reverse link), then each item's outcome — ``apply`` plus the
    admission→apply latency histogram for accepted items, ``drop`` with
    the error string for rejected ones.  ``errors`` is one ``None``
    (accepted) or error per trace position; ``t0`` is monotonic seconds.
    ``n_devices`` is the number of devices the verify dispatched over
    (1 for the single-card chain, the port's only one) — the batch span
    carries it, as the JAX package's does.
    Returns the batch id (None when no live trace was in the batch)."""
    members = [t for t in traces if t is not None]
    if not members:
        return None
    rec = get_recorder()
    batch_id = verify_args = None
    if rec._enabled:
        batch_id = rec.new_id()
        rec.record(
            "span", batch_id, span_name,
            args={
                "path": path, "n": len(errors), "n_devices": n_devices,
                # clip the link list so one 8k-item flush cannot occupy
                # a large slice of the ring's byte budget by itself
                "members": [t.trace_id for t in members[:128]],
                "n_members": len(members),
            },
            ts_us=int(t0 * 1e6), dur_us=max(int(dur_s * 1e6), 1),
            node=members[0].node,
        )
        # ONE reverse-link dict shared by every member's verify event
        verify_args = {"batch": batch_id, "path": path}
    m = get_metrics()
    m_on = m._enabled
    now = time.monotonic()
    for t, err in zip(traces, errors):
        if t is None:
            continue
        if verify_args is not None:
            t.note("verify", verify_args, now)
        if err is None:
            t.note("apply", None, now)
            if m_on:
                # precomputed key: skips the per-call label sort the
                # generic observe() pays (this runs once per accepted
                # item in an up-to-8k flush)
                m._observe_key(_ADMIT_APPLY_KEY, now - t.t0)
        else:
            t.event("drop", reason=str(err))
    return batch_id


# ------------------------------------------------------- slot-phase clock

class SlotClock:
    """Pure slot/offset/interval math from the chain's genesis time.

    Pre-genesis instants map to NEGATIVE slots (floor division), with
    the offset still normalized into ``[0, seconds_per_slot)`` — so
    delay math is total and a node booted before genesis never divides
    by zero or wraps.  ``intervals_per_slot`` splits a slot into the
    spec's sub-phases (propose / attest / aggregate at
    ``INTERVALS_PER_SLOT = 3``)."""

    __slots__ = ("genesis_time", "seconds_per_slot", "intervals_per_slot")

    def __init__(
        self,
        genesis_time: int,
        seconds_per_slot: int,
        intervals_per_slot: int = 3,
    ):
        if seconds_per_slot <= 0 or intervals_per_slot <= 0:
            raise ValueError("seconds_per_slot/intervals_per_slot must be >= 1")
        self.genesis_time = int(genesis_time)
        self.seconds_per_slot = int(seconds_per_slot)
        self.intervals_per_slot = int(intervals_per_slot)

    def slot_at(self, t: float) -> int:
        """Slot containing wall-clock ``t`` (negative before genesis)."""
        return int((t - self.genesis_time) // self.seconds_per_slot)

    def slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def offset_into_slot(self, t: float) -> float:
        """Seconds since the containing slot's start, in ``[0, sps)`` —
        exact boundaries land at 0.0 of the NEW slot."""
        return t - self.slot_start(self.slot_at(t))

    def interval_at(self, t: float) -> int:
        """Sub-phase index in ``[0, intervals_per_slot)``."""
        off = self.offset_into_slot(t)
        return min(
            int(off * self.intervals_per_slot // self.seconds_per_slot),
            self.intervals_per_slot - 1,
        )

    def phase(self, t: float) -> dict:
        """The ``/debug/slot`` summary shape for instant ``t``."""
        slot = self.slot_at(t)
        return {
            "slot": slot,
            "offset_s": round(t - self.slot_start(slot), 4),
            "interval": self.interval_at(t),
            "pre_genesis": t < self.genesis_time,
            "seconds_per_slot": self.seconds_per_slot,
            "intervals_per_slot": self.intervals_per_slot,
            "genesis_time": self.genesis_time,
        }


def _register_slot_histograms(metrics) -> None:
    """Pin the slot-shaped bucket bounds before the first observe.  The
    already-done guard is keyed on the registry INSTANCE (its bucket
    table), not a module global, so a swapped/recreated default registry
    — tests do this — gets the slot-shaped bounds again instead of
    silently falling through to the log-latency defaults."""
    if _SLOT_PHASE_FAMILIES[0] in metrics._buckets:
        return
    for name in _SLOT_PHASE_FAMILIES:
        try:
            metrics.register_histogram(name, SLOT_PHASE_BUCKETS)
        except ValueError:
            pass  # racing caller pinned them, or observations exist


def _observe_slot_delay(
    family: str, clock: SlotClock, slot: int, now: float | None
) -> float:
    """Shared slot-phase observation: seconds from ``slot``'s start to
    ``now``, clamped at 0 (an item early relative to the local clock
    would otherwise make the histogram uninterpretable as lateness)."""
    m = get_metrics()
    if now is None:
        now = time.time()
    delay = max(0.0, now - clock.slot_start(int(slot)))
    if m._enabled:
        _register_slot_histograms(m)
        m.observe(family, delay)
    return delay


def observe_block_arrival(clock: SlotClock, block_slot: int, now: float | None = None) -> float:
    """Record a gossip block's arrival offset into ITS slot."""
    return _observe_slot_delay(
        "slot_block_arrival_offset_seconds", clock, block_slot, now
    )


def observe_head_update(clock: SlotClock, head_slot: int, now: float | None = None) -> float:
    """Record how far after its slot's start the fork-choice head moved
    to a block at ``head_slot``."""
    return _observe_slot_delay("head_update_delay_seconds", clock, head_slot, now)
