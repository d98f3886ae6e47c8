"""Observability subsystem: counters, gauges, log-bucketed histograms,
spans, and full Prometheus text exposition.

Grown from the flat counter/gauge registry that mirrored the reference's
``telemetry.ex`` (ref: lib/.../telemetry.ex:56-80) into the substrate the
performance work reports against:

- **Histograms** are log-bucketed (factor-2 geometric bounds, 100 us to
  ~100 s by default) and rendered with the real exposition contract —
  ``# HELP``/``# TYPE`` headers, cumulative ``_bucket{le=...}`` series,
  ``_sum``/``_count``, and label-value escaping — so the stock
  ``metrics/prometheus.yml`` scrape ingests them directly.
- **Spans** (``with metrics.span("fork_choice_on_block"): ...``) time a
  region into the ``<name>_seconds`` histogram and emit one structured
  ``slow_op`` log line when a region exceeds its threshold
  (``TELEMETRY_SLOW_OP_S``, default 1 s, or per-span override).  Latency
  *distributions*, not averages, are what committee-based-consensus
  signature cost is dominated by (arxiv 2302.00418) — p99 per span is the
  dashboard contract.
- **No-op mode** (``TELEMETRY_OFF=1``, or ``Metrics(enabled=False)``):
  every recording call returns after one attribute check, ``span()``
  returns a shared inert context manager, and no metric keys are ever
  created — the hot paths keep their instrumentation at roughly the cost
  of a dict lookup.

The port's copy of the JAX package's ``telemetry.py``: the same registry,
spans and exposition, recorded and rendered identically.  Its device-fault
health latch (``device_fault``, ``device_fault_state``) is not carried
over: in the port a device fault raises out of the path it hit and is
never counted and retried on the host.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from bisect import bisect_left
from collections import defaultdict

from .utils.env import env_flag

__all__ = [
    "DEFAULT_BUCKETS",
    "BoundSpan",
    "Metrics",
    "get_metrics",
    "inc",
    "observe",
    "scrape_stats_lines",
    "set_gauge",
    "span",
    "telemetry_enabled",
]

log = logging.getLogger("telemetry")

# Factor-2 geometric bucket bounds, 100 us .. ~105 s: one allocation-free
# bisect per observe, and every latency from a warm dict hit to a cold
# kernel build lands in a resolvable bucket.
DEFAULT_BUCKETS = tuple(1e-4 * 2.0**i for i in range(21))

# Help strings for the metric inventory (the JAX package's, less the
# families of its compile cache and sharded plane; the device-memory and
# cost-observatory families read the CUDA allocator and the kernels' cost
# table).
# Unlisted names fall back to the metric name so exposition always carries
# a HELP line per family.
_HELP = {
    "network_request_count": "req/resp requests by result/type",
    "network_gossip_count": "gossip messages seen per topic type",
    "peers_connection_count": "currently connected peers",
    "sync_store_slot": "latest applied block slot",
    "fork_choice_head_slot": "slot of the cached fork-choice head",
    "sidecar_restarts": "network sidecar crash-restarts",
    "gossip_batch_error_count": "gossip items dropped by internal errors",
    "gossip_queue_depth": "queued gossip messages at drain start",
    "gossip_drain_seconds": "one gossip batch: decode + verify + verdicts",
    "gossip_shed_count": "gossip messages dropped at admission, by topic/reason",
    "ingest_lane_depth": "queued items per ingest scheduler lane",
    "ingest_lane_occupancy": "lane depth over lane capacity (0..1)",
    "ingest_shed_count": "items shed by the ingest scheduler, by lane/reason",
    "ingest_flush_count": "lane flushes by trigger (full|deadline)",
    "ingest_flush_error_count": "items lost to a raising lane flush",
    "ingest_loop_crash_count": "supervised restarts of the ingest drain loop",
    "ingest_batch_size": "items per handler call out of the scheduler",
    "ingest_flush_wait_seconds": "oldest-item queue wait at lane flush",
    "ingest_sched_seconds": "one scheduling round's bookkeeping (no handler time)",
    "ingest_degraded": "1 while the load-shedding latch is active",
    "attestation_batch_verify_seconds": "one batched attestation signature check",
    "block_transition_seconds": "full state transition of one block (slots + block + state-root check)",
    "epoch_transition_seconds": "one epoch-boundary processing pass (resident or host path)",
    "resident_plane_validators": "validators held as resident device columns by the transition plane",
    "resident_plane_sync_elems": "cumulative per-epoch delta elements scattered to the resident columns",
    "fork_choice_head_recompute_seconds": "uncached LMD-GHOST head walk",
    "ssz_hash_tree_root_seconds": "top-level SSZ Merkleization root",
    "sidecar_roundtrip_seconds": "one sidecar command round-trip",
    "device_live_arrays": "live device allocations (the CUDA caching allocator's active blocks)",
    "device_plane_bytes": "retained bytes per accounted memory plane (sharded is always 0; unattributed = torch.cuda.memory_allocated() minus the device planes; host planes report outside that arithmetic)",
    "device_plane_bytes_watermark": "high watermark of total allocated device bytes",
    "ops_entry_flops_total": "SASS-counted thread-instructions dispatched per CUDA kernel",
    "ops_entry_bytes_total": "bytes moved per CUDA kernel (inputs read once, outputs written once)",
    "ops_entry_roofline_ratio": "achieved/peak roofline ratio per kernel (max of compute and memory fractions)",
    "profile_captures_total": "on-demand torch.profiler capture attempts, by result",
    "profile_capture_seconds": "wall time of one on-demand profiler capture window",
    "registry_plane_resident_bytes": "device bytes of shared registry planes",
    "registry_plane_uploaded_cols": "registry columns shipped host->device",
    "registry_plane_stores": "live per-chain registry plane stores",
    "attestation_context_count": "live store-keyed epoch attestation contexts",
    "state_attestation_context_count": "live state-keyed epoch attestation contexts",
    "attestation_context_evictions_count": "epoch-LRU context evictions",
    "checkpoint_cache_pruned_count": "checkpoint states/contexts pruned on finality",
    "warmup_phase_seconds": "background warmer phase wall time by phase",
    "api_request_seconds": "beacon API handler latency by route",
    "witness_request_seconds": "witness API handler latency by route (proof|verify)",
    "witness_verify_seconds": "one batched multiproof verification (host or device plane)",
    "witness_verified_total": "multiproofs verified by the witness plane, by result",
    "witness_proof_bytes_total": "witness proof bytes served by the proof route",
    "serve_cache_hit_total": "serving-cache hits, by cache layer and route kind",
    "serve_cache_miss_total": "serving-cache misses, by cache layer and route kind",
    "serve_cache_entries": "entries resident per serving cache",
    "serve_cache_bytes": "accounted payload bytes resident per serving cache",
    "serve_cache_evictions_total": "serving-cache epoch-LRU evictions at the count/byte bound",
    "serve_cache_invalidations_total": "serving-cache entries evicted by invalidation, by reason",
    "serve_coalesce_flush_total": "witness-verify coalescer flushes, by trigger (target|deadline)",
    "serve_coalesce_proofs_total": "proofs dispatched through coalesced verify flushes",
    "serve_coalesce_requests_total": "verify requests merged into coalesced flushes",
    "serve_coalesce_wait_seconds": "per-request park wait inside the verify coalescer",
    "duty_sign_seconds": "one batched duty-signing dispatch (device G2 plane or host comb)",
    "duty_signatures_total": "signatures produced by the signing plane, by path",
    "duty_completion_offset_seconds": "duty-phase completion offset into its slot, by type",
    "duties_produced_total": "validator duties produced, by type (attest|aggregate|propose)",
    "duty_deadline_miss_total": "duties completed after their slot-phase deadline, by type",
    "duty_pool_attestations": "attestation-pool cells currently held",
    "duty_keys_managed": "validator keys the duty scheduler operates",
    "slo_quantile_seconds": "observed quantile per SLO (log-bucket estimate)",
    "slo_budget_seconds": "configured budget per SLO",
    "slo_ok": "1 while the SLO's observed quantile is within budget",
    "slo_burn_rate": "error-budget burn rate per SLO and window",
    "slo_evaluations_total": "SLO engine evaluation passes",
    "slo_violations_total": "budget violations observed at evaluation, by SLO",
    "ingest_degraded_transitions_total": "degraded-latch edges, by edge (enter = 0->1 flip, exit = latch release)",
    "port_retry_total": "sidecar command retries after transient failures, by command",
    "chaos_fault_injected_total": "chaos faults injected into the transport, by kind",
    "chaos_partition_active": "1 while a chaos network partition is being enforced",
    "chaos_recovery_seconds": "post-fault-window recovery: burn rates back under threshold and fleet reconverged",
    "fleet_head_divergence_seconds": "wall time fleet members spent on divergent heads before reconverging",
    "fleet_head_lag_slots": "head-slot spread across fleet members (lead head slot minus laggard's)",
    "fleet_block_propagation_seconds": "origin publish -> remote admission wall time for gossip blocks carrying a wire trace context",
    "fleet_scrape_errors_total": "fleet-observatory scrapes that timed out / errored, by member",
    "peer_delivery_latency_seconds": "origin publish -> local first delivery per peer and topic (wire trace context required)",
    "peer_gossip_first_total": "messages a peer delivered first (useful deliveries), by peer and topic",
    "peer_gossip_duplicate_total": "already-seen messages a peer delivered, by peer and topic",
    "peer_gossip_control_total": "gossip control frames, by direction-qualified kind (graft_sent, ihave_recv, iwant_served, ...)",
    "peer_score": "sidecar-reported peer score (ban threshold < 0)",
    "pipeline_drain_restarts_total": "supervised ingest drain-loop restarts",
    "slot_block_arrival_offset_seconds": "gossip block arrival offset into its slot",
    "attestation_admit_apply_seconds": "attestation gossip admission -> fork-choice apply",
    "head_update_delay_seconds": "head update delay after the head block's slot start",
    "trace_recorder_events": "ring entries held by the flight recorder (one per terminated item trace / batch span / instant)",
    "trace_recorder_capacity": "flight recorder ring capacity (entries)",
    "trace_recorder_dropped_total": "flight recorder ring entries overwritten (overwrite-oldest)",
    "storage_fsync_total": "WAL durability barriers that reached fsync, by reason (finality|close|...)",
    "storage_wal_truncated_total": "WAL opens that truncated a torn/corrupt tail",
    "storage_wal_dropped_bytes_total": "bytes dropped by torn/corrupt-tail truncation at WAL open",
    "storage_wal_migrated_total": "legacy unframed WALs migrated to the framed format at open",
    "storage_resume_rejected_total": "resume candidates rejected before anchor adoption, by reason (decode|missing|root)",
    "storage_recovery_seconds": "crash/restart -> root-verified resume anchor wall time",
    "storage_finalized_epoch": "finalized epoch whose snapshot pointer + fsync barrier are persisted",
    "kzg_verify_seconds": "one batched blob-proof verification (RLC fold into a single pairing check)",
    "kzg_msm_total": "G1 multi-scalar multiplications run by the KZG plane, by path (device|host)",
    "kzg_blobs_verified_total": "blob proofs judged by the KZG plane, by result (ok|invalid)",
    "da_gate_wait_seconds": "block arrival -> sampled blob-column set complete at the DA gate",
    "da_sidecars_total": "blob sidecars judged by the DA gate, by result (accept|duplicate|orphan|mismatch|evicted)",
    "da_blocks_pending": "blocks currently parked behind incomplete blob-column sets",
    "da_blobs_withheld_total": "blob-sidecar publishes swallowed by the chaos withholding adversary",
    "reorg_depth": "blocks orphaned per head transition (0 = fast-forward onto a descendant)",
    "finality_lag_epochs": "current epoch minus finalized epoch, sampled per epoch by the forensics tracker",
    "participation_rate": "previous-epoch participation fraction, by Altair timeliness flag",
    "subnet_missing_votes": "committee members with no current-epoch latest message, by attestation subnet",
    "forensics_evidence_total": "equivocation evidence records minted, by kind (double_proposal|double_vote|attester_slashing)",
    "forensics_ring_dropped_total": "forensic ring entries overwritten (overwrite-oldest), by ring",
}


def telemetry_enabled() -> bool:
    """Process-wide polarity of the default registry (``TELEMETRY_OFF=1``
    opts out; same truthiness parse as every other routing flag)."""
    return not env_flag("TELEMETRY_OFF")


def _escape(value) -> str:
    """Prometheus label-value escaping (backslash, quote, newline) — the
    old renderer emitted raw values, which corrupts the exposition on the
    first topic name or error string containing a quote."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels_text(labels: tuple, extra: tuple | None = None) -> str:
    items = list(labels)
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt(value: float) -> str:
    """Full-precision sample rendering: integral values as bare ints,
    everything else via shortest round-trip repr.  ``%g`` (6 significant
    digits) quantized counters past 1e6 and long-lived ``_sum`` series,
    stair-stepping Prometheus ``rate()``/``increase()``."""
    value = float(value)
    if value.is_integer() and abs(value) < 2**53:
        return str(int(value))
    return repr(value)


class _NoopSpan:
    """The shared inert span: no clock read, no allocation on exit."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()


def _emit_slow(name: str, dt: float, slow: float, labels, exc_type) -> None:
    # one structured line per slow op: key=value so log scrapers need no
    # format knowledge beyond the "slow_op" marker
    log.warning(
        "slow_op span=%s seconds=%.6f threshold_s=%.3f labels=%s error=%s",
        name,
        dt,
        slow,
        ",".join(f"{k}={v}" for k, v in labels) or "-",
        exc_type.__name__ if exc_type is not None else "-",
    )


class _Span:
    __slots__ = ("_metrics", "_name", "_labels", "_key", "_slow", "_t0")

    def __init__(self, metrics: "Metrics", name: str, slow: float, labels: dict):
        self._metrics = metrics
        self._name = name
        self._slow = slow
        # histogram key precomputed at construction: exit pays one lock +
        # one bisect, no kwargs re-expansion or re-sort
        self._labels = tuple(sorted(labels.items()))
        self._key = (name + "_seconds", self._labels)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        self._metrics._observe_key(self._key, dt)
        if dt >= self._slow:
            _emit_slow(self._name, dt, self._slow, self._labels, exc_type)
        return False


class _BoundTimer:
    """One timing of a :class:`BoundSpan` — the only per-call allocation
    on a bound call site."""

    __slots__ = ("_bound", "_t0")

    def __init__(self, bound: "BoundSpan"):
        self._bound = bound

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        b = self._bound
        hist = b._hist
        if hist is None:
            # first timing resolves (and pins) the histogram handle —
            # histograms are never replaced, so every later exit skips
            # the key hash + dict lookups entirely
            b._bounds, hist = b._metrics._hist_handle(b._key)
            b._hist = hist
        m = b._metrics
        with m._lock:
            hist.counts[bisect_left(b._bounds, dt)] += 1
            hist.sum += dt
            hist.count += 1
        if dt >= b._slow:
            _emit_slow(b._name, dt, b._slow, b._labels, exc_type)
        return False


class BoundSpan:
    """A span pre-bound to one ``(name, labels)`` call site: the label
    sort, key tuple, threshold and (after the first timing) the histogram
    handle are resolved ONCE, so a per-item hot loop pays two clock reads,
    one lock and one bisect per timing.  Not itself a context manager (a
    shared object holding ``t0`` would race across threads) — call
    :meth:`time` per region."""

    __slots__ = ("_metrics", "_name", "_labels", "_key", "_slow", "_bounds", "_hist")

    def __init__(self, metrics: "Metrics", name: str, slow: float, labels: dict):
        self._metrics = metrics
        self._name = name
        self._slow = slow
        self._labels = tuple(sorted(labels.items()))
        self._key = (name + "_seconds", self._labels)
        self._bounds = None
        self._hist = None

    def time(self):
        if not self._metrics._enabled:
            return _NOOP_SPAN
        return _BoundTimer(self)


class _Histogram:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # last slot is +Inf overflow
        self.sum = 0.0
        self.count = 0


class Metrics:
    """One metric registry: thread-safe counters, gauges and histograms
    plus the span timer API.  ``enabled=False`` is the true no-op mode —
    nothing is recorded and no keys are created."""

    def __init__(self, enabled: bool = True, slow_op_s: float | None = None):
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = defaultdict(float)
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], _Histogram] = {}
        self._buckets: dict[str, tuple] = {}  # per-name bucket bounds
        self._help: dict[str, str] = {}
        if slow_op_s is None:
            try:
                slow_op_s = float(os.environ.get("TELEMETRY_SLOW_OP_S", "") or 1.0)
            except ValueError:
                slow_op_s = 1.0
        self.slow_op_s = slow_op_s

    # ------------------------------------------------------------- control

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """Flip recording at runtime (the overhead bench measures both
        polarities in one process; the env flag only sets the default)."""
        self._enabled = bool(enabled)

    def describe(self, name: str, help_text: str) -> None:
        with self._lock:
            self._help[name] = help_text

    def register_histogram(self, name: str, buckets) -> None:
        """Pin non-default bucket bounds for ``name`` (must be sorted
        ascending; set before the first ``observe``)."""
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds):
            raise ValueError("histogram buckets must be sorted ascending")
        with self._lock:
            if any(key[0] == name for key in self._hists):
                # existing counts arrays are sized to the old bounds —
                # swapping under them would mis-index every later observe
                raise ValueError(
                    f"histogram {name!r} already has observations"
                )
            self._buckets[name] = bounds

    # ----------------------------------------------------------- recording

    def inc(self, name: str, value: float = 1, **labels) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._counters[(name, tuple(sorted(labels.items())))] += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._gauges[(name, tuple(sorted(labels.items())))] = value

    def observe(self, name: str, value: float, **labels) -> None:
        if not self._enabled:
            return
        self._observe_key((name, tuple(sorted(labels.items()))), value)

    def _observe_key(self, key: tuple, value: float) -> None:
        """Record into a histogram by its precomputed ``(name, labels)``
        key — the span-exit fast path."""
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                bounds = self._buckets.setdefault(key[0], DEFAULT_BUCKETS)
                hist = self._hists[key] = _Histogram(len(bounds))
            else:
                bounds = self._buckets[key[0]]
            hist.counts[bisect_left(bounds, value)] += 1
            hist.sum += value
            hist.count += 1

    def _hist_handle(self, key: tuple):
        """``(bounds, histogram)`` for a precomputed key, created on
        first use — BoundSpan pins the returned handle so later timings
        skip the dict lookups (histograms are never replaced)."""
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                bounds = self._buckets.setdefault(key[0], DEFAULT_BUCKETS)
                hist = self._hists[key] = _Histogram(len(bounds))
            else:
                bounds = self._buckets[key[0]]
        return bounds, hist

    def span(self, name: str, slow: float | None = None, **labels):
        """Context manager timing a region into ``<name>_seconds``;
        ``slow`` overrides the slow-op threshold for this span."""
        if not self._enabled:
            return _NOOP_SPAN
        return _Span(self, name, self.slow_op_s if slow is None else slow, labels)

    def bound_span(self, name: str, slow: float | None = None, **labels):
        """Pre-bind a span to a call site (labels resolved once); use
        ``with bound.time(): ...`` in the hot loop."""
        return BoundSpan(
            self, name, self.slow_op_s if slow is None else slow, labels
        )

    # -------------------------------------------------------------- access

    def get(self, name: str, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            return self._counters.get(key, 0.0)

    def get_histogram(self, name: str, **labels):
        """``(bounds, bucket_counts, sum, count)`` or None — test/debug
        access; ``bucket_counts`` has one +Inf overflow slot appended."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                return None
            return (self._buckets[name], list(hist.counts), hist.sum, hist.count)

    def histogram_series(self, name: str):
        """Every recorded series of one histogram family:
        ``[(labels, bounds, bucket_counts, sum, count), ...]`` with the
        counts copied under the lock (the SLO engine merges them into one
        family-level distribution; a torn read would break cumulative
        bucket monotonicity the same way it would break a scrape)."""
        with self._lock:
            bounds = self._buckets.get(name)
            if bounds is None:
                return []
            return [
                (key[1], bounds, list(h.counts), h.sum, h.count)
                for key, h in self._hists.items()
                if key[0] == name
            ]

    def key_count(self) -> int:
        """Total metric keys across all families (0 in no-op mode)."""
        with self._lock:
            return len(self._counters) + len(self._gauges) + len(self._hists)

    def family_names(self) -> set[str]:
        """Metric family names with at least one sample recorded."""
        with self._lock:
            return {key[0] for source in (self._counters, self._gauges, self._hists)
                    for key in source}

    # ----------------------------------------------------------- rendering

    def _header(self, lines: list, seen: set, name: str, typ: str) -> None:
        if name in seen:
            return
        seen.add(name)
        lines.append(f"# HELP {name} {self._help.get(name) or _HELP.get(name, name)}")
        lines.append(f"# TYPE {name} {typ}")

    def render_prometheus(self, skip=frozenset(), self_scrape: bool = True) -> str:
        """Prometheus text exposition format (0.0.4): HELP/TYPE headers
        per family, cumulative histogram buckets, escaped label values.
        Families named in ``skip`` are omitted — the merge-with-another-
        registry path uses this to guarantee a name can never emit two
        TYPE headers in one scrape (which fails the whole target).

        ``self_scrape`` appends the exposition's own vitals
        (``telemetry_scrape_seconds``/``telemetry_series_count``) so a
        slow or cardinality-exploding scrape is visible from the scrape
        itself; the merged `/metrics` route renders both registries with
        ``self_scrape=False`` and appends ONE combined stats block
        (:func:`scrape_stats_lines`) — two renders appending their own
        would emit duplicate TYPE headers."""
        t_start = time.perf_counter()
        lines: list[str] = []
        seen: set[str] = set()
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            # deep-copy histogram data UNDER the lock: the _Histogram
            # objects mutate concurrently, and a half-updated read would
            # emit non-monotone buckets or a _sum/_count pair from two
            # instants — breaking histogram_quantile for that scrape
            hists = sorted(
                (key, (list(h.counts), h.sum, h.count))
                for key, h in self._hists.items()
            )
            buckets = dict(self._buckets)
        for (name, labels), value in counters:
            if name in skip:
                continue
            self._header(lines, seen, name, "counter")
            lines.append(f"{name}{_labels_text(labels)} {_fmt(value)}")
        for (name, labels), value in gauges:
            if name in skip:
                continue
            self._header(lines, seen, name, "gauge")
            lines.append(f"{name}{_labels_text(labels)} {_fmt(value)}")
        for (name, labels), (counts, h_sum, h_count) in hists:
            if name in skip:
                continue
            self._header(lines, seen, name, "histogram")
            cum = 0
            for bound, n in zip(buckets[name], counts):
                cum += n
                lines.append(
                    f"{name}_bucket{_labels_text(labels, ('le', _fmt(bound)))} {cum}"
                )
            lines.append(
                f"{name}_bucket{_labels_text(labels, ('le', '+Inf'))} {h_count}"
            )
            lines.append(f"{name}_sum{_labels_text(labels)} {_fmt(h_sum)}")
            lines.append(f"{name}_count{_labels_text(labels)} {h_count}")
        if self_scrape and self._enabled:
            # series counted BEFORE the stats block (it describes the
            # payload, not itself); a disabled registry stays empty so
            # the no-op contract (zero keys, empty exposition) holds
            series = sum(1 for l in lines if not l.startswith("#"))
            lines.extend(
                scrape_stats_lines(time.perf_counter() - t_start, series)
            )
        return "\n".join(lines) + "\n"


def scrape_stats_lines(scrape_seconds: float, series_count: int) -> list[str]:
    """The `/metrics` self-observability block: how long this render
    took and how many sample series it carried.  Synthesized per scrape
    (never stored — a stored gauge would describe the PREVIOUS scrape),
    shared by the single-registry renderer and the merged API route."""
    return [
        "# HELP telemetry_scrape_seconds wall time spent rendering this exposition",
        "# TYPE telemetry_scrape_seconds gauge",
        f"telemetry_scrape_seconds {_fmt(scrape_seconds)}",
        "# HELP telemetry_series_count sample series in this exposition",
        "# TYPE telemetry_series_count gauge",
        f"telemetry_series_count {series_count}",
    ]


# ------------------------------------------------------- default registry
#
# One process-wide registry the layers (ops, validator, tracing) record
# into without any plumbing.  Polarity comes from TELEMETRY_OFF at first
# use; set_enabled() flips it at runtime.

_DEFAULT: Metrics | None = None
_DEFAULT_LOCK = threading.Lock()


def get_metrics() -> Metrics:
    global _DEFAULT
    m = _DEFAULT
    if m is None:
        with _DEFAULT_LOCK:
            m = _DEFAULT
            if m is None:
                m = _DEFAULT = Metrics(enabled=telemetry_enabled())
    return m


def span(name: str, slow: float | None = None, **labels):
    """Module-level span on the default registry — the one-liner the hot
    paths use: ``with span("block_transition"): ...``."""
    return get_metrics().span(name, slow, **labels)


def inc(name: str, value: float = 1, **labels) -> None:
    get_metrics().inc(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    get_metrics().observe(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    get_metrics().set_gauge(name, value, **labels)
