"""Declarative SLO engine over the telemetry histograms.

The node's hot paths record latency *distributions* (slot-phase delays,
ingest lane waits, drain and verify spans) into the telemetry registry;
this module turns those histogram families into machine-checkable pass
or fail:

- **Budget definitions** (:class:`SloDef`): a declarative row — family,
  quantile, budget seconds, optional label filter — over the histogram
  families the hot paths already emit.  :data:`DEFAULT_SLOS` is the
  shipped set; :data:`STORAGE_SLOS`, :data:`SOAK_SLOS` and
  :data:`FLEET_SLOS` extend it for the crash, soak and fleet runs.
- **Quantile estimation** (:func:`estimate_quantile`): pXX from the
  log-bucketed cumulative counts, linear interpolation inside the
  straddling bucket.  The estimate lands in the same bucket as the true
  sample quantile, so relative error is bounded by the bucket geometry
  (factor-2 default bounds: within 2x).
- **Multi-window burn rate**: the engine snapshots per-SLO
  ``(count, good)`` pairs on every tick and computes, for each window,
  the observed bad fraction over the window divided by the allowed bad
  fraction (``1 - quantile``) — the SRE burn-rate convention where
  ``1.0`` means "spending the error budget exactly at the sustainable
  rate".  ``breaching`` requires every window to burn above the SLO's
  threshold (the multi-window AND that keeps one late item from paging).
- **Exposition**: each evaluation publishes ``slo_quantile_seconds`` /
  ``slo_budget_seconds`` / ``slo_ok`` / ``slo_burn_rate`` gauges plus
  the evaluation/violation counters, and returns the ``/debug/slo``
  JSON report.

Histograms are cumulative over process lifetime, so the "cumulative"
window (process start -> now) is what a gate judges; burn-rate windows
exist for the live node, where a regression must surface faster than the
cumulative quantile can move.

The port's copy of the JAX package's ``slo.py``: the same rows, the same
estimates and the same report, float for float, over the port's
:class:`~.telemetry.Metrics`.  The engine does no device work.  The JAX
package's load-profile gate (``scripts/slo_check.py``) is not ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .telemetry import Metrics, get_metrics

__all__ = [
    "DEFAULT_SLOS",
    "DEFAULT_WINDOWS",
    "FLEET_SLOS",
    "SOAK_SLOS",
    "STORAGE_SLOS",
    "SloDef",
    "SloEngine",
    "estimate_quantile",
    "good_fraction",
    "get_engine",
    "slos_for_family",
]

# (name, seconds) burn-rate windows: "fast" catches a regression within
# a minute of sustained bad observations, "slow" confirms it is not one
# unlucky batch.  Both clamp to process lifetime when the engine is
# younger than the window (the CI-gate case).
DEFAULT_WINDOWS = (("fast", 60.0), ("slow", 300.0))


@dataclass(frozen=True)
class SloDef:
    """One declarative budget over an existing histogram family.

    ``labels`` is an optional ``((key, value), ...)`` subset filter —
    only series carrying every listed pair aggregate into the SLO;
    the default aggregates the whole family.  ``burn_threshold`` is the
    per-window burn rate above which the SLO counts as breaching (1.0 =
    consuming error budget exactly as fast as allowed)."""

    name: str
    family: str
    quantile: float
    budget: float
    description: str = ""
    labels: tuple = ()
    burn_threshold: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {self.quantile}")
        if self.budget <= 0.0:
            raise ValueError(f"budget must be positive, got {self.budget}")


# The shipped budget set.  Budgets are deliberately loose "is the node
# healthy at all" bounds — a soak or chaos harness tightens
# per-scenario copies via SloEngine(slos=...) rather than editing these.
DEFAULT_SLOS = (
    SloDef(
        "attestation_admit_apply_p95", "attestation_admit_apply_seconds",
        0.95, 2.0,
        "gossip admission -> fork-choice apply dwell for attestations",
    ),
    SloDef(
        "block_arrival_offset_p95", "slot_block_arrival_offset_seconds",
        0.95, 4.0,
        "blocks must arrive before the attestation deadline (1/3 slot)",
    ),
    SloDef(
        "head_update_delay_p95", "head_update_delay_seconds",
        0.95, 6.0,
        "head moves onto a slot's block within half a mainnet slot",
    ),
    SloDef(
        "ingest_lane_wait_p95", "ingest_flush_wait_seconds",
        0.95, 0.5,
        "oldest-item queue wait at lane flush (deadline coalescing bound)",
    ),
    SloDef(
        "ingest_sched_p99", "ingest_sched_seconds",
        0.99, 0.025,
        # measured ~4 us/item: 25 ms still catches any algorithmic
        # regression (those are systematic, not tail noise) without
        # letting a loaded CI runner's GC/scheduler stalls flap the
        # make-test gate on a ~1.5 s smoke window
        "scheduler bookkeeping per round stays in the telemetry class",
    ),
    SloDef(
        "api_request_p99", "api_request_seconds",
        0.99, 0.5,
        "beacon API handler latency (route-aggregated)",
    ),
    SloDef(
        "block_transition_p95", "block_transition_seconds",
        0.95, 12.0,
        # the mainnet slot budget: a node whose p95 block transition
        # exceeds one slot can never stay synced, whatever else is fast.
        # The replay bench pushes the ACTUAL target (>= 1 block/s at 1M
        # validators); this gate is the node-health floor
        "full block transition within one mainnet slot",
    ),
    SloDef(
        "gossip_drain_p95", "gossip_drain_seconds",
        0.95, 1.0,
        "one gossip batch decode+verify+verdict round",
    ),
    SloDef(
        "duty_sign_p95", "duty_sign_seconds",
        0.95, 2.0,
        # one batched signing dispatch for a whole slot's duties (device
        # G2 ladder on the device, the native multiply on the host): it must fit well
        # inside the 4 s attest window with room for data assembly and
        # publication.  The duties bench pushes the ACTUAL signatures/s
        # target; this gate is the health bound
        "one batched duty-signing dispatch (a slot's duties in one flush)",
    ),
    SloDef(
        "duty_attest_deadline_p95", "duty_completion_offset_seconds",
        0.95, 8.0,
        # the duties-met row: an attestation broadcast after 2/3 of a
        # mainnet slot (when aggregation opens) misses its inclusion
        # window however valid it is — the hard per-slot deadline a
        # 10^4-10^5-key operator must hit.  The offset includes the 1/3
        # slot the honest timeline waits before attesting, so the
        # production budget inside it is one interval
        "attestation duties broadcast before aggregation (2/3 mainnet slot)",
        labels=(("type", "attest"),),
    ),
    SloDef(
        "witness_verify_p95", "witness_verify_seconds",
        0.95, 1.0,
        # one batched multiproof check (up to a 256-proof bucket): the
        # stateless-serving floor — a node past this cannot answer light
        # clients at line rate whatever its gossip health.  The witness
        # bench pushes the ACTUAL throughput target (>= 10k proofs/s on
        # the CPU fallback); this gate is the health bound
        "one batched stateless-witness multiproof verification",
    ),
)


# Storage-durability row: crash/restart to a ROOT-VERIFIED
# resume anchor — checksummed WAL replay, torn-tail truncation, state
# decode and the hash-tree-root check against the stored block.  The
# crash gate judges every seeded SIGKILL
# trial's recovery against it; a churn power-loss scenario feeds the
# same family from a live fleet member.
STORAGE_SLOS = (
    SloDef(
        "storage_recovery_p95", "storage_recovery_seconds",
        0.95, 5.0,
        "crash -> root-verified resume anchor (WAL replay + verification)",
    ),
)


# Soak-specific budget rows: recovery — not just survival —
# is the asserted property of every chaos scenario, so the soak gate
# judges the DEFAULT set PLUS how fast the node comes back.  The budgets
# are health bounds for the ~seconds-per-slot soak profiles; scenarios
# tighten per-run copies via soak_check --budget.
SOAK_SLOS = DEFAULT_SLOS + STORAGE_SLOS + (
    SloDef(
        "chaos_recovery_p95", "chaos_recovery_seconds",
        0.95, 30.0,
        # measured from the END of an injected fault window (partition
        # healed, storm stopped, sidecar restarted) to the instant the
        # burn rates are back under threshold AND the fleet agrees on
        # one head — the "returns to SLO within a budgeted slot count"
        # acceptance, expressed in the engine's own units
        "post-fault recovery: burn under threshold + fleet reconverged",
    ),
    SloDef(
        "fleet_divergence_p95", "fleet_head_divergence_seconds",
        0.95, 60.0,
        # a divergence episode's wall-clock duration (first observation
        # of >1 distinct head until reconvergence): partitions are
        # EXPECTED to diverge for their whole window, so the budget is
        # sized to the scenario windows, not to steady-state operation
        "fleet head-divergence episodes resolve within the soak window",
    ),
    SloDef(
        "da_availability_p95", "da_gate_wait_seconds",
        0.95, 30.0,
        # expectation registered -> every sampled blob column verified
        # (da/availability.py): blocks with instant availability observe
        # 0, a withholding episode observes its whole duration — so the
        # budget bounds how long the DA scenario may withhold before the
        # heal republish lands (sized to the soak windows, like the
        # divergence row above)
        "block DA gate: expected blob columns verified within the window",
    ),
    SloDef(
        "reorg_depth_p95", "reorg_depth",
        0.95, 4.0,
        # the forensics plane observes EVERY head transition,
        # depth 0 for plain fast-forwards — so steady-state p95 sits at
        # 0 and the budget bounds how deep the chaos scenarios' weight
        # flips may actually orphan (a healed partition fast-forwards;
        # a real competing-branch reorg deeper than a few blocks means
        # votes were badly split for multiple slots)
        "head transitions orphan at most a few blocks at p95",
    ),
    SloDef(
        "finality_lag_p95", "finality_lag_epochs",
        0.95, 32.0,
        # soak fleets justify/finalize only when duty keys drive full
        # committee participation, so lag GROWS over a keyless scenario
        # at one epoch per epoch — the budget is an is-the-clock-sane
        # ceiling sized to the soak windows (a 16 s minimal-spec epoch
        # x 32 bounds scenarios well past the longest profile), not a
        # mainnet finality target
        "finality lag stays under the soak-window ceiling",
    ),
)


# Fleet-observatory rows: cross-node propagation health,
# judged by the fleet aggregator over its MERGED view.  Propagation is
# measured from the wire trace context's origin timestamp to remote
# admission, so the budget is slot-phase-relative: a block must be
# fleet-wide well inside the attestation deadline (1/3 slot of the
# 2 s-per-slot soak profile).  Per-peer delivery keeps a looser bound —
# one slow mesh link is a peer problem before it is a fleet problem.
FLEET_SLOS = SOAK_SLOS + (
    SloDef(
        "fleet_propagation_p95", "fleet_block_propagation_seconds",
        0.95, 0.75,
        "origin publish -> remote admission for gossip blocks, fleet-wide",
    ),
    SloDef(
        "peer_delivery_p95", "peer_delivery_latency_seconds",
        0.95, 1.5,
        "per-peer gossip delivery latency (origin publish -> local first delivery)",
    ),
)


def slos_for_family(family: str) -> tuple[SloDef, ...]:
    """Every shipped budget over one histogram family — a cost
    observatory annotates each entry point's span family with the
    latency budget that governs it, so the ``/debug/profile`` headroom
    ranking shows which budgeted path a kernel rewrite would relieve."""
    return tuple(s for s in DEFAULT_SLOS if s.family == family)


# ------------------------------------------------------ quantile estimation


def estimate_quantile(bounds, counts, q: float) -> float | None:
    """pXX estimate from log-bucketed histogram state.

    ``counts`` carries one slot per bound plus the +Inf overflow slot
    (the registry's layout).  Linear interpolation inside the bucket
    containing the quantile rank; the first bucket interpolates from 0.
    Returns ``None`` on an empty histogram.  A rank landing in the
    overflow bucket clamps to the top bound — a LOWER bound on the true
    quantile, which for budget checks is the conservative direction only
    if budgets stay below the top bound (the default bounds top out at
    ~105 s; every shipped budget is orders of magnitude under that).
    """
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    lo = 0.0
    for bound, c in zip(bounds, counts):
        prev = cum
        cum += c
        if cum >= target:
            if c <= 0:
                return lo
            frac = (target - prev) / c
            return lo + (bound - lo) * min(1.0, max(0.0, frac))
        lo = bound
    return float(bounds[-1])  # overflow bucket: clamp to the top bound


def good_fraction(bounds, counts, budget: float) -> float:
    """Estimated fraction of observations ``<= budget`` (the SLI), with
    linear interpolation inside the bucket the budget falls into."""
    total = sum(counts)
    if total <= 0:
        return 1.0
    cum = 0.0
    lo = 0.0
    for bound, c in zip(bounds, counts):
        if budget < bound:
            within = (budget - lo) / (bound - lo) if bound > lo else 0.0
            return (cum + c * min(1.0, max(0.0, within))) / total
        cum += c
        lo = bound
    # budget at/above the top bound: every finite-bucket observation is
    # within budget; overflow observations are unknowable above the top
    # bound and count as bad — the conservative direction for a gate
    return (total - counts[-1]) / total


# --------------------------------------------------------------- the engine


@dataclass
class _SloState:
    """Cumulative (count, good) as of one snapshot instant."""

    ts: float
    by_slo: dict = field(default_factory=dict)


class SloEngine:
    """Evaluates a set of :class:`SloDef` against a metrics registry.

    Thread-safe: the node tick loop evaluates once a second while the
    beacon API's ``/debug/slo`` route evaluates from a worker thread.
    Snapshot history is bounded (``max_snapshots``); at the node's 1 Hz
    tick the default retains ~68 minutes, comfortably past the slow
    burn window."""

    def __init__(
        self,
        slos=DEFAULT_SLOS,
        metrics: Metrics | None = None,
        windows=DEFAULT_WINDOWS,
        max_snapshots: int = 4096,
    ):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError("duplicate SLO names")
        self.slos = tuple(slos)
        self.windows = tuple(windows)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._snaps: deque[_SloState] = deque(maxlen=max_snapshots)
        self._t0 = time.monotonic()

    # ------------------------------------------------------------- plumbing

    @property
    def metrics(self) -> Metrics:
        return self._metrics if self._metrics is not None else get_metrics()

    def _merged(self, slo: SloDef):
        """``(bounds, counts)`` of every family series passing the SLO's
        label filter, bucket-wise summed — or ``None`` with no data."""
        series = self.metrics.histogram_series(slo.family)
        want = set(slo.labels)
        merged = None
        bounds = None
        for labels, b, counts, _sum, _count in series:
            if want and not want.issubset(set(labels)):
                continue
            if merged is None:
                bounds, merged = b, list(counts)
            else:
                merged = [a + c for a, c in zip(merged, counts)]
        if merged is None:
            return None
        return bounds, merged

    def _observe_all(self) -> dict:
        """Per-SLO ``(count, good_count, bounds, counts)`` right now."""
        out = {}
        for slo in self.slos:
            got = self._merged(slo)
            if got is None:
                out[slo.name] = (0, 0.0, None, None)
                continue
            bounds, counts = got
            total = sum(counts)
            good = good_fraction(bounds, counts, slo.budget) * total
            out[slo.name] = (total, good, bounds, counts)
        return out

    # -------------------------------------------------------------- surface

    def tick(self, now: float | None = None) -> None:
        """Append one burn-rate snapshot without a full evaluation (a
        load generator ticks mid-profile so the fast/slow windows have
        interior points)."""
        now = time.monotonic() if now is None else now
        state = _SloState(ts=now)
        for name, (count, good, _b, _c) in self._observe_all().items():
            state.by_slo[name] = (count, good)
        with self._lock:
            self._snaps.append(state)

    def _window_baseline(self, now: float, window_s: float) -> _SloState | None:
        """Newest snapshot at/older than ``now - window_s`` (None when the
        engine is younger than the window — the zero origin applies).
        Scanned newest-first: only the ~window's worth of entries newer
        than the cutoff are walked, not the whole bounded history."""
        cutoff = now - window_s
        with self._lock:
            for snap in reversed(self._snaps):
                if snap.ts <= cutoff:
                    return snap
        return None

    def evaluate(
        self,
        now: float | None = None,
        emit: bool = True,
        snapshot: bool = True,
    ) -> dict:
        """One full evaluation: quantiles vs budgets, burn rates per
        window, gauge/counter exposition (``emit=True``), and the
        ``/debug/slo`` report dict.  ``snapshot=True`` also appends a
        burn-rate snapshot, so a ticking caller needs no separate
        :meth:`tick`; read-only callers (the ``/debug/slo`` route) pass
        ``emit=False, snapshot=False`` so polling the endpoint can
        neither shorten the snapshot window nor inflate the
        evaluation/violation counters."""
        now = time.monotonic() if now is None else now
        observed = self._observe_all()
        m = self.metrics
        # window baselines are SLO-independent: resolve each window once
        # per evaluation, not once per (SLO, window) pair
        baselines = {
            wname: self._window_baseline(now, wsec)
            for wname, wsec in self.windows
        }

        rows = []
        violations = []
        for slo in self.slos:
            count, good, bounds, counts = observed[slo.name]
            row = {
                "slo": slo.name,
                "series": slo.family,
                "quantile": slo.quantile,
                "budget": slo.budget,
                "description": slo.description,
                "count": count,
                "window": "cumulative",
                "observed": None,
                "ok": None,
                "status": "no_data",
                "burn_rates": {},
                "breaching": False,
            }
            if slo.labels:
                row["labels"] = dict(slo.labels)
            if count > 0:
                estimate = estimate_quantile(bounds, counts, slo.quantile)
                row["observed"] = estimate
                row["ok"] = bool(estimate is not None and estimate <= slo.budget)
                row["status"] = "ok" if row["ok"] else "violated"
                burning = []
                for wname, _wsec in self.windows:
                    base = baselines[wname]
                    b_count, b_good = (
                        base.by_slo.get(slo.name, (0, 0.0)) if base else (0, 0.0)
                    )
                    d_count = count - b_count
                    d_bad = (count - good) - (b_count - b_good)
                    if d_count > 0:
                        burn = (d_bad / d_count) / max(1e-9, 1.0 - slo.quantile)
                        burn = max(0.0, burn)
                        burning.append(burn > slo.burn_threshold)
                    else:
                        burn = 0.0
                        burning.append(False)
                    row["burn_rates"][wname] = round(burn, 4)
                row["breaching"] = bool(burning) and all(burning)
                if not row["ok"]:
                    violations.append({
                        "slo": slo.name,
                        "series": slo.family,
                        "window": "cumulative",
                        "quantile": slo.quantile,
                        "observed": estimate,
                        "budget": slo.budget,
                        "count": count,
                        "burn_rates": dict(row["burn_rates"]),
                    })
            rows.append(row)

        if emit and m.enabled:
            m.inc("slo_evaluations_total")
            for row in rows:
                if row["observed"] is None:
                    continue
                m.set_gauge("slo_quantile_seconds", row["observed"], slo=row["slo"])
                m.set_gauge("slo_budget_seconds", row["budget"], slo=row["slo"])
                m.set_gauge("slo_ok", 1.0 if row["ok"] else 0.0, slo=row["slo"])
                for wname, burn in row["burn_rates"].items():
                    m.set_gauge("slo_burn_rate", burn, slo=row["slo"], window=wname)
                if not row["ok"]:
                    m.inc("slo_violations_total", slo=row["slo"])

        if snapshot:
            # snapshot AFTER evaluation so the burn baselines above did
            # not include this instant twice
            state = _SloState(ts=now)
            for name, (count, good, _b, _c) in observed.items():
                state.by_slo[name] = (count, good)
            with self._lock:
                self._snaps.append(state)

        return {
            "uptime_s": round(now - self._t0, 3),
            "windows": {name: sec for name, sec in self.windows},
            "slos": rows,
            "violations": violations,
            "ok": not violations,
        }


# ------------------------------------------------------- default engine

_ENGINE: SloEngine | None = None
_ENGINE_LOCK = threading.Lock()


def get_engine() -> SloEngine:
    """The process-wide engine over :data:`DEFAULT_SLOS` and the default
    registry — the node tick loop evaluates it and ``/debug/slo`` serves
    it, so both see one burn-rate history."""
    global _ENGINE
    eng = _ENGINE
    if eng is None:
        with _ENGINE_LOCK:
            eng = _ENGINE
            if eng is None:
                eng = _ENGINE = SloEngine()
    return eng
