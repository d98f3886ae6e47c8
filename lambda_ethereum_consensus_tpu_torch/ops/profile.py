"""Device cost and memory observatory: which kernel ran at which width, what
that cost against the card's peaks, which plane holds the card's memory, and
a bounded profiler window.

The port's counterpart of the JAX package's ``ops/profile.py``, in three
parts:

- **Cost attribution** (:func:`record_launch`, :func:`cost_table`,
  :func:`entry_report`): the wrappers of the four CUDA kernels
  (``ops/bigint_pallas._launch`` with its lane count,
  ``ops/sha256.sha256_nodes`` with its node count) each record one launch
  under ``(kernel, width)``.  Recording is a dict increment under a lock:
  it reads no tensor, synchronises nothing and launches nothing, because
  the host's microseconds per field launch are the port's bottleneck.  A
  launch's operations are its elements times :data:`OPS_PER_ELEMENT`, the
  SASS instruction count of the body the wrapper picks for that width
  (``chip_smoke.py`` checks each constant against ``cuobjdump -sass`` on the
  card); its bytes are its elements times :data:`BYTES_PER_ELEMENT`, every
  input read once and every output written once.  The JAX package keys the
  same table by ``(AOT entry, shape signature)`` and reads XLA's
  ``cost_analysis()``; the port keeps no executables.  Joined with each
  kernel's span-histogram family (:data:`_ENTRY_SPANS`), every kernel gets
  achieved rates and a roofline ratio against :data:`PEAKS`, ranked by
  headroom.  As in the JAX package the achieved rate divides a kernel's
  whole work by one family's seconds, which also hold host work, so it is a
  lower bound.
- **Per-plane device-memory accounting** (:class:`PlaneRegistry`): the
  modules that hold device memory register byte providers (the registry
  planes, the resident epoch plane, the duty-sign ladders; the witness
  service's host rows with ``device=False``), and :func:`plane_bytes`
  resolves them against the card's allocator total
  (``torch.cuda.memory_allocated``) into named planes plus an
  ``unattributed`` remainder and a high watermark.
- **Capture windows** (:func:`capture_trace`): one bounded
  ``torch.profiler`` window (CPU and CUDA activities) written as one Chrome
  trace, refused before tracing when the window exceeds
  :data:`PROFILE_CAPTURE_MAX_S`, deleted when the trace exceeds
  :data:`PROFILE_CAPTURE_MAX_MB`; its start and stop instants land in the
  flight recorder.

Budgets, peaks and the capture directory are module constants (the JAX
package reads ``PROFILE_*`` environment variables); nothing here reads the
environment.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from pathlib import Path

import torch

from ..telemetry import get_metrics
from ..tracing import get_recorder

__all__ = [
    "BYTES_PER_ELEMENT",
    "HBM_BYTES_PER_S",
    "OPS_PER_ELEMENT",
    "PEAKS",
    "PEAKS_CARD",
    "PROFILE_CAPTURE_DIR",
    "PROFILE_CAPTURE_MAX_MB",
    "PROFILE_CAPTURE_MAX_S",
    "PlaneRegistry",
    "backend_peaks",
    "capture_budget",
    "capture_state",
    "capture_trace",
    "cost_for",
    "cost_table",
    "device_planes",
    "emit_entry_metrics",
    "entry_report",
    "live_device_blocks",
    "live_device_bytes",
    "plane_bytes",
    "plane_watermark",
    "profile_report",
    "record_launch",
    "register_plane",
    "unregister_plane",
]

_LOCK = threading.Lock()

# ------------------------------------------------------------- the card

#: The card the peaks below describe, as ``nvidia-smi --query-gpu=name,
#: power.limit`` gives it.  A card held below 700 W runs slower under load.
PEAKS_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: H100 SXM, from the data sheet and the Hopper white paper: HBM3 bytes a
#: second, SMs, the SM clock's maximum, and the lanes an SM dispatches a
#: clock (4 schedulers x 32), of which 64 run on the INT32 ALU pipe and 64
#: on the FMA pipe (where IMAD runs).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_MHZ = 1980
DISPATCH_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64
FMA_LANES_PER_SM = 64

#: Per-backend peaks: (G operations a second, GB a second).  The ``"gpu"``
#: row is the one ``PERF.md``'s bounds divide by: the card's instruction
#: dispatch rate at its maximum clock (the kernels are integer code, so an
#: operation is one SASS thread-instruction) and its HBM rate.  The
#: ``"cpu"`` row is the JAX package's order-of-magnitude placeholder.
PEAKS: dict[str, tuple[float, float]] = {
    "gpu": (SMS * DISPATCH_LANES_PER_SM * SM_CLOCK_MHZ * 1e6 / 1e9, HBM_BYTES_PER_S / 1e9),
    "cpu": (50.0, 20.0),
}

#: SASS instructions one element (a node, a field lane) executes in each
#: kernel, by the threads per element of the body the wrapper launches at
#: that width (``bigint_pallas._geometry``): the body's straight-line
#: instruction count (``cuobjdump -sass``, NOPs left out) times its threads.
#: ``mul_mod`` runs its 2-thread group body below ``MUL_GROUP_THRESHOLD``
#: lanes and its one-thread body from there on.
OPS_PER_ELEMENT: dict[str, dict[int, int]] = {
    "sha256": {1: 2409},
    "mul_mod": {1: 1957, 2: 2 * 1415},
    "add_mod": {2: 2 * 444},
    "sub_mod": {2: 2 * 444},
}
#: Bytes an element moves: a SHA-256 node reads 64 B and writes its 32 B
#: digest; a field lane reads two 32-limb int32 operands and writes one.
BYTES_PER_ELEMENT: dict[str, int] = {
    "sha256": 64 + 32,
    "mul_mod": 3 * 32 * 4,
    "add_mod": 3 * 32 * 4,
    "sub_mod": 3 * 32 * 4,
}
_FIELD_KERNELS = ("mul_mod", "add_mod", "sub_mod")

# ------------------------------------------------------ cost attribution

# (kernel, width) -> launches
_LAUNCHES: dict[tuple[str, int], int] = {}


def record_launch(kernel: str, width: int) -> None:
    """Count one launch of ``kernel`` over ``width`` elements (lanes or
    nodes).  The wrappers call it where they count the launch."""
    key = (kernel, width)
    with _LOCK:
        _LAUNCHES[key] = _LAUNCHES.get(key, 0) + 1


def _threads_per_element(kernel: str, width: int) -> int:
    if kernel in _FIELD_KERNELS:
        from .bigint_pallas import _geometry

        return _geometry(kernel, width)[0]
    return 1


def _row(kernel: str, width: int, launches: int) -> dict:
    group = _threads_per_element(kernel, width)
    return {
        "entry": kernel,
        "width": width,
        "threads_per_element": group,
        "launches": launches,
        "flops": float(OPS_PER_ELEMENT[kernel][group] * width),
        "bytes_accessed": float(BYTES_PER_ELEMENT[kernel] * width),
    }


def cost_table() -> list[dict]:
    """One row per ``(kernel, width)`` launched: its launches and the
    operations (``flops``: SASS thread-instructions) and bytes of one
    launch."""
    with _LOCK:
        items = sorted(_LAUNCHES.items())
    return [_row(kernel, width, n) for (kernel, width), n in items]


def cost_for(kernel: str, width: int) -> dict | None:
    """One ``(kernel, width)`` row, or ``None``."""
    with _LOCK:
        n = _LAUNCHES.get((kernel, width))
    return None if n is None else _row(kernel, width, n)


def backend_peaks(backend: str | None) -> dict:
    """``{"backend", "gflops", "gbs", "source", "card"}`` for one backend
    name (an unknown one takes the ``"cpu"`` row)."""
    gflops, gbs = PEAKS.get(backend or "cpu", PEAKS["cpu"])
    return {
        "backend": backend,
        "gflops": gflops,
        "gbs": gbs,
        "source": "table",
        "card": PEAKS_CARD if backend == "gpu" else None,
    }


# kernel prefix -> the span-histogram family whose seconds its work
# divides by: the drain's span for the field kernels, the state root's for
# SHA-256 (see the module doc for why the rate is a lower bound)
_ENTRY_SPANS: tuple[tuple[str, str], ...] = (
    ("sha256", "ssz_hash_tree_root_seconds"),
    ("mul_mod", "attestation_batch_verify_seconds"),
    ("add_mod", "attestation_batch_verify_seconds"),
    ("sub_mod", "attestation_batch_verify_seconds"),
)


def _span_family(entry: str) -> str | None:
    for prefix, family in _ENTRY_SPANS:
        if entry.startswith(prefix):
            return family
    return None


def _family_totals(metrics, family: str) -> tuple[float, int]:
    """Cumulative (seconds, observations) over every series of one
    histogram family."""
    total_s = 0.0
    total_n = 0
    for _labels, _bounds, _counts, h_sum, h_count in metrics.histogram_series(family):
        total_s += h_sum
        total_n += h_count
    return total_s, total_n


def _default_backend() -> str:
    return "gpu" if torch.cuda.is_available() else "cpu"


def entry_report(metrics=None, backend: str | None = None) -> list[dict]:
    """The ranked headroom view: one row per kernel with its operation and
    byte totals, achieved rates against its span family and the roofline
    ratio against the backend's peaks.  Rows with achieved data rank first,
    most headroom first."""
    from ..slo import slos_for_family

    m = metrics if metrics is not None else get_metrics()
    if backend is None:
        backend = _default_backend()
    peaks = backend_peaks(backend)

    entries: dict[str, dict] = {}
    for c in cost_table():
        n = c["launches"]
        e = entries.setdefault(
            c["entry"],
            {
                "entry": c["entry"],
                "widths": 0,
                "calls": 0,
                "flops_total": 0.0,
                "bytes_total": 0.0,
                "flops_per_call_max": 0.0,
            },
        )
        e["widths"] += 1
        e["calls"] += n
        e["flops_total"] += c["flops"] * n
        e["bytes_total"] += c["bytes_accessed"] * n
        e["flops_per_call_max"] = max(e["flops_per_call_max"], c["flops"])

    span_cache: dict[str, tuple[float, int]] = {}
    for e in entries.values():
        family = _span_family(e["entry"])
        e["span_family"] = family
        e["span_seconds"] = e["span_count"] = None
        e["achieved_gflops"] = e["achieved_gbs"] = None
        e["compute_ratio"] = e["memory_ratio"] = None
        e["roofline_ratio"] = e["headroom"] = None
        e["slo"] = None
        if family is None:
            continue
        slos = slos_for_family(family)
        if slos:
            e["slo"] = {"name": slos[0].name, "budget": slos[0].budget}
        if family not in span_cache:
            span_cache[family] = _family_totals(m, family)
        span_s, span_n = span_cache[family]
        e["span_seconds"] = round(span_s, 6)
        e["span_count"] = span_n
        if span_s <= 0.0:
            continue
        e["achieved_gflops"] = e["flops_total"] / span_s / 1e9
        e["achieved_gbs"] = e["bytes_total"] / span_s / 1e9
        e["compute_ratio"] = e["achieved_gflops"] / peaks["gflops"]
        e["memory_ratio"] = e["achieved_gbs"] / peaks["gbs"]
        # the binding resource's achieved fraction; headroom is what a
        # faster kernel could still claim on this backend
        e["roofline_ratio"] = min(1.0, max(e["compute_ratio"], e["memory_ratio"]))
        e["headroom"] = 1.0 - e["roofline_ratio"]

    ranked = sorted(
        (e for e in entries.values() if e["roofline_ratio"] is not None),
        key=lambda e: (-(e["headroom"] or 0.0), -e["flops_total"]),
    ) + sorted(
        (e for e in entries.values() if e["roofline_ratio"] is None),
        key=lambda e: -e["flops_total"],
    )
    for i, e in enumerate(ranked, 1):
        e["rank"] = i
    return ranked


# the process-wide counter cursors: ops_entry_*_total must expose as
# counters (rate() semantics), so emission publishes deltas against the
# last emitted cumulative value instead of re-setting a gauge
_EMITTED_TOTALS: dict[str, tuple[float, float]] = {}


def emit_entry_metrics(metrics=None) -> None:
    """Publish ``ops_entry_flops_total`` / ``ops_entry_bytes_total`` counter
    deltas and the ``ops_entry_roofline_ratio`` gauge per kernel.  Called
    from the node tick; idempotent across co-resident nodes because the
    cursors are process-wide."""
    m = metrics if metrics is not None else get_metrics()
    if not m.enabled:
        return
    for e in entry_report(metrics=m):
        name = e["entry"]
        # read-modify-write under the lock: co-resident node ticks share
        # the cursors, and a race would publish one delta twice; the
        # cursor never rewinds, so a tick holding a stale report cannot
        # make the next one publish a delta again
        with _LOCK:
            prev_f, prev_b = _EMITTED_TOTALS.get(name, (0.0, 0.0))
            d_flops = max(0.0, e["flops_total"] - prev_f)
            d_bytes = max(0.0, e["bytes_total"] - prev_b)
            _EMITTED_TOTALS[name] = (max(prev_f, e["flops_total"]), max(prev_b, e["bytes_total"]))
        if d_flops > 0:
            m.inc("ops_entry_flops_total", d_flops, entry=name)
        if d_bytes > 0:
            m.inc("ops_entry_bytes_total", d_bytes, entry=name)
        if e["roofline_ratio"] is not None:
            m.set_gauge("ops_entry_roofline_ratio", e["roofline_ratio"], entry=name)


# --------------------------------------------------- per-plane accounting


class PlaneRegistry:
    """Named byte providers for everything that retains device (or host)
    buffers.  ``snapshot(total)`` resolves every provider and derives the
    ``unattributed`` remainder from the device-flagged planes, tracking the
    total's high watermark.  ``device=True`` means "these bytes are part of
    the allocator total the remainder is derived from"; planes holding
    memory outside it (host rows) register ``device=False`` and report as
    their own series without entering the remainder.  A provider that
    raises reports 0 for that snapshot: accounting never takes down the
    tick loop."""

    def __init__(self):
        self._lock = threading.Lock()
        self._planes: dict[str, tuple] = {}  # name -> (provider, device)
        self._watermark = 0.0

    def register(self, name: str, provider, device: bool = True) -> None:
        if not callable(provider):
            raise TypeError(f"plane {name!r} provider must be callable")
        with self._lock:
            self._planes[name] = (provider, bool(device))

    def unregister(self, name: str) -> None:
        with self._lock:
            self._planes.pop(name, None)

    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._planes))

    def device_names(self) -> tuple[str, ...]:
        """The planes whose bytes are part of the allocator total."""
        with self._lock:
            return tuple(sorted(n for n, (_p, device) in self._planes.items() if device))

    def snapshot(self, total_bytes: float | None = None) -> dict[str, float]:
        with self._lock:
            items = list(self._planes.items())
        out: dict[str, float] = {}
        attributed = 0.0
        for name, (provider, device) in items:
            try:
                nbytes = float(provider() or 0.0)
            except Exception:
                nbytes = 0.0
            out[name] = nbytes
            if device:
                attributed += nbytes
        if total_bytes is not None:
            total = float(total_bytes)
            out["unattributed"] = max(0.0, total - attributed)
            with self._lock:
                self._watermark = max(self._watermark, total)
        return out

    @property
    def watermark(self) -> float:
        with self._lock:
            return self._watermark


_REGISTRY = PlaneRegistry()


def register_plane(name: str, provider, device: bool = True) -> None:
    """Register a retained-bytes provider on the default registry."""
    _REGISTRY.register(name, provider, device=device)


def unregister_plane(name: str) -> None:
    _REGISTRY.unregister(name)


def plane_bytes(total_bytes: float | None = None) -> dict[str, float]:
    """Resolve every registered plane (plus ``unattributed`` when the
    allocator total is given): the node tick's ``device_plane_bytes``
    source."""
    return _REGISTRY.snapshot(total_bytes)


def device_planes() -> tuple[str, ...]:
    """The registered planes whose bytes the allocator total holds."""
    return _REGISTRY.device_names()


def plane_watermark() -> float:
    """High watermark of the allocator totals ever snapshotted."""
    return _REGISTRY.watermark


def live_device_bytes() -> float | None:
    """Bytes the card's caching allocator holds for live tensors, or
    ``None`` when this process has not initialised CUDA (a host-only
    process does not pay a CUDA context for an accounting sample)."""
    if not torch.cuda.is_initialized():
        return None
    return float(torch.cuda.memory_allocated())


def live_device_blocks() -> int | None:
    """The allocator's count of active blocks (the port's
    ``device_live_arrays``), or ``None`` without CUDA."""
    if not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_stats().get("active.all.current", 0))


# --------------------------------------------------------- trace capture

#: Longest window one capture may ask for, seconds.
PROFILE_CAPTURE_MAX_S = 10.0
#: Largest trace one capture may leave on disk, MB.
PROFILE_CAPTURE_MAX_MB = 128.0
#: Where captures land unless the caller names a directory.
PROFILE_CAPTURE_DIR = Path(__file__).resolve().parents[2] / ".profile_captures"

_CAPTURE_LOCK = threading.Lock()  # one capture at a time, process-wide
_CAPTURE_STATE: dict = {"running": False, "last": None}


def capture_budget() -> tuple[float, float]:
    """(max seconds, max MB) for one capture."""
    return float(PROFILE_CAPTURE_MAX_S), float(PROFILE_CAPTURE_MAX_MB)


def capture_state() -> dict:
    max_s, max_mb = capture_budget()
    with _LOCK:
        last = dict(_CAPTURE_STATE["last"]) if _CAPTURE_STATE["last"] is not None else None
        running = _CAPTURE_STATE["running"]
    return {"max_seconds": max_s, "max_mb": max_mb, "running": running, "last": last}


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for fname in files:
            try:
                total += os.path.getsize(os.path.join(root, fname))
            except OSError:
                pass
    return total


class TorchTracer:
    """The default tracer: one ``torch.profiler`` window over the CPU and,
    where there is a card, CUDA activities, exported as ``trace.json`` (a
    Chrome trace) into the capture directory."""

    def __init__(self):
        self._prof = None
        self._path = None

    def start_trace(self, path: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._path = path
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._path, "trace.json"))


def capture_trace(seconds: float, out_dir: str | None = None, tracer=None) -> dict:
    """One budgeted profiler window.

    Refuses before tracing when ``seconds`` exceeds the time budget, deletes
    the capture and raises when the written trace exceeds the byte budget.
    Runs synchronously: callers own the threading (the API route runs it on
    a worker thread).  ``tracer`` (``start_trace(path)`` / ``stop_trace()``)
    is a seam for tests; the default is :class:`TorchTracer`."""
    max_s, max_mb = capture_budget()
    m = get_metrics()
    seconds = float(seconds)
    if not seconds > 0.0:
        raise ValueError(f"capture seconds must be positive, got {seconds!r}")
    if seconds > max_s:
        m.inc("profile_captures_total", result="refused")
        raise ValueError(
            f"capture of {seconds:g}s exceeds the PROFILE_CAPTURE_MAX_S="
            f"{max_s:g} budget — refused before tracing"
        )
    if not _CAPTURE_LOCK.acquire(blocking=False):
        m.inc("profile_captures_total", result="busy")
        raise ValueError("a profiler capture is already running")
    try:
        with _LOCK:
            _CAPTURE_STATE["running"] = True
        if tracer is None:
            tracer = TorchTracer()
        path = os.path.join(
            out_dir or str(PROFILE_CAPTURE_DIR),
            time.strftime("capture-%Y%m%d-%H%M%S") + f"-{int(time.time() * 1e3) % 1000:03d}",
        )
        os.makedirs(path, exist_ok=True)
        rec = get_recorder()
        rec.record("inst", 0, "profile_capture_start", {"dir": path, "budget_s": round(seconds, 3)})
        t0 = time.perf_counter()
        try:
            tracer.start_trace(path)
            try:
                time.sleep(seconds)
            finally:
                tracer.stop_trace()
        except Exception:
            m.inc("profile_captures_total", result="error")
            # close the window on the recorder's timeline even on a failed
            # capture: a dangling start instant would render as a capture
            # that never ends
            rec.record(
                "inst", 0, "profile_capture_stop",
                {"dir": path, "error": True, "seconds": round(time.perf_counter() - t0, 3)},
            )
            raise
        dt = time.perf_counter() - t0
        rec.record("inst", 0, "profile_capture_stop", {"dir": path, "seconds": round(dt, 3)})
        m.observe("profile_capture_seconds", dt)
        nbytes = _dir_bytes(path)
        if nbytes > max_mb * (1 << 20):
            shutil.rmtree(path, ignore_errors=True)
            m.inc("profile_captures_total", result="over_budget")
            raise ValueError(
                f"capture wrote {nbytes} bytes, over the "
                f"PROFILE_CAPTURE_MAX_MB={max_mb:g} budget — trace deleted"
            )
        m.inc("profile_captures_total", result="ok")
        last = {"dir": path, "seconds": round(dt, 3), "bytes": nbytes, "at": time.time()}
        with _LOCK:
            _CAPTURE_STATE["last"] = last
        return dict(last)
    finally:
        with _LOCK:
            _CAPTURE_STATE["running"] = False
        _CAPTURE_LOCK.release()


# -------------------------------------------------------------- reporting


def profile_report(metrics=None, total_bytes: float | None = None) -> dict:
    """The ``/debug/profile`` payload: ranked kernels, plane accounting,
    peaks and capture state in one snapshot."""
    backend = _default_backend()
    if total_bytes is None:
        total_bytes = live_device_bytes()
    return {
        "backend": backend,
        "peaks": backend_peaks(backend),
        "entries": entry_report(metrics=metrics, backend=backend),
        "planes": plane_bytes(total_bytes),
        "live_device_bytes": total_bytes,
        "plane_watermark_bytes": plane_watermark(),
        "capture": capture_state(),
    }


# The shipped plane set starts as zero-byte placeholders, so the
# device_plane_bytes series are the same from the first tick; each owning
# module re-registers its name with its real provider when it loads
# (ops/bls_batch, state_transition/resident, witness/service, ops/bls_sign).
register_plane("registry_planes", lambda: 0.0)
register_plane("resident_epoch", lambda: 0.0)
register_plane("witness_buffers", lambda: 0.0, device=False)
register_plane("duty_sign_ladders", lambda: 0.0)
