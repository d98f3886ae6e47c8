"""The port's flight recorder, item traces and batch fan-in against the JAX
package's ``tracing.py``.

Both modules run the same call sequence on a fresh recorder and a fresh
telemetry registry of their own (each package's ``_RECORDER`` and
``_DEFAULT`` swapped per test).  Timing fields (``ts``, ``ts_us``,
``dur_us``, the chrome export's ``ts``/``dur`` and the admission→apply
latencies) are pinned, not compared by structure: each module's ``time``
is swapped for the same scripted clock, whose ``monotonic()`` and
``time()`` step by 1 ms from a fixed instant on every read, so equal call
sequences read equal instants.  Trace and batch ids come from each fresh
recorder's own counter and compare exactly.  Tolerance: none.
"""

import pytest

from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu import tracing as jtracing
from lambda_ethereum_consensus_tpu_torch import telemetry as ptelemetry
from lambda_ethereum_consensus_tpu_torch import tracing as ptracing

PACKAGES = {"jax": (jtracing, jtelemetry), "port": (ptracing, ptelemetry)}


class _Clock:
    """A stand-in for the ``time`` module: every read advances 1 ms."""

    def __init__(self, start: float = 1000.0):
        self.now = start

    def _tick(self) -> float:
        self.now += 0.001
        return self.now

    def monotonic(self) -> float:
        return self._tick()

    def time(self) -> float:
        return self._tick()

    def perf_counter(self) -> float:
        return self._tick()


@pytest.fixture
def fresh(monkeypatch):
    """Per package: a fresh enabled recorder, a fresh enabled registry and
    the scripted clock in its tracing module."""
    for tracing, telemetry in PACKAGES.values():
        monkeypatch.setattr(tracing, "_RECORDER", tracing.FlightRecorder(enabled=True))
        monkeypatch.setattr(telemetry, "_DEFAULT", telemetry.Metrics(enabled=True))
        monkeypatch.setattr(tracing, "time", _Clock())
    return PACKAGES


def _both(fn) -> tuple:
    return tuple(fn(*PACKAGES[name]) for name in ("jax", "port"))


# ------------------------------------------------------------- recorder


def _ring(tracing, _telemetry):
    rec = tracing.FlightRecorder(capacity=4, enabled=True)
    for i in range(10):
        rec.record("inst", 0, f"event{i}", {"i": i}, ts_us=i)
    return rec.stats(), rec.snapshot()


def test_recorder_ring_is_bounded_overwrite_oldest():
    want, got = _both(_ring)
    assert got == want
    stats, snap = got
    assert stats == {"capacity": 4, "events": 4, "appended_total": 10,
                     "dropped_total": 6, "enabled": True}
    assert [ev["name"] for ev in snap] == ["event6", "event7", "event8", "event9"]


def _clipped(tracing, _telemetry):
    rec = tracing.FlightRecorder(capacity=8, enabled=True)
    short = {"reason": "x" * 10, "n": 3}
    rec.record("inst", 0, "short", short, ts_us=1)
    rec.record("inst", 0, "long", {"reason": "y" * 500, "n": 4}, ts_us=2)
    snap = rec.snapshot()
    return snap, snap[0]["args"] is short, tracing._clip_args({}), tracing._MAX_ARG_CHARS


def test_args_are_clipped_to_the_max_chars():
    want, got = _both(_clipped)
    assert got == want
    snap, unchanged, empty, limit = got
    assert unchanged and empty is None and limit == 200
    assert snap[1]["args"] == {"reason": "y" * 200, "n": 4}


def _capped(tracing, _telemetry):
    trace = tracing.new_trace("gossip_attestation")
    for i in range(40):
        trace.event("requeue", n=i)
    trace.end("done", {"verdict": "accept"})
    trace.end("shed", {"reason": "late"})  # idempotent: the first end wins
    trace.event("after_end")
    return tracing.get_recorder().snapshot(), tracing._MAX_TRACE_EVENTS


def test_per_trace_event_cap_and_idempotent_end(fresh):
    want, got = _both(_capped)
    assert got == want
    snap, cap = got
    assert cap == 24
    kinds = [ev["kind"] for ev in snap]
    assert kinds == ["begin"] + ["inst"] * cap + ["end"]
    assert snap[-1]["args"] == {"stage": "done", "verdict": "accept"}


def _noop(tracing, _telemetry):
    rec = tracing.FlightRecorder(capacity=4, enabled=False)
    rec.record("inst", 0, "ignored", {"a": 1})
    live = tracing.ItemTrace(rec, 7, "label", 0.5)
    live.event("enqueue")
    live.end("done")
    tracing._RECORDER = rec
    minted = tracing.new_trace("gossip_attestation")
    stats = rec.stats()
    rec.set_enabled(True)
    on = tracing.new_trace("gossip_attestation")
    return stats, rec.snapshot(), minted, on is not None


def test_noop_mode_records_nothing_and_new_trace_is_none(fresh):
    want, got = _both(_noop)
    assert got == want
    stats, snap, minted, on = got
    assert stats["events"] == 0 and stats["appended_total"] == 0 and not stats["enabled"]
    assert snap == [] and minted is None and on


@pytest.mark.parametrize("value, capacity", [("7", 7), ("lots", 16384), ("", 16384), ("0", 1)])
def test_recorder_capacity_knob(monkeypatch, value, capacity):
    monkeypatch.setenv("TRACE_RECORDER_CAPACITY", value)
    caps = _both(lambda tracing, _t: tracing.FlightRecorder().stats()["capacity"])
    assert caps == (capacity, capacity)


@pytest.mark.parametrize("flag, enabled", [("1", False), ("0", True), ("", True)])
def test_recorder_shares_the_telemetry_polarity(monkeypatch, flag, enabled):
    monkeypatch.setenv("TELEMETRY_OFF", flag)
    polarity = _both(lambda tracing, _t: tracing.FlightRecorder().enabled)
    assert polarity == (enabled, enabled)


def test_get_recorder_is_the_package_singleton(monkeypatch):
    monkeypatch.setattr(ptracing, "_RECORDER", None)
    rec = ptracing.get_recorder()
    assert ptracing.get_recorder() is rec and isinstance(rec, ptracing.FlightRecorder)
    assert rec is not jtracing.get_recorder()


# --------------------------------------------------------- batch fan-in


def _fan_in(tracing, telemetry):
    rec = tracing.get_recorder()
    t1 = tracing.new_trace("gossip_attestation")
    t2 = tracing.new_trace("gossip_attestation", node="node-b")
    t3 = tracing.new_trace("gossip_aggregate")
    t1.event("enqueue", lane="attestation")
    t1.event("dequeue")
    t0 = tracing.time.monotonic()
    batch = tracing.record_verify_batch(
        [t1, None, t2, t3], [None, None, "invalid attestation signature", None],
        "cached", t0, 0.0042, n_devices=1)
    none_batch = tracing.record_verify_batch([None, None], [None, None], "host", t0, 0.001)
    for t in (t1, t2, t3):
        t.end("done", {"verdict": "accept"})
    rec.record("inst", 0, "ingest_degraded", {"on": True})
    rec.record("flow_s", 9, "publish", {"flow": "ab12"}, node="node-a")
    rec.record("flow_f", 9, "admit", {"flow": "ab12"}, node="node-b")
    full, node_b = rec.chrome(), rec.chrome(node="node-b")
    merged = tracing.merge_chrome_traces([full, node_b, None, {"traceEvents": []}])
    admit = telemetry.get_metrics().get_histogram("attestation_admit_apply_seconds")
    return dict(batch=batch, none_batch=none_batch, snapshot=rec.snapshot(), chrome=full,
                node_b=node_b, merged=merged, stats=rec.stats(), admit=admit)


def test_record_verify_batch_snapshot_chrome_and_merge_match_jax(fresh):
    want, got = _both(_fan_in)
    assert got == want
    assert got["batch"] is not None and got["none_batch"] is None
    span = [ev for ev in got["snapshot"] if ev["kind"] == "span"]
    assert len(span) == 1 and span[0]["name"] == "attestation_batch_verify"
    assert span[0]["args"]["n"] == 4 and span[0]["args"]["n_members"] == 3
    assert span[0]["args"]["path"] == "cached" and span[0]["dur_us"] == 4200
    verifies = [ev for ev in got["snapshot"] if ev["name"] == "verify"]
    assert len(verifies) == 3 and all(ev["args"]["batch"] == got["batch"] for ev in verifies)
    assert sum(1 for ev in got["snapshot"] if ev["name"] == "apply") == 2
    assert sum(1 for ev in got["snapshot"] if ev["name"] == "drop") == 1
    # two accepted members: two admission->apply samples
    assert got["admit"][3] == 2
    pids = {ev["pid"] for ev in got["merged"]["traceEvents"] if ev.get("ph") == "M"}
    assert len(pids) == 3


def test_record_verify_batch_with_recorder_off_still_observes_latency(fresh):
    def run(tracing, telemetry):
        rec = tracing.get_recorder()
        trace = tracing.new_trace("gossip_attestation")
        rec.set_enabled(False)
        batch = tracing.record_verify_batch([trace], [None], "host", trace.t0, 0.001)
        trace.end("done")
        admit = telemetry.get_metrics().get_histogram("attestation_admit_apply_seconds")
        return batch, rec.snapshot(), admit

    want, got = _both(run)
    assert got == want
    batch, snap, admit = got
    assert batch is None and snap == [] and admit[3] == 1


def test_members_list_is_clipped_at_128(fresh):
    def run(tracing, _telemetry):
        traces = [tracing.new_trace("gossip_attestation") for _ in range(200)]
        tracing.record_verify_batch(traces, [None] * 200, "cached",
                                    tracing.time.monotonic(), 0.5)
        return [ev for ev in tracing.get_recorder().snapshot() if ev["kind"] == "span"]

    want, got = _both(run)
    assert got == want
    (span,) = got
    assert len(span["args"]["members"]) == 128 and span["args"]["n_members"] == 200
