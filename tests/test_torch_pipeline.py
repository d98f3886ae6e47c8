"""The port's ingest scheduler against the JAX package's.

Seeded ``submit`` sequences (numpy) run through ``IngestScheduler`` of both
packages, over the lanes of the node's table (``node/node.py``
``_build_ingest_scheduler``: block, blob, aggregate, subnet and other, with
their weights, batch sizes, queues, shed rules and the ``NodeConfig``
deadlines of 25, 50 and 150 ms), once at the node's sizes and once with
every queue and the global budget cut 64-fold so that sheds, the overload
policy and the degraded latch engage.  Fake sources record each flush; the
subnet lane multiplexes two sources, and one source submits a block while
its flush runs (the head-of-line preemption).  ``time`` is pinned in both
scheduler modules and both ``tracing`` modules to one scripted clock that
only the test advances, and each step wakes the loop and lets it settle,
so flush order, sizes and causes, shed victims and counters, the degraded
latch, ``snapshot()``, both registries and the flight recorder compare
exactly.  The JAX scheduler runs only with lane kinds that no shape bucket
is registered for (its bucket registry is process-global), so neither
package snaps a flush.

Also: the pure policy functions, parametrised; and the port's one
divergence — a ``RuntimeError`` from a source ends its drain loop with no
restart and no ``ingest_flush_error_count``; it counts once in
``ingest_loop_crash_count``, leaves a ``drain_fault`` event on the flight
recorder, and the next ``submit()`` and ``stop()`` raise it — while a
``ValueError`` is counted and contained as in the JAX package.
"""

import asyncio
import types

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu import telemetry as jtel
from lambda_ethereum_consensus_tpu import tracing as jtracing
from lambda_ethereum_consensus_tpu import pipeline as jpipe
from lambda_ethereum_consensus_tpu.ops.aot import shape_buckets as jax_shape_buckets
from lambda_ethereum_consensus_tpu.pipeline import scheduler as jsched
from lambda_ethereum_consensus_tpu_torch import pipeline as ppipe
from lambda_ethereum_consensus_tpu_torch import telemetry as ptel
from lambda_ethereum_consensus_tpu_torch import tracing as ptracing
from lambda_ethereum_consensus_tpu_torch.fork_choice import attestation_batch_target
from lambda_ethereum_consensus_tpu_torch.pipeline import scheduler as psched

PKGS = {
    "jax": types.SimpleNamespace(pipe=jpipe, sched=jsched, tel=jtel, tracing=jtracing),
    "port": types.SimpleNamespace(pipe=ppipe, sched=psched, tel=ptel, tracing=ptracing),
}
# a lane kind no bucket is registered for: the JAX scheduler flushes unsnapped
UNWARMED = "torch_parity_unwarmed_kind"
# NodeConfig's deadlines and global budget, and the blob lane's coalesce target
BLOCK_MS, BLOB_MS, ATT_MS, MAX_ITEMS, MAX_BLOBS = 25, 50, 150, 24576, 6


def node_lanes(scale: int = 1) -> list[dict]:
    """The node's lane table (``node/node.py:654-705``), every queue bound
    divided by ``scale``."""
    att_target = min(attestation_batch_target(), 8192)
    return [
        dict(name="block", priority=0, weight=64, max_batch=64, max_queue=1024 // scale,
             deadline_s=BLOCK_MS / 1000.0, coalesce_target=1, shed_newest=True),
        dict(name="blob", priority=1, weight=64, max_batch=64, max_queue=1024 // scale,
             deadline_s=BLOB_MS / 1000.0, coalesce_target=MAX_BLOBS, shed_newest=True),
        dict(name="aggregate", priority=2, weight=4096, max_batch=8192,
             max_queue=16384 // scale, deadline_s=ATT_MS / 1000.0,
             coalesce_target=att_target, shape_kind=UNWARMED),
        dict(name="subnet", priority=3, weight=4096, max_batch=8192,
             max_queue=16384 // scale, deadline_s=ATT_MS / 1000.0,
             coalesce_target=att_target, shape_kind=UNWARMED),
        dict(name="other", priority=4, weight=64, max_batch=64, max_queue=1024 // scale,
             deadline_s=0.2, coalesce_target=16),
    ]


class _FakeTime:
    """The clock the scheduler and the recorder read: only the test moves it."""

    def __init__(self):
        self.now = 5000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return 0.0

    def time(self):
        return self.now


@pytest.fixture
def fake_time(monkeypatch):
    clock = _FakeTime()
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.sched, "time", clock)
        monkeypatch.setattr(pkg.tracing, "time", clock)
        monkeypatch.setattr(pkg.tel, "_DEFAULT", pkg.tel.Metrics(enabled=True))
        monkeypatch.setattr(pkg.tracing, "_RECORDER", pkg.tracing.FlightRecorder())
    assert jax_shape_buckets(UNWARMED) == ()
    return clock


class _Source:
    """A lane source that logs each flush as ``(name, items)`` and ends
    each item's trace; ``inject`` submits more items during its first
    flush."""

    def __init__(self, name: str, log: list, inject=None):
        self.name = name
        self.log = log
        self.inject = inject
        self.shed_items = []

    async def process(self, items):
        self.log.append((self.name, [item for item, _ in items]))
        for _, trace in items:
            if trace is not None:
                trace.end("done", {"source": self.name})
        if self.inject is not None:
            inject, self.inject = self.inject, None
            inject()

    async def shed(self, item, reason="overload"):
        self.shed_items.append((item, reason))


def _steps(seed: int, scale: int) -> list:
    """(advance seconds, [(lane, source index, traced)]) per step."""
    rng = np.random.default_rng(seed)
    lanes = ["block", "blob", "aggregate", "subnet", "other"]
    weights = np.array([0.05, 0.1, 0.35, 0.45, 0.05])
    advances = [0.0, 0.004, 0.02, 0.03, 0.06, 0.16, 0.25, 6.0]
    burst = 40 if scale == 1 else 700
    steps = []
    for _ in range(60):
        n = int(rng.integers(0, burst))
        picks = rng.choice(len(lanes), size=n, p=weights)
        submits = [(lanes[int(k)], int(rng.integers(0, 2)), bool(rng.random() < 0.3))
                   for k in picks]
        steps.append((advances[int(rng.integers(0, len(advances)))], submits))
    return steps


async def _settle(sched, clock):
    """Wake the loop and let it run until no lane is ready at the pinned
    instant and nothing is in flight."""
    sched._wake.set()
    for _ in range(10_000):
        await asyncio.sleep(0)
        if sched._inflight == 0 and not any(lane.ready(clock.now) for lane in sched._order):
            break
    else:
        raise AssertionError("the drain loop did not settle")
    for _ in range(20):
        await asyncio.sleep(0)


def _drive(name: str, clock, steps, scale: int) -> dict:
    pkg = PKGS[name]
    log: list = []

    async def main():
        node_metrics = pkg.tel.Metrics(enabled=True)
        sched = pkg.sched.IngestScheduler(metrics=node_metrics, max_items=MAX_ITEMS // scale)
        for cfg in node_lanes(scale):
            if name == "port":
                cfg = {k: v for k, v in cfg.items() if k != "shape_kind"}
            sched.add_lane(pkg.pipe.LaneConfig(**cfg))
        counter = iter(range(10**9))
        late_block = _Source("late block", log)

        def submit(lane, src, traced):
            item = next(counter)
            trace = pkg.tracing.new_trace(f"gossip_{lane}") if traced else None
            shed = sched.submit(lane, (item, trace), src, trace)
            return [(s.name, it[0], reason) for s, it, reason in shed]

        sources = {lane: [_Source(f"{lane} {i}", log) for i in range(2)]
                   for lane in ("block", "blob", "aggregate", "subnet", "other")}
        sources["subnet"][1].inject = lambda: submit("block", late_block, False)
        sched.start()
        sheds, snaps = [], []
        try:
            for advance, submits in steps:
                clock.now += advance
                for lane, k, traced in submits:
                    sheds.append(submit(lane, sources[lane][k], traced))
                await _settle(sched, clock)
                snaps.append(sched.snapshot())
        finally:
            await sched.stop()
        return dict(
            log=log, sheds=sheds, snaps=snaps, degraded=sched.degraded.active(clock.now),
            node_metrics=node_metrics.render_prometheus(self_scrape=False),
            metrics=_without_sched_seconds(
                pkg.tel.get_metrics().render_prometheus(self_scrape=False)),
            recorder=[{k: v for k, v in ev.items() if k != "trace_id"}
                      for ev in pkg.tracing.get_recorder().snapshot()],
        )

    return asyncio.run(asyncio.wait_for(main(), timeout=120))


def _without_sched_seconds(text: str) -> str:
    """The registry text without ``ingest_sched_seconds``: the idle loop
    observes it each time its real-time wait expires."""
    return "\n".join(line for line in text.splitlines() if "ingest_sched_seconds" not in line)


@pytest.mark.parametrize("seed,scale", [(0, 1), (1, 1), (2, 64), (3, 64)])
def test_seeded_submits_agree(fake_time, seed, scale):
    steps = _steps(seed, scale)
    start = fake_time.now
    want = _drive("jax", fake_time, steps, scale)
    fake_time.now = start
    got = _drive("port", fake_time, steps, scale)
    assert got["log"] == want["log"]
    assert got["sheds"] == want["sheds"]
    assert got["snaps"] == want["snaps"]
    assert got["degraded"] == want["degraded"]
    assert got["node_metrics"] == want["node_metrics"]
    assert got["metrics"] == want["metrics"]
    assert got["recorder"] == want["recorder"]
    assert any(name == "late block" for name, _ in got["log"])
    assert "ingest_flush_count" in got["metrics"]
    if scale > 1:
        assert 'reason="overload"' in got["metrics"] and 'reason="lane_full"' in got["metrics"]
        assert "ingest_degraded_transitions_total" in got["metrics"]


# ------------------------------------------------------------------- policy

@pytest.mark.parametrize("n,buckets,want", [
    (100, (16, 64, 256), 64), (64, (16, 64, 256), 64), (10, (16, 64), 10),
    (7, (), 7), (1, (1,), 1), (300, (256, 16, 64), 256),
])
def test_snap_batch(n, buckets, want):
    assert ppipe.snap_batch(n, buckets) == jpipe.snap_batch(n, buckets) == want


@pytest.mark.parametrize("depths,incoming,want", [
    ((0, 0, 5, 5), 0, 3), ((0, 0, 5, 0), 0, 2), ((3, 0, 0, 0), 2, None),
    ((3, 0, 0, 1), 3, 3), ((0, 2, 0, 0), 1, 1), ((0, 0, 0, 0), 0, None),
])
def test_choose_shed_victim(depths, incoming, want):
    picked = {}
    for name, pkg in PKGS.items():
        lanes = []
        for prio, depth in enumerate(depths):
            lane = pkg.pipe.Lane(pkg.pipe.LaneConfig(name=f"l{prio}", priority=prio))
            for i in range(depth):
                lane.push(float(i), i, None)
            lanes.append(lane)
        victim = pkg.pipe.choose_shed_victim(lanes, lanes[incoming])
        picked[name] = None if victim is None else victim.config.priority
    assert picked["port"] == picked["jax"] == want


@pytest.mark.parametrize("marks,probe", [
    ((), 1.0), ((0.0,), 1.0), ((0.0,), 5.0), ((0.0, 4.0), 8.0), ((0.0, 10.0), 12.0),
])
def test_degraded_signal(marks, probe):
    out = {}
    for name, pkg in PKGS.items():
        sig = pkg.pipe.DegradedSignal(window_s=5.0)
        edges = [sig.mark(t) for t in marks]
        out[name] = (edges, sig.active(probe), sig.remaining(probe))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("target,deadline,pushes,probe", [
    (3, 0.5, (0.0,), 0.1), (3, 0.5, (0.0,), 0.6), (3, 0.5, (0.0, 0.1, 0.2), 0.25),
    (1, 0.025, (), 0.0), (16, 0.2, (0.0,) * 15, 0.19),
])
def test_lane_ready_and_deadline(target, deadline, pushes, probe):
    out = {}
    for name, pkg in PKGS.items():
        lane = pkg.pipe.Lane(pkg.pipe.LaneConfig(name="l", priority=0, coalesce_target=target,
                                                 deadline_s=deadline, max_queue=64))
        for t in pushes:
            lane.push(t, "x", None)
        out[name] = (lane.ready(probe), lane.next_deadline(), lane.occupancy(),
                     [e[0] for e in lane.take(2)], len(lane))
    assert out["port"] == out["jax"]


def test_add_lane_rejects_bad_sizes():
    for pkg in PKGS.values():
        sched = pkg.sched.IngestScheduler(metrics=pkg.tel.Metrics(enabled=True))
        sched.add_lane(pkg.pipe.LaneConfig(name="a", priority=0))
        with pytest.raises(ValueError, match="duplicate lane"):
            sched.add_lane(pkg.pipe.LaneConfig(name="a", priority=1))
        with pytest.raises(ValueError, match="must be >= 1"):
            sched.add_lane(pkg.pipe.LaneConfig(name="b", priority=1, weight=0))


def test_lane_config_has_no_shape_kind():
    assert "shape_kind" in jpipe.LaneConfig.__dataclass_fields__
    assert "shape_kind" not in ppipe.LaneConfig.__dataclass_fields__


# ------------------------------------------------------- the one divergence

class _Failing:
    def __init__(self, exc):
        self.exc = exc
        self.calls = 0

    async def process(self, items):
        self.calls += 1
        raise self.exc("flush failed")


def _fail_once(name: str, exc) -> dict:
    pkg = PKGS[name]

    async def main():
        sched = pkg.sched.IngestScheduler(metrics=pkg.tel.Metrics(enabled=True))
        sched.add_lane(pkg.pipe.LaneConfig(name="l", priority=0, deadline_s=0.001))
        ok = _Source("ok", [])
        bad = _Failing(exc)
        sched.start()
        sched.submit("l", ("a", None), bad)
        for _ in range(200):
            await asyncio.sleep(0.005)
            if bad.calls:
                break
        await asyncio.sleep(0.05)
        task = sched._task
        alive = task is not None and not task.done()
        submit_raised = None
        try:
            sched.submit("l", ("b", None), ok)
        except Exception as e:  # noqa: BLE001 - what submit() raises is the result
            submit_raised = e
        for _ in range(40):
            await asyncio.sleep(0.005)
        raised = None
        try:
            await sched.stop()
        except Exception as e:  # noqa: BLE001 - what stop() raises is the result
            raised = e
        m = pkg.tel.get_metrics()
        return dict(
            alive=alive, submit_raised=submit_raised, raised=raised, later=ok.log,
            errors=m.get("ingest_flush_error_count", lane="l"),
            crashes=m.get("ingest_loop_crash_count"),
            restarts=m.get("pipeline_drain_restarts_total"),
            events=[(ev["name"], ev["args"]) for ev in pkg.tracing.get_recorder().snapshot()
                    if ev["name"] in ("drain_fault", "drain_restart")],
        )

    return asyncio.run(asyncio.wait_for(main(), timeout=30))


@pytest.fixture
def fresh_registries(monkeypatch):
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.tel, "_DEFAULT", pkg.tel.Metrics(enabled=True))
        monkeypatch.setattr(pkg.tracing, "_RECORDER", pkg.tracing.FlightRecorder(enabled=True))


def test_runtime_error_from_a_source_surfaces_in_the_port(fresh_registries):
    want = _fail_once("jax", RuntimeError)
    assert want["alive"] and want["raised"] is None and want["errors"] == 1
    assert want["submit_raised"] is None and want["later"] == [("ok", ["b"])]
    got = _fail_once("port", RuntimeError)
    assert not got["alive"]
    # the next submit raises the fault: nothing is admitted into a dead loop
    assert isinstance(got["submit_raised"], RuntimeError)
    assert str(got["submit_raised"]) == "flush failed"
    assert got["raised"] is got["submit_raised"]
    assert got["later"] == []  # no restart: the loop stayed down
    assert (got["errors"], got["crashes"], got["restarts"]) == (0, 1, 0)
    assert got["events"] == [
        ("drain_fault", {"error": "RuntimeError", "message": "flush failed"})]


def test_value_error_from_a_source_is_contained_in_both(fresh_registries):
    want = _fail_once("jax", ValueError)
    got = _fail_once("port", ValueError)
    assert got == want
    assert got["alive"] and got["raised"] is None and got["errors"] == 1
    assert got["submit_raised"] is None and got["events"] == []
    assert got["later"] == [("ok", ["b"])]
