"""The port's SLO engine (``slo.py``) against the JAX package's.

Both packages' functions and engines see the same inputs: the quantile
estimate and the good fraction on handcrafted buckets and under
``hypothesis``; every ``SloDef`` row of the four tables; and both
``SloEngine``s, each over its own package's registry fed the same
observations, ticked and evaluated at the same explicit ``now`` values with
the same start instant.  The reports are compared whole (quantiles, burn
rates per window, ``ok``, ``breaching``, violations), and so are the
registries' Prometheus renders, which carry the engines' gauges and
counters.  Nothing here reads the wall clock.  Tolerance: none.
"""

import dataclasses
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lambda_ethereum_consensus_tpu import slo as jslo
from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu_torch import slo
from lambda_ethereum_consensus_tpu_torch import telemetry

T0 = 1_000.0  # both engines' start instant


def _pair(**kwargs):
    """(jax engine, jax registry, port engine, port registry): one engine
    per package over a fresh registry of its own, both started at T0.
    ``slos`` are given as tuples of ``SloDef`` fields."""
    rows = kwargs.pop("slos")
    jm, pm = jtelemetry.Metrics(enabled=True), telemetry.Metrics(enabled=True)
    je = jslo.SloEngine(slos=tuple(jslo.SloDef(*r) for r in rows), metrics=jm, **kwargs)
    pe = slo.SloEngine(slos=tuple(slo.SloDef(*r) for r in rows), metrics=pm, **kwargs)
    je._t0 = pe._t0 = T0
    return je, jm, pe, pm


def _observe(registries, name, values, **labels):
    for m in registries:
        for v in values:
            m.observe(name, v, **labels)


def _render(m) -> str:
    return m.render_prometheus(self_scrape=False)


# ------------------------------------------------------ the two estimators

_HANDCRAFTED = [
    ((1.0, 2.0, 4.0, 8.0), [0, 0, 10, 0, 0]),
    ((1.0, 2.0, 4.0, 8.0), [10, 0, 0, 0, 0]),
    ((1.0, 2.0), [0, 0, 5]),
    ((1.0, 2.0, 4.0), [4, 0, 4, 2]),
    ((1.0, 2.0, 4.0), [0, 0, 0, 0]),
    ((0.5, 0.5, 3.0), [1, 2, 3, 0]),  # a repeated bound
    (tuple(1e-4 * 2.0**i for i in range(21)), [3, 0, 7, 1, 0, 0, 9] + [0] * 14 + [2]),
]


@pytest.mark.parametrize("bounds,counts", _HANDCRAFTED)
@pytest.mark.parametrize("q", [0.01, 0.5, 0.9, 0.95, 0.99])
def test_estimate_quantile_handcrafted(bounds, counts, q):
    assert slo.estimate_quantile(bounds, counts, q) == jslo.estimate_quantile(bounds, counts, q)


@pytest.mark.parametrize("bounds,counts", _HANDCRAFTED)
@pytest.mark.parametrize("budget", [0.0, 1e-4, 0.75, 1.0, 3.0, 8.0, 100.0])
def test_good_fraction_handcrafted(bounds, counts, budget):
    assert slo.good_fraction(bounds, counts, budget) == jslo.good_fraction(bounds, counts, budget)


_bounds = st.lists(st.floats(1e-6, 1e3, allow_nan=False), min_size=1, max_size=24).map(
    lambda xs: tuple(sorted(xs)))


@st.composite
def _histograms(draw):
    bounds = draw(_bounds)
    counts = draw(st.lists(st.integers(0, 10**6), min_size=len(bounds) + 1,
                           max_size=len(bounds) + 1))
    return bounds, counts


@settings(max_examples=300, deadline=None)
@given(_histograms(), st.floats(1e-6, 1 - 1e-6))
def test_estimate_quantile_property(hist, q):
    bounds, counts = hist
    assert slo.estimate_quantile(bounds, counts, q) == jslo.estimate_quantile(bounds, counts, q)


@settings(max_examples=300, deadline=None)
@given(_histograms(), st.floats(0.0, 2e3, allow_nan=False))
def test_good_fraction_property(hist, budget):
    bounds, counts = hist
    assert slo.good_fraction(bounds, counts, budget) == jslo.good_fraction(bounds, counts, budget)


# ---------------------------------------------------------- the definitions


@pytest.mark.parametrize("table", ["DEFAULT_SLOS", "STORAGE_SLOS", "SOAK_SLOS", "FLEET_SLOS"])
def test_slo_tables_equal(table):
    got = [dataclasses.astuple(s) for s in getattr(slo, table)]
    want = [dataclasses.astuple(s) for s in getattr(jslo, table)]
    assert got == want and len(got) == len({s[0] for s in got})
    assert slo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS


def test_slos_for_family_equal():
    families = {s.family for s in jslo.FLEET_SLOS} | {"ghost_seconds"}
    for family in sorted(families):
        got = [dataclasses.astuple(s) for s in slo.slos_for_family(family)]
        assert got == [dataclasses.astuple(s) for s in jslo.slos_for_family(family)]


@pytest.mark.parametrize("fields", [
    ("x", "x_seconds", 1.5, 1.0),
    ("x", "x_seconds", 0.0, 1.0),
    ("x", "x_seconds", 0.95, 0.0),
    ("x", "x_seconds", 0.95, -2.0),
])
def test_slodef_validation_equal(fields):
    with pytest.raises(ValueError) as want:
        jslo.SloDef(*fields)
    with pytest.raises(ValueError) as got:
        slo.SloDef(*fields)
    assert str(got.value) == str(want.value)


def test_duplicate_slo_names_refused():
    rows = (("dup", "a_seconds", 0.5, 1.0), ("dup", "b_seconds", 0.5, 1.0))
    with pytest.raises(ValueError, match="duplicate SLO names"):
        slo.SloEngine(slos=tuple(slo.SloDef(*r) for r in rows))
    with pytest.raises(ValueError, match="duplicate SLO names"):
        jslo.SloEngine(slos=tuple(jslo.SloDef(*r) for r in rows))


# ------------------------------------------------------------ the engines


def _scenario_pass_fail(e):
    _observe(e["ms"], "x_seconds", [0.010] * 100)
    _observe(e["ms"], "y_seconds", [0.2] * 40 + [3.0] * 10)
    return [("evaluate", T0 + 5.0)]


def _scenario_label_filter(e):
    for _ in range(50):
        _observe(e["ms"], "r_seconds", [0.001], route="/fast")
        _observe(e["ms"], "r_seconds", [5.0], route="/slow")
    return [("evaluate", T0 + 1.0)]


def _scenario_no_data(e):
    return [("evaluate", T0 + 1.0), ("evaluate", T0 + 2.0)]


def _scenario_windows(e):
    steps = [("tick", T0 + 10.0)]
    _observe(e["ms"], "x_seconds", [0.01] * 1000)
    steps.append(("tick", T0 + 70.0))
    steps.append(("observe", ("x_seconds", [5.0] * 100)))
    steps.append(("evaluate", T0 + 3610.0))
    return steps


def _scenario_zero_traffic(e):
    _observe(e["ms"], "x_seconds", [5.0] * 10)
    return [("tick", T0 + 5.0), ("evaluate", T0 + 95.0)]


def _scenario_young_process(e):
    _observe(e["ms"], "x_seconds", [5.0] * 100)
    return [("evaluate", T0 + 1.0)]


def _scenario_overflow(e):
    _observe(e["ms"], "x_seconds", [500.0] * 3 + [0.02] * 7)
    return [("evaluate", T0 + 1.0), ("tick", T0 + 2.0), ("evaluate", T0 + 400.0)]


_ROWS = (
    ("x_p95", "x_seconds", 0.95, 0.1, "the x path"),
    ("x_p50", "x_seconds", 0.5, 0.02, "", (), 2.0),
    ("y_p99", "y_seconds", 0.99, 1.0, "the y path"),
    ("fast_p95", "r_seconds", 0.95, 0.1, "", (("route", "/fast"),)),
    ("all_p95", "r_seconds", 0.95, 0.1),
    ("ghost_p95", "ghost_seconds", 0.95, 1.0),
)


@pytest.mark.parametrize("scenario,windows", [
    (_scenario_pass_fail, slo.DEFAULT_WINDOWS),
    (_scenario_label_filter, slo.DEFAULT_WINDOWS),
    (_scenario_no_data, slo.DEFAULT_WINDOWS),
    (_scenario_windows, (("fast", 60.0), ("slow", 3600.0))),
    (_scenario_zero_traffic, (("fast", 60.0),)),
    (_scenario_young_process, (("slow", 3600.0),)),
    (_scenario_overflow, slo.DEFAULT_WINDOWS),
], ids=["pass_fail", "label_filter", "no_data", "windows", "zero_traffic", "young_process",
        "overflow"])
def test_engine_reports_equal(scenario, windows):
    je, jm, pe, pm = _pair(slos=_ROWS, windows=windows)
    steps = scenario({"ms": (jm, pm)})
    reports = 0
    for kind, arg in steps:
        if kind == "tick":
            je.tick(now=arg)
            pe.tick(now=arg)
        elif kind == "observe":
            _observe((jm, pm), *arg)
        else:
            want = je.evaluate(now=arg)
            got = pe.evaluate(now=arg)
            assert got == want
            reports += 1
            # read-only evaluations leave both registries and histories alone
            assert pe.evaluate(now=arg + 1.0, emit=False, snapshot=False) == \
                je.evaluate(now=arg + 1.0, emit=False, snapshot=False)
    assert reports and _render(pm) == _render(jm)
    assert [(s.ts, s.by_slo) for s in pe._snaps] == [(s.ts, s.by_slo) for s in je._snaps]


def test_engine_over_the_default_table():
    """Every DEFAULT_SLOS row fed: some within budget, some over, the duty
    row's label filter selecting one series of its family."""
    je, jm, pe, pm = _pair(slos=[dataclasses.astuple(s) for s in jslo.DEFAULT_SLOS])
    for i, s in enumerate(jslo.DEFAULT_SLOS):
        values = [s.budget * f for f in (0.1, 0.5, 0.9, 1.5 if i % 2 else 0.7)] * (5 + i)
        labels = dict(s.labels)
        _observe((jm, pm), s.family, values, **labels)
        if labels:
            _observe((jm, pm), s.family, [s.budget * 10] * 50, type="propose")
    je.tick(now=T0 + 30.0)
    pe.tick(now=T0 + 30.0)
    _observe((jm, pm), "api_request_seconds", [0.9] * 40, route="/eth/v1/node/health")
    want = je.evaluate(now=T0 + 90.0)
    assert pe.evaluate(now=T0 + 90.0) == want
    assert not want["ok"] and all(r["status"] != "no_data" for r in want["slos"])
    assert _render(pm) == _render(jm)


def test_disabled_registry_emits_nothing():
    je, jm, pe, pm = _pair(slos=_ROWS[:1])
    for m in (jm, pm):
        m.set_enabled(False)
    assert pe.evaluate(now=T0 + 1.0) == je.evaluate(now=T0 + 1.0)
    assert pm.key_count() == jm.key_count() == 0


def test_snapshot_history_is_bounded():
    je, jm, pe, pm = _pair(slos=_ROWS[:2], max_snapshots=8)
    for i in range(100):
        _observe((jm, pm), "x_seconds", [0.001 * i])
        je.tick(now=float(i))
        pe.tick(now=float(i))
    assert len(pe._snaps) == len(je._snaps) == 8
    assert [(s.ts, s.by_slo) for s in pe._snaps] == [(s.ts, s.by_slo) for s in je._snaps]
    assert pe.evaluate(now=104.0) == je.evaluate(now=104.0)


def test_concurrent_evaluate():
    """Four threads evaluate one engine at once (the node's tick and the
    ``/debug/slo`` worker do): no error, every evaluation counted, and the
    registry ends where the JAX engine's serial run ends."""
    je, jm, pe, pm = _pair(slos=_ROWS[:1])
    _observe((jm, pm), "x_seconds", [0.01] * 100)
    errors = []

    def spin():
        try:
            for _ in range(200):
                pe.evaluate(now=T0 + 1.0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=spin) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for _ in range(800):
        je.evaluate(now=T0 + 1.0)
    assert not errors
    assert pm.get("slo_evaluations_total") == jm.get("slo_evaluations_total") == 800
    assert len(pe._snaps) == len(je._snaps) == 800
    assert _render(pm) == _render(jm)


def test_get_engine_reads_the_default_registry(monkeypatch):
    """The process-wide engine: one object, over DEFAULT_SLOS and each
    package's default registry (swapped for a fresh one here)."""
    registries = []
    for mod, tele in ((jslo, jtelemetry), (slo, telemetry)):
        monkeypatch.setattr(mod, "_ENGINE", None)
        registry = tele.Metrics(enabled=True)
        monkeypatch.setattr(tele, "_DEFAULT", registry)
        registries.append(registry)
    _observe(registries, "witness_verify_seconds", [0.02] * 30 + [2.0] * 3)
    _observe(registries, "api_request_seconds", [0.001] * 10, route="/metrics")
    je, pe = jslo.get_engine(), slo.get_engine()
    assert slo.get_engine() is pe and pe.metrics is registries[1]
    assert [s.name for s in pe.slos] == [s.name for s in jslo.DEFAULT_SLOS]
    je._t0 = pe._t0 = T0
    assert pe.evaluate(now=T0 + 2.0, emit=False, snapshot=False) == \
        je.evaluate(now=T0 + 2.0, emit=False, snapshot=False)
