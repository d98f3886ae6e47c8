"""The port's telemetry registry and slot clock against the JAX package's.

The same sequence of ``inc`` / ``set_gauge`` / ``observe`` / ``span`` /
``bound_span`` calls on a fresh ``Metrics()`` of each package must give
equal ``get()`` values, equal histograms and equal Prometheus text; spans
read a scripted clock, so their durations are equal too.  ``SlotClock``'s
slot, offset, interval and phase summary must match at every instant,
before genesis too, and the slot-phase observers must record equal
histograms.  Tolerance: none, every comparison is exact.
"""

import logging

import pytest
import torch

from lambda_ethereum_consensus_tpu import telemetry as JT
from lambda_ethereum_consensus_tpu import tracing as JTR
from lambda_ethereum_consensus_tpu_torch import telemetry as PT
from lambda_ethereum_consensus_tpu_torch import tracing as PTR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    """A scripted ``time`` module: ``perf_counter`` steps by the next of
    ``steps`` (cycled) on every read."""

    def __init__(self, steps):
        self._steps = list(steps)
        self._i = 0
        self._t = 100.0

    def perf_counter(self):
        self._t += self._steps[self._i % len(self._steps)]
        self._i += 1
        return self._t

    def time(self):
        return self.perf_counter()


@pytest.fixture
def scripted(monkeypatch):
    """Both registries read their own copy of one scripted clock."""
    steps = (0.004, 0.25, 1e-5, 3.0, 0.0625, 1.5)
    monkeypatch.setattr(JT, "time", _Clock(steps))
    monkeypatch.setattr(PT, "time", _Clock(steps))


def _drive(mod, m):
    """One sequence of every recording call the registry offers."""
    m.register_histogram("op_seconds", [0.01, 0.1])
    m.inc("reqs", result="ok")
    m.inc("reqs", result="ok")
    m.inc("reqs", value=3, result="err")
    m.inc("big", value=1234567)
    m.inc("big", value=1)
    m.inc("duty_signatures_total", 512, path="host")
    m.set_gauge("depth", 3, topic="beacon_block")
    m.set_gauge("depth", 7.25, topic="beacon_block")
    m.set_gauge("bytes_gauge", 268435456.0)
    m.set_gauge("duty_keys_managed", 16386.0)
    for v in (0.005, 0.05, 0.1, 7.0):  # 0.1 on a bound: le is inclusive
        m.observe("op_seconds", v, path="cached")
    m.observe("lat", 123456.789)
    m.observe("duty_completion_offset_seconds", 4.75, type="attest")
    m.observe("duty_completion_offset_seconds", 0.0, type="propose")
    with m.span("duty_sign"):
        pass
    with m.span("fork_choice_on_block", slow=10.0, path="cached"):
        pass
    with pytest.raises(ValueError):
        with m.span("boom", slow=0.0):
            raise ValueError("x")
    bound = m.bound_span("drain", slow=2.0, lane="att")
    for _ in range(3):
        with bound.time():
            pass
    m.describe("custom", "a described family")
    m.inc("custom")
    with pytest.raises(ValueError) as exc:
        m.register_histogram("op_seconds", [0.5, 1.0])
    return str(exc.value)


_GETS = [
    ("reqs", {"result": "ok"}), ("reqs", {"result": "err"}), ("reqs", {}),
    ("big", {}), ("duty_signatures_total", {"path": "host"}),
    ("duty_signatures_total", {"path": "device"}),
    ("depth", {"topic": "beacon_block"}), ("bytes_gauge", {}),
    ("duty_keys_managed", {}), ("custom", {}), ("absent", {}),
]
_HISTS = [
    ("op_seconds", {"path": "cached"}), ("op_seconds", {}), ("lat", {}),
    ("duty_completion_offset_seconds", {"type": "attest"}),
    ("duty_completion_offset_seconds", {"type": "propose"}),
    ("duty_sign_seconds", {}), ("fork_choice_on_block_seconds", {"path": "cached"}),
    ("boom_seconds", {}), ("drain_seconds", {"lane": "att"}),
]


def _without_scrape_time(text: str) -> str:
    return "\n".join(l for l in text.splitlines() if not l.startswith("telemetry_scrape_seconds "))


def test_registry_sequence_matches_jax(scripted, caplog):
    with caplog.at_level(logging.WARNING, logger="telemetry"):
        j_err = _drive(JT, jm := JT.Metrics(slow_op_s=1.0))
        j_logs = [r.getMessage() for r in caplog.records]
        caplog.clear()
        p_err = _drive(PT, pm := PT.Metrics(slow_op_s=1.0))
        p_logs = [r.getMessage() for r in caplog.records]
    assert p_err == j_err
    assert p_logs == j_logs and any("span=boom" in l for l in p_logs)
    for name, labels in _GETS:
        assert pm.get(name, **labels) == jm.get(name, **labels), (name, labels)
    for name, labels in _HISTS:
        assert pm.get_histogram(name, **labels) == jm.get_histogram(name, **labels), name
    for name in ("op_seconds", "duty_sign_seconds", "absent"):
        assert pm.histogram_series(name) == jm.histogram_series(name)
    assert pm.key_count() == jm.key_count()
    assert pm.family_names() == jm.family_names()
    text = pm.render_prometheus(self_scrape=False)
    assert text == jm.render_prometheus(self_scrape=False)
    assert 'op_seconds_bucket{path="cached",le="0.1"} 3' in text
    assert "# HELP duty_signatures_total signatures produced" in text
    skip = {"reqs", "op_seconds"}
    assert pm.render_prometheus(skip=skip, self_scrape=False) == \
        jm.render_prometheus(skip=skip, self_scrape=False)
    full = pm.render_prometheus()
    assert _without_scrape_time(full) == _without_scrape_time(jm.render_prometheus())
    assert full.count("# TYPE telemetry_scrape_seconds gauge") == 1


def test_label_escaping_matches_jax():
    evil = 'quote " backslash \\ newline \n end'
    texts = []
    for mod in (JT, PT):
        m = mod.Metrics()
        m.inc("evil", why=evil)
        m.set_gauge("evil_gauge", 1, why=evil, topic="a=b,c")
        m.observe("evil_seconds", 0.5, why=evil)
        texts.append(m.render_prometheus(self_scrape=False))
    assert texts[1] == texts[0]
    assert 'why="quote \\" backslash \\\\ newline \\n end"' in texts[1]


@pytest.mark.parametrize("value", [0.0, 1.0, 7.055, 1234567.0, 2.0**53, 1e-7, -3.5, 1e300])
def test_sample_rendering_matches_jax(value):
    assert PT._fmt(value) == JT._fmt(value)


def test_disabled_registry_matches_jax():
    out = []
    for mod in (JT, PT):
        m = mod.Metrics(enabled=False)
        m.inc("c", result="ok")
        m.set_gauge("g", 1.0)
        m.observe("h", 0.5)
        with m.span("op", topic="x"):
            pass
        with m.bound_span("b").time():
            pass
        before = (m.key_count(), m.get("c", result="ok"),
                  m.get_histogram("op_seconds", topic="x"), m.render_prometheus())
        assert m.span("a") is m.span("b")
        m.set_enabled(True)
        m.inc("c")
        out.append((before, m.get("c"), m.enabled))
    assert out[1] == out[0]
    assert out[1][0] == (0, 0.0, None, "\n")


@pytest.mark.parametrize("raw", ["", "2.5", "not-a-number", "0"])
def test_slow_op_threshold_from_env_matches_jax(raw, monkeypatch):
    monkeypatch.setenv("TELEMETRY_SLOW_OP_S", raw)
    assert PT.Metrics().slow_op_s == JT.Metrics().slow_op_s


@pytest.mark.parametrize("raw", ["", "1", "off", "False", "yes", " 0 "])
def test_telemetry_switch_matches_jax(raw, monkeypatch):
    monkeypatch.setenv("TELEMETRY_OFF", raw)
    assert PT.telemetry_enabled() == JT.telemetry_enabled()


def test_default_registry_helpers_match_jax(monkeypatch, scripted):
    texts = []
    for mod in (JT, PT):
        monkeypatch.setattr(mod, "_DEFAULT", None)
        assert mod.get_metrics() is mod.get_metrics()
        mod.inc("duties_produced_total", 512, type="attest")
        mod.set_gauge("duty_pool_attestations", 64.0)
        mod.observe("duty_completion_offset_seconds", 5.5, type="attest")
        with mod.span("duty_sign"):
            pass
        texts.append(mod.get_metrics().render_prometheus(self_scrape=False))
    assert texts[1] == texts[0]
    assert PT.scrape_stats_lines(0.25, 17) == JT.scrape_stats_lines(0.25, 17)
    assert PT.DEFAULT_BUCKETS == JT.DEFAULT_BUCKETS


def test_device_fault_latch_is_not_ported():
    assert not hasattr(PT, "device_fault")
    assert not hasattr(PT, "device_fault_state")
    assert "device_fault" not in PT.__all__


# ------------------------------------------------------------ slot clock

_INSTANTS = [-1e6, -13.0, 975.5, 987.9, 988.0, 999.0, 999.5, 1000.0, 1000.001, 1003.999,
             1004.0, 1006.0, 1008.0, 1011.999, 1012.0, 1024.0 + 3.5, 1e9 + 0.25]


@pytest.mark.parametrize("sps, intervals", [(12, 3), (6, 3), (12, 4), (5, 1)])
def test_slot_clock_matches_jax(sps, intervals):
    j = JTR.SlotClock(1000, sps, intervals)
    p = PTR.SlotClock(1000, sps, intervals)
    for t in _INSTANTS:
        assert p.slot_at(t) == j.slot_at(t), t
        assert p.offset_into_slot(t) == j.offset_into_slot(t), t
        assert p.interval_at(t) == j.interval_at(t), t
        assert p.phase(t) == j.phase(t), t
    for slot in (-3, -1, 0, 1, 7, 1 << 40):
        assert p.slot_start(slot) == j.slot_start(slot)
    assert p.phase(999.0)["pre_genesis"] is True


@pytest.mark.parametrize("args", [(0, 0), (0, 12, 0), (0, -6)])
def test_slot_clock_rejects_degenerate_config_like_jax(args):
    errors = []
    for mod in (JTR, PTR):
        with pytest.raises(ValueError) as exc:
            mod.SlotClock(*args)
        errors.append(str(exc.value))
    assert errors[1] == errors[0]


def test_slot_phase_observers_match_jax(monkeypatch):
    got = []
    for tele, trace in ((JT, JTR), (PT, PTR)):
        monkeypatch.setattr(tele, "_DEFAULT", tele.Metrics())
        clock = trace.SlotClock(genesis_time=1000, seconds_per_slot=12)
        delays = [
            trace.observe_block_arrival(clock, 2, now=1000 + 24 + 3.5),
            trace.observe_block_arrival(clock, 5, now=1000),  # early: clamps to 0
            trace.observe_head_update(clock, 2, now=1000 + 24 + 4.0),
            trace.observe_head_update(clock, -1, now=995.0),
        ]
        m = tele.get_metrics()
        got.append((delays, m.get_histogram("slot_block_arrival_offset_seconds"),
                    m.get_histogram("head_update_delay_seconds"),
                    m.render_prometheus(self_scrape=False)))
    assert got[1] == got[0]
    assert got[1][0] == [3.5, 0.0, 4.0, 7.0]
    assert got[1][1][0] == PTR.SLOT_PHASE_BUCKETS == JTR.SLOT_PHASE_BUCKETS
