"""The port's device cost and memory observatory (``ops/profile.py``) against
the JAX package's.

- ``PlaneRegistry`` and the module functions: the same register,
  unregister and snapshot sequence (a host plane, a raising provider, an
  over-claim, the watermark) gives equal dicts on both.
- The shipped planes: the four names registered at import, each fed by the
  module that owns the memory (the registry plane stores, live resident
  planes, live witness services on the host side, the duty-sign ladder in
  flight).
- ``entry_report`` and ``emit_entry_metrics``: the JAX side fed through
  ``tests/unit/test_profile.py``'s fake-executable pattern, the port through
  ``record_launch`` with the same operations, bytes, call counts and span
  histograms; ranks, ratios (to 1e-12) and counter deltas equal, and the
  ``"cpu"`` peaks equal.
- The cost table of the port's wrappers: each launch on a CUDA tensor is
  one row; a CPU tensor records nothing.
- ``capture_trace``: with a fake tracer, both refuse an oversized window
  before tracing, answer ``busy``, delete an over-budget trace, close a
  failed window, and record the same recorder instants and counters; a
  real ``torch.profiler`` window of 0.2 s on the CPU writes a Chrome trace.
- ``ops/_build``: ``library()`` loads a library and notes it in the build
  table; ``build_table`` parses registers and spills from a ``ptxas -v``
  log.
Each test swaps each package's default registry and flight recorder for
fresh ones.  Tolerance: exact, but for the ratios (1e-12).
"""

import gc
import json
import os
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu import tracing as jtracing
from lambda_ethereum_consensus_tpu.ops import aot as jaot
from lambda_ethereum_consensus_tpu.ops import profile as jprofile
from lambda_ethereum_consensus_tpu_torch import telemetry, tracing
from lambda_ethereum_consensus_tpu_torch.ops import _build
from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP
from lambda_ethereum_consensus_tpu_torch.ops import bls_batch, bls_sign, profile
from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
from lambda_ethereum_consensus_tpu_torch.state_transition import resident
from lambda_ethereum_consensus_tpu_torch.witness import service as wservice


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Fresh default registries and recorders for both packages, empty
    cost tables and emission cursors, and no ``PROFILE_*`` overrides on the
    JAX side."""
    registries = {}
    for name, tele, trc in (("jax", jtelemetry, jtracing), ("port", telemetry, tracing)):
        registries[name] = tele.Metrics(enabled=True)
        monkeypatch.setattr(tele, "_DEFAULT", registries[name])
        monkeypatch.setattr(trc, "_RECORDER", trc.FlightRecorder(enabled=True))
    for var in ("PROFILE_PEAK_GFLOPS", "PROFILE_PEAK_GBS", "PROFILE_CAPTURE_MAX_S",
                "PROFILE_CAPTURE_MAX_MB", "PROFILE_CAPTURE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jprofile, "_COSTS", {})
    monkeypatch.setattr(jprofile, "_EMITTED_TOTALS", {})
    monkeypatch.setattr(jaot, "_PROFILE", {})
    monkeypatch.setattr(profile, "_LAUNCHES", {})
    monkeypatch.setattr(profile, "_EMITTED_TOTALS", {})
    return registries


# ---------------------------------------------------------- plane registry


def _plane_sequence(register, unregister, snapshot, watermark) -> list:
    held = {"a": 1000.0, "b": 500.0}
    out = []
    register("plane_a", lambda: held["a"])
    register("plane_b", lambda: held["b"])
    register("host_plane", lambda: 10_000.0, device=False)
    out.append((snapshot(4000.0), watermark()))
    unregister("plane_b")
    out.append((snapshot(3000.0), watermark()))
    register("broken", lambda: 1 / 0)
    out.append((snapshot(100.0), watermark()))
    held["a"] = 99_999.0
    out.append((snapshot(100.0), watermark()))
    out.append((snapshot(None), watermark()))
    unregister("never_registered")
    out.append((snapshot(5000.0), watermark()))
    return out


def test_plane_registry_matches_jax():
    got, want = profile.PlaneRegistry(), jprofile.PlaneRegistry()
    seqs = [
        _plane_sequence(reg.register, reg.unregister, reg.snapshot, lambda reg=reg: reg.watermark)
        for reg in (got, want)
    ]
    assert seqs[0] == seqs[1]
    assert seqs[0][0][0] == {"plane_a": 1000.0, "plane_b": 500.0, "host_plane": 10_000.0,
                             "unattributed": 2500.0}
    assert got.names() == want.names()
    assert got.device_names() == ("broken", "plane_a")
    with pytest.raises(TypeError):
        got.register("x", 5)


def test_plane_module_functions_match_jax(monkeypatch):
    monkeypatch.setattr(profile, "_REGISTRY", profile.PlaneRegistry())
    monkeypatch.setattr(jprofile, "_REGISTRY", jprofile.PlaneRegistry())
    seqs = [
        _plane_sequence(mod.register_plane, mod.unregister_plane,
                        lambda total, mod=mod: mod.plane_bytes(total), mod.plane_watermark)
        for mod in (profile, jprofile)
    ]
    assert seqs[0] == seqs[1]


def test_shipped_planes_and_their_owners(monkeypatch):
    """The four planes registered at import, each fed by its owner; the
    witness service's host rows stay out of the remainder."""
    names = set(profile.plane_bytes(1 << 20)) - {"unattributed"}
    assert names == {"registry_planes", "resident_epoch", "witness_buffers", "duty_sign_ladders"}
    assert names <= set(jprofile.plane_bytes(1 << 20))
    assert set(profile.device_planes()) == names - {"witness_buffers"}
    # the owners' live sets, empty: other tests' planes and services stay out
    monkeypatch.setattr(bls_batch, "_PLANE_STORES", {})
    monkeypatch.setattr(resident, "_LIVE_PLANES", weakref.WeakSet())
    monkeypatch.setattr(wservice, "_LIVE_SERVICES", weakref.WeakSet())
    base = profile.plane_bytes(0)
    assert base == dict.fromkeys(names, 0.0) | {"unattributed": 0.0}

    store = bls_batch.get_plane_store(b"profile-test-chain", "cpu")
    store.update(np.ones((32, 40), np.int32), np.ones((32, 40), np.int32))
    assert store.resident_bytes == 2 * 32 * 1024 * 4
    plane = resident.ResidentEpochPlane(10, "cpu")
    plane.bal = torch.zeros(10, dtype=torch.int64)
    svc = wservice.WitnessService()
    svc.retained_bytes = lambda: 777
    snap = profile.plane_bytes(10 ** 9)
    assert snap["registry_planes"] == store.resident_bytes
    assert snap["resident_epoch"] - base["resident_epoch"] == 80
    assert snap["witness_buffers"] - base["witness_buffers"] == 777
    device = sum(snap[n] for n in profile.device_planes())
    assert snap["unattributed"] == 10 ** 9 - device  # host rows never enter it
    del plane, svc
    gc.collect()
    snap = profile.plane_bytes(None)
    assert snap["resident_epoch"] == base["resident_epoch"]
    assert snap["witness_buffers"] == base["witness_buffers"]

    seen = []
    real = bls_sign.g2_ladder

    def ladder(*args):
        seen.append(profile.plane_bytes()["duty_sign_ladders"])
        return real(*args)

    monkeypatch.setattr(bls_sign, "g2_ladder", ladder)
    bls_sign._sign_points_device([bls_sign.C.G2_GENERATOR] * 3, [1, 2, 3], 8, "cpu")
    assert seen == [3 * (3 * 32 * 2 * 4 + 1)]
    assert profile.plane_bytes()["duty_sign_ladders"] == 0


def test_live_totals_are_none_without_cuda(monkeypatch):
    """A process that has not initialised CUDA has no allocator total: no
    live bytes, no live blocks, no ``unattributed`` plane."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert profile.live_device_bytes() is None
    assert profile.live_device_blocks() is None
    assert "unattributed" not in profile.profile_report()["planes"]


# ------------------------------------------------------------- cost table


class _FakeExecutable:
    """Executable stand-in answering the two compile-time analyses
    (``tests/unit/test_profile.py``'s)."""

    def __init__(self, flops, bytes_accessed):
        self._flops, self._bytes = flops, bytes_accessed

    def __call__(self, *args):
        return ("ran", args)

    def cost_analysis(self):
        return [{"flops": self._flops, "bytes accessed": self._bytes}]

    def memory_analysis(self):
        return SimpleNamespace(generated_code_size_in_bytes=4096, temp_size_in_bytes=512,
                               argument_size_in_bytes=64, output_size_in_bytes=64)


class _FakeJitted:
    def __init__(self, executable):
        self._executable = executable

    def lower(self, *args):
        return SimpleNamespace(compile=lambda: self._executable)


# (entry, operations a call, bytes a call, calls): three span families of
# the JAX table, one entry with no family
_ENTRIES = (
    ("duty_sign_p20a", 2.0e9, 4.0e8, 3),
    ("witness_verify_p20b", 1.0e6, 5.0e8, 2),
    ("chain_p20c", 7.0, 3.0, 1),
    ("nospan_p20d", 9.0e9, 1.0, 4),
)
_SPANS = (("duty_sign_seconds", 1.0), ("duty_sign_seconds", 1.0),
          ("witness_verify_seconds", 0.25))


def _feed(registries, monkeypatch, calls=None):
    """The same entries through both packages: JAX fake executables through
    ``aot_jit`` (memory only), the port's ``record_launch`` with the same
    costs in its per-element tables (width 1)."""
    calls = calls or {name: n for name, _f, _b, n in _ENTRIES}
    monkeypatch.setattr(profile, "_ENTRY_SPANS", jprofile._ENTRY_SPANS)
    for name, flops, nbytes, _n in _ENTRIES:
        monkeypatch.setitem(profile.OPS_PER_ELEMENT, name, {1: flops})
        monkeypatch.setitem(profile.BYTES_PER_ELEMENT, name, nbytes)
        call = jaot.aot_jit(_FakeJitted(_FakeExecutable(flops, nbytes)), name, disk=False)
        for _ in range(calls[name]):
            call(1.0)
            profile.record_launch(name, 1)
    for family, seconds in _SPANS:
        for registry in registries.values():
            registry.observe(family, seconds)


_KEYS = ("rank", "calls", "flops_total", "bytes_total", "flops_per_call_max", "span_family",
         "span_seconds", "span_count", "slo")
_RATIOS = ("achieved_gflops", "achieved_gbs", "compute_ratio", "memory_ratio",
           "roofline_ratio", "headroom")


def test_entry_report_and_cpu_peaks_match_jax(fresh, monkeypatch):
    _feed(fresh, monkeypatch)
    assert {k: v for k, v in profile.backend_peaks("cpu").items() if k != "card"} == \
        jprofile.backend_peaks("cpu")
    got = profile.entry_report(metrics=fresh["port"], backend="cpu")
    want = jprofile.entry_report(metrics=fresh["jax"], backend="cpu")
    assert [e["entry"] for e in got] == [e["entry"] for e in want] == \
        ["duty_sign_p20a", "witness_verify_p20b", "nospan_p20d", "chain_p20c"]
    for g, w in zip(got, want):
        assert {k: g[k] for k in _KEYS} == {k: w[k] for k in _KEYS}, g["entry"]
        for k in _RATIOS:
            assert (g[k] is None) == (w[k] is None), (g["entry"], k)
            if w[k] is not None:
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0), (g["entry"], k)
    row = got[0]
    assert row["achieved_gflops"] == pytest.approx(3.0, rel=1e-12)
    assert row["slo"]["name"] == "duty_sign_p95"
    # the gpu row: the card's dispatch rate and HBM rate, with its name
    gpu = profile.backend_peaks("gpu")
    assert gpu["gflops"] == pytest.approx(132 * 128 * 1.98, rel=1e-12)
    assert gpu["gbs"] == 3350.0 and gpu["card"] == profile.PEAKS_CARD


def test_emit_entry_metrics_matches_jax(fresh, monkeypatch):
    _feed(fresh, monkeypatch)
    for mod, side in ((jprofile, "jax"), (profile, "port")):
        mod.emit_entry_metrics(fresh[side])
        mod.emit_entry_metrics(fresh[side])  # no new calls: no delta
    more = {name: 0 for name, *_ in _ENTRIES}
    more["duty_sign_p20a"] = 2
    _feed({}, monkeypatch, calls=more)
    for mod, side in ((jprofile, "jax"), (profile, "port")):
        mod.emit_entry_metrics(fresh[side])
    for name, *_ in _ENTRIES:
        for family in ("ops_entry_flops_total", "ops_entry_bytes_total",
                       "ops_entry_roofline_ratio"):
            g = fresh["port"].get(family, entry=name)
            w = fresh["jax"].get(family, entry=name)
            assert g == pytest.approx(w, rel=1e-12, abs=0), (family, name)
    assert fresh["port"].get("ops_entry_flops_total", entry="duty_sign_p20a") == \
        pytest.approx(5 * 2.0e9)
    # a disabled registry emits nothing and moves no cursor
    off = telemetry.Metrics(enabled=False)
    profile.emit_entry_metrics(off)
    assert off.key_count() == 0


def test_wrappers_record_cuda_launches_only(monkeypatch):
    """A CPU tensor runs the plain version and records nothing; on a CUDA
    tensor each wrapper records one row (the launch itself stubbed)."""
    a = torch.zeros((32, 5), dtype=torch.int32)
    BP.mul_mod(a, a)
    sops.sha256_nodes(torch.zeros((3, 64), dtype=torch.uint8))
    assert profile.cost_table() == []

    class FakeCuda:
        type = "cuda"
        index = 0

    seen = []
    monkeypatch.setattr(BP, "_run", lambda name, a, b, shape, geometry: seen.append(geometry))
    monkeypatch.setattr(BP, "kernel_launches", dict.fromkeys(BP.kernel_launches, 0))
    fake = SimpleNamespace(dtype=torch.int32, shape=(32, 4072), device=FakeCuda(),
                           dim=lambda: 2)
    BP._launch("mul_mod", fake, fake)
    BP._launch("mul_mod", fake, fake)
    big = SimpleNamespace(dtype=torch.int32, shape=(32, 1 << 20), device=FakeCuda(),
                          dim=lambda: 2)
    BP._launch("mul_mod", big, big)
    BP._launch("sub_mod", fake, fake)
    rows = {(r["entry"], r["width"]): r for r in profile.cost_table()}
    assert set(rows) == {("mul_mod", 4072), ("mul_mod", 1 << 20), ("sub_mod", 4072)}
    assert rows[("mul_mod", 4072)]["launches"] == 2 == BP.kernel_launches["mul_mod"] - 1
    assert rows[("mul_mod", 4072)]["threads_per_element"] == BP.MUL_GROUP
    assert rows[("mul_mod", 4072)]["flops"] == 4072 * profile.OPS_PER_ELEMENT["mul_mod"][2]
    assert rows[("mul_mod", 1 << 20)]["flops"] == (1 << 20) * profile.OPS_PER_ELEMENT["mul_mod"][1]
    assert rows[("sub_mod", 4072)]["bytes_accessed"] == 4072 * 384
    assert profile.cost_for("sub_mod", 4072) == rows[("sub_mod", 4072)]
    assert profile.cost_for("sub_mod", 1) is None
    # every body the wrappers launch has its count
    for name in BP.kernel_launches:
        for m in (1, BP.MUL_GROUP_THRESHOLD - 1, BP.MUL_GROUP_THRESHOLD, 1 << 20):
            assert BP._geometry(name, m)[0] in profile.OPS_PER_ELEMENT[name]


# ---------------------------------------------------------------- capture


class _FakeTracer:
    """``tests/unit/test_profile.py``'s: writes a trace file of
    ``write_bytes`` on start."""

    def __init__(self, write_bytes=64, fail=False):
        self.started = self.stopped = 0
        self.write_bytes = write_bytes
        self.fail = fail
        self.dir = None

    def start_trace(self, path):
        self.started += 1
        self.dir = path
        if self.fail:
            raise OSError("tracer refused")
        with open(os.path.join(path, "trace.pb"), "wb") as fh:
            fh.write(b"x" * self.write_bytes)

    def stop_trace(self):
        self.stopped += 1


def _budget(monkeypatch, max_s, max_mb=None):
    monkeypatch.setenv("PROFILE_CAPTURE_MAX_S", str(max_s))
    monkeypatch.setattr(profile, "PROFILE_CAPTURE_MAX_S", float(max_s))
    if max_mb is not None:
        monkeypatch.setenv("PROFILE_CAPTURE_MAX_MB", str(max_mb))
        monkeypatch.setattr(profile, "PROFILE_CAPTURE_MAX_MB", float(max_mb))


def _instants(trc) -> list:
    return [(e["name"], sorted(e["args"])) for e in trc.get_recorder().snapshot()]


def _both(fn):
    """``fn(module, side)`` on each package; returns ``[jax, port]``."""
    return [fn(jprofile, "jax"), fn(profile, "port")]


def test_capture_refuses_and_reports_busy_as_jax(fresh, monkeypatch, tmp_path):
    _budget(monkeypatch, 2)

    def refused(mod, side):
        tracer = _FakeTracer()
        with pytest.raises(ValueError, match="PROFILE_CAPTURE_MAX_S") as err:
            mod.capture_trace(5.0, out_dir=str(tmp_path / side), tracer=tracer)
        with pytest.raises(ValueError, match="positive"):
            mod.capture_trace(0.0, out_dir=str(tmp_path / side), tracer=tracer)
        assert mod._CAPTURE_LOCK.acquire(blocking=False)
        try:
            with pytest.raises(ValueError, match="already running"):
                mod.capture_trace(0.01, out_dir=str(tmp_path / side), tracer=tracer)
        finally:
            mod._CAPTURE_LOCK.release()
        return (str(err.value), tracer.started,
                fresh[side].get("profile_captures_total", result="refused"),
                fresh[side].get("profile_captures_total", result="busy"))

    want, got = _both(refused)
    assert got == want == (want[0], 0, 1, 1)
    assert not os.path.exists(tmp_path / "port")


def test_capture_within_budget_matches_jax(fresh, monkeypatch, tmp_path):
    _budget(monkeypatch, 2, 1)
    trcs = {"jax": jtracing, "port": tracing}

    def within(mod, side):
        tracer = _FakeTracer(write_bytes=128)
        report = mod.capture_trace(0.01, out_dir=str(tmp_path / side), tracer=tracer)
        assert os.path.isdir(report["dir"]) and report["seconds"] >= 0.01
        state = mod.capture_state()
        return (tracer.started, tracer.stopped, report["bytes"], sorted(report),
                _instants(trcs[side]), state["last"]["bytes"], state["running"],
                state["max_seconds"], state["max_mb"],
                fresh[side].get("profile_captures_total", result="ok"),
                fresh[side].get_histogram("profile_capture_seconds")[3])

    want, got = _both(within)
    assert got == want
    assert got[4] == [("profile_capture_start", ["budget_s", "dir"]),
                      ("profile_capture_stop", ["dir", "seconds"])]


def test_capture_over_budget_and_failed_window_match_jax(fresh, monkeypatch, tmp_path):
    _budget(monkeypatch, 2, 0.00001)
    trcs = {"jax": jtracing, "port": tracing}

    def over(mod, side):
        tracer = _FakeTracer(write_bytes=64)
        with pytest.raises(ValueError, match="PROFILE_CAPTURE_MAX_MB") as err:
            mod.capture_trace(0.01, out_dir=str(tmp_path / side), tracer=tracer)
        assert not os.path.isdir(tracer.dir)  # the over-budget trace is gone
        failing = _FakeTracer(fail=True)
        with pytest.raises(OSError, match="tracer refused"):
            mod.capture_trace(0.01, out_dir=str(tmp_path / side), tracer=failing)
        stop = [e["args"] for e in trcs[side].get_recorder().snapshot()][-1]
        return (str(err.value).split(" bytes")[1], tracer.stopped, failing.stopped,
                _instants(trcs[side]), stop["error"],
                fresh[side].get("profile_captures_total", result="over_budget"),
                fresh[side].get("profile_captures_total", result="error"),
                mod.capture_state()["running"])

    want, got = _both(over)
    assert got == want
    assert got[1:3] == (1, 0) and got[5:] == (1, 1, False)


def test_capture_with_torch_profiler_writes_a_chrome_trace(fresh, tmp_path):
    report = profile.capture_trace(0.2, out_dir=str(tmp_path))
    trace = os.path.join(report["dir"], "trace.json")
    with open(trace) as fh:
        doc = json.load(fh)
    assert "traceEvents" in doc
    assert report["bytes"] == os.path.getsize(trace) > 0
    assert report["seconds"] >= 0.2
    assert fresh["port"].get("profile_captures_total", result="ok") == 1


def test_profile_report_keys_match_jax(fresh, monkeypatch):
    _feed(fresh, monkeypatch)
    got, want = profile.profile_report(), jprofile.profile_report()
    assert set(got) == set(want)
    assert got["backend"] == "cpu" and got["live_device_bytes"] is None
    assert set(got["capture"]) == set(want["capture"])


# ------------------------------------------------------------ build table


_PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z17fq_add_mod_kernelPKi' for 'sm_90a'
ptxas info    : Function properties for _Z17fq_add_mod_kernelPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z17fq_mul_mod_kernelPKi' for 'sm_90a'
ptxas info    : Function properties for _Z17fq_mul_mod_kernelPKi
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
"""


def test_library_load_notes_the_build(monkeypatch, tmp_path):
    """``library()`` builds (or reuses) under its lock and notes the build
    table on the way: a library whose build exists loads once, in bounded
    time, and shows as reused."""
    import threading

    so = tmp_path / "libfake-0000.so"
    so.write_bytes(b"")
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build, "_target", lambda name: (tmp_path / f"{name}.cu", so))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    got = []
    loader = threading.Thread(target=lambda: got.append(_build.library("fake")), daemon=True)
    loader.start()
    loader.join(10)
    assert not loader.is_alive(), "library() never returned"
    assert got == [("loaded", str(so))]
    assert [(r["name"], r["source"], r["path"]) for r in _build.build_table()] == \
        [("fake", "reused", str(so))]


def test_build_table_parses_ptxas(monkeypatch):
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setitem(_build.build_logs, "fqtest", _PTXAS_LOG)
    _build._note("fqtest", _build.BUILD_DIR / "libfqtest.so", True, 4.25)
    _build._note("kvtest", _build.BUILD_DIR / "libkvtest.so", False, 0.0)
    table = _build.build_table()
    assert [r["name"] for r in table] == ["fqtest", "kvtest"]
    assert table[0]["source"] == "built" and table[0]["seconds"] == 4.25
    assert table[0]["kernels"] == [
        {"function": "_Z17fq_add_mod_kernelPKi", "registers": 48, "spill_stores": 0,
         "spill_loads": 0},
        {"function": "_Z17fq_mul_mod_kernelPKi", "registers": 255, "spill_stores": 16,
         "spill_loads": 12},
    ]
    assert table[1]["source"] == "reused" and table[1]["kernels"] == []
