"""The port's boot-time warmer (``node/warmup.py``) against the JAX package's.

- ``warm_drain_programs`` on the CPU at small shapes calls the seven chain
  ops in the JAX package's order with the shapes the JAX package computes
  from the same ``DrainShapes`` (the JAX ops stubbed: its real ones compile
  for minutes on the CPU; the port's run for real on their plain versions).
- ``start_warmer`` fills the JAX package's stats keys, observes
  ``warmup_phase_seconds`` per phase, and lands a planted failure in
  ``stats["error"]`` as the JAX package does; a device fault
  (``RuntimeError``) also reaches ``on_fault``, a wire error and any other
  exception do not.
- ``warm_transition`` runs where the JAX package's routing says so, and
  ``warm_witness`` drives the plane's internals on the JAX package's dummy
  proof and packed plane, one ``sha256_nodes`` call a round, with no
  ``witness_verify_seconds`` observed.
Tolerance: none.
"""

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu.node import warmup as jwarmup
from lambda_ethereum_consensus_tpu.ops import aot as jaot
from lambda_ethereum_consensus_tpu.ops import bls_batch as jBB
from lambda_ethereum_consensus_tpu.state_transition import resident as jresident
from lambda_ethereum_consensus_tpu.witness import verify as jverify
from lambda_ethereum_consensus_tpu_torch import faults, telemetry
from lambda_ethereum_consensus_tpu_torch.node import warmup
from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as pBB
from lambda_ethereum_consensus_tpu_torch.state_transition import resident as president
from lambda_ethereum_consensus_tpu_torch.witness import verify as pverify

_CHAIN_OPS = ("committee_sums", "agg_corrected", "ladder_g1", "ladder_g2", "prep", "miller",
              "check_tail")
_STATS_KEYS = {"overlap_s", "transition_s", "witness_s", "duties_s", "kzg_s"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    out = {}
    for name, tele in (("jax", jtelemetry), ("port", telemetry)):
        out[name] = tele.Metrics(enabled=True)
        monkeypatch.setattr(tele, "_DEFAULT", out[name])
    # the JAX warmer registers shape buckets, which its scheduler snaps to
    monkeypatch.setattr(jaot, "_SHAPE_BUCKETS", {})
    monkeypatch.delenv("GRAFT_RESIDENT_EPOCH", raising=False)
    return out


def _shape(x):
    if isinstance(x, (tuple, list)):
        return tuple(_shape(v) for v in x)
    dtype = str(x.dtype)
    return tuple(x.shape), "bool" if "bool" in dtype else "int"


def _spies(real: dict, calls: list, outputs: list) -> dict:
    """The chain ops of ``real`` with each of the seven recording its name
    and argument shapes into ``calls`` and its result into ``outputs``."""
    ops = dict(real)
    for name in _CHAIN_OPS:
        def spy(*args, name=name, fn=real[name]):
            calls.append((name, _shape(args)))
            out = fn(*args)
            outputs.append(out)
            return out
        ops[name] = spy
    return ops


@pytest.mark.parametrize("dims", [
    (64, 4, 16, 8, 2, 1), (96, 3, 20, 13, 4, 2),
], ids=["one-check", "two-checks"])
def test_drain_warmer_calls_the_chain_in_jax_order_at_jax_shapes(monkeypatch, registries, dims):
    shapes = dict(zip(("n_validators", "n_committees", "committee", "entries", "groups",
                       "checks"), dims))
    port_calls, port_out = [], []
    real = pBB.get_chain_ops("cpu")
    monkeypatch.setattr(pBB, "get_chain_ops",
                        lambda device=None: _spies(real, port_calls, port_out))
    assert warmup.warm_drain_programs(warmup.DrainShapes(**shapes, coeff_bits=8), "cpu") > 0

    # the JAX chain stubbed: each op returns zeros shaped as the port's
    # result of the same call, so only the warmer's own arithmetic reaches
    # the shapes compared
    jax_calls = []
    results = iter(port_out)

    def stub(name):
        def op(*args):
            jax_calls.append((name, _shape(args)))
            out = next(results)
            if isinstance(out, tuple):
                return tuple(np.zeros(t.shape, np.int32) for t in out)
            return np.zeros(out.shape, np.int32)
        return op

    monkeypatch.setattr(jBB, "_get_chain_ops",
                        lambda interpret=False: {name: stub(name) for name in _CHAIN_OPS})
    jwarmup.warm_drain_programs(jwarmup.DrainShapes(**shapes, coeff_bits=8))
    assert [n for n, _ in port_calls] == [n for n, _ in jax_calls] == list(_CHAIN_OPS)
    for (name, got), (_, want) in zip(port_calls, jax_calls):
        if name in ("ladder_g1", "prep", "miller", "check_tail"):
            # the first arguments are the previous op's results
            continue
        assert got == want, name
    g1, prep = port_calls[2][1], port_calls[4][1]
    assert g1[2:] == jax_calls[2][1][2:]  # the coefficient bits and the live lanes
    assert prep[2:] == jax_calls[4][1][2:]  # the index, message and liveness planes
    for side in ("jax", "port"):
        assert registries[side].get_histogram("warmup_phase_seconds", phase="drain")[3] == 1


def test_start_warmer_stats_match_jax(monkeypatch, registries):
    for name in ("warm_drain_programs", "warm_transition", "warm_witness", "warm_duties",
                 "warm_kzg"):
        monkeypatch.setattr(jwarmup, name, lambda *args, **kwargs: 0.0)
    jstats: dict = {}
    jwarmup.start_warmer(jwarmup.DrainShapes(64, 4, 16, 8, 2, coeff_bits=8), jstats).join(60)
    stats: dict = {}
    thread = warmup.start_warmer(warmup.DrainShapes(64, 4, 16, 8, 2, coeff_bits=8), stats,
                                 device="cpu")
    thread.join(120)
    assert not thread.is_alive() and thread.daemon and thread.name == "drain-warmer"
    assert set(stats) == set(jstats) == _STATS_KEYS
    assert stats["transition_s"] == 0.0  # 64 validators: the resident path is off
    for phase in ("drain", "witness", "duties", "kzg"):
        assert registries["port"].get_histogram("warmup_phase_seconds", phase=phase)[3] == 1
    assert registries["port"].get_histogram("warmup_phase_seconds", phase="transition") is None


class _CardLost(RuntimeError):
    pass


@pytest.mark.parametrize("exc,device_fault", [
    (_CardLost("planted"), True), (faults.WireError("sidecar"), False),
    (ValueError("bad shape"), False),
], ids=["device fault", "wire error", "other error"])
def test_warmer_failure_lands_in_stats_as_jax(monkeypatch, exc, device_fault):
    def planted(*args, **kwargs):
        raise exc

    monkeypatch.setattr(jwarmup, "warm_drain_programs", planted)
    monkeypatch.setattr(warmup, "warm_drain_programs", planted)
    jstats: dict = {}
    jwarmup.start_warmer(jwarmup.DrainShapes(64, 4, 16, 8, 2, coeff_bits=8), jstats).join(60)
    stats: dict = {}
    faulted = []
    warmup.start_warmer(warmup.DrainShapes(64, 4, 16, 8, 2, coeff_bits=8), stats,
                        device="cpu", on_fault=faulted.append).join(60)
    assert stats == jstats == {"error": f"{type(exc).__name__}: {exc}"}
    assert faulted == ([exc] if device_fault else [])


@pytest.mark.parametrize("n", [100, 1 << 14])
def test_warm_transition_follows_the_resident_route(registries, n):
    assert president.resident_enabled(n) is jresident.resident_enabled(n)
    dt = warmup.warm_transition(n, "cpu")
    hist = registries["port"].get_histogram("warmup_phase_seconds", phase="transition")
    if president.resident_enabled(n):
        assert dt > 0 and hist[3] == 1
    else:
        assert dt == 0.0 and hist is None


def test_warm_witness_drives_the_plane_internals(monkeypatch, registries):
    proof, jproof = pverify._dummy_proof(), jverify._dummy_proof()
    assert (proof.state_root, proof.indices, proof.leaves, proof.siblings) == \
        (jproof.state_root, jproof.indices, jproof.leaves, jproof.siblings)
    batch = pverify.MIN_PLANE_BATCH
    assert batch == jverify.DEFAULT_BATCH_BUCKETS[0]
    packed = pverify._assemble([proof] * batch, [b"\x00" * 32] * batch,
                               [pverify.plan_for(proof)] * batch)
    jpacked = jverify._assemble([jproof] * batch, [b"\x00" * 32] * batch,
                                [jverify.plan_for(jproof)] * batch)
    # the JAX plane pads rounds and slots to its shape buckets; the port's
    # is exactly as deep and wide as its plans, and equal on that part
    for key in ("nodes", "lidx", "ridx", "oidx", "mask", "root_idx", "expected"):
        live = tuple(slice(0, d) for d in packed[key].shape)
        np.testing.assert_array_equal(packed[key], jpacked[key][live], err_msg=key)
    assert jpacked["mask"].sum() == packed["mask"].sum() > 0
    hashed = []
    real = pverify.sha256_nodes
    monkeypatch.setattr(pverify, "sha256_nodes", lambda blocks: hashed.append(len(blocks))
                        or real(blocks))
    assert warmup.warm_witness("cpu") > 0
    assert hashed == [batch * packed["lidx"].shape[2]] * packed["lidx"].shape[0]
    port = registries["port"]
    assert port.get_histogram("warmup_phase_seconds", phase="witness")[3] == 1
    assert port.get_histogram("witness_verify_seconds") is None
    assert "witness_verified_total" not in port.family_names()
