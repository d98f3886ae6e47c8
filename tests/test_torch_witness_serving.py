"""The port's witness serving modules against the JAX package's classes.

``ServeCache``, ``WitnessService`` and ``VerifyCoalescer`` are driven through
the same sequences in both packages, each with a recording ``metrics`` sink,
and held equal: return values, proof bytes, eviction order, and the metric
calls (names, labels and counts; wait times are left out).  The JAX
coalescer verifies with ``device=False`` (its host planes), the port's with
``device="cpu"`` (its plane's plain PyTorch version below the oracle's
size route).  Tolerance: none.
"""

import contextlib
import threading

import pytest
import torch

from lambda_ethereum_consensus_tpu import serve_cache as jserve
from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.witness import coalesce as jcoalesce
from lambda_ethereum_consensus_tpu.witness import multiproof as jmp
from lambda_ethereum_consensus_tpu.witness.service import WitnessService as JaxWitnessService
from lambda_ethereum_consensus_tpu_torch import convert, serve_cache, telemetry
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.witness import coalesce
from lambda_ethereum_consensus_tpu_torch.witness import multiproof as mp
from lambda_ethereum_consensus_tpu_torch.witness.service import WitnessService

N = 16
SKS = [(i + 1).to_bytes(32, "big") for i in range(N)]


class Recorder:
    """A metrics sink that records every call (values of ``observe`` left
    out: they are wait times)."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def inc(self, name, value=1, **labels):
        with self._lock:
            self.calls.append(("inc", name, value, tuple(sorted(labels.items()))))

    def set_gauge(self, name, value, **labels):
        with self._lock:
            self.calls.append(("set_gauge", name, value, tuple(sorted(labels.items()))))

    def observe(self, name, value, **labels):
        with self._lock:
            self.calls.append(("observe", name, None, tuple(sorted(labels.items()))))

    @contextlib.contextmanager
    def span(self, name, slow=None, **labels):
        """A timed region, recorded as the registry records it: one
        ``<name>_seconds`` observation at exit."""
        yield
        self.observe(name + "_seconds", 0.0, **labels)

    def named(self, prefix: str) -> list:
        return [c for c in self.calls if c[1].startswith(prefix)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def states():
    """Three states of one lineage, (jax spec, [jax states], port spec,
    [port states]), both chain specs active."""
    jspec, pspec = jax_minimal_spec(), minimal_spec()
    with jax_use_chain_spec(jspec), use_chain_spec(pspec):
        genesis = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=jspec)
        jstates = [genesis]
        for k in range(1, 3):
            bal = list(genesis.balances)
            bal[k] += 1000 * k
            jstates.append(genesis.copy(balances=bal, slot=k * jspec.SLOTS_PER_EPOCH))
        pstates = [convert.state_from_ssz(s.encode(jspec), pspec) for s in jstates]
        yield jspec, jstates, pspec, pstates


@pytest.fixture(scope="module")
def proofs(states):
    jspec, jstates, pspec, pstates = states
    planner = mp.WitnessPlanner()
    return [planner.prove(pstates[0], [("balances", i % N), ("validators", (3 * i) % N)][: 1 + i % 2],
                          pspec) for i in range(12)]


def _to_jax(proof):
    return jmp.WitnessProof(proof.state_root, proof.indices, proof.leaves, proof.siblings)


def _corrupt(proof):
    return mp.WitnessProof(proof.state_root, proof.indices, proof.leaves,
                           tuple([b"\x01" * 32] + list(proof.siblings[1:])))


# ------------------------------------------------------------ ServeCache


def _drive_cache(cls):
    rec = Recorder()
    cache = cls("t", capacity=3, max_bytes=100, metrics=rec)
    out = [
        cache.get("a", kind="x"),
        cache.put("a", 1, root=b"r1", epoch=5, nbytes=10),
        cache.put("b", 2, root=b"r1", epoch=4, nbytes=10),
        cache.put("c", 3, root=b"r2", epoch=6, nbytes=10),
        cache.get("a", kind="x"),
        cache.put("d", 4, root=b"r2", epoch=6, nbytes=10),  # count bound: epoch 4 goes first
        cache.get("b"),
        cache.put("e", 5, root=b"r3", epoch=7, nbytes=75),  # byte bound
        cache.put("huge", 6, root=b"r3", epoch=7, nbytes=101),  # served, not kept
        cache.get("huge"),
        cache.put("e", 7, root=b"r3", epoch=8, nbytes=5),  # re-put moves epochs
        cache.stats(),
        len(cache),
        cache.invalidate_root(b"r2", reason="reorg"),
        cache.invalidate_root(b"none"),
        cache.stats(),
        cache.clear(),
        cache.stats(),
    ]
    return out, rec.calls


def test_serve_cache_matches_jax():
    assert _drive_cache(serve_cache.ServeCache) == _drive_cache(jserve.ServeCache)


def test_serve_cache_without_metrics_records_nothing():
    """``metrics=None`` records on the port's registry, as the JAX
    package's cache records on its own; ``SILENT`` stays the explicit
    opt-out that records nothing."""
    cache = serve_cache.ServeCache("t", capacity=1)
    assert cache.metrics is telemetry.get_metrics()
    assert cache.put("a", 1) == 1 and cache.get("a") == 1
    assert jserve.ServeCache("t", capacity=1).metrics is jtelemetry.get_metrics()
    quiet = serve_cache.ServeCache("t", capacity=1, metrics=serve_cache.SILENT)
    assert quiet.metrics is serve_cache.SILENT
    assert quiet.put("a", 1) == 1 and quiet.get("a") == 1


# ------------------------------------------------------------ WitnessService


def _drive_service(svc, rec_calls, states_, spec, roots):
    reqs = [("balances", 3), ("validators", 1)]
    out = []
    first = svc.prove(roots[0], states_[0], reqs, spec)
    again = svc.prove(roots[0], states_[0], reqs, spec)
    out.append(again is first)
    out.append(first.encode())
    out.append(svc.prove(roots[1], states_[1], reqs[::-1], spec).encode())
    out.append(svc.prove(roots[2], states_[2], [("balances", 15)], spec).encode())
    out.append(list(svc._planners))  # capacity 2: the first root's planner is gone
    out.append(svc.retained_bytes())
    out.append(svc.invalidate_root(roots[0]))
    out.append(svc.invalidate_root(roots[0]))
    out.append(svc.prove(roots[0], states_[0], reqs, spec).encode())
    return out, [c for c in rec_calls() if c[1].startswith("serve_cache")]


def test_witness_service_matches_jax(states):
    jspec, jstates, pspec, pstates = states
    roots = [s.hash_tree_root(pspec) for s in pstates]
    rec, jrec = Recorder(), Recorder()
    port = WitnessService(capacity=2, proof_cache_entries=4, metrics=rec)
    jax_svc = JaxWitnessService(capacity=2, proof_cache_entries=4)
    jax_svc._proofs._metrics = jrec
    got = _drive_service(port, lambda: rec.calls, pstates, pspec, roots)
    want = _drive_service(jax_svc, lambda: jrec.calls, jstates, jspec, roots)
    assert got == want
    assert got[0][0] is True
    assert mp.verify_host(convert.witness_proof_from_ssz(got[0][1]), roots[0])


# ------------------------------------------------------------ VerifyCoalescer


def _run_requests(co, requests, device):
    """Each request from its own thread, started in order; returns the
    verdicts or the exception per request."""
    out = [None] * len(requests)

    def go(k, batch, roots):
        try:
            out[k] = co.verify(batch, roots, device=device)
        except Exception as e:  # noqa: BLE001 - the error is the result
            out[k] = e

    threads = [threading.Thread(target=go, args=(k, b, r)) for k, (b, r) in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


def _both(proofs, requests, **kw):
    """The same requests through the port's and the JAX package's coalescer."""
    rec, jrec = Recorder(), Recorder()
    port = _run_requests(coalesce.VerifyCoalescer(metrics=rec, **kw), requests, "cpu")
    jreqs = [([_to_jax(p) for p in b], r) for b, r in requests]
    jax_out = _run_requests(jcoalesce.VerifyCoalescer(metrics=jrec, **kw), jreqs, False)
    return port, jax_out, rec, jrec


def test_target_flush_demuxes_verdicts(proofs):
    root = proofs[0].state_root
    batches = [proofs[0:2], [proofs[2], _corrupt(proofs[3])], proofs[4:6], proofs[6:8]]
    requests = [(b, [root] * len(b)) for b in batches]
    port, jax_out, rec, jrec = _both(proofs, requests, deadline_s=30.0, target=8, max_flush=256)
    assert port == jax_out == [[True, True], [True, False], [True, True], [True, True]]
    assert rec.named("serve_coalesce") == jrec.named("serve_coalesce")
    assert ("inc", "serve_coalesce_flush_total", 1, (("trigger", "target"),)) in rec.calls
    # the port's flush reached verify_batch with the coalescer's sink
    assert ("inc", "witness_verified_total", 7, (("result", "ok"),)) in rec.calls


def test_deadline_flush_and_max_flush(proofs):
    root = proofs[0].state_root
    requests = [(proofs[k:k + 2], [root] * 2) for k in (0, 2, 4)]
    port, jax_out, rec, jrec = _both(proofs, requests, deadline_s=1.0, target=4, max_flush=4)
    assert port == jax_out == [[True, True]] * 3
    flushes = [c for c in rec.named("serve_coalesce_flush_total")]
    assert flushes == jrec.named("serve_coalesce_flush_total")
    assert [c[3] for c in flushes] == [(("trigger", "target"),), (("trigger", "deadline"),)]
    assert rec.named("serve_coalesce") == jrec.named("serve_coalesce")


def test_lone_request_flushes_at_its_deadline(proofs):
    root = proofs[0].state_root
    requests = [(proofs[:3], [root] * 3)]
    port, jax_out, rec, jrec = _both(proofs, requests, deadline_s=0.02, target=64, max_flush=256)
    assert port == jax_out == [[True, True, True]]
    assert rec.named("serve_coalesce") == jrec.named("serve_coalesce")
    assert rec.named("serve_coalesce_flush_total")[0][3] == (("trigger", "deadline"),)


def test_a_failed_flush_fails_every_request_closed(proofs, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("plane failed")

    monkeypatch.setattr(coalesce, "verify_batch", boom)
    monkeypatch.setattr(jcoalesce, "verify_batch", boom)
    root = proofs[0].state_root
    requests = [(proofs[:2], [root] * 2), (proofs[2:4], [root] * 2)]
    port, jax_out, _, _ = _both(proofs, requests, deadline_s=30.0, target=4, max_flush=256)
    for out in (port, jax_out):
        assert all(isinstance(e, RuntimeError) and str(e) == "plane failed" for e in out)


def test_empty_request_answers_at_once():
    co, jco = coalesce.VerifyCoalescer(), jcoalesce.VerifyCoalescer(target=64, max_flush=256)
    assert co.verify([], []) == jco.verify([], []) == []
    assert co.snapshot() == {**jco.snapshot(), "deadline_s": coalesce.DEADLINE_S}
    assert (co.target, co.max_flush, co.deadline_s) == (64, 256, 0.025)
