"""Per-item drain containment, the drain's trace fan-in and the registry's
families: the port's fork choice against the JAX package's.

A minimal-preset chain of 64 validators (keys ``(i + 1).to_bytes(32,
"big")``): the JAX package mints a slot-1 block
(``tests/unit/test_fork_choice.build_block``) and a gossip drain of four
aggregates over slot 1's two committees, carried into the port as SSZ
bytes; both packages import the block from their own anchor store, and the
port runs on the plain PyTorch versions (``device="cpu"``).

The malformed item is one aggregate whose aggregation bits are a
hand-built sequence of the committee's length whose elements raise when
read (``TypeError``): outside every class the drain bodies catch, so each
package contains it into that item's ignore verdict, counted in
``gossip_batch_error_count{stage="item"}``, and the rest of the drain goes
on.  The port runs both of its bodies, chosen through its constant
``fork_choice/handlers.DRAIN_DEVICE_MIN`` (0: the cached body; above the
drain: the host body), each against the JAX package's host body (its
cached body needs the jitted device pipeline, minutes of compiling on the
CPU).  For the fan-in comparison of the cached body, the JAX package is
told to take its cached route (``crypto.bls.batch._chain_enabled`` patched
true for the route decision alone) with that route's body swapped for its
host body, which gives the same verdicts by contract: so its span, member
events and forensics record carry ``path="cached"`` like the port's.

Timing fields (``ts_us``, ``dur_us``, the members' event instants, the
records' ``ts``) are pinned, not compared by structure: each package's
``tracing.time`` and ``handlers._time`` are swapped for scripted clocks
that step 1 ms on every read (one per module, so equal call sequences read
equal instants), and ``forensics.time`` for one fixed instant.  Tolerance:
none — verdict strings, reject polarity, latest messages, recorder entries
and records are exact.

The last test drives one chain through both packages on fresh registries
(a block, a drain with traces, ``get_head``, a reorg record, a finality
sample, an attester slashing, a finalized advance, an epoch boundary, one
KZG verification and one witness ``verify_batch``) and holds the port's
``family_names()`` equal to the JAX package's, less the families the port
does not carry: ``device_fault*`` and the compile-cache and sharded-plane
families (the JAX help strings the port's registry dropped).
The resident plane's gauges, whose JAX counterpart compiles for minutes on
the CPU, are held against the port's own plane.
"""

import pytest
import torch

from lambda_ethereum_consensus_tpu import fork_choice as jfc
from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu import tracing as jtracing
from lambda_ethereum_consensus_tpu.config import constants as jconstants
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.crypto.bls import batch as jbatch
from lambda_ethereum_consensus_tpu.da import kzg as jkzg
from lambda_ethereum_consensus_tpu.fork_choice import forensics as jforensics
from lambda_ethereum_consensus_tpu.fork_choice import handlers as jhandlers
from lambda_ethereum_consensus_tpu.ssz import core as jssz
from lambda_ethereum_consensus_tpu.state_transition import accessors as jacc
from lambda_ethereum_consensus_tpu.state_transition import misc as jmisc
from lambda_ethereum_consensus_tpu.state_transition import process_slots as jax_process_slots
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu.witness import multiproof as jmp
from lambda_ethereum_consensus_tpu.witness import verify as jverify
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch import fork_choice as pfc
from lambda_ethereum_consensus_tpu_torch import telemetry as ptelemetry
from lambda_ethereum_consensus_tpu_torch import tracing as ptracing
from lambda_ethereum_consensus_tpu_torch import types as ptypes
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.da import kzg as pkzg
from lambda_ethereum_consensus_tpu_torch.fork_choice import forensics as pforensics
from lambda_ethereum_consensus_tpu_torch.fork_choice import handlers as phandlers
from lambda_ethereum_consensus_tpu_torch.ssz import core as pssz
from lambda_ethereum_consensus_tpu_torch.state_transition import process_slots
from lambda_ethereum_consensus_tpu_torch.witness import multiproof as pmp
from lambda_ethereum_consensus_tpu_torch.witness import verify as pverify

from .unit.test_fork_choice import SKS, build_block

MALFORMED = 2  # the drain position of the malformed aggregate
_REGISTRIES: list = []  # every registry a test swapped in, kept alive


class _Unreadable:
    """An aggregation bit that raises when read."""

    def __init__(self, error: type):
        self.error = error

    def __bool__(self):
        raise self.error("unreadable aggregation bit")


class _Clock:
    """A stand-in for the ``time`` module: every read advances 1 ms."""

    def __init__(self):
        self.now = 500.0

    def monotonic(self) -> float:
        self.now += 0.001
        return self.now

    time = perf_counter = monotonic


class _FixedClock:
    @staticmethod
    def time() -> float:
        return 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _ambient(monkeypatch):
    """Both packages read ``GRAFT_RESIDENT_EPOCH``; each gets fresh,
    enabled default registries (its SSZ root spans included), a fresh
    enabled recorder and pinned clocks."""
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")
    for telemetry, tracing, handlers, forensics, ssz in (
        (jtelemetry, jtracing, jhandlers, jforensics, jssz),
        (ptelemetry, ptracing, phandlers, pforensics, pssz),
    ):
        registry = telemetry.Metrics(enabled=True)
        _REGISTRIES.append(registry)
        monkeypatch.setattr(telemetry, "_DEFAULT", registry)
        monkeypatch.setattr(ssz, "_METRICS", registry)
        monkeypatch.setattr(ssz, "_ROOT_SPANS", {})
        monkeypatch.setattr(tracing, "_RECORDER", tracing.FlightRecorder(enabled=True))
        monkeypatch.setattr(tracing, "time", _Clock())
        monkeypatch.setattr(handlers, "_time", _Clock())
        monkeypatch.setattr(forensics, "time", _FixedClock)


def _anchor_block(types, genesis, spec):
    return types.BeaconBlock(
        slot=0,
        proposer_index=0,
        parent_root=bytes(genesis.latest_block_header.parent_root),
        state_root=genesis.hash_tree_root(spec),
        body=types.BeaconBlockBody(),
    )


@pytest.fixture(scope="module")
def chain():
    """The JAX package's genesis, anchor, slot-1 block and drain (full
    committee 0, full committee 1, a second full committee-0 aggregate to
    be made malformed, committee 1 with one member missing), an attester
    slashing, and one blob with its commitment and proof (width 4)."""
    spec = jax_minimal_spec()
    with jax_use_chain_spec(spec):
        genesis = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=spec)
        anchor = _anchor_block(jtypes, genesis, spec)
        anchor_root = anchor.hash_tree_root(spec)
        block, post = build_block(genesis, spec, 1)
        head = block.message.hash_tree_root(spec)
        cp = jtypes.Checkpoint(epoch=0, root=anchor_root)
        domain = jacc.get_domain(post, jconstants.DOMAIN_BEACON_ATTESTER, 0, spec)

        def aggregate(index, missing=0):
            committee = list(jacc.get_beacon_committee(post, 1, index, spec))
            bits = [True] * (len(committee) - missing) + [False] * missing
            data = jtypes.AttestationData(slot=1, index=index, beacon_block_root=head,
                                          source=cp, target=cp)
            root = jmisc.compute_signing_root(data, domain)
            signers = [v for v, b in zip(committee, bits) if b]
            return jtypes.Attestation(aggregation_bits=bits, data=data, signature=jbls.aggregate(
                [jbls.sign(SKS[v], root) for v in signers]))

        drain = [aggregate(0), aggregate(1), aggregate(0), aggregate(1, missing=1)]
        indexed = []
        for root in (head, anchor_root):
            d = drain[0].data.copy(beacon_block_root=root)
            sroot = jmisc.compute_signing_root(d, domain)
            indexed.append(jtypes.IndexedAttestation(
                attesting_indices=[0, 1, 2, 3], data=d,
                signature=jbls.aggregate([jbls.sign(SKS[i], sroot) for i in range(4)])))
        slashing = jtypes.AttesterSlashing(attestation_1=indexed[0], attestation_2=indexed[1])
        setup = jkzg.dev_setup(4)
        blob = b"".join((7 * i + 3).to_bytes(32, "big") for i in range(4))
        commitment = jkzg.blob_to_commitment(blob, setup, device=False)
        proof = jkzg.compute_blob_proof(blob, commitment, setup, device=False)
    return dict(spec=spec, genesis=genesis, anchor=anchor, block=block, drain=drain,
                slashing=slashing, blob=(blob, commitment, proof))


class _Side:
    """One package's fork choice over the shared chain."""

    def __init__(self, name, chain):
        jspec = chain["spec"]
        self.name = name
        if name == "jax":
            self.fc, self.tracing, self.telemetry = jfc, jtracing, jtelemetry
            self.spec, self.use_spec, self.kw = jspec, jax_use_chain_spec, {}
            self.genesis, self.anchor, self.block = chain["genesis"], chain["anchor"], chain["block"]
            self.drain, self.slashing = list(chain["drain"]), chain["slashing"]
            return
        pspec = minimal_spec()
        self.fc, self.tracing, self.telemetry = pfc, ptracing, ptelemetry
        self.spec, self.use_spec, self.kw = pspec, use_chain_spec, {"device": "cpu"}
        self.genesis = convert.state_from_ssz(chain["genesis"].encode(jspec), pspec)
        with use_chain_spec(pspec):
            self.anchor = _anchor_block(ptypes, self.genesis, pspec)
        self.block = convert.block_from_ssz(chain["block"].encode(jspec), pspec)
        self.drain = [convert.container_from_ssz("Attestation", a.encode(jspec), pspec)
                      for a in chain["drain"]]
        self.slashing = convert.container_from_ssz(
            "AttesterSlashing", chain["slashing"].encode(jspec), pspec)

    def store(self):
        store = self.fc.get_forkchoice_store(self.genesis, self.anchor, self.spec)
        store.forensics = self.fc.ConsensusForensics()
        self.fc.on_tick(store, store.genesis_time + 2 * self.spec.SECONDS_PER_SLOT, self.spec)
        self.fc.on_block(store, self.block, spec=self.spec, **self.kw)
        return store

    def malformed(self, error: type) -> list:
        drain = list(self.drain)
        bad = drain[MALFORMED]
        drain[MALFORMED] = bad.copy(
            aggregation_bits=[_Unreadable(error)] * len(bad.aggregation_bits))
        return drain

    def drain_call(self, store, drain, traces=None):
        return self.fc.on_attestation_batch(store, drain, spec=self.spec, traces=traces,
                                            **self.kw)

    def errors(self, stage: str) -> float:
        return self.telemetry.get_metrics().get("gossip_batch_error_count", stage=stage)


def _verdicts(results) -> list:
    return [None if r is None else (str(r), bool(r.reject)) for r in results]


def _messages(store) -> dict:
    return {int(i): (int(m.epoch), bytes(m.root)) for i, m in store.latest_messages.items()}


@pytest.fixture(params=["host", "cached"])
def body(request, monkeypatch):
    """The port's drain body, chosen through its constant."""
    monkeypatch.setattr(phandlers, "DRAIN_DEVICE_MIN", 0 if request.param == "cached" else 99)
    return request.param


def _run(chain, fn, jax_path: str = "host"):
    """``fn(side)`` on the JAX package (its host body, labelled
    ``jax_path``) and on the port."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if jax_path == "cached":
            real_route, host_body = jbatch._chain_enabled, jhandlers._attestation_batch_host

            def cached_body(*args):
                # the route decision said "cached"; the host body's own
                # verify keeps its real route (the host tail)
                with pytest.MonkeyPatch.context() as inner:
                    inner.setattr(jbatch, "_chain_enabled", real_route)
                    return host_body(*args)

            mp.setattr(jbatch, "_chain_enabled", lambda n: True)
            mp.setattr(jhandlers, "_attestation_batch_cached", cached_body)
        side = _Side("jax", chain)
        with side.use_spec(side.spec):
            out["jax"] = fn(side)
    side = _Side("port", chain)
    with side.use_spec(side.spec):
        out["port"] = fn(side)
    return out["jax"], out["port"]


# ------------------------------------------------------------ containment


def test_malformed_item_is_contained_on_both_bodies(chain, body):
    def run(side):
        store = side.store()
        before = side.errors("item")
        results = side.drain_call(store, side.malformed(TypeError))
        return dict(verdicts=_verdicts(results), messages=_messages(store),
                    counted=side.errors("item") - before, context=side.errors("context"))

    want, got = _run(chain, run)
    assert got == want
    verdicts = got["verdicts"]
    assert verdicts[MALFORMED] == (
        "attestation drain internal error: TypeError: unreadable aggregation bit", False)
    assert [v for i, v in enumerate(verdicts) if i != MALFORMED] == [None, None, None]
    assert got["counted"] == 1 and got["context"] == 0
    assert len(got["messages"]) == 8  # both committees' votes landed


def test_runtime_error_raises_in_the_port(chain, body):
    """The deliberate divergence: a ``RuntimeError`` (a kernel, native or
    CUDA fault) out of one item raises out of the port's drain, on either
    body, where the JAX package contains it like any other error."""
    side = _Side("jax", chain)
    with side.use_spec(side.spec):
        jresults = side.drain_call(side.store(), side.malformed(RuntimeError))
    assert _verdicts(jresults)[MALFORMED] == (
        "attestation drain internal error: RuntimeError: unreadable aggregation bit", False)
    side = _Side("port", chain)
    with side.use_spec(side.spec):
        store = side.store()
        with pytest.raises(RuntimeError, match="unreadable aggregation bit"):
            side.drain_call(store, side.malformed(RuntimeError))
        assert side.errors("item") == 0


# ---------------------------------------------------------- trace fan-in


def test_drain_with_traces_matches_jax(chain, body):
    def run(side):
        store = side.store()
        drain = side.malformed(TypeError)
        traces = [side.tracing.new_trace("gossip_attestation") for _ in drain]
        traces[1] = None  # an item admitted without a trace
        results = side.drain_call(store, drain, traces)
        for t in traces:
            if t is not None:
                t.end("done")
        rec = side.tracing.get_recorder()
        admit = side.telemetry.get_metrics().get_histogram("attestation_admit_apply_seconds")
        return dict(verdicts=_verdicts(results), snapshot=rec.snapshot(), chrome=rec.chrome(),
                    weights=store.forensics._weight_events.list(), admit=admit,
                    spans=[s[0] for s in side.telemetry.get_metrics().histogram_series(
                        "attestation_batch_verify_seconds")])

    want, got = _run(chain, run, jax_path=body)
    assert got == want
    (span,) = [ev for ev in got["snapshot"] if ev["kind"] == "span"]
    batch = span["trace_id"]
    assert span["args"]["path"] == body and span["args"]["n"] == 4
    assert span["args"]["n_members"] == 3 and span["args"]["n_devices"] == 1
    verify = [ev for ev in got["snapshot"] if ev["name"] == "verify"]
    assert len(verify) == 3 and all(ev["args"] == {"batch": batch, "path": body} for ev in verify)
    assert sum(ev["name"] == "apply" for ev in got["snapshot"]) == 2
    assert sum(ev["name"] == "drop" for ev in got["snapshot"]) == 1
    (weight,) = got["weights"]
    assert weight["batch"] == batch and weight["path"] == body and weight["n"] == 4
    assert got["admit"][3] == 2
    assert got["spans"] == [(("n_devices", 1), ("path", body))]


def test_drain_without_live_traces_still_logs_the_batch(chain):
    def run(side):
        store = side.store()
        side.drain_call(store, side.drain[:1], [None])
        return dict(weights=store.forensics._weight_events.list(),
                    snapshot=side.tracing.get_recorder().snapshot())

    want, got = _run(chain, run)
    assert got == want
    assert got["snapshot"] == []
    assert [(w["batch"], w["path"], w["n"]) for w in got["weights"]] == [(None, "host", 1)]


# ---------------------------------------------------------- the families


def test_registry_families_match_jax(chain, monkeypatch):
    """One chain through both packages on fresh registries: the port's
    families equal the JAX package's, less the families it does not carry."""
    monkeypatch.setattr(phandlers, "DRAIN_DEVICE_MIN", 99)  # the host body, as the JAX drain
    blob, commitment, proof = chain["blob"]

    def run(side):
        spec = side.spec
        store = side.store()
        side.fc.get_head(store, spec)
        traces = [side.tracing.new_trace("gossip_attestation") for _ in side.drain]
        side.drain_call(store, side.drain, traces)
        head = side.fc.get_head(store, spec)
        store.forensics.observe_transition(store, side.anchor.hash_tree_root(spec), head)
        store.forensics.observe_epoch(store, spec)
        side.fc.on_attester_slashing(store, side.slashing, spec)
        cp = type(store.justified_checkpoint)(epoch=1, root=side.anchor.hash_tree_root(spec))
        (jhandlers if side.name == "jax" else phandlers).update_checkpoints(store, cp, cp)
        store.forensics.export_ring_drops(side.telemetry.get_metrics())
        if side.name == "jax":
            jax_process_slots(side.genesis, spec.SLOTS_PER_EPOCH, spec)
            ok = jkzg.verify_blob_proof(blob, commitment, proof, jkzg.dev_setup(4))
            wproof = jmp.WitnessPlanner().prove(side.genesis, [("balances", 3)], spec)
            verdicts = jverify.verify_batch([wproof, "junk"], wproof.state_root, device=False)
        else:
            process_slots(side.genesis, spec.SLOTS_PER_EPOCH, spec, "cpu")
            ok = pkzg.verify_blob_proof(blob, commitment, proof, pkzg.dev_setup(4))
            wproof = pmp.WitnessPlanner().prove(side.genesis, [("balances", 3)], spec)
            verdicts = pverify.verify_batch([wproof, "junk"], wproof.state_root, device="cpu")
        return dict(families=side.telemetry.get_metrics().family_names(), ok=ok,
                    verdicts=verdicts)

    want, got = _run(chain, run)
    dropped = set(jtelemetry._HELP) - set(ptelemetry._HELP)
    assert dropped and all(name.startswith(("device_", "aot_", "ops_", "profile_"))
                           for name in dropped)
    carried = {name for name in want["families"]
               if name not in dropped and not name.startswith("device_fault")}
    assert got["families"] == carried
    assert got["ok"] is want["ok"] is True and got["verdicts"] == want["verdicts"] == [True, False]
    for family in ("attestation_batch_verify_seconds", "fork_choice_head_recompute_seconds",
                   "block_transition_seconds", "epoch_transition_seconds",
                   "ssz_hash_tree_root_seconds", "kzg_verify_seconds", "kzg_blobs_verified_total",
                   "witness_verify_seconds", "witness_verified_total",
                   "attestation_admit_apply_seconds", "reorg_depth", "finality_lag_epochs",
                   "participation_rate", "forensics_evidence_total",
                   "checkpoint_cache_pruned_count"):
        assert family in got["families"], family


def test_resident_plane_gauges(chain, monkeypatch):
    """The resident plane's two gauges, as the JAX package's plane sets
    them (its own plane compiles for minutes on the CPU, so the port's
    values are held against its plane's state): ``resident_plane_validators``
    after a sync, ``resident_plane_sync_elems`` after an epoch on the plane,
    each epoch boundary timed by the ``epoch_transition`` span."""
    jspec = chain["spec"]
    pspec = minimal_spec()
    state = convert.state_from_ssz(chain["genesis"].encode(jspec), pspec)
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "1")
    with use_chain_spec(pspec):
        out = process_slots(state, 2 * pspec.SLOTS_PER_EPOCH + 1, pspec, "cpu")
    plane = out._resident_plane
    m = ptelemetry.get_metrics()
    assert m.get("resident_plane_validators") == plane.n == len(out.validators)
    assert m.get("resident_plane_sync_elems") == plane.stats["scatter_elems"]
    assert plane.stats["sweeps"] == 2
    assert m.get_histogram("epoch_transition_seconds")[3] == 2
