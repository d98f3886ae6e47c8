"""The port's Beacon API server against the JAX package's.

Both packages' ``serving_fixture``s build the same minimal-spec chain (the
port's on the plain PyTorch versions, ``device="cpu"``); every
deterministic route is asked of both servers through ``_route`` and over a
real socket, and answers the same status, content type and payload: the
roots, block v2, the SSZ state download, witness proofs in JSON and SSZ,
verifies with and without ``state_id``, health, identity and the 400, 404,
405 and 413 answers.  The serve-plane behaviour of the JAX package's
``tests/unit/test_serve_plane.py`` is held on the port (a hit is bit-exact
and roots nothing, block v2 re-keys when finality moves, a reorg evicts the
stale head, coalesced verifies are demuxed per request), ``/metrics``
renders without a duplicate ``TYPE`` and with the JAX package's families,
the ``/debug/*`` routes answer over node stubs as the JAX package's
``test_tracing.py`` and ``test_forensics.py`` build them (with a fixed
clock, payloads equal), ``/debug/compile``, ``/debug/profile`` and
``POST /debug/profile/capture`` answer the JAX server's status codes and
top-level keys for the same requests (none answers 501), a device
error answers 500 and is never retried on the host, and
``run_mixed_traffic`` runs with no non-200 answer and no invalid verdict.
Each test swaps each package's default registry for a fresh one.
Tolerance: none.
"""

import http.client
import json
import socket
import threading
import time as _time

import pytest
import torch

from lambda_ethereum_consensus_tpu import fork_choice as jfc
from lambda_ethereum_consensus_tpu import slo as jslo
from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu import tracing as jtracing
from lambda_ethereum_consensus_tpu.api import beacon_api as jbeacon_api
from lambda_ethereum_consensus_tpu.api import harness as jharness
from lambda_ethereum_consensus_tpu.config import constants as jconstants
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.fork_choice import forensics as jforensics
from lambda_ethereum_consensus_tpu.pipeline import IngestScheduler as JaxIngestScheduler
from lambda_ethereum_consensus_tpu.pipeline import LaneConfig as JaxLaneConfig
from lambda_ethereum_consensus_tpu.pipeline import scheduler as jsched
from lambda_ethereum_consensus_tpu.state_transition import accessors as jacc
from lambda_ethereum_consensus_tpu.state_transition import misc as jmisc
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu_torch import convert, slo, telemetry, tracing
from lambda_ethereum_consensus_tpu_torch import fork_choice as pfc
from lambda_ethereum_consensus_tpu_torch import types as ptypes
from lambda_ethereum_consensus_tpu_torch.api import BeaconApiServer, beacon_api, harness
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.fork_choice import forensics as pforensics
from lambda_ethereum_consensus_tpu_torch.pipeline import IngestScheduler, LaneConfig
from lambda_ethereum_consensus_tpu_torch.pipeline import scheduler as psched
from lambda_ethereum_consensus_tpu_torch.types import BeaconState
from lambda_ethereum_consensus_tpu_torch.witness import coalesce
from lambda_ethereum_consensus_tpu_torch.witness.multiproof import WitnessProof

from .unit.test_fork_choice import SKS, build_block

_REGISTRIES: list = []  # every registry a test swapped in, kept alive
NOW = 1_700_000_000.0


class _FixedClock:
    """A stand-in for the ``time`` module of the server: one wall instant,
    the real monotonic and performance clocks."""

    time = staticmethod(lambda: NOW)
    perf_counter = staticmethod(_time.perf_counter)
    monotonic = staticmethod(_time.monotonic)


class _FixedMonotonic:
    """A stand-in for the ``time`` module of the ingest scheduler: one
    monotonic instant, so arrival stamps and ``oldest_wait_s`` are the same
    in every answer; the real wall and performance clocks."""

    time = staticmethod(_time.time)
    perf_counter = staticmethod(_time.perf_counter)
    monotonic = staticmethod(lambda: 1000.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    """A fresh default registry for each package, and each package's
    process-wide SLO engine made anew over it."""
    out = []
    for tele, mod in ((jtelemetry, jslo), (telemetry, slo)):
        registry = tele.Metrics(enabled=True)
        _REGISTRIES.append(registry)
        monkeypatch.setattr(tele, "_DEFAULT", registry)
        monkeypatch.setattr(mod, "_ENGINE", None)
        out.append(registry)
    return out


@pytest.fixture(scope="module")
def servers():
    """Both packages' serving fixtures, open together:
    ``(jax api, jax store, jax spec, port api, port store, port spec, head)``."""
    with jharness.serving_fixture() as (japi, jstore, jspec, jhead), \
            harness.serving_fixture(device="cpu") as (papi, pstore, pspec, phead):
        assert phead == jhead
        yield japi, jstore, jspec, papi, pstore, pspec, phead


def _both(servers, method, path, body=b"", ctype=""):
    japi, _, _, papi, _, _, _ = servers
    return (japi._route(method, path, body, ctype), papi._route(method, path, body, ctype))


def _paths(head: bytes) -> list[str]:
    h = "0x" + head.hex()
    return [
        "/eth/v1/beacon/states/head/root", "/eth/v1/beacon/states/finalized/root",
        "/eth/v1/beacon/states/justified/root", "/eth/v1/beacon/states/genesis/root",
        f"/eth/v1/beacon/states/{h}/root", "/eth/v1/beacon/states/3/root",
        "/eth/v1/beacon/blocks/head/root", "/eth/v1/beacon/blocks/finalized/root",
        "/eth/v1/beacon/blocks/0/root", "/eth/v1/beacon/blocks/2/root",
        f"/eth/v1/beacon/blocks/{h}/root",
        "/eth/v2/beacon/blocks/head", "/eth/v2/beacon/blocks/1", f"/eth/v2/beacon/blocks/{h}",
        "/eth/v2/beacon/blocks/finalized",
        "/eth/v2/debug/beacon/states/head", "/eth/v2/debug/beacon/states/finalized",
        "/eth/v0/witness/head?indices=balances:0,validators:3",
        "/eth/v0/witness/head?indices=balances:1,inactivity_scores:2",
        "/eth/v0/witness/head?indices=balances:0,validators:3&format=ssz",
        "/eth/v0/witness/2?indices=validators:15,current_epoch_participation:4",
        "/eth/v1/node/health", "/eth/v1/node/identity",
        # the error answers
        "/eth/v1/beacon/states/bogus/root", "/eth/v1/beacon/blocks/99/root",
        "/eth/v1/beacon/blocks/0x" + "ab" * 32 + "/root", "/eth/v0/witness/head",
        "/eth/v0/witness/head?indices=balances", "/eth/v0/witness/head?indices=balances:x",
        "/eth/v0/witness/head?indices=balances:0&format=xml",
        "/eth/v0/witness/head?indices=nosuchfield:1", "/eth/v0/witness/7?indices=balances:0",
        "/nope", "/eth/v1/beacon/states/head/root/extra",
    ]


def test_get_routes_equal(servers):
    head = servers[-1]
    statuses = set()
    for path in _paths(head) + _paths(head):  # the second pass: cache hits
        want, got = _both(servers, "GET", path)
        assert got == want, path
        statuses.add(got[0])
    assert statuses == {"200 OK", "400 Bad Request", "404 Not Found"}


def _verify_bodies(servers):
    """(ctype, body) pairs of the verify route: JSON with and without
    state_id, one bare proof object, one SSZ proof, a corrupted proof, and
    the malformed bodies."""
    japi, _, _, papi, _, _, _ = servers
    status, _, payload = papi._route("GET", "/eth/v0/witness/head?indices=balances:0,validators:3")
    assert status == "200 OK"
    proof = json.loads(payload)["data"]
    ssz = papi._route("GET", "/eth/v0/witness/head?indices=balances:2&format=ssz")[2]
    bad = dict(proof, siblings=["0x" + "5a" * 32] + proof["siblings"][1:])
    js = "application/json"
    return [
        (js, json.dumps({"state_id": "head", "proofs": [proof] * 3}).encode()),
        (js, json.dumps({"proofs": [proof, bad]}).encode()),
        (js, json.dumps({"state_id": "finalized", "proofs": [proof]}).encode()),
        (js, json.dumps(proof).encode()),
        (js, json.dumps({"state_id": "head", "proofs": [proof] * 9 + [bad]}).encode()),
        ("application/octet-stream", ssz),
        ("application/octet-stream; charset=binary", ssz),
        (js, b"{not json"), (js, b"[1, 2]"), (js, b"{}"), (js, b""),
        (js, json.dumps({"state_id": "nosuch", "proofs": [proof]}).encode()),
        ("application/octet-stream", b"\x00\x01"),
    ]


def test_verify_route_equal(servers):
    answers = []
    for ctype, body in _verify_bodies(servers):
        want, got = _both(servers, "POST", "/eth/v0/witness/verify", body, ctype)
        assert got == want, body[:80]
        answers.append(got)
    data = [json.loads(a[2])["data"] for a in answers[:7]]
    assert [d["results"] for d in data] == [[True] * 3, [True, False], [False], [True],
                                            [True] * 9 + [False], [True], [True]]
    assert [d["anchored"] for d in data] == [True, False, True, False, True, False, False]
    assert {a[0] for a in answers[7:]} == {"400 Bad Request"}


def test_method_answers_equal(servers):
    for method, path in (("PUT", "/eth/v1/node/health"), ("DELETE", "/metrics"),
                         ("POST", "/eth/v1/node/health"), ("POST", "/nope"),
                         ("HEAD", "/eth/v1/beacon/states/head/root")):
        want, got = _both(servers, method, path)
        assert got == want
    assert servers[3]._route("PUT", "/x")[0] == "405 Method Not Allowed"


# ----------------------------------------------------- over a real socket


def _raw(port: int, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(request)
        chunks = []
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)


def _http(port: int, method: str, path: str, body: bytes | None = None, ctype: str = ""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.reason, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_socket_answers_equal(servers):
    japi, _, _, papi, _, _, head = servers
    with harness.serving_thread(japi), harness.serving_thread(papi):
        for path in _paths(head):
            assert _http(papi.port, "GET", path) == _http(japi.port, "GET", path), path
        for ctype, body in _verify_bodies(servers):
            got = _http(papi.port, "POST", "/eth/v0/witness/verify", body, ctype)
            assert got == _http(japi.port, "POST", "/eth/v0/witness/verify", body, ctype)
        # the whole answer, byte for byte
        request = b"GET /eth/v1/beacon/states/head/root HTTP/1.1\r\nHost: x\r\n\r\n"
        assert _raw(papi.port, request) == _raw(japi.port, request)
        # 413 before any body byte is read
        big = (b"POST /eth/v0/witness/verify HTTP/1.1\r\nHost: x\r\nContent-Type: "
               b"application/json\r\nContent-Length: %d\r\n\r\n" % (5 << 20))
        got = _raw(papi.port, big)
        assert got == _raw(japi.port, big)
        assert got.startswith(b"HTTP/1.1 413 Payload Too Large\r\n")
        # a request line without a path: the connection closes unanswered
        assert _raw(papi.port, b"GET\r\n\r\n") == _raw(japi.port, b"GET\r\n\r\n") == b""


# -------------------------------------------------------- the serve plane


def _genesis_pair():
    """(jax genesis, jax anchor, jax spec, port genesis, port anchor, port
    spec) of a 64-validator chain, carried into the port as SSZ."""
    jspec, pspec = jax_minimal_spec(), minimal_spec()
    with jax_use_chain_spec(jspec):
        genesis = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=jspec)
        anchor = jtypes.BeaconBlock(slot=0, proposer_index=0, parent_root=b"\x00" * 32,
                                    state_root=genesis.hash_tree_root(jspec),
                                    body=jtypes.BeaconBlockBody())
    pgenesis = convert.state_from_ssz(genesis.encode(jspec), pspec)
    panchor = convert.container_from_ssz("BeaconBlock", anchor.encode(jspec), pspec)
    return genesis, anchor, jspec, pgenesis, panchor, pspec


@pytest.fixture(scope="module")
def genesis_pair():
    return _genesis_pair()


def _counting_roots(monkeypatch) -> list:
    """Counts the port's BeaconState roots."""
    calls = []
    real = BeaconState.hash_tree_root

    def counted(self, spec=None, backend=None):
        calls.append(1)
        return real(self, spec, backend)

    monkeypatch.setattr(BeaconState, "hash_tree_root", counted)
    return calls


def test_cache_hit_is_bit_exact_and_skips_the_encode(genesis_pair, monkeypatch):
    _, _, _, genesis, anchor, spec = genesis_pair
    with use_chain_spec(spec):
        store = pfc.get_forkchoice_store(genesis, anchor, spec)
        api = BeaconApiServer(store=store, spec=spec, device="cpu")
        m = telemetry.get_metrics()
        miss = api._route("GET", "/eth/v1/beacon/states/head/root")
        roots = _counting_roots(monkeypatch)
        hit = api._route("GET", "/eth/v1/beacon/states/head/root")
        assert hit == miss and miss[0] == "200 OK" and not roots
        assert m.get("serve_cache_hit_total", cache="response", kind="state_root") == 1
        assert m.get("serve_cache_miss_total", cache="response", kind="state_root") == 1
        path = "/eth/v0/witness/head?indices=balances:0,validators:3&format=ssz"
        first = api._route("GET", path)
        assert first[0] == "200 OK" and first[1] == "application/octet-stream"
        assert api._route("GET", path) == first
        assert m.get("serve_cache_hit_total", cache="response", kind="witness") == 1
        # the witness engine and the state root hashed on the server's backend
        assert api._witness_service().backend is api._backend
        assert api._backend.device == torch.device("cpu")


def test_block_v2_rekeys_when_finality_moves(servers):
    """The ``finalized`` bit depends on the finalized checkpoint, so the
    answer's key carries it: when finality moves to the slot-2 block, block
    1's answer is built again and flips to final, in both packages."""
    japi, jstore, jspec, papi, pstore, pspec, _ = servers
    answers = []
    for cls, store, spec, kw, tele in (
            (jbeacon_api.BeaconApiServer, jstore, jspec, {}, jtelemetry),
            (BeaconApiServer, pstore, pspec, {"device": "cpu"}, telemetry)):
        api = cls(store=store, spec=spec, **kw)
        m = tele.get_metrics()
        first = api._route("GET", "/eth/v2/beacon/blocks/1")
        assert api._route("GET", "/eth/v2/beacon/blocks/1") == first
        assert m.get("serve_cache_miss_total", cache="response", kind="block_v2") == 1
        kept = store.finalized_checkpoint
        slot2 = next(r for r, b in store.blocks.items() if b.slot == 2)
        store.finalized_checkpoint = kept.copy(root=slot2)
        try:
            moved = api._route("GET", "/eth/v2/beacon/blocks/1")
            assert m.get("serve_cache_miss_total", cache="response", kind="block_v2") == 2
        finally:
            store.finalized_checkpoint = kept
        again = api._route("GET", "/eth/v2/beacon/blocks/1")
        assert again == first
        assert m.get("serve_cache_hit_total", cache="response", kind="block_v2") == 2
        assert json.loads(first[2])["finalized"] is False
        assert json.loads(moved[2])["finalized"] is True
        answers.append((first, moved))
    assert answers[1] == answers[0]


def _flip_vote(jstore, jspec, loser: bytes, anchor_root: bytes):
    """One full committee's signed votes for ``loser`` (the JAX package's)."""
    committee = jacc.get_beacon_committee(jstore.block_states[loser], 1, 0, jspec)
    data = jtypes.AttestationData(slot=1, index=0, beacon_block_root=loser,
                                  source=jstore.justified_checkpoint,
                                  target=jtypes.Checkpoint(epoch=0, root=anchor_root))
    domain = jacc.get_domain(jstore.block_states[loser], jconstants.DOMAIN_BEACON_ATTESTER, 0,
                             jspec)
    signing_root = jmisc.compute_signing_root(data, domain)
    return jtypes.Attestation(aggregation_bits=[True] * len(committee), data=data,
                              signature=jbls.aggregate([jbls.sign(SKS[i], signing_root)
                                                        for i in committee]))


def test_reorg_evicts_the_stale_head(genesis_pair):
    """An attestation-weight head flip: the head-transition hook evicts the
    stale head's answers, and the next GETs answer the new head as a fresh
    server does, in both packages alike."""
    jgenesis, janchor, jspec, pgenesis, panchor, pspec = genesis_pair
    with jax_use_chain_spec(jspec):
        signed_a, _ = build_block(jgenesis, jspec, 1, graffiti=b"\xaa" * 32)
        signed_b, _ = build_block(jgenesis, jspec, 1, graffiti=b"\xbb" * 32)
    json_path = "/eth/v1/beacon/states/head/root"
    ssz_path = "/eth/v0/witness/head?indices=balances:0&format=ssz"
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            fc, genesis, anchor, spec, use, kw = jfc, jgenesis, janchor, jspec, jax_use_chain_spec, {}
            blocks = (signed_a, signed_b)
            make = lambda store: jbeacon_api.BeaconApiServer(store=store, spec=jspec)  # noqa: E731
        else:
            fc, genesis, anchor, spec, use, kw = pfc, pgenesis, panchor, pspec, use_chain_spec, \
                {"device": "cpu"}
            blocks = tuple(convert.block_from_ssz(b.encode(jspec), pspec)
                           for b in (signed_a, signed_b))
            make = lambda store: BeaconApiServer(store=store, spec=pspec, device="cpu")  # noqa: E731
        with use(spec):
            store = fc.get_forkchoice_store(genesis, anchor, spec)
            anchor_root = anchor.hash_tree_root(spec)
            fc.on_tick(store, store.genesis_time + 2 * spec.SECONDS_PER_SLOT, spec)
            roots = [fc.on_block(store, b, spec=spec, **kw) for b in blocks]
            baseline = fc.get_head(store, spec)
            loser = min(roots)
            assert baseline == max(roots)
            api = make(store)
            stale = (api._route("GET", json_path), api._route("GET", ssz_path))
            assert baseline in api._serve_cache._by_root
            vote = _flip_vote(store, spec, loser, anchor_root) if name == "jax" else \
                convert.container_from_ssz("Attestation", out["jax"]["vote"].encode(jspec), pspec)
            fc.on_attestation(store, vote, spec=spec, **kw)
            assert store.head_cache.head() == loser
            api.on_head_transition(baseline, loser)
            assert baseline not in api._serve_cache._by_root
            registry = (jtelemetry if name == "jax" else telemetry).get_metrics()
            fresh = (api._route("GET", json_path), api._route("GET", ssz_path))
            bare = make(store)
            assert fresh == (bare._route("GET", json_path), bare._route("GET", ssz_path))
            assert fresh[0][2] != stale[0][2] and fresh[1][2] != stale[1][2]
            out[name] = dict(vote=vote, stale=stale, fresh=fresh, invalidated=registry.get(
                "serve_cache_invalidations_total", cache="response", reason="head_transition"))
    assert out["port"]["stale"] == out["jax"]["stale"]
    assert out["port"]["fresh"] == out["jax"]["fresh"]
    assert out["port"]["invalidated"] == out["jax"]["invalidated"] == 2


def test_coalesced_verifies_are_demuxed_per_request(servers):
    """Two concurrent POSTs park in one pre-armed coalescer and flush as
    one plane of 6: each answer carries its own request's verdicts."""
    _, _, _, papi, _, pspec, head = servers
    with use_chain_spec(pspec):
        api = BeaconApiServer(store=papi.store, spec=pspec, device="cpu")
        api._coalescer = coalesce.VerifyCoalescer(deadline_s=5.0, target=6)
        proof = json.loads(api._route(
            "GET", "/eth/v0/witness/head?indices=balances:0,validators:3")[2])["data"]
        bad = dict(proof, leaves=[[proof["leaves"][0][0], "0x" + "00" * 32]] + proof["leaves"][1:])
        bodies = [json.dumps({"state_id": "head", "proofs": [proof] * 3}).encode(),
                  json.dumps({"state_id": "head", "proofs": [proof, bad, proof]}).encode()]
        answers = {}

        def post(i):
            answers[i] = api._route("POST", "/eth/v0/witness/verify", bodies[i],
                                    "application/json")

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    data = [json.loads(answers[i][2])["data"] for i in range(2)]
    assert [d["results"] for d in data] == [[True] * 3, [True, False, True]]
    assert [d["valid"] for d in data] == [True, False]
    m = telemetry.get_metrics()
    assert m.get("serve_coalesce_requests_total") == 2
    assert m.get("serve_coalesce_proofs_total") == 6
    assert m.get("serve_coalesce_flush_total", trigger="target") == 1


# ------------------------------------------------------------- /metrics


def _families(text: str) -> list[str]:
    return [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")]


def test_metrics_route_families(servers, _registries):
    head = servers[-1]
    for path in _paths(head):
        _both(servers, "GET", path)
    for ctype, body in _verify_bodies(servers)[:3]:
        _both(servers, "POST", "/eth/v0/witness/verify", body, ctype)
    want, got = _both(servers, "GET", "/metrics")
    assert got[:2] == want[:2] == ("200 OK", "text/plain; version=0.0.4")
    got_f, want_f = _families(got[2].decode()), _families(want[2].decode())
    assert len(got_f) == len(set(got_f)) and len(want_f) == len(set(want_f))
    assert set(got_f) == set(want_f)
    text = got[2].decode()
    for path in ("/eth/v1/beacon/states/{id}/root", "/eth/v0/witness/{id}",
                 "/eth/v0/witness/verify", "/eth/v1/node/health"):
        assert f'api_request_seconds_count{{route="{path}"}}' in text


def test_metrics_route_merges_the_node_registry(monkeypatch):
    """The family-aware merge: a family in both registries renders once,
    from the node's registry; the default registry's others come through;
    one combined scrape block.  Equal to the JAX package's render but for
    the scrape's own seconds."""
    bodies = []
    for tele, cls in ((jtelemetry, jbeacon_api.BeaconApiServer), (telemetry, BeaconApiServer)):
        default, node_m = tele.get_metrics(), tele.Metrics()
        node_m.inc("network_gossip_count", value=3, type="beacon_block")
        node_m.set_gauge("sync_store_slot", 9)
        default.inc("network_gossip_count", value=100, type="bench")
        default.observe("gossip_drain_seconds", 0.02, topic="beacon_block")
        kw = {} if cls is jbeacon_api.BeaconApiServer else {"device": "cpu"}
        _, _, body = cls(store=None, spec=None, metrics=node_m, **kw)._metrics()
        bodies.append([line for line in body.decode().splitlines()
                       if not line.startswith("telemetry_scrape_seconds ")])
    assert bodies[1] == bodies[0]
    text = "\n".join(bodies[1])
    assert text.count("# TYPE network_gossip_count counter") == 1
    assert 'network_gossip_count{type="beacon_block"} 3' in text
    assert 'network_gossip_count{type="bench"}' not in text
    assert "# TYPE gossip_drain_seconds histogram" in text


# ----------------------------------------------------------- debug routes


def test_unported_routes_answer_501(servers, monkeypatch, tmp_path):
    """The compile and profile routes, once 501 in the port: for the same
    requests the port answers the JAX server's status codes with the same
    top-level keys in ``data``, and none answers 501.  Both captures run a
    fake tracer (``tests/unit/test_profile.py``'s) into ``tmp_path``."""
    from lambda_ethereum_consensus_tpu.ops import profile as jprofile

    from lambda_ethereum_consensus_tpu_torch.ops import profile

    class Tracer:
        def start_trace(self, path):
            with open(f"{path}/trace.json", "w") as fh:
                fh.write("{}")

        def stop_trace(self):
            pass

    for mod in (jprofile, profile):
        real = mod.capture_trace
        monkeypatch.setattr(mod, "capture_trace",
                            lambda s, out_dir=None, real=real: real(s, out_dir, Tracer()))
    monkeypatch.delenv("PROFILE_CAPTURE_MAX_S", raising=False)
    requests = [
        ("GET", "/debug/compile", b""), ("GET", "/debug/profile", b""),
        ("POST", "/debug/profile/capture", b'{"seconds": 99}'),
        ("POST", "/debug/profile/capture", b"{}"),
        ("POST", "/debug/profile/capture", b"not json"),
        ("POST", "/debug/profile/capture", b'{"seconds": "soon"}'),
        ("POST", "/debug/profile/capture", b'{"seconds": 0.01, "dir": 7}'),
        ("POST", "/debug/profile/capture",
         json.dumps({"seconds": 0.01, "dir": str(tmp_path)}).encode()),
    ]
    for method, path, body in requests:
        want, got = _both(servers, method, path, body, "application/json")
        assert got[:2] == want[:2], (path, body, got[2], want[2])
        assert not got[0].startswith("501")
        g, w = json.loads(got[2]), json.loads(want[2])
        assert set(g) == set(w)
        if "data" in w:
            assert got[0] == "200 OK" and set(g["data"]) == set(w["data"]), path
        else:
            assert g["code"] == w["code"] == 400 and g["message"] == w["message"]
    assert telemetry.get_metrics().get_histogram(
        "api_request_seconds", route="/debug/profile/capture")[3] == 6
    for path in ("/debug/compile", "/debug/profile"):
        assert telemetry.get_metrics().get_histogram("api_request_seconds", route=path)[3] == 1


def test_debug_slo_is_the_ports_engine(servers, _registries):
    """``/debug/slo`` over the same observations: the JAX report less its
    ``device_health`` block (and the engines' uptime)."""
    for registry in _registries:
        for v in (0.01, 0.02, 0.9, 3.0):
            registry.observe("witness_verify_seconds", v)
        registry.observe("duty_completion_offset_seconds", 9.0, type="attest")
        registry.observe("api_request_seconds", 0.001, route="/metrics")
    want, got = _both(servers, "GET", "/debug/slo")
    assert got[:2] == want[:2] == ("200 OK", "application/json")
    want, got = json.loads(want[2])["data"], json.loads(got[2])["data"]
    assert "device_health" in want and "device_health" not in got
    for report in (want, got):
        report.pop("uptime_s")
        report.pop("device_health", None)
    assert got == want and got["ok"] is False
    rows = {r["slo"]: r for r in got["slos"]}
    assert rows["witness_verify_p95"]["status"] == "violated"
    assert rows["duty_attest_deadline_p95"]["count"] == 1
    # read-only: no evaluation counted, no snapshot kept
    assert telemetry.get_metrics().get("slo_evaluations_total") == 0
    assert len(slo.get_engine()._snaps) == 0


def test_debug_trace_route(servers):
    events = []
    for tracing_mod, api in ((jtracing, servers[0]), (tracing, servers[3])):
        t = tracing_mod.new_trace("beacon_block")
        t.end("done", {"verdict": "accept"})
        status, ctype, body = api._route("GET", "/debug/trace")
        assert (status, ctype) == ("200 OK", "application/json")
        doc = json.loads(body)
        mine = [(e["ph"], e["name"]) for e in doc["traceEvents"]
                if e.get("id") == format(t.trace_id, "x")]
        assert ("b", "beacon_block") in mine
        events.append(mine)
        _, _, other = api._route("GET", "/debug/trace?node=nosuch")
        assert json.loads(other)["traceEvents"] == [] or all(
            e.get("ph") == "M" for e in json.loads(other)["traceEvents"])
    assert events[1] == events[0]


def test_debug_node_routes_equal(monkeypatch):
    """``/debug/lanes``, ``/debug/slot``, ``/debug/peers`` and
    ``/debug/fleet`` over node stubs, and their 404s without one."""
    for mod in (jbeacon_api, beacon_api):
        monkeypatch.setattr(mod, "time", _FixedClock)
    for mod in (jsched, psched):
        monkeypatch.setattr(mod, "time", _FixedMonotonic)
    import asyncio

    answers = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            sched_cls, lane_cls, clock_cls, tele = \
                JaxIngestScheduler, JaxLaneConfig, jtracing.SlotClock, jtelemetry
            make = jbeacon_api.BeaconApiServer
            kw = {}
        else:
            sched_cls, lane_cls, clock_cls, tele = \
                IngestScheduler, LaneConfig, tracing.SlotClock, telemetry
            make = BeaconApiServer
            kw = {"device": "cpu"}

        async def lanes():
            sched = sched_cls(metrics=tele.Metrics(enabled=True), max_items=100)
            sched.add_lane(lane_cls(name="block", priority=0, max_queue=8))
            sched.add_lane(lane_cls(name="agg", priority=1, max_queue=16))

            class Null:
                async def process(self, items): ...

                async def shed(self, item, reason="overload"): ...

            sched.submit("agg", "x", Null())

            class NodeStub:
                ingest = sched
                slot_clock = clock_cls(genesis_time=int(NOW) - 25, seconds_per_slot=12)
                _gossip_stats = {"peers": {"ab": {"score": 1.5}}}
                _gossip_stats_ts = NOW - 2.5

            class Observatory:
                @staticmethod
                def fleet_view():
                    return {"members": ["a", "b"]}

            api = make(store=None, spec=None, node=NodeStub(), **kw)
            api.observatory = Observatory()
            bare = make(store=None, spec=None, **kw)
            out = []
            for path in ("/debug/lanes", "/debug/slot", "/debug/peers", "/debug/fleet"):
                for server in (api, bare):
                    status, ctype, body = server._route("GET", path)
                    data = json.loads(body)
                    if path == "/debug/lanes" and status == "200 OK":
                        data["data"].pop("recorder")  # each package's own ring
                    out.append((path, status, ctype, data))
            return out

        answers.append(asyncio.run(lanes()))
    assert answers[1] == answers[0]
    statuses = [(path, status) for path, status, _, _ in answers[1]]
    assert statuses == [(p, s) for p in ("/debug/lanes", "/debug/slot", "/debug/peers",
                                         "/debug/fleet") for s in ("200 OK", "404 Not Found")]
    slot = answers[1][2][3]["data"]
    assert slot["slot"] == 2 and slot["offset_s"] == 1.0


def test_debug_forensics_routes_equal(genesis_pair, monkeypatch):
    """``/debug/forkchoice``, ``/debug/reorgs`` and ``/debug/finality`` over
    a two-branch store with the forensics plane attached and a head flip
    recorded; 404 without the plane."""

    class _Fixed:
        time = staticmethod(lambda: NOW)

    for mod in (jforensics, pforensics):
        monkeypatch.setattr(mod, "time", _Fixed)
    jgenesis, janchor, jspec, pgenesis, panchor, pspec = genesis_pair
    with jax_use_chain_spec(jspec):
        signed_a, _ = build_block(jgenesis, jspec, 1, graffiti=b"\xaa" * 32)
        signed_b, _ = build_block(jgenesis, jspec, 1, graffiti=b"\xbb" * 32)
    answers, vote = [], None
    for pkg in ("jax", "port"):
        if pkg == "jax":
            fc, genesis, anchor, spec, use, kw = jfc, jgenesis, janchor, jspec, jax_use_chain_spec, {}
            blocks = (signed_a, signed_b)
            make, mkw = jbeacon_api.BeaconApiServer, {}
        else:
            fc, genesis, anchor, spec, use, kw = pfc, pgenesis, panchor, pspec, use_chain_spec, \
                {"device": "cpu"}
            blocks = tuple(convert.block_from_ssz(b.encode(jspec), pspec)
                           for b in (signed_a, signed_b))
            make, mkw = BeaconApiServer, {"device": "cpu"}
        with use(spec):
            store = fc.get_forkchoice_store(genesis, anchor, spec)
            bare = make(store=store, spec=spec, **mkw)
            missing = [bare._route("GET", p)[0] for p in
                       ("/debug/forkchoice", "/debug/reorgs", "/debug/finality")]
            store.forensics = fc.ConsensusForensics(enabled=True)
            anchor_root = anchor.hash_tree_root(spec)
            fc.on_tick(store, store.genesis_time + 2 * spec.SECONDS_PER_SLOT, spec)
            roots = [fc.on_block(store, b, spec=spec, **kw) for b in blocks]
            head = fc.get_head(store, spec)
            if vote is None:
                vote = _flip_vote(store, spec, min(roots), anchor_root)
                this_vote = vote
            else:
                this_vote = convert.container_from_ssz("Attestation", vote.encode(jspec), pspec)
            fc.on_attestation(store, this_vote, spec=spec, **kw)
            new_head = fc.get_head(store, spec)
            store.forensics.observe_transition(store, head, new_head)
            store.forensics.observe_epoch(store, spec)
            api = make(store=store, spec=spec, **mkw)
            got = [api._route("GET", p) for p in
                   ("/debug/forkchoice", "/debug/reorgs", "/debug/finality")]
            answers.append((missing, got))
    assert answers[1] == answers[0]
    missing, got = answers[1]
    assert missing == ["404 Not Found"] * 3 and {g[0] for g in got} == {"200 OK"}
    reorgs = json.loads(got[1][2])["data"]
    assert reorgs["reorg_count"] == 1 and reorgs["evidence"][0]["kind"] == "double_proposal"


# -------------------------------------------------------- the device rule


class _FaultyBackend:
    """A hash backend whose every call is a device fault."""

    def hash_level(self, blocks):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    def merkle_subtree_root(self, chunks):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_a_device_error_answers_500_and_is_not_retried(servers, monkeypatch):
    """A fault of the server's device answers 500, caches nothing, and
    never falls back to a host root; the coalescer's plane likewise."""
    _, _, _, papi, _, pspec, _ = servers
    with use_chain_spec(pspec):
        api = BeaconApiServer(store=papi.store, spec=pspec, device="cpu")
        api._backend = _FaultyBackend()
        for _ in range(2):
            status, _, body = api._route("GET", "/eth/v1/beacon/states/head/root")
            assert status == "500 Error" and json.loads(body)["message"] == "internal error"
        assert len(api._serve_cache) == 0

        def broken(*args, **kwargs):
            raise RuntimeError("CUDA error: device-side assert triggered")

        monkeypatch.setattr(coalesce, "verify_batch", broken)
        proof = WitnessProof.decode(papi._route(
            "GET", "/eth/v0/witness/head?indices=balances:0&format=ssz")[2])
        body = json.dumps({"proofs": [proof.to_json()] * 8}).encode()
        status, _, _ = api._route("POST", "/eth/v0/witness/verify", body, "application/json")
        assert status == "500 Error"


def test_the_card_by_default(monkeypatch):
    """``device=None`` is the card: without one the server refuses to
    start rather than hashing on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BeaconApiServer(store=None, spec=None)
    assert beacon_api.SERVE_CACHE_ENTRIES == 2048 and beacon_api.SERVE_CACHE_BYTES == 64 << 20


# ---------------------------------------------------------- mixed traffic


def test_run_mixed_traffic(servers):
    _, _, _, papi, _, pspec, head = servers
    with use_chain_spec(pspec):
        report = harness.run_mixed_traffic(papi, head, 0.5)
    assert report["non_200_count"] == 0 and report["non_200"] == []
    assert report["invalid_verdicts"] == 0
    assert report["get_requests"] > 0 and report["post_requests"] > 0
    assert report["post_proofs"] == 16 * report["post_requests"]
    assert report["coalesce_flushes"] > 0 and report["coalesce_mean_batch"] >= 16
    assert report["cache_hit_ratio"] == 1.0  # every GET key warmed before the window
