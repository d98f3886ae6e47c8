"""Serving-plane load harness: one mini chain + one mixed GET/witness
traffic generator, shared by every caller that drives the serving plane (the
port's tests, and ``chip_smoke.py``'s mixed-traffic step at full width),
so they can never desynchronize on the traffic mix or the accounting.

The generator pushes CLOSED-LOOP traffic through the server's own
worker-thread dispatch (``BeaconApiServer._route``) from a thread pool
— the exact code path a socket request runs after header parsing
(route-table regex dispatch, handler, response-cache read, coalescer
park, ``api_request_seconds`` observation), with the kernel's loopback
stack subtracted so a test box can reach production request rates.  The
socket layer itself is exercised separately by its callers.

Traffic mix (per GET worker loop iteration, round-robin): state root /
block root / block v2 by alias and by concrete root, plus hot-leaf-set
witness multiproofs in both encodings.  POST workers push witness
verify batches that the coalescer merges across workers into planes of
up to 256 proofs.

The port's copy of the JAX package's ``api/harness.py``:
:func:`serving_fixture` takes ``device`` (``None``: the card) for the
blocks' signing and import and for the server, and :func:`serving_thread`
serves a server over real sockets from an event loop of its own, for
callers without a loop (a node serves from its own).  The chain's size,
the traffic mix and the serving thread's timeout are module constants:
every caller runs them as they are.  The JAX package's
``scripts/slo_check.py`` and ``scripts/bench_api.py`` (the callers that
vary them there) are not ported.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading
import time

__all__ = [
    "serve_metric_snapshot",
    "serve_metric_deltas",
    "serving_fixture",
    "serving_thread",
    "run_mixed_traffic",
]

_GET_KINDS = ("state_root", "block_root", "block_v2", "witness")

# serving_fixture's chain: signed blocks on top of genesis, and validators
FIXTURE_BLOCKS = 4
FIXTURE_KEYS = 16
# seconds serving_thread waits for the loop to start and to stop the server
SERVE_THREAD_TIMEOUT_S = 30.0
# run_mixed_traffic's closed loop: GET workers, verify POST workers and the
# proofs in each POST (see its docstring for why one GET worker)
MIXED_GET_THREADS = 1
MIXED_POST_THREADS = 8
MIXED_PROOFS_PER_POST = 16


@contextlib.contextmanager
def serving_fixture(device=None):
    """A live minimal-spec chain behind a ``BeaconApiServer``: genesis of
    ``FIXTURE_KEYS`` validators + ``FIXTURE_BLOCKS`` signed blocks applied through the REAL fork-choice
    ``on_block`` path (so ``head_cache``, ``block_states`` and the
    incremental engines all carry what a synced node's store carries).
    The blocks are signed and imported, and the server hashes and
    verifies, on ``device`` (``None``: the card).  Yields ``(api, store,
    spec, head_root)`` inside the spec context."""
    from ..config import minimal_spec, use_chain_spec
    from ..crypto import bls
    from ..fork_choice import get_forkchoice_store, on_tick
    from ..fork_choice.handlers import on_block
    from ..state_transition.genesis import build_genesis_state
    from ..types.beacon import BeaconBlock, BeaconBlockBody
    from ..validator import build_signed_block
    from .beacon_api import BeaconApiServer

    sks = [(i + 1).to_bytes(32, "big") for i in range(FIXTURE_KEYS)]
    with use_chain_spec(minimal_spec()) as spec:
        genesis = build_genesis_state(
            [bls.sk_to_pk(sk) for sk in sks], spec=spec
        )
        anchor = BeaconBlock(
            slot=0,
            proposer_index=0,
            parent_root=b"\x00" * 32,
            state_root=genesis.hash_tree_root(spec),
            body=BeaconBlockBody(),
        )
        store = get_forkchoice_store(genesis, anchor, spec)
        cur = genesis
        head_root = anchor.hash_tree_root(spec)
        for slot in range(1, FIXTURE_BLOCKS + 1):
            signed, post = build_signed_block(cur, slot, sks, spec=spec, device=device)
            on_tick(
                store,
                int(store.genesis_time) + slot * int(spec.SECONDS_PER_SLOT),
                spec,
            )
            head_root = on_block(store, signed, spec=spec, device=device)
            cur = post
        api = BeaconApiServer(store=store, spec=spec, device=device)
        yield api, store, spec, head_root


@contextlib.contextmanager
def serving_thread(api):
    """Serve ``api`` (a ``BeaconApiServer``) over real sockets from an
    event loop running in a thread of its own; yields the base URL
    ``http://host:port``.  On exit the server closes, the loop's worker
    threads are joined and the loop stops, whatever raised inside."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="beacon-api", daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(api.start(), loop).result(SERVE_THREAD_TIMEOUT_S)
        yield f"http://{api.host}:{api.port}"
    finally:
        try:
            asyncio.run_coroutine_threadsafe(api.stop(), loop).result(SERVE_THREAD_TIMEOUT_S)
            asyncio.run_coroutine_threadsafe(
                loop.shutdown_default_executor(), loop).result(SERVE_THREAD_TIMEOUT_S)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(SERVE_THREAD_TIMEOUT_S)
            loop.close()


def _get_paths(head_root: bytes) -> list[str]:
    head_hex = "0x" + head_root.hex()
    return [
        "/eth/v1/beacon/states/head/root",
        "/eth/v1/beacon/blocks/head/root",
        "/eth/v2/beacon/blocks/head",
        f"/eth/v2/beacon/blocks/{head_hex}",
        "/eth/v0/witness/head?indices=balances:0,validators:3",
        "/eth/v0/witness/head?indices=balances:1,inactivity_scores:2",
        "/eth/v0/witness/head?indices=balances:0,validators:3&format=ssz",
        f"/eth/v1/beacon/states/{head_hex}/root",
    ]


def _verify_body(api) -> bytes:
    """One reusable verify POST body: ``MIXED_PROOFS_PER_POST`` hot-leaf-set
    proofs (cycled) anchored to the chain via ``state_id``."""
    status, _ctype, payload = api._route(
        "GET", "/eth/v0/witness/head?indices=balances:0,validators:3"
    )
    if not status.startswith("200"):
        raise RuntimeError(f"witness warmup answered {status}")
    proof_json = json.loads(payload)["data"]
    return json.dumps(
        {"state_id": "head", "proofs": [proof_json] * MIXED_PROOFS_PER_POST}
    ).encode()


def run_mixed_traffic(api, head_root: bytes, duration_s: float) -> dict:
    """Blocking closed-loop drive: ``MIXED_GET_THREADS`` workers hammer
    the GET mix, ``MIXED_POST_THREADS`` workers push verify batches of
    ``MIXED_PROOFS_PER_POST`` proofs the coalescer merges.  Returns
    request/verdict accounting; SLO quantiles and the ``serve_*``
    counters land in the process registry as on a live node.

    ONE GET worker: a second CPU-bound closed-loop
    Python thread collapses the pair's dispatch rate — the GIL convoy
    (every registry/cache lock handoff forces a thread switch), a
    property of CPython threading rather than the serving plane.  POST
    workers spend their loop parked in the coalescer, so they add
    concurrency (and fill buckets) without feeding the convoy."""
    get_paths = _get_paths(head_root)
    body = _verify_body(api)
    # warm every route once OUTSIDE the measured window: the first
    # verify dispatch pays plan-template/plane setup and the first GET
    # per key pays the encode — steady-state serving is what every
    # caller measures.
    # The serve_* counter deltas are snapshotted AFTER the warmup so the
    # warmup's solo deadline flush can't dilute the coalesced-batch mean
    for path in get_paths:
        api._route("GET", path)
    api._route("POST", "/eth/v0/witness/verify", body, "application/json")
    before = serve_metric_snapshot()
    stop_at = time.monotonic() + float(duration_s)
    lock = threading.Lock()
    totals = {
        "get_requests": 0,
        "post_requests": 0,
        "post_proofs": 0,
        "non_200": [],        # bounded SAMPLE for the report
        "non_200_count": 0,   # the true failure count
        "invalid_verdicts": 0,
    }

    def get_worker(worker: int) -> None:
        done = 0
        bad = []
        paths = get_paths[worker % len(get_paths):] + get_paths[: worker % len(get_paths)]
        rounds = 0
        while time.monotonic() < stop_at:
            for path in paths:
                status, _ctype, _payload = api._route("GET", path)
                if not status.startswith("200"):
                    bad.append((path, status))
                done += 1
            rounds += 1
            if rounds % 8 == 0:
                # an explicit GIL yield every ~64 requests: a socket
                # server yields on every read/write, and without this
                # the pure-Python closed loop starves the verify flush
                # threads (a coalesced dispatch stretched past the
                # witness_verify_p95 budget) — an artifact of the
                # generator, not of the serving plane being measured.
                # Every 8th round keeps the handoff cost off the
                # throughput number while verify threads still get a
                # slice every few ms
                time.sleep(0)
        with lock:
            totals["get_requests"] += done
            totals["non_200_count"] += len(bad)
            totals["non_200"].extend(bad[:8])

    def post_worker() -> None:
        done = 0
        proofs = 0
        bad = []
        invalid = 0
        while time.monotonic() < stop_at:
            status, _ctype, payload = api._route(
                "POST", "/eth/v0/witness/verify", body, "application/json"
            )
            if not status.startswith("200"):
                bad.append(("/eth/v0/witness/verify", status))
            else:
                data = json.loads(payload)["data"]
                proofs += data["batch"]
                if not data["valid"]:
                    invalid += 1
            done += 1
        with lock:
            totals["post_requests"] += done
            totals["post_proofs"] += proofs
            totals["non_200_count"] += len(bad)
            totals["non_200"].extend(bad[:8])
            totals["invalid_verdicts"] += invalid

    threads = [
        threading.Thread(target=get_worker, args=(i,), daemon=True)
        for i in range(MIXED_GET_THREADS)
    ] + [
        threading.Thread(target=post_worker, daemon=True)
        for _ in range(MIXED_POST_THREADS)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = max(time.monotonic() - t0, 1e-9)
    requests = totals["get_requests"] + totals["post_requests"]
    deltas = serve_metric_deltas(before, serve_metric_snapshot())
    return {
        **deltas,
        "requests": requests,
        "req_per_sec": requests / elapsed,
        "duration_s": elapsed,
        "get_requests": totals["get_requests"],
        "post_requests": totals["post_requests"],
        "post_proofs": totals["post_proofs"],
        "invalid_verdicts": totals["invalid_verdicts"],
        "non_200": totals["non_200"][:16],
        "non_200_count": totals["non_200_count"],
        "get_threads": MIXED_GET_THREADS,
        "post_threads": MIXED_POST_THREADS,
        "proofs_per_post": MIXED_PROOFS_PER_POST,
    }


def serve_metric_snapshot() -> dict:
    """The serving counters (hit/miss per layer, coalescer
    flush/proof totals) as one flat dict — callers subtract two
    snapshots (:func:`serve_metric_deltas`) so a shared process registry
    never double-counts earlier phases."""
    from ..telemetry import get_metrics

    m = get_metrics()
    out = {"cache_hits": 0.0, "cache_misses": 0.0}
    for kind in _GET_KINDS:
        out["cache_hits"] += m.get(
            "serve_cache_hit_total", cache="response", kind=kind
        )
        out["cache_misses"] += m.get(
            "serve_cache_miss_total", cache="response", kind=kind
        )
    out["proof_hits"] = m.get(
        "serve_cache_hit_total", cache="witness_proof", kind="proof"
    )
    out["coalesce_flushes"] = m.get(
        "serve_coalesce_flush_total", trigger="target"
    ) + m.get("serve_coalesce_flush_total", trigger="deadline")
    out["coalesce_proofs"] = m.get("serve_coalesce_proofs_total")
    out["coalesce_requests"] = m.get("serve_coalesce_requests_total")
    return out


def serve_metric_deltas(before: dict, after: dict) -> dict:
    """Per-phase serving stats from two snapshots: hit ratio over the
    phase's own traffic plus the mean coalesced batch size."""
    d = {k: after[k] - before[k] for k in before}
    lookups = d["cache_hits"] + d["cache_misses"]
    d["cache_hit_ratio"] = d["cache_hits"] / lookups if lookups else None
    d["coalesce_mean_batch"] = (
        d["coalesce_proofs"] / d["coalesce_flushes"]
        if d["coalesce_flushes"]
        else None
    )
    return d
