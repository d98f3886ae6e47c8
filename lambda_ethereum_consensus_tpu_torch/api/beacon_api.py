"""Beacon API: the JSON routes the reference serves via Phoenix
(ref: lib/beacon_api/router.ex:9-28 and the v1/v2 beacon controllers):

- ``GET /eth/v1/beacon/states/{state_id}/root``
- ``GET /eth/v1/beacon/blocks/{block_id}/root``
- ``GET /eth/v2/beacon/blocks/{block_id}``
- plus ``/eth/v1/node/health``, ``/eth/v1/node/identity`` and ``/metrics``

The stateless-witness surface (this client's addition):

- ``GET /eth/v0/witness/{state_id}?indices=balances:0,validators:3``
  serves a deduplicated binary-Merkle multiproof for arbitrary element
  indices into the big BeaconState lists, generated from the incremental
  root engine's retained levels (``&format=ssz`` for the compact binary
  encoding, JSON default);
- ``POST /eth/v0/witness/verify`` checks proofs (JSON body — a single
  proof object or ``{"proofs": [...]}`` — or one binary proof as
  ``application/octet-stream``) through the batched verification plane;
  ``state_id`` in the JSON body anchors the expected root to the chain
  instead of trusting the proof's own claim.

Both witness routes dispatch off the event loop like every other heavy
route and record ``witness_request_seconds{route=...}``.

Implemented as a dependency-free asyncio HTTP/1.1 server; the reference's
v1 state-root route is mostly hardcoded TODOs (v1/beacon_controller.ex:7-60)
— here every route answers from live chain data.

The ``/debug/*`` surface (this client's addition — the flight-recorder
debug contract):

- ``GET /debug/trace`` — the flight recorder's ring as Chrome/Perfetto
  trace-event JSON (load it in https://ui.perfetto.dev or
  ``chrome://tracing``; ``scripts/trace_dump.py`` fetches and saves it);
- ``GET /debug/lanes`` — live ingest scheduler/lane snapshot (depths,
  deficits, oldest waits, degraded latch);
- ``GET /debug/slot`` — current slot-phase summary (slot, offset,
  sub-interval, store/head slots) from the node's slot clock;
- ``GET /debug/slo`` — one SLO-engine evaluation (observed quantiles vs
  budgets, multi-window burn rates) as JSON;
- ``GET /debug/forkchoice``, ``/debug/reorgs``, ``/debug/finality`` — the
  store's consensus forensics plane; ``/debug/peers`` and
  ``/debug/fleet`` — the owning node's gossip stats and an attached fleet
  observatory.

Every matched route records its handler latency into the
``api_request_seconds{route=...}`` histogram (the family the
``api_request_p99`` SLO budgets), labeled with the route pattern's
readable form (``/eth/v1/beacon/states/{id}/root``) so cardinality is
bounded by the route table, not by request paths.

The port's copy of the JAX package's ``api/beacon_api.py``.  What differs:

- **The device.** ``BeaconApiServer(device=...)`` (``None``: the card,
  ``"cpu"``: the plain PyTorch versions) builds one
  :class:`~..ops.sha256.DeviceHashBackend` on that device.  State roots
  and every witness planner's engine hash on it, and the verify
  coalescer's planes run on it.  A device error raises out of the
  handler and answers 500; nothing retries it on the host.
- **Constants, not environment variables.** The response cache holds
  :data:`SERVE_CACHE_ENTRIES` answers and :data:`SERVE_CACHE_BYTES` bytes
  (the JAX package's ``SERVE_CACHE_ENTRIES`` / ``SERVE_CACHE_MB``
  defaults).  The response cache and the verify coalescer are always on:
  ``SERVE_NO_CACHE`` and ``WITNESS_NO_COALESCE`` have no port caller.
- **The compile and profile routes** read the port's own observatory
  (``ops/profile.py``, ``ops/_build.py``).  ``GET /debug/compile`` lists one
  executable row per ``(kernel, width)`` launched, with its launches and cost
  columns, and the build table under ``stats["builds"]``; the port keeps no
  shape buckets, so ``warmed_buckets`` holds the two founding families,
  empty.  ``GET /debug/profile`` is ``profile_report()``; ``POST
  /debug/profile/capture`` runs one ``torch.profiler`` window on the worker
  thread.
- ``/debug/slo`` carries no ``device_health`` block: the port keeps no
  device-fault latch, because a device fault raises.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time
from typing import Callable

from ..config import ChainSpec
from ..fork_choice import Store, get_head
from ..ops.sha256 import DeviceHashBackend, resolve_device
from ..serve_cache import ServeCache
from ..telemetry import get_metrics, scrape_stats_lines
from ..tracing import SlotClock, get_recorder

__all__ = ["SERVE_CACHE_BYTES", "SERVE_CACHE_ENTRIES", "BeaconApiServer"]

log = logging.getLogger("beacon_api")

#: Most answers the response cache holds.
SERVE_CACHE_ENTRIES = 2048
#: Most payload bytes the response cache holds (64 MiB).
SERVE_CACHE_BYTES = 64 << 20


class BeaconApiServer:
    def __init__(
        self,
        store: Store,
        spec: ChainSpec,
        metrics=None,
        node_id: bytes | None = None,
        port: int = 0,
        host: str = "127.0.0.1",
        node=None,
        device=None,
    ):
        self.store = store
        self.spec = spec
        self.metrics = metrics
        self.node_id = node_id
        self.host = host
        self.port = port
        # where the state roots, the witness engines and the verify planes
        # hash: None is the card, and raises where there is none
        self.device = resolve_device(device)
        self._backend = DeviceHashBackend(self.device)
        # the owning BeaconNode (optional): /debug/lanes reads its live
        # ingest scheduler, /debug/slot prefers its slot clock
        self.node = node
        self._server: asyncio.AbstractServer | None = None
        self._inline_paths = frozenset(p for p, _ in self._inline_routes())
        # route pattern -> bounded-cardinality label for api_request_seconds
        # ("/eth/v1/beacon/states/([^/]+)/root" -> ".../{id}/root")
        self._route_labels = {
            pattern: pattern.replace("([^/]+)", "{id}")
            for pattern, _ in self._routes() + self._post_routes()
        }
        # routes whose handler takes the raw query string as its last arg
        self._query_patterns = frozenset(
            p for p, _ in self._routes()
            if "witness" in p or p == r"/debug/trace"
        )
        # fleet observatory: a fleet harness attaches one so
        # this server also answers /debug/fleet with the merged view
        self.observatory = None
        # per-state multiproof planners (lambda_ethereum_consensus_tpu.
        # witness), created lazily on the first witness request
        self._witness = None
        # the response cache holds fully encoded answers for the hot GET
        # routes keyed by RESOLVED root (+ route discriminators); the
        # head-transition observer evicts the stale head's entries on a
        # reorg (see serve_cache.py module doc)
        self._serve_cache = ServeCache(
            "response", capacity=SERVE_CACHE_ENTRIES, max_bytes=SERVE_CACHE_BYTES
        )
        # cross-request verify coalescer (witness/coalesce.py), created
        # lazily with the witness subsystem
        self._coalescer = None

    # Routes answered ON the event loop (derived from _inline_routes in
    # __init__ — the patterns are literal paths): trivially cheap, and
    # the lane snapshot RELIES on loop serialization against the ingest
    # drain (scheduler.snapshot reads live lane state with no locking).
    # Every other route runs in a worker thread (see _handle): a state
    # root is seconds of Merkleization, /debug/states streams a full SSZ
    # encode, "head" resolution can walk the whole LMD-GHOST tree, and
    # /metrics + /debug/trace expand lock-protected snapshot structures —
    # none of that can share the loop that runs gossip verdicts and
    # ms-scale flush deadlines.  Offloaded
    # handlers touch the store concurrently with the loop; reads are
    # GIL-atomic point lookups, and _route contains any mid-mutation
    # surprise as a retryable 500.

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------ plumbing

    # bound on POST bodies (witness verify batches): past this the route
    # answers 413 instead of buffering an unbounded upload on the loop
    _MAX_BODY = 4 << 20

    async def _handle(self, reader, writer) -> None:
        try:
            request_line = await asyncio.wait_for(reader.readline(), 10)
            parts = request_line.decode("latin1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            content_length = 0
            content_type = ""
            while True:  # drain headers, keeping the two the body needs
                line = await asyncio.wait_for(reader.readline(), 10)
                if line in (b"\r\n", b"\n", b""):
                    break
                key, _, value = line.decode("latin1").partition(":")
                key = key.strip().lower()
                if key == "content-length":
                    try:
                        content_length = int(value.strip())
                    except ValueError:
                        content_length = 0
                elif key == "content-type":
                    content_type = value.strip()
            body = b""
            if method == "POST" and content_length > 0:
                if content_length > self._MAX_BODY:
                    status, ctype, payload = self._error(413, "body too large")
                    writer.write(
                        (
                            f"HTTP/1.1 {status}\r\n"
                            f"Content-Type: {ctype}\r\n"
                            f"Content-Length: {len(payload)}\r\n"
                            "Connection: close\r\n\r\n"
                        ).encode()
                        + payload
                    )
                    await writer.drain()
                    return
                body = await asyncio.wait_for(
                    reader.readexactly(content_length), 10
                )
            if method == "GET" and path.split("?", 1)[0] in self._inline_paths:
                status, ctype, payload = self._route_inline(method, path)
            else:
                status, ctype, payload = (
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._route, method, path, body, content_type
                    )
                )
            head = (
                f"HTTP/1.1 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                "Connection: close\r\n\r\n"
            )
            writer.write(head.encode() + payload)
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError, OSError):
            pass
        finally:
            writer.close()

    def _route(
        self, method: str, path: str, body: bytes = b"", ctype: str = ""
    ) -> tuple[str, str, bytes]:
        """Worker-thread dispatch over the FULL route table."""
        path, _, query = path.partition("?")
        if method == "POST":
            for pattern, handler in self._post_routes():
                m = re.fullmatch(pattern, path)
                if m:
                    t0 = time.perf_counter()
                    try:
                        return handler(body, ctype, *m.groups())
                    except KeyError:
                        return self._error(404, "not found")
                    except ValueError as e:
                        return self._error(400, str(e))
                    except Exception:
                        log.exception("beacon api handler failed on %s", path)
                        return self._error(500, "internal error")
                    finally:
                        get_metrics().observe(
                            "api_request_seconds",
                            time.perf_counter() - t0,
                            route=self._route_labels[pattern],
                        )
            return self._error(404, "unknown route")
        if method != "GET":
            return self._error(405, "method not allowed")
        for pattern, handler in self._routes():
            m = re.fullmatch(pattern, path)
            if m:
                # witness routes take the raw query string as a trailing
                # argument (index list + format live there)
                extra = (query,) if pattern in self._query_patterns else ()
                t0 = time.perf_counter()
                try:
                    return handler(*m.groups(), *extra)
                except KeyError:
                    return self._error(404, "not found")
                except ValueError as e:
                    return self._error(400, str(e))
                except Exception:
                    # offloaded handlers read live store structures from a
                    # worker thread; a mid-mutation surprise (dict resized
                    # during iteration) must answer 500, not kill the
                    # connection task silently
                    log.exception("beacon api handler failed on %s", path)
                    return self._error(500, "internal error")
                finally:
                    # handler latency (error answers included) into the
                    # family the api_request_p99 SLO budgets
                    get_metrics().observe(
                        "api_request_seconds",
                        time.perf_counter() - t0,
                        route=self._route_labels[pattern],
                    )
        return self._error(404, "unknown route")

    def _route_inline(self, method: str, path: str) -> tuple[str, str, bytes]:
        """Event-loop dispatch: ONLY the cheap, loop-serialized handlers
        in _inline_routes may be reachable from here."""
        if method != "GET":
            return self._error(405, "method not allowed")
        path = path.split("?", 1)[0]
        for pattern, handler in self._inline_routes():
            m = re.fullmatch(pattern, path)
            if m:
                t0 = time.perf_counter()
                try:
                    return handler(*m.groups())
                except KeyError:
                    return self._error(404, "not found")
                except ValueError as e:
                    return self._error(400, str(e))
                finally:
                    # one lock + bisect — cheap enough for the loop-
                    # serialized inline handlers it times
                    get_metrics().observe(
                        "api_request_seconds",
                        time.perf_counter() - t0,
                        route=self._route_labels[pattern],
                    )
        return self._error(404, "unknown route")

    def _routes(self) -> list[tuple[str, Callable]]:
        return [
            (r"/eth/v1/beacon/states/([^/]+)/root", self._state_root),
            (r"/eth/v1/beacon/blocks/([^/]+)/root", self._block_root),
            (r"/eth/v2/beacon/blocks/([^/]+)", self._block_v2),
            # SSZ state download — what checkpoint sync fetches
            # (ref: checkpoint_sync.ex:14 GET /eth/v2/debug/beacon/states/...)
            (r"/eth/v2/debug/beacon/states/([^/]+)", self._debug_state),
            # stateless witness plane: multiproofs for
            # arbitrary indices into the big BeaconState lists
            (r"/eth/v0/witness/([^/]+)", self._witness_proof),
            (r"/metrics", self._metrics),
            (r"/debug/trace", self._debug_trace),
            (r"/debug/compile", self._debug_compile),
            (r"/debug/profile", self._debug_profile),
            (r"/debug/slo", self._debug_slo),
            # consensus forensics plane — offloaded: the DAG
            # snapshot walks the head-cache tree and the ring copies,
            # none of which belongs on the event loop
            (r"/debug/forkchoice", self._debug_forkchoice),
            (r"/debug/reorgs", self._debug_reorgs),
            (r"/debug/finality", self._debug_finality),
        ] + self._inline_routes()

    def _post_routes(self) -> list[tuple[str, Callable]]:
        """POST routes (worker-thread only; handlers take (body, ctype,
        *groups))."""
        return [
            (r"/eth/v0/witness/verify", self._witness_verify),
            (r"/debug/profile/capture", self._debug_profile_capture),
        ]

    def _inline_routes(self) -> list[tuple[str, Callable]]:
        """Handlers cheap enough for the event loop (see _inline_paths)."""
        return [
            (r"/eth/v1/node/health", self._health),
            (r"/eth/v1/node/identity", self._identity),
            (r"/debug/lanes", self._debug_lanes),
            (r"/debug/slot", self._debug_slot),
            (r"/debug/peers", self._debug_peers),
            (r"/debug/fleet", self._debug_fleet),
        ]

    @staticmethod
    def _json(payload, status: str = "200 OK") -> tuple[str, str, bytes]:
        return status, "application/json", json.dumps(payload).encode()

    @staticmethod
    def _error(code: int, message: str) -> tuple[str, str, bytes]:
        reasons = {
            400: "Bad Request",
            404: "Not Found",
            405: "Method Not Allowed",
            413: "Payload Too Large",
        }
        return (
            f"{code} {reasons.get(code, 'Error')}",
            "application/json",
            json.dumps({"code": code, "message": message}).encode(),
        )

    # ------------------------------------------------------------- resolvers

    def _resolve_block_root(self, block_id: str) -> bytes:
        if block_id == "head":
            # get_head is memoized on (store.mutations, slot): GET-rate
            # resolution is an O(1) memo hit between store mutations,
            # WITH proposer boost and the viable-branch filter applied —
            # the streamed HeadCache deliberately omits both (its class
            # contract scopes it to telemetry/logging), so serving from
            # it could answer a different head than the node attests on
            return get_head(self.store, self.spec)
        if block_id == "finalized":
            return bytes(self.store.finalized_checkpoint.root)
        if block_id == "justified":
            return bytes(self.store.justified_checkpoint.root)
        if block_id == "genesis":
            block_id = "0"
        if block_id.startswith("0x"):
            root = bytes.fromhex(block_id[2:])
            if root not in self.store.blocks:
                raise KeyError(block_id)
            return root
        if block_id.isdigit():
            slot = int(block_id)
            for root, block in self.store.blocks.items():
                if block.slot == slot:
                    return root
            raise KeyError(block_id)
        raise ValueError(f"invalid block id {block_id!r}")

    # ------------------------------------------------------- serving cache

    def _cached_answer(self, kind: str, root: bytes, extra, build):
        """The response-cache read path for one resolved root: a hit is
        a memcpy of the stored ``(status, ctype, payload)`` triple —
        no re-resolve, no re-encode; a miss runs ``build()`` once and
        retains it tagged with the block's epoch (the eviction
        discipline's age axis) and the resolved root (the invalidation
        axis the head-transition observer evicts by)."""
        cache = self._serve_cache
        key = (kind, root, extra)
        hit = cache.get(key, kind=kind)
        if hit is not None:
            return hit
        answer = build()
        block = self.store.blocks.get(root) if self.store is not None else None
        epoch = (
            int(block.slot) // int(self.spec.SLOTS_PER_EPOCH)
            if block is not None and self.spec is not None
            else 0
        )
        return cache.put(
            key, answer, root=root, epoch=epoch, nbytes=len(answer[2])
        )

    def on_head_transition(self, old_head: bytes | None, new_head: bytes) -> None:
        """Round-9 observer hook (node._observe_head_transition): the
        moment the cached fork-choice head flips, evict the STALE head's
        cached encodings from the response cache and the witness
        service's proof cache — an attestation-weight reorg must never
        leave a dead branch's answers pinned, and the next GET for an
        alias must rebuild fresh under the new resolved root."""
        if old_head is None or old_head == new_head:
            return
        self._serve_cache.invalidate_root(old_head, reason="head_transition")
        witness = self._witness
        if witness is not None:
            witness.invalidate_root(old_head, reason="head_transition")

    # --------------------------------------------------------------- routes

    def _state_root(self, state_id: str) -> tuple[str, str, bytes]:
        root = self._resolve_block_root(state_id)

        def build():
            state = self.store.block_states[root]
            return self._json(
                {"data": {"root": "0x" + state.hash_tree_root(
                    self.spec, backend=self._backend).hex()}}
            )

        return self._cached_answer("state_root", root, None, build)

    def _block_root(self, block_id: str) -> tuple[str, str, bytes]:
        root = self._resolve_block_root(block_id)
        return self._cached_answer(
            "block_root",
            root,
            None,
            lambda: self._json({"data": {"root": "0x" + root.hex()}}),
        )

    def _block_v2(self, block_id: str) -> tuple[str, str, bytes]:
        root = self._resolve_block_root(block_id)
        # the ``finalized`` bit depends on the finalized checkpoint, so
        # the cache key carries it: finality advancing re-keys the entry
        # instead of serving a stale bit
        return self._cached_answer(
            "block_v2",
            root,
            bytes(self.store.finalized_checkpoint.root),
            lambda: self._block_v2_build(root),
        )

    def _block_v2_build(self, root: bytes) -> tuple[str, str, bytes]:
        block = self.store.blocks[root]
        return self._json(
            {
                "version": self.spec.fork_at_epoch(
                    block.slot // self.spec.SLOTS_PER_EPOCH
                ),
                "execution_optimistic": False,
                # finalized = ancestor of the finalized checkpoint, not just
                # an old slot (fork blocks below the boundary are NOT final)
                "finalized": self.store.get_ancestor(
                    bytes(self.store.finalized_checkpoint.root), block.slot
                )
                == root,
                "data": {
                    "message": {
                        "slot": str(block.slot),
                        "proposer_index": str(block.proposer_index),
                        "parent_root": "0x" + bytes(block.parent_root).hex(),
                        "state_root": "0x" + bytes(block.state_root).hex(),
                        "body_root": "0x" + block.body.hash_tree_root(self.spec).hex(),
                    }
                },
            }
        )

    def _debug_state(self, state_id: str) -> tuple[str, str, bytes]:
        root = self._resolve_block_root(state_id)
        state = self.store.block_states[root]
        return "200 OK", "application/octet-stream", state.encode(self.spec)

    # ------------------------------------------------------ witness plane

    def _witness_service(self):
        """Lazy per-server witness service (bounded per-state planners,
        each engine hashing on the server's device backend); created on
        first use."""
        if self._witness is None:
            from ..witness.service import WitnessService

            self._witness = WitnessService(backend=self._backend)
        return self._witness

    def _verify_coalescer(self):
        """Lazy per-server verify coalescer."""
        if self._coalescer is None:
            from ..witness.coalesce import VerifyCoalescer

            self._coalescer = VerifyCoalescer()
        return self._coalescer

    def _witness_proof(self, state_id: str, query: str = "") -> tuple[str, str, bytes]:
        """``GET /eth/v0/witness/{state_id}?indices=field:idx,...`` —
        a deduplicated binary-Merkle multiproof for arbitrary element
        indices into the big BeaconState lists, served from the
        incremental engine's retained levels.  ``format=ssz`` selects the
        compact binary encoding (JSON default)."""
        t0 = time.perf_counter()
        params = dict(
            kv.split("=", 1) for kv in query.split("&") if "=" in kv
        )
        requests = []
        for item in params.get("indices", "").split(","):
            item = item.strip()
            if not item:
                continue
            field, _, idx = item.partition(":")
            if not idx or not idx.lstrip("-").isdigit():
                raise ValueError(
                    f"bad index spec {item!r} (want field:element_index)"
                )
            requests.append((field, int(idx)))
        if not requests:
            raise ValueError("indices query parameter is required")
        fmt = params.get("format", "json")
        if fmt not in ("json", "ssz"):
            raise ValueError(f"unknown format {fmt!r} (json|ssz)")
        root = self._resolve_block_root(state_id)

        def build():
            state = self.store.block_states[root]
            proof = self._witness_service().prove(
                root, state, requests, self.spec
            )
            if fmt == "ssz":
                return "200 OK", "application/octet-stream", proof.encode()
            return self._json({"data": proof.to_json()})

        answer = self._cached_answer(
            "witness", root, (tuple(requests), fmt), build
        )
        m = get_metrics()
        m.observe(
            "witness_request_seconds", time.perf_counter() - t0, route="proof"
        )
        m.inc("witness_proof_bytes_total", len(answer[2]))
        return answer

    def _witness_verify(self, body: bytes, ctype: str) -> tuple[str, str, bytes]:
        """``POST /eth/v0/witness/verify`` — batched proof verification.
        JSON body: one proof object or ``{"proofs": [...], "state_id":
        optional}``; ``application/octet-stream``: one binary-encoded
        proof.  With ``state_id`` the expected root is anchored to the
        chain's block header (the trustworthy direction); without it the
        check is purely cryptographic against each proof's claimed root."""
        from ..witness.multiproof import WitnessProof

        t0 = time.perf_counter()
        state_id = None
        if ctype.split(";", 1)[0].strip() == "application/octet-stream":
            proofs = [WitnessProof.decode(body)]
        else:
            try:
                obj = json.loads(body.decode() or "{}")
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"malformed JSON body: {e}") from None
            if not isinstance(obj, dict):
                raise ValueError("body must be a JSON object")
            state_id = obj.get("state_id")
            raw = obj.get("proofs", obj if "leaves" in obj else None)
            if raw is None:
                raise ValueError("body carries neither 'proofs' nor a proof")
            if isinstance(raw, dict):
                raw = [raw]
            proofs = [WitnessProof.from_json(p) for p in raw]
        if state_id is not None:
            if self.store is None:
                raise ValueError("state_id anchoring needs a chain store")
            root = self._resolve_block_root(str(state_id))
            expected = [bytes(self.store.blocks[root].state_root)] * len(proofs)
            anchored = True
        else:
            expected = [p.state_root for p in proofs]
            anchored = False
        # cross-request coalescing: park with every other in-flight
        # verify so one plane fills from DIFFERENT requests before one
        # device dispatch; this request's verdicts come back demuxed, and
        # a lone request flushes at its deadline budget (witness/coalesce.py)
        results = self._verify_coalescer().verify(proofs, expected, device=self.device)
        get_metrics().observe(
            "witness_request_seconds", time.perf_counter() - t0, route="verify"
        )
        return self._json({
            "data": {
                "valid": all(results),
                "results": results,
                "batch": len(results),
                "anchored": anchored,
            }
        })

    def _health(self) -> tuple[str, str, bytes]:
        return "200 OK", "application/json", b"{}"

    def _identity(self) -> tuple[str, str, bytes]:
        return self._json(
            {
                "data": {
                    "peer_id": (self.node_id or b"").hex(),
                    "enr": "",
                    "p2p_addresses": [],
                }
            }
        )

    def _metrics(self) -> tuple[str, str, bytes]:
        """Prometheus exposition (text format 0.0.4: HELP/TYPE headers +
        histogram series from the registry renderer).

        Merges the node's own registry (node-identity gauges — peer
        count, sync slot — kept per node so co-resident nodes don't
        clobber each other) with the process-wide default registry the
        hot paths below the node runtime record spans into.  The merge
        is family-aware: any family already in the node registry is
        skipped from the default render, so a name recorded into both
        (e.g. by a bench script using the module-level helpers) can
        never emit a duplicate TYPE header — which would fail the whole
        scrape target, not just the colliding family.  Both renders run
        with ``self_scrape=False`` and ONE combined
        ``telemetry_scrape_seconds``/``telemetry_series_count`` block is
        appended (per-render stats would duplicate those TYPE headers
        too)."""
        default = get_metrics()
        if self.metrics is None or self.metrics is default:
            return "200 OK", "text/plain; version=0.0.4", default.render_prometheus().encode()
        t0 = time.perf_counter()
        own = self.metrics.render_prometheus(self_scrape=False).rstrip("\n")
        rest = default.render_prometheus(
            skip=self.metrics.family_names(), self_scrape=False
        ).rstrip("\n")
        parts = [p for p in (own, rest) if p]
        if self.metrics.enabled or default.enabled:
            series = sum(
                1
                for p in parts
                for l in p.splitlines()
                if not l.startswith("#")
            )
            parts.extend(scrape_stats_lines(time.perf_counter() - t0, series))
        body = ("\n".join(parts) + "\n").encode() if parts else b"\n"
        return "200 OK", "text/plain; version=0.0.4", body

    # --------------------------------------------------------- debug routes

    def _debug_trace(self, query: str = "") -> tuple[str, str, bytes]:
        """The flight recorder's ring as Chrome/Perfetto trace JSON.
        ``?node=<label>`` filters to one node's process row — the
        per-member slice the fleet aggregator scrapes before merging
        (in-process fleets share ONE ring)."""
        node = None
        for part in query.split("&"):
            if part.startswith("node="):
                node = part[len("node="):] or None
        return (
            "200 OK",
            "application/json",
            json.dumps(get_recorder().chrome(node=node)).encode(),
        )

    def _debug_peers(self) -> tuple[str, str, bytes]:
        """Per-peer gossip health: the node's last sidecar stats
        snapshot (delivery first/duplicate counts, peer scores, mesh
        membership, control-frame counters) plus its age.  404 without
        an owning node; ``{}`` data before the first poll lands."""
        node = self.node
        if node is None:
            return self._error(404, "no owning node")
        stats = getattr(node, "_gossip_stats", {}) or {}
        ts = getattr(node, "_gossip_stats_ts", 0.0)
        return self._json({"data": {
            "stats": stats,
            "age_s": round(time.time() - ts, 3) if ts else None,
        }})

    def _debug_fleet(self) -> tuple[str, str, bytes]:
        """The merged fleet view: per-member head/slot/SLO
        status, the propagation matrix and fleet-level SLO rows — only
        on the member (or standalone server) a FleetObservatory was
        attached to; 404 elsewhere."""
        if self.observatory is None:
            return self._error(404, "no fleet observatory attached")
        return self._json({"data": self.observatory.fleet_view()})

    def _debug_compile(self) -> tuple[str, str, bytes]:
        """The kernel attribution table: one row per ``(kernel, width)``
        launched, with its launches, the operations and bytes of one launch
        and the kernel's roofline ratio, plus the build table of the
        libraries this process built or reused.  Offloaded route: the table
        snapshot copies under ``ops/profile._LOCK``."""
        from ..ops import _build
        from ..ops import profile as ops_profile

        rows = ops_profile.cost_table()
        roofline = {e["entry"]: e["roofline_ratio"] for e in ops_profile.entry_report()}
        for row in rows:
            row["roofline_ratio"] = roofline.get(row["entry"])
        builds = _build.build_table()
        return self._json({
            "data": {
                "stats": {
                    "launches": sum(r["launches"] for r in rows),
                    "built": sum(b["source"] == "built" for b in builds),
                    "reused": sum(b["source"] == "reused" for b in builds),
                    "builds": builds,
                },
                # the two founding families stay present, empty: the port
                # keeps no shape buckets
                "warmed_buckets": {"attestation_entries": [], "witness_verify": []},
                "executables": rows,
            }
        })

    def _debug_profile(self) -> tuple[str, str, bytes]:
        """The device cost and memory observatory: kernels ranked by
        roofline headroom, per-plane device-memory accounting with the
        unattributed remainder and high watermark, the peaks and the
        capture budget and state."""
        from ..ops import profile as ops_profile

        return self._json({"data": ops_profile.profile_report()})

    def _debug_profile_capture(
        self, body: bytes, ctype: str
    ) -> tuple[str, str, bytes]:
        """``POST /debug/profile/capture`` — one budgeted ``torch.profiler``
        window (body: ``{"seconds": s}``, with an optional ``"dir"``).  Runs
        on the worker thread (the capture sleeps for the whole window); an
        over-budget request is refused before tracing and answers 400."""
        from ..ops import profile as ops_profile

        try:
            obj = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"malformed JSON body: {e}") from None
        if not isinstance(obj, dict):
            raise ValueError("body must be a JSON object")
        if "seconds" not in obj:
            raise ValueError("body must carry 'seconds'")
        try:
            seconds = float(obj["seconds"])
        except (TypeError, ValueError):
            raise ValueError("'seconds' must be a number") from None
        out_dir = obj.get("dir")
        if out_dir is not None and not isinstance(out_dir, str):
            raise ValueError("'dir' must be a string path")
        report = ops_profile.capture_trace(seconds, out_dir=out_dir)
        return self._json({"data": report})

    def _debug_slo(self) -> tuple[str, str, bytes]:
        """One READ-ONLY evaluation of the process-wide SLO engine.  The
        engine is shared with the node tick loop, so the burn-rate
        windows served here carry the tick history; a node-less process
        still gets the cumulative quantiles.  emit/snapshot are off so a
        polling client can neither inflate the evaluation/violation
        counters nor shorten the snapshot deque's window."""
        from ..slo import get_engine

        return self._json({"data": get_engine().evaluate(emit=False, snapshot=False)})

    def _forensics(self):
        """The owning store's forensics plane, or None — attached by the
        node at start(); hand-built stores and standalone servers answer
        404 from the three routes below."""
        return getattr(self.store, "forensics", None)

    def _debug_forkchoice(self) -> tuple[str, str, bytes]:
        """Weighted fork-DAG snapshot: every block in the
        O(1) head-cache tree with its cached subtree weight, the memoized
        head (``head_candidates`` — NEVER forces an uncached LMD-GHOST
        recompute), and the last cold-walk decision audit."""
        forensics = self._forensics()
        if forensics is None or self.store is None:
            return self._error(404, "no forensics plane attached")
        return self._json(
            {"data": forensics.forkchoice_view(self.store, self.spec)}
        )

    def _debug_reorgs(self) -> tuple[str, str, bytes]:
        """Reorg post-mortems + the equivocation-evidence ledger: every
        head transition's ReorgRecord (depth, common ancestor, orphaned
        roots, weight-swing attribution) and the deduplicated
        double-proposal/double-vote/slashing evidence."""
        forensics = self._forensics()
        if forensics is None:
            return self._error(404, "no forensics plane attached")
        return self._json({"data": {
            "reorgs": forensics.reorgs(),
            "reorg_count": forensics.reorg_count(),
            "evidence": forensics.evidence(),
            "stats": forensics.stats(),
        }})

    def _debug_finality(self) -> tuple[str, str, bytes]:
        """Finality-lag decomposition: the latest per-epoch sample
        (lag, participation by flag, missing votes by subnet) plus the
        justification/finalization advance history."""
        forensics = self._forensics()
        if forensics is None:
            return self._error(404, "no forensics plane attached")
        return self._json({"data": forensics.finality_view()})

    def _debug_lanes(self) -> tuple[str, str, bytes]:
        """Live ingest scheduler snapshot (404 when the node runs the
        standalone per-topic drains or no node is attached)."""
        ingest = getattr(self.node, "ingest", None)
        if ingest is None:
            return self._error(404, "no ingest scheduler attached")
        snap = ingest.snapshot()
        snap["recorder"] = get_recorder().stats()
        return self._json({"data": snap})

    def _debug_slot(self) -> tuple[str, str, bytes]:
        """Current slot-phase summary from the node's slot clock (built
        from the store's genesis when no node is attached)."""
        clock = getattr(self.node, "slot_clock", None)
        if clock is None:
            if self.store is None or self.spec is None:
                return self._error(404, "no slot clock available")
            clock = SlotClock(
                int(self.store.genesis_time), int(self.spec.SECONDS_PER_SLOT)
            )
        phase = clock.phase(time.time())
        if self.store is not None:
            phase["store_slot"] = int(self.store.current_slot(self.spec))
            cache = getattr(self.store, "head_cache", None)
            if cache is not None:
                head = cache.head()
                head_block = self.store.blocks.get(head)
                if head_block is not None:
                    phase["head_slot"] = int(head_block.slot)
                    phase["head_root"] = "0x" + head.hex()
        return self._json({"data": phase})
