"""Witness serving state: bounded per-state multiproof planners.

A beacon API serves witnesses for a handful of recent states (head,
justified, finalized); each :class:`~.multiproof.WitnessPlanner` retains
a full set of tree levels for its state (tens of MB at 1M validators),
so the service keeps a small LRU of planners keyed by block root — the
first request against a state pays one engine build, every later
request for the same state reads retained levels in O(proof) time.

Why a DEDICATED engine per served state rather than the state's own
``_root_engine``: the lineage engine (state_transition/core.py) is
lock-free single-threaded consensus state — ONE object rides the whole
advancing chain, re-stamped by every block's transition.  Witness
requests run on API worker threads concurrently with block application;
sharing that engine would both race its level arrays mid-rebuild
(torn proofs — or worse, torn roots fed back into consensus) and
re-sync its caches BACKWARD to whatever historical state a client asks
about, degrading the hot transition path's pushed-delta stamps.  The
service pays one isolated build per state (under the planner's lock)
and keeps consensus state untouched.

The port's copy of the JAX package's ``witness/service.py``.  Left out:
``register_plane`` (the memory accounting of ``ops/profile``, not
ported) and ``SERVE_NO_CACHE`` (the proof cache is always on).
``backend`` is the hash backend of every planner's engine (``None``: the
installed one); ``metrics`` is the proof cache's sink (``None``: the
port's registry, as in the JAX package).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..serve_cache import ServeCache
from ..types.beacon import BeaconState
from .multiproof import WitnessPlanner, WitnessProof

__all__ = ["WitnessService"]


class WitnessService:
    """Thread-safe planner cache (witness requests run on API worker
    threads; two concurrent first-requests for one state would otherwise
    both build engines).

    The **shared witness-proof cache** holds completed proofs keyed by
    ``(block root, requested leaf set)``.  A proof for a fixed root and
    leaf set is immutable, so a hot leaf set amortizes to a dictionary
    hit instead of a re-plan + re-hash.  The key is ORDER-SENSITIVE by
    design: ``WitnessProof.indices`` records the requested order, so two
    orderings of one leaf set are two distinct (bit-exact) payloads.
    Bounded by the epoch-LRU discipline of :class:`ServeCache` and
    evicted by root on a head transition (``invalidate_root``)."""

    def __init__(
        self,
        cls: type = BeaconState,
        capacity: int = 4,
        proof_cache_entries: int = 1024,
        backend=None,
        metrics=None,
    ):
        # capacity covers the states an API actually serves hot (head,
        # justified, finalized) plus one historical straggler — at 2 the
        # head/justified/finalized rotation would evict the planner it
        # is about to need on every third request
        self.cls = cls
        self.capacity = max(1, int(capacity))
        self.backend = backend
        # root -> (planner, its lock): the registry lock only guards the
        # LRU map; each planner serializes its own engine (concurrent
        # proofs against one state would race the field caches
        # mid-rebuild), so two different states prove concurrently
        self._planners: OrderedDict[bytes, tuple] = OrderedDict()
        self._lock = threading.Lock()
        # (root, requests) -> WitnessProof; proofs are a few KB each, so
        # the byte bound mostly guards adversarially wide index sets
        self._proofs = ServeCache(
            "witness_proof",
            capacity=max(1, int(proof_cache_entries)),
            max_bytes=16 << 20,
            metrics=metrics,
        )

    def retained_bytes(self) -> int:
        """Bytes retained by this service: every planner's engine tree
        rows plus the proof cache's accounted payloads."""
        with self._lock:
            planners = [p for p, _lock in self._planners.values()]
        return sum(planner.engine.retained_bytes() for planner in planners) + int(
            self._proofs.stats()["bytes"]
        )

    def planner(self, anchor_root: bytes) -> tuple:
        """``(planner, lock)`` for one state root, LRU-bounded."""
        with self._lock:
            entry = self._planners.get(anchor_root)
            if entry is None:
                entry = self._planners[anchor_root] = (
                    WitnessPlanner(self.cls, backend=self.backend),
                    threading.Lock(),
                )
            self._planners.move_to_end(anchor_root)
            while len(self._planners) > self.capacity:
                self._planners.popitem(last=False)
        return entry

    def prove(self, anchor_root: bytes, state, requests, spec=None) -> WitnessProof:
        root = bytes(anchor_root)
        key = (root, tuple(requests))
        hit = self._proofs.get(key, kind="proof")
        if hit is not None:
            return hit
        planner, lock = self.planner(root)
        with lock:
            proof = planner.prove(state, requests, spec)
        # nbytes from the compact encoding's arithmetic (32 B per chunk
        # + per-index overhead) without paying an actual encode
        nbytes = 40 + 32 * (len(proof.leaves) + len(proof.siblings)) + sum(
            12 + len(f) for f, _ in proof.indices
        )
        epoch = 0
        if state is not None and spec is not None:
            epoch = int(state.slot) // int(spec.SLOTS_PER_EPOCH)
        return self._proofs.put(key, proof, root=root, epoch=epoch, nbytes=nbytes)

    def invalidate_root(self, root: bytes, reason: str = "head_transition") -> int:
        """Evict one root's cached proofs (a head-transition observer
        calls this on a reorg)."""
        return self._proofs.invalidate_root(bytes(root), reason=reason)
