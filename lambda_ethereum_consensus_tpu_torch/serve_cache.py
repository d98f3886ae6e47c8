"""Head-root/epoch-keyed serving caches.

The serving plane's read path answers the same few questions at very
different costs: a state root is seconds of Merkleization on a cold
engine, a witness multiproof is a plan + a SHA-256 pass — and at
light-client scale every one of them repeats thousands of times per head.
:class:`ServeCache` is the bounded container behind the
**witness-proof cache** in :mod:`.witness.service`, which holds
:class:`~.witness.multiproof.WitnessProof` objects keyed by
``(block root, requested leaf set)`` so hot leaf sets skip the re-plan
even across output formats.

Keying discipline: every key carries the CONCRETE resolved root, so a
reorg changes the key and can never read a stale head's entry;
:meth:`ServeCache.invalidate_root` additionally evicts the stale head's
entries the moment the head flips.

Eviction: overflow — by entry count or by accounted payload bytes —
evicts from the OLDEST epoch present first, least-recently-used within
that epoch, so a burst of historical-state traffic can never wash the hot
head's entries out of a full cache.

The port's copy of the JAX package's ``serve_cache.py``.  As there,
``metrics=None`` records the ``serve_cache_*`` families, labeled
``cache=<name>``, on the package's default registry
(:func:`.telemetry.get_metrics`, read at each call, so a registry swapped
in later is the one recorded to); any other ``metrics`` object with the
registry's ``inc``/``observe``/``set_gauge``/``span`` gets them instead.
:data:`SILENT` is the explicit opt-out: a sink that records nothing, which
the witness plane's sinks (:class:`ServeCache`,
:class:`.witness.coalesce.VerifyCoalescer`,
:func:`.witness.verify.verify_batch`, :class:`.witness.service.WitnessService`)
all accept.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

from .telemetry import _NOOP_SPAN, get_metrics

__all__ = ["SILENT", "ServeCache"]


class _Silent:
    """A metrics sink that records nothing: the opt-out a caller passes
    as ``metrics`` to keep a sink off the registry."""

    def inc(self, name: str, value: float = 1, **labels) -> None:
        pass

    def observe(self, name: str, value: float, **labels) -> None:
        pass

    def set_gauge(self, name: str, value: float, **labels) -> None:
        pass

    def span(self, name: str, slow: float | None = None, **labels):
        return _NOOP_SPAN


SILENT = _Silent()


@dataclass
class _Entry:
    value: object
    root: bytes
    epoch: int
    nbytes: int


class ServeCache:
    """Thread-safe bounded cache with epoch-LRU eviction and root-keyed
    invalidation.  ``get``/``put`` run on API worker threads concurrently
    with the node loop's ``invalidate_root`` — one lock guards all maps
    (pure dict bookkeeping inside; nothing blocking is ever held under
    it)."""

    def __init__(
        self,
        name: str,
        capacity: int = 2048,
        max_bytes: int = 64 << 20,
        metrics=None,
    ):
        self.name = name
        self.capacity = max(1, int(capacity))
        self.max_bytes = int(max_bytes)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._entries: dict = {}  # key -> _Entry (recency lives per-epoch)
        # secondary indexes: per-root key set (O(keys-of-root)
        # invalidation) and per-epoch recency (oldest-epoch-first
        # eviction, LRU within the epoch; the
        # ONLY ordering eviction consults, so the main map stays a
        # plain dict with no hit-path reordering)
        self._by_root: dict[bytes, set] = {}
        self._by_epoch: dict[int, OrderedDict] = {}
        self._bytes = 0

    # ------------------------------------------------------------ plumbing

    @property
    def metrics(self):
        return self._metrics if self._metrics is not None else get_metrics()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "roots": len(self._by_root),
                "epochs": sorted(self._by_epoch),
            }

    def _unlink(self, key) -> "_Entry":
        """Drop one entry from every index (caller holds the lock)."""
        entry = self._entries.pop(key)
        self._bytes -= entry.nbytes
        keys = self._by_root.get(entry.root)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_root[entry.root]
        epoch_keys = self._by_epoch.get(entry.epoch)
        if epoch_keys is not None:
            epoch_keys.pop(key, None)
            if not epoch_keys:
                del self._by_epoch[entry.epoch]
        return entry

    def _publish_gauges(self) -> None:
        m = self.metrics
        m.set_gauge("serve_cache_entries", len(self._entries), cache=self.name)
        m.set_gauge("serve_cache_bytes", self._bytes, cache=self.name)

    # ------------------------------------------------------------- surface

    def get(self, key, kind: str = "value"):
        """The cached value, or ``None`` — counting the hit/miss under
        ``kind`` (the route family on the response layer)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                epoch_keys = self._by_epoch.get(entry.epoch)
                if epoch_keys is not None and key in epoch_keys:
                    epoch_keys.move_to_end(key)
                value = entry.value
            else:
                value = None
        m = self.metrics
        if value is not None:
            m.inc("serve_cache_hit_total", cache=self.name, kind=kind)
        else:
            m.inc("serve_cache_miss_total", cache=self.name, kind=kind)
        return value

    def put(self, key, value, root: bytes = b"", epoch: int = 0, nbytes: int = 0):
        """Insert (returning ``value`` so call sites read
        ``return cache.put(...)``), evicting oldest-epoch/LRU entries
        past the count/byte bounds.  An oversized single payload (past
        ``max_bytes`` on its own) is served but not retained — caching
        it would evict the entire working set for one straggler."""
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            return value
        root = bytes(root)
        epoch = int(epoch)
        evicted = 0
        with self._lock:
            if key in self._entries:
                self._unlink(key)
            self._entries[key] = _Entry(value, root, epoch, nbytes)
            self._bytes += nbytes
            self._by_root.setdefault(root, set()).add(key)
            self._by_epoch.setdefault(epoch, OrderedDict())[key] = None
            while len(self._entries) > self.capacity or self._bytes > self.max_bytes:
                oldest = min(self._by_epoch)
                victim = next(iter(self._by_epoch[oldest]))
                self._unlink(victim)
                evicted += 1
            self._publish_gauges()
        if evicted:
            self.metrics.inc(
                "serve_cache_evictions_total", evicted, cache=self.name
            )
        return value

    def invalidate_root(self, root: bytes, reason: str = "head_transition") -> int:
        """Evict every entry keyed to one resolved root — a head-transition
        observer calls this with the STALE head the moment the cached
        fork-choice head flips, so a reorg's dead branch never pins
        served entries."""
        root = bytes(root)
        with self._lock:
            keys = list(self._by_root.get(root, ()))
            for key in keys:
                self._unlink(key)
            if keys:
                self._publish_gauges()
        if keys:
            self.metrics.inc(
                "serve_cache_invalidations_total",
                len(keys),
                cache=self.name,
                reason=reason,
            )
        return len(keys)

    def clear(self, reason: str = "clear") -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_root.clear()
            self._by_epoch.clear()
            self._bytes = 0
            if n:
                self._publish_gauges()
        if n:
            self.metrics.inc(
                "serve_cache_invalidations_total",
                n,
                cache=self.name,
                reason=reason,
            )
        return n
