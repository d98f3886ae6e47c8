"""The data-availability gate: block import parks until blobs arrive.

Deneb couples block validity to blob availability: a block advertising
``blob_kzg_commitments`` may only join fork choice once every advertised
sidecar has been seen and verified.  This module is that gate — a
bounded pending-DA buffer keyed by block root:

- :meth:`DataAvailability.expect` registers a block's commitment list
  (the seam a deneb state-transition calls from the block body; chaos
  scenarios and tests call it directly since the repo's wire containers
  predate the body field).  ``versioned_hashes``, when provided, are
  cross-checked against the commitments — the execution-layer linkage.
- :meth:`DataAvailability.on_sidecar` records one verified sidecar's
  (root, index, commitment) linkage; commitment mismatches against the
  expectation are the caller's REJECT signal.
- :meth:`DataAvailability.is_available` is what the pending-blocks scan
  asks before applying: True for roots with no registered expectation
  (pre-deneb blocks pass untouched) or with every *sampled* index seen.

**Column sampling**: a node constructed with a ``subnets`` subset only
waits for blob indices mapping onto those subnets (``index %
BLOB_SIDECAR_SUBNET_COUNT``) — the DA-sampling model where each fleet
member guards its own columns and the union covers the block.

Both the expectation table and the orphan buffer (verified sidecars
arriving before their block) are FIFO-bounded by
:data:`DEFAULT_PENDING_MAX` (64 roots) so a withholding or spam adversary
cannot grow unbounded state.

The port's copy of the JAX package's ``da/availability.py``.  The one
difference: the bound is the module constant :data:`DEFAULT_PENDING_MAX`
(tests monkeypatch it), read where it bites, not the ``DA_PENDING_MAX``
environment variable or a ``max_pending=`` constructor argument.
Nothing here touches the device: the KZG checks run in the caller's drain
(:func:`.kzg.verify_blob_batch`), and this gate only records their linkage.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict

from ..telemetry import inc, observe, set_gauge
from .kzg import versioned_hash

__all__ = ["DEFAULT_PENDING_MAX", "DaError", "DataAvailability"]

log = logging.getLogger("da.availability")

#: roots each of the expectation table and the orphan buffer may hold
DEFAULT_PENDING_MAX = 64


class DaError(ValueError):
    """Inconsistent availability registration (bad linkage shape)."""


class DataAvailability:
    def __init__(
        self,
        spec,
        subnets: tuple[int, ...] | None = None,
        clock=time.monotonic,
    ):
        self.spec = spec
        self.subnet_count = int(spec.get("BLOB_SIDECAR_SUBNET_COUNT", 6))
        #: blob subnets this node samples; None = guard every column
        self.subnets = (
            None if subnets is None else frozenset(int(s) for s in subnets)
        )
        self._clock = clock
        # root -> {"commitments": tuple[bytes], "need": set[int],
        #          "seen": set[int], "t0": float}
        self._expected: OrderedDict[bytes, dict] = OrderedDict()
        # verified sidecars whose block we have not seen yet:
        # root -> {index: commitment}
        self._orphans: OrderedDict[bytes, dict] = OrderedDict()
        self._available: set[bytes] = set()

    # ------------------------------------------------------------ queries

    def _sampled(self, index: int) -> bool:
        return self.subnets is None or (
            index % self.subnet_count in self.subnets
        )

    def is_available(self, root: bytes) -> bool:
        """True unless ``root`` has a registered, still-incomplete
        expectation — unknown roots (pre-deneb blocks) pass untouched."""
        return bytes(root) not in self._expected

    def pending_count(self) -> int:
        return len(self._expected)

    def expected_commitment(self, root: bytes, index: int) -> bytes | None:
        entry = self._expected.get(bytes(root))
        if entry is None or index >= len(entry["commitments"]):
            return None
        return entry["commitments"][index]

    # ------------------------------------------------------- registration

    def expect(
        self,
        root: bytes,
        commitments,
        versioned_hashes=None,
    ) -> bool:
        """Register a block's advertised commitments; returns whether the
        block is available right now (no sampled columns outstanding).
        Re-registering a known or already-available root is idempotent."""
        root = bytes(root)
        commitments = tuple(bytes(c) for c in commitments)
        if versioned_hashes is not None:
            hashes = tuple(bytes(h) for h in versioned_hashes)
            if len(hashes) != len(commitments) or any(
                versioned_hash(c) != h for c, h in zip(commitments, hashes)
            ):
                raise DaError("versioned hashes do not match commitments")
        if root in self._available or root in self._expected:
            return root in self._available
        if not commitments:
            self._mark_available(root)
            observe("da_gate_wait_seconds", 0.0)
            return True
        need = {
            i for i in range(len(commitments)) if self._sampled(i)
        }
        # consume verified orphans that arrived before the block — only
        # those whose commitment matches the now-known advertisement
        seen = set()
        for i, commitment in self._orphans.pop(root, {}).items():
            if i in need and commitment == commitments[i]:
                seen.add(i)
        if need <= seen:
            self._mark_available(root)
            observe("da_gate_wait_seconds", 0.0)
            return True
        while len(self._expected) >= DEFAULT_PENDING_MAX:
            evicted, _ = self._expected.popitem(last=False)
            inc("da_sidecars_total", 1, result="evicted")
            log.warning(
                "pending-DA buffer full; evicting oldest root %s",
                evicted.hex()[:16],
            )
        self._expected[root] = {
            "commitments": commitments,
            "need": need,
            "seen": seen,
            "t0": self._clock(),
        }
        set_gauge("da_blocks_pending", float(len(self._expected)))
        return False

    def on_sidecar(self, root: bytes, index: int, commitment: bytes) -> str:
        """Record one KZG-VERIFIED sidecar.  Returns the linkage verdict:
        ``"mismatch"`` (advertised commitment differs — the caller's
        REJECT), ``"duplicate"``, ``"orphan"`` (no expectation yet;
        buffered), ``"accept"`` or ``"complete"`` (this sidecar finished
        the block's sampled set)."""
        root, commitment = bytes(root), bytes(commitment)
        index = int(index)
        entry = self._expected.get(root)
        if entry is None:
            if root in self._available:
                inc("da_sidecars_total", 1, result="duplicate")
                return "duplicate"
            bucket = self._orphans.setdefault(root, {})
            if index in bucket:
                inc("da_sidecars_total", 1, result="duplicate")
                return "duplicate"
            bucket[index] = commitment
            self._orphans.move_to_end(root)
            while len(self._orphans) > DEFAULT_PENDING_MAX:
                self._orphans.popitem(last=False)
            inc("da_sidecars_total", 1, result="orphan")
            return "orphan"
        if index >= len(entry["commitments"]) or (
            entry["commitments"][index] != commitment
        ):
            inc("da_sidecars_total", 1, result="mismatch")
            return "mismatch"
        if index in entry["seen"]:
            inc("da_sidecars_total", 1, result="duplicate")
            return "duplicate"
        entry["seen"].add(index)
        inc("da_sidecars_total", 1, result="accept")
        if entry["need"] <= entry["seen"]:
            del self._expected[root]
            self._mark_available(root)
            observe("da_gate_wait_seconds", self._clock() - entry["t0"])
            set_gauge("da_blocks_pending", float(len(self._expected)))
            return "complete"
        return "accept"

    def _mark_available(self, root: bytes) -> None:
        self._available.add(root)
        # bounded memory: availability verdicts for long-gone roots are
        # re-derivable (unknown root == available), so cap the memo
        if len(self._available) > 4 * DEFAULT_PENDING_MAX:
            self._available.clear()
