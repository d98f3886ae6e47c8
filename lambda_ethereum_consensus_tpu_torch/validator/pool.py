"""Attestation pool: collect votes, serve aggregates and block payloads.

Cells are keyed ``(slot, committee_index, data_root)`` — the identity an
aggregate is built over.  Two ingestion shapes:

- **single-bit votes** (the ``beacon_attestation_{subnet}`` wire shape,
  and what :class:`..scheduler.DutyScheduler` produces for its own keys)
  merge per committee POSITION: each position keeps its first signature,
  so the cell's aggregate is always over disjoint bits and
  ``bls.aggregate`` of the kept signatures is exactly the committee
  aggregate a spec-compliant aggregator publishes.
- **aggregates** (``beacon_aggregate_and_proof`` payloads) are kept as
  candidates per cell; block assembly picks the widest coverage per
  cell, preferring the vote-built aggregate when it covers at least as
  many bits.

The pool never verifies — callers feed it their own signatures or
gossip-verified ones (the node's drain has already REJECTed invalid
material by the time a verdict is ACCEPT).

The port's copy of the JAX package's ``validator/pool.py``.
"""

from __future__ import annotations

import threading

from ..config import ChainSpec, get_chain_spec
from ..crypto import bls
from ..telemetry import get_metrics
from ..types.beacon import Attestation

__all__ = ["AttestationPool"]


class _Cell:
    __slots__ = ("data", "committee_size", "sigs", "aggregates")

    def __init__(self, data, committee_size: int):
        self.data = data
        self.committee_size = committee_size
        self.sigs: dict[int, bytes] = {}  # position -> signature
        self.aggregates: list[Attestation] = []


class AttestationPool:
    """Thread-safe (the duty scheduler fires from an executor thread
    while gossip drains feed on the event loop)."""

    def __init__(self, spec: ChainSpec | None = None):
        self._spec = spec
        self._cells: dict[tuple, _Cell] = {}
        self._lock = threading.Lock()

    @property
    def spec(self) -> ChainSpec:
        return self._spec if self._spec is not None else get_chain_spec()

    def _key(self, att: Attestation) -> tuple:
        return (
            int(att.data.slot),
            int(att.data.index),
            att.data.hash_tree_root(self.spec),
        )

    def _cell(self, att: Attestation) -> _Cell:
        key = self._key(att)
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _Cell(
                att.data, len(att.aggregation_bits)
            )
        return cell

    def _gauge(self) -> None:
        get_metrics().set_gauge("duty_pool_attestations", float(len(self._cells)))

    # ------------------------------------------------------------- ingest

    def add_vote(self, att: Attestation) -> bool:
        """One single-bit vote; returns True when the position was new
        (a second vote for a taken position is dropped — first-seen wins,
        matching the gossip IGNORE discipline)."""
        bits = att.aggregation_bits
        positions = [i for i, b in enumerate(bits) if b]
        if len(positions) != 1:
            raise ValueError("add_vote wants exactly one aggregation bit")
        with self._lock:
            cell = self._cell(att)
            if positions[0] in cell.sigs:
                return False
            cell.sigs[positions[0]] = bytes(att.signature)
            self._gauge()
            return True

    def add_aggregate(self, att: Attestation) -> None:
        """A ready-made aggregate (gossip ``aggregate_and_proof`` payload)
        becomes a block-assembly candidate for its cell."""
        with self._lock:
            self._cell(att).aggregates.append(att)
            self._gauge()

    # -------------------------------------------------------------- serve

    def aggregate_for(
        self, slot: int, committee_index: int
    ) -> Attestation | None:
        """The vote-built aggregate for the (slot, index) cell with the
        most votes — what an elected aggregator publishes.  None when no
        votes are pooled for that committee."""
        with self._lock:
            best = None
            for (s, i, _root), cell in self._cells.items():
                if s != int(slot) or i != int(committee_index) or not cell.sigs:
                    continue
                if best is None or len(cell.sigs) > len(best.sigs):
                    best = cell
            if best is None:
                return None
            return self._from_votes(best)

    @staticmethod
    def _from_votes(cell: _Cell) -> Attestation:
        bits = [False] * cell.committee_size
        for pos in cell.sigs:
            bits[pos] = True
        return Attestation(
            aggregation_bits=bits,
            data=cell.data,
            signature=bls.aggregate(
                [cell.sigs[pos] for pos in sorted(cell.sigs)]
            ),
        )

    def block_attestations(
        self, slot: int, max_count: int | None = None
    ) -> list[Attestation]:
        """The widest aggregate per cell eligible for a block at
        ``slot`` (inclusion delay respected), widest-first overall —
        the proposer path's payload."""
        spec = self.spec
        out: list[tuple[int, Attestation]] = []
        with self._lock:
            for (s, _i, _root), cell in self._cells.items():
                if not (
                    s + spec.MIN_ATTESTATION_INCLUSION_DELAY
                    <= int(slot)
                    <= s + spec.SLOTS_PER_EPOCH
                ):
                    continue
                best: Attestation | None = (
                    self._from_votes(cell) if cell.sigs else None
                )
                count = len(cell.sigs)
                for agg in cell.aggregates:
                    n = sum(1 for b in agg.aggregation_bits if b)
                    if n > count:
                        best, count = agg, n
                if best is not None:
                    out.append((count, best))
        out.sort(key=lambda t: -t[0])
        if max_count is None:
            max_count = self.spec.MAX_ATTESTATIONS
        return [att for _n, att in out[:max_count]]

    # ------------------------------------------------------------- upkeep

    def prune(self, before_slot: int) -> int:
        """Drop cells no block can ever include (data older than one
        epoch behind ``before_slot``); returns cells dropped."""
        horizon = int(before_slot) - self.spec.SLOTS_PER_EPOCH
        with self._lock:
            stale = [k for k in self._cells if k[0] < horizon]
            for k in stale:
                del self._cells[k]
            if stale:
                self._gauge()
        return len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._cells)
