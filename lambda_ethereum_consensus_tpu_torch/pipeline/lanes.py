"""Bounded priority lanes: the queue shape the ingest scheduler serves.

A lane is a FIFO deque of ``(arrival, item, source, trace)`` entries
(``trace`` is the item's causal-trace context from :mod:`tracing`, or
None when tracing is off) with two flush triggers:

- **coalesce target**: the lane is ready the moment its depth reaches
  ``coalesce_target`` — the batch is already worth a device dispatch,
  waiting longer only adds latency;
- **deadline**: below the target, the lane is ready once its *oldest*
  item has waited ``deadline_s`` — light load drains at a bounded
  latency instead of degenerating into batch-of-1 dispatches.

The DRR ``deficit`` counter lives on the lane so the scheduler's
service-share state survives across rounds (a lane skipped this round
because its deficit ran out picks up where it left off).

The port's copy of the JAX package's ``pipeline/lanes.py``, without
``LaneConfig.shape_kind``: the port keeps no shape-bucket registry (a CUDA
kernel compiles no program per batch shape), so a key into one would select
nothing.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class LaneConfig:
    """One lane's shape.

    ``priority``: lower value = more important; the scheduler serves
    ready lanes in ascending priority order and the shed policy only
    ever evicts from lanes at or below the admitting item's class.

    ``weight``: DRR quantum in items per scheduling round — the service
    share a lane gets when several lanes are backlogged at once.  Set it
    to ``max_batch`` for a lane that must never be deficit-limited.

    ``coalesce_target``: eager-flush depth.  1 means "flush as soon as
    anything is queued" (blocks); the attestation lanes set it to the
    device path's minimum worthwhile batch
    (fork_choice.handlers.attestation_batch_target).

    ``shed_newest``: True for lanes whose items form parent-first
    chains (blocks) — a full lane then drops the INCOMING item instead
    of evicting its oldest queued one, preserving a processable prefix
    (evicting an ancestor would orphan every queued descendant into
    unknown-parent re-fetches).  Attestation lanes keep the default
    drop-oldest: the newest votes carry the most fork-choice signal.
    """

    name: str
    priority: int
    weight: int = 64
    max_batch: int = 64
    max_queue: int = 1024
    deadline_s: float = 0.1
    coalesce_target: int = 1
    shed_newest: bool = False


class Lane:
    """One bounded FIFO lane: arrival-stamped entries + DRR deficit."""

    __slots__ = ("config", "deficit", "_items")

    def __init__(self, config: LaneConfig):
        self.config = config
        self.deficit = 0
        self._items: deque = deque()

    def __len__(self) -> int:
        return len(self._items)

    def push(self, arrival: float, item, source, trace=None) -> None:
        self._items.append((arrival, item, source, trace))

    def pop_oldest(self):
        """Shed path: evict the head entry (or None when empty)."""
        return self._items.popleft() if self._items else None

    def take(self, n: int) -> list:
        """Dequeue up to ``n`` head entries in arrival order."""
        items = self._items
        return [items.popleft() for _ in range(min(n, len(items)))]

    def head_arrival(self) -> float | None:
        return self._items[0][0] if self._items else None

    def next_deadline(self) -> float | None:
        """Monotonic instant the oldest item's wait budget expires."""
        head = self.head_arrival()
        return None if head is None else head + self.config.deadline_s

    def ready(self, now: float) -> bool:
        """Flush-ready: coalesce target reached, or deadline expired."""
        items = self._items
        if not items:
            return False
        if len(items) >= self.config.coalesce_target:
            return True
        return now >= items[0][0] + self.config.deadline_s

    def occupancy(self) -> float:
        return len(self._items) / self.config.max_queue
