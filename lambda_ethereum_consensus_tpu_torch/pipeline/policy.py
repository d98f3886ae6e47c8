"""Pure decision functions of the ingest scheduler.

Kept free of asyncio and metrics so every policy choice is unit-testable
as a function of explicit state: batch-shape snapping, shed-victim
selection, and the degraded-mode window.

The port's copy of the JAX package's ``pipeline/policy.py``.  The port's
scheduler never snaps (it keeps no warmed shape buckets);
:func:`snap_batch` stays as the exported pure function.
"""

from __future__ import annotations

__all__ = ["DegradedSignal", "choose_shed_victim", "snap_batch"]


def snap_batch(n: int, buckets) -> int:
    """Snap a flush size onto a warmed shape bucket.

    Returns the largest bucket ``<= n``, or ``n`` unchanged when no
    bucket fits.  Snapping only ever rounds DOWN: the un-flushed
    remainder stays queued with its own (newer) arrival stamp, so it
    drains on the next deadline instead of padding this batch into an
    unwarmed shape that would compile a new program mid-drain.  A flush
    smaller than every warmed bucket goes out as-is — deadline flushes
    must drain even when the warmer targeted bigger shapes.
    """
    best = 0
    for b in buckets:
        if best < b <= n:
            best = b
    return best or n


def choose_shed_victim(lanes_by_priority, incoming):
    """The lane that pays for admitting one more ``incoming``-class item.

    Scans lanes from LOWEST priority upward and returns the first
    non-empty one that is not strictly more important than the incoming
    item's lane — overload sheds duplicate-heavy subnet votes before it
    ever touches an aggregate, and can never evict a block to admit an
    attestation.  Returns None when every queued item outranks the
    incoming one (the caller then drops the incoming item itself).

    ``lanes_by_priority`` is ascending by priority *value* (most
    important first), the order the scheduler already maintains.
    """
    for lane in reversed(lanes_by_priority):
        if lane.config.priority < incoming.config.priority:
            break
        if len(lane):
            return lane
    return None


class DegradedSignal:
    """Sliding-window overload latch: active while any shed happened in
    the last ``window_s`` seconds.  One float of state — the node
    exposes it as the ``ingest_degraded`` gauge so operators (and the
    API's health surface) see admission control engaging without
    diffing shed counters."""

    __slots__ = ("window_s", "_last_shed")

    def __init__(self, window_s: float = 5.0):
        self.window_s = window_s
        self._last_shed: float | None = None

    def mark(self, now: float) -> bool:
        """Record a shed; returns True when this mark ACTIVATED the
        latch (it was clear) — the edge the transitions counter and the
        flight-recorder event key on, so brief degraded episodes between
        scrapes stay alertable instead of vanishing into a gauge."""
        activated = not self.active(now)
        self._last_shed = now
        return activated

    def active(self, now: float) -> bool:
        return self._last_shed is not None and (now - self._last_shed) < self.window_s

    def remaining(self, now: float) -> float | None:
        """Seconds until the latch clears (None when already clear) —
        the scheduler caps its idle sleep by this so the gauge drops on
        time even when traffic stops entirely."""
        if not self.active(now):
            return None
        return self._last_shed + self.window_s - now
