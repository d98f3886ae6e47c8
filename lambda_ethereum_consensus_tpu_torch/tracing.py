"""Slot-phase clock and slot-phase delay metrics.

The port's copy of the part of the JAX package's ``tracing.py`` the duty
engine needs:

- **Slot-phase clock** (:class:`SlotClock`): pure slot/offset/interval
  math from ``genesis_time``/``SECONDS_PER_SLOT`` — what the duty
  scheduler fires its phases by and judges their deadlines against.
- **Slot-phase observers** (:func:`observe_block_arrival`,
  :func:`observe_head_update`): a block's arrival offset into its slot and
  the head-update delay after its slot's start, into histograms with
  half-second slot-shaped buckets (``SLOT_PHASE_BUCKETS``) on the
  telemetry registry.

Not carried over: the item traces (``ItemTrace``, ``new_trace``), the
flight recorder (``FlightRecorder``), the batch fan-in span
(``record_verify_batch``) and the trace merger (``merge_chrome_traces``).
"""

from __future__ import annotations

import time

from .telemetry import get_metrics

__all__ = [
    "SLOT_PHASE_BUCKETS",
    "SlotClock",
    "observe_block_arrival",
    "observe_head_update",
]

# Slot-phase delay buckets: the default telemetry bounds are log-spaced
# for 100 us..105 s latencies and would fold a whole 12 s slot into two
# buckets.  Half-second steps across a mainnet slot keep "arrived in the
# attestation interval" vs "arrived at the deadline" resolvable, with a
# short geometric tail for late/catch-up outliers.
SLOT_PHASE_BUCKETS = tuple(0.5 * i for i in range(1, 25)) + (16.0, 24.0, 48.0, 96.0)

_SLOT_PHASE_FAMILIES = (
    "slot_block_arrival_offset_seconds",
    "head_update_delay_seconds",
)


class SlotClock:
    """Pure slot/offset/interval math from the chain's genesis time.

    Pre-genesis instants map to NEGATIVE slots (floor division), with
    the offset still normalized into ``[0, seconds_per_slot)`` — so
    delay math is total and a node booted before genesis never divides
    by zero or wraps.  ``intervals_per_slot`` splits a slot into the
    spec's sub-phases (propose / attest / aggregate at
    ``INTERVALS_PER_SLOT = 3``)."""

    __slots__ = ("genesis_time", "seconds_per_slot", "intervals_per_slot")

    def __init__(
        self,
        genesis_time: int,
        seconds_per_slot: int,
        intervals_per_slot: int = 3,
    ):
        if seconds_per_slot <= 0 or intervals_per_slot <= 0:
            raise ValueError("seconds_per_slot/intervals_per_slot must be >= 1")
        self.genesis_time = int(genesis_time)
        self.seconds_per_slot = int(seconds_per_slot)
        self.intervals_per_slot = int(intervals_per_slot)

    def slot_at(self, t: float) -> int:
        """Slot containing wall-clock ``t`` (negative before genesis)."""
        return int((t - self.genesis_time) // self.seconds_per_slot)

    def slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def offset_into_slot(self, t: float) -> float:
        """Seconds since the containing slot's start, in ``[0, sps)`` —
        exact boundaries land at 0.0 of the NEW slot."""
        return t - self.slot_start(self.slot_at(t))

    def interval_at(self, t: float) -> int:
        """Sub-phase index in ``[0, intervals_per_slot)``."""
        off = self.offset_into_slot(t)
        return min(
            int(off * self.intervals_per_slot // self.seconds_per_slot),
            self.intervals_per_slot - 1,
        )

    def phase(self, t: float) -> dict:
        """The ``/debug/slot`` summary shape for instant ``t``."""
        slot = self.slot_at(t)
        return {
            "slot": slot,
            "offset_s": round(t - self.slot_start(slot), 4),
            "interval": self.interval_at(t),
            "pre_genesis": t < self.genesis_time,
            "seconds_per_slot": self.seconds_per_slot,
            "intervals_per_slot": self.intervals_per_slot,
            "genesis_time": self.genesis_time,
        }


def _register_slot_histograms(metrics) -> None:
    """Pin the slot-shaped bucket bounds before the first observe.  The
    already-done guard is keyed on the registry INSTANCE (its bucket
    table), not a module global, so a swapped/recreated default registry
    — tests do this — gets the slot-shaped bounds again instead of
    silently falling through to the log-latency defaults."""
    if _SLOT_PHASE_FAMILIES[0] in metrics._buckets:
        return
    for name in _SLOT_PHASE_FAMILIES:
        try:
            metrics.register_histogram(name, SLOT_PHASE_BUCKETS)
        except ValueError:
            pass  # racing caller pinned them, or observations exist


def _observe_slot_delay(
    family: str, clock: SlotClock, slot: int, now: float | None
) -> float:
    """Shared slot-phase observation: seconds from ``slot``'s start to
    ``now``, clamped at 0 (an item early relative to the local clock
    would otherwise make the histogram uninterpretable as lateness)."""
    m = get_metrics()
    if now is None:
        now = time.time()
    delay = max(0.0, now - clock.slot_start(int(slot)))
    if m._enabled:
        _register_slot_histograms(m)
        m.observe(family, delay)
    return delay


def observe_block_arrival(clock: SlotClock, block_slot: int, now: float | None = None) -> float:
    """Record a gossip block's arrival offset into ITS slot."""
    return _observe_slot_delay(
        "slot_block_arrival_offset_seconds", clock, block_slot, now
    )


def observe_head_update(clock: SlotClock, head_slot: int, now: float | None = None) -> float:
    """Record how far after its slot's start the fork-choice head moved
    to a block at ``head_slot``."""
    return _observe_slot_delay("head_update_delay_seconds", clock, head_slot, now)
