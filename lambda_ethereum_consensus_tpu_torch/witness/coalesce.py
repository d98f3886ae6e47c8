"""Cross-request batch coalescing for witness verification.

A verify request arrives as whatever ragged batch one light client
happened to send — usually a handful of proofs, under
:data:`~.verify.DEVICE_MIN`, where the per-proof oracle would answer it
alone.  The coalescer fills planes from DIFFERENT requests instead:
concurrent requests park in a bounded queue and one leader dispatches the
merged batch through :func:`~.verify.verify_batch`, demuxing the
per-proof verdicts back to each parked request.

Flush discipline:

- **target flush**: the queue is ready the moment its proof count
  reaches :data:`TARGET` — the batch already fills a plane, waiting
  longer only adds latency;
- **deadline flush**: below the target, the queue flushes once its
  OLDEST parked request has waited ``deadline_s`` — a lone request
  never waits more than its deadline budget.

A flush takes whole requests up to :data:`MAX_FLUSH` proofs.

Concurrency model: leader/followers on one condition variable.  The
first parked request whose wait finds no active leader becomes the
leader, sleeps until a flush trigger, takes the FIFO prefix, and
dispatches OUTSIDE the lock while followers (and late arrivals) keep
parking.  Requests run on API worker threads, so parking blocks no event
loop.  The plane launches on the card's current stream; the coalescer
keeps no per-call state outside its own instance.

The port's copy of the JAX package's ``witness/coalesce.py``.  Its
variables become constants with the same defaults: the deadline
(``WITNESS_COALESCE_DEADLINE_MS``, 25 ms), the target and the flush cap
(the JAX package's smallest and largest ``witness_verify`` buckets, 64
and 256); ``WITNESS_NO_COALESCE`` is not read: the port's verify route
(``api/beacon_api.py``) always coalesces.
"""

from __future__ import annotations

import threading
import time

from ..telemetry import get_metrics
from .verify import verify_batch

__all__ = ["DEADLINE_S", "MAX_FLUSH", "TARGET", "VerifyCoalescer"]

#: Longest a parked request waits for company before its flush.
DEADLINE_S = 0.025
#: Queued proofs that make a flush ready at once.
TARGET = 64
#: Most proofs one flush takes (whole requests; a single larger request
#: is still taken alone).
MAX_FLUSH = 256


class _Parked:
    """One request's slot in the queue: its proofs, their expected
    roots, and the rendezvous the parking thread waits on."""

    __slots__ = ("proofs", "roots", "arrival", "done", "results", "error")

    def __init__(self, proofs, roots, arrival: float):
        self.proofs = proofs
        self.roots = roots
        self.arrival = arrival
        self.done = threading.Event()
        self.results: list | None = None
        self.error: BaseException | None = None


class VerifyCoalescer:
    def __init__(
        self,
        deadline_s: float | None = None,
        target: int | None = None,
        max_flush: int | None = None,
        metrics=None,
    ):
        self.deadline_s = DEADLINE_S if deadline_s is None else float(deadline_s)
        self.target = int(target) if target else TARGET
        self.max_flush = int(max_flush) if max_flush else MAX_FLUSH
        self._metrics = metrics
        self._cv = threading.Condition()
        self._parked: list[_Parked] = []  # FIFO
        self._queued_proofs = 0
        self._leader_active = False

    @property
    def metrics(self):
        """The sink of the ``serve_coalesce_*`` families and of each
        flush's :func:`~.verify.verify_batch`: the caller's ``metrics``,
        or the port's registry."""
        return self._metrics if self._metrics is not None else get_metrics()

    # ------------------------------------------------------------- surface

    def verify(self, proofs, expected_roots, device=None) -> list:
        """Park this request, coalesce with whatever else is in flight,
        return ITS verdicts (one bool per proof, order preserved).  An
        empty request answers immediately — parking it would hold a slot
        that can never contribute proofs to a plane.  ``device`` is
        :func:`~.verify.verify_batch`'s (``None``: the card)."""
        if not proofs:
            return []
        entry = _Parked(list(proofs), list(expected_roots), time.monotonic())
        with self._cv:
            self._parked.append(entry)
            self._queued_proofs += len(entry.proofs)
            self._cv.notify_all()
            while not entry.done.is_set():
                if not self._leader_active:
                    self._leader_active = True
                    try:
                        self._lead(device)
                    finally:
                        self._leader_active = False
                        self._cv.notify_all()
                else:
                    # follower: wake on flush completion or leadership
                    # vacancy; the timeout only bounds a missed notify
                    # (floored so a zero deadline cannot busy-spin)
                    self._cv.wait(timeout=max(self.deadline_s, 0.001))
        if entry.error is not None:
            raise entry.error
        if entry.results is None:
            # fail CLOSED: a flush that died without a verdict (leader
            # killed mid-dispatch) must never read as an empty success
            raise RuntimeError(
                "coalesced verify flush terminated without a verdict"
            )
        return list(entry.results)

    # ------------------------------------------------------------ internals

    def _lead(self, device) -> None:
        """Leader body (called WITH the condition held): wait for a
        flush trigger, then dispatch one merged batch.  Leadership ends
        after one flush so a parked follower can take over for the next
        — keeping any single request's total wait bounded by its own
        deadline plus one dispatch."""
        while self._parked:
            now = time.monotonic()
            if self._queued_proofs >= self.target:
                self._flush("target", device)
                return
            oldest_deadline = self._parked[0].arrival + self.deadline_s
            if now >= oldest_deadline:
                self._flush("deadline", device)
                return
            self._cv.wait(timeout=oldest_deadline - now)

    def _flush(self, trigger: str, device) -> None:
        """Take the FIFO prefix (whole requests, up to ``max_flush``
        proofs), dispatch it outside the lock, demux verdicts, wake the
        owners."""
        batch: list[_Parked] = []
        taken = 0
        while self._parked:
            entry = self._parked[0]
            if batch and taken + len(entry.proofs) > self.max_flush:
                break
            self._parked.pop(0)
            taken += len(entry.proofs)
            batch.append(entry)
        self._queued_proofs -= taken
        now = time.monotonic()
        self._cv.release()
        try:
            proofs = [p for entry in batch for p in entry.proofs]
            roots = [r for entry in batch for r in entry.roots]
            m = self.metrics
            m.inc("serve_coalesce_flush_total", trigger=trigger)
            m.inc("serve_coalesce_proofs_total", len(proofs))
            m.inc("serve_coalesce_requests_total", len(batch))
            for entry in batch:
                m.observe("serve_coalesce_wait_seconds", now - entry.arrival)
            try:
                results = verify_batch(proofs, roots, device=device, metrics=self._metrics)
            except BaseException as e:
                # every parked owner gets the error (fail closed); a
                # non-Exception (KeyboardInterrupt/SystemExit) still
                # propagates through the leader after the demux
                for entry in batch:
                    entry.error = e
                if not isinstance(e, Exception):
                    raise
                return
            at = 0
            for entry in batch:
                entry.results = results[at : at + len(entry.proofs)]
                at += len(entry.proofs)
        finally:
            for entry in batch:
                entry.done.set()
            self._cv.acquire()

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "parked_requests": len(self._parked),
                "queued_proofs": self._queued_proofs,
                "target": self.target,
                "max_flush": self.max_flush,
                "deadline_s": self.deadline_s,
            }
