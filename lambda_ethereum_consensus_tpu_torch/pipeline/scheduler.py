"""The ingest scheduler: one asyncio drain over all priority lanes.

Replaces the per-topic independent ``_drain_loop``s (network/gossip.py)
with a single service loop whose three jobs map to the three failure
shapes of the greedy design:

1. **Deficit-weighted priority service.**  Ready lanes are served in
   ascending priority order, but each lane's per-round consumption is
   bounded by its DRR deficit (``weight`` items added per round) — so a
   subnet-attestation flood cannot starve block import, and blocks
   going first every round bounds their drain latency even when every
   lane is backlogged.
2. **Deadline batch coalescing.**  A lane flushes when it reaches its
   coalesce target (the batch is already worth a device dispatch) or
   when its oldest item has waited ``deadline_s`` — light load drains
   at bounded latency in real batches instead of batch-of-1 device
   calls.
3. **Admission-time load shedding.**  A full lane — or a scheduler over
   its global item budget — sheds the OLDEST item from the
   lowest-priority backlogged lane (policy.choose_shed_victim) to admit
   the new one, never the newest block on the wire.  Every shed counts
   (``ingest_shed_count{lane,reason}``) and arms the degraded-mode
   latch the node exposes as the ``ingest_degraded`` gauge.

Sources are duck-typed (``async process(items)``, ``async shed(item)``)
so the same scheduler serves real ``TopicSubscription``s and synthetic
feeds.

The port's copy of the JAX package's ``pipeline/scheduler.py``, with two
deliberate differences:

- a flush is never snapped onto shape buckets: the port keeps no AOT
  registry, so it flushes as the JAX package does when nothing was warmed;
- a device fault from a source's ``process`` (a ``RuntimeError``: a kernel,
  native or CUDA fault, ``torch.OutOfMemoryError``; ``faults.is_device_fault``)
  is not counted into ``ingest_flush_error_count``: it ends the drain loop,
  which is not restarted.  The fault counts once in
  ``ingest_loop_crash_count``, puts a ``drain_fault`` event on the flight
  recorder's timeline, and is raised by the next
  :meth:`IngestScheduler.submit` and by :meth:`IngestScheduler.stop`.  Every
  other exception, a wire error (``PortError``, ``ReqRespError``) included,
  is counted and contained as in the JAX package.

The degraded latch's window is the module constant
:data:`DEGRADED_WINDOW_S`, not a ``degraded_window_s=`` argument.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..faults import is_device_fault
from ..telemetry import get_metrics
from ..tracing import get_recorder
from .lanes import Lane, LaneConfig
from .policy import DegradedSignal, choose_shed_victim

log = logging.getLogger("pipeline")

# pow2 size buckets 1..16384 for the batch-size histogram: the default
# telemetry buckets are latency-shaped (100 us..105 s) and would fold
# every batch size into two buckets
BATCH_SIZE_BUCKETS = tuple(float(1 << i) for i in range(15))

#: seconds the degraded latch stays up after the last shed
DEGRADED_WINDOW_S = 5.0


class IngestScheduler:
    """Shared lane store + the drain task.

    ``metrics`` is the owning node's registry for per-node gauges (lane
    depth/occupancy/degraded — co-resident nodes must not clobber each
    other); counters and histograms land on the process-wide default
    registry where cross-node aggregation is correct.
    """

    def __init__(
        self,
        metrics=None,
        max_items: int | None = None,
    ):
        self.metrics = metrics if metrics is not None else get_metrics()
        self.lanes: dict[str, Lane] = {}
        self._order: list[Lane] = []  # ascending priority value
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = False
        self._max_items = max_items
        self._total = 0  # queued across lanes
        self._inflight = 0  # dequeued into a flush that has not finished
        self.degraded = DegradedSignal(DEGRADED_WINDOW_S)
        # edge tracker for the transitions counter: enter is counted at
        # the shed that flips the latch, exit when the drain loop first
        # observes the latch released (the idle sleep is capped by the
        # latch expiry, so the exit edge lands on time even with zero
        # traffic) — one increment per storm edge, both directions
        self._degraded_active = False
        self._flush_error_logged = False
        # the RuntimeError that ended the drain loop: submit() and stop()
        # raise it, so admission never feeds a loop that no longer runs
        self._fault: BaseException | None = None
        self._enqueue_args: dict[str, dict] = {}  # per-lane, see add_lane
        m = get_metrics()
        try:
            m.register_histogram("ingest_batch_size", BATCH_SIZE_BUCKETS)
        except ValueError:
            pass  # an earlier scheduler (restart/co-resident node) pinned them

    # ------------------------------------------------------------- lifecycle

    def add_lane(self, config: LaneConfig) -> Lane:
        if config.name in self.lanes:
            raise ValueError(f"duplicate lane: {config.name}")
        if min(config.weight, config.max_batch, config.max_queue,
               config.coalesce_target) < 1:
            # weight 0 would make a ready lane unservable: the drain
            # loop would spin on it forever without flushing
            raise ValueError(f"lane {config.name}: sizes/weight must be >= 1")
        lane = Lane(config)
        self.lanes[config.name] = lane
        self._order = sorted(self.lanes.values(), key=lambda l: l.config.priority)
        # prebuilt enqueue-note args: submit() runs at gossip arrival
        # rate, so the per-item trace note must not allocate (ItemTrace
        # stores shared dicts without mutating them)
        self._enqueue_args[config.name] = {"lane": config.name}
        return lane

    @property
    def max_items(self) -> int:
        """Global admission budget (defaults to the sum of lane bounds —
        then only per-lane bounds bite; set it lower to make cross-lane
        shedding engage before any single lane fills)."""
        if self._max_items is not None:
            return self._max_items
        return sum(lane.config.max_queue for lane in self._order)

    @property
    def depth(self) -> int:
        return self._total

    def start(self) -> None:
        self._stopped = False
        self._fault = None
        self._task = asyncio.ensure_future(self._run())
        # supervised: this ONE task serves every lane — an escaped
        # exception must not silently end all gossip processing while
        # the node looks healthy (66 per-topic loops each contained
        # their own failures; the shared loop needs a supervisor)
        self._task.add_done_callback(self._on_task_done)

    def _on_task_done(self, task: asyncio.Task) -> None:
        if task.cancelled() or self._stopped:
            return
        exc = task.exception()
        if exc is None:
            return  # _run never returns normally
        if is_device_fault(exc):
            # a device fault is surfaced, never retried: the loop stays
            # down, and submit() and stop() raise it (_run counted it)
            log.error("ingest drain loop ended by a device fault", exc_info=exc)
            return
        log.error("ingest drain loop crashed; restarting in 1 s", exc_info=exc)
        m = get_metrics()
        m.inc("ingest_loop_crash_count")
        # alertable + trace-dump-visible (a crash-looping drain was
        # log-only): the counter feeds rate() alerts, the recorder event
        # puts the restart ON the timeline next to the items it stalled
        m.inc("pipeline_drain_restarts_total")
        get_recorder().record(
            "inst", 0, "drain_restart",
            {"error": type(exc).__name__, "message": str(exc)},
        )
        task.get_loop().call_later(1.0, self._restart)

    def _restart(self) -> None:
        if not self._stopped:
            self.start()

    async def stop(self) -> None:
        """Cancel the drain loop; raise the ``RuntimeError`` that ended it."""
        self._stopped = True  # also disarms a pending crash-restart
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    # ------------------------------------------------------------- admission

    def submit(self, lane_name: str, item, source, trace=None) -> list:
        """Admit one item; returns ``[(source, item, reason), ...]``
        entries shed to make room (empty in the common case).  The
        CALLER dispatches the sheds' IGNORE verdicts — submit itself
        never awaits, so the gossip callback can run it inline at
        arrival rate.  ``reason`` matches the ``ingest_shed_count``
        label so per-topic and per-lane shed series agree on cause.

        ``trace`` is the item's causal-trace context (or None): the
        scheduler owns every termination IT decides — an incoming drop
        or an eviction ends the trace here with the shed reason, so the
        flight recorder can answer "why did this item never verify".

        Raises the ``RuntimeError`` that ended the drain loop, if one did."""
        if self._fault is not None:
            raise self._fault
        lane = self.lanes[lane_name]
        now = time.monotonic()
        victim = reason = None
        if len(lane) >= lane.config.max_queue:
            victim, reason = lane, "lane_full"
        elif self._total + self._inflight >= self.max_items:
            # in-flight items still occupy memory until their flush
            # finishes — admission that ignored them would overshoot the
            # budget by a whole round's worth of batches under flood
            victim = choose_shed_victim(self._order, lane)
            reason = "overload"
            if victim is None:
                # every queued item outranks the incoming one: drop it
                self._count_shed(lane, reason, now)
                if trace is not None:
                    trace.end(
                        "shed", {"reason": reason, "lane": lane_name}, now
                    )
                return [(source, item, reason)]
        shed: list = []
        if victim is not None:
            if victim is lane and lane.config.shed_newest:
                # parent-first lanes (blocks): keep the processable
                # prefix, drop the incoming item instead of an ancestor
                self._count_shed(lane, reason, now)
                if trace is not None:
                    trace.end(
                        "shed", {"reason": reason, "lane": lane_name}, now
                    )
                return [(source, item, reason)]
            old = victim.pop_oldest()
            if old is not None:
                self._total -= 1
                self._count_shed(victim, reason, now)
                if old[3] is not None:
                    old[3].end(
                        "shed",
                        {"reason": reason, "lane": victim.config.name},
                        now,
                    )
                shed.append((old[2], old[1], reason))
        lane.push(now, item, source, trace)
        if trace is not None:
            trace.note("enqueue", self._enqueue_args[lane_name], now)
        self._total += 1
        self._wake.set()
        return shed

    def _count_shed(self, lane: Lane, reason: str, now: float) -> None:
        get_metrics().inc("ingest_shed_count", lane=lane.config.name, reason=reason)
        if self.degraded.mark(now):
            # the latch FLIP, not the level: a sub-scrape-interval
            # degraded episode still increments, so it alerts
            if self._degraded_active:
                # the previous episode expired and re-latched between
                # drain-loop iterations (the only other exit observer):
                # emit its exit edge here so enter/exit stay paired and
                # engaged-time stays computable from counters alone
                get_metrics().inc(
                    "ingest_degraded_transitions_total", edge="exit"
                )
                get_recorder().record("inst", 0, "ingest_degraded_clear", {})
            self._degraded_active = True
            get_metrics().inc("ingest_degraded_transitions_total", edge="enter")
            get_recorder().record(
                "inst", 0, "ingest_degraded",
                {"lane": lane.config.name, "reason": reason},
            )
        self.metrics.set_gauge("ingest_degraded", 1.0)

    # ----------------------------------------------------------------- drain

    async def _run(self) -> None:
        try:
            await self._drain()
        except RuntimeError as exc:
            if not is_device_fault(exc):
                raise  # the supervisor restarts the loop
            # stored before any other coroutine runs, so the very next
            # submit() raises it; counted and put on the timeline once
            self._fault = exc
            get_metrics().inc("ingest_loop_crash_count")
            get_recorder().record(
                "inst", 0, "drain_fault",
                {"error": type(exc).__name__, "message": str(exc)},
            )
            raise

    async def _drain(self) -> None:
        m = get_metrics()
        # flushes only ever run inside this loop, so at (re)start nothing
        # can truly be in flight: any nonzero ledger is leakage from a
        # crash that abandoned a planned round after _take_batch — left
        # uncleared it would permanently shrink the admission budget and
        # turn every future submit into an "overload" shed (the
        # abandoned items' verdicts are already lost; the sidecar
        # expires unvalidated msg ids on its own timeout)
        self._inflight = 0
        while True:
            # clear BEFORE scanning: a submit landing mid-scan re-sets the
            # event and the next wait returns immediately (no lost wakeup)
            self._wake.clear()
            t0 = time.perf_counter()
            now = time.monotonic()
            self._update_degraded(now)
            ready = [lane for lane in self._order if lane.ready(now)]
            if not ready:
                timeout = self._sleep_budget(now)
                m.observe("ingest_sched_seconds", time.perf_counter() - t0)
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout)
                except asyncio.TimeoutError:
                    pass
                continue
            # one DRR round: deficit grows by weight, service is bounded
            # by min(deficit, depth, max_batch); priority order puts
            # blocks first every round
            plan = []
            for lane in ready:
                taken = self._take_batch(lane)
                if taken is not None:
                    plan.append(taken)
            m.observe("ingest_sched_seconds", time.perf_counter() - t0)
            i = 0
            while i < len(plan):
                lane, batch, cause = plan[i]
                # head-of-line guard: a more-important lane that became
                # ready while an earlier flush was in flight (a block
                # arriving mid-round) is served NOW — its wait is
                # bounded by one in-flight flush, not a whole round of
                # attestation flushes
                pre = self._preempting_batch(lane.config.priority)
                if pre is not None:
                    await self._flush(*pre, m)
                    continue
                await self._flush(lane, batch, cause, m)
                i += 1
            for lane in self._order:
                name = lane.config.name
                self.metrics.set_gauge("ingest_lane_depth", len(lane), lane=name)
                self.metrics.set_gauge(
                    "ingest_lane_occupancy", lane.occupancy(), lane=name
                )

    def _take_batch(self, lane: Lane):
        """Dequeue one DRR-bounded batch from a ready lane: ``(lane,
        batch, cause)``, or None when the deficit allows nothing."""
        cfg = lane.config
        lane.deficit = min(lane.deficit + cfg.weight, cfg.weight + cfg.max_batch)
        n = min(len(lane), lane.deficit, cfg.max_batch)
        cause = "full" if len(lane) >= cfg.coalesce_target else "deadline"
        if n <= 0:
            return None
        batch = lane.take(n)
        self._total -= len(batch)
        self._inflight += len(batch)  # released when the flush finishes
        lane.deficit = lane.deficit - len(batch) if len(lane) else 0
        return lane, batch, cause

    def _preempting_batch(self, priority: int):
        """A batch from the most important lane that is ready NOW and
        strictly outranks ``priority`` (None when nothing does)."""
        now = time.monotonic()
        for lane in self._order:
            if lane.config.priority >= priority:
                return None
            if lane.ready(now):
                taken = self._take_batch(lane)
                if taken is not None:
                    return taken
        return None

    def _sleep_budget(self, now: float) -> float | None:
        """Idle sleep until the earliest lane deadline (or the degraded
        latch expiry, so the gauge clears on time); None = wait for the
        next submit."""
        timeout = self.degraded.remaining(now)
        for lane in self._order:
            deadline = lane.next_deadline()
            if deadline is not None:
                until = max(deadline - now, 0.0)
                timeout = until if timeout is None else min(timeout, until)
        return timeout

    def _update_degraded(self, now: float) -> None:
        active = self.degraded.active(now)
        if self._degraded_active and not active:
            # the RELEASE edge (round-19 satellite): exactly one exit
            # increment per storm, mirroring the enter flip — the pair
            # makes "how long was admission control engaged" computable
            # from counters alone, scrape cadence notwithstanding
            self._degraded_active = False
            get_metrics().inc("ingest_degraded_transitions_total", edge="exit")
            get_recorder().record("inst", 0, "ingest_degraded_clear", {})
        self.metrics.set_gauge("ingest_degraded", 1.0 if active else 0.0)

    async def _flush(self, lane: Lane, batch: list, cause: str, m) -> None:
        """Hand one lane flush to its sources: items group by source (a
        lane can multiplex 64 subnet topics) preserving arrival order,
        and each group is ONE handler call — the device batch the
        coalescing exists to fill.  The batch stays on the in-flight
        admission ledger until this returns (cancel included): items
        held by a running flush still occupy memory."""
        name = lane.config.name
        now = time.monotonic()
        m.inc("ingest_flush_count", lane=name, cause=cause)
        # oldest-item wait = the flush's worst-case drain latency
        m.observe("ingest_flush_wait_seconds", now - batch[0][0], lane=name)
        groups: dict[int, list] = {}
        sources: dict[int, object] = {}
        # one dequeue-args dict SHARED by the whole flush's traces (the
        # per-item hot loop must not allocate per event)
        dq_args = {"lane": name, "cause": cause, "batch": len(batch)}
        for _arrival, item, source, trace in batch:
            if trace is not None:
                trace.note("dequeue", dq_args, now)
            groups.setdefault(id(source), []).append(item)
            sources[id(source)] = source
        try:
            for sid, items in groups.items():
                m.observe("ingest_batch_size", float(len(items)), lane=name)
                try:
                    await sources[sid].process(items)
                    self._flush_error_logged = False  # outage over: re-arm
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    if is_device_fault(exc):
                        raise  # a device fault ends the loop (no restart)
                    # a failed flush (port hiccup, handler bug) must not
                    # kill the scheduler — but it must be visible:
                    # counter per flush, one traceback per outage
                    m.inc("ingest_flush_error_count", value=len(items), lane=name)
                    # cold path: re-scan the batch for this group's
                    # traces rather than taxing the hot loop above with
                    # a parallel per-item structure
                    fe_args = {"lane": name}  # shared across the group
                    for _arrival, _item, source, trace in batch:
                        if trace is not None and id(source) == sid:
                            trace.end("flush_error", fe_args)
                    if not self._flush_error_logged:
                        self._flush_error_logged = True
                        log.exception("ingest flush failed on lane %s", name)
        finally:
            self._inflight -= len(batch)

    # -------------------------------------------------------------- debug

    def snapshot(self) -> dict:
        """Live scheduler/lane state for the ``/debug/lanes`` route —
        point-in-time reads only, no locking against the drain loop (the
        event loop serializes us with it)."""
        now = time.monotonic()
        lanes = []
        for lane in self._order:
            cfg = lane.config
            head = lane.head_arrival()
            lanes.append({
                "name": cfg.name,
                "priority": cfg.priority,
                "depth": len(lane),
                "capacity": cfg.max_queue,
                "occupancy": round(lane.occupancy(), 4),
                "deficit": lane.deficit,
                "weight": cfg.weight,
                "coalesce_target": cfg.coalesce_target,
                "deadline_s": cfg.deadline_s,
                "oldest_wait_s": (
                    None if head is None else round(now - head, 4)
                ),
                "ready": lane.ready(now),
            })
        return {
            "depth": self._total,
            "inflight": self._inflight,
            "max_items": self.max_items,
            "degraded": self.degraded.active(now),
            "lanes": lanes,
        }
