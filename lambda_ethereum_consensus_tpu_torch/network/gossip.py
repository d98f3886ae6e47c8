"""Gossip topic pipeline: batched decode/verify instead of one-at-a-time.

The reference processes gossip through Broadway with ``max_demand: 1`` — one
message at a time through snappy + SSZ + handler (ref: p2p/gossip_consumer.ex:
10-21).  Here each topic feeds a bounded queue drained in *batches*: one drain
decodes every queued message and hands the whole batch to the handler, which
can verify signatures as a single batched device dispatch (SURVEY.md §2.3:
"collect N gossip messages -> one batched verify").  Verdicts go back per
message, gating sidecar forwarding.

The port's copy of the JAX package's ``network/gossip.py``, on the port's
tracing and telemetry.  One divergence, the port's device-fault rule
(``faults.is_device_fault``): a device ``RuntimeError`` out of a handler is
never contained.  In a scheduler lane it ends the scheduler's drain loop; a
standalone topic's drain loop ends on it and :meth:`TopicSubscription.stop`
raises it.  Every other exception, a ``PortError`` during verdict dispatch
included, is contained and counted as in the JAX package.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

from ..compression.snappy import compress as snappy_compress
from ..compression.snappy import decompress as snappy_decompress
from ..config import ChainSpec, get_chain_spec
from ..faults import is_device_fault
from ..state_transition import misc
from ..telemetry import get_metrics, span
from ..tracing import get_recorder, new_trace
from .port import VERDICT_ACCEPT, VERDICT_IGNORE, VERDICT_REJECT, Port

log = logging.getLogger("gossip")

MAX_QUEUE = 1024
MAX_BATCH = 64
# shutdown bound on port.unsubscribe: a wedged/dead sidecar that still
# accepts writes would otherwise hold stop() for the full command
# timeout (30 s) PER TOPIC — 66 topics of it on a subnet-dense node
UNSUBSCRIBE_TIMEOUT_S = 2.0


def _topic_short(topic: str) -> str:
    """Metric label for a topic: the bare name (``beacon_block``), not the
    digest-bearing full path — label cardinality must not grow per fork."""
    parts = topic.split("/")
    return parts[3] if len(parts) >= 5 else topic


def topic_name(fork_digest: bytes, name: str) -> str:
    """``/eth2/<digest>/<name>/ssz_snappy`` (the reference hardcodes the
    capella digest — ref: p2p/gossipsub.ex:16-34; here it is computed)."""
    return f"/eth2/{fork_digest.hex()}/{name}/ssz_snappy"


def fork_topic(
    spec: ChainSpec,
    genesis_validators_root: bytes,
    name: str,
    epoch: int | None = None,
) -> str:
    """Topic path under the fork active at ``epoch`` (None keeps the
    historical capella pin — this helper long predated a fork schedule
    and hard-coded that digest)."""
    if epoch is None:
        epoch_version = spec.CAPELLA_FORK_VERSION
    else:
        epoch_version = spec.fork_version_at_epoch(int(epoch))
    digest = misc.compute_fork_digest(epoch_version, genesis_validators_root)
    return topic_name(digest, name)


@dataclass
class GossipMessage:
    msg_id: bytes
    payload: bytes  # decompressed SSZ bytes
    peer_id: bytes
    value: object | None = None  # decoded container (when ssz_type given)
    trace: object | None = None  # tracing.ItemTrace minted at admission


# trace-terminal args, prebuilt and SHARED across items (ItemTrace.end
# stores them without mutation): one dict per verdict, zero per-item
# allocations on the verdict-dispatch hot loop
_VERDICT_END_ARGS = {
    VERDICT_ACCEPT: {"verdict": "accept"},
    VERDICT_REJECT: {"verdict": "reject"},
    VERDICT_IGNORE: {"verdict": "ignore"},
}
_DECODE_END_ARGS = {"verdict": "reject"}
_QUEUE_FULL_ARGS = {"reason": "queue_full"}


BatchHandler = Callable[[list[GossipMessage]], Awaitable[list[int]]]


class TopicSubscription:
    """One topic's queue + batch-drain loop — or, when an ingest
    scheduler is given, one *lane producer*: arrivals are submitted to
    the shared priority scheduler (pipeline/scheduler.py) instead of a
    private queue, and this object becomes the lane's flush target
    (``process``/``shed``) for its topic."""

    def __init__(
        self,
        port: Port,
        topic: str,
        handler: BatchHandler,
        ssz_type=None,
        spec: ChainSpec | None = None,
        max_batch: int = MAX_BATCH,
        max_queue: int = MAX_QUEUE,
        metrics=None,
        scheduler=None,
        lane: str | None = None,
        sink: "SharedLaneSink | None" = None,
        node: str | None = None,
    ):
        """``max_batch`` bounds one drain's handler batch.  Attestation
        channels raise it by two orders of magnitude: the device RLC
        drain's fixed dispatch cost amortizes across thousands of
        signatures, so capping batches at 64 would cap the node's verify
        throughput at a fraction of the hardware's (VERDICT r4 next #1 —
        batch size IS the TPU economics)."""
        self.port = port
        self.topic = topic
        self.topic_label = _topic_short(topic)
        # the owning node's registry for PER-NODE gauges (queue depth is
        # a set(), so co-resident nodes would clobber a shared one); span
        # histograms and error counters stay on the default registry —
        # observe/inc aggregate correctly across nodes
        self.metrics = metrics if metrics is not None else get_metrics()
        self.handler = handler
        self.ssz_type = ssz_type
        self.spec = spec or get_chain_spec()
        self.max_batch = max_batch
        self.queue: asyncio.Queue = asyncio.Queue(max_queue)
        self._task: asyncio.Task | None = None
        # the device fault that ended the standalone drain loop: stop()
        # raises it
        self._fault: BaseException | None = None
        self._handler_error_logged = False  # one traceback per outage
        if scheduler is not None and lane is None:
            raise ValueError("scheduler mode requires a lane name")
        if sink is not None and scheduler is None:
            raise ValueError("a shared sink only makes sense in scheduler mode")
        self.scheduler = scheduler
        self.lane = lane
        self.sink = sink
        # node label for the flight recorder's per-node process rows (a
        # fleet's co-resident nodes share ONE ring; None = single-node)
        self.node = node
        # prebuilt standalone-enqueue trace args: the admission callback
        # runs at gossip arrival rate, so the per-item note must not
        # allocate (ItemTrace stores shared dicts without mutating them)
        self._enqueue_args = {"lane": self.topic_label}

    async def start(self) -> None:
        await self.port.subscribe(self.topic, self._on_gossip)
        if self.scheduler is None:
            # standalone mode: this topic drains itself.  In scheduler
            # mode the shared priority loop owns service order instead.
            self._task = asyncio.ensure_future(self._drain_loop())

    async def stop(self) -> None:
        """Unsubscribe and end the drain loop; raise the device fault that
        ended the standalone loop, if one did."""
        try:
            # bounded: a wedged sidecar must not hang node shutdown on
            # one topic's unsubscribe round-trip
            await asyncio.wait_for(
                self.port.unsubscribe(self.topic), UNSUBSCRIBE_TIMEOUT_S
            )
        except Exception:  # timeout or a dead port: shutdown proceeds
            log.warning(
                "unsubscribe(%s) failed or timed out during shutdown", self.topic
            )
        self.cancel()
        if self._fault is not None:
            raise self._fault

    def cancel(self) -> None:
        """Kill the drain loop without touching the port (dead-sidecar path)."""
        if self._task is not None:
            self._task.cancel()

    async def _on_gossip(self, topic, msg_id, payload, peer_id) -> None:
        # trace minted at ADMISSION (None when tracing is off): the item
        # tuple carries it end to end — lane, flush, decode, verify,
        # verdict — so "where did this message's budget go" is one
        # /debug/trace lookup instead of histogram archaeology
        trace = new_trace(self.topic_label, node=self.node)
        # wire trace context (round 22): the sender stamped (origin,
        # trace_id, hop, origin_ts) onto the frame and the Port parked it
        # under this msg_id.  Absent for old/interop senders — the fresh
        # local trace above is then the whole story (mixed-version path).
        pop = getattr(self.port, "pop_trace", None)
        wire = pop(msg_id) if pop is not None else None
        if wire is not None:
            self._admit_remote(trace, wire, peer_id)
        if self.scheduler is not None:
            # lane producer: admission (and any cross-lane shedding) is
            # the scheduler's call; this topic just dispatches the
            # IGNORE verdicts of whatever was evicted to admit us.  With
            # a shared sink the item carries its subscription so one
            # flush can span every topic on the lane.
            if self.sink is not None:
                source, item = self.sink, (self, msg_id, payload, peer_id, trace)
            else:
                source, item = self, (msg_id, payload, peer_id, trace)
            for src, it, reason in self.scheduler.submit(
                self.lane, item, source, trace=trace
            ):
                await src.shed(it, reason)
            return
        if self.queue.full():
            # backpressure: drop and ignore rather than grow unboundedly —
            # but COUNT it; a silent drop under overload is indistinguishable
            # from a hung pipeline on the dashboard
            get_metrics().inc(
                "gossip_shed_count", topic=self.topic_label, reason="queue_full"
            )
            if trace is not None:
                trace.end("shed", _QUEUE_FULL_ARGS)
            await self.port.validate_message(msg_id, VERDICT_IGNORE)
            return
        if trace is not None:
            trace.note("enqueue", self._enqueue_args)
        self.queue.put_nowait((msg_id, payload, peer_id, trace))

    def _admit_remote(self, trace, wire, peer_id: bytes) -> None:
        """Book a remotely-originated admission: per-peer delivery
        latency (+ the fleet block-propagation histogram for blocks),
        a ``remote_admit`` stage event carrying the origin's identity,
        and the Perfetto flow arrow binding this node's trace to the
        origin's publish (shared global id ``origin:trace_id``)."""
        origin, origin_tid, hop, origin_ts = wire
        delay = max(0.0, time.time() - origin_ts)
        m = get_metrics()
        if m._enabled:
            m.observe(
                "peer_delivery_latency_seconds", delay,
                peer=peer_id.hex()[:8], topic=self.topic_label,
            )
            if self.topic_label == "beacon_block":
                m.observe("fleet_block_propagation_seconds", delay)
        if trace is not None:
            flow = f"{origin}:{origin_tid}"
            trace.note("remote_admit", {
                "origin": origin, "origin_trace": origin_tid,
                "hop": hop, "flow": flow, "prop_s": round(delay, 4),
            })
            get_recorder().record(
                "flow_f", trace.trace_id, f"admit:{self.topic_label}",
                {"flow": flow, "origin": origin, "hop": hop},
                node=self.node,
            )

    # ------------------------------------------------- scheduler-lane target

    async def process(self, items: list) -> None:
        """One lane flush for this topic: the scheduler already shaped
        the batch (coalescing, DRR bound, shape snapping)."""
        await self._process_batch(items)

    async def shed(self, item, reason: str = "overload") -> None:
        """An admission-time eviction of one of this topic's queued
        messages: count it (under the scheduler's OWN reason, so the
        per-topic and per-lane shed series never disagree on cause) and
        IGNORE so the sidecar forgets the id."""
        msg_id = item[0]
        get_metrics().inc(
            "gossip_shed_count", topic=self.topic_label, reason=reason
        )
        await self.port.validate_message(msg_id, VERDICT_IGNORE)

    async def _drain_loop(self) -> None:
        while True:
            batch = [await self.queue.get()]
            while len(batch) < self.max_batch and not self.queue.empty():
                batch.append(self.queue.get_nowait())
            try:
                await self._process_batch(batch)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if is_device_fault(exc):
                    # surfaced, never contained: the loop ends here and
                    # stop() raises it
                    self._fault = exc
                    log.error("gossip drain on %s ended by a device fault",
                              self.topic, exc_info=exc)
                    return
                # a failed batch (port hiccup, handler bug) must not kill
                # the topic — messages in it are simply never validated/
                # forwarded — but it must be VISIBLE: a silently swallowed
                # handler bug looks like a hung pipeline from outside
                log.exception("gossip batch failed on %s", self.topic)
                continue

    async def _process_batch(self, raw_batch) -> None:
        if self.scheduler is None:
            # queue depth at drain start: sustained growth here is the
            # first sign the verify path cannot keep up with gossip
            # arrival (scheduler mode reports ingest_lane_depth instead)
            self.metrics.set_gauge(
                "gossip_queue_depth", self.queue.qsize(), topic=self.topic_label
            )
        with span("gossip_drain", topic=self.topic_label):
            await _drain_decode_verify(
                self,
                [(self, m, p, pe, tr) for m, p, pe, tr in raw_batch],
                # this topic's handler keeps its one-subscription shape
                lambda pairs: self.handler([msg for _, msg in pairs]),
                metric_topic=self.topic_label,
                log_name=self.topic,
            )


async def _drain_decode_verify(
    owner, items, handler, metric_topic: str, log_name: str
) -> None:
    """The shared drain tail of both flush targets
    (``TopicSubscription._process_batch`` and ``SharedLaneSink.process``
    — two call sites, ONE policy): raw-snappy decode with REJECT on any
    failure of attacker-controlled bytes (ref: gossip_consumer.ex:36
    :snappyer), one handler call, error containment (every item in a
    raising batch drops to IGNORE, counted on
    ``gossip_batch_error_count`` — ADVICE r5: silent drops look like a
    hung pipeline — with one traceback per outage via ``owner``'s
    latch, not one per drain), short-verdict padding, and per-message
    verdict dispatch.

    ``items`` are ``(subscription, msg_id, payload, peer_id, trace)``;
    ``handler`` receives ``[(subscription, GossipMessage)]`` pairs.
    """
    pairs: list[tuple] = []
    for sub, msg_id, payload, peer_id, trace in items:
        try:
            data = snappy_decompress(payload)
            value = (
                sub.ssz_type.decode(data, sub.spec)
                if sub.ssz_type is not None
                else None
            )
        except Exception:
            if trace is not None:
                trace.end("decode_error", _DECODE_END_ARGS)
            await sub.port.validate_message(msg_id, VERDICT_REJECT)
            continue
        pairs.append((sub, GossipMessage(msg_id, data, peer_id, value, trace)))
    if not pairs:
        return
    handler_failed = False
    try:
        verdicts = list(await handler(pairs))
        owner._handler_error_logged = False  # outage over: re-arm
    except Exception as exc:
        if is_device_fault(exc):
            raise  # a device fault is surfaced, never contained
        handler_failed = True
        get_metrics().inc(
            "gossip_batch_error_count",
            value=len(pairs),
            stage="drain",
            topic=metric_topic,
        )
        if not owner._handler_error_logged:
            owner._handler_error_logged = True
            log.exception("gossip handler failed on %s", log_name)
        verdicts = [VERDICT_IGNORE] * len(pairs)
    if len(verdicts) < len(pairs):  # short handler output: ignore rest
        verdicts += [VERDICT_IGNORE] * (len(pairs) - len(verdicts))
    end_ts = time.monotonic()  # one clock read for the whole batch
    end_stage = "error" if handler_failed else "done"
    for (sub, msg), verdict in zip(pairs, verdicts):
        if msg.trace is not None:
            msg.trace.end(
                end_stage,
                _VERDICT_END_ARGS.get(verdict) or {"verdict": str(verdict)},
                end_ts,
            )
        await sub.port.validate_message(msg.msg_id, verdict)


class SharedLaneSink:
    """One flush target multiplexing MANY topics of one lane.

    Per-source flush grouping would fragment a coalesced lane batch
    back into per-topic handler calls — 64 subnet topics sharing a lane
    would turn a 128-item flush into 64 two-item device dispatches,
    exactly the batch-of-2 economics the scheduler exists to fix.  A
    sink makes the whole flush ONE handler call: items arrive as
    ``(subscription, msg_id, payload, peer_id, trace)``, decode runs per item
    under each subscription's ssz_type/spec, and ``handler`` receives
    ``[(subscription, GossipMessage)]`` pairs so e.g. the node can
    resolve each vote's subnet while verifying every signature in one
    batched RLC check.
    """

    def __init__(self, handler, label: str):
        self.handler = handler
        self.label = label  # gossip_drain span / error-counter topic label
        self._handler_error_logged = False

    async def shed(self, item, reason: str = "overload") -> None:
        sub = item[0]
        await sub.shed(item[1:], reason)

    async def process(self, items: list) -> None:
        with span("gossip_drain", topic=self.label):
            await _drain_decode_verify(
                self, items, self.handler,
                metric_topic=self.label, log_name=self.label,
            )


async def publish_ssz(
    port: Port,
    topic: str,
    value,
    spec: ChainSpec | None = None,
    *,
    node: str | None = None,
) -> None:
    """SSZ-encode + raw-snappy-compress + publish.

    With a ``node`` label (round 22), the publish is stamped with a
    wire trace context ``(node, trace_id, hop=0, time.time())`` and a
    Perfetto flow-start arrow is recorded under the same global id —
    every remote admission of this message binds back to this instant
    in the merged fleet export.  Label-less publishes stay unstamped
    (the pre-round-22 wire, byte for byte)."""
    spec = spec or get_chain_spec()
    port_payload = snappy_compress(value.encode(spec))
    trace_ctx = None
    rec = get_recorder()
    if node is not None and rec.enabled:
        trace_id = rec.new_id()
        trace_ctx = (node, trace_id, 0, time.time())
        rec.record(
            "flow_s", trace_id, f"publish:{_topic_short(topic)}",
            {"flow": f"{node}:{trace_id}"}, node=node,
        )
    if trace_ctx is not None:
        await port.publish(topic, port_payload, trace_ctx)
    else:
        # positional-compat: test doubles often stub a 2-arg publish
        await port.publish(topic, port_payload)
