"""Host-side manager of the network sidecar (ref: lib/libp2p_port.ex); the
port's copy of the JAX package's ``network/port.py``.

Spawns the sidecar subprocess, frames ``Command`` protobufs over its stdin,
and routes ``Notification`` frames back: command results resolve awaiting
futures (the reference serializes caller pids into the protobuf instead —
libp2p_port.ex:199-234); gossip/request/peer events invoke registered
handlers.  Sidecar death fails all pending futures and fires ``on_exit`` so a
supervisor can restart it (parity with the ``:exit_status`` handling at
libp2p_port.ex:232-234).

Changes from the JAX package: the sidecar spawned is this package's
(``python -m lambda_ethereum_consensus_tpu_torch.network.sidecar``, which
imports no ``torch``); ``PORT_RETRY_MAX`` is a module constant, read at each
command, not an environment variable; and ``wire="libp2p"`` raises
``NotImplementedError`` until the libp2p sidecar is ported, so the libp2p
wire's ``attnets``/``syncnets`` arguments and its ENR are not ported.  The sidecar
always runs noise: without ``cryptography`` its ``init`` fails and
:meth:`Port.start` raises :class:`PortError`.  ``PortError`` derives from
``faults.WireError``: still a ``RuntimeError``, never a device fault.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import struct
import sys
from collections import OrderedDict
from typing import Awaitable, Callable

from ..faults import WireError
from ..telemetry import get_metrics, span
from .proto import port_pb2

VERDICT_ACCEPT = port_pb2.ValidateMessage.ACCEPT
VERDICT_REJECT = port_pb2.ValidateMessage.REJECT
VERDICT_IGNORE = port_pb2.ValidateMessage.IGNORE

Handler = Callable[..., Awaitable[None] | None]

# Bounded retry-with-backoff for transient command failures (round 19):
# a sidecar hiccup (one failed dial mid-churn, a dropped result frame,
# one timed-out round-trip) should cost a retry, not a dead subscription
# — while a persistent failure must still raise after the bounded
# attempts so callers see real outages.  Exponential backoff with full
# jitter; retries are skipped outright once the sidecar is dead (the
# supervisor rebuilds the whole Port then — re-sending into a corpse
# would just burn the backoff schedule).
PORT_RETRY_MAX = 2
PORT_RETRY_BASE_S = 0.05


class PortError(WireError):
    pass


class PortCommandError(PortError):
    """The sidecar processed the command and said no (``result.ok``
    false).  Deterministic — never retried: re-sending a rejected
    command cannot change the answer, only mislabel a permanent error
    as transient in ``port_retry_total``."""


class Port:
    """One sidecar process + its control channel."""

    def __init__(self):
        self._proc: asyncio.subprocess.Process | None = None
        self._pending: dict[bytes, asyncio.Future] = {}
        self._counter = 0
        self._dead = False
        self._closed = False
        self._reader_task: asyncio.Task | None = None
        self.listen_port: int | None = None
        self.node_id: bytes | None = None
        # handler registries
        self.gossip_handlers: dict[str, Handler] = {}
        self.request_handlers: dict[str, Handler] = {}
        self._on_new_peer: Handler | None = None
        self._on_peer_gone: Handler | None = None
        self.on_exit: Handler | None = None
        # Cross-node trace contexts delivered alongside gossip (round 22).
        # Handlers keep their 4-arg (topic, msg_id, payload, peer) signature
        # — the optional wire trace is parked here keyed by msg_id and
        # retrieved via pop_trace() by whoever mints the local ItemTrace.
        # Bounded: an un-popped entry (handler predates tracing) must not
        # grow without limit.
        self._gossip_traces: OrderedDict[bytes, tuple[str, int, int, float]] = (
            OrderedDict()
        )
        # peer events that raced handler assignment: the sidecar dials
        # bootnodes during init, so on a fast loopback a new_peer
        # notification can land before the node wires on_new_peer —
        # dropping it would leave the host-side peerbook empty (and
        # range sync idle) while the sidecar is happily connected.
        # Buffer them and replay on handler assignment.
        self._early_peer_events: list[tuple[str, tuple]] = []

    # -------------------------------------------------- peer-event handlers

    @property
    def on_new_peer(self) -> Handler | None:
        return self._on_new_peer

    @on_new_peer.setter
    def on_new_peer(self, handler: Handler | None) -> None:
        self._on_new_peer = handler
        self._drain_early()

    @property
    def on_peer_gone(self) -> Handler | None:
        return self._on_peer_gone

    @on_peer_gone.setter
    def on_peer_gone(self, handler: Handler | None) -> None:
        self._on_peer_gone = handler
        self._drain_early()

    _EARLY_PEER_EVENTS_MAX = 256

    def _buffer_early(self, kind: str, args: tuple) -> None:
        if len(self._early_peer_events) < self._EARLY_PEER_EVENTS_MAX:
            self._early_peer_events.append((kind, args))

    def _drain_early(self) -> None:
        """Replay buffered peer events in ARRIVAL order, stopping at the
        first event whose handler is still unset — a connect/disconnect
        pair buffered during init must not replay as disconnect-last-wins
        for a peer that is actually connected.  The node assigns both
        handlers back to back, so the second assignment drains the rest."""
        handlers = {"new_peer": self._on_new_peer, "peer_gone": self._on_peer_gone}
        while self._early_peer_events:
            kind, args = self._early_peer_events[0]
            handler = handlers[kind]
            if handler is None:
                return
            self._early_peer_events.pop(0)
            self._spawn(handler, *args)

    # ------------------------------------------------------------ lifecycle

    @classmethod
    async def start(
        cls,
        listen_addr: str = "127.0.0.1:0",
        bootnodes: list[str] | None = None,
        fork_digest: bytes = b"",
        enable_peer_exchange: bool = True,
        key_file: str | None = None,
        wire: str | None = None,
    ) -> "Port":
        if wire == "libp2p":
            raise NotImplementedError(
                "the libp2p wire is not ported yet (ROADMAP.md Queue 1 item 4); "
                "wire=None runs the bespoke-frame sidecar"
            )
        self = cls()
        env = dict(os.environ)
        if key_file:
            # persistent noise identity: without it, a restart rotates the
            # static key and a graylisted peer sheds its ban (ADVICE r2)
            env.setdefault("SIDECAR_KEY_FILE", key_file)
        self._proc = await asyncio.create_subprocess_exec(
            sys.executable,
            "-m",
            "lambda_ethereum_consensus_tpu_torch.network.sidecar",
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
            env=env,
        )
        self._reader_task = asyncio.ensure_future(self._read_loop())
        try:
            cmd = port_pb2.Command()
            cmd.init.listen_addr = listen_addr
            cmd.init.bootnodes.extend(bootnodes or [])
            cmd.init.enable_peer_exchange = enable_peer_exchange
            cmd.init.fork_digest = fork_digest.hex()
            # handshake commands never retry: a re-sent init would bind a
            # second listener in the sidecar, and a failed handshake tears
            # the whole Port down anyway (the except below)
            result = await self._command(cmd, retries=0)
            self.listen_port = int(result.payload.decode())  # "<port>"
            ident = port_pb2.Command()
            ident.get_node_identity.SetInParent()
            self.node_id = (await self._command(ident, retries=0)).payload
        except BaseException:
            # failed handshake must not leak the subprocess / reader task
            await self.close()
            raise
        return self

    async def close(self) -> None:
        self._dead = True
        self._closed = True  # deliberate shutdown: suppress on_exit
        if self._proc is not None:
            if self._proc.stdin is not None:
                self._proc.stdin.close()
            if self._proc.returncode is None:
                self._proc.kill()
            await self._proc.wait()
        if self._reader_task is not None:
            self._reader_task.cancel()

    @property
    def alive(self) -> bool:
        return (
            not self._dead
            and self._proc is not None
            and self._proc.returncode is None
        )

    # ------------------------------------------------------------- commands

    async def _command(
        self,
        cmd: port_pb2.Command,
        timeout: float = 30,
        retries: int | None = None,
    ) -> port_pb2.Result:
        """One command with bounded transient-failure retries.

        Every attempt is a full :meth:`_roundtrip` (fresh command id, own
        span sample); a failed attempt counts on
        ``port_retry_total{command}`` before the backoff sleep.  Retries
        stop early when the sidecar is no longer alive — those failures
        are terminal for this Port instance, the restart supervisor owns
        what happens next."""
        if retries is None:
            retries = PORT_RETRY_MAX
        attempt = 0
        while True:
            try:
                return await self._roundtrip(cmd, timeout)
            except PortCommandError:
                raise  # deterministic rejection: retrying cannot help
            except (PortError, asyncio.TimeoutError):
                if attempt >= retries or not self.alive:
                    raise
                attempt += 1
                get_metrics().inc(
                    "port_retry_total",
                    command=cmd.WhichOneof("c") or "unknown",
                )
                base = PORT_RETRY_BASE_S * (2 ** (attempt - 1))
                # full jitter: concurrent retriers (66 topic subscriptions
                # behind one hiccup) must not re-dogpile in lockstep
                await asyncio.sleep(base * (1.0 + random.random()))

    async def _roundtrip(self, cmd: port_pb2.Command, timeout: float) -> port_pb2.Result:
        if not self.alive:
            raise PortError("sidecar is not running")
        self._counter += 1
        cmd_id = self._counter.to_bytes(8, "big")
        cmd.id = cmd_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[cmd_id] = fut
        raw = cmd.SerializeToString()
        assert self._proc is not None and self._proc.stdin is not None
        # the span covers write -> matching Result frame: the honest wall
        # clock a caller waits on one sidecar round-trip, queueing
        # included.  The slow-op threshold scales with the command's own
        # timeout: send_request legitimately spends seconds on a remote
        # peer during range sync, and the default 1 s bar would emit one
        # WARNING per request for hours — only a round-trip nearing its
        # deadline is an anomaly worth a log line (the histogram carries
        # the full latency distribution regardless)
        with span(
            "sidecar_roundtrip",
            slow=timeout * 0.8,
            command=cmd.WhichOneof("c") or "unknown",
        ):
            self._proc.stdin.write(struct.pack(">I", len(raw)) + raw)
            await self._proc.stdin.drain()
            try:
                result: port_pb2.Result = await asyncio.wait_for(fut, timeout)
            finally:
                self._pending.pop(cmd_id, None)
        if not result.ok:
            raise PortCommandError(result.error or "sidecar command failed")
        return result

    async def add_peer(self, addr: str) -> None:
        cmd = port_pb2.Command()
        cmd.add_peer.addr = addr
        await self._command(cmd)

    async def subscribe(self, topic: str, handler: Handler) -> None:
        self.gossip_handlers[topic] = handler
        cmd = port_pb2.Command()
        cmd.subscribe.topic = topic
        await self._command(cmd)

    async def unsubscribe(self, topic: str) -> None:
        self.gossip_handlers.pop(topic, None)
        cmd = port_pb2.Command()
        cmd.unsubscribe.topic = topic
        await self._command(cmd)

    async def publish(
        self,
        topic: str,
        payload: bytes,
        trace: tuple[str, int, int, float] | None = None,
    ) -> None:
        """Publish, optionally stamping a ``(origin, trace_id, hop,
        origin_ts)`` trace context onto the wire frame so remote admission
        can attribute the message back to this node's ItemTrace."""
        cmd = port_pb2.Command()
        cmd.publish.topic = topic
        cmd.publish.payload = payload
        if trace is not None:
            origin, trace_id, hop, origin_ts = trace
            cmd.publish.trace.origin = origin
            cmd.publish.trace.trace_id = trace_id
            cmd.publish.trace.hop = hop
            cmd.publish.trace.origin_ts = origin_ts
        await self._command(cmd)

    async def validate_message(self, msg_id: bytes, verdict: int) -> None:
        cmd = port_pb2.Command()
        cmd.validate_message.msg_id = msg_id
        cmd.validate_message.verdict = verdict
        await self._command(cmd)

    async def set_request_handler(self, protocol_id: str, handler: Handler) -> None:
        self.request_handlers[protocol_id] = handler
        cmd = port_pb2.Command()
        cmd.set_request_handler.protocol_id = protocol_id
        await self._command(cmd)

    async def send_request(
        self, peer_id: bytes, protocol_id: str, payload: bytes, timeout_ms: int = 15000
    ) -> bytes:
        cmd = port_pb2.Command()
        cmd.send_request.peer_id = peer_id
        cmd.send_request.protocol_id = protocol_id
        cmd.send_request.payload = payload
        cmd.send_request.timeout_ms = timeout_ms
        # no retries: the dominant failure here is the REMOTE peer not
        # answering, which already burned the full timeout_ms — stacking
        # the backoff schedule on top would make range sync wait ~3x the
        # budget per bad peer before trying the next one
        result = await self._command(cmd, timeout=timeout_ms / 1000 + 5, retries=0)
        return result.payload

    async def send_response(self, request_id: bytes, payload: bytes) -> None:
        cmd = port_pb2.Command()
        cmd.send_response.request_id = request_id
        cmd.send_response.payload = payload
        await self._command(cmd)

    async def get_gossip_stats(self) -> dict:
        """Per-(peer, topic) gossip-health snapshot from the sidecar.

        Returns ``{}`` against a sidecar that predates the command
        (mixed-version fleet) — peer-health metrics simply stay empty
        rather than failing the node's tick loop."""
        cmd = port_pb2.Command()
        cmd.get_gossip_stats.SetInParent()
        try:
            result = await self._command(cmd)
        except PortCommandError:
            return {}
        try:
            return json.loads(result.payload.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            return {}

    # -------------------------------------------------------- notifications

    async def _read_loop(self) -> None:
        assert self._proc is not None and self._proc.stdout is not None
        try:
            while True:
                head = await self._proc.stdout.readexactly(4)
                (length,) = struct.unpack(">I", head)
                raw = await self._proc.stdout.readexactly(length)
                await self._dispatch(port_pb2.Notification.FromString(raw))
        except (asyncio.IncompleteReadError, asyncio.CancelledError):
            pass
        finally:
            self._dead = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(PortError("sidecar exited"))
            self._pending.clear()
            # only an *unexpected* death triggers the restart hook
            if self.on_exit is not None and not self._closed:
                await _maybe_await(self.on_exit())

    async def _dispatch(self, n: port_pb2.Notification) -> None:
        # Results resolve futures inline; everything else runs as a task —
        # a handler that itself issues commands (e.g. validate_message) would
        # otherwise deadlock against this read loop.
        which = n.WhichOneof("n")
        if which == "result":
            fut = self._pending.get(n.result.id)
            if fut is not None and not fut.done():
                fut.set_result(n.result)
        elif which == "gossip":
            handler = self.gossip_handlers.get(n.gossip.topic)
            if handler is None:
                self._spawn(self.validate_message, n.gossip.msg_id, VERDICT_IGNORE)
            else:
                if n.gossip.HasField("trace"):
                    t = n.gossip.trace
                    self._stash_trace(
                        n.gossip.msg_id,
                        (t.origin, t.trace_id, t.hop, t.origin_ts),
                    )
                self._spawn(
                    handler,
                    n.gossip.topic, n.gossip.msg_id, n.gossip.payload, n.gossip.peer_id,
                )
        elif which == "request":
            handler = self.request_handlers.get(n.request.protocol_id)
            if handler is not None:
                self._spawn(
                    handler,
                    n.request.protocol_id,
                    n.request.request_id,
                    n.request.payload,
                    n.request.peer_id,
                )
        elif which == "new_peer":
            if self.on_new_peer is not None:
                self._spawn(self.on_new_peer, n.new_peer.peer_id, n.new_peer.addr)
            else:
                self._buffer_early("new_peer", (n.new_peer.peer_id, n.new_peer.addr))
        elif which == "peer_gone":
            if self.on_peer_gone is not None:
                self._spawn(self.on_peer_gone, n.peer_gone.peer_id)
            else:
                self._buffer_early("peer_gone", (n.peer_gone.peer_id,))

    _GOSSIP_TRACES_MAX = 512

    def _stash_trace(self, msg_id: bytes, trace: tuple[str, int, int, float]) -> None:
        self._gossip_traces[msg_id] = trace
        while len(self._gossip_traces) > self._GOSSIP_TRACES_MAX:
            self._gossip_traces.popitem(last=False)

    def pop_trace(self, msg_id: bytes) -> tuple[str, int, int, float] | None:
        """Claim the wire trace context delivered with ``msg_id``'s gossip
        notification, or None when the sender omitted it (old node, interop
        peer) — the caller then mints a fresh local trace."""
        return self._gossip_traces.pop(msg_id, None)

    @staticmethod
    def _spawn(handler, *args) -> None:
        """Run a (possibly sync) handler without blocking — or killing — the
        read loop: a raising callback must not declare the sidecar dead."""
        try:
            value = handler(*args)
        except Exception:
            logging.getLogger("network.port").exception("notification handler failed")
            return
        if asyncio.iscoroutine(value):
            task = asyncio.ensure_future(value)
            task.add_done_callback(_log_task_exception)


def _log_task_exception(task: asyncio.Task) -> None:
    if not task.cancelled() and task.exception() is not None:
        logging.getLogger("network.port").error(
            "async notification handler failed", exc_info=task.exception()
        )


async def _maybe_await(value):
    if asyncio.iscoroutine(value) or isinstance(value, asyncio.Future):
        return await value
    return value
