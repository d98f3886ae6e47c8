"""Network sidecar process: TCP p2p + framed-protobuf stdio control plane.

The port's copy of the JAX package's bespoke-frame sidecar
(``network/sidecar.py``); the two speak the same wire and interoperate.  Run
as ``python -m lambda_ethereum_consensus_tpu_torch.network.sidecar`` (what
``Port.start`` does).  It imports no ``torch``: the process does no device
work.  Fills the role of the reference's Go libp2p binary (ref:
native/libp2p_port/main.go):

- stdio: 4-byte big-endian length frames carrying ``Command`` in and
  ``Notification`` out (the reference's ``{:packet, 4}`` port contract).
- p2p: TCP with a HELLO handshake (fork-digest filtered — the job discv5 ENR
  filtering does in the reference), gossipsub-style MESH routing with
  peer scoring, seen-cache dedup and host-gated validation (mirroring the
  blocking topic validator, subscriptions.go:95-135), correlated
  req/resp, and peer exchange.

Mesh (replacing round 1's flood): per subscribed topic the sidecar keeps
a mesh of D=8 peers (D_lo=6 .. D_hi=12), maintained by a 700 ms heartbeat
(the reference's eth2 gossipsub params, subscriptions.go:31-77) with
GRAFT/PRUNE control frames; full messages flow only along mesh links.
Peer scores are fed by the HOST's validation verdicts — REJECT costs
``REJECT_PENALTY``, sustained misbehavior crosses ``GRAYLIST_SCORE`` and
the peer is disconnected — and decay toward zero each heartbeat.

The p2p transport is deliberately contained behind this process boundary so a
full libp2p implementation can replace it without touching the host runtime.

Every connection runs the Noise XX handshake before its HELLO.  One
divergence from the JAX package: the sidecar never falls back to plaintext
(without ``cryptography`` its ``init`` command fails, so ``Port.start``
raises).  ``SIDECAR_WIRE=libp2p`` runs ``sidecar_libp2p.main`` instead, as
in the JAX package.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import struct
import sys
from collections import OrderedDict

# every peer.send_frame() containment site must also catch NoiseError
# (encrypt can refuse: nonce exhausted, unfinalized session) or one bad peer
# kills a whole broadcast loop
from . import noise
from .noise import NoiseError, handshake
from .proto import p2p_pb2, port_pb2

MAX_FRAME = 1 << 28
GOSSIP_SEEN_CAP = 4096
MAX_DIALED_FROM_EXCHANGE = 32

# Gossipsub-style mesh parameters (ref: subscriptions.go:31-77 — the
# reference's eth2-tuned go-libp2p-pubsub config).
MESH_D = 8
MESH_D_LO = 6
MESH_D_HI = 12
HEARTBEAT_S = 0.7
# Verdict-fed scoring: REJECT is a protocol violation; scores decay
# toward 0 each heartbeat so old behavior washes out.  Negative scores
# decay far slower (ADVICE r2: 0.95/0.7s forgave a graylist in ~15 s;
# the reference retains negative scores for ~100 epochs) — at 0.9995 a
# -120 graylist stays below the -40 prune bar for ~25 min.
ACCEPT_REWARD = 1.0
REJECT_PENALTY = 40.0
SCORE_DECAY = 0.95
BAN_DECAY = 0.9995
MAX_SCORE = 100.0
PRUNE_SCORE = -40.0     # below: never grafted, pruned from meshes
GRAYLIST_SCORE = -80.0  # below: disconnected outright
# Topic-scoped peer exchange cadence (in heartbeats): subscribers of a
# topic are introduced to each other even when the local node does not
# subscribe, so a relay-only middle node cannot partition that topic
# (ADVICE r2 — real gossipsub heals such gaps with control traffic).
SUBSCRIBER_PX_EVERY = 10


def _msg_id(topic: str, payload: bytes) -> bytes:
    """Gossip message id (sha256 prefix, like eth2's MsgID —
    subscriptions.go SHA256-based MsgID).  Deliberately EXCLUDES the
    optional trace context: the same payload republished with a
    different trace stamp must still dedup as one message."""
    return hashlib.sha256(topic.encode() + b"\x00" + payload).digest()[:20]


def _copy_trace(dst, src) -> None:
    """Field-wise copy between the p2p and port TraceCtx twins (distinct
    generated types with identical shape)."""
    dst.origin = src.origin
    dst.trace_id = src.trace_id
    dst.hop = src.hop
    dst.origin_ts = src.origin_ts


class Peer:
    def __init__(self, reader, writer, conn_id: int):
        self.reader = reader
        self.writer = writer
        self.conn_id = conn_id
        self.node_id = b""
        self.listen_port = 0
        self.addr = ""
        self.send_lock = asyncio.Lock()
        self.topics: set[str] = set()  # the peer's announced subscriptions
        self.score = 0.0
        self.noise = None  # NoiseSession after the handshake

    async def send_frame(self, frame: p2p_pb2.P2PFrame) -> None:
        raw = frame.SerializeToString()
        async with self.send_lock:
            # the lock also serializes AEAD nonces (counter per direction)
            try:
                raw = self.noise.encrypt(raw)
            except NoiseError:
                # the send direction is unrecoverable (nonce exhausted /
                # cipher desync) but the TCP side may look healthy: close
                # so run_peer's read loop tears the peer down — containment
                # sites that swallow the raise must not leave a zombie mesh
                # member that blackholes gossip
                self.writer.close()
                raise
            self.writer.write(struct.pack(">I", len(raw)) + raw)
            await self.writer.drain()


class Sidecar:
    def __init__(self):
        self.node_id = b""
        self.fork_digest = ""
        self.listen_port = 0
        self.enable_peer_exchange = True
        self.peers: dict[bytes, Peer] = {}  # node_id -> peer
        self.subscriptions: set[str] = set()
        self.mesh: dict[str, set[bytes]] = {}  # topic -> mesh peer ids
        # negative scores survive disconnection (else a graylisted peer
        # resets its score with one TCP reconnect); decayed per heartbeat
        # and dropped once back above the prune threshold
        self.ban_scores: dict[bytes, float] = {}
        # Noise transport static key, set by the init command.  The node
        # identity IS the static key (sha256 of the public key), so a
        # graylisted peer cannot shed its ban by re-rolling a random node_id
        # — rotation costs a keypair and the HELLO is checked against the
        # authenticated channel.
        self.noise_static = None
        self.handlers: set[str] = set()  # protocol ids served by the host
        self.seen: OrderedDict[bytes, None] = OrderedDict()
        # msg_id -> (topic, payload, source, trace); capped — an evicted entry
        # means the verdict never came, so the message is simply never forwarded
        self.pending_validation: OrderedDict[bytes, tuple] = OrderedDict()
        # per-peer gossip health (round 22 fleet observatory): duplicates
        # dedup HERE and never reach the host, so first/duplicate counts
        # must be tallied at the wire and exported via get_gossip_stats
        self.delivery_stats: dict[tuple[bytes, str], list[int]] = {}
        self.control_stats: dict[str, int] = {}  # graft/prune sent/recv
        # req_id -> (command id, peer node_id): responses only count from the
        # peer the request went to (no cross-peer response forgery)
        self.pending_requests: dict[bytes, tuple[bytes, bytes]] = {}
        self.incoming_requests: dict[bytes, Peer] = {}  # request_id -> peer
        self.known_addrs: set[str] = set()
        self.stdout_lock = asyncio.Lock()
        self._conn_counter = 0
        self._req_counter = 0

    # ------------------------------------------------------------- stdio

    async def notify(self, notification: port_pb2.Notification) -> None:
        raw = notification.SerializeToString()
        async with self.stdout_lock:
            sys.stdout.buffer.write(struct.pack(">I", len(raw)) + raw)
            sys.stdout.buffer.flush()

    async def result(self, cmd_id: bytes, ok: bool, payload: bytes = b"", error: str = "") -> None:
        n = port_pb2.Notification()
        n.result.id = cmd_id
        n.result.ok = ok
        n.result.payload = payload
        n.result.error = error
        await self.notify(n)

    async def command_loop(self) -> None:
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin.buffer
        )
        while True:
            head = await reader.readexactly(4)
            (length,) = struct.unpack(">I", head)
            if length > MAX_FRAME:
                raise RuntimeError("oversized command frame")
            raw = await reader.readexactly(length)
            cmd = port_pb2.Command.FromString(raw)
            try:
                await self.handle_command(cmd)
            except Exception as e:  # command errors must not kill the sidecar
                await self.result(cmd.id, False, error=f"{type(e).__name__}: {e}")

    async def handle_command(self, cmd: port_pb2.Command) -> None:
        which = cmd.WhichOneof("c")
        if which == "init":
            await self.handle_init(cmd)
        elif which == "get_node_identity":
            await self.result(cmd.id, True, payload=self.node_id)
        elif which == "add_peer":
            ok, err = await self.dial(cmd.add_peer.addr)
            await self.result(cmd.id, ok, error=err)
        elif which == "subscribe":
            topic = cmd.subscribe.topic
            self.subscriptions.add(topic)
            self.mesh.setdefault(topic, set())
            await self._announce_sub(topic, True)
            await self._mesh_maintain(topic)
            await self.result(cmd.id, True)
        elif which == "unsubscribe":
            topic = cmd.unsubscribe.topic
            self.subscriptions.discard(topic)
            for nid in self.mesh.pop(topic, set()):
                peer = self.peers.get(nid)
                if peer is not None:
                    await self._send_control(peer, "prune", topic)
            await self._announce_sub(topic, False)
            await self.result(cmd.id, True)
        elif which == "publish":
            trace = (
                cmd.publish.trace if cmd.publish.HasField("trace") else None
            )
            await self.publish(cmd.publish.topic, cmd.publish.payload, trace)
            await self.result(cmd.id, True)
        elif which == "validate_message":
            await self.finish_validation(
                cmd.validate_message.msg_id, cmd.validate_message.verdict
            )
            await self.result(cmd.id, True)
        elif which == "set_request_handler":
            self.handlers.add(cmd.set_request_handler.protocol_id)
            await self.result(cmd.id, True)
        elif which == "get_gossip_stats":
            await self.result(
                cmd.id, True, payload=json.dumps(self.gossip_stats()).encode()
            )
        elif which == "send_request":
            await self.send_request(cmd)
        elif which == "send_response":
            await self.send_response(cmd)
        else:
            await self.result(cmd.id, False, error=f"unknown command {which}")

    async def handle_init(self, cmd: port_pb2.Command) -> None:
        args = cmd.init
        # raises without `cryptography`: the init fails, never plaintext
        self.noise_static = _static_key(os.environ.get("SIDECAR_KEY_FILE"))
        self.node_id = hashlib.sha256(noise._pub(self.noise_static)).digest()
        self.fork_digest = args.fork_digest
        self.enable_peer_exchange = args.enable_peer_exchange
        host, _, port = (args.listen_addr or "127.0.0.1:0").rpartition(":")
        server = await asyncio.start_server(
            self.accept_connection, host or "127.0.0.1", int(port or 0)
        )
        self.listen_port = server.sockets[0].getsockname()[1]
        for addr in args.bootnodes:
            asyncio.ensure_future(self.dial(addr))
        asyncio.ensure_future(self._heartbeat_loop())
        await self.result(
            cmd.id, True, payload=str(self.listen_port).encode()
        )

    # ------------------------------------------------------------- peers

    async def accept_connection(self, reader, writer) -> None:
        self._conn_counter += 1
        peer = Peer(reader, writer, self._conn_counter)
        await self.run_peer(peer, dialed_addr=None)

    async def dial(self, addr: str) -> tuple[bool, str]:
        host, _, port = addr.rpartition(":")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), timeout=5
            )
        except (OSError, asyncio.TimeoutError) as e:
            return False, f"dial {addr}: {e}"
        self._conn_counter += 1
        peer = Peer(reader, writer, self._conn_counter)
        self.known_addrs.add(addr)
        asyncio.ensure_future(self.run_peer(peer, dialed_addr=addr))
        return True, ""

    async def run_peer(self, peer: Peer, dialed_addr: str | None) -> None:
        try:
            # encrypted transport first: everything after this line —
            # including the HELLO — rides the authenticated channel
            try:
                peer.noise = await asyncio.wait_for(
                    handshake(
                        peer.reader,
                        peer.writer,
                        self.noise_static,
                        initiator=dialed_addr is not None,
                    ),
                    timeout=10,
                )
            except (NoiseError, asyncio.TimeoutError):
                print(
                    "sidecar: noise handshake failed "
                    f"({'dial ' + dialed_addr if dialed_addr else 'inbound'}) — "
                    "a plaintext peer?",
                    file=sys.stderr,
                    flush=True,
                )
                return
            hello = p2p_pb2.P2PFrame()
            hello.hello.node_id = self.node_id
            hello.hello.fork_digest = self.fork_digest
            hello.hello.listen_port = self.listen_port
            hello.hello.topics.extend(sorted(self.subscriptions))
            await peer.send_frame(hello)
            first = await asyncio.wait_for(self.read_frame(peer), timeout=10)
            if first is None or first.WhichOneof("f") != "hello":
                return
            h = first.hello
            if h.fork_digest != self.fork_digest:
                return  # wrong fork: drop (the discovery filter's job)
            if h.node_id == self.node_id or h.node_id in self.peers:
                return  # self-dial or duplicate connection
            # identity binding: the HELLO node_id must be the hash of the
            # noise-authenticated static key — no borrowed ids
            if h.node_id != hashlib.sha256(peer.noise.remote_static).digest():
                return
            carried = self.ban_scores.get(h.node_id, 0.0)
            if carried < GRAYLIST_SCORE:
                return  # graylisted identity: refuse the connection
            peer.node_id = h.node_id
            peer.listen_port = h.listen_port
            peer.topics = set(h.topics)
            peer.score = carried
            peername = peer.writer.get_extra_info("peername")
            peer.addr = dialed_addr or (
                f"{peername[0]}:{h.listen_port}" if h.listen_port else ""
            )
            self.peers[peer.node_id] = peer
            if peer.addr:
                self.known_addrs.add(peer.addr)
            # Re-announce our subscription set now that the peer is
            # registered: a host subscribe processed while this handshake
            # was in flight landed after our HELLO topic snapshot but
            # before we appeared in self.peers, so its _announce_sub
            # fan-out missed this link — without the repair the peer
            # never learns the topic and mesh routing blackholes it.
            for topic in sorted(self.subscriptions):
                sub = p2p_pb2.P2PFrame()
                sub.sub_opts.topic = topic
                sub.sub_opts.subscribe = True
                await peer.send_frame(sub)
            n = port_pb2.Notification()
            n.new_peer.peer_id = peer.node_id
            n.new_peer.addr = peer.addr
            await self.notify(n)
            if self.enable_peer_exchange:
                exchange = p2p_pb2.P2PFrame()
                exchange.peer_exchange.addrs.extend(
                    a for a in self.known_addrs if a != peer.addr
                )
                await peer.send_frame(exchange)
            while True:
                frame = await self.read_frame(peer)
                if frame is None:
                    break
                await self.handle_frame(peer, frame)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError, OSError,
                NoiseError):
            pass
        finally:
            if peer.node_id and self.peers.get(peer.node_id) is peer:
                del self.peers[peer.node_id]
                for members in self.mesh.values():
                    members.discard(peer.node_id)
                if peer.score < 0:
                    self.ban_scores[peer.node_id] = peer.score
                n = port_pb2.Notification()
                n.peer_gone.peer_id = peer.node_id
                await self.notify(n)
            peer.writer.close()

    async def read_frame(self, peer: Peer) -> p2p_pb2.P2PFrame | None:
        try:
            head = await peer.reader.readexactly(4)
        except asyncio.IncompleteReadError:
            return None
        (length,) = struct.unpack(">I", head)
        if length > MAX_FRAME:
            return None
        raw = await peer.reader.readexactly(length)
        try:
            raw = peer.noise.decrypt(raw)
        except NoiseError:
            return None  # tampered/offset stream: drop the peer
        return p2p_pb2.P2PFrame.FromString(raw)

    async def handle_frame(self, peer: Peer, frame: p2p_pb2.P2PFrame) -> None:
        which = frame.WhichOneof("f")
        if which == "gossip":
            await self.on_gossip(
                peer,
                frame.gossip.topic,
                frame.gossip.payload,
                frame.gossip.trace if frame.gossip.HasField("trace") else None,
            )
        elif which == "req":
            await self.on_req(peer, frame.req)
        elif which == "resp":
            await self.on_resp(peer, frame.resp)
        elif which == "peer_exchange":
            await self.on_peer_exchange(frame.peer_exchange.addrs)
        elif which == "sub_opts":
            if frame.sub_opts.subscribe:
                peer.topics.add(frame.sub_opts.topic)
            else:
                peer.topics.discard(frame.sub_opts.topic)
                self.mesh.get(frame.sub_opts.topic, set()).discard(peer.node_id)
        elif which == "graft":
            self.control_stats["graft_recv"] = (
                self.control_stats.get("graft_recv", 0) + 1
            )
            await self.on_graft(peer, frame.graft.topic)
        elif which == "prune":
            self.control_stats["prune_recv"] = (
                self.control_stats.get("prune_recv", 0) + 1
            )
            self.mesh.get(frame.prune.topic, set()).discard(peer.node_id)
        elif which == "goodbye":
            peer.writer.close()

    # ----------------------------------------------------------- mesh

    async def _send_control(self, peer: Peer, kind: str, topic: str) -> None:
        frame = p2p_pb2.P2PFrame()
        getattr(frame, kind).topic = topic
        self.control_stats[f"{kind}_sent"] = (
            self.control_stats.get(f"{kind}_sent", 0) + 1
        )
        try:
            await peer.send_frame(frame)
        except (OSError, ConnectionError, NoiseError):
            pass

    async def _announce_sub(self, topic: str, subscribe: bool) -> None:
        frame = p2p_pb2.P2PFrame()
        frame.sub_opts.topic = topic
        frame.sub_opts.subscribe = subscribe
        for peer in list(self.peers.values()):
            try:
                await peer.send_frame(frame)
            except (OSError, ConnectionError, NoiseError):
                pass

    async def on_graft(self, peer: Peer, topic: str) -> None:
        """A peer grafts us into its mesh; accept when we subscribe to the
        topic and the peer is in good standing, else prune back."""
        if topic in self.subscriptions and peer.score > PRUNE_SCORE:
            self.mesh.setdefault(topic, set()).add(peer.node_id)
        else:
            await self._send_control(peer, "prune", topic)

    async def _mesh_maintain(self, topic: str) -> None:
        members = self.mesh.setdefault(topic, set())
        members &= set(self.peers)  # drop vanished peers
        if len(members) < MESH_D_LO:
            candidates = sorted(
                (
                    p
                    for p in self.peers.values()
                    if topic in p.topics
                    and p.node_id not in members
                    and p.score > PRUNE_SCORE
                ),
                key=lambda p: -p.score,
            )
            for peer in candidates[: MESH_D - len(members)]:
                members.add(peer.node_id)
                await self._send_control(peer, "graft", topic)
        elif len(members) > MESH_D_HI:
            ranked = sorted(
                members, key=lambda nid: self.peers[nid].score, reverse=True
            )
            for nid in ranked[MESH_D:]:
                members.discard(nid)
                peer = self.peers.get(nid)
                if peer is not None:
                    await self._send_control(peer, "prune", topic)

    async def _heartbeat_loop(self) -> None:
        beats = 0
        while True:
            await asyncio.sleep(HEARTBEAT_S)
            beats += 1
            for peer in list(self.peers.values()):
                peer.score *= SCORE_DECAY if peer.score >= 0 else BAN_DECAY
                if peer.score < GRAYLIST_SCORE:
                    await self._disconnect(peer)
            # off-line penalties decay too (slowly); forgiven once above
            # the prune threshold
            for nid in list(self.ban_scores):
                self.ban_scores[nid] *= BAN_DECAY
                if self.ban_scores[nid] > PRUNE_SCORE:
                    del self.ban_scores[nid]
            for topic in list(self.subscriptions):
                await self._mesh_maintain(topic)
            if self.enable_peer_exchange and beats % SUBSCRIBER_PX_EVERY == 0:
                await self._subscriber_px()

    async def _subscriber_px(self) -> None:
        """Introduce announced subscribers of each topic to one another.

        Mesh routing only relays topics the local node subscribes to, so
        two subscribers whose only path runs through a non-subscribing
        relay would stay partitioned; this control traffic lets them dial
        each other directly (the role PRUNE-PX / IHAVE play in gossipsub
        v1.1, subscriptions.go:31-77)."""
        by_topic: dict[str, list[Peer]] = {}
        for p in self.peers.values():
            for t in p.topics:
                by_topic.setdefault(t, []).append(p)
        intros: dict[bytes, set[str]] = {}
        for subs in by_topic.values():
            if len(subs) < 2:
                continue
            addrs = {p.addr for p in subs if p.addr}
            for p in subs:
                others = addrs - {p.addr}
                if others:
                    intros.setdefault(p.node_id, set()).update(others)
        for nid, addrs in intros.items():
            peer = self.peers.get(nid)
            if peer is None:
                continue
            frame = p2p_pb2.P2PFrame()
            frame.peer_exchange.addrs.extend(sorted(addrs))
            try:
                await peer.send_frame(frame)
            except (OSError, ConnectionError, NoiseError):
                pass

    async def _disconnect(self, peer: Peer) -> None:
        frame = p2p_pb2.P2PFrame()
        frame.goodbye.reason = 1  # fault
        try:
            await peer.send_frame(frame)
        except (OSError, ConnectionError, NoiseError):
            pass
        peer.writer.close()

    # ------------------------------------------------------------- gossip

    def _mark_seen(self, msg_id: bytes) -> bool:
        """True if newly seen."""
        if msg_id in self.seen:
            return False
        self.seen[msg_id] = None
        while len(self.seen) > GOSSIP_SEEN_CAP:
            self.seen.popitem(last=False)
        return True

    async def publish(self, topic: str, payload: bytes, trace=None) -> None:
        msg_id = _msg_id(topic, payload)
        self._mark_seen(msg_id)
        await self._forward(topic, payload, exclude=None, trace=trace)

    def _route_targets(self, topic: str, exclude: bytes | None) -> list[Peer]:
        """Mesh members for the topic; when the mesh is still empty (cold
        start, before a heartbeat) fall back to every topic subscriber."""
        members = self.mesh.get(topic) or {
            p.node_id for p in self.peers.values() if topic in p.topics
        }
        return [
            self.peers[nid]
            for nid in members
            if nid != exclude and nid in self.peers
        ]

    async def _forward(
        self, topic: str, payload: bytes, exclude: bytes | None, trace=None
    ) -> None:
        frame = p2p_pb2.P2PFrame()
        frame.gossip.topic = topic
        frame.gossip.payload = payload
        if trace is not None:
            _copy_trace(frame.gossip.trace, trace)
        for peer in self._route_targets(topic, exclude):
            try:
                await peer.send_frame(frame)
            except (OSError, ConnectionError, NoiseError):
                pass

    def _note_delivery(self, peer: Peer, topic: str, first: bool) -> None:
        stat = self.delivery_stats.setdefault((peer.node_id, topic), [0, 0])
        stat[0 if first else 1] += 1

    async def on_gossip(self, peer: Peer, topic: str, payload: bytes, trace=None) -> None:
        msg_id = _msg_id(topic, payload)
        first = self._mark_seen(msg_id)
        self._note_delivery(peer, topic, first)
        if not first:
            return
        if topic not in self.subscriptions:
            # mesh routing: messages flow along grafted links of
            # subscribers only — no blind flood relay of foreign topics
            return
        # host-gated validation before forwarding (reference: blocking topic
        # validator waiting on the Elixir verdict, subscriptions.go:95-135)
        self.pending_validation[msg_id] = (topic, payload, peer.node_id, trace)
        while len(self.pending_validation) > GOSSIP_SEEN_CAP:
            self.pending_validation.popitem(last=False)
        n = port_pb2.Notification()
        n.gossip.topic = topic
        n.gossip.msg_id = msg_id
        n.gossip.payload = payload
        n.gossip.peer_id = peer.node_id
        if trace is not None:
            _copy_trace(n.gossip.trace, trace)
        await self.notify(n)

    async def finish_validation(self, msg_id: bytes, verdict: int) -> None:
        entry = self.pending_validation.pop(msg_id, None)
        if entry is None:
            return
        topic, payload, source, trace = entry
        peer = self.peers.get(source)
        if verdict == port_pb2.ValidateMessage.ACCEPT:
            if peer is not None:
                peer.score = min(MAX_SCORE, peer.score + ACCEPT_REWARD)
            if trace is not None:
                # the context survives the re-publish with one more hop:
                # downstream admissions attribute latency to the ORIGIN
                fwd = p2p_pb2.TraceCtx()
                _copy_trace(fwd, trace)
                fwd.hop = trace.hop + 1
                trace = fwd
            await self._forward(topic, payload, exclude=source, trace=trace)
        elif verdict == port_pb2.ValidateMessage.REJECT:
            # protocol violation: downscore, prune from every mesh, and
            # disconnect once past the graylist threshold (round 1 never
            # penalized — REJECT now has teeth)
            if peer is None:
                # hit-and-run: the sender disconnected before the verdict
                # landed — debit the persistent ban score directly so a
                # reconnect doesn't start clean
                self.ban_scores[source] = (
                    self.ban_scores.get(source, 0.0) - REJECT_PENALTY
                )
                return
            peer.score -= REJECT_PENALTY
            if peer.score <= PRUNE_SCORE:
                # snapshot: _send_control awaits, and a concurrent GRAFT /
                # subscribe may insert a mesh key mid-iteration (ADVICE r2)
                for topic, members in list(self.mesh.items()):
                    if source in members:
                        members.discard(source)
                        # tell the remote: a silent local discard leaves
                        # an asymmetric half-dead mesh link on their side
                        await self._send_control(peer, "prune", topic)
            if peer.score < GRAYLIST_SCORE:
                await self._disconnect(peer)

    def gossip_stats(self) -> dict:
        """JSON-able per-peer gossip-health snapshot (round 22): delivery
        first/duplicate counters per (peer, topic), live peer scores,
        mesh membership and control-frame counts.  IHAVE/IWANT slots are
        structurally present but zero on this wire — the bespoke mesh
        has no gossip-id advertisement; the libp2p sidecar fills them."""
        delivery: dict[str, dict[str, dict[str, int]]] = {}
        for (nid, topic), (first, dup) in self.delivery_stats.items():
            delivery.setdefault(nid.hex(), {})[topic] = {
                "first": first, "duplicate": dup,
            }
        peers = {
            nid.hex(): {
                "score": round(peer.score, 4),
                "addr": peer.addr,
                "topics": sorted(peer.topics),
            }
            for nid, peer in self.peers.items()
        }
        control = dict(self.control_stats)
        for key in ("ihave_sent", "ihave_recv", "iwant_sent", "iwant_recv",
                    "iwant_served"):
            control.setdefault(key, 0)
        return {
            "wire": "bespoke",
            "peers": peers,
            "delivery": delivery,
            "mesh": {
                topic: sorted(nid.hex() for nid in members)
                for topic, members in self.mesh.items()
            },
            "ban_scores": {
                nid.hex(): round(score, 4)
                for nid, score in self.ban_scores.items()
            },
            "control": control,
        }

    # ------------------------------------------------------------ req/resp

    async def send_request(self, cmd: port_pb2.Command) -> None:
        req = cmd.send_request
        peer = self.peers.get(req.peer_id)
        if peer is None:
            await self.result(cmd.id, False, error="unknown peer")
            return
        self._req_counter += 1
        req_id = self._req_counter.to_bytes(8, "big")
        self.pending_requests[req_id] = (cmd.id, peer.node_id)
        frame = p2p_pb2.P2PFrame()
        frame.req.req_id = req_id
        frame.req.protocol_id = req.protocol_id
        frame.req.payload = req.payload
        try:
            await peer.send_frame(frame)
        except (OSError, ConnectionError, NoiseError) as e:
            self.pending_requests.pop(req_id, None)
            await self.result(cmd.id, False, error=f"send: {e}")
            return
        timeout = (req.timeout_ms or 15000) / 1000
        asyncio.get_running_loop().call_later(
            timeout, lambda: asyncio.ensure_future(self._expire_request(req_id))
        )

    async def _expire_request(self, req_id: bytes) -> None:
        entry = self.pending_requests.pop(req_id, None)
        if entry is not None:
            await self.result(entry[0], False, error="request timed out")

    async def on_req(self, peer: Peer, req: p2p_pb2.Req) -> None:
        if req.protocol_id not in self.handlers:
            frame = p2p_pb2.P2PFrame()
            frame.resp.req_id = req.req_id
            frame.resp.ok = False
            frame.resp.error = "unsupported protocol"
            await peer.send_frame(frame)
            return
        request_id = peer.conn_id.to_bytes(8, "big") + req.req_id
        self.incoming_requests[request_id] = peer
        n = port_pb2.Notification()
        n.request.protocol_id = req.protocol_id
        n.request.request_id = request_id
        n.request.payload = req.payload
        n.request.peer_id = peer.node_id
        await self.notify(n)

    async def send_response(self, cmd: port_pb2.Command) -> None:
        resp = cmd.send_response
        peer = self.incoming_requests.pop(resp.request_id, None)
        if peer is None:
            await self.result(cmd.id, False, error="unknown request id")
            return
        frame = p2p_pb2.P2PFrame()
        frame.resp.req_id = resp.request_id[8:]
        frame.resp.payload = resp.payload
        frame.resp.ok = True
        try:
            await peer.send_frame(frame)
            await self.result(cmd.id, True)
        except (OSError, ConnectionError, NoiseError) as e:
            await self.result(cmd.id, False, error=f"send: {e}")

    async def on_resp(self, peer: Peer, resp: p2p_pb2.Resp) -> None:
        entry = self.pending_requests.get(resp.req_id)
        if entry is None:
            return  # expired or unknown
        cmd_id, expected_peer = entry
        if peer.node_id != expected_peer:
            return  # forged response from a different peer: ignore
        del self.pending_requests[resp.req_id]
        if resp.ok:
            await self.result(cmd_id, True, payload=resp.payload)
        else:
            await self.result(cmd_id, False, error=resp.error or "remote error")

    # ------------------------------------------------------------ discovery

    async def on_peer_exchange(self, addrs) -> None:
        if not self.enable_peer_exchange:
            return
        budget = MAX_DIALED_FROM_EXCHANGE - len(self.peers)
        for addr in addrs:
            if budget <= 0:
                break
            if addr not in self.known_addrs:
                self.known_addrs.add(addr)
                budget -= 1
                asyncio.ensure_future(self.dial(addr))


def _static_key(key_file: str | None):
    """The node's X25519 static key: read from ``key_file`` when it holds
    one, else generated (and written there atomically, when a file is
    named).  Raises :class:`NoiseError` without ``cryptography``."""
    if noise.X25519PrivateKey is None:
        raise NoiseError(
            "the sidecar's noise transport needs the 'cryptography' module; "
            "it never runs in plaintext"
        )
    # identity persists across restarts (SIDECAR_KEY_FILE): key rotation
    # must cost more than a process restart or a graylisted peer evades its
    # ban by restarting (ADVICE r2)
    if key_file and os.path.exists(key_file):
        try:
            with open(key_file, "rb") as fh:
                return noise.X25519PrivateKey.from_private_bytes(fh.read(32))
        except ValueError:
            # corrupt/truncated key file: regenerate below — a parse error
            # must rotate the identity
            print(
                f"sidecar: corrupt key file {key_file}; regenerating identity",
                file=sys.stderr,
                flush=True,
            )
    key = noise.X25519PrivateKey.generate()
    if key_file:
        # atomic write: a crash mid-write must not leave a short file for
        # the next start to trip over
        tmp = f"{key_file}.tmp.{os.getpid()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as fh:
            fh.write(noise._priv_bytes(key))
        os.replace(tmp, key_file)
    return key


async def _main() -> None:
    sidecar = Sidecar()
    await sidecar.command_loop()


def main() -> None:
    if os.environ.get("SIDECAR_WIRE") == "libp2p":
        # real libp2p wire protocols (multistream/noise/yamux|mplex/meshsub)
        # behind the same stdio contract — see sidecar_libp2p.py
        from .sidecar_libp2p import main as libp2p_main

        libp2p_main()
        return
    try:
        asyncio.run(_main())
    except (KeyboardInterrupt, asyncio.IncompleteReadError, EOFError):
        pass


if __name__ == "__main__":
    main()
