"""gossipsub v1.1 over /meshsub/1.1.0 — the real pubsub wire protocol.

Speaks go-libp2p-pubsub's RPC protobuf (proto/gossipsub.proto) on
meshsub streams, replacing the sidecar's bespoke gossip frames for
libp2p-wire deployments.  Semantics follow the gossipsub v1.1 spec with
the reference's eth2 tuning (ref: subscriptions.go:31-77):

- mesh per topic, D=8 / D_lo=6 / D_hi=12, 700 ms heartbeat;
- GRAFT/PRUNE control, IHAVE gossip to non-mesh subscribers each
  heartbeat (history 6 windows, gossip 3), IWANT recovery;
- StrictNoSign: publishes carry only ``data`` + ``topic``; messages
  with from/seqno/signature/key are rejected as protocol violations;
- eth2 message id (post-Altair, ref: utils.go MsgID): sha256 of
  ``domain(4B) || uint64_le(len(topic)) || topic || payload`` truncated
  to 20 bytes, where domain is VALID(0x01000000) with the raw-snappy
  decompressed payload, INVALID(0x00000000) with the compressed bytes;
- host-gated validation: inbound messages go to an async validator and
  are forwarded only on ACCEPT (the reference's blocking topic
  validator, subscriptions.go:95-135); REJECT feeds peer scoring.

One long-lived outbound stream per peer carries our RPCs (varint-
length-delimited, as go-libp2p-pubsub frames them); each peer likewise
opens one inbound stream to us.

The port's copy of the JAX package's ``network/libp2p/gossipsub.py``;
the bytes it puts on the wire are the JAX module's. Validation stays
serial per peer, as in the JAX package: a peer's next RPC is read only
once the validator has answered for every message of the current one.
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
import time
from collections import OrderedDict

from ...compression.snappy import SnappyError, decompress as raw_decompress
from ..proto import gossipsub_pb2 as pb
from . import varint
from .host import Libp2pError, Libp2pHost
from .identity import PeerId
from .mplex import MplexError

MESHSUB_PROTOCOL = "/meshsub/1.1.0"
MAX_RPC = 10 * (1 << 20)  # the reference's 10 MB message cap

# eth2 mesh tuning (ref: subscriptions.go:33-39)
D = 8
D_LO = 6
D_HI = 12
HEARTBEAT_S = 0.7
HISTORY_LENGTH = 6
HISTORY_GOSSIP = 3
SEEN_TTL_S = 550 * HEARTBEAT_S
FANOUT_TTL_S = 60.0
# bandwidth-amplification bounds (gossipsub v1.1 MaxIHaveLength /
# GossipRetransmission roles)
MAX_IHAVE_IDS = 5000
MAX_IWANT_RETRANSMIT = 3

# gossipsub v1.1 prune backoff + peer exchange (spec §prune-backoff, §px;
# the reference's go-libp2p-pubsub defaults: PruneBackoff = 1 min).  A
# pruned link MUST NOT re-graft until the backoff expires — on either
# side — and a GRAFT arriving inside the window is refused with a fresh
# PRUNE plus a behavioral penalty (the spec's graft-flood defense).
# The penalty is waived inside a short grace window after OUR prune:
# an honest peer's heartbeat GRAFT can legally cross our PRUNE on the
# wire, and docking 10 points per race would walk a churning-but-honest
# peer to the prune bar (go-libp2p-pubsub's GraftFloodThreshold plays
# this role, scaled there by the P7 penalty-squared weighting).
PRUNE_BACKOFF_S = 60.0
GRAFT_FLOOD_PENALTY = 10.0
GRAFT_FLOOD_GRACE_S = 2.0
# PX is only honored from peers in good standing (spec: acceptPXThreshold)
# and bounded, so one PRUNE cannot make us dial an attacker's whole list
MAX_PX_PEERS = 16

ACCEPT, REJECT, IGNORE = 1, 2, 3

ACCEPT_REWARD = 1.0
REJECT_PENALTY = 40.0
PRUNE_SCORE = -40.0
MAX_SCORE = 100.0
# negative scores survive disconnection (go-libp2p-pubsub RetainScore,
# ref: subscriptions.go RetainScore = 100 epochs) and decay slowly; a
# reconnect must not reset a misbehaving peer's standing
SCORE_DECAY = 0.95
BAN_DECAY = 0.9995

MESSAGE_DOMAIN_INVALID_SNAPPY = b"\x00\x00\x00\x00"
MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"


def eth2_msg_id(topic: str, data: bytes) -> bytes:
    """Post-Altair eth2 message id (ref: utils.go MsgID)."""
    h = hashlib.sha256()
    try:
        payload = raw_decompress(data)
        h.update(MESSAGE_DOMAIN_VALID_SNAPPY)
    except SnappyError:
        payload = data
        h.update(MESSAGE_DOMAIN_INVALID_SNAPPY)
    h.update(struct.pack("<Q", len(topic)))
    h.update(topic.encode())
    h.update(payload)
    return h.digest()[:20]


def encode_rpc(rpc: pb.RPC) -> bytes:
    raw = rpc.SerializeToString()
    return varint.encode(len(raw)) + raw


async def _read_rpc(stream) -> pb.RPC:
    try:
        length = await varint.read(stream, max_shift=31)
    except varint.VarintError as e:
        raise Libp2pError(str(e)) from None
    if length > MAX_RPC:
        raise Libp2pError(f"oversized rpc ({length})")
    raw = await stream.readexactly(length)
    try:
        return pb.RPC.FromString(raw)
    except Exception as e:  # protobuf DecodeError etc: peer spoke garbage
        raise Libp2pError(f"undecodable rpc: {e}") from None


class _PeerState:
    def __init__(self, peer_id: PeerId):
        self.peer_id = peer_id
        self.topics: set[str] = set()
        self.score = 0.0
        self.stream = None  # our outbound meshsub stream
        self.send_lock = asyncio.Lock()
        # msg_id -> times served to THIS peer (IWANT retransmission budget)
        self.iwant_served: dict[bytes, int] = {}
        # ids we will IWANT from this peer per heartbeat window
        self.ihave_budget = MAX_IHAVE_IDS


class Gossipsub:
    """The router.  ``validator(topic, data, msg_id, peer_id) -> verdict``
    decides forwarding; absent a validator everything is accepted."""

    def __init__(self, host: Libp2pHost, validator=None, on_px=None):
        self.host = host
        self.validator = validator
        # PX hook: ``on_px(topic, [PeerInfo, ...])`` receives the peers a
        # good-standing PRUNE carried, so discovery can dial them — the
        # router itself never dials (addresses live in the signed peer
        # records, whose resolution is the host/discovery layer's job)
        self.on_px = on_px
        self.peers: dict[PeerId, _PeerState] = {}
        self.retained_scores: dict[PeerId, float] = {}  # negative only
        self.subscriptions: set[str] = set()
        self.mesh: dict[str, set[PeerId]] = {}
        self.fanout: dict[str, tuple[set[PeerId], float]] = {}
        # (topic, peer) -> monotonic expiry: no re-GRAFT on this link
        # until then, whichever side sent the PRUNE (spec MUST); the
        # noted-at side table feeds the graft-flood grace window
        self.backoff: dict[tuple[str, PeerId], float] = {}
        self.backoff_noted: dict[tuple[str, PeerId], float] = {}
        # seen-cache: msg_id -> expiry, ids only (550 heartbeats, as the
        # reference's WithSeenMessagesTTL) — REJECTed ids stay here so
        # invalid messages are not re-validated, but only ACCEPTed
        # payloads enter mcache and become IHAVE/IWANT-servable
        self.seen: OrderedDict[bytes, float] = OrderedDict()
        # message cache: msg_id -> (topic, data), retained for exactly the
        # HISTORY_LENGTH gossip windows (payloads drop out with rotation)
        self.mcache: dict[bytes, tuple[str, bytes]] = {}
        # gossip windows: lists of msg-ids, newest first
        self._history: list[list[bytes]] = []
        self._current_window: list[bytes] = []
        # per-(peer, topic) delivery counters [first, duplicate] and
        # control-frame tallies: duplicates
        # dedup here and never reach the host, so gossip health must be
        # tallied at the wire and exported via get_gossip_stats
        self.delivery_stats: dict[tuple[bytes, str], list[int]] = {}
        self.control_stats: dict[str, int] = {}
        self._heartbeat_task: asyncio.Task | None = None
        host.set_stream_handler(MESHSUB_PROTOCOL, self._inbound)
        self._prev_on_peer = host.on_peer
        host.on_peer = self._on_peer

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._heartbeat_task is None:
            self._heartbeat_task = asyncio.ensure_future(self._heartbeat_loop())

    async def stop(self) -> None:
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            self._heartbeat_task = None

    # ------------------------------------------------------------- peering
    async def _on_peer(self, peer_id: PeerId, addr: str) -> None:
        state = _PeerState(peer_id)
        state.score = self.retained_scores.get(peer_id, 0.0)
        self.peers[peer_id] = state
        if self.subscriptions:
            rpc = pb.RPC()
            for topic in sorted(self.subscriptions):
                sub = rpc.subscriptions.add()
                sub.subscribe = True
                sub.topicid = topic
            await self._send_rpc(state, rpc)
        if self._prev_on_peer is not None:
            await self._prev_on_peer(peer_id, addr)

    SEND_TIMEOUT_S = 5.0

    async def _send_rpc(self, state: _PeerState, rpc: pb.RPC) -> None:
        try:
            # bounded: a peer that accepts the stream but never answers
            # multistream (or stops reading) must not stall the heartbeat
            # and every later peer in a forward loop behind its send_lock
            await asyncio.wait_for(self._send_rpc_inner(state, rpc), self.SEND_TIMEOUT_S)
        except (
            Libp2pError,
            ConnectionError,
            OSError,
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
        ):
            self._drop_peer(state.peer_id)

    async def _send_rpc_inner(self, state: _PeerState, rpc: pb.RPC) -> None:
        async with state.send_lock:
            if state.stream is None:
                state.stream, _ = await self.host.new_stream(
                    state.peer_id, [MESHSUB_PROTOCOL]
                )
            state.stream.write(encode_rpc(rpc))
            await state.stream.drain()

    def _drop_peer(self, peer_id: PeerId) -> None:
        state = self.peers.pop(peer_id, None)
        if state is not None:
            if state.score < 0:
                self.retained_scores[peer_id] = state.score
            else:
                # left in good standing: a previously-retained debt the
                # peer has since worked off must not be re-applied
                self.retained_scores.pop(peer_id, None)
        for members in self.mesh.values():
            members.discard(peer_id)
        for members, _ in self.fanout.values():
            members.discard(peer_id)

    # ------------------------------------------------------------- inbound
    async def _inbound(self, stream, protocol: str, peer_id: PeerId) -> None:
        state = self.peers.get(peer_id)
        if state is None:
            state = _PeerState(peer_id)
            state.score = self.retained_scores.get(peer_id, 0.0)
            self.peers[peer_id] = state
        try:
            while True:
                rpc = await _read_rpc(stream)
                await self._handle_rpc(state, rpc)
        except (
            asyncio.IncompleteReadError,
            Libp2pError,
            ConnectionError,
            MplexError,  # stream reset mid-RPC (yamux errors subclass it)
        ):
            pass
        finally:
            self._drop_peer(peer_id)

    async def _handle_rpc(self, state: _PeerState, rpc: pb.RPC) -> None:
        for sub in rpc.subscriptions:
            if sub.subscribe:
                state.topics.add(sub.topicid)
            else:
                state.topics.discard(sub.topicid)
                self.mesh.get(sub.topicid, set()).discard(state.peer_id)
        for msg in rpc.publish:
            await self._on_publish(state, msg)
        if rpc.HasField("control"):
            await self._on_control(state, rpc.control)

    async def _on_publish(self, state: _PeerState, msg: pb.Message) -> None:
        # StrictNoSign (ref: subscriptions.go WithMessageSignaturePolicy):
        # author/seqno/signature on the wire is a protocol violation
        # (proto3 presence: absent scalar/bytes fields read as empty)
        if getattr(msg, "from") or msg.seqno or msg.signature or msg.key:
            state.score -= REJECT_PENALTY
            return
        topic = msg.topic
        if topic not in self.subscriptions:
            return
        msg_id = eth2_msg_id(topic, msg.data)
        first = self._mark_seen(msg_id)
        stat = self.delivery_stats.setdefault(
            (state.peer_id.bytes, topic), [0, 0]
        )
        stat[0 if first else 1] += 1
        if not first:
            return
        verdict = ACCEPT
        if self.validator is not None:
            verdict = await self.validator(topic, msg.data, msg_id, state.peer_id)
        if verdict == ACCEPT:
            # only now does the payload enter the gossip cache: a REJECTed
            # message must never be IHAVE-advertised or IWANT-served
            self._remember(msg_id, topic, msg.data)
            state.score = min(MAX_SCORE, state.score + ACCEPT_REWARD)
            await self._forward(topic, msg.data, exclude=state.peer_id)
        elif verdict == REJECT:
            state.score -= REJECT_PENALTY
            if state.score <= PRUNE_SCORE:
                for topic_, members in list(self.mesh.items()):
                    if state.peer_id in members:
                        members.discard(state.peer_id)
                        await self._send_control(state, prune=[topic_])

    def _in_backoff(self, topic: str, peer_id: PeerId) -> bool:
        expiry = self.backoff.get((topic, peer_id))
        return expiry is not None and expiry > time.monotonic()

    def _note_backoff(
        self, topic: str, peer_id: PeerId, duration_s: float = PRUNE_BACKOFF_S
    ) -> None:
        now = time.monotonic()
        if not self._in_backoff(topic, peer_id):
            # the grace window anchors to the EPISODE's first prune: a
            # refused GRAFT restarts the expiry below but must not
            # re-open the grace, or a flood of grafts spaced inside the
            # grace would be penalized at most once
            self.backoff_noted[(topic, peer_id)] = now
        self.backoff[(topic, peer_id)] = now + duration_s

    async def _on_control(self, state: _PeerState, ctl: pb.ControlMessage) -> None:
        if ctl.graft:
            self._bump("graft_recv", len(ctl.graft))
        if ctl.prune:
            self._bump("prune_recv", len(ctl.prune))
        for graft in ctl.graft:
            topic = graft.topic_id
            if self._in_backoff(topic, state.peer_id):
                # GRAFT inside the prune-backoff window: refuse with a
                # fresh PRUNE and penalize (spec §prune-backoff — the
                # graft-flood defense; the backoff clock restarts).  A
                # GRAFT that crossed our PRUNE on the wire lands within
                # the grace window and is refused without the penalty.
                noted = self.backoff_noted.get((topic, state.peer_id), 0.0)
                if time.monotonic() - noted > GRAFT_FLOOD_GRACE_S:
                    state.score -= GRAFT_FLOOD_PENALTY
                # the refusal PRUNE below restarts the backoff clock (its
                # _note_backoff), and carries no PX (go-libp2p-pubsub
                # does the same): answering every backoff-violating GRAFT
                # with our mesh membership would let a peer poll topology
                # for free
                await self._send_control(state, prune=[topic], px=False)
            elif topic in self.subscriptions and state.score > PRUNE_SCORE:
                self.mesh.setdefault(topic, set()).add(state.peer_id)
            else:
                await self._send_control(state, prune=[topic])
        for prune in ctl.prune:
            topic = prune.topic_id
            self.mesh.get(topic, set()).discard(state.peer_id)
            # honor the peer's announced backoff (their default when the
            # field is unset/zero): no re-GRAFT on this link until expiry
            self._note_backoff(
                topic, state.peer_id, float(prune.backoff) or PRUNE_BACKOFF_S
            )
            if prune.peers and state.score >= 0 and self.on_px is not None:
                # peer exchange: only from good standing, bounded — the
                # hook owns dialing via the signed peer records
                px = list(prune.peers)[:MAX_PX_PEERS]
                result = self.on_px(topic, px)
                if asyncio.iscoroutine(result):
                    await result
        wanted: list[bytes] = []
        seen_this_rpc: set[bytes] = set()
        for ihave in ctl.ihave:
            self._bump("ihave_recv", len(ihave.message_ids))
            if ihave.topic_id not in self.subscriptions:
                continue
            for m in ihave.message_ids:
                # per-peer budget refilled each heartbeat (gossipsub
                # v1.1's MaxIHaveLength x MaxIHaveMessages role), and
                # dedup: one repeated 10 MB id must cost one IWANT, and
                # splitting ids across many RPCs must not reset the cap
                if state.ihave_budget <= 0:
                    break
                if m in self.seen or m in seen_this_rpc:
                    continue
                seen_this_rpc.add(m)
                state.ihave_budget -= 1
                wanted.append(m)
        if wanted:
            self._bump("iwant_sent", len(wanted))
            rpc = pb.RPC()
            rpc.control.iwant.add().message_ids.extend(wanted)
            await self._send_rpc(state, rpc)
        serve: list[tuple[str, bytes]] = []
        for iwant in ctl.iwant:
            self._bump("iwant_recv", len(iwant.message_ids))
            for mid in iwant.message_ids:
                # per-(peer, msg) retransmission budget (the spec's
                # GossipRetransmission role): re-IWANTing the same cached
                # 10 MB entry must not amplify bandwidth forever
                served = state.iwant_served.get(mid, 0)
                if served >= MAX_IWANT_RETRANSMIT:
                    continue
                entry = self.mcache.get(mid)
                if entry is not None:
                    state.iwant_served[mid] = served + 1
                    if len(state.iwant_served) > MAX_IHAVE_IDS * 4:
                        state.iwant_served.pop(next(iter(state.iwant_served)))
                    serve.append(entry)
        if serve:
            self._bump("iwant_served", len(serve))
            rpc = pb.RPC()
            for topic, data in serve:
                m = rpc.publish.add()
                m.topic = topic
                m.data = data
            await self._send_rpc(state, rpc)

    def _bump(self, key: str, n: int = 1) -> None:
        self.control_stats[key] = self.control_stats.get(key, 0) + n

    def stats(self) -> dict:
        """JSON-able gossip-health snapshot — the libp2p-wire twin of the
        bespoke sidecar's ``gossip_stats()``, with live IHAVE/IWANT
        efficacy counters (ids advertised / requested / retransmitted)."""
        delivery: dict[str, dict[str, dict[str, int]]] = {}
        for (pid, topic), (first, dup) in self.delivery_stats.items():
            delivery.setdefault(pid.hex(), {})[topic] = {
                "first": first, "duplicate": dup,
            }
        control = dict(self.control_stats)
        for key in ("graft_sent", "graft_recv", "prune_sent", "prune_recv",
                    "ihave_sent", "ihave_recv", "iwant_sent", "iwant_recv",
                    "iwant_served"):
            control.setdefault(key, 0)
        return {
            "wire": "libp2p",
            "peers": {
                s.peer_id.bytes.hex(): {
                    "score": round(s.score, 4),
                    "addr": "",
                    "topics": sorted(s.topics),
                }
                for s in self.peers.values()
            },
            "delivery": delivery,
            "mesh": {
                topic: sorted(p.bytes.hex() for p in members)
                for topic, members in self.mesh.items()
            },
            "ban_scores": {
                p.bytes.hex(): round(score, 4)
                for p, score in self.retained_scores.items()
            },
            "control": control,
        }

    # ------------------------------------------------------------- outbound
    async def subscribe(self, topic: str) -> None:
        self.subscriptions.add(topic)
        self.mesh.setdefault(topic, set())
        rpc = pb.RPC()
        sub = rpc.subscriptions.add()
        sub.subscribe = True
        sub.topicid = topic
        for state in list(self.peers.values()):
            await self._send_rpc(state, rpc)
        await self._maintain(topic)

    async def unsubscribe(self, topic: str) -> None:
        self.subscriptions.discard(topic)
        rpc = pb.RPC()
        sub = rpc.subscriptions.add()
        sub.subscribe = False
        sub.topicid = topic
        members = self.mesh.pop(topic, set())
        for state in list(self.peers.values()):
            out = pb.RPC()
            out.CopyFrom(rpc)
            if state.peer_id in members:
                entry = out.control.prune.add()
                entry.topic_id = topic
                entry.backoff = int(PRUNE_BACKOFF_S)
                self._note_backoff(topic, state.peer_id)
            await self._send_rpc(state, out)

    async def publish(self, topic: str, data: bytes) -> bytes:
        msg_id = eth2_msg_id(topic, data)
        self._mark_seen(msg_id)
        self._remember(msg_id, topic, data)
        await self._forward(topic, data, exclude=None)
        return msg_id

    def _targets(self, topic: str, exclude: PeerId | None) -> list[_PeerState]:
        if topic in self.subscriptions:
            members = self.mesh.get(topic, set())
        else:
            # fanout: not subscribed, but publishing — keep D subscribers
            members, _ = self.fanout.get(topic, (set(), 0.0))
            members &= set(self.peers)
            if not members:
                members = {
                    s.peer_id
                    for s in self.peers.values()
                    if topic in s.topics
                }
                members = set(list(members)[:D])
            self.fanout[topic] = (members, time.monotonic() + FANOUT_TTL_S)
        return [
            self.peers[p] for p in members if p != exclude and p in self.peers
        ]

    async def _forward(self, topic: str, data: bytes, exclude: PeerId | None) -> None:
        rpc = pb.RPC()
        msg = rpc.publish.add()
        msg.topic = topic
        msg.data = data
        for state in self._targets(topic, exclude):
            await self._send_rpc(state, rpc)

    async def _send_control(
        self, state: _PeerState, graft: list[str] = (), prune: list[str] = (),
        px: bool = True,
    ) -> None:
        """GRAFT/PRUNE control.  Every PRUNE we send announces our
        backoff (spec MUST: the pruned peer must not re-GRAFT before it
        expires), records the same window locally (we must not re-graft
        either), and — when the pruned peer is in good standing —
        carries peer exchange: other mesh members it can dial instead,
        so pruning for oversubscription heals the topic rather than
        shrinking it."""
        rpc = pb.RPC()
        for topic in graft:
            self._bump("graft_sent")
            rpc.control.graft.add().topic_id = topic
        for topic in prune:
            self._bump("prune_sent")
            entry = rpc.control.prune.add()
            entry.topic_id = topic
            entry.backoff = int(PRUNE_BACKOFF_S)
            self._note_backoff(topic, state.peer_id)
            if px and state.score >= 0:
                members = self.mesh.get(topic, set())
                for peer_id in list(members)[:MAX_PX_PEERS]:
                    if peer_id != state.peer_id:
                        entry.peers.add().peer_id = peer_id.bytes
        await self._send_rpc(state, rpc)

    # ------------------------------------------------------------ heartbeat
    def _mark_seen(self, msg_id: bytes) -> bool:
        """True if newly seen; purges expired ids opportunistically."""
        if msg_id in self.seen:
            return False
        now = time.monotonic()
        self.seen[msg_id] = now + SEEN_TTL_S
        while self.seen:
            first = next(iter(self.seen))
            if self.seen[first] < now:
                del self.seen[first]
            else:
                break
        return True

    def _remember(self, msg_id: bytes, topic: str, data: bytes) -> None:
        self.mcache[msg_id] = (topic, data)
        self._current_window.append(msg_id)

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(HEARTBEAT_S)
            try:
                await self.heartbeat()
            except Exception:
                pass  # the loop must survive transient send errors

    async def heartbeat(self) -> None:
        # rotate gossip windows; payloads whose window ages out leave the
        # message cache (ids stay in `seen` for dedup)
        self._history.insert(0, self._current_window)
        self._current_window = []
        for expired in self._history[HISTORY_LENGTH:]:
            for mid in expired:
                self.mcache.pop(mid, None)
        del self._history[HISTORY_LENGTH:]
        now = time.monotonic()
        for topic, (members, expiry) in list(self.fanout.items()):
            if expiry < now:
                del self.fanout[topic]
        for key, expiry in list(self.backoff.items()):
            if expiry < now:
                del self.backoff[key]
                self.backoff_noted.pop(key, None)
        # score decay: positive washes out fast, negative slowly; retained
        # (offline) penalties are forgiven once back above the prune bar
        for state in self.peers.values():
            state.score *= SCORE_DECAY if state.score >= 0 else BAN_DECAY
            state.ihave_budget = MAX_IHAVE_IDS  # per-heartbeat IWANT quota
        for peer_id in list(self.retained_scores):
            self.retained_scores[peer_id] *= BAN_DECAY
            # forgive only once the debt has decayed to noise (a -40
            # single-REJECT debt takes ~86 min at 0.9995/0.7 s) — NOT at
            # the prune bar, which one decay step would cross
            if self.retained_scores[peer_id] > -1.0:
                del self.retained_scores[peer_id]
        for topic in list(self.subscriptions):
            await self._maintain(topic)
            await self._emit_gossip(topic)

    async def _maintain(self, topic: str) -> None:
        members = self.mesh.setdefault(topic, set())
        members &= set(self.peers)
        if len(members) < D_LO:
            candidates = sorted(
                (
                    s
                    for s in self.peers.values()
                    if topic in s.topics
                    and s.peer_id not in members
                    and s.score > PRUNE_SCORE
                    # spec MUST: a pruned link stays un-grafted until its
                    # announced backoff expires — on the pruner's side too
                    and not self._in_backoff(topic, s.peer_id)
                ),
                key=lambda s: -s.score,
            )
            for state in candidates[: D - len(members)]:
                members.add(state.peer_id)
                await self._send_control(state, graft=[topic])
        elif len(members) > D_HI:
            ranked = sorted(
                members,
                key=lambda p: self.peers[p].score if p in self.peers else 0.0,
                reverse=True,
            )
            for peer_id in ranked[D:]:
                members.discard(peer_id)
                state = self.peers.get(peer_id)
                if state is not None:
                    await self._send_control(state, prune=[topic])

    async def _emit_gossip(self, topic: str) -> None:
        """IHAVE the last HISTORY_GOSSIP windows' ids to up-to-D
        subscribed peers outside the mesh (gossipsub spec §gossip)."""
        ids = [
            mid
            for window in self._history[:HISTORY_GOSSIP]
            for mid in window
            if mid in self.mcache and self.mcache[mid][0] == topic
        ]
        if not ids:
            return
        members = self.mesh.get(topic, set())
        audience = [
            s
            for s in self.peers.values()
            if topic in s.topics and s.peer_id not in members and s.score >= 0
        ][:D]
        for state in audience:
            self._bump("ihave_sent", len(ids))
            rpc = pb.RPC()
            ih = rpc.control.ihave.add()
            ih.topic_id = topic
            ih.message_ids.extend(ids)
            await self._send_rpc(state, rpc)
