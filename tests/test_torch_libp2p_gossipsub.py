"""The port's gossipsub v1.1: the cases of the JAX package's
``tests/unit/test_gossipsub_wire.py`` against the port's modules.

RPC bytes against go-libp2p-pubsub's ``pb/rpc.proto`` layout, the varint
framing, and routers on real /meshsub/1.1.0 streams over port hosts on
loopback: a publish reaching a validator, a REJECT downscoring without
forwarding, a negative score kept across a reconnect, IHAVE/IWANT
recovery and a relay through a middle node.  Every wait polls a condition
with a bound.  Tolerance: none.
"""

import asyncio
import time

import pytest

pytest.importorskip(
    "cryptography",
    reason="libp2p identity/noise needs the optional 'cryptography' module",
)

from lambda_ethereum_consensus_tpu_torch.compression.snappy import compress as raw_compress
from lambda_ethereum_consensus_tpu_torch.network.libp2p import gossipsub as gs
from lambda_ethereum_consensus_tpu_torch.network.libp2p.host import Libp2pHost
from lambda_ethereum_consensus_tpu_torch.network.proto import gossipsub_pb2 as pb

TOPIC = "/eth2/bba4da96/beacon_block/ssz_snappy"


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


async def until(cond, limit_s: float = 10.0) -> None:
    t_end = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"condition not met within {limit_s} s")
        await asyncio.sleep(0.005)


# ------------------------------------------------------------- wire bytes

def test_rpc_subscription_bytes():
    rpc = pb.RPC()
    sub = rpc.subscriptions.add()
    sub.subscribe = True
    sub.topicid = "t"
    assert rpc.SerializeToString() == bytes.fromhex("0a050801120174")


def test_rpc_publish_strict_nosign_bytes():
    rpc = pb.RPC()
    msg = rpc.publish.add()
    msg.data = b"\xaa\xbb"
    msg.topic = "top"
    assert rpc.SerializeToString() == b"\x12\x09\x12\x02\xaa\xbb\x22\x03top"


def test_rpc_control_graft_bytes():
    rpc = pb.RPC()
    rpc.control.graft.add().topic_id = "t"
    assert rpc.SerializeToString() == b"\x1a\x05\x1a\x03\x0a\x01t"


def test_varint_delimited_framing():
    rpc = pb.RPC()
    rpc.control.iwant.add().message_ids.append(b"\x01" * 20)
    body = rpc.SerializeToString()
    assert gs.encode_rpc(rpc) == bytes([len(body)]) + body


# ------------------------------------------------------------- propagation

async def _mesh_pair():
    """Two connected routers subscribed to TOPIC, each in the other's mesh."""
    h1, h2 = Libp2pHost(), Libp2pHost()
    g1, g2 = gs.Gossipsub(h1), gs.Gossipsub(h2)
    host, port = await h2.listen()
    await h1.dial(host, port)
    await until(lambda: h1.peer_id in g2.peers)  # the accept side registered
    await g1.subscribe(TOPIC)
    await g2.subscribe(TOPIC)
    await until(lambda: TOPIC in g1.peers[h2.peer_id].topics
                and TOPIC in g2.peers[h1.peer_id].topics)
    await g1._maintain(TOPIC)
    await g2._maintain(TOPIC)
    await until(lambda: h2.peer_id in g1.mesh[TOPIC] and h1.peer_id in g2.mesh[TOPIC])
    return (h1, g1), (h2, g2)


async def _close(*hosts):
    for h in hosts:
        await h.close()


def test_publish_reaches_subscriber_and_validator_gates():
    async def main():
        (h1, g1), (h2, g2) = await _mesh_pair()
        got = []

        async def validator(topic, data, msg_id, peer_id):
            got.append((topic, data, msg_id, peer_id))
            return gs.ACCEPT

        g2.validator = validator
        try:
            msg_id = await g1.publish(TOPIC, raw_compress(b"a beacon block"))
            await until(lambda: got)
            await until(lambda: msg_id in g2.mcache)
        finally:
            await _close(h1, h2)
        return got, msg_id, h1.peer_id

    got, msg_id, sender = run(main())
    assert got == [(TOPIC, raw_compress(b"a beacon block"), msg_id, sender)]


def test_reject_downscores_and_does_not_forward():
    async def main():
        (h1, g1), (h2, g2) = await _mesh_pair()
        verdicts = []

        async def reject_all(topic, data, msg_id, peer_id):
            verdicts.append(msg_id)
            return gs.REJECT

        g2.validator = reject_all
        try:
            msg_id = await g1.publish(TOPIC, raw_compress(b"bad"))
            await until(lambda: g2.peers[h1.peer_id].score < 0)
            return (g2.peers[h1.peer_id].score, msg_id in g2.mcache, msg_id in g2.seen,
                    verdicts == [msg_id])
        finally:
            await _close(h1, h2)

    score, cached, seen, once = run(main())
    assert score <= -gs.REJECT_PENALTY + 1e-9
    assert seen and not cached and once


def test_negative_score_survives_reconnect():
    async def main():
        (h1, g1), (h2, g2) = await _mesh_pair()

        async def reject_all(topic, data, msg_id, peer_id):
            return gs.REJECT

        g2.validator = reject_all
        try:
            await g1.publish(TOPIC, raw_compress(b"bad-1"))
            await until(lambda: g2.peers[h1.peer_id].score < 0)
            bad = h1.peer_id
            before = g2.peers[bad].score
            g2._drop_peer(bad)  # the connection dies
            assert g2.retained_scores[bad] == before
            await g2._on_peer(bad, "127.0.0.1:1")  # and comes back
            return before, g2.peers[bad].score
        finally:
            await _close(h1, h2)

    before, after = run(main())
    assert before <= -gs.REJECT_PENALTY + 1e-9 and after == before


def test_ihave_iwant_recovery():
    """A peer outside the mesh learns an id by IHAVE and pulls the message
    with IWANT.  The first publish has reached it before its caches are
    wiped, and a backoff keeps it out of the mesh through the heartbeat, so
    only IHAVE/IWANT can deliver the message again."""

    async def main():
        (h1, g1), (h2, g2) = await _mesh_pair()
        payload = raw_compress(b"gossiped block")
        try:
            msg_id = await g1.publish(TOPIC, payload)
            await until(lambda: msg_id in g2.seen)
            g1.mesh[TOPIC].clear()
            g1._note_backoff(TOPIC, h2.peer_id)  # no re-graft by the heartbeat
            g2.mcache.pop(msg_id, None)
            g2.seen.pop(msg_id, None)
            received = []

            async def validator(topic, data, mid, peer_id):
                received.append((mid, data))
                return gs.ACCEPT

            g2.validator = validator
            await g1.heartbeat()  # rotates the window, IHAVEs g2
            await until(lambda: received)
            return received, msg_id, g1.control_stats, g2.control_stats, g1.mesh[TOPIC]
        finally:
            await _close(h1, h2)

    received, msg_id, c1, c2, mesh = run(main())
    assert received == [(msg_id, raw_compress(b"gossiped block"))]
    assert (c1["ihave_sent"], c2["ihave_recv"], c2["iwant_sent"], c1["iwant_served"]) == \
        (1, 1, 1, 1)
    assert not mesh


def test_three_node_mesh_relay():
    """A -> B -> C with no A-C connection: C gets A's publish through B."""

    async def main():
        ha, hb, hc = Libp2pHost(), Libp2pHost(), Libp2pHost()
        ga, gb, gc = gs.Gossipsub(ha), gs.Gossipsub(hb), gs.Gossipsub(hc)
        try:
            bhost, bport = await hb.listen()
            await ha.dial(bhost, bport)
            await hc.dial(bhost, bport)
            await until(lambda: ha.peer_id in gb.peers and hc.peer_id in gb.peers)
            for g in (ga, gb, gc):
                await g.subscribe(TOPIC)
            await until(lambda: all(TOPIC in s.topics for g in (ga, gb, gc)
                                    for s in g.peers.values()))
            for g in (ga, gb, gc):
                await g._maintain(TOPIC)
            await until(lambda: {ha.peer_id, hc.peer_id} <= gb.mesh[TOPIC]
                        and hb.peer_id in ga.mesh[TOPIC] and hb.peer_id in gc.mesh[TOPIC])
            seen_c = []

            async def validator(topic, data, msg_id, peer_id):
                seen_c.append((data, peer_id))
                return gs.ACCEPT

            gc.validator = validator
            payload = raw_compress(b"relayed block")
            await ga.publish(TOPIC, payload)
            await until(lambda: seen_c)
            return seen_c, payload, hb.peer_id
        finally:
            await _close(ha, hb, hc)

    seen_c, payload, relay = run(main())
    assert seen_c == [(payload, relay)]


def test_strict_nosign_violation_is_penalised():
    """A publish carrying ``from``/``seqno`` is dropped unvalidated and
    costs the sender REJECT_PENALTY, as in the JAX router."""

    async def main():
        (h1, g1), (h2, g2) = await _mesh_pair()
        validated = []

        async def validator(topic, data, msg_id, peer_id):
            validated.append(data)
            return gs.ACCEPT

        g2.validator = validator
        try:
            rpc = pb.RPC()
            msg = rpc.publish.add()
            msg.topic, msg.data, msg.seqno = TOPIC, raw_compress(b"signed"), b"\x01"
            await g1._send_rpc(g1.peers[h2.peer_id], rpc)
            await until(lambda: g2.peers[h1.peer_id].score < 0)
            return g2.peers[h1.peer_id].score, validated
        finally:
            await _close(h1, h2)

    score, validated = run(main())
    assert score == -gs.REJECT_PENALTY and validated == []
