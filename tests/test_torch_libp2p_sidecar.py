"""The ``Port`` contract over the port's libp2p sidecar (``wire="libp2p"``).

The direct-dial cases of the JAX package's
``tests/unit/test_sidecar_libp2p.py`` against the port's ``Port`` (every
case but the discv5 bootnode, which needs discovery): the libp2p peer id,
a req/resp round trip, an unserved protocol, gossip with a verdict, a
relay through a middle node and a REJECT's score.  Then the port's own:
the key file keeps the identity, no start without ``cryptography``, and a
port ``Port`` with a JAX ``Port``, both on the libp2p wire: gossip each
way, and blocks by range, blocks by root and ping
each way with byte-equal answers, and yamux negotiated between the port's
sidecar and a JAX host.  The peer id, req/resp, unserved-protocol and
gossip cases share one sender and receiver (the ``pair`` fixture, on an
event loop of its own), so the file starts fewer sidecar processes; the
REJECT case, which lowers the sender's score, keeps a pair of its own.
Every listener binds port 0, every wait has a bound and every ``Port`` is
closed in a ``finally``.  Tolerance: none.
"""

import asyncio
import time
from pathlib import Path

import pytest

pytest.importorskip(
    "cryptography",
    reason="the libp2p sidecar needs the optional 'cryptography' module",
)

from lambda_ethereum_consensus_tpu.config import mainnet_spec as jax_mainnet_spec
from lambda_ethereum_consensus_tpu.network import Port as JaxPort
from lambda_ethereum_consensus_tpu.network import gossip as jax_gossip
from lambda_ethereum_consensus_tpu.network import reqresp as jax_reqresp
from lambda_ethereum_consensus_tpu.network.libp2p import host as jhost
from lambda_ethereum_consensus_tpu.network.peerbook import Peerbook as JaxPeerbook
from lambda_ethereum_consensus_tpu.types import beacon as jax_beacon
from lambda_ethereum_consensus_tpu.types import p2p as jax_p2p
from lambda_ethereum_consensus_tpu_torch.compression import compress
from lambda_ethereum_consensus_tpu_torch.config import mainnet_spec
from lambda_ethereum_consensus_tpu_torch.network import Port, gossip, reqresp
from lambda_ethereum_consensus_tpu_torch.network.libp2p.gossipsub import (
    REJECT_PENALTY,
    eth2_msg_id,
)
from lambda_ethereum_consensus_tpu_torch.network.peerbook import Peerbook
from lambda_ethereum_consensus_tpu_torch.network.port import (
    VERDICT_ACCEPT,
    VERDICT_REJECT,
    PortError,
)
from lambda_ethereum_consensus_tpu_torch.types import beacon
from lambda_ethereum_consensus_tpu_torch.types import p2p as port_p2p

TOPIC = "/eth2/bba4da96/beacon_block/ssz_snappy"
STATUS = "/eth2/beacon_chain/req/status/1/ssz_snappy"
DIGEST = b"\xba\xa4\xda\x96"


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=90))


@pytest.fixture(scope="module")
def pair():
    """One sender dialled into one receiver on the libp2p wire, shared by
    the cases that neither score nor restart them: (run, sender, receiver,
    the receiver's id as the sender saw it), ``run`` driving a coroutine on
    the pair's own event loop with the module's bound."""
    loop = asyncio.new_event_loop()
    ports: list = []

    def on_loop(coro):
        return loop.run_until_complete(asyncio.wait_for(coro, timeout=90))

    try:
        sender, recver, peer_id = on_loop(start_pair(ports))
        yield on_loop, sender, recver, peer_id
    finally:
        try:
            on_loop(closing(ports))
        finally:
            loop.close()


async def closing(ports):
    for port in ports:
        await port.close()


async def start_pair(ports: list, sender_cls=Port, recver_cls=Port):
    """A receiver and a sender on the libp2p wire, the sender dialled in
    (both appended to ``ports``): (sender, receiver, receiver's id as the
    sender saw it)."""
    ports.append(await recver_cls.start(wire="libp2p", fork_digest=DIGEST))
    ports.append(await sender_cls.start(wire="libp2p", fork_digest=DIGEST))
    recver, sender = ports[-2:]
    connected = asyncio.get_running_loop().create_future()
    sender.on_new_peer = lambda pid, addr: connected.done() or connected.set_result(pid)
    await sender.add_peer(f"127.0.0.1:{recver.listen_port}")
    return sender, recver, await asyncio.wait_for(connected, 10)


async def meshed(port, peer_ids, topic: str, limit_s: float = 20.0) -> dict:
    """Wait until ``port``'s sidecar has every one of ``peer_ids`` in its
    mesh for ``topic`` (a subscribed router publishes to its mesh)."""
    want = {p.hex() for p in peer_ids}
    t_end = time.monotonic() + limit_s
    while True:
        stats = await port.get_gossip_stats()
        if want <= set(stats["mesh"].get(topic, ())):
            return stats
        if time.monotonic() > t_end:
            raise AssertionError(f"no mesh on {topic} within {limit_s} s: {stats['mesh']}")
        await asyncio.sleep(0.02)


def test_identity_is_libp2p_peer_id(pair):
    _run, sender, recver, peer_id = pair
    for port in (sender, recver):
        # ed25519 identity multihash: 0x00 0x24, then the 36-byte PublicKey pb
        assert port.node_id[:4] == b"\x00\x24\x08\x01" and len(port.node_id) == 38
        assert port.enr is None  # discovery is off
    assert peer_id == recver.node_id != sender.node_id


def test_reqresp_roundtrip_over_libp2p(pair):
    on_loop, sender, recver, peer_id = pair

    async def main():
        served = {}

        async def handle(protocol_id, request_id, payload, from_peer):
            served.update(protocol=protocol_id, payload=payload, peer=from_peer)
            await recver.send_response(request_id, b"resp:" + payload)

        await recver.set_request_handler(STATUS, handle)
        reply = await sender.send_request(peer_id, STATUS, b"my-status")
        return served, reply

    served, reply = on_loop(main())
    assert served == {"protocol": STATUS, "payload": b"my-status", "peer": sender.node_id}
    assert reply == b"resp:my-status"


def test_unsupported_protocol_errors_cleanly(pair):
    on_loop, sender, _recver, peer_id = pair

    async def main():
        with pytest.raises(PortError):
            await sender.send_request(peer_id, "/eth2/nope/1/ssz_snappy", b"x")

    on_loop(main())


def test_gossip_validation_over_meshsub(pair):
    on_loop, sender, recver, _ = pair

    async def main():
        got = asyncio.get_running_loop().create_future()

        async def on_gossip(topic, msg_id, payload, from_peer):
            await recver.validate_message(msg_id, VERDICT_ACCEPT)
            if not got.done():
                got.set_result((topic, msg_id, payload, from_peer))

        await recver.subscribe(TOPIC, on_gossip)
        await sender.subscribe(TOPIC, lambda *a: None)
        await meshed(sender, [recver.node_id], TOPIC)
        await sender.publish(TOPIC, b"hello-block")
        return await asyncio.wait_for(got, 10), sender.node_id

    (topic, msg_id, payload, from_peer), sender_id = on_loop(main())
    assert (topic, payload, from_peer) == (TOPIC, b"hello-block", sender_id)
    assert msg_id == eth2_msg_id(TOPIC, b"hello-block")


def test_gossip_relays_through_middle_node_libp2p():
    """A -> B -> C, no A-C connection: C gets A's publish once B accepts
    it."""

    async def main():
        ports: list = []
        try:
            for _ in range(3):
                ports.append(await Port.start(wire="libp2p"))
            a, b, c = ports
            await a.add_peer(f"127.0.0.1:{b.listen_port}")
            await c.add_peer(f"127.0.0.1:{b.listen_port}")
            got_c = asyncio.Queue()

            async def on_b(topic, msg_id, payload, from_peer):
                await b.validate_message(msg_id, VERDICT_ACCEPT)

            async def on_c(topic, msg_id, payload, from_peer):
                await c.validate_message(msg_id, VERDICT_ACCEPT)
                await got_c.put((payload, from_peer))

            await b.subscribe(TOPIC, on_b)
            await c.subscribe(TOPIC, on_c)
            await a.subscribe(TOPIC, lambda *args: None)
            await meshed(b, [a.node_id, c.node_id], TOPIC)
            await meshed(a, [b.node_id], TOPIC)
            await a.publish(TOPIC, b"relay-me")
            return await asyncio.wait_for(got_c.get(), 10), b.node_id
        finally:
            await closing(ports)

    first, b_id = run(main())
    assert first == (b"relay-me", b_id)


def test_rejects_feed_scoring_libp2p():
    async def main():
        ports: list = []
        try:
            sender, recver, _ = await start_pair(ports)
            rejected = asyncio.get_running_loop().create_future()

            async def on_gossip(topic, msg_id, payload, from_peer):
                await recver.validate_message(msg_id, VERDICT_REJECT)
                if not rejected.done():
                    rejected.set_result(from_peer)

            await recver.subscribe(TOPIC, on_gossip)
            await sender.subscribe(TOPIC, lambda *a: None)
            await meshed(sender, [recver.node_id], TOPIC)
            await sender.publish(TOPIC, b"bad-msg")
            assert await asyncio.wait_for(rejected, 10) == sender.node_id
            t_end = time.monotonic() + 10
            while True:
                stats = await recver.get_gossip_stats()
                score = stats["peers"].get(sender.node_id.hex(), {}).get("score", 0.0)
                if score < 0 or time.monotonic() > t_end:
                    return stats, score
                await asyncio.sleep(0.02)
        finally:
            await closing(ports)

    stats, score = run(main())
    assert stats["wire"] == "libp2p"
    assert score <= -REJECT_PENALTY * 0.9  # heartbeats decay it by 0.9995 each


def test_key_file_keeps_the_identity(tmp_path):
    async def main():
        key = str(tmp_path / "node.key")
        ids = []
        for _ in range(2):
            ports = [await Port.start(wire="libp2p", key_file=key)]
            try:
                ids.append(ports[0].node_id)
            finally:
                await closing(ports)
        return ids, key

    (first, second), key = run(main())
    assert first == second and Path(key).stat().st_size == 32


def test_no_cryptography_fails_the_start(tmp_path, monkeypatch):
    """Without ``cryptography`` the libp2p sidecar's init fails and
    ``Port.start`` raises; it never runs without noise."""
    stub = tmp_path / "cryptography"
    stub.mkdir()
    (stub / "__init__.py").write_text("raise ImportError('cryptography blocked')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    with pytest.raises(PortError, match="cryptography"):
        run(Port.start(wire="libp2p"))


# ----------------------------------------- a port sidecar and a JAX sidecar

class _Chain:
    """A ``ChainView`` over blocks of slots 1, 2, 3 and 5 in one package's
    types."""

    def __init__(self, beacon_types, p2p_types, spec):
        self.spec = spec
        self.p2p = p2p_types
        self.blocks = {
            slot: beacon_types.SignedBeaconBlock(message=beacon_types.BeaconBlock(
                slot=slot, proposer_index=slot * 7, parent_root=bytes([slot]) * 32,
                body=beacon_types.BeaconBlockBody()), signature=bytes([slot]) * 96)
            for slot in (1, 2, 3, 5)
        }

    def status(self):
        return self.p2p.StatusMessage(fork_digest=DIGEST, finalized_root=b"\x11" * 32,
                                      finalized_epoch=0, head_root=b"\x22" * 32, head_slot=5)

    def metadata(self):
        return self.p2p.Metadata(seq_number=7)

    def block_by_slot(self, slot):
        return self.blocks.get(slot)

    def block_by_root(self, root):
        for b in self.blocks.values():
            if b.message.hash_tree_root(self.spec) == root:
                return b
        return None


@pytest.mark.parametrize("dialer", ["port", "jax"], ids=["port_dials", "jax_dials"])
def test_port_and_jax_libp2p_sidecars_interoperate(dialer):
    """A port ``Port`` and a JAX ``Port`` on the libp2p wire: gossip each
    way, and blocks by range, blocks by root and ping each way, every
    answer byte-equal; each side's stats show the other in its mesh."""
    spec, jspec = mainnet_spec(), jax_mainnet_spec()

    async def main():
        ports: list = []
        try:
            if dialer == "port":
                ours, theirs, _ = await start_pair(ports, sender_cls=Port, recver_cls=JaxPort)
            else:
                theirs, ours, _ = await start_pair(ports, sender_cls=JaxPort, recver_cls=Port)
            our_chain = _Chain(beacon, port_p2p, spec)
            their_chain = _Chain(jax_beacon, jax_p2p, jspec)
            await reqresp.ReqRespServer(ours, our_chain, spec).register()
            await jax_reqresp.ReqRespServer(theirs, their_chain, jspec).register()

            inbox = {"ours": asyncio.Queue(), "theirs": asyncio.Queue()}

            def on(port, box):
                async def handler(topic, msg_id, payload, from_peer):
                    await port.validate_message(msg_id, VERDICT_ACCEPT)
                    await inbox[box].put((topic, msg_id, payload, from_peer))
                return handler

            topic = gossip.topic_name(DIGEST, "beacon_block")
            await ours.subscribe(topic, on(ours, "ours"))
            await theirs.subscribe(topic, on(theirs, "theirs"))
            await meshed(ours, [theirs.node_id], topic)
            await meshed(theirs, [ours.node_id], topic)
            await gossip.publish_ssz(ours, topic, our_chain.blocks[3], spec)
            await jax_gossip.publish_ssz(theirs, topic, their_chain.blocks[5], jspec)
            got_theirs = await asyncio.wait_for(inbox["theirs"].get(), 10)
            got_ours = await asyncio.wait_for(inbox["ours"].get(), 10)
            wire3 = compress(our_chain.blocks[3].encode(spec))
            wire5 = compress(our_chain.blocks[5].encode(spec))
            assert got_theirs == (topic, eth2_msg_id(topic, wire3), wire3, ours.node_id)
            assert got_ours == (topic, eth2_msg_id(topic, wire5), wire5, theirs.node_id)

            our_book, their_book = Peerbook(), JaxPeerbook()
            our_book.add_peer(theirs.node_id)
            their_book.add_peer(ours.node_id)
            ours_dl = reqresp.BlockDownloader(ours, our_book, spec)
            theirs_dl = jax_reqresp.BlockDownloader(theirs, their_book, jspec)
            by_range = await ours_dl.request_blocks_by_range(1, 5)
            assert [b.encode(spec) for b in by_range] == [
                their_chain.blocks[s].encode(jspec) for s in (1, 2, 3, 5)]
            assert all(isinstance(b, beacon.SignedBeaconBlock) for b in by_range)
            back = await theirs_dl.request_blocks_by_range(2, 2)
            assert [b.encode(jspec) for b in back] == [
                our_chain.blocks[s].encode(spec) for s in (2, 3)]
            root = our_chain.blocks[5].message.hash_tree_root(spec)
            by_root = await ours_dl.request_blocks_by_root([root])
            assert [b.encode(spec) for b in by_root] == [their_chain.blocks[5].encode(jspec)]
            back_root = await theirs_dl.request_blocks_by_root(
                [their_chain.blocks[2].message.hash_tree_root(jspec)])
            assert [b.encode(jspec) for b in back_root] == [our_chain.blocks[2].encode(spec)]
            assert await reqresp.ping_peer(ours, theirs.node_id) == 7
            assert await jax_reqresp.ping_peer(theirs, ours.node_id) == 7
            # the muxer the port's sidecar negotiates with a JAX host
            probe = jhost.Libp2pHost()
            try:
                peer = await probe.dial("127.0.0.1", ours.listen_port)
                muxer = type(probe.connections[peer].muxer).__name__
            finally:
                await probe.close()
            return ours.enr, (await ours.get_gossip_stats())["wire"], muxer
        finally:
            await closing(ports)

    enr, wire, muxer = run(main())
    assert enr is None and wire == "libp2p" and muxer == "Yamux"
