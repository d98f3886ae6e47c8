"""The port's bespoke wire against the JAX package's.

Byte-for-byte: every ``Command``, ``Notification`` and ``P2PFrame`` kind
(seeded field values), gossip message ids, topic names and the req/resp
request and response-chunk framing.  Live: the cases of
``tests/unit/test_network_port.py`` over two port sidecars on loopback, a
port sidecar paired with a JAX sidecar (gossip both ways and a blocks by
range request each way: the wire-compatibility proof), the port's
divergences (noise is never dropped, ``wire="libp2p"`` is refused), and the
sidecar module importing with ``torch``, ``jax`` and the JAX package
blocked.
"""

import asyncio
import random
import subprocess
import sys
from pathlib import Path

import pytest

from lambda_ethereum_consensus_tpu.config import mainnet_spec as jax_mainnet_spec
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.network import Port as JaxPort
from lambda_ethereum_consensus_tpu.network import gossip as jax_gossip
from lambda_ethereum_consensus_tpu.network import reqresp as jax_reqresp
from lambda_ethereum_consensus_tpu.network import sidecar as jax_sidecar
from lambda_ethereum_consensus_tpu.network.peerbook import Peerbook as JaxPeerbook
from lambda_ethereum_consensus_tpu.network.proto import p2p_pb2 as jax_p2p_pb2
from lambda_ethereum_consensus_tpu.network.proto import port_pb2 as jax_port_pb2
from lambda_ethereum_consensus_tpu.types import beacon as jax_beacon
from lambda_ethereum_consensus_tpu.types import p2p as jax_p2p
from lambda_ethereum_consensus_tpu_torch.compression import compress
from lambda_ethereum_consensus_tpu_torch.config import mainnet_spec, minimal_spec
from lambda_ethereum_consensus_tpu_torch.network import Port
from lambda_ethereum_consensus_tpu_torch.network import gossip, reqresp, sidecar
from lambda_ethereum_consensus_tpu_torch.network import port as port_mod
from lambda_ethereum_consensus_tpu_torch.network.peerbook import Peerbook
from lambda_ethereum_consensus_tpu_torch.network.port import (
    VERDICT_ACCEPT,
    VERDICT_REJECT,
    PortCommandError,
    PortError,
)
from lambda_ethereum_consensus_tpu_torch.network.proto import p2p_pb2, port_pb2
from lambda_ethereum_consensus_tpu_torch.types import beacon
from lambda_ethereum_consensus_tpu_torch.types import p2p as port_p2p

ROOT = Path(__file__).resolve().parent.parent
DIGEST = b"\xba\xa4\xda\x96"


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


# ----------------------------------------------------- control-protocol frames

def _fill(msg, rng: random.Random, depth: int = 0) -> None:
    """Set every field of ``msg`` (oneofs excepted) to a seeded value."""
    for field in msg.DESCRIPTOR.fields:
        if field.containing_oneof is not None:
            continue
        name, typ = field.name, field.type
        repeated = field.is_repeated
        if typ == field.TYPE_MESSAGE:
            if depth < 3:
                _fill(getattr(msg, name), rng, depth + 1)
            continue
        if typ == field.TYPE_STRING:
            values = ["/%s/%d" % (name, rng.randrange(10**6)) for _ in range(3)]
        elif typ == field.TYPE_BYTES:
            values = [bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 40)))
                      for _ in range(3)]
        elif typ == field.TYPE_BOOL:
            values = [True]
        elif typ == field.TYPE_DOUBLE:
            values = [rng.random() * 1e9]
        elif typ == field.TYPE_ENUM:
            values = [field.enum_type.values[-1].number]
        elif typ == field.TYPE_UINT32:
            values = [rng.getrandbits(32)]
        else:  # uint64
            values = [rng.getrandbits(64)]
        if repeated:
            getattr(msg, name).extend(values)
        else:
            setattr(msg, name, values[0])


def _kinds(cls):
    return [f.name for f in cls.DESCRIPTOR.oneofs[0].fields]


def _frame(cls, kind: str, seed: int):
    msg = cls()
    _fill(msg, random.Random(seed))
    sub = getattr(msg, kind)
    sub.SetInParent()
    _fill(sub, random.Random(seed + 1))
    return msg


FRAME_KINDS = [
    (name, kind)
    for name in ("Command", "Notification", "P2PFrame")
    for kind in _kinds(getattr(p2p_pb2 if name == "P2PFrame" else port_pb2, name))
]


@pytest.mark.parametrize("name,kind", FRAME_KINDS, ids=[f"{n}.{k}" for n, k in FRAME_KINDS])
def test_frames_equal_jax(name, kind):
    ours_mod, theirs_mod = (
        (p2p_pb2, jax_p2p_pb2) if name == "P2PFrame" else (port_pb2, jax_port_pb2)
    )
    for seed in (1, 2, 3):
        ours = _frame(getattr(ours_mod, name), kind, seed)
        theirs = _frame(getattr(theirs_mod, name), kind, seed)
        raw = ours.SerializeToString()
        assert raw == theirs.SerializeToString()
        assert len(raw) > 4
        back = getattr(theirs_mod, name).FromString(raw)
        assert back.WhichOneof(back.DESCRIPTOR.oneofs[0].name) == kind
        assert getattr(ours_mod, name).FromString(back.SerializeToString()) == ours


def test_frame_kinds_and_descriptors_equal_jax():
    assert port_pb2.DESCRIPTOR.serialized_pb == jax_port_pb2.DESCRIPTOR.serialized_pb
    assert p2p_pb2.DESCRIPTOR.serialized_pb == jax_p2p_pb2.DESCRIPTOR.serialized_pb
    assert len(FRAME_KINDS) == 11 + 5 + 9
    assert (port_mod.VERDICT_ACCEPT, port_mod.VERDICT_REJECT, port_mod.VERDICT_IGNORE) == (0, 1, 2)


# ------------------------------------------------------ ids, topics, req/resp

def test_msg_id_topic_name_and_fork_topic_equal_jax():
    rng = random.Random(5)
    for _ in range(50):
        topic = "/eth2/%08x/beacon_attestation_%d/ssz_snappy" % (
            rng.getrandbits(32), rng.randrange(64))
        payload = bytes(rng.getrandbits(8) for _ in range(rng.randrange(300)))
        assert sidecar._msg_id(topic, payload) == jax_sidecar._msg_id(topic, payload)
        digest = bytes(rng.getrandbits(8) for _ in range(4))
        for name in ("beacon_block", "beacon_aggregate_and_proof", "blob_sidecar_3"):
            assert gossip.topic_name(digest, name) == jax_gossip.topic_name(digest, name)
    spec, jspec = minimal_spec(), jax_minimal_spec()
    for _ in range(5):
        gvr = bytes(rng.getrandbits(8) for _ in range(32))
        for epoch in (None, 0, 3, 10**6):
            for name in ("beacon_block", "voluntary_exit"):
                assert gossip.fork_topic(spec, gvr, name, epoch) == \
                    jax_gossip.fork_topic(jspec, gvr, name, epoch)


def test_reqresp_framing_equals_jax():
    rng = random.Random(9)
    for n in (0, 1, 100, 70_000):
        data = bytes(rng.getrandbits(8) for _ in range(n))
        context = bytes(rng.getrandbits(8) for _ in range(4))
        assert reqresp.encode_request(data) == jax_reqresp.encode_request(data)
        assert reqresp.decode_request(jax_reqresp.encode_request(data)) == data
        for result, ctx in ((reqresp.SUCCESS, context), (reqresp.ERROR_SERVER_ERROR, b"")):
            chunk = reqresp.encode_response_chunk(result, data, ctx)
            assert chunk == jax_reqresp.encode_response_chunk(result, data, ctx)
        stream = (reqresp.encode_response_chunk(reqresp.SUCCESS, data, context)
                  + reqresp.encode_response_chunk(reqresp.ERROR_RESOURCE_UNAVAILABLE, b"gone")
                  + reqresp.encode_response_chunk(reqresp.SUCCESS, data[:7], context))
        ours = reqresp.decode_response_chunks(stream, context_bytes=4)
        assert ours == jax_reqresp.decode_response_chunks(stream, context_bytes=4)
        assert ours == [(0, context, data), (3, b"", b"gone"), (0, context, data[:7])]
    assert [reqresp.STATUS, reqresp.GOODBYE, reqresp.PING, reqresp.METADATA_PROTOCOL,
            reqresp.BLOCKS_BY_RANGE, reqresp.BLOCKS_BY_ROOT] == [
        jax_reqresp.STATUS, jax_reqresp.GOODBYE, jax_reqresp.PING,
        jax_reqresp.METADATA_PROTOCOL, jax_reqresp.BLOCKS_BY_RANGE, jax_reqresp.BLOCKS_BY_ROOT]


def test_reqresp_malformed_framing_raises_on_both_sides():
    good = reqresp.encode_request(b"payload" * 10)
    for bad in (good[:-3], b"\x05" + good[1:], b"\xff" * 12, good[:1] + b"junk"):
        with pytest.raises(reqresp.ReqRespError):
            reqresp.decode_request(bad)
        with pytest.raises(jax_reqresp.ReqRespError):
            jax_reqresp.decode_request(bad)


# ------------------------------------------------- two port sidecars (live)

async def start_pair(fork_digest=DIGEST, cls=Port, peer_cls=Port):
    recver = await peer_cls.start(fork_digest=fork_digest)
    sender = await cls.start(fork_digest=fork_digest)
    new_peer = asyncio.get_running_loop().create_future()
    sender.on_new_peer = lambda pid, addr: new_peer.done() or new_peer.set_result(pid)
    await sender.add_peer(f"127.0.0.1:{recver.listen_port}")
    peer_id = await asyncio.wait_for(new_peer, 10)
    assert peer_id == recver.node_id
    return sender, recver, peer_id


def test_identity_and_connect():
    async def main():
        sender, recver, _ = await start_pair()
        assert len(sender.node_id) == 32 and sender.node_id != recver.node_id
        await sender.close()
        await recver.close()

    run(main())


def test_request_response_roundtrip():
    async def main():
        sender, recver, peer_id = await start_pair()

        async def handle(protocol_id, request_id, payload, from_peer):
            assert payload == b"ping payload" and from_peer == sender.node_id
            await recver.send_response(request_id, b"pong:" + payload)

        await recver.set_request_handler("/eth2/beacon_chain/req/ping/1/", handle)
        reply = await sender.send_request(peer_id, "/eth2/beacon_chain/req/ping/1/",
                                          b"ping payload")
        assert reply == b"pong:ping payload"
        with pytest.raises(PortCommandError, match="unsupported protocol"):
            await sender.send_request(peer_id, "/nope/1/", b"x")
        await sender.close()
        await recver.close()

    run(main())


def test_gossip_roundtrip_with_validation():
    async def main():
        sender, recver, _ = await start_pair()
        got = asyncio.get_running_loop().create_future()

        async def on_gossip(topic, msg_id, payload, from_peer):
            await recver.validate_message(msg_id, VERDICT_ACCEPT)
            if not got.done():
                got.set_result((topic, msg_id, payload, from_peer))

        await recver.subscribe("/eth2/test/topic/ssz_snappy", on_gossip)
        await asyncio.sleep(0.2)
        await sender.publish("/eth2/test/topic/ssz_snappy", b"gossip body")
        topic, msg_id, payload, from_peer = await asyncio.wait_for(got, 10)
        assert (topic, payload, from_peer) == (
            "/eth2/test/topic/ssz_snappy", b"gossip body", sender.node_id)
        assert msg_id == jax_sidecar._msg_id(topic, payload)
        await sender.close()
        await recver.close()

    run(main())


def test_gossip_propagates_through_middle_node():
    """A -> B -> C: C receives what A publishes only if B accepts it."""

    async def main():
        digest = b"\x01\x02\x03\x04"
        a = await Port.start(fork_digest=digest)
        b = await Port.start(fork_digest=digest, enable_peer_exchange=False)
        c = await Port.start(fork_digest=digest, enable_peer_exchange=False)
        await a.add_peer(f"127.0.0.1:{b.listen_port}")
        await c.add_peer(f"127.0.0.1:{b.listen_port}")
        await asyncio.sleep(0.3)
        got_c = asyncio.get_running_loop().create_future()

        async def on_b(topic, msg_id, payload, from_peer):
            await b.validate_message(msg_id, VERDICT_ACCEPT if payload != b"bad" else VERDICT_REJECT)

        async def on_c(topic, msg_id, payload, from_peer):
            await c.validate_message(msg_id, VERDICT_ACCEPT)
            if not got_c.done():
                got_c.set_result(payload)

        await b.subscribe("/t", on_b)
        await c.subscribe("/t", on_c)
        await asyncio.sleep(0.2)
        await a.publish("/t", b"bad")  # rejected at B, must not reach C
        await a.publish("/t", b"good")
        assert await asyncio.wait_for(got_c, 10) == b"good"
        for port in (a, b, c):
            await port.close()

    run(main())


def test_fork_digest_mismatch_filters_peer():
    async def main():
        x = await Port.start(fork_digest=b"\xaa\xaa\xaa\xaa")
        y = await Port.start(fork_digest=b"\xbb\xbb\xbb\xbb")
        connected = asyncio.get_running_loop().create_future()
        x.on_new_peer = lambda *a: connected.done() or connected.set_result(a)
        await x.add_peer(f"127.0.0.1:{y.listen_port}")
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(asyncio.shield(connected), 1.5)
        await x.close()
        await y.close()

    run(main())


def test_sidecar_crash_detected():
    async def main():
        port = await Port.start()
        exited = asyncio.get_running_loop().create_future()
        port.on_exit = lambda: exited.done() or exited.set_result(True)
        port._proc.kill()
        assert await asyncio.wait_for(exited, 10)
        assert not port.alive
        with pytest.raises(PortError, match="not running"):
            await port.publish("/t", b"x")
        await port.close()

    run(main())


def test_rejecting_peer_gets_downscored_and_disconnected():
    async def main():
        digest = b"\x05\x06\x07\x08"
        bad = await Port.start(fork_digest=digest)
        honest = await Port.start(fork_digest=digest)
        gone = asyncio.get_running_loop().create_future()
        honest.on_peer_gone = lambda peer_id: gone.done() or gone.set_result(peer_id)
        new_peer = asyncio.get_running_loop().create_future()
        honest.on_new_peer = lambda pid, addr: new_peer.done() or new_peer.set_result(pid)
        await bad.add_peer(f"127.0.0.1:{honest.listen_port}")
        assert await asyncio.wait_for(new_peer, 10) == bad.node_id
        seen = asyncio.Queue()

        async def on_gossip(topic, msg_id, payload, from_peer):
            await honest.validate_message(msg_id, VERDICT_REJECT)
            await seen.put(payload)

        await honest.subscribe("/junk", on_gossip)
        await asyncio.sleep(0.2)
        for i in range(3):  # -40 (pruned), -80, -120: past the graylist
            await bad.publish("/junk", b"junk-%d" % i)
            await asyncio.wait_for(seen.get(), 10)
        assert await asyncio.wait_for(gone, 10) == bad.node_id
        stats = await honest.get_gossip_stats()
        assert stats["wire"] == "bespoke"
        assert stats["ban_scores"][bad.node_id.hex()] < sidecar.GRAYLIST_SCORE
        await bad.close()
        await honest.close()

    run(main())


def test_mesh_grafts_between_subscribers():
    async def main():
        digest = b"\x09\x0a\x0b\x0c"
        a = await Port.start(fork_digest=digest)
        b = await Port.start(fork_digest=digest)
        await a.add_peer(f"127.0.0.1:{b.listen_port}")
        await asyncio.sleep(0.2)
        got = asyncio.get_running_loop().create_future()

        async def on_a(topic, msg_id, payload, from_peer):
            await a.validate_message(msg_id, VERDICT_ACCEPT)

        async def on_b(topic, msg_id, payload, from_peer):
            await b.validate_message(msg_id, VERDICT_ACCEPT)
            if not got.done():
                got.set_result(payload)

        await a.subscribe("/mesh", on_a)
        await b.subscribe("/mesh", on_b)
        await asyncio.sleep(1.0)  # a heartbeat: GRAFT frames settle the mesh
        stats = await a.get_gossip_stats()
        assert stats["mesh"]["/mesh"] == [b.node_id.hex()]
        assert stats["control"].get("graft_sent", 0) + stats["control"].get("graft_recv", 0) >= 1
        await a.publish("/mesh", b"over the mesh")
        assert await asyncio.wait_for(got, 10) == b"over the mesh"
        await a.close()
        await b.close()

    run(main())


def test_key_file_keeps_the_identity(tmp_path):
    async def main():
        key = str(tmp_path / "node.key")
        first = await Port.start(key_file=key)
        await first.close()
        second = await Port.start(key_file=key)
        await second.close()
        assert first.node_id == second.node_id
        assert Path(key).stat().st_size == 32

    run(main())


# --------------------------------------------------- the port's divergences

def test_libp2p_wire_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        run(Port.start(wire="libp2p"))
    out = subprocess.run(
        [sys.executable, "-m", "lambda_ethereum_consensus_tpu_torch.network.sidecar"],
        cwd=ROOT, env={"SIDECAR_WIRE": "libp2p", "PATH": ""}, input=b"",
        capture_output=True, timeout=60,
    )
    assert out.returncode != 0 and b"not ported" in out.stderr


def test_no_cryptography_fails_the_start(tmp_path, monkeypatch):
    """Without ``cryptography`` the sidecar's init fails and ``Port.start``
    raises; it never drops to plaintext."""
    stub = tmp_path / "cryptography"
    stub.mkdir()
    (stub / "__init__.py").write_text("raise ImportError('cryptography blocked')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    with pytest.raises(PortError, match="cryptography"):
        run(Port.start())


def test_retry_max_is_a_module_constant(monkeypatch):
    """``PORT_RETRY_MAX`` is read at each command (the environment is not):
    one transient failure is absorbed, a persistent one raises after
    1 + PORT_RETRY_MAX attempts, a dead sidecar is not retried."""
    from lambda_ethereum_consensus_tpu_torch.telemetry import get_metrics

    class _Proc:
        returncode = None

    def stub():
        port = Port()
        port._proc = _Proc()
        return port

    def cmd():
        c = port_pb2.Command()
        c.publish.topic = "t"
        c.publish.payload = b"x"
        return c

    monkeypatch.setattr(port_mod, "PORT_RETRY_BASE_S", 0.001)
    monkeypatch.setenv("PORT_RETRY_MAX", "9")

    async def main():
        m = get_metrics()
        m.set_enabled(True)
        before = m.get("port_retry_total", command="publish")
        port, attempts = stub(), []

        async def flaky(c, timeout):
            attempts.append(c.WhichOneof("c"))
            if len(attempts) == 1:
                raise PortError("transient sidecar hiccup")
            result = port_pb2.Result()
            result.ok = True
            return result

        port._roundtrip = flaky
        assert (await port._command(cmd())).ok
        assert attempts == ["publish", "publish"]
        assert m.get("port_retry_total", command="publish") == before + 1

        for retry_max in (0, 3):
            monkeypatch.setattr(port_mod, "PORT_RETRY_MAX", retry_max)
            port, attempts = stub(), []

            async def broken(c, timeout):
                attempts.append(1)
                raise PortError("sidecar is wedged")

            port._roundtrip = broken
            with pytest.raises(PortError):
                await port._command(cmd())
            assert len(attempts) == 1 + retry_max

        port, attempts = stub(), []

        async def dies(c, timeout):
            attempts.append(1)
            port._dead = True
            raise PortError("sidecar exited")

        port._roundtrip = dies
        with pytest.raises(PortError):
            await port._command(cmd())
        assert len(attempts) == 1

        port, attempts = stub(), []

        async def refused(c, timeout):
            attempts.append(1)
            raise PortCommandError("no")

        port._roundtrip = refused
        with pytest.raises(PortCommandError):
            await port._command(cmd())
        assert len(attempts) == 1  # a deterministic refusal is never retried

    run(main())


def test_early_peer_events_replay_in_arrival_order():
    class _Proc:
        returncode = None

    async def main():
        port = Port()
        port._proc = _Proc()
        for kind, pid in (("new", b"p1"), ("gone", b"p1"), ("new", b"p1"), ("gone", b"p2")):
            n = port_pb2.Notification()
            if kind == "new":
                n.new_peer.peer_id = pid
                n.new_peer.addr = "127.0.0.1:9"
            else:
                n.peer_gone.peer_id = pid
            await port._dispatch(n)
        seen = []
        port.on_new_peer = lambda pid, addr: seen.append(("new", pid))
        assert seen == [("new", b"p1")]  # only the prefix before a gone
        port.on_peer_gone = lambda pid: seen.append(("gone", pid))
        assert seen == [("new", b"p1"), ("gone", b"p1"), ("new", b"p1"), ("gone", b"p2")]
        assert port._early_peer_events == []
        n = port_pb2.Notification()
        n.new_peer.peer_id = b"p3"
        await port._dispatch(n)
        assert seen[-1] == ("new", b"p3")

    run(main())


# -------------------------------------------- a port sidecar and a JAX one

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


def test_port_sidecar_and_jax_sidecar_interoperate(monkeypatch):
    """A port ``Port`` (port sidecar) and a JAX ``Port`` (JAX sidecar) over
    loopback, both on noise: gossip each way, and a blocks by range, a
    blocks by root and a ping request each way, every answer byte-equal."""
    monkeypatch.delenv("SIDECAR_PLAINTEXT", raising=False)
    spec, jspec = mainnet_spec(), jax_mainnet_spec()  # the default blocks' widths

    async def main():
        ours, theirs, _ = await start_pair(cls=Port, peer_cls=JaxPort)
        our_chain = _Chain(beacon, port_p2p, spec)
        their_chain = _Chain(jax_beacon, jax_p2p, jspec)
        await reqresp.ReqRespServer(ours, our_chain, spec).register()
        await jax_reqresp.ReqRespServer(theirs, their_chain, jspec).register()

        # gossip both ways
        inbox = {"ours": asyncio.Queue(), "theirs": asyncio.Queue()}

        def on(port, box):
            async def handler(topic, msg_id, payload, from_peer):
                await port.validate_message(msg_id, VERDICT_ACCEPT)
                await inbox[box].put((topic, msg_id, payload, from_peer))
            return handler

        topic = gossip.topic_name(DIGEST, "beacon_block")
        await ours.subscribe(topic, on(ours, "ours"))
        await theirs.subscribe(topic, on(theirs, "theirs"))
        await asyncio.sleep(0.3)
        await gossip.publish_ssz(ours, topic, our_chain.blocks[3], spec)
        await jax_gossip.publish_ssz(theirs, topic, their_chain.blocks[5], jspec)
        got_theirs = await asyncio.wait_for(inbox["theirs"].get(), 10)
        got_ours = await asyncio.wait_for(inbox["ours"].get(), 10)
        wire3 = compress(our_chain.blocks[3].encode(spec))
        wire5 = compress(our_chain.blocks[5].encode(spec))
        assert got_theirs == (topic, sidecar._msg_id(topic, wire3), wire3, ours.node_id)
        assert got_ours == (topic, sidecar._msg_id(topic, wire5), wire5, theirs.node_id)

        # req/resp both ways
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
        assert [b.encode(jspec) for b in back] == [our_chain.blocks[s].encode(spec) for s in (2, 3)]
        root = our_chain.blocks[5].message.hash_tree_root(spec)
        by_root = await ours_dl.request_blocks_by_root([root])
        assert [b.encode(spec) for b in by_root] == [their_chain.blocks[5].encode(jspec)]
        assert await reqresp.ping_peer(ours, theirs.node_id) == 7
        assert await jax_reqresp.ping_peer(theirs, ours.node_id) == 7
        await ours.close()
        await theirs.close()

    run(main())


# ------------------------------------------------- the sidecar's imports

_PROBE = """
import sys
for name in ("torch", "jax", "jaxlib", "lambda_ethereum_consensus_tpu"):
    sys.modules[name] = None
import lambda_ethereum_consensus_tpu_torch.network.sidecar as s
assert s.Sidecar and s.main
mods = sorted(m for m in sys.modules if m.startswith("lambda_ethereum_consensus_tpu_torch"))
print(" ".join(mods))
"""


def test_sidecar_imports_without_torch_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert "lambda_ethereum_consensus_tpu_torch.network.gossip" not in loaded
    assert "lambda_ethereum_consensus_tpu_torch.network.sidecar" in loaded
