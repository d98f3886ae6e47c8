"""Req/resp and the gossip pipeline of the port, and the wire-error rule.

``tests/unit/test_network_reqresp.py`` over the port's types and sidecars:
the framing round trips, a block download (range, root, ping) from a
``ReqRespServer`` and the standalone gossip batch pipeline.  Then the port's
fault rule at the wire (``faults.is_device_fault``): a ``PortError`` during a
lane flush's verdict dispatch is counted in ``ingest_flush_error_count`` and
the scheduler goes on draining, exactly as in the JAX package; a handler's
device ``RuntimeError`` in the same kind of flush still ends the loop and is
raised from the next ``submit()``; a standalone topic's drain ends on a
device fault and ``stop()`` raises it; the pending-blocks loop contains a
wire error.
"""

import asyncio
import types

import pytest

from lambda_ethereum_consensus_tpu import pipeline as jpipe
from lambda_ethereum_consensus_tpu import telemetry as jtel
from lambda_ethereum_consensus_tpu.network import gossip as jgossip
from lambda_ethereum_consensus_tpu.network import port as jport
from lambda_ethereum_consensus_tpu_torch import pipeline as ppipe
from lambda_ethereum_consensus_tpu_torch import telemetry as ptel
from lambda_ethereum_consensus_tpu_torch.compression import compress
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.crypto.bls.native import NativeError
from lambda_ethereum_consensus_tpu_torch.faults import WireError, is_device_fault
from lambda_ethereum_consensus_tpu_torch.network import Port
from lambda_ethereum_consensus_tpu_torch.network import gossip as pgossip
from lambda_ethereum_consensus_tpu_torch.network import port as pport
from lambda_ethereum_consensus_tpu_torch.network.gossip import (
    GossipMessage,
    TopicSubscription,
    publish_ssz,
)
from lambda_ethereum_consensus_tpu_torch.network.peerbook import Peerbook
from lambda_ethereum_consensus_tpu_torch.network.port import (
    VERDICT_ACCEPT,
    PortCommandError,
    PortError,
)
from lambda_ethereum_consensus_tpu_torch.network.reqresp import (
    SUCCESS,
    BlockDownloader,
    ReqRespError,
    ReqRespServer,
    decode_request,
    decode_response_chunks,
    encode_request,
    encode_response_chunk,
    ping_peer,
)
from lambda_ethereum_consensus_tpu_torch.node import pending_blocks as PB
from lambda_ethereum_consensus_tpu_torch.store.kv import KvError
from lambda_ethereum_consensus_tpu_torch.types.beacon import (
    BeaconBlock,
    BeaconBlockBody,
    SignedBeaconBlock,
)
from lambda_ethereum_consensus_tpu_torch.types.p2p import Metadata, StatusMessage

DIGEST = b"\xba\xa4\xda\x96"


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ------------------------------------------------------------------ framing

def test_request_framing_roundtrip():
    data = b"\x01\x02\x03" * 100
    assert decode_request(encode_request(data)) == data


def test_response_chunk_roundtrip():
    chunks = (encode_response_chunk(SUCCESS, b"first block bytes", context=b"\xaa\xbb\xcc\xdd")
              + encode_response_chunk(SUCCESS, b"second", context=b"\xaa\xbb\xcc\xdd"))
    assert decode_response_chunks(chunks, context_bytes=4) == [
        (SUCCESS, b"\xaa\xbb\xcc\xdd", b"first block bytes"),
        (SUCCESS, b"\xaa\xbb\xcc\xdd", b"second"),
    ]


def test_error_chunk_has_no_context():
    chunks = encode_response_chunk(2, b"server exploded")
    assert decode_response_chunks(chunks, context_bytes=4) == [(2, b"", b"server exploded")]


# ---------------------------------------------------------------- live pair

class FakeChain:
    """ChainView over a handful of in-memory blocks."""

    def __init__(self, spec):
        self.spec = spec
        self.blocks = {slot: SignedBeaconBlock(message=BeaconBlock(slot=slot, body=BeaconBlockBody()))
                       for slot in (1, 2, 3, 5)}

    def status(self):
        return StatusMessage(fork_digest=DIGEST, finalized_root=b"\x11" * 32, finalized_epoch=0,
                             head_root=b"\x22" * 32, head_slot=5)

    def metadata(self):
        return Metadata(seq_number=7)

    def block_by_slot(self, slot):
        return self.blocks.get(slot)

    def block_by_root(self, root):
        for b in self.blocks.values():
            if b.message.hash_tree_root(self.spec) == root:
                return b
        return None


@pytest.fixture(scope="module")
def spec():
    with use_chain_spec(minimal_spec()) as s:
        yield s


def test_block_download_roundtrip(spec):
    async def main():
        server_port = await Port.start(fork_digest=DIGEST)
        client_port = await Port.start(fork_digest=DIGEST)
        chain = FakeChain(spec)
        await ReqRespServer(server_port, chain, spec).register()
        peerbook = Peerbook()
        connected = asyncio.get_running_loop().create_future()
        client_port.on_new_peer = lambda pid, addr: (
            peerbook.add_peer(pid), connected.done() or connected.set_result(pid))
        await client_port.add_peer(f"127.0.0.1:{server_port.listen_port}")
        await asyncio.wait_for(connected, 10)

        downloader = BlockDownloader(client_port, peerbook, spec)
        blocks = await downloader.request_blocks_by_range(1, 5)
        assert [b.message.slot for b in blocks] == [1, 2, 3, 5]
        assert [b.encode(spec) for b in blocks] == [chain.blocks[s].encode(spec) for s in (1, 2, 3, 5)]
        roots = [chain.blocks[2].message.hash_tree_root(spec)]
        assert [b.message.slot for b in await downloader.request_blocks_by_root(roots)] == [2]
        assert await ping_peer(client_port, server_port.node_id) == 7
        # an unknown protocol answers an error chunk, which the client raises
        with pytest.raises(PortCommandError, match="unsupported protocol"):
            await client_port.send_request(server_port.node_id, "/nope/1/", b"x")
        await client_port.close()
        await server_port.close()

    run(main())


def test_gossip_batch_pipeline(spec):
    async def main():
        a = await Port.start(fork_digest=DIGEST)
        b = await Port.start(fork_digest=DIGEST)
        await a.add_peer(f"127.0.0.1:{b.listen_port}")
        await asyncio.sleep(0.3)
        received: list[list[GossipMessage]] = []
        done = asyncio.get_running_loop().create_future()

        async def handler(batch):
            received.append(batch)
            if sum(len(x) for x in received) >= 3 and not done.done():
                done.set_result(True)
            return [VERDICT_ACCEPT] * len(batch)

        sub = TopicSubscription(b, "/eth2/test/beacon_block/ssz_snappy", handler,
                                ssz_type=SignedBeaconBlock, spec=spec)
        await sub.start()
        await asyncio.sleep(0.2)
        for slot in (10, 11, 12):
            signed = SignedBeaconBlock(message=BeaconBlock(slot=slot, body=BeaconBlockBody()))
            await publish_ssz(a, "/eth2/test/beacon_block/ssz_snappy", signed, spec)
        await asyncio.wait_for(done, 15)
        assert sorted(m.value.message.slot for batch in received for m in batch) == [10, 11, 12]
        await sub.stop()
        await a.close()
        await b.close()

    run(main())


# ------------------------------------------------------ the wire-error rule

def test_wire_errors_are_runtime_errors_but_no_device_faults():
    for cls in (PortError, PortCommandError, ReqRespError):
        assert issubclass(cls, RuntimeError) and issubclass(cls, WireError)
        assert not is_device_fault(cls("x"))
    for exc in (RuntimeError("CUDA error"), NativeError("x"), KvError("x")):
        assert is_device_fault(exc)
    for exc in (ValueError("x"), KeyError("x"), asyncio.CancelledError()):
        assert not is_device_fault(exc)


class _StubPort:
    """A port with no sidecar: it records verdicts, or raises ``error`` on
    ``validate_message`` while one is set."""

    def __init__(self, error_cls):
        self.error_cls = error_cls
        self.failing = False
        self.verdicts = []
        self.gossip = None

    async def subscribe(self, topic, handler):
        self.gossip = handler

    async def unsubscribe(self, topic):
        pass

    async def validate_message(self, msg_id, verdict):
        if self.failing:
            raise self.error_cls("sidecar is not running")
        self.verdicts.append((msg_id, verdict))


PKGS = {
    "jax": types.SimpleNamespace(pipe=jpipe, tel=jtel, gossip=jgossip, port=jport),
    "port": types.SimpleNamespace(pipe=ppipe, tel=ptel, gossip=pgossip, port=pport),
}


async def _until(cond, what: str, limit: float = 10.0):
    for _ in range(int(limit / 0.005)):
        if cond():
            return
        await asyncio.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _lane_flushes(name: str, monkeypatch) -> dict:
    """One scheduler lane fed by a ``TopicSubscription``: a flush whose
    verdict dispatch raises ``PortError``, then a good flush, then (port
    only checks it) a flush whose handler raises a device ``RuntimeError``,
    then a submit."""
    pkg = PKGS[name]
    monkeypatch.setattr(pkg.tel, "_DEFAULT", pkg.tel.Metrics(enabled=True))

    async def main():
        sched = pkg.pipe.IngestScheduler()
        sched.add_lane(pkg.pipe.LaneConfig(name="aggregate", priority=2, weight=64,
                                           max_batch=64, max_queue=1024, deadline_s=0.005,
                                           coalesce_target=4))
        port = _StubPort(pkg.port.PortError)
        calls = []
        fault = [None]

        async def handler(batch):
            calls.append([m.payload for m in batch])
            if fault[0] is not None:
                raise fault[0]
            return [pkg.port.VERDICT_ACCEPT] * len(batch)

        sub = pkg.gossip.TopicSubscription(port, "/eth2/00000000/agg/ssz_snappy", handler,
                                           scheduler=sched, lane="aggregate")
        await sub.start()
        sched.start()

        async def deliver(tags):
            for tag in tags:
                await port.gossip(sub.topic, b"id-" + tag, compress(tag), b"peer")

        port.failing = True
        await deliver([b"a1", b"a2", b"a3", b"a4"])
        await _until(lambda: len(calls) == 1 and not sched.depth and not sched._inflight,
                     "the failing flush")
        port.failing = False
        await deliver([b"b1", b"b2", b"b3", b"b4"])
        await _until(lambda: len(port.verdicts) == 4, "the good flush")
        alive = not sched._task.done()
        m = pkg.tel.get_metrics()
        out = dict(calls=calls, verdicts=list(port.verdicts), alive=alive,
                   errors=m.get("ingest_flush_error_count", lane="aggregate"),
                   crashes=m.get("ingest_loop_crash_count"))
        if name == "port":
            fault[0] = RuntimeError("CUDA error: an illegal memory access was encountered")
            await deliver([b"c1", b"c2", b"c3", b"c4"])
            await _until(lambda: sched._task.done(), "the device fault")
            with pytest.raises(RuntimeError, match="illegal memory access") as raised:
                await deliver([b"d1"])
            out.update(submit_raised=raised.value, fault_errors=m.get(
                "ingest_flush_error_count", lane="aggregate"),
                fault_crashes=m.get("ingest_loop_crash_count"))
            with pytest.raises(RuntimeError, match="illegal memory access"):
                await sched.stop()
        else:
            await sched.stop()
        return out

    return run(main(), timeout=60)


def test_port_error_in_a_lane_flush_is_counted_and_the_drain_goes_on(monkeypatch):
    want = _lane_flushes("jax", monkeypatch)
    got = _lane_flushes("port", monkeypatch)
    for out in (want, got):
        assert out["calls"][:2] == [[b"a1", b"a2", b"a3", b"a4"], [b"b1", b"b2", b"b3", b"b4"]]
        assert out["alive"]
        # the PortError flush counts its four items; the loop goes on
        assert (out["errors"], out["crashes"]) == (4, 0)
    assert got["verdicts"] == [(b"id-b%d" % i, VERDICT_ACCEPT) for i in range(1, 5)]
    assert got["verdicts"] == want["verdicts"]


def test_device_fault_in_the_same_lane_flush_ends_the_loop(monkeypatch):
    got = _lane_flushes("port", monkeypatch)
    assert got["calls"][2] == [b"c1", b"c2", b"c3", b"c4"]
    assert isinstance(got["submit_raised"], RuntimeError)
    assert not is_device_fault(PortError("x")) and is_device_fault(got["submit_raised"])
    # not counted as a contained flush error: one loop crash instead
    assert (got["fault_errors"], got["fault_crashes"]) == (4, 1)


def test_standalone_topic_drain_contains_wire_errors_and_ends_on_device_faults():
    async def main():
        port = _StubPort(PortError)
        calls = []
        fault = [None]

        async def handler(batch):
            calls.append(len(batch))
            if fault[0] is not None:
                raise fault[0]
            return [VERDICT_ACCEPT] * len(batch)

        sub = TopicSubscription(port, "/t", handler)
        await sub.start()
        port.failing = True
        await port.gossip("/t", b"m1", compress(b"x1"), b"p")
        await _until(lambda: len(calls) == 1, "the first batch")
        port.failing = False
        await port.gossip("/t", b"m2", compress(b"x2"), b"p")
        await _until(lambda: port.verdicts == [(b"m2", VERDICT_ACCEPT)], "the second batch")
        assert not sub._task.done()  # the PortError was contained
        # a handler's wire error is contained too: every item IGNOREd
        fault[0] = ReqRespError("peer went away")
        await port.gossip("/t", b"m3", compress(b"x3"), b"p")
        await _until(lambda: len(port.verdicts) == 2, "the third batch")
        assert port.verdicts[-1] == (b"m3", pport.VERDICT_IGNORE)
        fault[0] = RuntimeError("CUDA error: device-side assert triggered")
        await port.gossip("/t", b"m4", compress(b"x4"), b"p")
        await _until(lambda: sub._task.done(), "the device fault")
        with pytest.raises(RuntimeError, match="device-side assert"):
            await sub.stop()
        assert len(port.verdicts) == 2  # the faulted batch got no verdict

    run(main(), timeout=30)


def test_pending_blocks_loop_contains_wire_errors():
    class _Scan:
        def __init__(self, errors):
            self.errors = list(errors)

        async def __call__(self):
            if self.errors:
                raise self.errors.pop(0)

    async def main():
        pending = PB.PendingBlocks.__new__(PB.PendingBlocks)
        pending._fault = None
        pending._tasks = []
        scan = _Scan([PortError("hiccup"), ReqRespError("bad chunk"), None])
        scan.errors.pop()  # the third scan succeeds
        task = asyncio.ensure_future(pending._loop(scan, 0.001))
        await _until(lambda: not scan.errors, "two contained wire errors")
        await asyncio.sleep(0.01)
        assert not task.done() and pending._fault is None
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    run(main(), timeout=30)
