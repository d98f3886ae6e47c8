"""The port's beacon node against the JAX package's.

Every chain is minted by the JAX package (``chaos.fleet.make_chain``: the
minimal preset, 64 keys, five blocks, a genesis time just in the past so the
blocks and the next slot are inside the gossip window) and carried into the
port through SSZ bytes.  Every port node runs on the plain PyTorch versions
(``device="cpu"``) over the bespoke wire (``wire=None``); a JAX node on the
same chain runs beside it where values are compared side by side.

- ``test_two_nodes_sync_and_gossip[bespoke]``: the JAX package's
  ``tests/integration/test_node.py`` flow on two port nodes (range sync, a
  gossip block, a subnet attestation reaching fork choice, the highest
  stored slot, the HTTP API), each head the JAX-minted block's root, and
  the API's JSON bodies equal to a JAX node's on the same chain.
- ``test_checkpoint_sync_from_our_own_api``: a port node and a JAX node
  checkpoint-sync from a port node's API to the JAX genesis root.
- ``test_node_restart_resumes_from_db``: a restarted port node resumes at
  its stored head with the JAX node's ``resume_report``, and its chain
  view's ``status()``/``metadata()`` encode as the JAX node's.
- The topic table's rows at phase0 and deneb, the ingest scheduler's lane
  snapshot under a pinned clock, ``NodeConfig``'s shared defaults,
  ``parse_args`` and ``prefetched``/``decode_signed_blocks`` (in order and
  with errors) equal the JAX package's.
- The warmer and the device gauges: ``warm_drain_shapes`` starts the
  warmer, ``stop()`` joins it, and the tick sets the plane, watermark and
  registry-plane gauges on the CPU (no ``unattributed`` series there).
- The port's divergences: a device fault (``RuntimeError``) in the tick loop,
  in range sync or in the warmer ends that loop, counts once in
  ``node_loop_fault_total`` with a ``node_fault`` recorder event and is
  raised by ``stop()``, where a wire error and any other exception stay
  contained; ``BeaconNode`` with no card raises and installs nothing.
Tolerance: none — roots, bodies and bytes are exact.
"""

import asyncio
import dataclasses
import json
import urllib.request
from contextlib import asynccontextmanager

import pytest
import torch

from lambda_ethereum_consensus_tpu.chaos.fleet import make_chain
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.fork_choice import get_head as jax_get_head
from lambda_ethereum_consensus_tpu.node import BeaconNode as JaxBeaconNode
from lambda_ethereum_consensus_tpu.node import NodeConfig as JaxNodeConfig
from lambda_ethereum_consensus_tpu.node import __main__ as jmain
from lambda_ethereum_consensus_tpu.node import replay as jreplay
from lambda_ethereum_consensus_tpu.pipeline import scheduler as jsched
from lambda_ethereum_consensus_tpu.state_transition import accessors as jacc
from lambda_ethereum_consensus_tpu.state_transition import misc as jmisc
from lambda_ethereum_consensus_tpu.types.beacon import Checkpoint as JaxCheckpoint
from lambda_ethereum_consensus_tpu.validator import build_signed_block as jax_build_block
from lambda_ethereum_consensus_tpu.validator.duties import make_attestation as jax_attestation
from lambda_ethereum_consensus_tpu_torch import convert, faults, telemetry, tracing
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.config.presets import FORK_ORDER
from lambda_ethereum_consensus_tpu_torch.fork_choice import get_head
from lambda_ethereum_consensus_tpu_torch.network.gossip import publish_ssz, topic_name
from lambda_ethereum_consensus_tpu_torch.node import BeaconNode, NodeConfig
from lambda_ethereum_consensus_tpu_torch.node import __main__ as pmain
from lambda_ethereum_consensus_tpu_torch.node import node as node_mod
from lambda_ethereum_consensus_tpu_torch.node import replay, warmup
from lambda_ethereum_consensus_tpu_torch.pipeline import scheduler as psched
from lambda_ethereum_consensus_tpu_torch.ssz.hash import get_hash_backend

N = 64
CHAIN_LEN = 5


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def chain():
    """A fresh JAX-minted chain (a fresh wall-clock window per test) and its
    port copy: ``(bundle, port genesis, port blocks)``."""
    bundle = make_chain(n_keys=N, chain_len=CHAIN_LEN)
    spec = minimal_spec()
    genesis = convert.state_from_ssz(bundle.genesis.encode(bundle.spec), spec)
    blocks = [convert.block_from_ssz(b.encode(bundle.spec), spec) for b in bundle.blocks]
    return bundle, genesis, blocks


@asynccontextmanager
async def started(node):
    await node.start()
    try:
        yield node
    finally:
        await node.stop()


def port_node(config, spec=None):
    return BeaconNode(config, spec or minimal_spec(), device="cpu")


async def seeded(node, blocks) -> int:
    for signed in blocks:
        node.pending.add_block(signed)
    return await node.pending.process_once()


async def http_json(port: int, path: str):
    def get():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return json.loads(r.read())

    return await asyncio.get_running_loop().run_in_executor(None, get)


# ------------------------------------------------------------ the live flows

@pytest.mark.parametrize("wire", [None], ids=["bespoke"])
def test_two_nodes_sync_and_gossip(chain, tmp_path, wire):
    bundle, genesis, blocks = chain
    jspec, spec = bundle.spec, minimal_spec()
    roots = [b.message.hash_tree_root(jspec) for b in bundle.blocks]
    with jax_use_chain_spec(jspec):
        jsigned6, jstate6 = jax_build_block(bundle.tip_state, CHAIN_LEN + 1, bundle.sks, spec=jspec)
        att_subnet = jmisc.compute_subnet_for_attestation(
            jacc.get_committee_count_per_slot(
                bundle.genesis, jmisc.compute_epoch_at_slot(CHAIN_LEN, jspec), jspec),
            CHAIN_LEN, 0, jspec)
        t_epoch = jmisc.compute_epoch_at_slot(CHAIN_LEN, jspec)
        jvote = jax_attestation(
            jstate6, CHAIN_LEN, 0, jacc.get_block_root_at_slot(jstate6, CHAIN_LEN, jspec),
            JaxCheckpoint(epoch=t_epoch, root=jacc.get_block_root(jstate6, t_epoch, jspec)),
            JaxCheckpoint(epoch=jstate6.current_justified_checkpoint.epoch,
                          root=bytes(jstate6.current_justified_checkpoint.root)),
            bundle.sks, jspec, only_position=0)
    root6 = jsigned6.message.hash_tree_root(jspec)
    signed6 = convert.block_from_ssz(jsigned6.encode(jspec), spec)
    vote = convert.container_from_ssz("Attestation", jvote.encode(jspec), spec)
    subnets = (0, 1, att_subnet)

    async def main():
        with use_chain_spec(spec):
            async with started(port_node(NodeConfig(
                    db_path=str(tmp_path / "a.wal"), genesis_state=genesis,
                    enable_range_sync=False, wire=wire, attnet_subnets=subnets))) as node_a:
                assert await seeded(node_a, blocks) == CHAIN_LEN
                head_a = get_head(node_a.store, spec)
                assert head_a == roots[-1] and node_a.store.blocks[head_a].slot == CHAIN_LEN
                async with started(port_node(NodeConfig(
                        db_path=str(tmp_path / "b.wal"), genesis_state=genesis,
                        bootnodes=[f"127.0.0.1:{node_a.port.listen_port}"],
                        enable_range_sync=True, wire=wire, attnet_subnets=subnets))) as node_b:
                    for _ in range(200):
                        await node_b.pending.process_once()
                        if get_head(node_b.store, spec) == head_a:
                            break
                        await asyncio.sleep(0.1)
                    assert get_head(node_b.store, spec) == head_a, "range sync failed"

                    # the next block, gossiped from A
                    node_a.pending.add_block(signed6)
                    assert await node_a.pending.process_once() == 1
                    digest = node_a.chain.fork_digest()
                    await publish_ssz(node_a.port, topic_name(digest, "beacon_block"), signed6,
                                      spec)
                    for _ in range(200):
                        await node_b.pending.process_once()
                        if get_head(node_b.store, spec) == root6:
                            break
                        await asyncio.sleep(0.1)
                    assert get_head(node_b.store, spec) == root6, "gossip block not applied"

                    # a subnet vote into B's fork choice through its subnet lane
                    before = len(node_b.store.latest_messages)
                    await publish_ssz(node_a.port,
                                      topic_name(digest, f"beacon_attestation_{att_subnet}"),
                                      vote, spec)
                    for _ in range(200):
                        if len(node_b.store.latest_messages) > before:
                            break
                        await asyncio.sleep(0.1)
                    assert len(node_b.store.latest_messages) > before, \
                        "subnet attestation did not reach B's fork choice"
                    assert node_b.blocks_db.highest_slot() == CHAIN_LEN + 1

                    # the API over HTTP, against a JAX node on the same chain
                    bodies = await _api_bodies(node_a.api.port, root6)
                    lanes = await http_json(node_a.api.port, "/debug/lanes")
                    metrics_body = await asyncio.get_running_loop().run_in_executor(
                        None, lambda: urllib.request.urlopen(
                            f"http://127.0.0.1:{node_a.api.port}/metrics", timeout=10).read())
        with jax_use_chain_spec(jspec):
            async with started(JaxBeaconNode(JaxNodeConfig(
                    db_path=str(tmp_path / "j.wal"), genesis_state=bundle.genesis,
                    enable_range_sync=False, wire=None, attnet_subnets=subnets),
                    jspec)) as node_j:
                for signed in (*bundle.blocks, jsigned6):
                    node_j.pending.add_block(signed)
                await node_j.pending.process_once()
                assert jax_get_head(node_j.store, jspec) == root6
                want = await _api_bodies(node_j.api.port, root6)
                want_lanes = await http_json(node_j.api.port, "/debug/lanes")
        assert bodies["/eth/v1/beacon/blocks/head/root"]["data"]["root"] == "0x" + root6.hex()
        assert bodies[f"/eth/v1/beacon/blocks/{CHAIN_LEN}/root"]["data"]["root"] == \
            "0x" + roots[-1].hex()
        assert bodies[f"/eth/v2/beacon/blocks/0x{root6.hex()}"]["data"]["message"]["slot"] == \
            str(CHAIN_LEN + 1)
        assert bodies == want
        for doc in (lanes, want_lanes):
            doc["data"].pop("recorder")
            for lane in doc["data"]["lanes"]:
                lane.pop("coalesce_target")  # each package's attestation_batch_target()
        assert [lane["name"] for lane in lanes["data"]["lanes"]] == \
            ["block", "blob", "aggregate", "subnet", "other"]
        assert lanes == want_lanes
        assert b"peers_connection_count" in metrics_body

    run(main())


async def _api_bodies(port: int, root6: bytes) -> dict:
    paths = ["/eth/v1/beacon/blocks/head/root", f"/eth/v1/beacon/blocks/{CHAIN_LEN}/root",
             "/eth/v1/beacon/blocks/finalized/root", f"/eth/v2/beacon/blocks/0x{root6.hex()}",
             "/eth/v2/beacon/blocks/head", "/eth/v1/beacon/states/head/root",
             "/eth/v1/beacon/states/finalized/root", "/eth/v1/node/health"]
    return {path: await http_json(port, path) for path in paths}


def test_checkpoint_sync_from_our_own_api(chain, tmp_path):
    """A port node and a JAX node both boot by checkpoint sync from a port
    node's Beacon API, anchored on its finalized state (genesis here)."""
    bundle, genesis, _ = chain
    jspec, spec = bundle.spec, minimal_spec()
    genesis_root = bundle.genesis.hash_tree_root(jspec)

    async def main():
        with use_chain_spec(spec):
            async with started(port_node(NodeConfig(
                    db_path=str(tmp_path / "ca.wal"), genesis_state=genesis,
                    enable_range_sync=False))) as node_a:
                url = f"http://127.0.0.1:{node_a.api.port}"
                async with started(port_node(NodeConfig(
                        db_path=str(tmp_path / "cc.wal"), checkpoint_sync_url=url,
                        enable_range_sync=False))) as node_c:
                    head_c = get_head(node_c.store, spec)
                    state_c = node_c.store.block_states[head_c]
                    assert state_c.hash_tree_root(spec) == genesis_root
                    assert node_c.resume_report["source"] == "checkpoint"
                with jax_use_chain_spec(jspec):
                    async with started(JaxBeaconNode(JaxNodeConfig(
                            db_path=str(tmp_path / "cj.wal"), checkpoint_sync_url=url,
                            enable_range_sync=False, wire=None), jspec)) as node_j:
                        head_j = jax_get_head(node_j.store, jspec)
                        assert node_j.store.block_states[head_j].hash_tree_root(jspec) == \
                            genesis_root
        assert head_c == head_j

    run(main())


def test_node_restart_resumes_from_db(chain, tmp_path):
    bundle, genesis, blocks = chain
    jspec, spec = bundle.spec, minimal_spec()
    head = bundle.blocks[2].message.hash_tree_root(jspec)

    async def main():
        reports, views = [], []
        with use_chain_spec(spec):
            async with started(port_node(NodeConfig(
                    db_path=str(tmp_path / "resume.wal"), genesis_state=genesis,
                    enable_range_sync=False))) as node:
                assert await seeded(node, blocks[:3]) == 3
                assert get_head(node.store, spec) == head
            async with started(port_node(NodeConfig(
                    db_path=str(tmp_path / "resume.wal"), enable_range_sync=False))) as node2:
                assert get_head(node2.store, spec) == head
                assert node2.store.blocks[head].slot == 3
                reports.append(node2.resume_report)
                views.append(_view(node2.chain, spec))
        with jax_use_chain_spec(jspec):
            async with started(JaxBeaconNode(JaxNodeConfig(
                    db_path=str(tmp_path / "jresume.wal"), genesis_state=bundle.genesis,
                    enable_range_sync=False, wire=None), jspec)) as node:
                for signed in bundle.blocks[:3]:
                    node.pending.add_block(signed)
                await node.pending.process_once()
            async with started(JaxBeaconNode(JaxNodeConfig(
                    db_path=str(tmp_path / "jresume.wal"), enable_range_sync=False, wire=None),
                    jspec)) as node2:
                assert jax_get_head(node2.store, jspec) == head
                reports.append(node2.resume_report)
                views.append(_view(node2.chain, jspec))
        assert reports[0] == reports[1]
        assert reports[0]["source"] == "db_scan" and reports[0]["verified"] is True
        assert views[0] == views[1]

    run(main())


def _view(chain_view, spec) -> tuple:
    """A chain view's answers as bytes: status, metadata, the stored blocks
    by slot and by root."""
    status = chain_view.status()
    head = bytes(status.head_root)
    return (status.encode(spec), chain_view.metadata().encode(spec),
            chain_view.block_by_slot(2).encode(spec), chain_view.block_by_root(head).encode(spec),
            chain_view.block_by_slot(4), chain_view.fork_digest())


# ------------------------------------------------- side-by-side values, no boot

def test_topic_table_rows_equal(chain, tmp_path):
    """The rows ``_start_network`` subscribes at phase0 and at deneb, for the
    default and a sampling blob-subnet set."""
    bundle, genesis, _ = chain
    for blob_subnets in (None, (1, 4)):
        kw = dict(attnet_subnets=(3, 0, 3, 9), blob_subnets=blob_subnets)
        got = port_node(NodeConfig(db_path=str(tmp_path / "t.wal"), **kw))._topic_table()
        want = JaxBeaconNode(JaxNodeConfig(db_path=str(tmp_path / "t.wal"), **kw),
                             bundle.spec)._topic_table()
        for fork in ("phase0", "deneb"):
            rows = [_row(ts) for ts in got
                    if FORK_ORDER.index(ts.since_fork) <= FORK_ORDER.index(fork)]
            assert rows == [_row(ts) for ts in want
                            if FORK_ORDER.index(ts.since_fork) <= FORK_ORDER.index(fork)]
            names = [r[0] for r in rows]
            assert names[:5] == ["beacon_block", "beacon_aggregate_and_proof",
                                 "beacon_attestation_0", "beacon_attestation_3",
                                 "beacon_attestation_9"]
            blob = [n for n in names if n.startswith("blob_sidecar_")]
            if fork == "phase0":
                assert blob == []
            else:
                assert blob == [f"blob_sidecar_{i}" for i in (blob_subnets or range(6))]


def _row(ts) -> tuple:
    return (ts.name, ts.ssz_type.__name__, ts.handler, ts.lane, ts.since_fork, ts.max_batch,
            ts.max_queue, ts.sink, ts.subnet)


class _FixedMonotonic:
    """A stand-in for a scheduler module's ``time``: one monotonic instant."""

    import time as _time

    time = staticmethod(_time.time)
    perf_counter = staticmethod(_time.perf_counter)
    monotonic = staticmethod(lambda: 500.0)


def test_ingest_lane_snapshot_equal(tmp_path, monkeypatch):
    """``_build_ingest_scheduler``'s lanes, fed the same items at one pinned
    monotonic instant: the same snapshot, but for the attestation lanes'
    coalescing target, which is each package's ``attestation_batch_target()``
    (at most 8,192; the port's 8, the JAX package's 128 on the CPU): the
    aggregate lane's depth is past both, the subnet lane's under both."""
    from lambda_ethereum_consensus_tpu.fork_choice import attestation_batch_target as jtarget
    from lambda_ethereum_consensus_tpu_torch.fork_choice import attestation_batch_target

    class Null:
        async def process(self, items): ...

        async def shed(self, item, reason="overload"): ...

    snaps = []
    for mod, make, target in ((jsched, lambda: JaxBeaconNode(JaxNodeConfig()), jtarget),
                              (psched, lambda: port_node(NodeConfig()), attestation_batch_target)):
        monkeypatch.setattr(mod, "time", _FixedMonotonic)
        sched = make()._build_ingest_scheduler()
        sink = Null()
        for lane, n in (("block", 2), ("blob", 3), ("aggregate", 130), ("subnet", 7)):
            for i in range(n):
                sched.submit(lane, (lane, i), sink)
        snap = sched.snapshot()
        for lane in snap["lanes"]:
            if lane["name"] in ("aggregate", "subnet"):
                assert lane["coalesce_target"] == min(target(), 8192)
                lane["coalesce_target"] = None
        snaps.append(snap)
    assert snaps[1] == snaps[0]
    assert [lane["depth"] for lane in snaps[1]["lanes"]] == [2, 3, 130, 7, 0]
    assert [lane["ready"] for lane in snaps[1]["lanes"]] == [True, False, True, False, False]


def test_node_config_shared_defaults():
    """Every field both ``NodeConfig``s have defaults the same, but ``wire``;
    the port's lacks exactly the two fields with no port caller."""
    got = {f.name: f for f in dataclasses.fields(NodeConfig)}
    want = {f.name: f for f in dataclasses.fields(JaxNodeConfig)}
    assert set(want) - set(got) == {"port_wrapper", "ingest_scheduler"}
    assert set(got) <= set(want)
    port_cfg, jax_cfg = NodeConfig(), JaxNodeConfig()
    for name in got:
        if name == "wire":
            assert (port_cfg.wire, jax_cfg.wire) == (None, "libp2p")
        else:
            assert getattr(port_cfg, name) == getattr(jax_cfg, name), name


@pytest.mark.parametrize("argv", [
    [],
    ["--network", "minimal", "--db", "x.wal", "--no-sync", "--wire", "bespoke",
     "--attnets", "3,5", "--bootnodes", "127.0.0.1:9000,127.0.0.1:9001"],
    ["--checkpoint-sync", "http://127.0.0.1:5052", "--api-port", "0", "--wire", "libp2p",
     "--listen", "0.0.0.0:9000", "--log-level", "debug"],
], ids=["defaults", "bespoke", "checkpoint"])
def test_parse_args_equal(argv):
    got, want = vars(pmain.parse_args(argv)), vars(jmain.parse_args(argv))
    assert got.pop("device") is None
    if "--wire" not in argv:
        assert (got.pop("wire"), want.pop("wire")) == ("bespoke", "libp2p")
    assert got == want


def test_prefetched_and_decode_equal(chain):
    """``prefetched`` yields in order and raises at the failing item, as the
    JAX package's does; ``decode_signed_blocks`` decodes the JAX-minted
    blocks' bytes to the same bytes and fails on a truncated one where the
    JAX package's does."""

    def prep(x):
        if x == 5:
            raise ValueError(f"bad item {x}")
        return x * x

    for depth in (1, 2, 4):
        outs = []
        for mod in (jreplay, replay):
            got = []
            with pytest.raises(ValueError, match="bad item 5"):
                for y in mod.prefetched(range(8), prep, depth=depth):
                    got.append(y)
            outs.append(got)
        assert outs[0] == outs[1] == [0, 1, 4, 9, 16]
    for mod in (jreplay, replay):
        with pytest.raises(ValueError):
            list(mod.prefetched([1], prep, depth=0))
        assert list(mod.prefetched(iter(()), prep)) == []

    bundle, _, _ = chain
    raws = [b.encode(bundle.spec) for b in bundle.blocks]
    got = [b.encode(minimal_spec()) for b in replay.decode_signed_blocks(raws, minimal_spec())]
    assert got == raws
    bad = raws[:2] + [raws[2][:7]] + raws[3:]
    errors = []
    for mod, spec in ((jreplay, bundle.spec), (replay, minimal_spec())):
        seen = []
        with pytest.raises(Exception) as exc:
            for block in mod.decode_signed_blocks(bad, spec):
                seen.append(block.encode(spec))
        assert seen == raws[:2]
        errors.append(type(exc.value).__name__)
    assert errors[0] == errors[1]


# ------------------------------------------------------- the port's divergences

class _CardLost(RuntimeError):
    """A stand-in for a CUDA error out of a kernel."""


class _SidecarHiccup(faults.WireError):
    pass


@pytest.fixture
def fresh_observers(monkeypatch):
    metrics = telemetry.Metrics(enabled=True)
    monkeypatch.setattr(telemetry, "_DEFAULT", metrics)
    monkeypatch.setattr(tracing, "_RECORDER", tracing.FlightRecorder(enabled=True))
    return metrics


def _fault_events() -> list:
    return [ev["args"] for ev in tracing.get_recorder().snapshot() if ev["name"] == "node_fault"]


@pytest.mark.parametrize("exc,surfaced", [
    (_CardLost("card lost"), True), (_SidecarHiccup("sidecar hiccup"), False),
    (ValueError("bad tick"), False),
], ids=["device fault", "wire error", "other error"])
def test_tick_loop_fault_surfaces_from_stop(chain, tmp_path, monkeypatch, fresh_observers,
                                            exc, surfaced):
    _, genesis, _ = chain
    ticks = []

    def failing_tick(store, time, spec=None):
        ticks.append(time)
        raise exc

    async def main():
        node = port_node(NodeConfig(db_path=str(tmp_path / "f.wal"), genesis_state=genesis,
                                    enable_range_sync=False))
        await node.start()
        monkeypatch.setattr(node_mod, "on_tick", failing_tick)
        tick_task = node._tasks[0]
        for _ in range(60):
            if len(ticks) >= 2 or tick_task.done():
                break
            await asyncio.sleep(0.1)
        assert tick_task.done() is surfaced
        if surfaced:
            with pytest.raises(_CardLost, match="card lost"):
                await node.stop()
        else:
            assert len(ticks) >= 2  # contained: the loop ticked again
            await node.stop()
        return len(ticks)

    with use_chain_spec(minimal_spec()):
        before = get_hash_backend()
        n_ticks = run(main())
        assert get_hash_backend() is before
    assert fresh_observers.get("node_loop_fault_total", loop="tick") == (1 if surfaced else 0)
    if surfaced:
        assert n_ticks == 1
        assert _fault_events() == [{"loop": "tick", "error": "_CardLost",
                                    "message": "card lost"}]
    else:
        assert _fault_events() == []


@pytest.mark.parametrize("exc,surfaced", [
    (_CardLost("card lost in sync"), True), (ValueError("bad chunk"), False),
], ids=["device fault", "other error"])
def test_range_sync_fault_surfaces_from_stop(chain, tmp_path, monkeypatch, fresh_observers,
                                             exc, surfaced):
    _, genesis, _ = chain
    runs = []

    class FailingSync:
        def __init__(self, *args):
            pass

        async def run(self):
            runs.append(1)
            raise exc

    monkeypatch.setattr(node_mod, "SyncBlocks", FailingSync)

    async def main():
        async with started(port_node(NodeConfig(
                db_path=str(tmp_path / "s.wal"), genesis_state=genesis,
                enable_range_sync=False))) as node_a:
            node_b = port_node(NodeConfig(
                db_path=str(tmp_path / "sb.wal"), genesis_state=genesis,
                bootnodes=[f"127.0.0.1:{node_a.port.listen_port}"], enable_range_sync=True))
            await node_b.start()
            sync_task = node_b._tasks[1]
            for _ in range(100):
                if sync_task.done():
                    break
                await asyncio.sleep(0.1)
            assert sync_task.done() and runs == [1]
            if surfaced:
                with pytest.raises(_CardLost, match="card lost in sync"):
                    await node_b.stop()
            else:
                await node_b.stop()

    with use_chain_spec(minimal_spec()):
        run(main())
    assert fresh_observers.get("node_loop_fault_total", loop="range_sync") == \
        (1 if surfaced else 0)
    assert len(_fault_events()) == (1 if surfaced else 0)


def _drain_shapes():
    return warmup.DrainShapes(64, 4, 16, 8, 2, coeff_bits=8)


def test_node_warms_joins_and_samples_device_gauges(chain, tmp_path, fresh_observers):
    """``warm_drain_shapes`` starts the warmer on the node's device right
    after the backend is installed, ``stop()`` joins it, and the tick sets
    the device gauges: every plane (no ``unattributed`` series and no live
    blocks without CUDA), the watermark and the registry-plane gauges."""
    _, genesis, _ = chain

    async def main():
        node = port_node(NodeConfig(db_path=str(tmp_path / "w.wal"), genesis_state=genesis,
                                    enable_range_sync=False, warm_drain_shapes=_drain_shapes()))
        await node.start()
        warmer = node._warmer
        assert warmer is not None and warmer.name == "drain-warmer"
        await asyncio.get_running_loop().run_in_executor(None, warmer.join, 100)
        assert not warmer.is_alive()
        for _ in range(40):
            if fresh_observers.get("registry_plane_stores") or \
                    "device_plane_bytes" in fresh_observers.family_names():
                break
            await asyncio.sleep(0.1)
        await node.stop()
        assert node._warmer is None
        return node.warmer_stats

    with use_chain_spec(minimal_spec()):
        stats = run(main())
    assert set(stats) == {"overlap_s", "transition_s", "witness_s", "duties_s", "kzg_s"}
    text = fresh_observers.render_prometheus(self_scrape=False)
    for plane in ("registry_planes", "resident_epoch", "witness_buffers", "duty_sign_ladders"):
        assert f'device_plane_bytes{{plane="{plane}",sharded="0"}}' in text, plane
    assert 'plane="unattributed"' not in text
    assert "device_live_arrays" not in fresh_observers.family_names()
    assert fresh_observers.get("device_plane_bytes_watermark") == 0.0
    for family in ("device_plane_bytes_watermark", "registry_plane_stores",
                   "registry_plane_resident_bytes", "registry_plane_uploaded_cols"):
        assert family in fresh_observers.family_names(), family
    assert fresh_observers.get_histogram("warmup_phase_seconds", phase="drain")[3] == 1


@pytest.mark.parametrize("exc,surfaced", [
    (_CardLost("card lost while warming"), True), (ValueError("bad shape"), False),
], ids=["device fault", "other error"])
def test_warmer_fault_surfaces_from_stop(chain, tmp_path, monkeypatch, fresh_observers,
                                         exc, surfaced):
    """A device fault in the warmer lands in ``warmer_stats["error"]``,
    counts once in ``node_loop_fault_total{loop="warmer"}`` and is raised by
    ``stop()``; any other exception only lands in the stats."""
    _, genesis, _ = chain

    def planted(*args, **kwargs):
        raise exc

    monkeypatch.setattr(warmup, "warm_drain_programs", planted)

    async def main():
        node = port_node(NodeConfig(db_path=str(tmp_path / "wf.wal"), genesis_state=genesis,
                                    enable_range_sync=False, warm_drain_shapes=_drain_shapes()))
        await node.start()
        if surfaced:
            with pytest.raises(_CardLost, match="card lost while warming"):
                await node.stop()
        else:
            await node.stop()
        return node.warmer_stats

    with use_chain_spec(minimal_spec()):
        stats = run(main())
    assert stats == {"error": f"{type(exc).__name__}: {exc}"}
    assert fresh_observers.get("node_loop_fault_total", loop="warmer") == (1 if surfaced else 0)
    assert _fault_events() == ([{"loop": "warmer", "error": "_CardLost",
                                 "message": "card lost while warming"}] if surfaced else [])


def test_node_without_a_card_raises(monkeypatch):
    """``device=None`` is the card: without one the constructor raises and
    installs no hash backend; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = get_hash_backend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BeaconNode(NodeConfig(), minimal_spec())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BeaconNode(NodeConfig(), minimal_spec(), device="cuda")
    assert get_hash_backend() is before
