"""BeaconNode: the whole client wired together.

Startup order mirrors the reference's supervision tree (ref: application.ex:
26-45): persistence -> anchor selection (DB resume | checkpoint sync |
provided genesis, ref: fork_choice/supervisor.ex:16-44) -> fork-choice store
-> network sidecar (restarted on crash) -> req/resp server -> gossip topics
-> pending-blocks loops -> range sync -> tick loop -> Beacon API.

The port's copy of the JAX package's ``node/node.py``.  What differs:

- **The device.** ``BeaconNode(config, spec=None, device=None)``: ``None``
  is the card (``ops.sha256.resolve_device``), and the constructor raises
  where there is none; ``"cpu"`` runs the plain PyTorch versions.  That one
  device carries the SSZ hash backend ``start()`` installs (``stop()`` puts
  the previous one back), the Beacon API server, the pending blocks' scan,
  the attestation drains, the blob drain's fold and the duty scheduler.
  No environment variable picks a path.
- **Device faults are surfaced.** Where the JAX package logs every
  exception away (the tick loop, a duty firing and its publication, range
  sync, the gossip-stats poll), the port asks ``faults.is_device_fault``:
  a device fault ends that loop (no duty fires after it), counts once in
  ``node_loop_fault_total{loop}``, puts a ``node_fault`` event on the
  flight recorder and is raised by the next :meth:`BeaconNode.stop`, which
  also raises what ended the ingest scheduler's drain or a pending-blocks
  loop, after its whole teardown.  Wire errors (``faults.WireError``) and
  every other exception stay contained as in the JAX package.
- **The wire.** ``NodeConfig.wire`` defaults to ``None``, the bespoke
  sidecar; ``"libp2p"`` runs the libp2p sidecar with discovery off
  (``host:port`` bootnodes only), and ``Port.start`` takes no ENR
  ``attnets``/``syncnets`` (``attnet_subnets`` is still validated).
- **Knobs.** ``GOSSIP_STATS_POLL_S`` is a class constant (the environment
  is not read).  ``NodeConfig`` has no ``port_wrapper`` and no
  ``ingest_scheduler`` (the node always drains through its ingest
  scheduler); lanes carry no ``shape_kind``.
- **The warmer.** ``NodeConfig.warm_drain_shapes`` starts
  ``warmup.start_warmer`` on the node's device right after the device
  backend is installed; ``stop()`` joins it (10 s bound).  A device fault in
  the warmer counts in ``node_loop_fault_total{loop="warmer"}`` and is
  raised by ``stop()``, as for the node's loops.
- **Device telemetry.** The tick samples the JAX package's gauges from the
  port's sources: ``device_live_arrays`` is the CUDA allocator's count of
  active blocks and ``device_plane_bytes{plane,sharded}`` resolves
  ``ops/profile``'s planes against ``torch.cuda.memory_allocated()`` (no
  ``unattributed`` series and no live-array gauge in a process that has not
  initialised CUDA; ``sharded`` is always ``"0"``), beside the watermark,
  the cost table's entry metrics, the registry-plane gauges, the
  attestation-context gauges, the flight recorder's gauges and drop counter
  and the forensics ring drops.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from ..api.beacon_api import BeaconApiServer
from ..config import ChainSpec, constants, get_chain_spec
from ..config.presets import FORK_ORDER
from ..da import DataAvailability
from ..faults import is_device_fault
from ..fork_choice import (
    ConsensusForensics,
    Store,
    attestation_batch_target,
    get_forkchoice_store,
    get_head,
    on_attestation_batch,
    on_tick,
)
from ..network import Port
from ..network.gossip import TopicSubscription, _topic_short, topic_name
from ..network.peerbook import Peerbook
from ..network.port import VERDICT_ACCEPT, VERDICT_IGNORE, VERDICT_REJECT
from ..network.reqresp import BlockDownloader, ReqRespServer
from ..ops import bls_batch
from ..ops import profile as ops_profile
from ..ops.sha256 import install_device_backend, resolve_device
from ..pipeline import IngestScheduler, LaneConfig
from ..slo import get_engine
from ..state_transition import misc
from ..store import (
    BlockStore,
    KvStore,
    StateStore,
    get_finalized_anchor,
    set_finalized_anchor,
)
from ..tracing import (
    SlotClock,
    get_recorder,
    observe_block_arrival,
    observe_head_update,
)
from ..types.beacon import BeaconBlock, BeaconBlockBody, BeaconState, SignedBeaconBlock
from ..types.validator import SignedAggregateAndProof
from .chain import LiveChainView
from .pending_blocks import PendingBlocks
from .sync import SyncBlocks
from .telemetry import Metrics, get_metrics, telemetry_enabled
from .warmup import DrainShapes, start_warmer

log = logging.getLogger("node")

# recorder-overwrite counter cursor (see _sample_device_telemetry): the
# flight recorder is process-wide, so the export cursor must be too
_trace_dropped_exported = 0


@dataclass(frozen=True)
class TopicSpec:
    """One row of the fork-aware gossip topic table.

    ``_start_network`` used to hard-code the capella topic set inline;
    every fork since would have meant another copy of the subscription
    boilerplate.  Now forks only ADD rows: a row joins the mesh when the
    chain's current fork (``spec.fork_at_epoch``) has reached
    ``since_fork``.  ``handler``/``sink`` are bound-method NAMES so the
    table itself is a frozen value (rebuilt per network (re)start)."""

    name: str  # short topic name (topic_name() adds digest + ssz_snappy)
    ssz_type: object
    handler: str  # BeaconNode method: async (batch) -> verdicts
    lane: str = "other"  # ingest-scheduler lane
    since_fork: str = "phase0"
    max_batch: int = 64
    max_queue: int = 1024
    # shared-lane sink method: one flush spanning every topic of the
    # lane (gossip.SharedLaneSink); None = per-topic flushes
    sink: str | None = None
    # subnet id baked into the handler (functools.partial) for
    # subnet-family topics; None for singleton topics
    subnet: int | None = None


@dataclass
class NodeConfig:
    db_path: str = "beacon.wal"
    listen_addr: str = "127.0.0.1:0"
    bootnodes: list[str] = field(default_factory=list)
    api_port: int = 0
    checkpoint_sync_url: str | None = None
    genesis_state: BeaconState | None = None
    anchor_block: BeaconBlock | None = None
    enable_range_sync: bool = True
    # None/"" = the bespoke-frame sidecar (the default until discovery is
    # ported); "libp2p" = real multistream/noise/yamux|mplex/meshsub, with
    # discovery off: host:port bootnodes only
    wire: str | None = None
    # attestation subnets to subscribe (beacon_attestation_{i} topics;
    # ref: gossipsub.ex:16-34 scaffolds the 64-subnet set).  Neither wire
    # advertises an ENR here, so no attnets bitfield is written
    attnet_subnets: tuple[int, ...] = (0, 1)
    # warm the device paths for these drain shapes on a background thread
    # started with the device backend (node/warmup.py), so the first real
    # drain finds every kernel and operator loaded
    warm_drain_shapes: DrainShapes | None = None
    # per-lane flush deadlines: blocks drain near-immediately; the
    # attestation lanes trade up to this much latency for device-sized
    # batches under light load (the shed/deadline regimes are measured
    # by scripts/bench_pipeline.py)
    ingest_block_deadline_ms: int = 25
    ingest_attestation_deadline_ms: int = 150
    # global admission budget, deliberately BELOW the sum of per-lane
    # caps (1024 + 2x16384 + 1024): the cross-lane shed policy (evict
    # the lowest-priority backlogged lane) must engage while the block
    # and aggregate lanes still have headroom — at the sum, a lane's own
    # full-check always fires first and the policy would be dead code
    ingest_max_items: int = 24576
    # validator keys this node operates (validator index -> 32-byte
    # secret key): a non-empty map arms the duty scheduler —
    # attestations at 1/3 slot, aggregation at 2/3, block proposal at
    # the boundary, all batch-signed through the duty_sign plane
    duty_keys: dict | None = None
    # fleet-observatory identity: the label stamped into wire
    # trace contexts on publish and onto this node's flight-recorder
    # process row — co-resident fleet members stay distinguishable in
    # ONE merged Perfetto export.  None = single-node (no stamping; the
    # pre-round-22 wire byte for byte).
    node_label: str | None = None
    # data-availability sampling: the blob_sidecar_{i}
    # subnets this node joins once deneb is active.  None = every
    # subnet (a full-DA node); a proper subset makes the DA gate a
    # SAMPLING node — block import waits only for blob indices whose
    # column (index % BLOB_SIDECAR_SUBNET_COUNT) maps onto these
    # subnets (da/availability.py)
    blob_subnets: tuple[int, ...] | None = None
    # blob lane flush deadline: sidecars should coalesce into one
    # RLC-folded pairing check per block's worth, but must not hold
    # block import hostage — tighter than attestations, looser than
    # blocks
    ingest_blob_deadline_ms: int = 50


class BeaconNode:
    def __init__(self, config: NodeConfig, spec: ChainSpec | None = None, device=None):
        self.config = config
        self.spec = spec or get_chain_spec()
        # where every device path of the node runs: None is the card, and
        # raises here where there is none
        self.device = resolve_device(device)
        # per-NODE registry for node-identity gauges (peer count, sync
        # slot, head slot): co-resident nodes in one process must not
        # clobber each other's values.  The hot paths below the node
        # runtime (ssz, fork_choice, network) record spans into the
        # process-wide default registry instead; /metrics merges both
        # (api/beacon_api.py — the family sets are disjoint).
        self.metrics = Metrics(enabled=telemetry_enabled())
        self.kv: KvStore | None = None
        self.blocks_db: BlockStore | None = None
        self.states_db: StateStore | None = None
        self.store: Store | None = None
        self.port: Port | None = None
        self.peerbook = Peerbook()
        self.pending: PendingBlocks | None = None
        self.da: DataAvailability | None = None
        self._kzg_setup = None  # lazily-built trusted setup (spec width)
        self.api: BeaconApiServer | None = None
        self.slot_clock: SlotClock | None = None
        self.duties = None  # DutyScheduler when config.duty_keys is set
        self._duty_task: asyncio.Task | None = None
        self._head_root: bytes | None = None  # last head seen by _on_applied
        # consensus forensics plane: per-NODE for the same
        # reason as the metrics registry above — co-resident fleet
        # members each keep their own reorg/evidence story.  Attached to
        # the store in start() so the free-function handlers reach it
        # via getattr(store, "forensics", None).
        self.forensics = ConsensusForensics()
        self._tasks: list[asyncio.Task] = []
        self._subs: list[TopicSubscription] = []
        self.ingest: IngestScheduler | None = None
        self._stopping = False
        # durability plane: the finalized epoch whose snapshot
        # pointer + fsync barrier have been persisted, and how the boot
        # anchor was chosen (source, verification, WAL recovery report)
        self._persisted_finalized_epoch = -1
        self._finality_warned_epoch = -1
        self.resume_report: dict = {}
        self.device_backend = None
        self._prev_hash_backend = None
        # the background warmer (config.warm_drain_shapes) and its stats
        self._warmer = None
        self.warmer_stats: dict = {}
        # the device fault that ended one of the node's loops: stop() raises it
        self._fault: BaseException | None = None
        # subnet gossip validation state: committees-per-slot + shuffling
        # seed memo and the one-vote-per-validator-per-epoch IGNORE cache
        # (epoch -> cells)
        self._cps_memo: dict[tuple[int, bytes], tuple[int, bool, bytes]] = {}
        self._cps_fallback_memo: dict[tuple[int, bytes], tuple[int, bytes]] = {}
        # per-target vote-cell discriminator, (value, is_seed): sticky
        # once seed-derived so recorded cell keys never change; a
        # provisional target-root stand-in (no state yet) upgrades to the
        # seed — safe because cells are only recorded for ACCEPTed votes,
        # which require the target block (hence a seed source) to be known
        self._vote_cell_disc: dict[tuple[int, bytes], tuple[bytes, bool]] = {}
        self._seen_subnet_votes: dict[int, set] = {}
        # per-peer gossip-health plumbing: the last sidecar
        # stats snapshot (served at /debug/peers), counter cursors for
        # delta emission (the sidecar reports totals; a restart resets
        # them), and the bounded poll task
        self._gossip_stats: dict = {}
        self._gossip_stats_ts: float = 0.0
        self._gossip_poll_task: asyncio.Task | None = None
        self._gossip_poll_mono: float = 0.0
        self._peer_stat_cursor: dict[tuple[str, str], tuple[int, int]] = {}
        self._control_cursor: dict[str, int] = {}

    # ------------------------------------------------------------- startup

    async def start(self) -> None:
        spec = self.spec
        self._install_device_paths()
        self.kv = KvStore(self.config.db_path)
        self.blocks_db = BlockStore(self.kv)
        self.states_db = StateStore(self.kv)

        anchor_state, anchor_block, anchor_root = await self._select_anchor()
        self.store = get_forkchoice_store(
            anchor_state, anchor_block, spec, anchor_root=anchor_root
        )
        self.store.forensics = self.forensics
        # catch the store up to wall clock immediately (ref: on_tick_now at
        # fork_choice/store.ex:65-82) so blocks are acceptable before the
        # first timer tick
        on_tick(self.store, int(time.time()), spec)
        # slot-phase clock for the delay histograms and /debug/slot —
        # pure math over genesis_time/SECONDS_PER_SLOT, shared with the
        # API server so both report the same slot arithmetic
        self.slot_clock = SlotClock(
            int(self.store.genesis_time),
            int(spec.SECONDS_PER_SLOT),
            constants.INTERVALS_PER_SLOT,
        )
        if self.config.duty_keys:
            from ..validator import DutyScheduler

            self.duties = DutyScheduler(
                self.config.duty_keys, spec, clock=self.slot_clock,
                device=self.device,
            )
            log.info(
                "duty scheduler armed: %d keys", len(self.config.duty_keys)
            )
        anchor_root = anchor_root or anchor_block.hash_tree_root(spec)
        self.blocks_db.store_block(
            SignedBeaconBlock(message=anchor_block), spec, root=anchor_root
        )
        self.states_db.store_state(anchor_root, anchor_state, spec)

        self.chain = LiveChainView(self.store, self.blocks_db, spec)
        # the DA gate exists on every node (pre-deneb it simply never
        # registers an expectation, so is_available is always True) —
        # the pending-blocks scan and the blob drain share this instance
        self.da = DataAvailability(spec, subnets=self.config.blob_subnets)
        await self._start_network()

        self.pending = PendingBlocks(
            self.store,
            spec,
            downloader=self.downloader,
            on_applied=self._on_applied,
            da_gate=self.da,
            device=self.device,
        )
        self.pending.start()

        self._tasks.append(asyncio.ensure_future(self._tick_loop()))
        if self.config.enable_range_sync:
            self._tasks.append(asyncio.ensure_future(self._range_sync()))

        self.api = BeaconApiServer(
            self.store,
            spec,
            metrics=self.metrics,
            node_id=self.port.node_id,
            port=self.config.api_port,
            node=self,  # /debug/lanes + /debug/slot read live node state
            device=self.device,
        )
        await self.api.start()
        log.info(
            "node up: p2p=%s api=%s head=%s",
            self.port.listen_port,
            self.api.port,
            # graftlint: disable=async-blocking — one cold head walk at
            # the end of startup, before any gossip is flowing
            get_head(self.store, spec).hex()[:16],
        )

    def _install_device_paths(self) -> None:
        """Make the node's device its engine, with no env vars: install the
        device SSZ hash backend (Merkleization) on it; the BLS, KZG and
        state-transition paths take the same device per call: device
        paths are not opt-in sidecars to the product."""
        from ..ssz.hash import get_hash_backend

        self._prev_hash_backend = get_hash_backend()
        self.device_backend = install_device_backend(self.device)
        log.info("device paths ON: SSZ hashing + BLS routed to %s", self.device)
        if self.config.warm_drain_shapes is not None:
            self._warmer = start_warmer(
                self.config.warm_drain_shapes, self.warmer_stats, device=self.device,
                on_fault=lambda exc: self._fail("warmer", exc),
            )
            log.info("drain-program warmer started")

    async def _select_anchor(self) -> tuple[BeaconState, BeaconBlock, bytes | None]:
        """DB resume | checkpoint sync | provided genesis
        (ref: fork_choice/supervisor.ex:16-44).

        Returns ``(state, block, root_override)`` — the override is set when
        only the block *header* is known (checkpoint sync), so the store is
        keyed by the real block root rather than a reconstructed block's.

        DB resume is VERIFIED — the finalized snapshot pointer
        is tried first, then the bounded highest-slot scan, and every
        candidate must Merkle-root to the ``state_root`` its stored block
        committed to before it is adopted.  A store whose candidates all
        fail verification falls through to checkpoint sync (or provided
        genesis) instead of booting on bad data.
        """
        spec = self.spec
        resumed = self._resume_from_db()
        if resumed is not None:
            return resumed
        if self.config.checkpoint_sync_url:
            from ..api.checkpoint_sync import sync_from_checkpoint

            state = await sync_from_checkpoint(self.config.checkpoint_sync_url, spec)
            header = state.latest_block_header.copy(
                # graftlint: disable=async-blocking — one anchor-state root
                # during startup; nothing else is scheduled on the loop yet
                state_root=state.hash_tree_root(spec)
            )
            anchor = BeaconBlock(
                slot=header.slot,
                proposer_index=header.proposer_index,
                parent_root=bytes(header.parent_root),
                state_root=bytes(header.state_root),
                body=BeaconBlockBody(),
            )
            self.resume_report["source"] = "checkpoint"
            # the header root IS the finalized block's root; descendants
            # reference it as parent_root
            return state, anchor, header.hash_tree_root(spec)
        if self.config.genesis_state is not None:
            self.resume_report["source"] = "genesis"
            state = self.config.genesis_state
            anchor = self.config.anchor_block or BeaconBlock(
                slot=state.slot,
                proposer_index=0,
                parent_root=b"\x00" * 32,
                # graftlint: disable=async-blocking — genesis-state root at
                # startup, before the loop serves anything
                state_root=state.hash_tree_root(spec),
                body=BeaconBlockBody(),
            )
            return state, anchor, None
        raise RuntimeError(
            "no anchor available: provide genesis_state or checkpoint_sync_url"
        )

    def _resume_from_db(
        self,
    ) -> tuple[BeaconState, BeaconBlock, bytes] | None:
        """Verified DB resume: newest verified state first (the node
        resumes at its head), the fsync-barriered finalized snapshot
        pointer as the durable floor when nothing recent verifies.

        Resume = (checksummed WAL replay, done by KvStore on open) +
        state-root verification of the candidate against its stored
        block.  The WAL recovery report and the verification outcome
        land in ``self.resume_report`` so harnesses (chaos churn, the
        crash gate) can assert HOW the node booted, not just that it
        did."""
        import time as _time

        spec = self.spec
        t0 = _time.monotonic()
        report = self.resume_report = {
            "source": None,
            "verified": False,
            "recovery": dict(self.kv.recovery),
        }
        anchor_root = get_finalized_anchor(self.kv)
        candidate = None
        # newest verified state first (the node resumes at its head);
        # the fsync-barriered finalized snapshot is the durable FLOOR —
        # tried when every recent candidate fails verification, before
        # giving up on the DB entirely
        got = self.states_db.get_latest_verified_state(self.blocks_db, spec)
        if got is not None:
            candidate = (got[0], got[1], "db_scan")
        elif anchor_root is not None:
            state = self.states_db.verified_state(
                anchor_root, self.blocks_db, spec
            )
            if state is not None:
                log.warning(
                    "no recent state verified; resuming from the "
                    "finalized snapshot %s", anchor_root.hex()[:16],
                )
                candidate = (anchor_root, state, "db_finalized")
        had_data = anchor_root is not None or (
            self.states_db.get_latest_state(spec) is not None
        )
        if candidate is None:
            if had_data:
                # data exists but nothing verifies: the fall-through to
                # checkpoint sync / provided genesis is the POINT —
                # booting on an unverified anchor is how a corrupt store
                # becomes a consensus fault
                log.error(
                    "DB resume rejected: no stored state passed state-root "
                    "verification; falling back to checkpoint sync/genesis"
                )
                report["source"] = "db_rejected"
            return None
        root, state, source = candidate
        block = self.blocks_db.get_block(root, spec)
        report.update(source=source, verified=True)
        self._persisted_finalized_epoch = int(
            state.finalized_checkpoint.epoch
        )
        elapsed = _time.monotonic() - t0
        # process-wide registry: the storage_recovery_p95 SLO row (crash
        # gate, churn power-loss scenario) reads the default registry the
        # engine aggregates, not this node's identity gauges
        get_metrics().observe("storage_recovery_seconds", elapsed)
        log.info(
            "resuming from verified stored state at slot %d (%s, %.3fs)",
            state.slot, source, elapsed,
        )
        # the stored key is authoritative (a checkpoint anchor's
        # reconstructed block hashes differently from its real root)
        return state, block.message, root

    def _persist_finality(self) -> None:
        """The fsync barrier at finalization: when the finalized checkpoint
        advances, make sure its state snapshot is stored, point
        ``finalized|anchor`` at it, and push one batched durability
        barrier — so an unclean kill loses at most the unfinalized window,
        never a finalized record.  The WAL's userspace buffer drains every
        finalization tick too, not only on clean ``stop()``."""
        if self.kv is None or self.store is None:
            return
        fin = self.store.finalized_checkpoint
        epoch = int(fin.epoch)
        if epoch <= self._persisted_finalized_epoch:
            return
        root = bytes(fin.root)
        state = self.store.block_states.get(root)
        if state is not None and not self.states_db.has_state(root):
            self.states_db.store_state(root, state, self.spec)
        if not (
            self.blocks_db.has_block(root)
            and (state is not None or self.states_db.has_state(root))
        ):
            # the snapshot cannot be written yet (state not materialized,
            # block unknown): drain the buffer but do NOT latch the
            # epoch — the pointer write retries on the next tick, and
            # the gauge keeps telling the truth about what is durable
            self.kv.flush()
            if self._finality_warned_epoch != epoch:
                self._finality_warned_epoch = epoch
                log.warning(
                    "finalized epoch %d root %s has no stored snapshot "
                    "yet; anchor pointer deferred", epoch, root.hex()[:16],
                )
            return
        set_finalized_anchor(self.kv, root)
        self.kv.barrier(reason="finality")
        self._persisted_finalized_epoch = epoch
        self.metrics.set_gauge("storage_finalized_epoch", float(epoch))
        get_recorder().record(
            "inst", 0, "finality_barrier",
            {"epoch": epoch, "root": root.hex()[:16]},
        )

    async def _start_network(self) -> None:
        # on restart: drop pipelines bound to the dead sidecar first
        for sub in self._subs:
            sub.cancel()
        self._subs.clear()
        digest = self.chain.fork_digest()
        for i in set(self.config.attnet_subnets):
            if not 0 <= i < 64:
                # fail at startup, not inside the sidecar-restart loop
                raise ValueError(f"attestation subnet id out of range: {i}")
        # no ENR is advertised on either wire (discovery is not ported), so
        # no attnets/syncnets ride along (the port's Port.start takes none)
        self.port = await Port.start(
            listen_addr=self.config.listen_addr,
            bootnodes=self.config.bootnodes,
            fork_digest=digest,
            # noise identity survives restarts: bans stay bound to the key
            key_file=self.config.db_path + ".sidecar_key",
            wire=self.config.wire,
        )
        self.port.on_new_peer = self._on_new_peer
        self.port.on_peer_gone = self._on_peer_gone
        self.port.on_exit = self._on_sidecar_exit
        self.downloader = BlockDownloader(self.port, self.peerbook, self.spec)
        if self.pending is not None:  # restart: rebind to the live port
            self.pending.downloader = self.downloader
        self.reqresp = ReqRespServer(self.port, self.chain, self.spec)
        await self.reqresp.register()

        # the shared ingest scheduler: one priority drain over every
        # topic (pipeline/) — a sidecar restart rebuilds it so no lane
        # holds items bound to dead subscriptions
        if self.ingest is not None:
            ingest, self.ingest = self.ingest, None
            await ingest.stop()  # raises what ended its drain loop
        self.ingest = sched = self._build_ingest_scheduler()
        sched.start()

        # gossip topics (ref: gossipsub.ex:16-34), now table-driven: one
        # fork-aware TopicSpec row per topic instead of a hard-coded
        # capella set.  Rows gated behind a later fork (deneb blob
        # sidecars) activate when the chain's CURRENT fork reaches them;
        # a sidecar restart after a fork transition picks up the new rows
        # (subscriptions are rebuilt here on every (re)start).
        from ..network.gossip import SharedLaneSink

        import functools

        epoch = int(self.store.current_slot(self.spec)) // int(
            self.spec.SLOTS_PER_EPOCH
        )
        active_fork = FORK_ORDER.index(self.spec.fork_at_epoch(epoch))
        sinks: dict[str, SharedLaneSink] = {}
        for ts in self._topic_table():
            if FORK_ORDER.index(ts.since_fork) > active_fork:
                continue
            handler = getattr(self, ts.handler)
            if ts.subnet is not None:
                handler = functools.partial(handler, ts.subnet)
            sink = None
            if ts.sink is not None:
                # one sink per lane: a flush spanning N subnet topics is
                # ONE batched verify, not N per-topic fragments
                sink = sinks.get(ts.sink)
                if sink is None:
                    sink = sinks[ts.sink] = SharedLaneSink(
                        getattr(self, ts.sink), label=f"{ts.lane}_lane"
                    )
            sub = TopicSubscription(
                self.port, topic_name(digest, ts.name), handler,
                ssz_type=ts.ssz_type, spec=self.spec,
                max_batch=ts.max_batch, max_queue=ts.max_queue,
                metrics=self.metrics,
                scheduler=sched, lane=ts.lane,
                sink=sink, node=self.config.node_label,
            )
            await sub.start()
            self._subs.append(sub)

    def _blob_subnet_ids(self) -> tuple[int, ...]:
        count = int(self.spec.get("BLOB_SIDECAR_SUBNET_COUNT", 6))
        if self.config.blob_subnets is None:
            return tuple(range(count))
        subs = tuple(sorted({int(s) for s in self.config.blob_subnets}))
        for s in subs:
            if not 0 <= s < count:
                # fail at startup, not inside the sidecar-restart loop
                raise ValueError(f"blob subnet id out of range: {s}")
        return subs

    def _topic_table(self) -> list[TopicSpec]:
        """The fork-aware gossip surface.  Forks append rows; nothing
        else about subscription wiring changes per fork."""
        from ..types.beacon import Attestation
        from ..types.deneb import BlobSidecar

        # attestation channels take deep batches: the device drain's
        # fixed dispatch cost amortizes across thousands of signatures,
        # and one mainnet slot already carries ~1k aggregates
        ATT_BATCH, ATT_QUEUE = 8192, 16384
        table = [
            TopicSpec(
                name="beacon_block", ssz_type=SignedBeaconBlock,
                handler="_on_block_batch", lane="block",
            ),
            TopicSpec(
                name="beacon_aggregate_and_proof",
                ssz_type=SignedAggregateAndProof,
                handler="_on_aggregate_batch", lane="aggregate",
                max_batch=ATT_BATCH, max_queue=ATT_QUEUE,
            ),
        ]
        # attestation subnets: unaggregated votes, one topic per subnet,
        # drained through the SAME batched-RLC verify as aggregates —
        # and, under the scheduler, one SHARED lane: a flood on any
        # subnet competes with the other subnets, never with blocks
        for i in sorted(set(self.config.attnet_subnets)):
            table.append(TopicSpec(
                name=f"beacon_attestation_{i}", ssz_type=Attestation,
                handler="_on_attestation_batch", lane="subnet",
                max_batch=ATT_BATCH, max_queue=ATT_QUEUE,
                sink="_on_subnet_sink_batch", subnet=i,
            ))
        # deneb blob sidecars: one topic per sampled column, one shared
        # lane — a flush verifies in a single RLC-folded pairing check
        for i in self._blob_subnet_ids():
            table.append(TopicSpec(
                name=f"blob_sidecar_{i}", ssz_type=BlobSidecar,
                handler="_on_blob_sidecar_batch", lane="blob",
                since_fork="deneb",
                sink="_on_blob_sink_batch", subnet=i,
            ))
        return table

    def _build_ingest_scheduler(self) -> IngestScheduler:
        """Lane model: blocks > aggregates > subnet
        attestations > other.  Deficit weights keep the attestation
        lanes from starving each other while strict priority order
        keeps block import latency bounded under any flood; the
        attestation lanes coalesce to the device path's minimum
        worthwhile batch (fork_choice.attestation_batch_target); the port
        snaps no flush onto shape buckets."""
        cfg = self.config
        att_deadline = cfg.ingest_attestation_deadline_ms / 1000.0
        att_target = min(attestation_batch_target(), 8192)
        sched = IngestScheduler(
            metrics=self.metrics, max_items=self.config.ingest_max_items
        )
        sched.add_lane(LaneConfig(
            name="block", priority=0, weight=64, max_batch=64, max_queue=1024,
            deadline_s=cfg.ingest_block_deadline_ms / 1000.0, coalesce_target=1,
            # blocks chain parent-first: a full lane drops the incoming
            # message (the old queue-full behavior) rather than evicting
            # a queued ancestor and orphaning its descendants
            shed_newest=True,
        ))
        # blob sidecars sit between blocks and attestations: a block
        # cannot apply until its sampled columns verify, so sidecars must
        # not starve behind an attestation flood — but they coalesce to a
        # block's worth so a flush is ONE RLC-folded pairing check.  A
        # full lane sheds the incoming message (withholding adversaries
        # must not evict queued honest sidecars).
        sched.add_lane(LaneConfig(
            name="blob", priority=1, weight=64, max_batch=64, max_queue=1024,
            deadline_s=cfg.ingest_blob_deadline_ms / 1000.0,
            coalesce_target=int(self.spec.get("MAX_BLOBS_PER_BLOCK", 6)),
            shed_newest=True,
        ))
        sched.add_lane(LaneConfig(
            name="aggregate", priority=2, weight=4096, max_batch=8192,
            max_queue=16384, deadline_s=att_deadline,
            coalesce_target=att_target,
        ))
        sched.add_lane(LaneConfig(
            name="subnet", priority=3, weight=4096, max_batch=8192,
            max_queue=16384, deadline_s=att_deadline,
            coalesce_target=att_target,
        ))
        # catch-all for non-core topics (sync committees, slashings, BLS
        # changes — future subscriptions); empty until one is wired, and
        # excluded from the budget picture by the explicit max_items
        sched.add_lane(LaneConfig(
            name="other", priority=4, weight=64, max_batch=64, max_queue=1024,
            deadline_s=0.2, coalesce_target=16,
        ))
        return sched

    # ------------------------------------------------------------- handlers

    def _on_new_peer(self, peer_id: bytes, addr: str) -> None:
        self.peerbook.add_peer(peer_id)
        self.metrics.set_gauge("peers_connection_count", len(self.peerbook))

    def _on_peer_gone(self, peer_id: bytes) -> None:
        self.peerbook.remove_peer(peer_id)
        self.metrics.set_gauge("peers_connection_count", len(self.peerbook))

    async def _on_sidecar_exit(self) -> None:
        if self._stopping:
            return
        log.warning("network sidecar died; restarting")
        self.metrics.inc("sidecar_restarts")
        await asyncio.sleep(1.0)
        if not self._stopping:
            try:
                await self._start_network()
            except Exception as exc:
                if not is_device_fault(exc):
                    raise
                self._fail("network", exc)

    async def _on_block_batch(self, batch) -> list[int]:
        """Batched gossip blocks -> pending set (one decode pass; signature
        verification happens in on_block)."""
        verdicts = []
        head_slot = self.store.current_slot(self.spec)
        for msg in batch:
            block = msg.value
            self.metrics.inc("network_gossip_count", type="beacon_block")
            if self.slot_clock is not None:
                # arrival offset into the block's OWN slot: the slot-
                # phase histogram that says whether blocks reach us in
                # time to attest (decode follows admission within the
                # flush deadline, so this is admission-accurate)
                offset = observe_block_arrival(
                    self.slot_clock, int(block.message.slot)
                )
                # weight-event log: a late block that later flips the
                # head is named (with this offset) in the ReorgRecord's
                # attribution.  No root here — merkleizing on the gossip
                # admission path would break the O(1)-per-event budget;
                # the forensic join keys on (slot, arrival offset).
                self.forensics.note_block_arrival(
                    None, int(block.message.slot), offset
                )
                if msg.trace is not None:
                    msg.trace.event(
                        "slot_phase",
                        slot=int(block.message.slot),
                        offset_s=round(offset, 4),
                    )
            # within-one-epoch window check (ref: gossip_handler.ex:21)
            if abs(block.message.slot - head_slot) <= self.spec.SLOTS_PER_EPOCH:
                self.pending.add_block(block)
                if msg.trace is not None:
                    msg.trace.event("apply", kind="pending_queue")
                verdicts.append(VERDICT_ACCEPT)
            else:
                verdicts.append(VERDICT_IGNORE)
        return verdicts

    def _attestation_drain(self, batch, extract, metric_type: str) -> list[int]:
        """Shared drain for both attestation channels: one batched RLC
        signature check (fork_choice.on_attestation_batch) and the
        three-way verdict mapping — invalid signatures REJECT (the
        sidecar downscores and eventually disconnects the sender; an
        IGNORE would never penalize anyone)."""
        self.metrics.inc("network_gossip_count", value=len(batch), type=metric_type)
        results = on_attestation_batch(
            self.store,
            [extract(msg) for msg in batch],
            is_from_block=False,
            spec=self.spec,
            # fan-in link: the ONE batched verify span records its
            # member item traces (and each accepted member observes the
            # admission->apply slot-phase histogram)
            traces=[msg.trace for msg in batch],
            device=self.device,
        )
        # an attestation batch can reorg the head onto an already-applied
        # block with no _on_applied involved — observe that too
        self._observe_head_transition()
        return [
            VERDICT_ACCEPT
            if err is None
            else (VERDICT_REJECT if getattr(err, "reject", False) else VERDICT_IGNORE)
            for err in results
        ]

    async def _on_aggregate_batch(self, batch) -> list[int]:
        return self._attestation_drain(
            batch, lambda msg: msg.value.message.aggregate, "aggregate_and_proof"
        )

    def _committees_per_slot_at(
        self, target
    ) -> tuple[int, bool, bytes] | None:
        """``(committees_per_slot, authoritative, shuffling_seed)`` for the
        target epoch.

        ``authoritative`` is True only when the materialized checkpoint
        state answered — approximations (target block's post-state, the
        justified state during sync) can cross a committee-count boundary,
        and a REJECT issued from one would penalize honest peers, so the
        caller must downgrade mismatches to IGNORE for those.  A
        non-authoritative memo entry upgrades itself once the checkpoint
        state materializes.  The attester shuffling seed rides along (from
        the same resolved state) as the one-vote-cell discriminator."""
        from ..config import constants
        from ..fork_choice.store import checkpoint_key
        from ..state_transition import accessors

        key = checkpoint_key(target)
        hit = self._cps_memo.get(key)
        if hit is not None and (hit[1] or key not in self.store.checkpoint_states):
            return hit
        state = self.store.checkpoint_states.get(key)
        authoritative = state is not None
        if state is None:
            state = self.store.block_states.get(bytes(target.root))
        if state is None:
            # sync-time fallback: the justified state, memoized under its
            # own key so gossip doesn't pay an O(registry) active-set scan
            # per message while targets are still being fetched
            epoch = int(target.epoch)
            jroot = bytes(self.store.justified_checkpoint.root)
            fhit = self._cps_fallback_memo.get((epoch, jroot))
            if fhit is not None:
                return fhit[0], False, fhit[1]
            jstate = self.store.block_states.get(jroot)
            if jstate is None:
                return None
            cps = accessors.get_committee_count_per_slot(jstate, epoch, self.spec)
            seed = accessors.get_seed(
                jstate, epoch, constants.DOMAIN_BEACON_ATTESTER, self.spec
            )
            if len(self._cps_fallback_memo) > 64:
                self._cps_fallback_memo.clear()
            self._cps_fallback_memo[(epoch, jroot)] = (cps, seed)
            return cps, False, seed
        cps = accessors.get_committee_count_per_slot(
            state, int(target.epoch), self.spec
        )
        seed = accessors.get_seed(
            state, int(target.epoch), constants.DOMAIN_BEACON_ATTESTER, self.spec
        )
        if len(self._cps_memo) > 64:
            self._cps_memo.clear()
        self._cps_memo[key] = (cps, authoritative, seed)
        return cps, authoritative, seed

    async def _on_attestation_batch(self, subnet: int, batch) -> list[int]:
        """Standalone-mode entry: one subnet topic's own drain."""
        return self._subnet_attestation_drain([(subnet, msg) for msg in batch])

    async def _on_subnet_sink_batch(self, pairs) -> list[int]:
        """Scheduler-mode entry: ONE flush spanning every subscribed
        subnet topic (gossip.SharedLaneSink) — all votes land in a
        single batched RLC verify instead of per-topic fragments.  Each
        vote's subnet comes from its topic name (``beacon_attestation_{i}``,
        the same authority the per-topic handlers bind at wiring time),
        so a subscription needs no side-channel attribute to join the
        sink."""
        return self._subnet_attestation_drain(
            [(int(sub.topic_label.rsplit("_", 1)[1]), msg) for sub, msg in pairs]
        )

    async def _on_blob_sidecar_batch(self, subnet: int, batch) -> list[int]:
        """Standalone-mode entry: one blob subnet topic's own drain."""
        return self._blob_sidecar_drain([(subnet, msg) for msg in batch])

    async def _on_blob_sink_batch(self, pairs) -> list[int]:
        """Scheduler-mode entry: ONE flush spanning every subscribed
        blob_sidecar topic (gossip.SharedLaneSink) — all sidecars in the
        flush verify in a single RLC-folded pairing check."""
        return self._blob_sidecar_drain(
            [(int(sub.topic_label.rsplit("_", 1)[1]), msg) for sub, msg in pairs]
        )

    def _kzg_trusted_setup(self):
        if self._kzg_setup is None:
            from ..da import trusted_setup

            self._kzg_setup = trusted_setup(self.spec)
        return self._kzg_setup

    def _blob_sidecar_drain(self, tagged) -> list[int]:
        """blob_sidecar_{i} gossip validation (p2p spec deneb):

        - REJECT structurally misrouted sidecars (index beyond
          MAX_BLOBS_PER_BLOCK, or on the wrong subnet for its index) —
          compliant peers penalize a node that re-propagates these
        - REJECT commitment-linkage mismatches against a block's
          advertised commitment list (the DA gate's expectation)
        - the whole flush's KZG proofs fold into ONE pairing check
          (da.kzg.verify_blob_batch); only a failing fold pays the
          per-item bisect, so the all-valid common case is one pairing
        - verified sidecars feed the DA gate: the sidecar that completes
          a block's sampled column set unparks it in pending-blocks
        """
        from ..da import verify_blob_batch, verify_blob_proof
        from ..telemetry import inc

        spec = self.spec
        max_blobs = int(spec.get("MAX_BLOBS_PER_BLOCK", 6))
        subnet_count = int(spec.get("BLOB_SIDECAR_SUBNET_COUNT", 6))
        verdicts: list[int | None] = [None] * len(tagged)
        items = []  # (pos, root, sidecar, msg)
        for pos, (subnet, msg) in enumerate(tagged):
            sc = msg.value
            self.metrics.inc("network_gossip_count", type="blob_sidecar")
            index = int(sc.index)
            if index >= max_blobs or index % subnet_count != subnet:
                verdicts[pos] = VERDICT_REJECT
                continue
            root = sc.signed_block_header.message.hash_tree_root(spec)
            # linkage pre-check against an already-registered block
            # expectation: an advertised-commitment mismatch REJECTs
            # before paying for the pairing check
            expected = self.da.expected_commitment(root, index)
            if expected is not None and expected != bytes(sc.kzg_commitment):
                inc("da_sidecars_total", 1, result="mismatch")
                verdicts[pos] = VERDICT_REJECT
                continue
            items.append((pos, root, sc, msg))
        if items:
            setup = self._kzg_trusted_setup()
            blobs = [bytes(sc.blob) for _, _, sc, _ in items]
            comms = [bytes(sc.kzg_commitment) for _, _, sc, _ in items]
            proofs = [bytes(sc.kzg_proof) for _, _, sc, _ in items]
            if verify_blob_batch(blobs, comms, proofs, setup=setup, device=self.device):
                ok = [True] * len(items)
            else:
                # one bad sidecar must not take honest flush-mates down
                # with it: re-check each item on its own
                ok = [
                    verify_blob_proof(b, c, p, setup=setup)
                    for b, c, p in zip(blobs, comms, proofs)
                ]
            for (pos, root, sc, msg), valid in zip(items, ok):
                if not valid:
                    verdicts[pos] = VERDICT_REJECT
                    continue
                linkage = self.da.on_sidecar(
                    root, int(sc.index), bytes(sc.kzg_commitment)
                )
                if linkage == "mismatch":
                    verdicts[pos] = VERDICT_REJECT
                elif linkage == "duplicate":
                    verdicts[pos] = VERDICT_IGNORE
                else:  # accept | complete | orphan (block not seen yet)
                    verdicts[pos] = VERDICT_ACCEPT
                if msg.trace is not None and linkage == "complete":
                    msg.trace.event("apply", kind="da_complete")
        return [VERDICT_IGNORE if v is None else v for v in verdicts]

    def _subnet_attestation_drain(self, tagged) -> list[int]:
        """Subnet gossip validation (p2p spec beacon_attestation_{i}:
        without these REJECTs the node re-propagates misrouted messages
        compliant peers penalize) then the shared batched drain:

        - REJECT unless exactly one aggregation bit is set
        - REJECT when the committee maps to a different subnet
        - IGNORE duplicate (validator, epoch) votes — keyed by the
          (epoch, slot, index, bit, shuffling-seed) cell.  The cell only
          pins one validator per epoch UNDER ONE SHUFFLING: the seed
          discriminates competing forks whose different shufflings put a
          DIFFERENT validator in the same (slot, index, bit) cell (an
          honest first-seen vote on the other fork is not IGNOREd), while
          forks that share the shuffling (divergence after the seed's
          randao mix) still collide — the same validator's second vote at
          one epoch stays IGNOREd, as the p2p spec requires.  The
          discriminator is sticky once seed-derived (recorded cell keys
          must never reflow); a provisional target-root stand-in (no
          state can answer yet) upgrades to the seed, which is safe
          because only ACCEPTed votes record cells and acceptance
          requires the target block — hence a seed source — to be known
        """
        from ..state_transition.misc import compute_subnet_for_attestation

        verdicts: list[int | None] = [None] * len(tagged)
        passed, passed_pos, passed_keys = [], [], []
        batch_keys: set = set()  # dedupe same-validator cells WITHIN the batch
        for pos, (subnet, msg) in enumerate(tagged):
            att = msg.value
            bits = att.aggregation_bits
            if bits.count() != 1:
                verdicts[pos] = VERDICT_REJECT
                continue
            cps_auth = self._committees_per_slot_at(att.data.target)
            seed = None
            if cps_auth is not None:
                cps, authoritative, seed = cps_auth
                if int(att.data.index) >= cps or compute_subnet_for_attestation(
                    cps, int(att.data.slot), int(att.data.index), self.spec
                ) != subnet:
                    # approximate committee counts can mis-map honest
                    # messages across a count boundary — only the real
                    # checkpoint state justifies penalizing the sender
                    verdicts[pos] = (
                        VERDICT_REJECT if authoritative else VERDICT_IGNORE
                    )
                    continue
            epoch = int(att.data.target.epoch)
            tkey = (epoch, bytes(att.data.target.root))
            hit = self._vote_cell_disc.get(tkey)
            if hit is not None and hit[1]:
                disc = hit[0]  # seed-derived: sticky, keys never reflow
            elif seed is not None:
                # first seed-based resolution (or an upgrade from the
                # provisional stand-in — no cells were recorded under it:
                # ACCEPT requires the target block, hence a seed source)
                disc = seed
                self._vote_cell_disc[tkey] = (seed, True)
            else:
                # no state to derive the seed from yet: the target root is
                # the coarser stand-in (never merges distinct shufflings)
                disc = bytes(att.data.target.root)
                self._vote_cell_disc[tkey] = (disc, False)
            key = (int(att.data.slot), int(att.data.index), bits.indices()[0], disc)
            if (
                key in self._seen_subnet_votes.get(epoch, ())
                or (epoch, key) in batch_keys
            ):
                verdicts[pos] = VERDICT_IGNORE
                # the IGNORE is correct for fork choice, but a duplicate
                # cell carrying a DIFFERENT head root is a double vote —
                # retained as ledger evidence instead of vanishing here
                self.forensics.note_vote(
                    (epoch,) + key, bytes(att.data.beacon_block_root)
                )
                continue
            batch_keys.add((epoch, key))
            # first-seen root for the cell, recorded BEFORE the verify
            # verdict lands so a same-batch twin still compares roots
            self.forensics.note_vote(
                (epoch,) + key, bytes(att.data.beacon_block_root)
            )
            passed.append(msg)
            passed_pos.append(pos)
            passed_keys.append((epoch, key))
        if passed:
            inner = self._attestation_drain(
                passed, lambda msg: msg.value, "beacon_attestation"
            )
            current_epoch = misc.compute_epoch_at_slot(
                self.store.current_slot(self.spec), self.spec
            )
            for pos, verdict, (epoch, key) in zip(passed_pos, inner, passed_keys):
                verdicts[pos] = verdict
                if verdict == VERDICT_ACCEPT:
                    self._seen_subnet_votes.setdefault(epoch, set()).add(key)
            # prune epochs that can no longer appear on gossip
            for epoch in [
                e for e in self._seen_subnet_votes if e < current_epoch - 1
            ]:
                del self._seen_subnet_votes[epoch]
            for tkey in [
                k for k in self._vote_cell_disc if k[0] < current_epoch - 1
            ]:
                del self._vote_cell_disc[tkey]
        return verdicts

    def _on_applied(self, root: bytes, signed: SignedBeaconBlock) -> None:
        self.blocks_db.store_block(signed, self.spec)
        self.states_db.store_state(root, self.store.block_states[root], self.spec)
        self.metrics.set_gauge("sync_store_slot", signed.message.slot)
        # a block apply can advance finality mid-slot; barrier now rather
        # than waiting for the next tick (still batched per epoch)
        self._persist_finality()
        self._observe_head_transition()

    def _observe_head_transition(self) -> None:
        """Record the head-update slot-phase metric whenever the cached
        fork-choice head differs from the last head we observed — called
        after block applies AND after attestation batches, so a weight
        reorg onto an already-applied competing block (no apply involved)
        still lands in ``head_update_delay_seconds`` and the recorder.
        Delay is measured against the NEW head block's slot start;
        catch-up blocks from old slots honestly report huge delays —
        that is the point."""
        cache = self.store.head_cache
        if cache is None or self.slot_clock is None:
            return
        head = cache.head()
        if head is None or head == self._head_root:
            return
        head_block = self.store.blocks.get(head)
        if head_block is None:
            return
        first = self._head_root is None
        prev = self._head_root
        self._head_root = head
        # serving-plane invalidation: the response/proof
        # caches key hot entries by resolved head root — evict the STALE
        # head's encodings the moment the head flips, so a reorg (weight
        # flip, proposer-boost expiry, checkpoint move) never leaves a
        # dead branch's answers pinned in the serving plane
        if self.api is not None and prev is not None:
            self.api.on_head_transition(prev, head)
        if first:
            # adopting the anchor at boot is not a head UPDATE: the
            # anchor's age (minutes on a devnet, hours after checkpoint
            # sync) would land one giant sample in
            # head_update_delay_seconds and leave the round-12
            # head_update_delay_p95 SLO violated until real transitions
            # dilute it.  Real catch-up transitions still observe —
            # their huge delays are the point (see PR-4 note above).
            return
        delay = observe_head_update(self.slot_clock, int(head_block.slot))
        get_recorder().record(
            "inst", 0, "head_update",
            {"slot": int(head_block.slot),
             "root": head.hex()[:16],
             "delay_s": round(delay, 4)},
        )
        # forensics post-mortem: EVERY transition mints a
        # ReorgRecord — depth 0 for plain chain extension, and the
        # depth/ancestor/attribution story for actual weight reorgs
        self.forensics.observe_transition(self.store, prev, head)

    # ---------------------------------------------------------------- loops

    def _fail(self, loop: str, exc: BaseException) -> None:
        """Record the device fault that ends one of the node's loops: counted
        once, put on the flight recorder's timeline, raised by the next
        :meth:`stop` (the first fault wins)."""
        if self._fault is None:
            self._fault = exc
        get_metrics().inc("node_loop_fault_total", loop=loop)
        get_recorder().record(
            "inst", 0, "node_fault",
            {"loop": loop, "error": type(exc).__name__, "message": str(exc)},
        )
        log.error("%s ended by a device fault: %r", loop, exc)

    async def _tick_loop(self) -> None:
        """1 s wall-clock ticks, aligned to the second boundary
        (ref: fork_choice/store.ex:178-182).  A device fault ends it."""
        while True:
            now = time.time()
            await asyncio.sleep(1.0 - (now % 1.0))
            try:
                on_tick(self.store, int(time.time()), self.spec)
                # durability barrier: one batched fsync when the
                # finalized checkpoint advanced this tick (never per-put)
                self._persist_finality()
                self._sample_device_telemetry()
                self._maybe_poll_gossip_stats()
                # finality-lag decomposition: observes on the FIRST tick
                # and then once per epoch change (internal dedup) — the
                # first-tick sample guarantees every soak scenario emits
                # at least one finality_lag_epochs observation
                self.forensics.observe_epoch(self.store, self.spec)
                # one SLO evaluation per tick: publishes the slo_* gauges
                # and appends the burn-rate snapshot the multi-window
                # evaluation (and /debug/slo) reads — at 1 Hz the engine's
                # bounded history covers well past the slow window
                get_engine().evaluate()
                if self.store.head_cache is not None:
                    # O(1) cached head for the per-tick gauge — the full
                    # LMD-GHOST get_head stays on the consensus-critical
                    # paths (chain view, API, production)
                    head = self.store.head_cache.head()
                    head_block = self.store.blocks.get(head)
                    if head_block is not None:
                        # own gauge: sync_store_slot belongs to _on_applied
                        # (per-applied-block); mixing writers would make
                        # the sync panel flap between fork heads
                        self.metrics.set_gauge(
                            "fork_choice_head_slot", int(head_block.slot)
                        )
                    # proposer-boost expiry / checkpoint moves on the
                    # tick can also flip the head with no apply or
                    # attestation batch in sight
                    self._observe_head_transition()
                # duty phases fire off the tick but run on an executor
                # thread (batched signing is CPU-heavy by design); one
                # in-flight firing at a time — a slow phase must not
                # pile a new firing onto every tick behind it
                if self.duties is not None and self._fault is None and (
                    self._duty_task is None or self._duty_task.done()
                ):
                    self._duty_task = asyncio.ensure_future(
                        self._fire_duties()
                    )
            except Exception as exc:
                if is_device_fault(exc):
                    self._fail("tick", exc)
                    return
                log.exception("tick failed")

    async def _fire_duties(self) -> None:
        """One duty-scheduler pass: phase production on an executor
        thread (the batched signing and block assembly are CPU-bound),
        then publication on the loop — own blocks also enter the local
        import path so the node's head advances without a gossip echo."""
        loop = asyncio.get_running_loop()
        try:
            produced = await loop.run_in_executor(
                None, self.duties.on_tick, self.store
            )
        except Exception as exc:
            if is_device_fault(exc):
                self._fail("duties", exc)
                return
            log.exception("duty firing failed")
            return
        if not produced or self.port is None:
            return
        from ..network.gossip import publish_ssz
        from ..state_transition.misc import compute_subnet_for_attestation

        digest = self.chain.fork_digest()
        try:
            block = produced.get("block")
            if block is not None:
                signed, _post = block
                if self.pending is not None:
                    self.pending.add_block(signed)  # self-import, no echo wait
                await publish_ssz(
                    self.port, topic_name(digest, "beacon_block"),
                    signed, self.spec, node=self.config.node_label,
                )
            subscribed = set(self.config.attnet_subnets)
            cps = int(produced.get("committees_per_slot") or 1)
            for att in produced.get("attestations", ()):
                # votes for unsubscribed subnets stay pooled (the
                # aggregation duty still covers them); publishing to a
                # mesh we are not part of would just be dropped
                subnet = compute_subnet_for_attestation(
                    cps, int(att.data.slot), int(att.data.index), self.spec
                )
                if subnet in subscribed:
                    await publish_ssz(
                        self.port,
                        topic_name(digest, f"beacon_attestation_{subnet}"),
                        att, self.spec, node=self.config.node_label,
                    )
            agg_topic = topic_name(digest, "beacon_aggregate_and_proof")
            for agg in produced.get("aggregates", ()):
                await publish_ssz(
                    self.port, agg_topic, agg, self.spec,
                    node=self.config.node_label,
                )
        except Exception as exc:
            if is_device_fault(exc):
                self._fail("duties", exc)
                return
            # a wedged sidecar must not kill duty production; the next
            # slot's firing retries against whatever port is live then
            log.exception("duty publication failed")

    # how often the sidecar's gossip-health snapshot is pulled (a full
    # command round-trip — NOT every tick)
    GOSSIP_STATS_POLL_S = 5.0

    def _maybe_poll_gossip_stats(self) -> None:
        """Kick one bounded gossip-stats poll per interval.
        Off the tick's critical path: the round-trip runs as its own
        task, and at most one is ever in flight."""
        if self.port is None:
            return
        if self._gossip_poll_task is not None and not self._gossip_poll_task.done():
            return
        now = time.monotonic()
        if now - self._gossip_poll_mono < self.GOSSIP_STATS_POLL_S:
            return
        self._gossip_poll_mono = now
        self._gossip_poll_task = asyncio.ensure_future(self._poll_gossip_stats())

    async def _poll_gossip_stats(self) -> None:
        """One sidecar stats round-trip -> per-peer health metrics +
        the cached snapshot ``/debug/peers`` serves.  Every failure mode
        (dead port, old sidecar returning ``{}``, command timeout) is
        absorbed — peer health degrades to staleness, never to a tick
        error; a device fault ends the poll and is recorded (:meth:`_fail`)."""
        port = self.port
        get_stats = getattr(port, "get_gossip_stats", None)
        if port is None or get_stats is None or not getattr(port, "alive", False):
            return
        try:
            stats = await get_stats()
        except Exception as exc:
            if is_device_fault(exc):
                self._fail("gossip_stats", exc)
            return
        if not stats:
            return
        self._gossip_stats = stats
        self._gossip_stats_ts = time.time()
        self._emit_gossip_health(stats)

    def _emit_gossip_health(self, stats: dict) -> None:
        """Sidecar totals -> metric families, by delta against the last
        snapshot (a restarted sidecar resets to zero: the cursor then
        re-baselines and counts the fresh totals).  Peer labels are
        8-hex-char node-id prefixes — bounded cardinality, and the same
        prefix ``/debug/fleet``'s propagation matrix keys on."""
        m = self.metrics
        if not m.enabled:
            return
        for peer, topics in (stats.get("delivery") or {}).items():
            label = peer[:8]
            for topic, cell in (topics or {}).items():
                short = _topic_short(topic)
                key = (peer, topic)
                prev_first, prev_dup = self._peer_stat_cursor.get(key, (0, 0))
                first = int(cell.get("first", 0))
                dup = int(cell.get("duplicate", 0))
                d_first, d_dup = first - prev_first, dup - prev_dup
                if d_first < 0 or d_dup < 0:  # sidecar restart reset
                    d_first, d_dup = first, dup
                self._peer_stat_cursor[key] = (first, dup)
                if d_first:
                    m.inc("peer_gossip_first_total",
                          value=d_first, peer=label, topic=short)
                if d_dup:
                    m.inc("peer_gossip_duplicate_total",
                          value=d_dup, peer=label, topic=short)
        for kind, count in (stats.get("control") or {}).items():
            prev = self._control_cursor.get(kind, 0)
            delta = int(count) - prev
            if delta < 0:
                delta = int(count)
            self._control_cursor[kind] = int(count)
            if delta:
                m.inc("peer_gossip_control_total", value=delta, kind=kind)
        for peer, info in (stats.get("peers") or {}).items():
            m.set_gauge(
                "peer_score", float((info or {}).get("score", 0.0)),
                peer=peer[:8],
            )

    def _sample_device_telemetry(self) -> None:
        """Per-tick device/cache gauges: the allocator's live blocks and
        the device-memory planes, the kernels' cost metrics, shared
        registry-plane residency, attestation-context cache sizes,
        flight-recorder vitals and the forensics ring drops.

        PROCESS-wide facts (device memory, plane stores, the cost table,
        the process-global state-context cache, the recorder) go to the
        default registry — writes from co-resident nodes are then
        idempotent and never double-count in cross-target sums; only the
        store-scoped context gauge is truly per node and lands on
        ``self.metrics``."""
        from ..fork_choice import attestation

        node_m = self.metrics
        proc_m = get_metrics()
        if not (node_m.enabled or proc_m.enabled):
            return
        blocks = ops_profile.live_device_blocks()
        if blocks is not None:
            proc_m.set_gauge("device_live_arrays", float(blocks))
        # one series per accounted plane, plus the unattributed remainder
        # of the allocator's total where this process has one
        for plane, nbytes in ops_profile.plane_bytes(ops_profile.live_device_bytes()).items():
            proc_m.set_gauge("device_plane_bytes", float(nbytes), plane=plane, sharded="0")
        proc_m.set_gauge("device_plane_bytes_watermark", float(ops_profile.plane_watermark()))
        ops_profile.emit_entry_metrics(proc_m)
        planes = bls_batch.plane_store_stats()
        proc_m.set_gauge("registry_plane_stores", float(planes["stores"]))
        proc_m.set_gauge("registry_plane_resident_bytes", float(planes["resident_bytes"]))
        proc_m.set_gauge("registry_plane_uploaded_cols", float(planes["uploaded_cols"]))
        # this store's contexts: genuinely per node
        node_m.set_gauge(
            "attestation_context_count",
            float(len(getattr(self.store, "attestation_contexts", ()))),
            cache="store",
        )
        # the state-keyed cache is a process global — its own family
        # (not a label on the per-node one) so each family lives in
        # exactly one registry and the /metrics merge stays disjoint
        proc_m.set_gauge(
            "state_attestation_context_count",
            float(attestation.state_context_count()),
        )
        # flight-recorder vitals: occupancy + overwrite pressure per tick
        # (a dropped_total climbing faster than the scrape interval means
        # the ring window is shorter than the debugging horizon)
        rec = get_recorder().stats()
        proc_m.set_gauge("trace_recorder_events", float(rec["events"]))
        proc_m.set_gauge("trace_recorder_capacity", float(rec["capacity"]))
        # _total names must expose as counters (rate() on a gauge copy
        # both under-reports bursts and fails strict counter typing);
        # the cursor is module-global so co-resident nodes ticking the
        # same process-wide recorder never double-count the delta
        global _trace_dropped_exported
        delta = rec["dropped_total"] - _trace_dropped_exported
        if delta > 0 and proc_m.enabled:
            # advance the cursor only when the inc actually records —
            # otherwise a disabled process registry (node gauges still
            # on) would silently consume the delta and lose the drops
            _trace_dropped_exported = rec["dropped_total"]
            proc_m.inc("trace_recorder_dropped_total", value=delta)
        # forensic ring-drop deltas: the cursor lives ON the per-node
        # forensics instance (unlike the process-wide recorder above),
        # so co-resident fleet members each export their own drops
        self.forensics.export_ring_drops(self.metrics)

    async def _range_sync(self) -> None:
        sync = SyncBlocks(self.store, self.pending, self.downloader, self.spec)
        # wait for at least one peer before syncing
        for _ in range(100):
            if len(self.peerbook):
                break
            await asyncio.sleep(0.1)
        if not len(self.peerbook):
            return
        try:
            fetched = await sync.run()
            self.metrics.inc("network_request_count", value=fetched, result="ok", type="range_sync")
            log.info("range sync fetched %d blocks", fetched)
        except Exception as exc:
            if is_device_fault(exc):
                self._fail("range_sync", exc)
                return
            log.exception("range sync failed")

    # ------------------------------------------------------------- shutdown

    async def stop(self) -> None:
        """Tear everything down, then raise the device fault that ended one
        of the node's loops, the ingest drain or a pending-blocks loop, if
        one did (the node's own first)."""
        self._stopping = True
        faults: list[BaseException] = []
        if self._warmer is not None:
            # the warmer is daemonized and bounded, but a stop() that
            # returns while it still launches races the hash-backend
            # restore below: bound the wait off the loop
            await asyncio.get_running_loop().run_in_executor(None, self._warmer.join, 10.0)
            self._warmer = None
        if self.device_backend is not None:
            # restore the process-global SSZ hash backend start() swapped
            # in (multi-node-lifecycle processes, tests)
            from ..ssz.hash import set_hash_backend

            set_hash_backend(self._prev_hash_backend)
            self.device_backend = None
        if self._subs:
            # concurrent: the per-topic 2 s unsubscribe bound must not
            # multiply by topic count (66 topics of a wedged sidecar
            # would stall shutdown ~2 minutes if awaited serially)
            results = await asyncio.gather(
                *(sub.stop() for sub in self._subs), return_exceptions=True
            )
            faults += [
                r for r in results
                if isinstance(r, BaseException) and is_device_fault(r)
            ]
        if self.ingest is not None:
            try:
                await self.ingest.stop()
            except Exception as exc:
                faults.append(exc)
        if self.pending is not None:
            try:
                self.pending.stop()
            except Exception as exc:
                faults.append(exc)
        if self._duty_task is not None:
            self._duty_task.cancel()
        if self._gossip_poll_task is not None:
            self._gossip_poll_task.cancel()
        for t in self._tasks:
            t.cancel()
        if self.api is not None:
            await self.api.stop()
        if self.port is not None:
            await self.port.close()
        if self.kv is not None:
            # a clean stop is itself a durability barrier: everything
            # applied this run survives the next power cut, not just the
            # finalized prefix
            try:
                self.kv.barrier(reason="close")
                self.kv.close()
            except Exception as exc:
                faults.append(exc)
        fault = self._fault or (faults[0] if faults else None)
        if fault is not None:
            raise fault
