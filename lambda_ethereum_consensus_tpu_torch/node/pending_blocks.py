"""Pending-block tracking: hold, order, apply or mark invalid, fetch parents.

Port of the reference's PendingBlocks GenServer (ref: lib/.../beacon/
pending_blocks.ex): every PROCESS_INTERVAL the pending set is scanned in slot
order — blocks whose parent is in the fork-choice store are applied, blocks
with invalid parents become (transitively) invalid, unknown parents are
queued for download; every DOWNLOAD_INTERVAL up to MAX_DOWNLOAD queued roots
are fetched from peers.

The port's copy of the JAX package's ``node/pending_blocks.py``.  Blocks
apply through the port's ``fork_choice.on_block`` on ``device`` (default:
the card).  One deliberate divergence: a ``RuntimeError`` (a kernel, native
or CUDA fault, ``torch.OutOfMemoryError``, or the store's ``KvError``) is
never logged away by the loop: it ends that loop and cancels its sibling at
once, counts once in ``pending_blocks_loop_fault_total``, puts a
``pending_loop_fault`` event on the flight recorder's timeline, and is raised
by the next :meth:`PendingBlocks.add_block` and by :meth:`PendingBlocks.stop`.
Any other exception, a wire error from the downloader (``ReqRespError``,
``PortError``; ``faults.is_device_fault``) included, is logged and the loop
goes on, as in the JAX package.
"""

from __future__ import annotations

import asyncio
import logging

from ..config import ChainSpec
from ..faults import is_device_fault
from ..fork_choice import Store, on_block
from ..state_transition.errors import SpecError
from ..telemetry import get_metrics
from ..tracing import get_recorder
from ..types.beacon import SignedBeaconBlock

log = logging.getLogger("pending_blocks")

PROCESS_INTERVAL = 3.0  # ref: pending_blocks.ex:158-164
DOWNLOAD_INTERVAL = 1.0
MAX_DOWNLOAD = 20


class PendingBlocks:
    def __init__(
        self,
        store: Store,
        spec: ChainSpec,
        downloader=None,
        on_applied=None,
        da_gate=None,
        device=None,
    ):
        self.store = store
        self.spec = spec
        self.downloader = downloader
        self.on_applied = on_applied  # callback(root, signed_block)
        # da.availability.DataAvailability (deneb): blocks whose sampled
        # blob columns are still outstanding stay parked in the pending
        # set — applied on a later scan once the gate opens
        self.da_gate = da_gate
        self.device = device
        self.pending: dict[bytes, SignedBeaconBlock] = {}
        self.invalid: set[bytes] = set()
        self.to_download: set[bytes] = set()
        self._tasks: list[asyncio.Task] = []
        # the RuntimeError that ended a loop: add_block() and stop() raise it
        self._fault: BaseException | None = None

    def add_block(self, signed_block: SignedBeaconBlock) -> None:
        """Queue a block for the scan; raises the ``RuntimeError`` that
        ended a loop, if one did."""
        if self._fault is not None:
            raise self._fault
        root = signed_block.message.hash_tree_root(self.spec)
        if root in self.invalid or root in self.store.blocks:
            return
        self.pending[root] = signed_block

    def is_pending(self, root: bytes) -> bool:
        return root in self.pending

    # ------------------------------------------------------------ processing

    async def process_once(self) -> int:
        """One scan over the pending set; returns number applied."""
        applied = 0
        for root, signed in sorted(
            list(self.pending.items()), key=lambda kv: kv[1].message.slot
        ):
            if root not in self.pending:
                continue
            parent = bytes(signed.message.parent_root)
            if parent in self.invalid:
                self._mark_invalid(root)
            elif parent in self.store.blocks:
                if self.da_gate is not None and not self.da_gate.is_available(
                    root
                ):
                    continue  # parked: data availability incomplete
                try:
                    on_block(self.store, signed, spec=self.spec, device=self.device)
                except (SpecError, ValueError, TypeError) as e:
                    # adversarial payloads can trip a Python-level error
                    # (bad lengths, out-of-range indices) before the
                    # transition names it a SpecError — either way the
                    # block is invalid; only the scan must survive
                    log.warning("invalid block %s: %s", root.hex()[:16], e)
                    self._mark_invalid(root)
                    continue
                del self.pending[root]
                applied += 1
                if self.on_applied is not None:
                    self.on_applied(root, signed)
            elif parent in self.pending:
                continue  # parent queued; it will be applied first next scan
            else:
                self.to_download.add(parent)
        return applied

    def _mark_invalid(self, root: bytes) -> None:
        self.invalid.add(root)
        self.pending.pop(root, None)
        # transitively invalidate queued descendants
        for r, b in list(self.pending.items()):
            if bytes(b.message.parent_root) in self.invalid:
                self._mark_invalid(r)

    async def download_once(self) -> None:
        if not self.to_download or self.downloader is None:
            return
        roots = [
            r
            for r in list(self.to_download)[:MAX_DOWNLOAD]
            if r not in self.store.blocks and r not in self.pending
        ]
        self.to_download.difference_update(roots)
        if not roots:
            return
        try:
            blocks = await self.downloader.request_blocks_by_root(roots)
        except Exception as e:
            log.debug("parent download failed: %s", e)
            self.to_download.update(roots)  # retry next tick
            return
        for block in blocks:
            self.add_block(block)

    # ---------------------------------------------------------------- loops

    def start(self) -> None:
        self._fault = None
        self._tasks = [
            asyncio.ensure_future(self._loop(self.process_once, PROCESS_INTERVAL)),
            asyncio.ensure_future(self._loop(self.download_once, DOWNLOAD_INTERVAL)),
        ]

    def stop(self) -> None:
        """Cancel both loops; raise the ``RuntimeError`` that ended one."""
        for t in self._tasks:
            if t.done() and not t.cancelled():
                t.exception()  # retrieved: the fault is raised below
            t.cancel()
        self._tasks = []
        if self._fault is not None:
            raise self._fault

    def _fail(self, exc: RuntimeError) -> None:
        """Record the fault that ends a loop and cancel the other loop, so
        no half of the pending set runs on after the card has failed."""
        self._fault = exc
        get_metrics().inc("pending_blocks_loop_fault_total")
        get_recorder().record(
            "inst", 0, "pending_loop_fault",
            {"error": type(exc).__name__, "message": str(exc)},
        )
        me = asyncio.current_task()
        for t in self._tasks:
            if t is not me:
                t.cancel()

    async def _loop(self, fn, interval: float) -> None:
        while True:
            try:
                await fn()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if is_device_fault(exc):
                    # a device, native or store fault is never logged away
                    self._fail(exc)
                    raise
                log.exception("pending-blocks loop error")
            await asyncio.sleep(interval)
