"""Optimistic range sync (ref: lib/.../beacon/sync_blocks.ex).

Chunks the span [finalized_slot, current_slot] into CHUNK_SIZE ranges and
downloads up to MAX_CONCURRENT chunks at a time; failed chunks are retried
until the span is exhausted.  Downloaded blocks feed PendingBlocks, which
orders and applies them.

The port's copy of the JAX package's ``node/sync.py``.  A failed chunk
download is retried as there; a device fault out of the pending set's scan
(``PendingBlocks.process_once``, which applies blocks on the card) is not
caught here and ends the run.
"""

from __future__ import annotations

import asyncio
import logging

from ..config import ChainSpec
from ..state_transition import misc

log = logging.getLogger("sync")

CHUNK_SIZE = 20       # ref: sync_blocks.ex:15
MAX_CONCURRENT = 4    # ref: sync_blocks.ex:48-52
CHUNK_TIMEOUT = 20.0
MAX_ROUNDS = 10


class SyncBlocks:
    def __init__(self, store, pending_blocks, downloader, spec: ChainSpec):
        self.store = store
        self.pending = pending_blocks
        self.downloader = downloader
        self.spec = spec

    async def run(self) -> int:
        """Sync from the finalized checkpoint to the wall-clock head.

        Returns the number of blocks fetched.  Mirrors SyncBlocks.run/1 +
        perform_sync/1: failed chunks are retried; a chunk is *done* once a
        download for it succeeds (slot-presence can't signal completion —
        skipped slots are routine and would re-download forever).
        """
        start = misc.compute_start_slot_at_epoch(
            self.store.finalized_checkpoint.epoch, self.spec
        )
        fetched = 0
        done: set[int] = set()
        for _ in range(MAX_ROUNDS):
            head = self.store.current_slot(self.spec)
            known_slots = {b.slot for b in self.store.blocks.values()}
            todo = []
            for s in range(start, head + 1, CHUNK_SIZE):
                count = min(CHUNK_SIZE, head + 1 - s)
                if s in done:
                    continue
                if all(slot in known_slots for slot in range(s, s + count)):
                    done.add(s)  # everything already present locally
                    continue
                todo.append((s, count))
            if not todo:
                return fetched
            sem = asyncio.Semaphore(MAX_CONCURRENT)

            async def fetch(chunk):
                async with sem:
                    try:
                        return chunk, await asyncio.wait_for(
                            self.downloader.request_blocks_by_range(*chunk),
                            CHUNK_TIMEOUT,
                        )
                    except Exception as e:
                        log.debug("chunk %s failed: %s", chunk, e)
                        return chunk, None

            results = await asyncio.gather(*(fetch(c) for c in todo))
            progress = False
            for chunk, blocks in results:
                if blocks is None:
                    continue
                progress = True
                done.add(chunk[0])
                for block in blocks:
                    self.pending.add_block(block)
                    fetched += 1
            await self.pending.process_once()
            if not progress:
                await asyncio.sleep(1.0)  # ref: 1s sleep before chunk retry
        return fetched
