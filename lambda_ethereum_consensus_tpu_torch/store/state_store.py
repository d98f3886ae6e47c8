"""Typed state persistence (ref: lib/.../store/state_store.ex).

Key scheme: ``beacon_state|block_root -> SSZ(BeaconState)`` plus
``stateslot|<slot be64> -> block_root``; ``get_latest_state`` seeks the
highest slot key to resume after restart (ref: state_store.ex:36-49,
fork_choice/supervisor.ex:16-28).

Round 20 adds the crash-safe resume surface: ``finalized|anchor`` holds
the last finality-barriered block root (written by the node's
finalization hook right before its fsync barrier), and
``get_latest_verified_state`` walks the slot index highest-first
accepting only candidates whose decoded state Merkle-roots to the
``state_root`` their stored block committed to — a WAL that survived a
crash with a silently stale or damaged record can therefore never become
the boot anchor; the node falls back to checkpoint sync instead.

The port's copy of the JAX package's ``store/state_store.py``.  The
candidate's state root runs on the installed hash backend (the SHA-256
kernel once ``ops.sha256.install_device_backend()`` has run); a fault there
raises, since only the decode is treated as a rejected candidate.  The
scan's bound is the module constant :data:`RESUME_MAX_SCAN`, not a
``max_scan=`` argument.
"""

from __future__ import annotations

import logging

from ..config import ChainSpec, get_chain_spec
from ..telemetry import get_metrics
from ..types.beacon import BeaconState
from .kv import KvStore

log = logging.getLogger("state_store")

_STATE = b"beacon_state|"
_SLOT = b"stateslot|"

#: candidates the verified resume walks before it gives up on the store
RESUME_MAX_SCAN = 8

#: The finality snapshot pointer: the block root whose state the node
#: fsync-barriered last.  Resume scans the slot index newest-first so
#: the node comes back at its head; this pointer is the durable FLOOR,
#: adopted when none of the recent candidates verifies.
FINALIZED_ANCHOR_KEY = b"finalized|anchor"


def set_finalized_anchor(kv: KvStore, root: bytes) -> None:
    kv.put(FINALIZED_ANCHOR_KEY, root)


def get_finalized_anchor(kv: KvStore) -> bytes | None:
    root = kv.get(FINALIZED_ANCHOR_KEY)
    return root if root and len(root) == 32 else None


def _slot_key(slot: int) -> bytes:
    return _SLOT + int(slot).to_bytes(8, "big")


class StateStore:
    def __init__(self, kv: KvStore):
        self._kv = kv

    def store_state(
        self,
        block_root: bytes,
        state: BeaconState,
        spec: ChainSpec | None = None,
    ) -> None:
        spec = spec or get_chain_spec()
        self._kv.put(_STATE + block_root, state.encode(spec))
        self._kv.put(_slot_key(state.slot), block_root)

    def has_state(self, block_root: bytes) -> bool:
        return self._kv.get(_STATE + block_root) is not None

    def get_state(
        self, block_root: bytes, spec: ChainSpec | None = None
    ) -> BeaconState | None:
        raw = self._kv.get(_STATE + block_root)
        if raw is None:
            return None
        return BeaconState.decode(raw, spec or get_chain_spec())

    def get_state_by_slot(
        self, slot: int, spec: ChainSpec | None = None
    ) -> BeaconState | None:
        root = self._kv.get(_slot_key(slot))
        return None if root is None else self.get_state(root, spec)

    def get_latest_state(
        self, spec: ChainSpec | None = None
    ) -> tuple[bytes, BeaconState] | None:
        """Highest-slot stored state, for restart resume (UNVERIFIED —
        the node's anchor selection uses the verified variant below)."""
        kv = self._kv.last_under_prefix(_SLOT)
        if kv is None:
            return None
        root = kv[1]
        state = self.get_state(root, spec)
        return None if state is None else (root, state)

    # ------------------------------------------------------ verified resume

    def verified_state(
        self, root: bytes, blocks, spec: ChainSpec | None = None
    ) -> BeaconState | None:
        """The state stored under ``root`` IF it decodes and its
        hash-tree-root matches the ``state_root`` committed by the block
        stored under the same root; ``None`` (never an exception) for a
        missing, undecodable, or mismatching candidate — a corrupt record
        is a rejected resume candidate, not a crashed boot."""
        spec = spec or get_chain_spec()
        try:
            state = self.get_state(root, spec)
            block = blocks.get_block(root, spec)
        except Exception as e:  # undecodable SSZ payload
            log.warning("resume candidate %s undecodable: %s", root.hex()[:16], e)
            get_metrics().inc("storage_resume_rejected_total", reason="decode")
            return None
        if state is None or block is None:
            get_metrics().inc("storage_resume_rejected_total", reason="missing")
            return None
        if state.hash_tree_root(spec) != bytes(block.message.state_root):
            log.error(
                "resume candidate %s FAILED state-root verification; "
                "refusing to boot on it", root.hex()[:16],
            )
            get_metrics().inc("storage_resume_rejected_total", reason="root")
            return None
        return state

    def get_latest_verified_state(
        self,
        blocks,
        spec: ChainSpec | None = None,
    ) -> tuple[bytes, BeaconState] | None:
        """Highest-slot candidate that PASSES state-root verification,
        walking the slot index newest-first past damaged entries.  The
        scan is bounded: a store where the newest
        :data:`RESUME_MAX_SCAN` candidates all fail verification is
        systemically damaged, and checkpoint sync beats archaeology on a
        liveness deadline."""
        spec = spec or get_chain_spec()
        scanned = 0
        for _key, root in self._kv.iterate_prefix(_SLOT, descending=True):
            if scanned >= RESUME_MAX_SCAN:
                break
            scanned += 1
            state = self.verified_state(root, blocks, spec)
            if state is not None:
                return root, state
        return None
