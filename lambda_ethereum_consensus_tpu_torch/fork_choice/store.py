"""The fork-choice Store (ref: lib/ssz_types/store.ex:1-61).

The port's copy of the JAX package's ``fork_choice/store.py``.

A host-side mutable object — fork choice is branchy, latency-sensitive
control flow that stays on CPU (SURVEY.md §2.3); only the vote-weight
reductions in :mod:`.head` are batched array math.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..config import ChainSpec, constants, get_chain_spec
from ..state_transition import accessors, misc
from ..state_transition.errors import SpecError
from ..telemetry import get_metrics
from ..types.beacon import BeaconBlock, BeaconState, Checkpoint
from .tree import HeadCache


class ForkChoiceError(SpecError):
    """Message rejected by fork-choice validation.

    ``reject`` distinguishes protocol violations (bad signature,
    undecodable point — gossip verdict REJECT, peer penalized) from
    conditions that may be timing or missing context (unknown block,
    wrong epoch — verdict IGNORE), mirroring the reference's three-way
    accept/reject/ignore (subscriptions.go:95-135).
    """

    def __init__(self, msg: str, reject: bool = False):
        super().__init__(msg)
        self.reject = reject


@dataclass(frozen=True)
class LatestMessage:
    epoch: int
    root: bytes


@dataclass
class Store:
    time: int
    genesis_time: int
    justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint
    unrealized_justified_checkpoint: Checkpoint
    unrealized_finalized_checkpoint: Checkpoint
    proposer_boost_root: bytes = b"\x00" * 32
    equivocating_indices: set[int] = field(default_factory=set)
    blocks: dict[bytes, BeaconBlock] = field(default_factory=dict)
    block_states: dict[bytes, BeaconState] = field(default_factory=dict)
    checkpoint_states: dict[tuple[int, bytes], BeaconState] = field(default_factory=dict)
    latest_messages: dict[int, LatestMessage] = field(default_factory=dict)
    unrealized_justifications: dict[bytes, Checkpoint] = field(default_factory=dict)
    # children index maintained on insert so head walks are O(tree) not O(blocks^2)
    children: dict[bytes, list[bytes]] = field(default_factory=dict)
    # O(1) cached-head tree, streamed by the handlers (see tree.HeadCache);
    # None only for hand-built test stores
    head_cache: HeadCache | None = None
    # head memo (VERDICT r2 #9): ``mutations`` is bumped by every
    # head-relevant store change (blocks, votes, checkpoints, boost,
    # equivocations) so API reads between mutations are O(1) instead of a
    # full LMD-GHOST recomputation; the memo key also carries the current
    # slot because viability filtering depends on the clock.
    mutations: int = 0
    head_memo: tuple | None = None
    # epoch-scoped attestation-verification contexts (committee tables +
    # device committee caches), keyed like checkpoint_states plus the
    # context's device, pruned with it on finalization (prune_checkpoint_caches) and LRU-evicted by
    # oldest epoch on cap overflow — see fork_choice/attestation.py
    attestation_contexts: dict = field(default_factory=dict)
    # columnar mirror of latest_messages' epochs (int64, -1 = no vote):
    # the batched drain filters "who actually moves" with one array
    # compare instead of per-validator dict lookups
    _vote_epochs = None

    def bump(self) -> None:
        self.mutations += 1

    def vote_epoch_array(self, n: int):
        """Grown-to-``n`` per-validator latest-vote-epoch array, built
        from ``latest_messages`` on first use and kept in sync by both
        vote-update paths (:func:`.handlers.update_latest_messages` /
        the batched drain)."""
        import numpy as np

        if self._vote_epochs is None or len(self._vote_epochs) < n:
            # (re)build from the authoritative dict: growing without a
            # backfill would resurrect -1 for validators whose votes were
            # recorded while their index was beyond the array
            arr = np.full(n, -1, np.int64)
            for i, lm in self.latest_messages.items():
                if i < n:
                    arr[i] = lm.epoch
            self._vote_epochs = arr
        return self._vote_epochs

    def prune_checkpoint_caches(self, finalized_epoch: int) -> None:
        """Drop checkpoint states and attestation contexts whose target
        epoch precedes finalization.

        Gossip attestations only carry current/previous-epoch targets and
        both are >= the finalized epoch, so these keys can never be read
        again — but each held a full BeaconState plus (for contexts) an
        epoch committee table and a device committee cache, which is what
        made the maps the store's largest steady-state growth.  Called on
        every finalized-checkpoint advance (handlers.update_checkpoints).
        Attestation contexts are keyed ``(epoch, root, device)``.
        """
        pruned = 0
        for cache in (self.checkpoint_states, self.attestation_contexts):
            for key in [k for k in cache if k[0] < finalized_epoch]:
                del cache[key]
                pruned += 1
        if pruned:
            get_metrics().inc("checkpoint_cache_pruned_count", value=pruned)

    def note_vote(self, index: int, epoch: int) -> None:
        """Keep the columnar epoch mirror in sync on per-item updates."""
        if self._vote_epochs is not None:
            if index >= len(self._vote_epochs):
                self.vote_epoch_array(index + 1)
            self._vote_epochs[index] = epoch

    # ---------------------------------------------------------- time helpers
    def current_slot(self, spec: ChainSpec | None = None) -> int:
        spec = spec or get_chain_spec()
        return constants.GENESIS_SLOT + (self.time - self.genesis_time) // spec.SECONDS_PER_SLOT

    def slots_since_epoch_start(self, spec: ChainSpec | None = None) -> int:
        spec = spec or get_chain_spec()
        return self.current_slot(spec) - misc.compute_start_slot_at_epoch(
            misc.compute_epoch_at_slot(self.current_slot(spec), spec), spec
        )

    # ---------------------------------------------------------- tree helpers
    def get_ancestor(self, root: bytes, slot: int) -> bytes:
        """Ancestor of ``root`` at or before ``slot``
        (ref: lib/ssz_types/store.ex:44-55).

        The walk clamps at the anchor: when a parent is not in the store
        (pruned history below the weak-subjectivity anchor), the oldest known
        ancestor is returned — which is how a mid-epoch anchor still answers
        checkpoint-block queries for its own epoch.
        """
        block = self.blocks[root]
        while block.slot > slot:
            parent = bytes(block.parent_root)
            if parent not in self.blocks:
                return root
            root = parent
            block = self.blocks[root]
        return root

    def get_checkpoint_block(self, root: bytes, epoch: int, spec: ChainSpec | None = None) -> bytes:
        """Checkpoint block of ``root`` for ``epoch``
        (ref: lib/ssz_types/store.ex:57-61)."""
        return self.get_ancestor(root, misc.compute_start_slot_at_epoch(epoch, spec))

    def add_block(self, root: bytes, block: BeaconBlock, state: BeaconState) -> None:
        self.blocks[root] = block
        self.block_states[root] = state
        self.children.setdefault(bytes(block.parent_root), []).append(root)
        if self.head_cache is not None:
            self.head_cache.on_block(root, bytes(block.parent_root))
        self.bump()


def checkpoint_key(checkpoint: Checkpoint) -> tuple[int, bytes]:
    return (int(checkpoint.epoch), bytes(checkpoint.root))


def get_forkchoice_store(
    anchor_state: BeaconState,
    anchor_block: BeaconBlock,
    spec: ChainSpec | None = None,
    anchor_root: bytes | None = None,
) -> Store:
    """Fresh store from an anchor (ref: fork_choice/helpers.ex:12-50).

    ``anchor_root`` overrides the anchor's identity for checkpoint-sync
    anchors where only the block *header* is known: the header root equals
    the real block root, while a reconstructed block with an empty body
    would hash differently and orphan every descendant.
    """
    spec = spec or get_chain_spec()
    if bytes(anchor_block.state_root) != anchor_state.hash_tree_root(spec):
        raise ForkChoiceError("anchor block state root does not match anchor state")
    if anchor_root is None:
        anchor_root = anchor_block.hash_tree_root(spec)
    anchor_epoch = accessors.get_current_epoch(anchor_state, spec)
    justified = Checkpoint(epoch=anchor_epoch, root=anchor_root)
    finalized = Checkpoint(epoch=anchor_epoch, root=anchor_root)
    store = Store(
        time=anchor_state.genesis_time + spec.SECONDS_PER_SLOT * anchor_state.slot,
        genesis_time=anchor_state.genesis_time,
        justified_checkpoint=justified,
        finalized_checkpoint=finalized,
        unrealized_justified_checkpoint=justified,
        unrealized_finalized_checkpoint=finalized,
    )
    store.blocks[anchor_root] = anchor_block
    store.block_states[anchor_root] = anchor_state
    store.checkpoint_states[checkpoint_key(justified)] = anchor_state
    store.unrealized_justifications[anchor_root] = justified
    store.head_cache = HeadCache(anchor_root)
    return store
