"""Live chain view over the fork-choice store + persistence.

Feeds the req/resp server real status/metadata/blocks (the reference
hardcodes these — ref: p2p/incoming_requests/handler.ex:18-41).

The port's copy of the JAX package's ``node/chain.py``.
"""

from __future__ import annotations

from ..config import ChainSpec
from ..fork_choice import Store, get_head
from ..state_transition import misc
from ..store import BlockStore
from ..types.p2p import Metadata, StatusMessage


class LiveChainView:
    def __init__(self, store: Store, blocks: BlockStore, spec: ChainSpec):
        self.store = store
        self.blocks = blocks
        self.spec = spec
        self.metadata_seq = 0

    def fork_digest(self) -> bytes:
        state = next(iter(self.store.block_states.values()))
        return misc.compute_fork_digest(
            bytes(state.fork.current_version), bytes(state.genesis_validators_root)
        )

    def status(self) -> StatusMessage:
        head_root = get_head(self.store, self.spec)
        head_block = self.store.blocks[head_root]
        finalized = self.store.finalized_checkpoint
        return StatusMessage(
            fork_digest=self.fork_digest(),
            finalized_root=bytes(finalized.root),
            finalized_epoch=finalized.epoch,
            head_root=head_root,
            head_slot=head_block.slot,
        )

    def metadata(self) -> Metadata:
        return Metadata(seq_number=self.metadata_seq)

    def block_by_slot(self, slot: int):
        return self.blocks.get_block_by_slot(slot, self.spec)

    def block_by_root(self, root: bytes):
        return self.blocks.get_block(root, self.spec)
