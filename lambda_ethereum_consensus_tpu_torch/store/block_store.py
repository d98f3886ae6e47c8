"""Typed block persistence (ref: lib/.../store/block_store.ex).

Key scheme mirrors the reference: ``block|root -> SSZ(SignedBeaconBlock)``
plus a ``blockslot|<slot be64> -> root`` index for slot lookups and
missing-range scans (ref: block_store.ex:12-76).

The port's copy of the JAX package's ``store/block_store.py``.
"""

from __future__ import annotations

from typing import Iterator

from ..config import ChainSpec, get_chain_spec
from ..types.beacon import SignedBeaconBlock
from .kv import KvStore

_BLOCK = b"block|"
_SLOT = b"blockslot|"


def _slot_key(slot: int) -> bytes:
    return _SLOT + int(slot).to_bytes(8, "big")


class BlockStore:
    def __init__(self, kv: KvStore):
        self._kv = kv

    def store_block(
        self,
        signed_block: SignedBeaconBlock,
        spec: ChainSpec | None = None,
        root: bytes | None = None,
    ) -> bytes:
        """Store under ``root`` (defaults to the block's hash tree root —
        checkpoint anchors override it with the real header root)."""
        spec = spec or get_chain_spec()
        if root is None:
            root = signed_block.message.hash_tree_root(spec)
        self._kv.put(_BLOCK + root, signed_block.encode(spec))
        self._kv.put(_slot_key(signed_block.message.slot), root)
        return root

    def get_block(
        self, root: bytes, spec: ChainSpec | None = None
    ) -> SignedBeaconBlock | None:
        raw = self._kv.get(_BLOCK + root)
        if raw is None:
            return None
        return SignedBeaconBlock.decode(raw, spec or get_chain_spec())

    def has_block(self, root: bytes) -> bool:
        return self._kv.get(_BLOCK + root) is not None

    def get_block_root_by_slot(self, slot: int) -> bytes | None:
        return self._kv.get(_slot_key(slot))

    def get_block_by_slot(
        self, slot: int, spec: ChainSpec | None = None
    ) -> SignedBeaconBlock | None:
        root = self.get_block_root_by_slot(slot)
        return None if root is None else self.get_block(root, spec)

    def stored_slots(self, descending: bool = False) -> Iterator[int]:
        for key, _ in self._kv.iterate_prefix(_SLOT, descending=descending):
            yield int.from_bytes(key[len(_SLOT) :], "big")

    def missing_slots(self, start: int, stop: int) -> list[int]:
        """Slots in [start, stop) without a stored block
        (ref: block_store.ex stream_missing_blocks_*)."""
        have = set()
        for key, _ in self._kv.iterate(_slot_key(start), _slot_key(stop)):
            have.add(int.from_bytes(key[len(_SLOT) :], "big"))
        return [s for s in range(start, stop) if s not in have]

    def highest_slot(self) -> int | None:
        kv = self._kv.last_under_prefix(_SLOT)
        if kv is None:
            return None
        return int.from_bytes(kv[0][len(_SLOT) :], "big")
