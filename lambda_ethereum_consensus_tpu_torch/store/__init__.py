"""Persistence: native KV store + typed block/state stores.

Replaces the reference's LevelDB layer (ref: lib/lambda_ethereum_consensus/
store/{db.ex,block_store.ex,state_store.ex}) with a C++ ordered KV engine
(``native/kvstore``) bound via ctypes, plus the same key schemes:
``block|root``, ``blockslot|slot -> root``, ``beacon_state|root``,
``stateslot|slot -> root`` and the highest-slot resume seek.

Round 20: the WAL is framed + checksummed (crash-consistent, torn tails
truncated and reported), ``finalized|anchor`` marks the fsync-barriered
finality snapshot, and resume candidates are state-root-verified before
adoption (see ARCHITECTURE.md "Durability & crash recovery").

The port's copy of the JAX package's ``store`` package, the WAL format the
same, so a file written by either package opens in the other.  The native
engine is built from ``native/kvstore/kvstore.cpp`` into the package's
``_build/`` (:mod:`.kv`); the state root of a verified resume runs on the
installed hash backend (the SHA-256 kernel on the card).
"""

from .block_store import BlockStore
from .kv import KvError, KvStore, fsync_replace
from .state_store import (
    StateStore,
    get_finalized_anchor,
    set_finalized_anchor,
)

__all__ = [
    "KvError",
    "KvStore",
    "fsync_replace",
    "BlockStore",
    "StateStore",
    "get_finalized_anchor",
    "set_finalized_anchor",
]
