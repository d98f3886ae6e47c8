"""The beacon-chain state transition (capella), with its device planes on
the card.

The port's copy of the JAX package's ``state_transition/``: pure functions
over immutable SSZ containers, a mutable working state
(:class:`~.mutable.BeaconStateMut`) inside a transition, and numpy over the
registry columns for every O(n_validators) pass.  Two planes run on the
device: every slot's state root goes through the incremental engine
(``ssz/incremental.py``), whose full-field rebuilds use the installed hash
backend (the SHA-256 kernel), and every epoch boundary of a large registry
runs on the resident plane (:mod:`.resident`), torch ops over int64
columns held on the card.  A block's attestation signatures are checked as
one batch, routed by size (``state_transition/operations.py``
``_verify_deferred_attestations``): the epoch committee cache on the
device, or host sums through ``crypto/bls/batch.verify_points``, itself
routed between the device chain and the host tail.

Entry points take ``device=None``, meaning the card, and raise where it is
absent; ``device="cpu"`` runs the plain PyTorch versions.
"""

from .core import (
    StateTransitionError,
    process_block,
    process_slot,
    process_slots,
    state_root,
    state_transition,
)

__all__ = [
    "StateTransitionError",
    "process_block",
    "process_slot",
    "process_slots",
    "state_root",
    "state_transition",
]
