"""Fork choice: LMD-GHOST + Casper FFG store and handlers.

The port's copy of the JAX package's ``fork_choice`` package:
:mod:`.store` (the Store object + constructor), :mod:`.handlers`
(``on_tick`` / ``on_block`` / ``on_attestation`` / ``on_attestation_batch``
/ ``on_attester_slashing``), :mod:`.head` (``get_head`` with batched
vote-weight accumulation), :mod:`.tree` (incremental cached-head fork
tree), :mod:`.attestation` (epoch contexts over the device committee
cache) and :mod:`.forensics` (the consensus audit plane: head-decision
audits, reorg post-mortems, finality-lag decomposition, equivocation
evidence).
"""

from .attestation import (
    EpochAttestationContext,
    device_plane_store,
    get_attestation_context,
    get_state_attestation_context,
    registry_planes,
)
from .forensics import ConsensusForensics, ReorgRecord
from .handlers import (
    attestation_batch_target,
    on_attestation,
    on_attestation_batch,
    on_attester_slashing,
    on_block,
    on_tick,
)
from .head import get_head, get_weight, head_candidates
from .store import ForkChoiceError, LatestMessage, Store, checkpoint_key, get_forkchoice_store
from .tree import ForkTree, HeadCache

__all__ = [
    "ConsensusForensics",
    "EpochAttestationContext",
    "ForkChoiceError",
    "ForkTree",
    "HeadCache",
    "LatestMessage",
    "ReorgRecord",
    "Store",
    "attestation_batch_target",
    "checkpoint_key",
    "device_plane_store",
    "get_attestation_context",
    "get_forkchoice_store",
    "get_head",
    "get_state_attestation_context",
    "get_weight",
    "head_candidates",
    "on_attestation",
    "on_attestation_batch",
    "on_attester_slashing",
    "on_block",
    "on_tick",
    "registry_planes",
]
