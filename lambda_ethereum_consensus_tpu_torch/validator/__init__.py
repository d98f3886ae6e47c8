"""Block and attestation production: the single-key helpers that mint a
chain (:mod:`.duties`).  The JAX package's duty scheduler and attestation
pool are not ported."""

from .duties import (
    attestation_data_from_state,
    build_signed_block,
    make_attestation,
    make_sync_aggregate,
    proposer_index_at_slot,
    sign_block,
)

__all__ = [
    "attestation_data_from_state",
    "build_signed_block",
    "make_attestation",
    "make_sync_aggregate",
    "proposer_index_at_slot",
    "sign_block",
]
