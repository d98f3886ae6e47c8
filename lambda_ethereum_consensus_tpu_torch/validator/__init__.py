"""Validator-duty plane: duty scheduling, batched signing, production.

The reference ships validator *containers* only (lib/ssz_types/validator/);
this package carries the whole write side — the single-key helpers devnets
and fixtures mint chains with (:mod:`.duties`), and the duty
engine operating 10^4-10^5 keys from one node: per-epoch assignment
derivation, batched device/host signing, pooled aggregation and the
proposer path (:mod:`.scheduler`, :mod:`.pool`), and the epoch walk
(:mod:`.harness`).  The port's copy of the JAX package's ``validator``
package.
"""

from .duties import (
    attestation_data_from_state,
    build_aggregate_and_proof,
    build_signed_block,
    get_slot_signature,
    is_aggregator,
    is_aggregator_hash,
    make_attestation,
    make_sync_aggregate,
    proposer_index_at_slot,
    sign_block,
)
from .pool import AttestationPool
from .scheduler import AttesterDuty, DutyScheduler, EpochDuties

__all__ = [
    "AttestationPool",
    "AttesterDuty",
    "DutyScheduler",
    "EpochDuties",
    "attestation_data_from_state",
    "build_aggregate_and_proof",
    "build_signed_block",
    "get_slot_signature",
    "is_aggregator",
    "is_aggregator_hash",
    "make_attestation",
    "make_sync_aggregate",
    "proposer_index_at_slot",
    "sign_block",
]
