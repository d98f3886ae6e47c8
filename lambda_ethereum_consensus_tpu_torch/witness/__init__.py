"""Stateless witness plane: binary-Merkle multiproofs and a
vector-commitment prototype, on the card.

A node serving *stateless* light clients answers "what is balance[i] /
validator[j] under state root R?" with a **witness**: the leaf chunks plus
the minimal deduplicated sibling set that rehashes to R.

Submodules:

- :mod:`.multiproof` — gindex math, proof planning/generation against
  :class:`~..ssz.incremental.IncrementalStateRoot` retained levels,
  SSZ/JSON proof encodings, and the bit-exact host verification oracle.
  numpy + hashlib only.
- :mod:`.verify` — batched verification: B multiproofs as one SHA-256
  plane on the card, one launch of the hand-written kernel per Merkle
  round, with the host oracle below :data:`.verify.DEVICE_MIN` proofs.
- :mod:`.vector_commitment` — width-256 Pedersen vector commitment whose
  MSM runs on :func:`..ops.bls_g1.batch_g1_mul` (EXPERIMENTAL — see its
  module docstring).
- :mod:`.service` — per-state planners and the shared proof cache;
  :mod:`.coalesce` — cross-request batching of verify requests.

The port's copy of the JAX package's ``witness/``; the beacon API routes
that serve it are :mod:`..api.beacon_api`'s.
"""

from .multiproof import (  # noqa: F401
    WitnessError,
    WitnessProof,
    WitnessPlanner,
    helper_gindices,
    plan_rounds,
    verify_host,
    witness_fields,
)

__all__ = [
    "WitnessError",
    "WitnessProof",
    "WitnessPlanner",
    "helper_gindices",
    "plan_rounds",
    "verify_host",
    "witness_fields",
]
