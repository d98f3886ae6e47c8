"""Data-availability plane (Deneb/EIP-4844): KZG commitments on the
device G1 ladder.

- :mod:`.kzg` — trusted setup, blob-to-commitment MSM, single and
  RLC-folded batch proof verification (one pairing check per batch).

The JAX package's block-import availability gate (``da/availability.py``)
is not ported yet.
"""

from .kzg import (  # noqa: F401
    KzgError,
    blob_to_commitment,
    compute_blob_proof,
    dev_setup,
    trusted_setup,
    verify_blob_batch,
    verify_blob_proof,
    versioned_hash,
    warm_kzg_programs,
)
