"""Data-availability plane (Deneb/EIP-4844): KZG commitments on the
device G1 ladder plus the block-import availability gate.

- :mod:`.kzg` — trusted setup, blob-to-commitment MSM, single and
  RLC-folded batch proof verification (one pairing check per batch).
- :mod:`.availability` — the bounded pending-DA buffer that parks block
  import until every expected blob sidecar has arrived and verified.
"""

from .availability import DaError, DataAvailability  # noqa: F401
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
