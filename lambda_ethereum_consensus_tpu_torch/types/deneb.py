"""Deneb (EIP-4844) wire containers: blobs and their KZG sidecars.

The blob itself stays an opaque byte vector at this layer —
``FIELD_ELEMENTS_PER_BLOB * 32`` bytes, one 32-byte big-endian field
element per chunk — and the cryptographic interpretation (commitment,
proof, versioned-hash linkage) lives in :mod:`..da.kzg`.  Sizes are
spec-late-bound like every other container here, so the same classes
serve the mainnet preset (4096 field elements) and the minimal preset
(4 field elements, which keeps CI-path MSMs tiny).
"""

from ..ssz import ByteVector, Container, Vector, uint64
from .base import Bytes32, Bytes48
from .beacon import SignedBeaconBlockHeader

KZGCommitment = Bytes48
KZGProof = Bytes48
VersionedHash = Bytes32
BlobIndex = uint64

#: One blob: FIELD_ELEMENTS_PER_BLOB 32-byte field elements, flat.
Blob = ByteVector(lambda spec: spec.FIELD_ELEMENTS_PER_BLOB * 32)


class BlobIdentifier(Container):
    block_root: Bytes32
    index: BlobIndex


class BlobSidecar(Container):
    index: BlobIndex
    blob: Blob
    kzg_commitment: KZGCommitment
    kzg_proof: KZGProof
    signed_block_header: SignedBeaconBlockHeader
    kzg_commitment_inclusion_proof: Vector(
        Bytes32, "KZG_COMMITMENT_INCLUSION_PROOF_DEPTH"
    )
