"""Primitive type aliases of the beacon-chain spec (ref: lib/ssz_types/mod.ex).

These are SSZ descriptor aliases — ``Slot``/``Epoch``/... are ``uint64``,
roots/digests are fixed byte vectors — shared by every container module.
"""

from ..ssz import ByteList, ByteVector, uint8, uint64

# unsigned integer aliases
Slot = uint64
Epoch = uint64
CommitteeIndex = uint64
ValidatorIndex = uint64
Gwei = uint64
WithdrawalIndex = uint64
ParticipationFlags = uint8

# byte-vector aliases
Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)

Root = Bytes32
Hash32 = Bytes32
Version = Bytes4
DomainType = Bytes4
ForkDigest = Bytes4
Domain = Bytes32
BLSPubkey = Bytes48
BLSSignature = Bytes96
ExecutionAddress = Bytes20

#: EL transaction as opaque bytes (ref: lib/ssz_types/transaction.ex)
Transaction = ByteList("MAX_BYTES_PER_TRANSACTION")
