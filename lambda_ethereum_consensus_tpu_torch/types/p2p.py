"""P2P wire containers (ref: lib/ssz_types/p2p/*.ex)."""

from ..ssz import Bitvector, Container, List, uint64
from .base import Epoch, ForkDigest, Root, Slot
from .beacon import SignedBeaconBlock


class StatusMessage(Container):
    """Req/resp ``status`` payload (ref: lib/ssz_types/p2p/status_message.ex)."""

    fork_digest: ForkDigest
    finalized_root: Root
    finalized_epoch: Epoch
    head_root: Root
    head_slot: Slot


class BeaconBlocksByRangeRequest(Container):
    start_slot: Slot
    count: uint64
    step: uint64


class BeaconBlocksByRangeResponse(Container):
    body: List(SignedBeaconBlock, 1024)


class BeaconBlocksByRootRequest(Container):
    body: List(Root, 1024)


class Metadata(Container):
    """ENR metadata served on the ``metadata`` protocol
    (ref: lib/ssz_types/p2p/metadata.ex)."""

    seq_number: uint64
    attnets: Bitvector(64)   # ATTESTATION_SUBNET_COUNT
    syncnets: Bitvector(4)   # SYNC_COMMITTEE_SUBNET_COUNT
