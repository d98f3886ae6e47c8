"""Validator-duty containers (ref: lib/ssz_types/validator/*.ex)."""

from ..ssz import Container
from .base import BLSSignature, ValidatorIndex
from .beacon import Attestation


class AggregateAndProof(Container):
    aggregator_index: ValidatorIndex
    aggregate: Attestation
    selection_proof: BLSSignature


class SignedAggregateAndProof(Container):
    message: AggregateAndProof
    signature: BLSSignature
