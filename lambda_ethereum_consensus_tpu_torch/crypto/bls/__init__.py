"""BLS12-381 on the host, and the device batch-verify entry points.

:mod:`.fields`, :mod:`.curve`, :mod:`.hash_to_curve`, :mod:`.pairing` and
:mod:`.api` are the port's own pure-Python copies of the JAX package's host
modules: they build test data and serve as the oracle.  :mod:`.batch`
verifies signature sets and drains attestations through the port's device
chain (:mod:`..ops.bls_batch`).
"""

from .api import (
    G2_POINT_AT_INFINITY,
    BlsError,
    aggregate,
    aggregate_verify,
    eth_aggregate_pubkeys,
    eth_fast_aggregate_verify,
    fast_aggregate_verify,
    key_validate,
    keygen,
    sign,
    sk_to_pk,
    verify,
)
from .batch import batch_verify

__all__ = [
    "BlsError",
    "G2_POINT_AT_INFINITY",
    "aggregate",
    "aggregate_verify",
    "batch_verify",
    "eth_aggregate_pubkeys",
    "eth_fast_aggregate_verify",
    "fast_aggregate_verify",
    "key_validate",
    "keygen",
    "sign",
    "sk_to_pk",
    "verify",
]
