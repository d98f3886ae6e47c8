"""The random-linear-combination coefficient width.

A leaf module, so that both the device chain (:mod:`.bls_batch`) and the
host-facing entry points (:mod:`..crypto.bls.batch`) take their default
from one place without importing each other.
"""

#: RLC coefficient width (bits) the entry points default to: the deployed
#: batch-verification width of the JAX package (``BLS_RLC_BITS``).
COEFF_BITS = 64
