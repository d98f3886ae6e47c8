"""BLS12-381 on the host, and the device batch-verify entry point.

:mod:`.fields`, :mod:`.curve`, :mod:`.hash_to_curve` and :mod:`.pairing` are
the port's own pure-Python copies of the JAX package's host modules: they
build test data and serve as the oracle.  :mod:`.batch` drains attestations
through the port's device chain (:mod:`..ops.bls_batch`).
"""
