"""PyTorch/CUDA port of ``lambda_ethereum_consensus_tpu``.

The same SSZ engine and beacon-chain containers, with Merkleization hashed
by a hand-written CUDA SHA-256 kernel, and the attestation drain's batched
BLS12-381 verification on the card through three hand-written field kernels,
for an NVIDIA H100.  Layout mirrors the JAX package: ``config/``, ``ssz/``,
``types/``, ``crypto/bls/``, ``ops/``; the CUDA sources live in ``csrc/`` and
build at first use (``ops/_build.py``).
"""
