"""PyTorch/CUDA port of ``lambda_ethereum_consensus_tpu``.

The same SSZ engine and beacon-chain containers, with Merkleization hashed
by a hand-written CUDA SHA-256 kernel on an NVIDIA H100.  Layout mirrors the
JAX package: ``config/``, ``ssz/``, ``types/``, ``ops/sha256.py``; the CUDA
sources live in ``csrc/`` and build at first use (``ops/_build.py``).
"""
