"""Device ops: hand-written CUDA kernels, their wrappers and plain versions."""
