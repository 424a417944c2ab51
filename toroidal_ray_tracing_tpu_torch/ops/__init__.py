"""Hand-written trace kernels (CUDA sources in ../csrc) and their
orchestration."""
