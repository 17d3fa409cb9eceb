"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``reduce``: K1, the fused per-step combine; ``flash``: K2, the
flash-attention block update; ``decode``: K6 decode attention and the
K7/K8 cache writes)."""
