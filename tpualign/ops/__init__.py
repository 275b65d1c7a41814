"""Alignment engines: NumPy oracle, pure-XLA row scan, and the bit-parallel
CUDA kernel for Hopper GPUs."""
