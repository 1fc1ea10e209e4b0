"""Fused vocab-tiled cross-entropy: CUDA kernel, plain version, wrapper."""
