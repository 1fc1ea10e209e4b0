"""Sliding-window causal flash attention: CUDA kernel, plain version, wrapper."""
