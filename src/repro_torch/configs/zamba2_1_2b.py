"""Zamba2 1.2B — hybrid Mamba2 backbone with a shared attention block.

[arXiv:2411.15242] 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. One *shared-weight* attention block interleaved every 6
Mamba2 layers (Zamba-style parameter sharing).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64),
    shared_attn_every=6,
    source="arXiv:2411.15242",
)
