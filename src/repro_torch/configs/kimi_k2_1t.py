"""Kimi K2 — trillion-parameter MoE (paper-table entry).

[arXiv:2501.kimi2] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert)
vocab=163840, MoE 384 experts top-8, 1 shared expert.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=163840,
    head_dim=128,
    rope_theta=1e6,
    moe=MoEConfig(
        num_experts=384,
        experts_per_token=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        capacity_factor=1.25,
    ),
    source="arXiv:2501.kimi2",
)
