"""Mixtral 8x7B — sparse MoE with sliding-window attention.

[arXiv:2401.04088] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, SWA (window 4096 per the model card).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,  # all FF capacity is in the experts
    vocab_size=32000,
    swa_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=14336),
    source="arXiv:2401.04088",
)
