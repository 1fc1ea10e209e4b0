"""Configuration dataclasses and the architecture registry (copies of
the JAX package's).

``get_config(arch_id)`` resolves ``--arch`` names: every architecture of
the JAX package, in its six families (dense, moe, hybrid, ssm, audio,
vlm); ``SHAPES`` holds the workload shapes.  ``reduced(cfg)`` is the
smoke-test variant of the same family (a copy of
``repro.configs.reduced``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_7b,
    kimi_k2_1t,
    llama3_2_3b,
    mixtral_8x7b,
    phi3_vision_4_2b,
    qwen3_32b,
    smollm_135m,
    whisper_medium,
    xlstm_350m,
    zamba2_1_2b,
)
from repro_torch.configs.base import SHAPES, InputShape, ModelConfig  # noqa: F401

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_7b, kimi_k2_1t, llama3_2_3b, mixtral_8x7b,
              phi3_vision_4_2b, qwen3_32b, smollm_135m, whisper_medium,
              xlstm_350m, zamba2_1_2b)
}

ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}"
        ) from None


def list_archs() -> tuple:
    return ARCH_IDS


def reduced(cfg: ModelConfig, *, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same architecture family.

    ≤2 layers, d_model ≤ 512, ≤4 experts, small vocab — runs a real
    forward step on the CPU in a fraction of a second.
    """
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    # keep the GQA ratio family: kv must divide heads
    while heads % kv:
        kv -= 1
    upd: dict = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, vocab),
        head_dim=d_model // heads,
    )
    if cfg.moe is not None:
        upd["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 512),
        )
    if cfg.ssm is not None:
        upd["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=min(cfg.ssm.state_dim, 32), chunk_size=64
        )
    if cfg.xlstm is not None:
        upd["xlstm"] = dataclasses.replace(cfg.xlstm, chunk_size=64)
    if cfg.encoder_layers:
        upd["encoder_layers"] = min(cfg.encoder_layers, 2)
    if cfg.num_patches:
        upd["num_patches"] = min(cfg.num_patches, 16)
    if cfg.swa_window is not None:
        upd["swa_window"] = min(cfg.swa_window, 64)
    if cfg.shared_attn_every:
        upd["shared_attn_every"] = 1
    return cfg.replace(**upd)
