"""Serving path for the dense family: KV caches, prefill and one-token
decode steps (port of ``repro.models.decode``).

``prefill`` runs the prompt (its causal self-attention through the
``swa_attention`` kernel) and captures each layer's K/V into a cache of
``cache_len`` slots — a ring buffer of ``swa_window`` slots when the
window is on.  ``decode_step`` consumes ONE new token per request
against that cache, in plain torch as in the JAX package, and writes the
token's K/V into the cache in place (see
:func:`repro_torch.models.attention.decode_attend`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.models.transformer import (
    _attn_out,
    _ff,
    check_dense,
    dtype_of,
    layer,
    output_table,
    positions_of,
)
from repro_torch.utils.device import DeviceLike, resolve_device


def _effective_cache_len(cfg: ModelConfig, cache_len: int) -> int:
    if cfg.swa_window is not None:
        return min(cache_len, cfg.swa_window)
    return cache_len


def _stacked_kv_axes() -> A.KVCache:
    kv = ("layer", "batch", "cache_seq", "kv_heads", None)
    return A.KVCache(k=kv, v=kv, pos_ids=("layer", "cache_seq"))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: DeviceLike = "cuda",
               dtype: Optional[torch.dtype] = None):
    """Returns (cache, logical_axes) for one-token decoding: a KVCache
    whose leaves carry a leading layer axis."""
    check_dense(cfg)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    device = resolve_device(device)
    C = _effective_cache_len(cfg, cache_len)
    shape = (cfg.num_layers, batch, C, cfg.num_kv_heads, cfg.head_dim_)
    cache = A.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos_ids=torch.full((cfg.num_layers, C), -1, dtype=torch.int32,
                           device=device))
    return cache, _stacked_kv_axes()


def _attn_block_decode(lp, cfg, x, cache_l, pos):
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    o, cache_l = A.decode_attend(lp["attn"], cfg, h, cache_l, pos)
    x = x + _attn_out(lp["attn"], o)
    ff, _ = _ff(lp, cfg, x)
    return x + ff, cache_l


def decode_step(cfg: ModelConfig, params, cache: A.KVCache,
                tokens: torch.Tensor, pos: int):
    """tokens (B, 1) int; pos the tokens' absolute position.  Returns
    (logits (B,1,V) fp32, cache), the cache updated in place."""
    check_dense(cfg)
    x = embed(params["embedding"], tokens, dtype_of(cfg.compute_dtype))
    for i in range(cfg.num_layers):
        x, _ = _attn_block_decode(layer(params["blocks"], i), cfg, x,
                                  layer(cache, i), pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(output_table(cfg, params), x), cache


def prefill(cfg: ModelConfig, params, batch, cache_len: int):
    """Run the prompt, return (logits (B,S,V) fp32, cache ready for
    ``decode_step``)."""
    check_dense(cfg)
    x = embed(params["embedding"], batch["tokens"],
              dtype_of(cfg.compute_dtype))
    positions = positions_of(x)
    C = _effective_cache_len(cfg, cache_len)
    caches = []
    for i in range(cfg.num_layers):
        lp = layer(params["blocks"], i)
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = A.qkv(lp["attn"], cfg, hn, positions)
        o = A.attention(q, k, v, causal=True, window=cfg.swa_window)
        x = x + _attn_out(lp["attn"], o)
        ff, _ = _ff(lp, cfg, x)
        x = x + ff
        caches.append(A.prefill_into_cache(lp["attn"], cfg, k, v, C))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = A.KVCache(*(torch.stack(leaves) for leaves in zip(*caches)))
    return unembed(output_table(cfg, params), x), cache
