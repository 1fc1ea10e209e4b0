"""Serving path: caches, prefill and one-token decode steps (port of
``repro.models.decode``).  ``decode_step`` consumes ONE new token per
request against the cache, in plain torch as in the JAX package, and
updates the cache in place (see
:func:`repro_torch.models.attention.decode_attend`).  Per family:

* dense / moe — ``prefill`` runs the prompt (its causal self-attention
  through the ``swa_attention`` kernel) and captures each layer's K/V
  into a cache of ``cache_len`` slots, a ring buffer of ``swa_window``
  slots when the window is on.  A moe layer's experts run as in
  training; at decode T = B tokens, so ``capacity`` gives its floor.
* hybrid (zamba2) — a cache of the Mamba2 (ssm, conv) states per layer
  and one KV cache of ``cache_len`` slots per shared-attention site.
  ``prefill`` replays the prompt through ``decode_step`` (the state is
  O(1) in the context, the JAX package's recurrent prefill) and returns
  the last position's logits (B, 1, V); it launches no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.models.transformer import (
    _attn_out,
    _ff,
    check_family,
    dtype_of,
    group_bounds,
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


def _stacked_kv(n: int, batch: int, C: int, cfg, dtype, device) -> A.KVCache:
    shape = (n, batch, C, cfg.num_kv_heads, cfg.head_dim_)
    return A.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos_ids=torch.full((n, C), -1, dtype=torch.int32, device=device))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: DeviceLike = "cuda",
               dtype: Optional[torch.dtype] = None):
    """Returns (cache, logical_axes) for one-token decoding: for dense
    and moe a KVCache whose leaves carry a leading layer axis; for the
    hybrid ``{"mamba": MambaState, "attn": KVCache}``, the states
    stacked over layers and the caches over shared-attention sites."""
    check_family(cfg)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    device = resolve_device(device)
    if cfg.arch_type == "hybrid":
        n_sites = len(group_bounds(cfg.num_layers, cfg.shared_attn_every))
        one = SSM.init_mamba_state(cfg, batch, dtype, device)
        mamba = SSM.MambaState(*(
            torch.zeros((cfg.num_layers,) + t.shape, dtype=t.dtype,
                        device=device) for t in one))
        mamba_ax = SSM.MambaState(*(("layer",) + a
                                    for a in SSM.mamba_state_axes()))
        return ({"mamba": mamba,
                 "attn": _stacked_kv(n_sites, batch, cache_len, cfg, dtype,
                                     device)},
                {"mamba": mamba_ax, "attn": _stacked_kv_axes()})
    C = _effective_cache_len(cfg, cache_len)
    return (_stacked_kv(cfg.num_layers, batch, C, cfg, dtype, device),
            _stacked_kv_axes())


def _attn_block_decode(lp, cfg, x, cache_l, pos):
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    o, cache_l = A.decode_attend(lp["attn"], cfg, h, cache_l, pos)
    x = x + _attn_out(lp["attn"], o)
    ff, _ = _ff(lp, cfg, x)
    return x + ff, cache_l


def _hybrid_decode(cfg, params, cache, x, pos: int):
    shared = params["shared_attn"]
    mamba = cache["mamba"]
    for site, (s, e) in enumerate(group_bounds(cfg.num_layers,
                                               cfg.shared_attn_every)):
        for i in range(s, e):
            lp = layer(params["blocks"], i)
            y, st = SSM.mamba2_decode_step(
                lp["mamba"], cfg, rms_norm(x, lp["ln"], cfg.norm_eps),
                layer(mamba, i))
            x = x + y
            mamba.ssm[i].copy_(st.ssm)
            mamba.conv[i].copy_(st.conv)
        x, _ = _attn_block_decode(shared, cfg, x, layer(cache["attn"], site),
                                  pos)
    return x


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: int):
    """tokens (B, 1) int; pos the tokens' absolute position.  Returns
    (logits (B,1,V) fp32, cache), the cache updated in place."""
    check_family(cfg)
    x = embed(params["embedding"], tokens, dtype_of(cfg.compute_dtype))
    if cfg.arch_type == "hybrid":
        x = _hybrid_decode(cfg, params, cache, x, pos)
    else:
        for i in range(cfg.num_layers):
            x, _ = _attn_block_decode(layer(params["blocks"], i), cfg, x,
                                      layer(cache, i), pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(output_table(cfg, params), x), cache


def prefill(cfg: ModelConfig, params, batch, cache_len: int):
    """Run the prompt, return (logits, cache ready for ``decode_step``):
    the logits (B,S,V) fp32 of every position, or for the hybrid, whose
    prefill replays the prompt through ``decode_step``, the last
    position's (B,1,V)."""
    check_family(cfg)
    if cfg.arch_type == "hybrid":
        tokens = batch["tokens"]
        cache, _ = init_cache(cfg, tokens.shape[0], cache_len,
                              device=tokens.device)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = decode_step(cfg, params, cache,
                                        tokens[:, t:t + 1], t)
        return logits, cache
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
