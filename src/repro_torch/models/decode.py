"""Serving path: caches, prefill and one-token decode steps (port of
``repro.models.decode``).  ``decode_step`` consumes ONE new token per
request against the cache, in plain torch as in the JAX package, and
updates the cache in place (see
:func:`repro_torch.models.attention.decode_attend`).  Per family:

* dense / moe / vlm — ``prefill`` runs the prompt (its causal
  self-attention through the ``swa_attention`` kernel) and captures each
  layer's K/V into a cache of ``cache_len`` slots, a ring buffer of
  ``swa_window`` slots when the window is on.  A moe layer's experts run
  as in training; at decode T = B tokens, so ``capacity`` gives its
  floor.  vlm's prefill takes the tokens only, as the JAX package's.
* hybrid (zamba2) — a cache of the Mamba2 (ssm, conv) states per layer
  and one KV cache of ``cache_len`` slots per shared-attention site.
* ssm (xlstm) — the mLSTM matrix memory and the sLSTM (c, n, m, h)
  states per pair, O(1) in the context.
* The hybrid and ssm ``prefill`` replays the prompt through
  ``decode_step`` (the JAX package's recurrent prefill) and returns the
  last position's logits (B, 1, V); it launches no kernel.
* audio (whisper) — a decoder self-attention cache of ``DECODER_LEN``
  slots and the cross-attention K/V of every decoder layer over the
  ``cache_len`` encoder frames.  ``prefill`` encodes the frames once and
  fills the cross K/V; it returns no logits (``None``).  Decode is
  plain: whisper serving launches no kernel.  As in the JAX package,
  decode's self-attention applies RoPE (``decode_attend``), which the
  decoder's training forward does not.

On a rank of a serving mesh every attention runs on the rank's heads
(or, with ``cache_seq_shard``, on its slice of the cache's positions or
of whisper's frames: :func:`~repro_torch.models.attention.cross_decode`),
and the cache is filled in the plan's layout; so do zamba2's Mamba2
layers and xlstm's mLSTM, whose states are the rank's heads (and ``ff``
columns), while the sLSTM's states are whole on every rank.  Under
``seq_shard`` the prefill runs on each rank's chunk of the prompt: the
chunk is gathered before each layer's projections, so the rank's K and
V cover every position, which the cache takes; the logits are the whole
sequence's.  The recurrent prefill replays the whole prompt (the plan's
``seq_shard`` chunks nothing there: ``launch/steps.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.whisper_medium import DECODER_LEN
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.layers import rms_norm, unembed
from repro_torch.models.transformer import (
    _ff,
    _lookup_table,
    attn_proj,
    check_family,
    cross_kv,
    dtype_of,
    embed_tokens,
    group_bounds,
    layer,
    output_table,
    whisper_encode,
)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.constraint import constrain_act, constrain_params
from repro_torch.sharding.rules import map_axes
from repro_torch.utils.device import DeviceLike, resolve_device


def _effective_cache_len(cfg: ModelConfig, cache_len: int) -> int:
    if cfg.swa_window is not None:
        return min(cache_len, cfg.swa_window)
    return cache_len


def _stacked_kv_axes() -> A.KVCache:
    base = A.kv_cache_axes()
    return A.KVCache(k=("layer",) + base.k, v=("layer",) + base.v,
                     pos_ids=("layer",) + base.pos_ids)


def _stacked_kv(n: int, batch: int, C: int, cfg, dtype, device) -> A.KVCache:
    shape = (n, batch, C, cfg.num_kv_heads, cfg.head_dim_)
    return A.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos_ids=torch.full((n, C), -1, dtype=torch.int32, device=device))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: DeviceLike = "cuda",
               dtype: Optional[torch.dtype] = None):
    """Returns (cache, logical_axes) for one-token decoding: for dense,
    moe and vlm a KVCache whose leaves carry a leading layer axis; for
    the hybrid ``{"mamba": MambaState, "attn": KVCache}``, the states
    stacked over layers and the caches over shared-attention sites; for
    ssm ``{"mlstm": MLSTMState, "slstm": SLSTMState}`` stacked over pairs
    (fp32 whatever ``dtype``, as the JAX package's); for audio ``{"self":
    KVCache, "cross_k", "cross_v"}``, the cross K/V of ``cache_len``
    encoder frames (zeros until ``prefill`` fills them).  On
    ``device="meta"`` the leaves are the dry-run's abstract stand-ins
    (the JAX package's ``abstract=True``): shapes and dtypes, no data."""
    check_family(cfg)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    device = resolve_device(device)
    if cfg.arch_type == "ssm":
        pairs = cfg.num_layers // 2
        hd = int(cfg.d_model * cfg.xlstm.mlstm_proj_factor) // cfg.num_heads

        def zeros(*shape):
            return torch.zeros((pairs, batch) + shape, dtype=torch.float32,
                               device=device)

        m = XL.MLSTMState(C=zeros(cfg.num_heads, hd, hd),
                          n=zeros(cfg.num_heads, hd))
        s = XL.SLSTMState(c=zeros(cfg.d_model), n=zeros(cfg.d_model),
                          m=zeros(cfg.d_model) - 20.0, h=zeros(cfg.d_model))
        axes = {"mlstm": XL.MLSTMState(
                    C=("layer", "batch", "heads", None, None),
                    n=("layer", "batch", "heads", None)),
                "slstm": XL.SLSTMState(*([("layer", "batch", "embed")]
                                         * 4))}
        return {"mlstm": m, "slstm": s}, axes
    if cfg.arch_type == "audio":
        shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
                 cfg.head_dim_)
        ax = ("layer", "batch", "cache_seq", "kv_heads", None)
        return ({"self": _stacked_kv(cfg.num_layers, batch, DECODER_LEN, cfg,
                                     dtype, device),
                 "cross_k": torch.zeros(shape, dtype=dtype, device=device),
                 "cross_v": torch.zeros(shape, dtype=dtype, device=device)},
                {"self": _stacked_kv_axes(), "cross_k": ax, "cross_v": ax})
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
    x = x + attn_proj(lp["attn"], cfg, o)
    ff, _ = _ff(lp, cfg, x)
    return x + ff, cache_l


def _hybrid_decode(cfg, params, cache, x, pos):
    # sites the JAX package leaves to XLA: a mesh rank's data-split
    # blocks are gathered where each layer and the shared block are read
    shared = constrain_params(params["shared_attn"], "shared_attn")
    mamba = cache["mamba"]
    for site, (s, e) in enumerate(group_bounds(cfg.num_layers,
                                               cfg.shared_attn_every)):
        for i in range(s, e):
            lp = constrain_params(layer(params["blocks"], i), "blocks")
            y, st = SSM.mamba2_decode_step(
                lp["mamba"], cfg, rms_norm(x, lp["ln"], cfg.norm_eps),
                layer(mamba, i))
            x = x + y
            mamba.ssm[i].copy_(st.ssm)
            mamba.conv[i].copy_(st.conv)
        x, _ = _attn_block_decode(shared, cfg, x, layer(cache["attn"], site),
                                  pos)
    return x


def _xlstm_decode(cfg, params, cache, x):
    mst, sst = cache["mlstm"], cache["slstm"]
    for i in range(cfg.num_layers // 2):
        # JAX decode.py's scan body: a mesh rank's data-split blocks are
        # gathered here
        lp = constrain_params(layer(params["pairs"], i), "pairs")
        y, m_new = XL.mlstm_decode_step(
            lp["mlstm"], cfg, rms_norm(x, lp["ln_m"], cfg.norm_eps),
            layer(mst, i))
        x = x + y
        y, s_new = XL.slstm_decode_step(
            lp["slstm"], cfg, rms_norm(x, lp["ln_s"], cfg.norm_eps),
            layer(sst, i))
        x = x + y
        x = x + XL.slstm_block_mlp(lp["slstm"], cfg, x)
        for state, new in ((mst, m_new), (sst, s_new)):
            for t, v in zip(state, new):
                t[i].copy_(v)
    return x


def _whisper_decode(cfg, params, cache, x, pos):
    dtype = x.dtype
    dec_pos = constrain_params(params["dec_pos"], "dec_pos")
    if torch.is_tensor(pos):  # a traced position: no read to the host
        row = dec_pos.index_select(0, pos.reshape(1).long())[0]
    else:
        row = dec_pos[pos]
    x = x + row.to(dtype)[None, None]
    for i in range(cfg.num_layers):
        # a mesh rank's data-split blocks are gathered here (ZeRO-3
        # serving); the attentions run on the rank's heads
        lp = constrain_params(layer(params["dec_blocks"], i), "dec_blocks")
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        o, _ = A.decode_attend(lp["attn"], cfg, hn, layer(cache["self"], i),
                               pos)
        x = x + attn_proj(lp["attn"], cfg, o)
        hn = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        o = A.cross_decode(lp["cross"], cfg, hn, cache["cross_k"][i],
                           cache["cross_v"][i])
        x = x + attn_proj(lp["cross"], cfg, o, "cross_out")
        ff, _ = _ff(lp, cfg, x, gelu=True)
        x = x + ff
    return x


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos):
    """tokens (B, 1) int; pos the tokens' absolute position, an int or a
    0-d integer tensor on the tokens' device (the serve step's traced
    input; see :func:`~repro_torch.models.attention.decode_attend`).
    Returns (logits (B,1,V) fp32, cache), the cache updated in place."""
    check_family(cfg)
    x = embed_tokens(cfg, _lookup_table(params, None), tokens,
                     dtype_of(cfg.compute_dtype))
    if cfg.arch_type == "hybrid":
        x = _hybrid_decode(cfg, params, cache, x, pos)
    elif cfg.arch_type == "ssm":
        x = _xlstm_decode(cfg, params, cache, x)
    elif cfg.arch_type == "audio":
        x = _whisper_decode(cfg, params, cache, x, pos)
    else:
        for i in range(cfg.num_layers):
            # JAX decode.py's site: a mesh rank's data-split blocks are
            # gathered here (ZeRO-3 serving)
            x, _ = _attn_block_decode(
                constrain_params(layer(params["blocks"], i), "blocks"), cfg,
                x, layer(cache, i), pos)
    x = rms_norm(x, constrain_params(params["final_norm"], "final_norm"),
                 cfg.norm_eps)
    return _logits(cfg, params, x), cache


def _logits(cfg: ModelConfig, params, x):
    """fp32 logits of the whole vocabulary (made whole over a model axis
    that splits it)."""
    return C.gather_vocab(unembed(output_table(cfg, params), x),
                          cfg.vocab_size)


def prefill(cfg: ModelConfig, params, batch, cache_len: int):
    """Run the prompt, return (logits, cache ready for ``decode_step``):
    the logits (B,S,V) fp32 of every position; for the hybrid and ssm,
    whose prefill replays the prompt through ``decode_step``, the last
    position's (B,1,V); for audio, which encodes ``batch["frame_embeds"]``
    once and fills the cross K/V (``cache_len`` is ignored: the cross
    cache holds the encoder's frames), ``None``."""
    check_family(cfg)
    if cfg.arch_type == "audio":
        return None, _whisper_prefill(cfg, params, batch)
    if cfg.arch_type in ("hybrid", "ssm"):
        tokens = batch["tokens"]
        cache, axes = init_cache(cfg, tokens.shape[0], cache_len,
                                 device=tokens.device)
        # on a rank of a serving mesh, the states and the shared block's
        # KV cache in the plan's layout (the rank's heads, ff columns, kv
        # heads or positions)
        cache = map_axes(
            lambda a, x: constrain_act(x, a, x.shape).contiguous(), axes,
            cache)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = decode_step(cfg, params, cache,
                                        tokens[:, t:t + 1], t)
        return logits, cache
    x = embed_tokens(cfg, _lookup_table(params, None), batch["tokens"],
                     dtype_of(cfg.compute_dtype))
    positions = C.seq_positions(x)
    slots = _effective_cache_len(cfg, cache_len)
    caches = []
    for i in range(cfg.num_layers):
        # JAX decode.py's ZeRO-3 site: a mesh rank's data-split blocks
        # are gathered here
        lp = constrain_params(layer(params["blocks"], i), "blocks")
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        # under seq_shard the rank's chunk gathered over the sequence:
        # its heads' K and V cover every position, which the cache takes
        hn = C.region_in(hn, "attn_in", split=False)
        q, k, v = A.qkv(lp["attn"], cfg, hn, positions, local_kv=False)
        o = A.attention(q, *A.heads_kv(q, k, v, cfg), causal=True,
                        window=cfg.swa_window)
        x = x + attn_proj(lp["attn"], cfg, o)
        ff, _ = _ff(lp, cfg, x)
        x = x + ff
        caches.append(A.prefill_into_cache(lp["attn"], cfg, k, v, slots))
    x = rms_norm(x, constrain_params(params["final_norm"], "final_norm"),
                 cfg.norm_eps)
    cache = A.KVCache(*(torch.stack(leaves) for leaves in zip(*caches)))
    # under seq_shard the whole sequence's logits, as ``forward``'s
    x = C.region_in(x, "logits_in", split=False)
    return _logits(cfg, params, x), cache


def _whisper_prefill(cfg: ModelConfig, params, batch):
    """Encode the frames once and fill every decoder layer's cross K/V;
    the self-attention cache starts empty.  On a rank of a serving mesh
    the cache is put into the plan's layout (:func:`~repro_torch.models.
    attention.kv_cache_axes`): the rank's kv heads, or its slice of the
    frames and the self cache's slots (``cache_seq_shard``); under
    ``seq_shard`` the encoder runs on the rank's chunk of the frames,
    gathered whole for the cross K/V."""
    enc = whisper_encode(cfg, params, batch)
    enc = C.region_in(enc, "enc_out", split=False)
    b, frames = enc.shape[:2]
    kv, hd = cfg.num_kv_heads, cfg.head_dim_
    ax = ("batch", "cache_seq", "kv_heads", None)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = constrain_params(layer(params["dec_blocks"], i), "dec_blocks")
        k, v = cross_kv(lp, enc)
        ks.append(constrain_act(k, ax, (b, frames, kv, hd)))
        vs.append(constrain_act(v, ax, (b, frames, kv, hd)))
    self_kv = _stacked_kv(cfg.num_layers, b, DECODER_LEN, cfg, enc.dtype,
                          enc.device)
    axes = _stacked_kv_axes()
    self_kv = A.KVCache(*(constrain_act(x, a, x.shape).contiguous()
                          for x, a in zip(self_kv, axes)))
    return {"self": self_kv, "cross_k": torch.stack(ks),
            "cross_v": torch.stack(vs)}
