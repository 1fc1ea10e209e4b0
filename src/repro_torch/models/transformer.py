"""The model stack for all six families (port of
``repro.models.transformer``).

* dense / moe / vlm — pre-norm decoder blocks (GQA attention + SwiGLU,
  or the sort-dispatched experts of :mod:`repro_torch.models.moe`) over
  a stacked parameter layer axis; the router aux loss is summed over the
  layers.  vlm (phi-3-vision) prepends its projected patch embeddings
  (``batch["patch_embeds"]``, the stubbed vision tower's output) to the
  tokens; ``forward`` and ``loss_fn`` crop that prefix.
* hybrid (zamba2) — stacked Mamba2 blocks (:mod:`repro_torch.models.ssm`)
  with one *shared-weight* attention block applied after every group of
  ``shared_attn_every`` layers; its gradient sums over its sites.
* ssm (xlstm) — alternating mLSTM/sLSTM pairs
  (:mod:`repro_torch.models.xlstm`); no attention.
* audio (whisper) — an encoder (non-causal self-attention, GELU MLPs)
  over stubbed frame embeddings plus sinusoidal positions, and a decoder
  (causal self-attention, cross-attention to the encoder, learned
  positions ``dec_pos``); no RoPE in either.

A Python loop over the layer axis replaces the JAX package's
``lax.scan``; ``constrain_params`` (a sharding annotation) has no
counterpart on one card.  With ``cfg.remat`` each block body is
rematerialised in the backward
(:func:`repro_torch.utils.remat.checkpoint`) at the JAX package's
boundaries: a dense/moe/vlm decoder block, each Mamba2 layer of a
hybrid group (not the shared attention block), an xlstm mLSTM/sLSTM
pair, and whisper's encoder and decoder blocks.  Every causal
self-attention runs the ``swa_attention`` kernel
(:func:`repro_torch.models.attention.attention`); non-causal attention
is plain (``attend`` or ``attend_blockwise``).

Public entry points: ``init`` / ``forward`` / ``loss_fn`` /
``whisper_encode``.  The loss runs the ``fused_ce`` kernel on the output
table; gradients flow through it and through ``swa_attention`` (both
are autograd Functions with a ``vmap`` rule, so the train step's
per-agent ``vmap(grad)`` keeps one launch per call).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_ce.ops import fused_ce_nll
from repro_torch.configs.whisper_medium import DECODER_LEN
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.layers import (
    build_embedding,
    build_gelu_mlp,
    build_rms_norm,
    build_swiglu,
    embed,
    gelu_mlp,
    rms_norm,
    sinusoidal_positions,
    swiglu,
    unembed,
)
from repro_torch.models.param import Scope, init_pair
from repro_torch.utils.remat import checkpoint
from repro_torch.utils.tree import tree_map

PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for an arch_type that is none of the six families."""
    if cfg.arch_type not in PORTED_FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def layer(stacked, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    return tree_map(lambda t: t[i], stacked)


# ======================================================================
# Blocks: parameters
# ======================================================================

def _build_attn_block(scope: Scope, cfg: ModelConfig, *,
                      cross: bool = False):
    build_rms_norm(scope, "ln_attn", cfg.d_model)
    A.build_attention(scope.sub("attn"), cfg)
    if cross:
        build_rms_norm(scope, "ln_cross", cfg.d_model)
        A.build_attention(scope.sub("cross"), cfg)


def _build_ff(scope: Scope, cfg: ModelConfig, *, gelu: bool = False):
    build_rms_norm(scope, "ln_ff", cfg.d_model)
    if cfg.moe is not None:
        MOE.build_moe(scope.sub("moe"), cfg)
    elif gelu:
        build_gelu_mlp(scope.sub("mlp"), cfg.d_model, cfg.d_ff)
    else:
        build_swiglu(scope.sub("mlp"), cfg.d_model, cfg.d_ff)


def _build_decoder_block(scope: Scope, cfg: ModelConfig):
    _build_attn_block(scope, cfg)
    _build_ff(scope, cfg)


def _attn_out(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def _self_attn(p, cfg, x, positions, *, causal=True, rope=True,
               window="cfg"):
    q, k, v = A.qkv(p["attn"], cfg, x, positions, rope=rope)
    win = cfg.swa_window if window == "cfg" else window
    o = A.attention(q, k, v, causal=causal, window=win,
                    q_block=cfg.attn_q_block)
    return _attn_out(p["attn"], o)


def _maybe_remat(cfg, fn):
    """Checkpoint a (params, carry…) block body when cfg.remat is set."""
    return checkpoint(fn) if cfg.remat else fn


def _ff(p, cfg, x, *, gelu: bool = False):
    """Returns (out, aux)."""
    h = rms_norm(x, p["ln_ff"], cfg.norm_eps)
    if cfg.moe is not None:
        return MOE.moe_layer(p["moe"], cfg, h)
    return (gelu_mlp(p["mlp"], h) if gelu else swiglu(p["mlp"], h)), 0.0


def _decoder_block(p, cfg, x, positions):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    x = x + _self_attn(p, cfg, h, positions)
    ff, aux = _ff(p, cfg, x)
    return x + ff, aux


# ======================================================================
# init
# ======================================================================

def init(cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
         abstract: bool = False, dtype: Optional[torch.dtype] = None):
    """Returns (params, logical_axes), drawn from ``gen`` onto its
    device.  The tree, names, shapes and init distributions are the
    JAX package's; the draws are not.  ``abstract=True`` allocates
    nothing: every leaf is an empty ``meta`` tensor of its shape and
    dtype (``gen`` is not read)."""
    check_family(cfg)
    dtype = dtype or dtype_of(cfg.param_dtype)

    def mamba_block(s: Scope):
        build_rms_norm(s, "ln", cfg.d_model)
        SSM.build_mamba2(s.sub("mamba"), cfg)

    def pair(s: Scope):
        build_rms_norm(s, "ln_m", cfg.d_model)
        XL.build_mlstm(s.sub("mlstm"), cfg)
        build_rms_norm(s, "ln_s", cfg.d_model)
        XL.build_slstm(s.sub("slstm"), cfg)

    def enc_block(s: Scope):
        _build_attn_block(s, cfg)
        _build_ff(s, cfg, gelu=True)

    def dec_block(s: Scope):
        _build_attn_block(s, cfg, cross=True)
        _build_ff(s, cfg, gelu=True)

    def build(sc: Scope):
        build_embedding(sc, cfg.vocab_size, cfg.d_model)
        if not cfg.tie_embeddings and not cfg.is_encoder_decoder:
            sc.param("out_embed", (cfg.vocab_size, cfg.d_model),
                     ("vocab", "embed"), scale=0.02)
        build_rms_norm(sc, "final_norm", cfg.d_model)
        if cfg.arch_type == "hybrid":
            sc.stacked("blocks", cfg.num_layers, mamba_block)
            shared = sc.sub("shared_attn")
            _build_attn_block(shared, cfg)
            _build_ff(shared, cfg)
        elif cfg.arch_type == "ssm":
            sc.stacked("pairs", cfg.num_layers // 2, pair)
        elif cfg.arch_type == "audio":
            sc.param("dec_pos", (DECODER_LEN, cfg.d_model), (None, "embed"),
                     scale=0.02)
            sc.stacked("enc_blocks", cfg.encoder_layers, enc_block)
            build_rms_norm(sc, "enc_norm", cfg.d_model)
            sc.stacked("dec_blocks", cfg.num_layers, dec_block)
        else:
            if cfg.arch_type == "vlm":
                proj = sc.sub("vision_proj")
                proj.param("w", (cfg.d_model, cfg.d_model),
                           ("embed", "embed"))
                proj.param("b", (cfg.d_model,), ("embed",), init="zeros")
            sc.stacked("blocks", cfg.num_layers,
                       lambda s: _build_decoder_block(s, cfg))

    return init_pair(gen, dtype, build, abstract)


# ======================================================================
# forward (train / prefill)
# ======================================================================

def positions_of(x: torch.Tensor) -> torch.Tensor:
    """(B, S) absolute positions 0 … S−1 of a (B, S, D) activation."""
    return torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])


def group_bounds(n_layers: int, every: int):
    """The hybrid's layer groups ``[(start, end), ...]``: the shared
    attention block runs after each."""
    out, s = [], 0
    while s < n_layers:
        out.append((s, min(s + every, n_layers)))
        s += every
    return out


def _shared_block(shared, cfg, x, positions):
    """The hybrid's shared attention block: causal over the whole
    sequence (no window), then its SwiGLU."""
    h = rms_norm(x, shared["ln_attn"], cfg.norm_eps)
    x = x + _self_attn(shared, cfg, h, positions, window=None)
    ff, _ = _ff(shared, cfg, x)
    return x + ff


def forward_hidden(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor,
                                                              float, int]:
    """Backbone only. Returns (final hidden (B,S,D), aux_loss, prefix_len):
    for vlm with ``patch_embeds`` the hidden states cover the patch
    prefix too, and ``prefix_len`` is its length."""
    check_family(cfg)
    if cfg.arch_type == "audio":
        return _whisper_hidden(cfg, params, batch) + (0,)
    dtype = dtype_of(cfg.compute_dtype)
    x = embed(params["embedding"], batch["tokens"], dtype)
    prefix = 0
    if cfg.arch_type == "vlm" and "patch_embeds" in batch:
        vp = params["vision_proj"]
        pe = (batch["patch_embeds"].to(dtype) @ vp["w"].to(dtype)
              + vp["b"].to(dtype))
        x = torch.cat([pe, x], dim=1)
        prefix = pe.shape[1]
    positions = positions_of(x)
    aux = 0.0
    if cfg.arch_type == "hybrid":
        mamba = _maybe_remat(cfg, lambda lp, h: h + SSM.mamba2_forward(
            lp["mamba"], cfg, rms_norm(h, lp["ln"], cfg.norm_eps)))
        for s, e in group_bounds(cfg.num_layers, cfg.shared_attn_every):
            for i in range(s, e):
                x = mamba(layer(params["blocks"], i), x)
            x = _shared_block(params["shared_attn"], cfg, x, positions)
    elif cfg.arch_type == "ssm":
        def pair(lp, h):
            h = h + XL.mlstm_forward(lp["mlstm"], cfg,
                                     rms_norm(h, lp["ln_m"], cfg.norm_eps))
            h = h + XL.slstm_forward(lp["slstm"], cfg,
                                     rms_norm(h, lp["ln_s"], cfg.norm_eps))
            return h + XL.slstm_block_mlp(lp["slstm"], cfg, h)

        pair = _maybe_remat(cfg, pair)
        for i in range(cfg.num_layers // 2):
            x = pair(layer(params["pairs"], i), x)
    else:
        block = _maybe_remat(
            cfg, lambda lp, h, pos: _decoder_block(lp, cfg, h, pos))
        for i in range(cfg.num_layers):
            x, al = block(layer(params["blocks"], i), x, positions)
            aux = aux + al
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, prefix


def output_table(cfg: ModelConfig, params):
    if cfg.tie_embeddings or cfg.is_encoder_decoder:
        return params["embedding"]
    return params["out_embed"]


def forward(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, float]:
    """Returns (logits over token positions, aux_loss)."""
    x, aux, prefix = forward_hidden(cfg, params, batch)
    logits = unembed(output_table(cfg, params), x)
    if prefix:
        logits = logits[:, prefix:]
    return logits, aux


# ======================================================================
# whisper
# ======================================================================

def cross_kv(lp, enc: torch.Tensor, enc_v: Optional[torch.Tensor] = None):
    """A decoder layer's cross-attention keys and values (B, S_enc, KV,
    hd) from the encoder output (the values from ``enc_v`` when given:
    the same tensor, as a separate input of a checkpointed block)."""
    enc_v = enc if enc_v is None else enc_v
    k = torch.einsum("bsd,dhk->bshk", enc, lp["cross"]["wk"].to(enc.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_v,
                     lp["cross"]["wv"].to(enc_v.dtype))
    return k, v


def whisper_encode(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """The encoder over the (stubbed) frame embeddings -> (B, S_enc, D):
    sinusoidal positions, non-causal self-attention without RoPE."""
    dtype = dtype_of(cfg.compute_dtype)
    frames = batch["frame_embeds"].to(dtype)
    enc = frames + sinusoidal_positions(frames.shape[1], cfg.d_model, dtype,
                                        frames.device)[None]
    pos_e = positions_of(enc)

    def enc_block(lp, h, pos):
        hn = rms_norm(h, lp["ln_attn"], cfg.norm_eps)
        h = h + _self_attn(lp, cfg, hn, pos, causal=False, rope=False)
        ff, _ = _ff(lp, cfg, h, gelu=True)
        return h + ff

    enc_block = _maybe_remat(cfg, enc_block)
    for i in range(cfg.encoder_layers):
        enc = enc_block(layer(params["enc_blocks"], i), enc, pos_e)
    return rms_norm(enc, params["enc_norm"], cfg.norm_eps)


def _whisper_hidden(cfg, params, batch):
    dtype = dtype_of(cfg.compute_dtype)
    enc = whisper_encode(cfg, params, batch)
    tokens = batch["tokens"]
    x = embed(params["embedding"], tokens, dtype)
    x = x + params["dec_pos"][:tokens.shape[1]].to(dtype)[None]
    pos_d = positions_of(x)

    # the encoder output comes into a decoder block twice, for the values
    # and then the keys: a checkpointed block then hands its two
    # gradient terms to autograd in the order the plain graph adds them
    # (the values' first), so the encoder's gradient is bitwise the
    # plain path's
    def dec_block(lp, h, enc_v, enc_k, pos):
        hn = rms_norm(h, lp["ln_attn"], cfg.norm_eps)
        h = h + _self_attn(lp, cfg, hn, pos, causal=True, rope=False)
        hn = rms_norm(h, lp["ln_cross"], cfg.norm_eps)
        q, _, _ = A.qkv(lp["cross"], cfg, hn, pos, rope=False)
        k, v = cross_kv(lp, enc_k, enc_v)
        o = A.attention(q, k, v, causal=False, window=None,
                        q_block=cfg.attn_q_block)
        h = h + _attn_out(lp["cross"], o)
        ff, _ = _ff(lp, cfg, h, gelu=True)
        return h + ff

    dec_block = _maybe_remat(cfg, dec_block)
    for i in range(cfg.num_layers):
        x = dec_block(layer(params["dec_blocks"], i), x, enc, enc, pos_d)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, 0.0


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Mean token CE over the batch's ``loss_mask`` (all tokens without
    one), from the ``fused_ce`` kernel's per-token NLL on the output
    table: the full (B, S, V) logits never exist.  A vlm's patch prefix
    is cropped first.  A moe model adds ``router_aux_weight`` × the
    router load-balance loss."""
    x, aux, prefix = forward_hidden(cfg, params, batch)
    if prefix:
        x = x[:, prefix:]
    table = output_table(cfg, params)
    if x.dtype != table.dtype:
        # the kernel takes one dtype; widening is exact (the JAX loss
        # computes its logits in fp32 either way)
        x, table = x.float(), table.float()
    nll = fused_ce_nll(x.reshape(-1, x.shape[-1]), table,
                       batch["labels"].reshape(-1))
    mask = batch.get("loss_mask")
    if mask is None:
        ce = nll.mean()
    else:
        mask = mask.reshape(-1).float()
        ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    if cfg.moe is not None:
        ce = ce + cfg.moe.router_aux_weight * aux
    return ce
