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
``lax.scan``.  ``constrain_params`` (:mod:`repro_torch.sharding.
constraint`) runs where the JAX package calls it (each layer slice,
inside the remat boundary; the output table) and, because the port has
no partitioner to move the rest, on every other leaf the model reads
(the embedding lookup, ``final_norm``, vlm's ``vision_proj``, zamba2's
``shared_attn``, whisper's ``dec_pos`` and ``enc_norm``): with no hook
installed it is a no-op.  On a (data, model) mesh the hook hands each
site this rank's model block of the weights, and every family's layers
run tensor-parallel by those blocks' shapes (zamba2's Mamba2 layers and
xlstm's mLSTM on the rank's heads, the sLSTM's recurrence whole on every
rank: :mod:`repro_torch.models.ssm`, :mod:`repro_torch.models.xlstm`):
attention column-parallel over the heads and row-parallel out (whisper's
cross-attention too, over the encoder output made ready once a
forward: :func:`decoder_memory`), the SwiGLU and the GELU MLP over their
``ff`` columns (the GELU's ``b_out`` added once, after the sum), the
experts over the expert axis or their ``ff``
(:mod:`repro_torch.models.moe`), the embedding and the loss over the
vocabulary (:mod:`repro_torch.sharding.collectives`).  Under
``seq_shard`` whisper's encoder runs on each rank's chunk of the
frames, and phi-3-vision's chunks are of the patch prefix and the
tokens together (:func:`_prefixed`).  With ``cfg.remat`` each block body is
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

from typing import Callable, Optional, Tuple

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
from repro_torch.sharding import collectives as C
from repro_torch.sharding.constraint import constrain_params
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


def attn_proj(p, cfg, o, tag: str = "attn_out"):
    """The output projection of the heads ``o`` (B,S,H,hd): over a model
    axis that splits the heads it is row-parallel, this rank's heads'
    share summed over the ranks (under ``seq_shard`` reduce-scattered to
    the rank's chunk; where the heads are whole there, the chunk)."""
    return C.region_out(_attn_out(p, o), tag,
                        split=p["wo"].shape[0] != cfg.num_heads)


def _self_attn(p, cfg, x, positions, *, causal=True, rope=True,
               window="cfg"):
    # under seq_shard the chunk gathered over the sequence; the heads'
    # split is qkv's (``positions`` are the whole sequence's)
    x = C.region_in(x, "attn_in", split=False)
    q, k, v = A.qkv(p["attn"], cfg, x, positions, rope=rope)
    win = cfg.swa_window if window == "cfg" else window
    o = A.attention(q, k, v, causal=causal, window=win,
                    q_block=cfg.attn_q_block)
    return attn_proj(p["attn"], cfg, o)


def _maybe_remat(cfg, fn):
    """Checkpoint a (params, carry…) block body when cfg.remat is set."""
    return checkpoint(fn) if cfg.remat else fn


def _ff(p, cfg, x, *, gelu: bool = False):
    """Returns (out, aux)."""
    h = rms_norm(x, p["ln_ff"], cfg.norm_eps)
    if cfg.moe is not None:
        return MOE.moe_layer(p["moe"], cfg, h)
    if gelu:
        if C.shard_offset(p["mlp"]["w_in"].shape[1], cfg.d_ff,
                          "gelu mlp") is None:
            return gelu_mlp(p["mlp"], h), 0.0
        # column-parallel w_in/b_in, row-parallel w_out; b_out added once,
        # after the sum
        out = gelu_mlp(p["mlp"], C.region_in(h, "mlp_in"), out_bias=False)
        return C.region_out(out, "mlp_out") + p["mlp"]["b_out"], 0.0
    if C.shard_offset(p["mlp"]["w_gate"].shape[1], cfg.d_ff,
                      "swiglu") is None:
        return swiglu(p["mlp"], h), 0.0
    # column-parallel gate/up, row-parallel down
    out = swiglu(p["mlp"], C.region_in(h, "mlp_in"))
    return C.region_out(out, "mlp_out"), 0.0


def _decoder_block(p, cfg, x, positions):
    """A decoder block.  Under ``seq_shard`` (Megatron's sequence
    parallelism) ``x`` is this rank's chunk of the sequence: the norms
    and the residual stream stay on the chunk, and the attention and a
    split MLP gather it at their entry and reduce-scatter their output
    back to it (:func:`~repro_torch.sharding.collectives.region_in`)."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    x = x + _self_attn(p, cfg, h, positions)
    ff, aux = _ff(p, cfg, x)
    return x + ff, aux


# ======================================================================
# init
# ======================================================================

def init(cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
         abstract: bool = False, dtype: Optional[torch.dtype] = None,
         place: Optional[Callable] = None):
    """Returns (params, logical_axes), drawn from ``gen`` onto its
    device.  The tree, names, shapes and init distributions are the
    JAX package's; the draws are not.  ``abstract=True`` allocates
    nothing: every leaf is an empty ``meta`` tensor of its shape and
    dtype (``gen`` is not read).  ``place(path, leaf)`` maps each leaf
    as it is drawn (:class:`~repro_torch.models.param.Scope`: a mesh
    rank's blocks)."""
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

    return init_pair(gen, dtype, build, abstract, place)


# ======================================================================
# forward (train / prefill)
# ======================================================================

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


def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The embedding lookup; over a vocabulary split over the model
    axis, each rank looks up the tokens its block holds (zeros for the
    rest) and the ranks sum (one term is not zero: exact)."""
    v0 = C.shard_offset(table.shape[0], cfg.vocab_size, "embedding")
    if v0 is None:
        return embed(table, tokens, dtype)
    # under seq_shard every rank looks up the whole sequence in its
    # block, and the sum is reduce-scattered to the chunks
    tokens = C.gather_ids(tokens, "sp_tokens")
    rel = tokens.long() - v0
    inside = (rel >= 0) & (rel < table.shape[0])
    rows = embed(table, torch.where(inside, rel, torch.zeros_like(rel)),
                 dtype)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return C.region_out(rows, "embed")


def _lookup_table(params, table):
    """The embedding table for the lookup: ``table`` where the caller
    holds it already (the tied output table: one constrained use, so a
    mesh step gathers its gradient once), else a site of its own, which
    the JAX package leaves to XLA."""
    if table is not None:
        return table
    return constrain_params(params["embedding"], "embedding")


def forward_hidden(cfg: ModelConfig, params, batch, table=None
                   ) -> Tuple[torch.Tensor, float, int]:
    """Backbone only. Returns (final hidden (B,S,D), aux_loss, prefix_len):
    for vlm with ``patch_embeds`` the hidden states cover the patch
    prefix too, and ``prefix_len`` is its length.  ``table`` is the
    tied embedding as the caller constrained it (None: the lookup
    constrains its own)."""
    check_family(cfg)
    if cfg.arch_type == "audio":
        return _whisper_hidden(cfg, params, batch, table) + (0,)
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_tokens(cfg, _lookup_table(params, table), batch["tokens"],
                     dtype)
    prefix = 0
    if cfg.arch_type == "vlm" and "patch_embeds" in batch:
        # a site the JAX package leaves to XLA: the patch projection,
        # which every model rank computes whole
        vp = constrain_params(params["vision_proj"], "vision_proj")
        pe = (batch["patch_embeds"].to(dtype) @ vp["w"].to(dtype)
              + vp["b"].to(dtype))
        prefix = pe.shape[1]
        x = _prefixed(pe, x)
    positions = C.seq_positions(x)
    aux = 0.0
    if cfg.arch_type == "hybrid":
        def mamba_block(lp, h):
            lp = constrain_params(lp, "blocks")
            return h + SSM.mamba2_forward(
                lp["mamba"], cfg, rms_norm(h, lp["ln"], cfg.norm_eps))

        mamba = _maybe_remat(cfg, mamba_block)
        for s, e in group_bounds(cfg.num_layers, cfg.shared_attn_every):
            for i in range(s, e):
                x = mamba(layer(params["blocks"], i), x)
            # a site the JAX package leaves to XLA: the shared block
            x = _shared_block(constrain_params(params["shared_attn"],
                                               "shared_attn"),
                              cfg, x, positions)
    elif cfg.arch_type == "ssm":
        def pair(lp, h):
            lp = constrain_params(lp, "pairs")
            h = h + XL.mlstm_forward(lp["mlstm"], cfg,
                                     rms_norm(h, lp["ln_m"], cfg.norm_eps))
            h = h + XL.slstm_forward(lp["slstm"], cfg,
                                     rms_norm(h, lp["ln_s"], cfg.norm_eps))
            return h + XL.slstm_block_mlp(lp["slstm"], cfg, h)

        pair = _maybe_remat(cfg, pair)
        for i in range(cfg.num_layers // 2):
            x = pair(layer(params["pairs"], i), x)
    else:
        # the constraint INSIDE the remat boundary: the recompute in the
        # backward takes its blocks of the weights again
        block = _maybe_remat(
            cfg, lambda lp, h, pos: _decoder_block(
                constrain_params(lp, "blocks"), cfg, h, pos))
        for i in range(cfg.num_layers):
            x, al = block(layer(params["blocks"], i), x, positions)
            aux = aux + al
    x = rms_norm(x, constrain_params(params["final_norm"], "final_norm"),
                 cfg.norm_eps)  # a site the JAX package leaves to XLA
    return x, aux, prefix


def _prefixed(pe: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The patch prefix ``pe`` (B, P, D) before the token embeddings
    ``x``.  Under ``seq_shard`` the chunked sequence is the concatenated
    P + S one: ``x`` (this rank's chunk of the S tokens) is gathered
    whole, the prefix put before it, and the rank keeps its chunk of the
    P + S positions (so every rank's residual stream has (P + S) / n of
    them, and the positions run over the whole P + S sequence, as in the
    unsharded model); the loss crops the prefix from the whole hidden
    and cuts the rank's chunk of the S tokens again
    (:func:`_crop_prefix`), the chunk its labels are.  The prefix's
    gradient is each rank's chunk's share, summed over "model" by the
    gather hook (``vision_proj`` is whole on every rank)."""
    if C.tokens_split() != "seq":
        return torch.cat([pe, x], dim=1)
    # the model axis divides P + S: else the step chunks no sequence
    # (launch/steps.py ``_tokens_split``)
    whole = torch.cat([pe, C.gather_seq(x, "sp_prefix_in")], dim=1)
    return C.seq_chunk(whole)


def _crop_prefix(x: torch.Tensor, prefix: int) -> torch.Tensor:
    """The hidden states of the tokens: the patch prefix cropped (under
    ``seq_shard``, from the whole P + S sequence gathered over "model",
    then cut to this rank's chunk of the tokens)."""
    if C.tokens_split() != "seq":
        return x[:, prefix:]
    return C.seq_chunk(C.gather_seq(x, "sp_prefix_out")[:, prefix:])


def output_table(cfg: ModelConfig, params):
    if cfg.tie_embeddings or cfg.is_encoder_decoder:
        return constrain_params(params["embedding"], "embedding")
    return constrain_params(params["out_embed"], "out_embed")


def forward(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, float]:
    """Returns (logits over token positions, aux_loss); over a model axis
    that splits the vocabulary, the whole vocabulary's on every rank."""
    x, aux, prefix = forward_hidden(cfg, params, batch)
    x = C.region_in(x, "logits_in", split=False)
    logits = C.gather_vocab(unembed(output_table(cfg, params), x),
                            cfg.vocab_size)
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
    sinusoidal positions, non-causal self-attention without RoPE.  Under
    ``seq_shard`` the frames are this rank's chunk (their positions the
    chunk's rows of the whole table), and so is the output."""
    dtype = dtype_of(cfg.compute_dtype)
    frames = batch["frame_embeds"].to(dtype)
    pos_e = C.seq_positions(frames)
    table = sinusoidal_positions(pos_e.shape[1], cfg.d_model, dtype,
                                 frames.device)
    if pos_e.shape[1] != frames.shape[1]:
        table = C.seq_chunk(table, 0)
    enc = frames + table[None]

    def enc_block(lp, h, pos):
        lp = constrain_params(lp, "enc_blocks")
        hn = rms_norm(h, lp["ln_attn"], cfg.norm_eps)
        h = h + _self_attn(lp, cfg, hn, pos, causal=False, rope=False)
        ff, _ = _ff(lp, cfg, h, gelu=True)
        return h + ff

    enc_block = _maybe_remat(cfg, enc_block)
    for i in range(cfg.encoder_layers):
        enc = enc_block(layer(params["enc_blocks"], i), enc, pos_e)
    return rms_norm(enc, constrain_params(params["enc_norm"], "enc_norm"),
                    cfg.norm_eps)  # a site the JAX package leaves to XLA


def decoder_memory(cfg: ModelConfig, enc: torch.Tensor,
                   kv_heads: int) -> torch.Tensor:
    """The encoder output as every decoder layer's cross-attention reads
    it, made ready once per forward (not once per layer): under
    ``seq_shard`` this rank's chunk gathered whole over "model" (its
    backward sums the ranks' cotangents and keeps the chunk); under
    tensor parallelism over split cross-attention kv heads, ``enc`` with
    its cotangent (each rank's heads' share) summed over "model"; else
    ``enc``.  ``kv_heads``, the cross-attention's kv heads that this rank
    count here (a model block of them, or all) tells the layout."""
    if C.tokens_split() == "seq":
        return C.gather_seq(enc, "sp_enc_out")
    if C.shard_offset(kv_heads, cfg.num_kv_heads,
                      "cross kv heads") is None:
        return enc
    return C.copy_to_model(enc, "tp_enc_out")


def cross_attn(lp, cfg, hn, enc_v, enc_k, pos):
    """A decoder layer's cross-attention of the normed ``hn`` (this
    rank's chunk under ``seq_shard``, gathered over the sequence first)
    to the encoder output (:func:`decoder_memory`'s, as keys ``enc_k``
    and values ``enc_v``): the rank's heads, the output projection
    row-parallel (tag ``cross_out``)."""
    hn = C.region_in(hn, "cross_in", split=False)
    q, _, _ = A.qkv(lp["cross"], cfg, hn, pos, rope=False, local_kv=False)
    k, v = cross_kv(lp, enc_k, enc_v)
    o = A.attention(q, *A.heads_kv(q, k, v, cfg), causal=False, window=None,
                    q_block=cfg.attn_q_block)
    return attn_proj(lp["cross"], cfg, o, "cross_out")


def _whisper_hidden(cfg, params, batch, table=None):
    dtype = dtype_of(cfg.compute_dtype)
    enc = whisper_encode(cfg, params, batch)
    tokens = batch["tokens"]
    # a site the JAX package leaves to XLA: dec_pos
    x = embed_tokens(cfg, _lookup_table(params, table), tokens, dtype)
    pos_d = C.seq_positions(x)
    dec_pos = constrain_params(params["dec_pos"], "dec_pos")[
        :pos_d.shape[1]]
    if pos_d.shape[1] != x.shape[1]:
        dec_pos = C.seq_chunk(dec_pos, 0)
    x = x + dec_pos.to(dtype)[None]
    # the stacked weights at rest: their kv dim is the model block
    enc = decoder_memory(cfg, enc,
                         params["dec_blocks"]["cross"]["wk"].shape[2])

    # the encoder output comes into a decoder block twice, for the values
    # and then the keys: a checkpointed block then hands its two
    # gradient terms to autograd in the order the plain graph adds them
    # (the values' first), so the encoder's gradient is bitwise the
    # plain path's
    def dec_block(lp, h, enc_v, enc_k, pos):
        lp = constrain_params(lp, "dec_blocks")
        hn = rms_norm(h, lp["ln_attn"], cfg.norm_eps)
        h = h + _self_attn(lp, cfg, hn, pos, causal=True, rope=False)
        hn = rms_norm(h, lp["ln_cross"], cfg.norm_eps)
        h = h + cross_attn(lp, cfg, hn, enc_v, enc_k, pos)
        ff, _ = _ff(lp, cfg, h, gelu=True)
        return h + ff

    dec_block = _maybe_remat(cfg, dec_block)
    for i in range(cfg.num_layers):
        x = dec_block(layer(params["dec_blocks"], i), x, enc, enc, pos_d)
    x = rms_norm(x, constrain_params(params["final_norm"], "final_norm"),
                 cfg.norm_eps)  # a site the JAX package leaves to XLA
    return x, 0.0


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Mean token CE over the batch's ``loss_mask`` (all tokens without
    one), from the ``fused_ce`` kernel's per-token NLL on the output
    table: the full (B, S, V) logits never exist.  A vlm's patch prefix
    is cropped first.  A moe model adds ``router_aux_weight`` × the
    router load-balance loss."""
    table = output_table(cfg, params)
    tied = cfg.tie_embeddings or cfg.is_encoder_decoder
    x, aux, prefix = forward_hidden(cfg, params, batch,
                                    table if tied else None)
    if prefix:
        x = _crop_prefix(x, prefix)
    if x.dtype != table.dtype:
        # the kernel takes one dtype; widening is exact (the JAX loss
        # computes its logits in fp32 either way)
        x, table = x.float(), table.float()
    labels, mask = batch["labels"], batch.get("loss_mask")
    split = C.tokens_split()
    vocab_split = table.shape[0] != cfg.vocab_size
    if vocab_split:
        # under seq_shard the chunk's hidden gathered over the sequence
        # (its backward sums the vocabulary blocks' shares); the table
        # stays split
        x = C.region_in(x, "loss_in", split=False)
        labels = C.gather_ids(labels, "sp_labels")
        if mask is not None:
            mask = C.gather_ids(mask, "sp_labels")
    x2, labels = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    if not vocab_split:
        nll = fused_ce_nll(x2, table, labels)
    else:
        nll = C.vocab_parallel_nll(x2, table, labels, cfg.vocab_size)
    if split is not None and not vocab_split:
        # this rank's tokens' NLL: the sums over the model ranks
        if mask is None:
            ce = C.reduce_from_model(nll.sum(), "loss_sum") / (
                nll.numel() * C.model_size())
        else:
            mask = mask.reshape(-1).float()
            ce = C.reduce_from_model((nll * mask).sum(), "loss_sum") / (
                C.reduce_from_model(mask.sum(), "loss_sum").clamp(min=1.0))
    elif mask is None:
        ce = nll.mean()
    else:
        mask = mask.reshape(-1).float()
        ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    if cfg.moe is not None:
        ce = ce + cfg.moe.router_aux_weight * aux
    return ce
