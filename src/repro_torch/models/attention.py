"""Attention: GQA with RoPE, optional QK-norm and sliding windows (port of
``repro.models.attention``).

Paths:

* ``attention(causal=True)`` — causal self-attention, with or without a
  sliding window, goes through the hand-written ``swa_attention`` kernel
  (:mod:`repro_torch.kernels.swa_attention`), any S.  In the JAX package
  the model computes it with ``attend``/``attend_blockwise`` and the
  Pallas kernel is that math's drop-in; the port wires the kernel in.
* ``attend`` — direct masked attention, for ``causal=False``
  (the whisper encoder, cross-attention); not on the dense serving path.
* ``attend_blockwise`` — the same math over blocks of ``q_block``
  queries, each attending the full prefix (or its window), so one
  block's score tile (B, H, q_block, Sk) is live at a time in the
  forward; ``causal=False`` calls take it as the JAX package's
  ``attention`` does (``q_block`` set and S > q_block, or S >
  ``BLOCKWISE_THRESHOLD``).  Each block is rematerialised in the
  backward (:func:`repro_torch.utils.remat.checkpoint`, as the JAX
  package's ``jax.checkpoint``), so no block's tile is kept for it
  either.
* ``decode_attend`` — one new token against a KV cache (ring buffer for
  sliding windows), plain torch as in the JAX package.

Layout convention: activations (B, S, D); q (B, S, H, hd); k/v
(B, S, KV, hd); caches (B, C, KV, hd).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.sharding import collectives as C
from repro_torch.sharding.constraint import cache_positions, constrain_act
from repro_torch.utils.remat import checkpoint

BLOCKWISE_THRESHOLD = 8192
Q_BLOCK = 1024

NEG_INF = -1e30


def build_attention(scope, cfg):
    hd = cfg.head_dim_
    scope.param("wq", (cfg.d_model, cfg.num_heads, hd),
                ("embed", "heads", None))
    scope.param("wk", (cfg.d_model, cfg.num_kv_heads, hd),
                ("embed", "kv_heads", None))
    scope.param("wv", (cfg.d_model, cfg.num_kv_heads, hd),
                ("embed", "kv_heads", None))
    scope.param("wo", (cfg.num_heads, hd, cfg.d_model),
                ("heads", None, "embed"))
    if cfg.qk_norm:
        scope.param("q_norm", (hd,), (None,), init="ones")
        scope.param("k_norm", (hd,), (None,), init="ones")


def qkv(p, cfg, x, positions, *, rope: bool = True, local_kv: bool = True):
    """q (B,S,H,hd), k/v (B,S,KV,hd) of the normed activations x.

    Over a model axis (weights that are this rank's block of the heads,
    :mod:`repro_torch.sharding.collectives`), q, k and v are
    column-parallel: this rank's query heads and the kv heads they read,
    x's gradient summed over the ranks.  Where the kv heads are whole
    here (the divisibility guard replicated them) and the query heads
    split, every rank projects all kv heads, their gradient is summed
    over the ranks (each rank's query heads see a part of it), and the
    rank keeps the kv groups of its own query heads (``local_kv=False``
    keeps every kv head: what a cache stores, :func:`heads_kv` then
    gives the attention its groups)."""
    h0 = C.shard_offset(p["wq"].shape[1], cfg.num_heads, "attention heads")
    k0 = C.shard_offset(p["wk"].shape[1], cfg.num_kv_heads,
                        "attention kv heads")
    xq = x if h0 is None else C.copy_to_model(x, "tp_attn_in")
    xkv = x if k0 is None else xq
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        # a whole norm weight on split heads: its gradient is summed
        qn = p["q_norm"] if h0 is None else C.copy_to_model(p["q_norm"])
        kn = p["k_norm"] if k0 is None else C.copy_to_model(p["k_norm"])
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if local_kv:
        k, v = heads_kv(q, k, v, cfg)
    return q, k, v


def heads_kv(q, k, v, cfg):
    """The kv heads that the query heads ``q`` read: ``k``/``v`` as they
    are, or where every kv head is here and the query heads are this
    rank's block, the rank's kv groups (their gradient summed over the
    model axis)."""
    h0 = C.shard_offset(q.shape[2], cfg.num_heads, "attention heads")
    if h0 is None or k.shape[2] != cfg.num_kv_heads:
        return k, v
    return (_local_kv(C.copy_to_model(k, "tp_kv"), h0, q.shape[2], cfg),
            _local_kv(C.copy_to_model(v, "tp_kv"), h0, q.shape[2], cfg))


def _local_kv(k: torch.Tensor, h0: int, heads: int, cfg) -> torch.Tensor:
    """The kv heads that query heads ``h0 … h0 + heads − 1`` read (query
    head h reads kv head h // (H / KV)), in the kernel's GQA layout: the
    rank's kv groups as a slice when its heads cover whole groups or lie
    in one; else each query head's kv head (no config of the repository
    splits a group across ranks that way)."""
    rep = cfg.num_heads // cfg.num_kv_heads
    g0, g1 = h0 // rep, (h0 + heads - 1) // rep + 1
    if (h0 % rep == 0 and heads % rep == 0) or rep % heads == 0:
        return k[:, :, g0:g1]
    idx = torch.div(torch.arange(h0, h0 + heads, device=k.device), rep,
                    rounding_mode="floor")
    return k.index_select(2, idx)


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """GQA: (B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head."""
    b, s, kv, hd = k.shape
    rep = num_heads // kv
    return k[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(
        b, s, num_heads, hd)


def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(Q, K) additive mask from absolute positions."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                    device=q_pos.device)
    if causal:
        m = m.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    if window is not None:
        m = m.masked_fill(k_pos[None, :] <= q_pos[:, None] - window, NEG_INF)
    return m


def attend(q, k, v, *, causal=True, window=None, q_offset=0):
    """Direct attention. q (B,Sq,H,hd); k/v (B,Sk,KV,hd)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float()
    scores = scores / math.sqrt(hd)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    scores = scores + _mask(q_pos, k_pos, causal, window)[None, None]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", w, v)


def attend_blockwise(q, k, v, *, causal=True, window=None,
                     q_block: int = Q_BLOCK):
    """Same math as ``attend``, over blocks of ``q_block`` queries: each
    block attends the full prefix (or its sliding window), so its score
    tile is (B, H, q_block, Sk), not (B, H, Sq, Sk), and the block is
    checkpointed: the backward recomputes its softmax instead of keeping
    every block's tile.  ``q_block`` falls back to Sq when it does not
    divide Sq, as in the JAX package."""
    b, sq, h, hd = q.shape
    if sq % q_block:
        q_block = sq  # fall back for ragged sizes
    k_, v_ = _expand_kv(k, h), _expand_kv(v, h)

    @checkpoint
    def block(q0, qi, k_, v_):
        q_pos = q0 + torch.arange(q_block, device=qi.device)
        k_pos = torch.arange(k_.shape[1], device=qi.device)
        scores = torch.einsum("bqhk,bshk->bhqs", qi, k_).float()
        scores = scores / math.sqrt(hd)
        scores = scores + _mask(q_pos, k_pos, causal, window)[None, None]
        w = torch.softmax(scores, dim=-1).to(qi.dtype)
        return torch.einsum("bhqs,bshk->bqhk", w, v_)

    outs = [block(q0, q[:, q0:q0 + q_block], k_, v_)
            for q0 in range(0, sq, q_block)]
    return torch.cat(outs, dim=1)


def attention(q, k, v, *, causal=True, window=None, q_block=None):
    """Attention as the JAX package dispatches it.  Causal: the
    ``swa_attention`` kernel, whose window ``None`` means plain causal
    (window = S); the kernel never forms the score tile that ``q_block``
    bounds, so it reads none.  Non-causal (an encoder, cross-attention):
    ``attend_blockwise`` when ``q_block`` is set and S > q_block, or S >
    ``BLOCKWISE_THRESHOLD``; else ``attend``."""
    if causal:
        return swa_ops.swa_attention(q, k, v, window=window or q.shape[1])
    s = q.shape[1]
    if q_block is not None and s > q_block:
        return attend_blockwise(q, k, v, causal=False, window=window,
                                q_block=q_block)
    if s > BLOCKWISE_THRESHOLD:
        return attend_blockwise(q, k, v, causal=False, window=window)
    return attend(q, k, v, causal=False, window=window)


# ----------------------------------------------------------------------
# Decode path (KV cache)
# ----------------------------------------------------------------------

class KVCache(NamedTuple):
    """Per-layer cache. ``k``/``v``: (B, C, KV, hd) where C = cache_len
    (= window size for SWA ring buffers). ``pos_ids``: (C,) absolute
    position stored in each slot, −1 when empty (rope is pre-applied to
    cached keys, so slots need no rotation at read time)."""

    k: torch.Tensor
    v: torch.Tensor
    pos_ids: torch.Tensor


def init_kv_cache(batch: int, cache_len: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device) -> KVCache:
    shape = (batch, cache_len, kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos_ids=torch.full((cache_len,), -1, dtype=torch.int32,
                                      device=device))


def abstract_kv_cache(batch: int, cache_len: int, kv_heads: int,
                      head_dim: int, dtype: torch.dtype) -> KVCache:
    """The cache's shapes and dtypes as empty ``meta`` tensors (the
    dry-run's stand-in): nothing allocated."""
    shape = (batch, cache_len, kv_heads, head_dim)
    return KVCache(k=torch.empty(shape, dtype=dtype, device="meta"),
                   v=torch.empty(shape, dtype=dtype, device="meta"),
                   pos_ids=torch.empty((cache_len,), dtype=torch.int32,
                                       device="meta"))


def kv_cache_axes() -> KVCache:
    """The logical axes of a layer's cache (its tree for
    :func:`repro_torch.sharding.rules.tree_shardings`)."""
    kv = ("batch", "cache_seq", "kv_heads", None)
    return KVCache(k=kv, v=kv, pos_ids=("cache_seq",))


def decode_attend(p, cfg, x, cache: KVCache, pos):
    """One-token attention against the cache.

    x: (B, 1, D); pos: the new token's absolute position, an int or a
    0-d integer tensor on x's device (the serve step's input, as the
    JAX package's traced ``pos``).  Returns (out (B,1,H,hd), cache).
    Unlike the JAX package, which returns a new cache, the new key,
    value and position are written into ``cache``'s tensors in place
    (one slot each): the returned cache is the argument, and no copy of
    the whole cache is made per token.  A tensor ``pos`` is never read
    on the host: its slot is computed and written on the device
    (``index_copy_``), so the step traces on ``meta`` and writes the
    same values as an int ``pos``.

    On a rank of a serving mesh (:mod:`repro_torch.sharding.constraint`'s
    activation hook) the cache is the rank's block and its layout decides
    the attention's, as JAX pins it (``qg``, ``k``, ``v`` to
    ``("batch", None, "decode_heads", …)`` and ``("batch", "cache_seq",
    "decode_heads", None)``):

    * the cache holds the rank's kv heads (or every kv head, where the
      model axis does not divide them), and the rank attends with its
      own query heads: no collective;
    * the cache holds the rank's slice of the positions (flash-decoding,
      ``cache_seq_shard``): q, k_new and v_new are made whole over
      "model", the new slot is written only by the rank that owns it,
      each rank attends over its positions with every head, the partial
      softmax statistics (max, then the sum beside the weighted values)
      are combined over "model", and the rank keeps its heads for the
      row-parallel output projection (``out`` holds them).
    """
    b = x.shape[0]
    c_loc, kv_loc = cache.k.shape[1], cache.k.shape[2]
    c0, slots = cache_positions(c_loc)
    split = c_loc != slots
    traced = torch.is_tensor(pos)
    positions = (pos.to(torch.int64).expand(b, 1) if traced else
                 torch.full((b, 1), pos, dtype=torch.int64, device=x.device))
    q, k_new, v_new = qkv(p, cfg, x, positions, rope=True, local_kv=False)
    h, kv_heads, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if split:
        q = constrain_act(q, ("batch", None, None, None), (b, 1, h, hd))
    kv_ax = ("batch", None, "kv_heads" if kv_loc != kv_heads else None, None)
    k_new = constrain_act(k_new, kv_ax, (b, 1, kv_heads, hd))
    v_new = constrain_act(v_new, kv_ax, (b, 1, kv_heads, hd))
    if cfg.swa_window is not None:
        slot = pos % slots  # ring buffer: cache holds only the window
    else:
        slot = pos.clamp(max=slots - 1) if traced else min(pos, slots - 1)
    if traced:
        local = (slot - c0).reshape(1).to(torch.int64)
        k_w, v_w = k_new.to(cache.k.dtype), v_new.to(cache.v.dtype)
        p_w = pos.reshape(1).to(torch.int32)
        if split:
            # only the rank that owns the slot writes it: the others
            # write back what the slot holds
            own = (local >= 0) & (local < c_loc)
            local = local.clamp(0, c_loc - 1)
            k_w = torch.where(own.reshape(1, 1, 1, 1), k_w,
                              cache.k.index_select(1, local))
            v_w = torch.where(own.reshape(1, 1, 1, 1), v_w,
                              cache.v.index_select(1, local))
            p_w = torch.where(own, p_w, cache.pos_ids.index_select(0, local))
        cache.k.index_copy_(1, local, k_w)
        cache.v.index_copy_(1, local, v_w)
        cache.pos_ids.index_copy_(0, local, p_w)
    elif 0 <= slot - c0 < c_loc:
        cache.k[:, slot - c0] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot - c0] = v_new[:, 0].to(cache.v.dtype)
        cache.pos_ids[slot - c0] = pos

    pos_ids = cache.pos_ids
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if cfg.swa_window is not None:
        valid &= pos_ids > pos - cfg.swa_window
    return _attend_cached(q, cache.k, cache.v, valid, cfg, split), cache


def _attend_cached(q, k, v, valid, cfg, split: bool):
    """One token's queries ``q`` (B,1,H or this rank's heads,hd) over
    cached keys and values (B,C,KV or the rank's kv heads,hd) at the
    slots ``valid`` (C,) marks.  ``split``: the cache holds this rank's
    slice of the positions and ``q`` every head; the partial softmax
    statistics are combined over "model" and the output keeps the
    rank's heads."""
    b, hd = q.shape[0], cfg.head_dim_
    # GQA-native grouped attention: the rep-expanded K/V never exist;
    # the query heads here read their kv groups of the cache
    qg, kc, vc = _decode_groups(q, k, v, cfg)
    scores = torch.einsum("bqgrd,bsgd->bgrqs", qg, kc).float()
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~valid[None, None, None, None, :], NEG_INF)
    heads = qg.shape[2] * qg.shape[3]
    if not split:
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bgrqs,bsgd->bqgrd", w, vc).reshape(
            b, 1, heads, hd)
    # the partial softmax over this rank's positions, combined over
    # "model": the max, then the sum beside the weighted values
    m = C.max_over_model(scores.amax(-1, keepdim=True), "decode_max")
    e = torch.exp(scores - m)                       # (B, G, R, 1, C)
    o = torch.einsum("bgrqs,bsgd->bqgrd", e.to(q.dtype), vc)
    den = e.sum(-1)                                 # (B, G, R, 1)
    both = C.reduce_from_model(
        torch.cat([den.reshape(-1), o.reshape(-1).float()]), "decode_sum")
    den = both[:den.numel()].reshape(den.shape).permute(0, 3, 1, 2)
    o = both[den.numel():].reshape(o.shape) / den[..., None]
    out = o.to(q.dtype).reshape(b, 1, heads, hd)
    return constrain_act(out, ("batch", None, "heads", None),
                         (b, 1, cfg.num_heads, hd))


def cross_decode(p, cfg, x, k, v):
    """One token's cross-attention (an encoder-decoder's): the normed
    ``x`` (B,1,D) over the cached keys and values of the encoder frames
    ``k``/``v`` (B,F,KV,hd).  Returns the heads (B,1,H,hd).  On a rank
    of a serving mesh the cache's layout decides the attention's, as in
    :func:`decode_attend`: the rank's kv heads and its query heads (no
    collective), or its slice of the frames with every head (the
    queries gathered over "model", the partial softmax combined, the
    output the rank's heads)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    _, frames = cache_positions(k.shape[1], cross=True)
    split = k.shape[1] != frames
    if not split and q.shape[2] == cfg.num_heads:
        return attend(q, k, v, causal=False)
    if split:
        q = constrain_act(q, ("batch", None, None, None),
                          (q.shape[0], 1, cfg.num_heads, cfg.head_dim_))
    valid = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
    return _attend_cached(q, k, v, valid, cfg, split)


def _decode_groups(q, k, v, cfg):
    """``qg`` (B,1,G,R,hd) and the cached ``k``/``v`` (B,C,G,hd): the
    query heads ``q`` (all of them, or this rank's block) in groups of
    R that read one kv head each, and those kv heads of the cache (all
    of them, or the rank's block)."""
    b, _, h_loc, hd = q.shape
    rep = cfg.num_heads // cfg.num_kv_heads
    h0 = C.shard_offset(h_loc, cfg.num_heads, "decode heads") or 0
    kv0 = C.shard_offset(k.shape[2], cfg.num_kv_heads,
                         "decode kv heads") or 0
    g0 = h0 // rep - kv0
    if h0 % rep == 0 and h_loc % rep == 0:
        g1 = g0 + h_loc // rep
        return (q.reshape(b, 1, h_loc // rep, rep, hd),
                k[:, :, g0:g1], v[:, :, g0:g1])
    if rep % h_loc == 0:
        # the heads lie in one group
        return (q.reshape(b, 1, 1, h_loc, hd), k[:, :, g0:g0 + 1],
                v[:, :, g0:g0 + 1])
    idx = torch.div(torch.arange(h0, h0 + h_loc, device=q.device), rep,
                    rounding_mode="floor") - kv0
    return (q.reshape(b, 1, h_loc, 1, hd), k.index_select(2, idx),
            v.index_select(2, idx))


def prefill_into_cache(p, cfg, k, v, cache_len: int) -> KVCache:
    """Build a cache from prefill K/V (B,S,KV,hd); keeps the last
    ``cache_len`` positions (all of them when S ≤ cache_len).  On a rank
    of a serving mesh (K/V of its kv heads, or of all of them) the cache
    is put into the layout the plan's rules give the cache
    (:func:`kv_cache_axes`): the rank's slice of the positions where
    ``cache_seq`` holds "model" (its kv heads made whole), else its kv
    heads."""
    cache = _prefill_cache(k, v, cache_len)
    b, _, _, hd = k.shape
    whole = (b, cache_len, cfg.num_kv_heads, hd)
    ax = kv_cache_axes()
    return KVCache(k=constrain_act(cache.k, ax.k, whole),
                   v=constrain_act(cache.v, ax.v, whole),
                   pos_ids=constrain_act(cache.pos_ids, ax.pos_ids,
                                         (cache_len,)))


def _prefill_cache(k, v, cache_len: int) -> KVCache:
    b, s, kv, hd = k.shape
    if s >= cache_len:
        k_c, v_c = k[:, s - cache_len:], v[:, s - cache_len:]
        pos_ids = torch.arange(s - cache_len, s, dtype=torch.int32,
                               device=k.device)
    else:
        pad = cache_len - s
        zk = torch.zeros((b, pad, kv, hd), dtype=k.dtype, device=k.device)
        k_c = torch.cat([k, zk], dim=1)
        v_c = torch.cat([v, zk], dim=1)
        pos_ids = torch.cat([
            torch.arange(s, dtype=torch.int32, device=k.device),
            torch.full((pad,), -1, dtype=torch.int32, device=k.device)])
    return KVCache(k=k_c, v=v_c, pos_ids=pos_ids)

