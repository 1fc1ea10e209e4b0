"""Mixture-of-Experts with sort-based, fixed-capacity dispatch (port of
``repro.models.moe``).

* Routing: a softmax router, the top-K experts per token with their
  gates renormalized to sum to 1 (:func:`route`).
* Dispatch is data movement into a fixed ``(E, cap, D)`` buffer: the
  (token, k) pairs sorted by expert id (a stable sort, so that within
  an expert the earlier pair keeps its place), each pair's position in
  its expert's segment from an exclusive cumsum of the expert counts,
  and the pairs past ``cap`` dropped (:func:`dispatch_slots`).  A
  dropped pair's slot is one trash row past the buffer, written and
  never read, so every shape is static: no boolean-mask indexing, no
  ``nonzero``, no host sync, and the layer runs under
  ``torch.func.vmap``.
* The expert compute is three batched products over the buffer, the
  active expert flops only (× the capacity factor).
* The combine gathers each pair's output row back in the flat (token,
  k) order and sums over k in order.  Each kept pair owns one buffer
  row, so no two writes or gradient sums meet: the layer has no float
  atomics on the card and its step is bitwise repeatable (where the JAX
  package scatter-adds in sorted order; with K = 2 both sum the same two
  terms).
* The shared experts (kimi-k2) are a dense SwiGLU beside the routed
  ones.

The router aux loss is the Switch load-balance loss
``E · Σ_e f_e · p̄_e / K``, returned beside the output.

On a rank of a (data, model) mesh the layer reads its layout from its
blocks' shapes, as the JAX package's rules lay them out
(:mod:`repro_torch.sharding.collectives`):

* the expert split (``expert`` on "model", where the expert count
  divides it): the router's columns and the experts are the rank's.
  The (T, E) logits are made whole before the softmax, every rank
  routes every token the same way and builds the same slots, runs its
  experts' rows of the buffer and combines only the pairs whose expert
  it holds (the others at zero);
* the ``ff`` split (the guard replicates ``expert``): every expert runs
  column- and row-parallel over its ``ff`` columns, the router whole;
* the shared experts are column- and row-parallel over ``ff``;
* the partial outputs (routed and shared) are summed over "model" once
  (tag ``moe_out``).

Routing always sees the agent's whole token set, as JAX's one global
computation does: a rank holding a chunk of the sequence
(``seq_shard``) or a block of the rows (``inner_batch_shard``, or a
serving batch's rows over the data axes) gathers the tokens first and
hands back its own part after the combine, so the capacity and the
dropped pairs are JAX's.  The aux loss comes from the whole
probabilities and is the same on every rank.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives as C

_DROPS: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "moe_drops", default=None)


@contextlib.contextmanager
def record_drops():
    """Collect, per moe layer call in the body, the (T, K) bool mask of
    the (token, k) pairs past their expert's capacity (on the CPU).  A
    call under a ``torch.func`` transform cannot be recorded: call the
    model's forward or loss directly."""
    token = _DROPS.set([])
    try:
        yield _DROPS.get()
    finally:
        _DROPS.reset(token)


def build_moe(scope, cfg):
    moe = cfg.moe
    d = cfg.d_model
    scope.param("router", (d, moe.num_experts), ("embed", "expert"),
                scale=0.02)
    scope.param("w_gate", (moe.num_experts, d, moe.d_ff_expert),
                ("expert", "embed", "ff"))
    scope.param("w_up", (moe.num_experts, d, moe.d_ff_expert),
                ("expert", "embed", "ff"))
    scope.param("w_down", (moe.num_experts, moe.d_ff_expert, d),
                ("expert", "ff", "embed"))
    if moe.num_shared_experts:
        f = moe.d_ff_expert * moe.num_shared_experts
        scope.param("shared_w_gate", (d, f), ("embed", "ff"))
        scope.param("shared_w_up", (d, f), ("embed", "ff"))
        scope.param("shared_w_down", (f, d), ("ff", "embed"))


def capacity(num_tokens: int, k: int, num_experts: int, factor: float) -> int:
    cap = int(num_tokens * k * factor / num_experts) + 1
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def route(p, cfg, xt: torch.Tensor):
    """xt (T, D) -> (probs (T, E) fp32, gates (T, K) renormalized,
    expert ids (T, K)), the top K in descending order of probability."""
    return route_logits(cfg, (xt @ p["router"].to(xt.dtype)).float())


def route_logits(cfg, logits: torch.Tensor):
    """:func:`route` from the router's (T, E) fp32 logits."""
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.moe.experts_per_token, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), experts


def dispatch_slots(experts: torch.Tensor, num_experts: int,
                   cap: int) -> torch.Tensor:
    """The buffer row of every (token, k) pair, in the flat order of
    ``experts.reshape(-1)``: ``e · cap + position in e's segment``, or
    the trash row ``E · cap`` for a pair past its expert's capacity."""
    flat_e = experts.reshape(-1)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(num_experts, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add(
        0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, 0) - counts  # exclusive cumsum
    pos = torch.arange(n, device=flat_e.device) - seg_start[sorted_e]
    slot = torch.where(pos < cap, sorted_e * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    # back to the flat order: ``order`` is a permutation
    return torch.empty_like(slot).scatter(0, order, slot)


def _router_logits(p, cfg, xt, xst, e0):
    """The (T, E) fp32 router logits: from the whole router, or where
    its columns are the rank's (the expert split) from ``xst`` (the
    tokens whose cotangent the model ranks sum, under tensor
    parallelism), the rank's columns made whole over "model".  Under
    tensor parallelism that gather's backward keeps the rank's block of
    the whole cotangent (every rank's loss is the whole one); where the
    ranks split the tokens it sums the ranks' shares first."""
    if e0 is None:
        return (xt @ p["router"].to(xt.dtype)).float()
    part = xst @ p["router"].to(xst.dtype)
    return C.gather_columns([(part, 1, cfg.moe.num_experts)],
                            "moe_logits")[0].float()


def _whole_tokens(x: torch.Tensor) -> torch.Tensor:
    """The agent's (a serving batch's) whole token set from this rank's
    part: its chunk of the sequence gathered (``seq_shard``), its rows
    of the agent's batch (``inner_batch_shard``) and a serving batch's
    rows over the data axes; each gather's backward sums the ranks'
    cotangents and keeps the part."""
    split = C.tokens_split()
    if split == "seq":
        x = C.gather_seq(x, "sp_moe_in")
    elif split == "rows":
        x = C.gather_seq(x, "rows_moe_in", dim=0)
    return C.gather_rows(x)


def _own_part(y: torch.Tensor, partial: bool) -> torch.Tensor:
    """This rank's part of an output over the whole token set: its rows
    of a serving batch, then summed over "model" where ``partial`` (each
    rank's share of split weights) and cut to the rank's chunk or rows
    where the ranks split the tokens."""
    y = C.own_rows(y)
    split = C.tokens_split()
    if split == "rows":
        return C.seq_chunk(y, 0)
    if split == "seq":
        return C.scatter_seq(y, "sp_moe_out") if partial else C.seq_chunk(y)
    return C.reduce_from_model(y, "tp_moe_out") if partial else y


def moe_layer(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).  On a mesh rank
    (the module doc) ``x`` is the rank's part of the tokens and the
    weights its blocks; the output is the rank's part."""
    moe = cfg.moe
    e, k = moe.num_experts, moe.experts_per_token
    e0 = C.shard_offset(p["w_gate"].shape[0], e, "moe experts")
    f0 = C.shard_offset(p["w_gate"].shape[2], moe.d_ff_expert, "moe ff")
    routed_split = e0 is not None or f0 is not None
    shared_split = bool(moe.num_shared_experts) and C.shard_offset(
        p["shared_w_gate"].shape[1],
        moe.d_ff_expert * moe.num_shared_experts, "moe shared ff") is not None
    tp = C.tokens_split() is None
    xw = _whole_tokens(x)
    # the input of the split weights: its cotangent summed over "model"
    # under tensor parallelism (each rank's share of it)
    xs = (C.copy_to_model(xw, "tp_moe_in")
          if tp and (routed_split or shared_split) else xw)
    b, s, d = xw.shape
    t = b * s
    cap = capacity(t, k, e, moe.capacity_factor)

    xt, xst = xw.reshape(t, d), xs.reshape(t, d)
    probs, gates, experts = route_logits(
        cfg, _router_logits(p, cfg, xt, xst, e0))

    # ---- Switch load-balance aux loss --------------------------------
    hits = (experts[..., None] == torch.arange(e, device=x.device)).float()
    f_e = hits.sum(1).mean(0)  # fraction routed (counting top-k hits)
    p_e = probs.mean(0)
    aux = C.whole_term(e * torch.sum(f_e * p_e) / k)
    if tp and routed_split:
        # each rank's pairs give a share of the gates' cotangent
        gates = C.copy_to_model(gates, "tp_moe_gates")

    # ---- sort-based dispatch: (T·K) pairs -> (E·cap + trash, D) ------
    slot = dispatch_slots(experts, e, cap)
    rec = _DROPS.get()
    if rec is not None:
        rec.append((slot == e * cap).reshape(t, k).detach().cpu())
    src = xst if routed_split else xt
    e_loc = p["w_gate"].shape[0]
    if e0 is not None:
        # the rank's experts' rows of the buffer; every other pair goes
        # to the trash row
        slot = slot - e0 * cap
        slot = torch.where((slot >= 0) & (slot < e_loc * cap), slot,
                           torch.full_like(slot, e_loc * cap))
    pairs = src.unsqueeze(1).expand(t, k, d).reshape(t * k, d)
    buf = src.new_zeros((e_loc * cap + 1, d)).index_copy(0, slot, pairs)
    buf = buf[:e_loc * cap].reshape(e_loc, cap, d)

    # ---- expert compute (active flops only) --------------------------
    gate_h = F.silu(torch.einsum("ecd,edf->ecf", buf,
                                 p["w_gate"].to(buf.dtype)))
    up_h = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(buf.dtype))
    out_buf = torch.einsum("ecf,efd->ecd", gate_h * up_h,
                           p["w_down"].to(buf.dtype)).reshape(e_loc * cap, d)

    # ---- combine: each pair's row (0 for a dropped pair), summed over k
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    gathered = out_buf[slot].reshape(t, k, d)
    out = (gathered * gates.to(xt.dtype)[..., None]).sum(1)

    # ---- shared experts (dense path, kimi-k2) ------------------------
    shared = None
    if moe.num_shared_experts:
        xh = xst if shared_split else xt
        g = F.silu(xh @ p["shared_w_gate"].to(xh.dtype))
        shared = (g * (xh @ p["shared_w_up"].to(xh.dtype))) @ p[
            "shared_w_down"].to(xh.dtype)
    if shared is not None and shared_split == routed_split:
        out, shared = out + shared, None
    out = _own_part(out.reshape(b, s, d), routed_split)
    if shared is not None:
        out = out + _own_part(shared.reshape(b, s, d), shared_split)
    return out, aux
