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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
    logits = (xt @ p["router"].to(xt.dtype)).float()
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


def moe_layer(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.experts_per_token
    cap = capacity(t, k, e, moe.capacity_factor)

    xt = x.reshape(t, d)
    probs, gates, experts = route(p, cfg, xt)

    # ---- Switch load-balance aux loss --------------------------------
    hits = (experts[..., None] == torch.arange(e, device=x.device)).float()
    f_e = hits.sum(1).mean(0)  # fraction routed (counting top-k hits)
    p_e = probs.mean(0)
    aux = e * torch.sum(f_e * p_e) / k

    # ---- sort-based dispatch: (T·K) pairs -> (E·cap + trash, D) ------
    slot = dispatch_slots(experts, e, cap)
    pairs = xt.unsqueeze(1).expand(t, k, d).reshape(t * k, d)
    buf = xt.new_zeros((e * cap + 1, d)).index_copy(0, slot, pairs)
    buf = buf[:e * cap].reshape(e, cap, d)

    # ---- expert compute (active flops only) --------------------------
    gate_h = F.silu(torch.einsum("ecd,edf->ecf", buf,
                                 p["w_gate"].to(buf.dtype)))
    up_h = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(buf.dtype))
    out_buf = torch.einsum("ecf,efd->ecd", gate_h * up_h,
                           p["w_down"].to(buf.dtype)).reshape(e * cap, d)

    # ---- combine: each pair's row (0 for a dropped pair), summed over k
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    gathered = out_buf[slot].reshape(t, k, d)
    out = (gathered * gates.to(xt.dtype)[..., None]).sum(1)

    # ---- shared experts (dense path, kimi-k2) ------------------------
    if moe.num_shared_experts:
        g = F.silu(xt @ p["shared_w_gate"].to(xt.dtype))
        out = out + (g * (xt @ p["shared_w_up"].to(xt.dtype))) @ p[
            "shared_w_down"].to(xt.dtype)

    return out.reshape(b, s, d), aux
