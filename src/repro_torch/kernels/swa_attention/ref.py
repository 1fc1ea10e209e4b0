"""Plain PyTorch version of the ``swa_attention`` kernel (the math of
``repro.kernels.swa_attention.ref``, model layout).

The CPU path of :func:`repro_torch.kernels.swa_attention.ops.swa_attention`,
and the version the kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,S,KV,hd) -> (B,S,H,hd) in ``q.dtype``.

    Causal attention restricted to positions (t − window, t]; scores,
    softmax and the weighted sum in fp32.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    k = k[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(b, s, h, hd)
    v = v[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(b, s, h, hd)
    scores = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    scores = scores.masked_fill(~mask[None, None], NEG)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", w, v.float()).to(q.dtype)
