"""Plain PyTorch version of the ``fused_ce`` kernel (the math of
``repro.kernels.fused_ce.ref``).

The CPU path of :mod:`repro_torch.kernels.fused_ce.ops`, and the version
the kernel is held against on the card.  Leading dimensions of ``x``,
``table`` and ``labels`` broadcast, so the same function serves one
token matrix or a group of them.
"""
from __future__ import annotations

import torch


def fused_ce_lse_ref(x: torch.Tensor, table: torch.Tensor,
                     labels: torch.Tensor):
    """``(nll, lse)`` per token, both fp32: ``lse_t = logsumexp_v(x_t ·
    table_v)`` and ``nll_t = lse_t − x_t · table_{labels_t}``.

    x (..., T, D); table (..., V, D); labels (..., T) integer.
    """
    logits = x.float() @ table.float().transpose(-1, -2)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold, lse


def fused_ce_ref(x: torch.Tensor, table: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL. x (T, D); table (V, D); labels (T,) -> (T,) fp32."""
    return fused_ce_lse_ref(x, table, labels)[0]
