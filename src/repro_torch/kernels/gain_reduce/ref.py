"""Plain PyTorch version of the ``gain_reduce`` kernel.

The CPU path of :func:`repro_torch.kernels.gain_reduce.ops.gain_reduce`,
and the version the kernel is held against on the card.
"""
from __future__ import annotations

import torch


def gain_reduce_ref(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``[gᵀg, gᵀh]`` per row in fp32: shape ``g.shape[:-1] + (2,)``."""
    gf, hf = g.float(), h.float()
    return torch.stack([(gf * gf).sum(-1), (gf * hf).sum(-1)], -1)

