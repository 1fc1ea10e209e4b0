"""Error-feedback stage — local residual memory for biased compression.

The port of ``repro.comm.error_feedback``.  The residual ``g − C(g)`` is
kept only when the agent TRANSMITTED its compressed tensor; a silent
agent sent nothing and keeps nothing (eq. 10 drops its update).
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map


def ef_init(params, num_agents: int):
    """Zero residual memory: one slot per agent per parameter leaf."""
    return tree_map(
        lambda p: torch.zeros((num_agents,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device),
        params,
    )


def ef_add(grads, ef_memory):
    """Fold the carried residual into this round's gradients (no-op if None)."""
    if ef_memory is None:
        return grads
    return tree_map(lambda g, m: g + m, grads, ef_memory)


def ef_residual(grads, sent, alphas):
    """New memory: ``(g − C(g)) · α`` per agent (``alphas`` is ``(A,)``,
    matching the leaves' leading agent axis)."""

    def bcast(g):
        return alphas.to(g.dtype).reshape((-1,) + (1,) * (g.ndim - 1))

    return tree_map(lambda g, s: (g - s) * bcast(g), grads, sent)
