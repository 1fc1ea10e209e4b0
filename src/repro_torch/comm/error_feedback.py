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


def ef_residual(grads, sent, alphas, delivered=None):
    """New memory: ``(g − C(g)) · α`` per agent (``alphas`` is ``(A,)``,
    matching the leaves' leading agent axis).

    ``delivered`` (a channel's ``(A,)`` {0, 1} delivery draw) folds a
    LOST transmission back whole: the residual becomes ``(g − C(g)·d)·α``,
    so on a drop the entire intended payload returns to memory."""

    def bcast(v, g):
        return v.to(g.dtype).reshape((-1,) + (1,) * (g.ndim - 1))

    if delivered is None:
        return tree_map(lambda g, s: (g - s) * bcast(alphas, g), grads, sent)
    return tree_map(
        lambda g, s: (g - s * bcast(delivered, g)) * bcast(alphas, g),
        grads, sent)
