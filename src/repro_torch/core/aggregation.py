"""Server-side aggregation — paper eq. (10) generalized to m agents.

The port of ``repro.core.aggregation``: the server averages whichever
gradients arrive and holds if none do,

    w⁺ = w − ε · Σᵢ αᵢ gᵢ / max(Σᵢ αᵢ, 1),

plus the legacy whole-tree quantized and top-k variants (with error
feedback) and the round's summary statistics.  The train step composes
the same pieces per agent through ``repro_torch.comm`` instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm.compressors import fake_quantize, topk_sparsify
from repro_torch.utils.tree import tree_map


class AggregateStats(NamedTuple):
    comm_rate: torch.Tensor   # mean_i alpha_i           (per-round rate)
    any_tx: torch.Tensor      # max_i alpha_i            (Thm 2's counter)
    num_tx: torch.Tensor      # sum_i alpha_i
    mean_gain: torch.Tensor   # mean of per-agent estimated gains


def masked_mean(grads, alphas: torch.Tensor):
    """Eq. (10): mean over transmitting agents; zero update if none.

    ``grads`` leaves carry a leading agent axis A; ``alphas`` is a float
    ``(A,)`` vector of {0, 1} decisions.
    """
    denom = torch.clamp(alphas.sum(), min=1.0)

    def agg(g):
        a = alphas.reshape((-1,) + (1,) * (g.ndim - 1)).to(g.dtype)
        return (g * a).sum(0) / denom.to(g.dtype)

    return tree_map(agg, grads)


def _residual(grads, sent, alphas):
    """``(g − C(g)) · α``: a silent agent keeps nothing."""

    def res(g, s):
        return (g - s) * alphas.reshape(
            (-1,) + (1,) * (g.ndim - 1)).to(g.dtype)

    return tree_map(res, grads, sent)


def masked_mean_quantized(grads, alphas: torch.Tensor,
                          ef_memory: Optional[object] = None):
    """Eq. (10) with int8 transmissions (+ error feedback).

    Each stacked ``(A, *shape)`` leaf is quantized as ONE tensor (one
    scale over all agents, as in the JAX package's whole-tree path).
    Returns ``(aggregated, new_ef_memory)``; the memory is ``None``
    without ``ef_memory``."""
    if ef_memory is not None:
        grads = tree_map(lambda g, m: g + m, grads, ef_memory)
    sent = tree_map(lambda g: fake_quantize(g[None])[0], grads)
    new_mem = None if ef_memory is None else _residual(grads, sent, alphas)
    return masked_mean(sent, alphas), new_mem


def masked_mean_topk(grads, alphas: torch.Tensor, frac: float,
                     ef_memory: Optional[object] = None):
    """Eq. (10) with top-k-sparsified transmissions (+ error feedback):
    each agent sparsifies its own slice.  Same contract as
    :func:`masked_mean_quantized`."""
    if ef_memory is not None:
        grads = tree_map(lambda g, m: g + m, grads, ef_memory)
    sent = tree_map(lambda g: topk_sparsify(g, frac)[0], grads)
    new_mem = None if ef_memory is None else _residual(grads, sent, alphas)
    return masked_mean(sent, alphas), new_mem


def aggregate_stats(alphas: torch.Tensor,
                    gains: torch.Tensor) -> AggregateStats:
    return AggregateStats(
        comm_rate=alphas.mean(),
        any_tx=alphas.max(),
        num_tx=alphas.sum(),
        mean_gain=gains.mean(),
    )
