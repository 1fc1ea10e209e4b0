"""Server-side aggregation — paper eq. (10) generalized to m agents.

The port of ``repro.core.aggregation.masked_mean``: the server averages
whichever gradients arrive and holds if none do,

    w⁺ = w − ε · Σᵢ αᵢ gᵢ / max(Σᵢ αᵢ, 1).
"""
from __future__ import annotations

import torch

from repro_torch.utils.todo import not_ported
from repro_torch.utils.tree import tree_map


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


__getattr__ = not_ported(__name__, {
    name: "queue 1 item 4"
    for name in ("AggregateStats", "masked_mean_quantized",
                 "masked_mean_topk", "aggregate_stats")
})
