"""Small tree linear-algebra helpers over dicts of tensors.

The port's parameter trees are flat ``{name: tensor}`` dicts (the JAX
package's pytrees of the linear-regression fleet are exactly that).
Leaves are visited in sorted-key order, which is the order
``jax.tree_util.tree_leaves`` gives a dict, so reductions across leaves
associate the same way in both packages.

``per_agent=True`` on the reductions keeps a leading agent axis: each
leaf is ``(A, *shape)`` and the result is an ``(A,)`` vector.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.utils.todo import not_ported

Tree = Dict[str, torch.Tensor]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``{k: fn(tree[k], *(r[k] for r in rest))}`` in sorted-key order."""
    return {k: fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return [tree[k] for k in sorted(tree)]


def tree_add_scaled(a: Tree, b: Tree, scale) -> Tree:
    """a + scale * b, leafwise; result keeps ``a``'s leaf dtypes."""
    return tree_map(lambda x, y: (x + scale * y).to(x.dtype), a, b)


def tree_vdot(a: Tree, b: Tree, *, per_agent: bool = False) -> torch.Tensor:
    """Sum of elementwise products across all leaves (fp32 accumulation)."""

    def dot(x, y):
        p = x.float() * y.float()
        return p.reshape(p.shape[0], -1).sum(1) if per_agent else p.sum()

    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = dot(x, y)
        total = d if total is None else total + d
    return total


def tree_norm_sq(a: Tree, *, per_agent: bool = False) -> torch.Tensor:
    return tree_vdot(a, a, per_agent=per_agent)


def tree_flatten_agents(tree: Tree) -> torch.Tensor:
    """``(A, n)`` fp32 rows: each agent's leaves flattened and
    concatenated in leaf order (the batched form of the JAX trigger's
    ``concatenate([x.reshape(-1) ...])``)."""
    leaves = [x.reshape(x.shape[0], -1).float() for x in tree_leaves(tree)]
    return leaves[0].contiguous() if len(leaves) == 1 else torch.cat(leaves, 1)


__getattr__ = not_ported(__name__, {
    "tree_scale": "queue 1 item 1",
    "tree_size": "queue 1 item 1",
    "tree_cast": "queue 1 item 1",
    "tree_zeros_like": "queue 1 item 1",
})
