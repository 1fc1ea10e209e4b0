"""Small tree helpers over nested dicts (and tuples) of tensors.

The port's trees are the JAX package's pytrees written as plain Python
containers: the fleet's parameters are flat ``{name: tensor}`` dicts,
the LM's are nested dicts whose ``blocks`` leaves carry a leading layer
axis, and a KV cache is a NamedTuple.  Dict entries are visited in
sorted-key order and tuple entries in order, which is the order
``jax.tree_util.tree_leaves`` gives, so reductions across leaves
associate the same way in both packages.

``per_agent=True`` on the reductions keeps a leading agent axis: each
leaf is ``(A, *shape)`` and the result is an ``(A,)`` vector.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

Tree = Any  # a tensor, or a dict / tuple / NamedTuple of trees


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over trees of one structure; dicts come
    back with sorted keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_flatten_with_path(tree: Tree, prefix: Tuple = ()) -> List[Tuple]:
    """``[(path, leaf)]`` in leaf order; a path is the tuple of dict keys
    and tuple field names (or indices) from the root to the leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        names = tree._fields if _is_namedtuple(tree) else range(len(tree))
        return [item for name, x in zip(names, tree)
                for item in tree_flatten_with_path(x, prefix + (name,))]
    return [(prefix, tree)]


def tree_unflatten(skeleton: Tree, leaves) -> Tree:
    """A tree of ``skeleton``'s structure whose leaves, in the order of
    :func:`tree_flatten_with_path`, are ``leaves``."""
    return _unflatten(skeleton, iter(leaves))


def _unflatten(node, it):
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``leaves`` (at an LM's size,
    # gigabytes of tensors) alive until the cyclic collector runs
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*(_unflatten(x, it) for x in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_unflatten(x, it) for x in node)
    return next(it)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_add_scaled(a: Tree, b: Tree, scale) -> Tree:
    """a + scale * b, leafwise; result keeps ``a``'s leaf dtypes."""
    return tree_map(lambda x, y: (x + scale * y).to(x.dtype), a, b)


def tree_scale(a: Tree, scale) -> Tree:
    return tree_map(lambda x: scale * x, a)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_size(a: Tree) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_cast(a: Tree, dtype: torch.dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), a)


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


def tree_flatten_agents(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``(A, n)`` fp32 rows: each agent's leaves flattened and
    concatenated in leaf order (the batched form of the JAX trigger's
    ``concatenate([x.reshape(-1) ...])``)."""
    leaves = [x.reshape(x.shape[0], -1).float() for x in tree_leaves(tree)]
    return leaves[0].contiguous() if len(leaves) == 1 else torch.cat(leaves, 1)
