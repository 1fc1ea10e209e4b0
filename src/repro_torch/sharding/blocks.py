"""The comm epilogue on model blocks (port-only).

On a (data, model) mesh each agent's gradient leaves the backward as
this rank's model block of every leaf, the layout the JAX package pins
it to (``constrain_params(g, "")``), and the EF memory, the payload, a
delay line's payloads and the aggregate stay in that layout.  What reads
a whole leaf reads it through here:

* :func:`model_blocks` is the context the mesh step runs its round in:
  the tree of :class:`LeafBlock` (None for a leaf that every model rank
  holds whole) by leaf path;
* :func:`at_leaf` / :func:`map_leaves` name the leaf a compressor runs
  on, and :func:`current` gives it to the compressor
  (:mod:`repro_torch.comm.compressors`), which then forms the whole
  leaf's result from the blocks with a collective over "model" (int8's
  scale, top-k's threshold, randk's salt and subset, the sketch's
  counters);
* :func:`per_agent_vdot` is each agent's ``Σ xᵀy`` over a tree (the
  blocks' sums reduced over "model", plus the whole leaves' once);
  :func:`global_like` gives a per-agent tree's whole shapes, which the
  byte counts read.

Without the context (one card, a data-only mesh, tests) every function
here is the whole-leaf one.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.utils.tree import (
    tree_flatten_with_path,
    tree_unflatten,
    tree_vdot,
)


@dataclass(frozen=True)
class LeafBlock:
    """This rank's model block of one leaf: the leaf's whole shape, the
    block's index in it, and the model axis its blocks lie over (a
    :class:`~repro_torch.sharding.collectives.ModelAxis`)."""

    whole: Tuple[int, ...]
    index: Tuple[slice, ...]
    axis: object

    @property
    def numel(self) -> int:
        n = 1
        for d in self.whole:
            n *= int(d)
        return n

    def where(self, tag: str, op: str = "sum"):
        return self.axis.where(tag, op)

    def _ranges(self):
        """Each dim's ``(size in the leaf, start, stop)`` of the block."""
        out = []
        for n, s in zip(self.whole, self.index):
            start, stop, step = s.indices(int(n))
            assert step == 1, "a model block is a contiguous slice"
            out.append((int(n), start, stop))
        return out

    def flat_index(self, device=None) -> torch.Tensor:
        """The block's entries' indices in the whole leaf flattened
        (row-major), in the block's own row-major order (block-sized)."""
        idx = torch.zeros((), dtype=torch.int64, device=device)
        for n, start, stop in self._ranges():
            idx = idx.unsqueeze(-1) * n + torch.arange(
                start, stop, dtype=torch.int64, device=device)
        return idx.reshape(-1)

    def local_of(self, flat: torch.Tensor):
        """``(position in the block, whether in it)`` of indices ``flat``
        into the whole leaf flattened (row-major)."""
        local = torch.zeros_like(flat)
        inside = torch.ones_like(flat, dtype=torch.bool)
        rest, mult = flat, 1
        for n, start, stop in reversed(self._ranges()):
            c, rest = rest % n, rest // n
            inside &= (c >= start) & (c < stop)
            local = local + (c - start) * mult
            mult *= stop - start
        return local, inside

    def cut(self, whole: torch.Tensor) -> torch.Tensor:
        """The block of an ``(A, *whole)`` tensor."""
        return whole[(slice(None),) + self.index]


_TREE: contextvars.ContextVar[Optional[Dict[tuple, Optional[LeafBlock]]]] = (
    contextvars.ContextVar("model_blocks", default=None))
_LEAF: contextvars.ContextVar[Optional[LeafBlock]] = contextvars.ContextVar(
    "model_block_leaf", default=None)


@contextlib.contextmanager
def model_blocks(layouts: Optional[Dict[tuple, Optional[LeafBlock]]]):
    """Run the body with ``layouts`` (leaf path -> :class:`LeafBlock` or
    None) as the per-agent trees' layout; None: whole leaves."""
    token = _TREE.set(layouts)
    try:
        yield
    finally:
        _TREE.reset(token)


def current() -> Optional[LeafBlock]:
    """The block of the leaf a compressor runs on; None: a whole leaf."""
    return _LEAF.get()


def _of(path) -> Optional[LeafBlock]:
    tree = _TREE.get()
    return None if tree is None else tree.get(tuple(path))


@contextlib.contextmanager
def at_leaf(path):
    """Run the body on the leaf at ``path`` of a parameter-shaped tree."""
    token = _LEAF.set(_of(path))
    try:
        yield
    finally:
        _LEAF.reset(token)


def map_leaves(fn, tree):
    """``fn`` over a parameter-shaped tree's leaves, each under
    :func:`at_leaf` (a plain map without the context)."""
    if isinstance(tree, torch.Tensor):
        # one leaf: the caller's at_leaf names it
        return fn(tree)
    flat = tree_flatten_with_path(tree)
    if _TREE.get() is None:
        out = [fn(x) for _, x in flat]
    else:
        out = []
        for path, x in flat:
            with at_leaf(path):
                out.append(fn(x))
    return tree_unflatten(tree, out)


def split_leaves(tree):
    """``(the leaves split over "model", the whole ones)`` of a
    parameter-shaped tree, each list in leaf order."""
    split, whole = [], []
    for path, x in tree_flatten_with_path(tree):
        (split if _of(path) is not None else whole).append(x)
    return split, whole


def model_axis():
    """The model axis of the blocks (None without the context)."""
    tree = _TREE.get()
    if not tree:
        return None
    for blk in tree.values():
        if blk is not None:
            return blk.axis
    return None


def per_agent_vdot(a, b) -> torch.Tensor:
    """Each agent's ``Σ_leaves Σ x·y`` in fp32 over two per-agent trees
    (leading agent axis): the whole-tree value, from the blocks' sums
    reduced over "model" once and the whole leaves' added."""
    axis = model_axis()
    if axis is None:
        return tree_vdot(a, b, per_agent=True)
    from repro_torch.sharding.collectives import _AllReduce

    (sa, wa), (sb, wb) = split_leaves(a), split_leaves(b)
    if not sa:
        return tree_vdot(a, b, per_agent=True)
    total = _AllReduce.apply(tree_vdot(sa, sb, per_agent=True),
                             axis.where("block_vdot"))
    if wa:
        total = total + tree_vdot(wa, wb, per_agent=True)
    return total


def global_like(tree, lead: int = 1):
    """``meta`` stand-ins of a per-agent tree (``lead`` leading dims)
    with every block widened to its whole leaf: the tree itself without
    the context."""
    if _TREE.get() is None:
        return tree

    def widen(path, x):
        blk = _of(path)
        shape = tuple(x.shape) if blk is None else (
            tuple(x.shape[:lead]) + blk.whole)
        return torch.empty(shape, dtype=x.dtype, device="meta")

    return tree_unflatten(tree, [widen(p, x) for p, x in
                                 tree_flatten_with_path(tree)])
