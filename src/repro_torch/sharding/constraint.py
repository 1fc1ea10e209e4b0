"""Gather-at-use constraints for FSDP (ZeRO-3) parameters (port of
``repro.sharding.constraint``).

Model code calls ``constrain_params(subtree, key)`` on each layer slice
it is about to use (and on the tables, the norms and the other
top-level leaves it reads); the step builder installs a hook that puts
every leaf of the subtree into its layout with the data axes removed:
whole over the data axes, split over "model" as its tensor-parallel
spec says.  Without a hook installed the call is a no-op, so pure model
use (tests, examples, one card) is unaffected.

The port has no partitioner, so the layout is a per-rank fact: on a
rank, a leaf "in the data-free layout" is its block over the model
axis.  The mesh train step hands the model its round tree in that
layout (each rank's model blocks, gathered over data once a round where
ZeRO-3 splits them), so the hook (:func:`make_gather_hook`) brings a
leaf there from either of two layouts, told apart by shape:

* the leaf at rest (split over data and model) — gathered over the data
  axes (:func:`repro_torch.sharding.collectives.gather_from_data`);
* already the model block — unchanged (JAX's constraint is idempotent).

The whole-tree key "" (the per-agent gradient and the lookahead probe,
which JAX pins to the data-free layout) takes each leaf of a per-agent
tree (leading agent dims allowed) to its model block: a global leaf is
sliced, a block kept.  The gradient with respect to the round's blocks
is that layout already, and the comm epilogue keeps it
(:mod:`repro_torch.sharding.blocks`): no step makes a per-agent leaf
whole.

Where the model ranks split the tokens (``split``: ``seq_shard``'s
chunks of the sequence, ``inner_batch_shard``'s rows of each agent's
batch), each rank's use of a weight gives only its tokens' share of the
gradient, so the hook sums it over "model": a leaf that every model
rank holds whole is used as it is with its cotangent summed
(:func:`repro_torch.sharding.collectives.copy_over`), and under
``"rows"`` a leaf that "model" splits is gathered whole at its use, its
cotangent summed over "model" and cut back to the block
(:func:`~repro_torch.sharding.collectives.gather_model`).

Activations get the same treatment through ``constrain_act``; training
installs no activation hook (the JAX package installs one for serving
only).  A serving step on a mesh installs :func:`make_act_hook`'s: the
rank holds its rows of the batch, so the hook acts over "model" alone.
It brings an activation that the caller hands it whole, or in the
tensor-parallel layout the model produced (the rank's heads, kv heads,
``ff`` columns), into the layout the plan's rules give each of its
logical axes: a dim the rules split it slices to the rank's block (the
rank's heads where ``decode_heads`` holds "model", the rank's slice of
cache positions where ``cache_seq`` does), and a dim they leave whole
that holds a model block it gathers (the flash-decoding layout's
queries and new keys, made whole over "model").  The cache's layout
decides the decode attention's (:func:`cache_positions`).
"""
from __future__ import annotations

import contextvars
from typing import Callable, Optional

_HOOK: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "fsdp_gather_hook", default=None
)
_ACT_HOOK: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "act_constraint_hook", default=None
)

from repro_torch.sharding.rules import DATA_AXES


def set_act_hook(fn: Optional[Callable]):
    """fn(x, logical_axes) -> constrained x (or None to clear)."""
    return _ACT_HOOK.set(fn)


def reset_act_hook(token) -> None:
    _ACT_HOOK.reset(token)


def constrain_act(x, logical_axes, whole=None):
    """Pin an activation to the plan's sharding for ``logical_axes``.
    ``whole`` is its shape whole over "model" (default ``x.shape``: ``x``
    is whole); each dim of ``x`` is that size or this rank's block of
    it.  No-op unless a hook is installed."""
    fn = _ACT_HOOK.get()
    return fn(x, logical_axes, whole) if fn is not None else x


def cache_positions(local: int, cross: bool = False):
    """``(offset, length)``: where this rank's ``local`` cache slots start
    in the whole cache, and the whole cache's length (``(0, local)``
    unless a serving hook splits the positions over "model").
    ``cross``: the slots of an encoder-decoder's cross-attention cache
    (the encoder frames), else of the self-attention cache."""
    fn = _ACT_HOOK.get()
    positions = getattr(fn, "positions", None)
    return (0, local) if positions is None else positions(local, cross)


def make_act_hook(mesh, rules, *, cache_len: Optional[int] = None,
                  cross_len: Optional[int] = None):
    """The activation hook of a serving plan on ``mesh`` (the module
    doc).  ``cache_len`` is the whole KV cache's length (its slots) and
    ``cross_len`` an encoder-decoder's cross-attention cache's (its
    frames), for :func:`cache_positions`: the positions are split where
    the rules put ``cache_seq`` on "model" and the model axis divides
    them.  A gather is one ``all_reduce`` over "model" of the
    zero-padded block (tag ``act_gather``)."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import NamedSharding, resolve_pspec

    model_rules = strip_data_axes(rules)
    n = mesh.shape.get("model", 1)
    axis = C.ModelAxis(mesh) if n > 1 else None

    def hook(x, logical_axes, whole=None):
        whole = tuple(x.shape) if whole is None else tuple(whole)
        if axis is None:
            return x
        target = NamedSharding(mesh, resolve_pspec(whole, logical_axes,
                                                   model_rules, mesh))
        block = target.shard_shape(whole)
        have = tuple(x.shape)
        # a dim the layout keeps whole that x holds a model block of is
        # gathered first (every rank's block over the other dims is
        # the same one), then what the layout splits is sliced
        grow = [d for d in range(x.ndim) if have[d] != whole[d]
                and have[d] * n == whole[d] and block[d] == whole[d]]
        if len(grow) > 1:
            raise ValueError(f"activation hook: {have} holds a model block "
                             f"of {whole} in more than one dim")
        if grow:
            d = grow[0]
            index = tuple(slice(axis.index * have[d],
                                (axis.index + 1) * have[d]) if i == d
                          else slice(0, have[i]) for i in range(x.ndim))
            x = C.gather_from_data(
                x, index, tuple(whole[i] if i == d else have[i]
                                for i in range(x.ndim)),
                axis.where("act_gather"))
        cut = tuple(s if h == w != b else slice(None)
                    for h, w, b, s in zip(x.shape, whole, block,
                                          target.slices(whole)))
        if any(s != slice(None) for s in cut):
            x = x[cut]
        if tuple(x.shape) != block:
            raise ValueError(
                f"activation hook: a tensor of shape {have} is neither "
                f"whole ({whole}) nor a model block of it in each dim; the "
                f"layout of {tuple(logical_axes)} is {block}")
        return x

    def splits(length):
        return (axis is not None and length is not None and bool(
            resolve_pspec((length,), ("cache_seq",), model_rules, mesh)))

    split = {False: splits(cache_len), True: splits(cross_len)}

    def positions(local: int, cross: bool = False):
        whole = cross_len if cross else cache_len
        if not split[cross]:
            return 0, local
        if local * n != whole:
            raise ValueError(f"a cache of {local} slots is not 1/{n} of "
                             f"the plan's {whole}")
        return axis.index * local, whole

    hook.positions = positions
    return hook


def set_gather_hook(fn: Optional[Callable]):
    """fn(params_subtree, key: str) -> constrained subtree (or None to
    clear).  Returns the context token (``_HOOK.reset`` restores)."""
    return _HOOK.set(fn)


def reset_gather_hook(token) -> None:
    _HOOK.reset(token)


def constrain_params(subtree, key: str):
    fn = _HOOK.get()
    return fn(subtree, key) if fn is not None else subtree


def strip_data_axes(rules: dict) -> dict:
    """The rule table with the data axes removed from every target."""
    def strip(ax):
        if ax is None:
            return None
        if isinstance(ax, str):
            return None if ax in DATA_AXES else ax
        kept = tuple(a for a in ax if a not in DATA_AXES)
        return kept if kept else None

    return {k: strip(v) for k, v in rules.items()}


def make_gather_hook(mesh, axes_tree, rules, shapes_tree,
                     split: Optional[str] = None):
    """Build the hook used by the step builders.

    ``axes_tree`` is the model's logical-axes tree, ``rules`` the plan's
    rule table and ``shapes_tree`` the global parameter tree (or its
    ``meta`` stand-in), whose shapes tell the layouts apart.  A key ""
    is the whole (per-agent) tree; a layer slice loses the leading
    "layer" axis.  ``split`` is what of the tokens the model ranks split
    (None, ``"seq"`` or ``"rows"``: the module doc)."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (
        NamedSharding,
        map_axes,
        resolve_pspec,
        split_spec,
    )

    gather_rules = strip_data_axes(rules)
    split_model = mesh.shape.get("model", 1) > 1
    summed = split if split_model else None

    def model_of(axes, glob):
        """The model-axis sharding of a leaf of global shape ``glob``
        (None where every model rank holds it whole)."""
        model = NamedSharding(mesh, resolve_pspec(glob, axes, gather_rules,
                                                  mesh))
        used = model.axes
        return model if used and mesh.axes_size(used) > 1 else None

    def one(axes, leaf, ref):
        glob, axes = tuple(ref.shape), tuple(axes)
        if len(axes) == leaf.ndim + 1 and axes[0] == "layer":
            axes, glob = axes[1:], glob[1:]
        model = model_of(axes, glob)
        block = glob if model is None else model.shard_shape(glob)
        shape = tuple(leaf.shape)
        if shape != block:
            spec_r = resolve_pspec(glob, axes, rules, mesh)
            rest = NamedSharding(mesh, split_spec(spec_r)[0])
            if shape != rest.shard_shape(block):
                raise ValueError(
                    f"gather hook: a leaf of shape {shape} is neither the "
                    f"model block {block} nor the block at rest "
                    f"{NamedSharding(mesh, spec_r).shard_shape(glob)}")
            leaf = C.gather_from_data(leaf, rest.slices(block), block,
                                      C.Where(mesh, rest.axes,
                                              "fsdp_gather"))
        if summed is None:
            return leaf
        if model is None:
            # whole on every model rank, used on this rank's tokens
            return C.copy_over(leaf, C.Where(mesh, ("model",),
                                             f"{summed}_param_grad"))
        if summed == "rows":
            return C.gather_model(leaf, model.slices(glob), glob,
                                  C.Where(mesh, ("model",), "rows_gather"))
        return leaf

    def trailing(leaf, glob):
        return tuple(leaf.shape[leaf.ndim - len(glob):])

    def to_block(axes, leaf, ref):
        glob = tuple(ref.shape)
        model = model_of(tuple(axes), glob)
        if model is None or trailing(leaf, glob) == model.shard_shape(glob):
            return leaf
        if trailing(leaf, glob) != glob:
            raise ValueError(f"gather hook: a per-agent leaf of shape "
                             f"{tuple(leaf.shape)} ends in neither {glob} "
                             f"nor its model block")
        return leaf[(Ellipsis,) + model.slices(glob)]

    def hook(subtree, key: str):
        if not key:
            if not split_model:
                return subtree
            return map_axes(to_block, axes_tree, subtree, shapes_tree)
        ax_sub, sh_sub = axes_tree, shapes_tree
        for part in key.split("."):
            ax_sub, sh_sub = ax_sub[part], sh_sub[part]
        return map_axes(one, ax_sub, subtree, sh_sub)

    return hook
