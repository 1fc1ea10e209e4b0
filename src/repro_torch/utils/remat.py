"""Rematerialisation: the port's ``jax.checkpoint``.

``checkpoint(fn)`` returns a function that computes ``fn`` but keeps
only its inputs for the backward pass; the backward runs ``fn`` again
and differentiates that run.  A model block wrapped in it holds its
input carry and (views of) its parameters between the forward and the
backward, not its activations.

``torch.utils.checkpoint`` cannot serve here: the train step takes its
gradients with ``torch.func.vmap(torch.func.grad_and_value(...))``,
and under that transform its non-reentrant mode raises (``torch.func``
has no saved-tensor hooks) and its reentrant mode too (its Function
has no ``setup_context``).  This checkpoint is an autograd Function in
the form ``torch.func`` composes with:

* ``setup_context`` saves the inputs, for reverse mode
  (``save_for_backward``) and for forward mode (``save_for_forward``);
* ``backward`` recomputes ``fn`` from them and pulls the output
  cotangents back, as ``torch.func.grad`` of Σ⟨output, cotangent⟩.  It
  is :func:`~repro_torch.kernels.autograd.first_order`: the recompute is
  not recorded for a second reverse pass (recorded, it would keep
  every block's activations alive again), while its ops still carry
  forward-mode tangents, so a Hessian-vector product (``torch.func.jvp`` of
  ``torch.func.grad``) runs through it.  Inside its own ``grad`` the
  recompute's backward runs with grad mode on, as the plain path's does
  under ``torch.func.grad`` (``silu``'s backward has another formula
  without it), so a rematerialised block's gradient is bitwise the
  plain block's; the inner level's graph goes when that ``grad``
  returns;
* ``jvp`` recomputes ``fn`` under ``torch.func.jvp``;
* ``generate_vmap_rule`` maps all three over a batch, so a kernel's own
  ``vmap`` rule inside ``fn`` still launches once per call.

``fn`` takes and returns trees (:mod:`repro_torch.utils.tree`): a
layer's parameter dict and the carry in, the carry (and an aux loss)
out.  Their tensor leaves pass through the Function; any other leaf
(an int, a float, ``None``) is held as it is.  Floating-point inputs
are differentiated; integer inputs (token ids, labels) are constants.
Every tensor ``fn`` reads comes in through its arguments: the Function
runs ``fn`` below the ``torch.func`` transforms that call it, and a
tensor created under one of them (even a constant such as the
positions' ``arange``) is wrapped at that transform's level, which
``fn`` cannot read from its closure.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.kernels.autograd import first_order
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

_TENSOR = object()  # marks a tensor leaf in a tree's skeleton


def _skeleton(tree):
    """``tree`` with each tensor leaf replaced by a marker: its
    structure and non-tensor leaves, holding no tensor."""
    return tree_map(
        lambda x: _TENSOR if isinstance(x, torch.Tensor) else x, tree)


def _fill(skeleton, tensors):
    """The tree of ``skeleton`` with its markers replaced, in leaf
    order, by ``tensors``."""
    it = iter(tensors)
    return tree_unflatten(skeleton, [next(it) if x is _TENSOR else x
                                     for x in tree_leaves(skeleton)])


def _tensor_leaves(tree):
    return tuple(x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def _differentiable(inputs):
    """``(positions, call)``: the positions of the floating-point
    inputs, and ``call(run, *floats)``, which runs ``run`` on the inputs
    with those replaced by ``floats``."""
    pos = [i for i, x in enumerate(inputs) if x.is_floating_point()]

    def call(run, *floats):
        full = list(inputs)
        for i, x in zip(pos, floats):
            full[i] = x
        return run(*full)

    return pos, call


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *inputs):
        return run(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, *tensors = inputs
        ctx.run = run
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)

    @staticmethod
    @first_order
    def backward(ctx, *cotangents):
        inputs = ctx.saved_tensors
        pos, call = _differentiable(inputs)

        def pulled(*floats):
            outs = call(ctx.run, *floats)
            return sum((o * c).sum() for o, c in zip(outs, cotangents))

        grads = [None] * len(inputs)
        for i, g in zip(pos, torch.func.grad(
                pulled, argnums=tuple(range(len(pos))))(
                    *(inputs[i] for i in pos))):
            grads[i] = g
        return (None, *grads)

    @staticmethod
    def jvp(ctx, _run_tangent, *tangents):
        inputs = ctx.saved_tensors
        pos, call = _differentiable(inputs)
        primals = tuple(inputs[i] for i in pos)
        dirs = tuple(torch.zeros_like(inputs[i]) if tangents[i] is None
                     else tangents[i] for i in pos)
        _, out = torch.func.jvp(functools.partial(call, ctx.run), primals,
                                dirs)
        return out


def checkpoint(fn: Callable) -> Callable:
    """``fn`` rematerialised in its backward: the same results, with
    only its inputs kept for the backward pass (``jax.checkpoint``)."""

    @functools.wraps(fn)
    def wrapped(*args):
        in_skel = _skeleton(args)
        out_skel = []

        def run(*tensors):
            out = fn(*_fill(in_skel, tensors))
            out_skel[:] = [_skeleton(out)]
            return _tensor_leaves(out)

        outs = _Checkpoint.apply(run, *_tensor_leaves(args))
        return _fill(out_skel[0], outs)

    return wrapped
