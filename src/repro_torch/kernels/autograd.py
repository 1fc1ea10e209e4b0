"""A first-order backward that keeps forward-mode tangents.

The LM kernels' backwards are plain PyTorch.  ``torch.func.grad`` runs
them with ``create_graph=True``, and recorded for a second reverse pass
they would keep every layer's recomputed score tiles alive (the train
step ran out of memory on an 80 GB card that way).  So they run under
``torch.no_grad()``: nothing of theirs is recorded for reverse mode,
and a second reverse pass sees their results as constants.

``torch.autograd.function.once_differentiable`` runs them that way too,
but then re-creates its outputs with ``detach()``, and ``detach()``
drops forward-mode tangents: a Hessian-vector product taken forward
over reverse (``torch.func.jvp`` of ``torch.func.grad``, the
``gain_quadratic`` trigger) silently came out as zero.  ``no_grad`` does
not apply to forward mode, so under :func:`first_order` the backward's
ops carry the outer tangent.  (Under ``torch.func``,
``once_differentiable`` did not raise on a second reverse pass either.)
"""
from __future__ import annotations

import functools

import torch


def first_order(backward):
    """Decorate an ``autograd.Function.backward``: run it without
    recording for reverse mode, keeping its forward-mode tangents."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        with torch.no_grad():
            return backward(ctx, *grads)

    return wrapper
