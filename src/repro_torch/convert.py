"""Carry weights, state and data from the JAX package into the port.

Inputs are the JAX package's values with numpy-convertible leaves
(``np.asarray`` of a JAX array, or ``jax.device_get`` output): a
``TrainState``, a ``Problem``, a round's batch.  Nothing here imports
JAX; the objects are read through their attributes and ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import TrainState
from repro_torch.core.regression import Problem
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.todo import todo


def to_torch(tree, device: DeviceLike):
    """Every array leaf of a (dict / tuple / list / NamedTuple) tree as a
    tensor on ``device``, with its dtype; ``None`` stays ``None``."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(np.asarray(x))).to(dev)

    return conv(tree)


def to_numpy(tree):
    """The inverse direction, for comparisons: tensors → numpy arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def state_from_jax(state, *, device: DeviceLike = "cuda") -> TrainState:
    """A JAX ``TrainState`` (params, opt state, EF memory) as the port's."""
    if state.ctrl_state is not None:
        raise todo("controller state (adaptive triggers)", "queue 1 item 4")
    if state.net_state is not None:
        raise todo("channel state (lossy wires)", "queue 1 item 7")
    return TrainState(
        step=int(np.asarray(state.step)),
        params=to_torch(dict(state.params), device),
        opt_state=to_torch(state.opt_state, device),
        ef_memory=(None if state.ef_memory is None
                   else to_torch(dict(state.ef_memory), device)),
    )


def problem_from_jax(problem, *, device: DeviceLike = "cuda") -> Problem:
    """A JAX linreg ``Problem`` as the port's, on ``device``."""
    return Problem(
        sigma_diag=to_torch(problem.sigma_diag, device),
        w_star=to_torch(problem.w_star, device),
        noise_std=float(problem.noise_std),
        eps=float(problem.eps),
        n_samples=int(problem.n_samples),
        num_agents=int(problem.num_agents),
    )
