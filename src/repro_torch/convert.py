"""Carry weights, state and data from the JAX package into the port.

Inputs are the JAX package's values with numpy-convertible leaves
(``np.asarray`` of a JAX array, or ``jax.device_get`` output): a
``TrainState``, a ``Problem``, a round's batch, an LM's parameters and
serving cache.  Nothing here imports
JAX; the objects are read through their attributes and ``np.asarray``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.api import TrainState
from repro_torch.core.regression import Problem
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import MambaState
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.utils.device import DeviceLike, resolve_device


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


def _tree(x):
    """A JAX mapping of arrays as a dict; an array (or None) as it is."""
    return dict(x) if isinstance(x, Mapping) else x


def state_from_jax(state, *, device: DeviceLike = "cuda") -> TrainState:
    """A JAX ``TrainState`` (params, opt state, EF memory, controller
    rows, channel state) as the port's.  The channel state is the bare
    ``(A, NET_WIDTH)`` rows or the ``(rows, {"meta", "buf"})`` pair of a
    payload-buffering channel, carried in the same form."""
    return TrainState(
        step=int(np.asarray(state.step)),
        params=to_torch(_tree(state.params), device),
        opt_state=to_torch(state.opt_state, device),
        ef_memory=to_torch(_tree(state.ef_memory), device),
        ctrl_state=to_torch(state.ctrl_state, device),
        net_state=to_torch(_net(state.net_state), device),
    )


def _net(net):
    """The channel slot with its line's mappings as dicts."""
    if isinstance(net, tuple):
        rows, line = net
        return rows, {k: _tree(v) for k, v in dict(line).items()}
    return net


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


def params_from_jax(params, *, device: DeviceLike = "cuda"):
    """An LM's JAX parameter tree (nested dicts of arrays, the ``blocks``
    leaves stacked on a leading layer axis) as the port's: the same
    paths, shapes, layouts (``wq (d,H,hd)``, ``wo (H,hd,d)``, ...) and
    dtypes, leaf for leaf."""
    if not isinstance(params, dict):
        raise TypeError(f"expected a dict of parameters, got "
                        f"{type(params).__name__}")
    return to_torch(params, device)


def cache_from_jax(cache, *, device: DeviceLike = "cuda"):
    """A JAX serving cache as the port's: a ``KVCache`` (per layer, or
    stacked on a layer axis); the hybrid's ``{"mamba": MambaState,
    "attn": KVCache}`` (states stacked over layers, caches over
    shared-attention sites); the ssm's ``{"mlstm": MLSTMState, "slstm":
    SLSTMState}`` (stacked over pairs); or the audio family's ``{"self":
    KVCache, "cross_k", "cross_v"}``."""
    if isinstance(cache, Mapping):
        if "mamba" in cache:
            m = cache["mamba"]
            return {"mamba": MambaState(ssm=to_torch(m.ssm, device),
                                        conv=to_torch(m.conv, device)),
                    "attn": cache_from_jax(cache["attn"], device=device)}
        if "mlstm" in cache:
            return {"mlstm": MLSTMState(*to_torch(tuple(cache["mlstm"]),
                                                  device)),
                    "slstm": SLSTMState(*to_torch(tuple(cache["slstm"]),
                                                  device))}
        return {"self": cache_from_jax(cache["self"], device=device),
                "cross_k": to_torch(cache["cross_k"], device),
                "cross_v": to_torch(cache["cross_v"], device)}
    return KVCache(k=to_torch(cache.k, device), v=to_torch(cache.v, device),
                   pos_ids=to_torch(cache.pos_ids, device))
