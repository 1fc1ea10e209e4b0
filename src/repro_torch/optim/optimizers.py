"""Optimizers (SGD / momentum / AdamW) as functional ``init``/``update``
pairs over trees of tensors.

The port of ``repro.optim.optimizers`` (not ``torch.optim``, so the
update order matches the reference)::

    opt = adamw(schedule, ...)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params, step)
    params = tree_add_scaled(params, updates, 1.0)

Updates are *deltas to add*, cast back to the parameter dtype.  All
moments are fp32 whatever the parameter dtype.  ``step`` is the round
index, a Python int; schedules turn it into an fp32 rate
(:mod:`repro_torch.optim.schedules`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map

Schedule = Callable[[int], float]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (updates, state)


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: float(np.float32(lr))


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``
    (``norm``: that norm where the caller has it, as for a tree whose
    leaves are blocks of a larger one)."""
    if max_norm <= 0:
        return grads
    if norm is None:
        norm = torch.sqrt(sum(g.float().square().sum()
                              for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def sgd(lr: Union[float, Schedule]) -> Optimizer:
    """Plain SGD — the paper's eq. (3)/(6) update."""
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        s = sched(step)
        return tree_map(lambda g: (-s * g).to(g.dtype), grads), state

    return Optimizer(init, update)


def momentum(lr: Union[float, Schedule], beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return tree_map(_zeros_f32, params)

    def update(grads, m, params, step):
        s = sched(step)
        m = tree_map(lambda mi, g: beta * mi + g.float(), m, grads)
        if nesterov:
            upd = tree_map(
                lambda mi, g: (-s * (beta * mi + g.float())).to(g.dtype),
                m, grads)
        else:
            upd = tree_map(lambda mi, g: (-s * mi).to(g.dtype), m, grads)
        return upd, m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return AdamState(mu=tree_map(_zeros_f32, params),
                         nu=tree_map(_zeros_f32, params))

    def update(grads, state, params, step):
        s = sched(step)
        t = np.float32(step + 1)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state.nu, grads)
        # bias corrections in fp32, as the reference forms them from an
        # fp32 step count
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)

        def upd(m, v, p):
            step_ = m / bc1 / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return (-s * step_).to(p.dtype)

        return tree_map(upd, mu, nu, params), AdamState(mu, nu)

    return Optimizer(init, update)


def with_grad_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    if max_norm <= 0:
        return opt

    def update(grads, state, params, step):
        return opt.update(clip_by_global_norm(grads, max_norm), state,
                          params, step)

    return Optimizer(opt.init, update)


def from_config(cfg) -> Optimizer:
    """Build the optimizer described by a :class:`TrainConfig`."""
    from repro_torch.optim.schedules import from_config as sched_from_config

    sched = sched_from_config(cfg)
    if cfg.optimizer == "sgd":
        opt = sgd(sched)
    elif cfg.optimizer == "momentum":
        opt = momentum(sched, beta=cfg.beta1)
    elif cfg.optimizer == "adamw":
        opt = adamw(sched, b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps,
                    weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return with_grad_clip(opt, cfg.grad_clip)
