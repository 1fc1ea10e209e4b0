"""Optimizers as functional ``init``/``update`` pairs.

The port of ``repro.optim.optimizers`` (not ``torch.optim``, so the
update order matches the reference)::

    opt = sgd(lr)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params, step)
    params = tree_add_scaled(params, updates, 1.0)

Updates are *deltas to add*, cast back to the parameter dtype.  Only
plain SGD with a constant (optionally warmed-up) learning rate is
ported: the paper's eq. (3)/(6) update.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import numpy as np

from repro_torch.utils.todo import not_ported, todo
from repro_torch.utils.tree import tree_map

_OPTIM_ITEM = "queue 1 item 5"


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (updates, state)


def _schedule(cfg) -> Callable[[int], float]:
    """The config's learning-rate schedule as an fp32 value per step
    (``step`` is the Python round index)."""
    if cfg.schedule != "constant":
        raise todo(f"the {cfg.schedule!r} learning-rate schedule",
                   _OPTIM_ITEM)
    lr = np.float32(cfg.lr)
    warmup = int(cfg.warmup_steps)
    if warmup <= 0:
        return lambda step: float(lr)
    return lambda step: float(lr * min(
        np.float32(1.0), np.float32(step + 1) / np.float32(warmup)))


def sgd(lr: Union[float, Callable[[int], float]]) -> Optimizer:
    """Plain SGD — the paper's eq. (3)/(6) update."""
    sched = lr if callable(lr) else (lambda step: float(np.float32(lr)))

    def init(params):
        return ()

    def update(grads, state, params, step):
        s = sched(step)
        return tree_map(lambda g: (-s * g).to(g.dtype), grads), state

    return Optimizer(init, update)


def from_config(cfg) -> Optimizer:
    """Build the optimizer described by a :class:`TrainConfig`."""
    if cfg.optimizer != "sgd":
        raise todo(f"the {cfg.optimizer!r} optimizer", _OPTIM_ITEM)
    if cfg.grad_clip > 0:
        raise todo("gradient clipping", _OPTIM_ITEM)
    return sgd(_schedule(cfg))


__getattr__ = not_ported(__name__, {
    name: _OPTIM_ITEM
    for name in ("clip_by_global_norm", "momentum", "AdamState", "adamw",
                 "with_grad_clip")
})
