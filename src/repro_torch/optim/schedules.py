"""Learning-rate schedules (port of ``repro.optim.schedules``).

A schedule maps the round index (a Python int) to the step size as an
fp32 value: each is computed in numpy float32 with the JAX package's
operations in its order, so the two packages feed their optimizers the
same rate.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_F = np.float32


def constant(lr: float) -> Schedule:
    def sched(step):
        return float(_F(lr))
    return sched


def linear_warmup(base: Schedule, warmup_steps: int) -> Schedule:
    def sched(step):
        if warmup_steps <= 0:
            return base(step)
        warm = min(_F(1.0), _F(step + 1) / _F(warmup_steps))
        return float(_F(base(step)) * warm)
    return sched


def _progress(step: int, total_steps: int):
    return np.clip(_F(step) / _F(max(total_steps, 1)), _F(0.0), _F(1.0))


def cosine(lr: float, total_steps: int, final_frac: float = 0.1) -> Schedule:
    def sched(step):
        t = _progress(step, total_steps)
        cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * t))
        return float(_F(lr) * (_F(final_frac) + _F(1 - final_frac) * cos))
    return sched


def linear_decay(lr: float, total_steps: int,
                 final_frac: float = 0.0) -> Schedule:
    def sched(step):
        t = _progress(step, total_steps)
        return float(_F(lr) * (_F(1.0) - _F(1.0 - final_frac) * t))
    return sched


def from_config(cfg) -> Schedule:
    if cfg.schedule == "constant":
        base = constant(cfg.lr)
    elif cfg.schedule == "cosine":
        base = cosine(cfg.lr, cfg.total_steps)
    elif cfg.schedule == "linear":
        base = linear_decay(cfg.lr, cfg.total_steps)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return linear_warmup(base, cfg.warmup_steps)
