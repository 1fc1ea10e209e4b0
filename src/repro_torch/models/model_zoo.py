"""Model facade (port of ``repro.models.model_zoo``).

``build(cfg)`` returns a :class:`Model` bundling the init / forward /
loss / decode closures of every family.  The workload specs and axes
(``input_specs``/``input_axes``/``runs_shape``) belong to the dry-run,
which the port has not reached.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.utils.todo import not_ported


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable                 # (gen, dtype=None) -> (params, axes)
    forward: Callable              # (params, batch) -> (logits, aux)
    loss_fn: Callable              # (params, batch) -> scalar
    init_cache: Callable           # (batch, cache_len, device, dtype)
    decode_step: Callable          # (params, cache, tokens, pos)
    prefill: Callable              # (params, batch, cache_len)


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(T.init, cfg),
        forward=functools.partial(T.forward, cfg),
        loss_fn=functools.partial(T.loss_fn, cfg),
        init_cache=functools.partial(D.init_cache, cfg),
        decode_step=functools.partial(D.decode_step, cfg),
        prefill=functools.partial(D.prefill, cfg),
    )


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Dense archs get a first-class SWA variant for ``long_500k``."""
    if cfg.subquadratic or cfg.arch_type == "audio":
        return cfg
    return cfg.replace(swa_window=4096)


__getattr__ = not_ported(__name__, {
    "input_specs": "queue 1 item 12",
    "input_axes": "queue 1 item 12",
    "runs_shape": "queue 1 item 12",
})
