"""Triggers from a legacy :class:`TriggerConfig`.

The port of ``repro.core.triggers``: :func:`make_trigger` builds a
trigger function from a ``TriggerConfig`` (including the documented
``gain_exact`` / ``gain_estimated`` linear-regression kinds) through the
registry, and the trigger types and linreg closed forms re-export.  New
code builds policies instead::

    from repro_torch.comm import CommPolicy
    trig = CommPolicy.parse("gain_lookahead(lam=0.1)").build_trigger(
        loss_fn=loss_fn, probe_eps=eps)
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.comm.triggers import (  # noqa: F401  (public re-exports)
    TRIGGERS,
    TriggerContext,
    TriggerFn,
    TriggerOutput,
    build_trigger,
    linreg_gain_estimated,
    linreg_gain_exact,
)
from repro_torch.configs.base import TriggerConfig


def make_trigger(
    cfg: TriggerConfig,
    *,
    loss_fn: Optional[Callable] = None,
    probe_eps: float = 1e-2,
    use_kernel: bool = False,
    oracle: Optional[tuple] = None,
) -> TriggerFn:
    """Build a trigger function from a :class:`TriggerConfig`.

    ``loss_fn(params, batch) -> scalar`` is the *local empirical* loss
    (needed by the gain triggers); ``probe_eps`` is the ε of the probe
    step ``w − ε g``; ``use_kernel`` sets ``kernel=true`` where the
    trigger has it; ``oracle`` is the ``(Σ, w*)`` pair of ``gain_exact``.
    The trigger speaks the port's agent-batched protocol
    (:mod:`repro_torch.comm.triggers`).
    """
    from repro_torch.comm.policy import trigger_spec_from_config

    spec = trigger_spec_from_config(cfg, use_kernel=use_kernel)
    return build_trigger(
        spec, TriggerContext(loss_fn=loss_fn, probe_eps=probe_eps,
                             oracle=oracle))
