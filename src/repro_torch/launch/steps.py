"""Train-step construction: the triggered train step of an LM on one
card (port of ``repro.launch.steps``).

* ``plan_run`` fixes the run: the model config, the workload shape, the
  number of agents (the paper's m) and the :class:`TrainConfig`.  Its
  memory knobs are the JAX package's: ``remat`` checkpoints every block
  of the model (its backward recomputes the block's activations),
  ``attn_q_block`` bounds the score tile of non-causal attention (the
  causal kernel forms none), and ``microbatches`` sums each agent's loss
  over that many equal slices of its batch.
* ``build_train_step`` wires the model's loss into the event-triggered
  train step (:func:`repro_torch.core.api.make_triggered_train_step`).

On one card there is no mesh: no sharding rules, no FSDP gather hooks
and no fleet-sharded step, and the agent count is the caller's (default
1, the size of the JAX CLI's data axis on one device).  Every agent's
gradient and lookahead probe run batched on the card, through the
``swa_attention`` and ``fused_ce`` kernels.  ``build_prefill_step``,
``build_serve_step`` and ``lower_for`` belong to the dry-run (ROADMAP
queue 1 item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import (
    InputShape,
    ModelConfig,
    TrainConfig,
    TriggerConfig,
)
from repro_torch.core.api import make_triggered_train_step
from repro_torch.models import build, long_context_variant
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.todo import not_ported


@dataclass(frozen=True)
class RunPlan:
    cfg: ModelConfig
    shape: InputShape
    num_agents: int
    train_cfg: TrainConfig


def plan_run(
    cfg: ModelConfig,
    shape: InputShape,
    *,
    num_agents: int = 1,
    comm: Optional[object] = None,
    trigger: Optional[TriggerConfig] = None,
    optimizer: str = "sgd",
    lr: float = 1e-2,
    remat: bool = False,
    attn_q_block: Optional[int] = None,
    microbatches: int = 1,
) -> RunPlan:
    if shape.name == "long_500k":
        cfg = long_context_variant(cfg)
    if remat or attn_q_block:
        cfg = cfg.replace(remat=remat, attn_q_block=attn_q_block)
    trigger = trigger or TriggerConfig(kind="gain_lookahead", lam=0.0)
    if comm is not None and not isinstance(comm, str):
        from repro_torch.comm import CommPolicy

        # policies and per-agent lists as spec strings, so TrainConfig
        # stays a hashable frozen dataclass
        comm = (str(comm) if isinstance(comm, CommPolicy)
                else tuple(str(p) for p in comm))
    train_cfg = TrainConfig(
        lr=lr,
        optimizer=optimizer,
        num_agents=num_agents,
        microbatches=microbatches,
        trigger=trigger,
        comm=comm,
    )
    return RunPlan(cfg=cfg, shape=shape, num_agents=num_agents,
                   train_cfg=train_cfg)


def build_train_step(plan: RunPlan, *, compute_dtype: str,
                     device: DeviceLike = "cuda"):
    """``train_step(state, batch) -> (state, metrics)`` for the plan's
    model at ``compute_dtype`` on ``device``."""
    model = build(plan.cfg.replace(compute_dtype=compute_dtype))
    optimizer = opt_lib.from_config(plan.train_cfg)
    return make_triggered_train_step(model.loss_fn, optimizer,
                                     plan.train_cfg, device=device)


__getattr__ = not_ported(__name__, {
    "build_prefill_step": "queue 1 item 12",
    "build_serve_step": "queue 1 item 12",
    "lower_for": "queue 1 item 12",
})
