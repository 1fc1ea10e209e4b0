"""Training configuration dataclasses (copies of ``repro.configs.base``).

Only the training-side configs the triggered step reads are here; the
model-zoo configs belong to the LM path, which the port has not reached.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

from repro_torch.utils.todo import not_ported


@dataclass(frozen=True)
class TriggerConfig:
    """The paper's communication trigger, as a legacy policy config.

    Every kind resolves through the ``repro_torch.comm.TRIGGERS``
    registry (new code should use a CommPolicy spec string instead —
    see ``TrainConfig.comm``).
    """

    kind: str = "gain_lookahead"
    lam: float = 0.0       # λ  (gain triggers)
    mu: float = 0.0        # μ  (grad-norm trigger)
    period: int = 1        # (periodic trigger)
    # diminishing-λ schedules (paper's post-eq.(23) remark):
    #   const | inv_t (λ/(1+k)) | geometric (λ·rate^k)
    lam_decay: str = "const"
    lam_decay_rate: float = 0.95


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    optimizer: str = "adamw"  # sgd | momentum | adamw
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 0.0
    warmup_steps: int = 0
    schedule: str = "constant"  # constant | cosine | linear
    total_steps: int = 1000
    num_agents: int = 2
    microbatches: int = 1  # gradient accumulation per agent (memory knob)
    trigger: TriggerConfig = TriggerConfig(kind="always")
    # The communication policy as a spec string — e.g.
    # "gain_lookahead(lam=0.1,decay=inv_t)|topk(0.05)|int8+ef" — or a
    # tuple of specs for per-agent heterogeneous networks.  When set it
    # supersedes `trigger`.
    comm: Optional[Union[str, Tuple[str, ...]]] = None
    seed: int = 0


__getattr__ = not_ported(__name__, {
    name: "queue 1 item 10"
    for name in ("MoEConfig", "SSMConfig", "XLSTMConfig", "ModelConfig",
                 "InputShape", "SHAPES", "ShardingConfig")
})
