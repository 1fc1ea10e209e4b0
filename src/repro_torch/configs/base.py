"""Configuration dataclasses (copies of ``repro.configs.base``).

The model configs (``ModelConfig`` and its sub-configs), the workload
shapes the dry-run traces (``SHAPES``) and the training-side configs
the triggered step reads, and the mesh's ``ShardingConfig``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (per-layer)."""

    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD sub-config."""

    state_dim: int
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM sub-config: blocks alternate mLSTM / sLSTM pairs."""

    slstm_proj_factor: float = 1.333
    mlstm_proj_factor: float = 2.0
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    """A full architecture description (assigned-pool exact numbers)."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention features
    qk_norm: bool = False
    swa_window: Optional[int] = None  # sliding-window size; None = full attn
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): one *shared* attention block applied every N layers
    shared_attn_every: int = 0
    # encoder-decoder (whisper): encoder layer count; frontend is a stub
    encoder_layers: int = 0
    # vlm (phi-3-vision): number of prepended image-patch embeddings (stub)
    num_patches: int = 0
    # memory/perf knobs of the JAX package: remat (every block body
    # rematerialised in the backward, repro_torch.utils.remat) and the
    # blockwise attention tile (non-causal attention only: the port's
    # causal attention kernel never forms the score tile it bounds)
    remat: bool = False
    attn_q_block: Optional[int] = None
    # dtypes (strings, as in the JAX package)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # citation for the assigned config
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.num_heads)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this config decode with a sub-quadratic / bounded state?"""
        return (self.arch_type in ("ssm", "hybrid")
                or self.swa_window is not None)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Closed-form parameter count estimate (matches init to ~1%)."""
        d, v, hd = self.d_model, self.vocab_size, self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = (d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                + (self.num_heads * hd) * d)
        if self.moe is not None:
            ff_dense = 3 * d * self.d_ff if self.d_ff else 0
            ff = (self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                  + d * self.moe.num_experts)
            ff += self.moe.num_shared_experts * 3 * d * self.moe.d_ff_expert
            per_layer = attn + ff + ff_dense
        elif self.arch_type == "ssm":
            e = self.ssm.expand if self.ssm else 2
            per_layer = 2 * e * d * d + e * d * (
                2 * (self.ssm.state_dim if self.ssm else 64))
        else:
            per_layer = attn + 3 * d * self.d_ff
        total = emb + self.num_layers * per_layer
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 2 * d * self.d_ff + attn)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE activates top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_moe = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        active_moe = ((self.moe.experts_per_token
                       + self.moe.num_shared_experts)
                      * 3 * d * self.moe.d_ff_expert)
        return (self.param_count()
                - self.num_layers * (full_moe - active_moe)
                - self.num_layers * self.moe.num_shared_experts
                * 3 * d * self.moe.d_ff_expert)


@dataclass(frozen=True)
class InputShape:
    """An assigned (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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


@dataclass(frozen=True)
class ShardingConfig:
    """Mesh-axis assignment. Axis names must exist in the active mesh."""

    data_axes: Tuple[str, ...] = ("data",)       # batch / agent axes
    model_axes: Tuple[str, ...] = ("model",)     # tensor-parallel axes
    fsdp: bool = False                           # shard params over data_axes
    agent_axes: Tuple[str, ...] = ("data",)      # per-agent gradient axis
    remat: str = "none"                          # none | full | dots
