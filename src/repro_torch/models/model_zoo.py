"""Model facade and workload input specs (port of
``repro.models.model_zoo``).

``build(cfg)`` returns a :class:`Model` bundling the init / forward /
loss / decode closures of every family.  ``input_specs(cfg, shape,
...)`` gives the inputs the dry-run traces against as empty ``meta``
tensors (the JAX package's ``jax.ShapeDtypeStruct`` stand-ins), and
``input_axes`` the matching logical-axis tree:

* train shapes  → ``train_step`` inputs, leading *agent* axis
* prefill       → full-sequence forward inputs
* decode shapes → ``serve_step`` inputs: ONE token + a ``seq_len`` cache
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.whisper_medium import DECODER_LEN
from repro_torch.models import decode as D
from repro_torch.models import transformer as T


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable                 # (gen=None, abstract=False, dtype=None)
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


# ======================================================================
# Workload specs (meta stand-ins, no allocation)
# ======================================================================

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(
    cfg: ModelConfig,
    shape: InputShape,
    *,
    num_agents: int = 1,
    compute_dtype=None,
) -> Dict[str, Any]:
    """Inputs for the step function this workload traces, as ``meta``
    tensors.

    train/prefill → batch dict (train adds the leading agent axis);
    decode        → {"tokens", "pos", "cache"}.
    """
    dt = compute_dtype or T.dtype_of(cfg.compute_dtype)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    if shape.kind in ("train", "prefill"):
        agents = num_agents if shape.kind == "train" else 1
        if B % agents:
            raise ValueError(f"global batch {B} does not split over "
                             f"{agents} agents")
        per = B // agents
        lead = (agents, per) if shape.kind == "train" else (B,)

        if cfg.arch_type == "audio":
            dec = min(S, DECODER_LEN)
            return {
                "frame_embeds": _meta(lead + (S, cfg.d_model), dt),
                "tokens": _meta(lead + (dec,), i32),
                "labels": _meta(lead + (dec,), i32),
            }
        specs = {
            "tokens": _meta(lead + (S,), i32),
            "labels": _meta(lead + (S,), i32),
        }
        if cfg.arch_type == "vlm":
            specs["patch_embeds"] = _meta(
                lead + (cfg.num_patches, cfg.d_model), dt)
        return specs

    # decode: one new token against a seq_len cache
    cache, _ = D.init_cache(cfg, B, S, device="meta", dtype=dt)
    return {
        "tokens": _meta((B, 1), i32),
        "pos": _meta((), i32),
        "cache": cache,
    }


def input_axes(cfg: ModelConfig, shape: InputShape, *, num_agents: int = 1):
    """Logical-axis tree matching ``input_specs`` (the mesh step's batch
    shardings read it)."""
    if shape.kind in ("train", "prefill"):
        lead = ("agent", "inner_batch") if shape.kind == "train" else ("batch",)
        if cfg.arch_type == "audio":
            return {
                "frame_embeds": lead + ("seq", "embed"),
                "tokens": lead + ("seq",),
                "labels": lead + ("seq",),
            }
        axes = {"tokens": lead + ("seq",), "labels": lead + ("seq",)}
        if cfg.arch_type == "vlm":
            axes["patch_embeds"] = lead + ("patch", "embed")
        return axes

    _, cache_axes = D.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
    return {
        "tokens": ("batch", None),
        "pos": (),
        "cache": cache_axes,
    }


def runs_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Assignment skip rules. Returns (run?, reason)."""
    if shape.name == "long_500k":
        if cfg.arch_type == "audio":
            return False, (
                "whisper encoder is full-attention over frames by construction "
                "and the decoder context is architecturally capped at 448; a "
                "500k decoder cache has no meaningful interpretation"
            )
        if not cfg.subquadratic:
            return True, "runs with the sliding-window variant (swa_window=4096 override)"
    return True, ""


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Dense archs get a first-class SWA variant for ``long_500k``."""
    if cfg.subquadratic or cfg.arch_type == "audio":
        return cfg
    return cfg.replace(swa_window=4096)
