"""Shared neural-net layers: norm, RoPE, sinusoidal positions, the
SwiGLU and GELU MLPs, embeddings (port of
``repro.models.layers``).

All functions are pure; parameters come in as trees built by
:class:`repro_torch.models.param.Scope`.  The matrix products are plain
``torch.matmul`` (the JAX package leaves them to XLA, outside Pallas).
The losses here are the plain ones; the model's loss runs the
``fused_ce`` kernel (:func:`repro_torch.models.transformer.loss_fn`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives as C
from repro_torch.utils.remat import checkpoint


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, whole: int,
                   tag: str, eps: float = 1e-5):
    """``rms_norm`` over a last dim of size ``whole`` of which ``x`` and
    ``weight`` hold this rank's block (a model axis splits it): the sum
    of squares summed over "model", forward and backward
    (:func:`repro_torch.sharding.collectives.sum_over_model`: each rank's
    cotangent of it comes from its own block, so an identity backward
    would give a right forward and a wrong gradient); ``rms_norm``
    where ``x`` is whole."""
    if x.shape[-1] == whole:
        return rms_norm(x, weight, eps)
    dt = x.dtype
    xf = x.float()
    var = C.sum_over_model(xf.square().sum(-1, keepdim=True), tag) / whole
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def build_rms_norm(scope, name: str, dim: int, axis: str = "embed"):
    return scope.param(name, (dim,), (axis,), init="ones")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> torch.Tensor:
    """(seq_len, dim) sinusoidal position table: sin in the even
    columns, cos in the odd, at rates exp(−2i·ln(10000)/dim), in fp32
    as the JAX package forms it."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    rate = -torch.full((), 10000.0, device=device).log() / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * rate)
    pe = torch.zeros((seq_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def build_swiglu(scope, d_model: int, d_ff: int):
    scope.param("w_gate", (d_model, d_ff), ("embed", "ff"))
    scope.param("w_up", (d_model, d_ff), ("embed", "ff"))
    scope.param("w_down", (d_ff, d_model), ("ff", "embed"))


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` at the two dtypes' promotion, as jnp's ``@`` computes it
    (weights held at another dtype than the activations)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(_matmul(x, p["w_gate"]))
    return _matmul(gate * _matmul(x, p["w_up"]), p["w_down"])


def build_gelu_mlp(scope, d_model: int, d_ff: int):
    scope.param("w_in", (d_model, d_ff), ("embed", "ff"))
    scope.param("b_in", (d_ff,), ("ff",), init="zeros")
    scope.param("w_out", (d_ff, d_model), ("ff", "embed"))
    scope.param("b_out", (d_model,), ("embed",), init="zeros")


def gelu_mlp(p, x: torch.Tensor, out_bias: bool = True) -> torch.Tensor:
    """GELU in its tanh form, ``jax.nn.gelu``'s default.  ``out_bias=
    False`` leaves ``b_out`` out (a row-parallel rank's share, which the
    caller sums before it adds the bias)."""
    h = F.gelu(_matmul(x, p["w_in"]) + p["b_in"], approximate="tanh")
    out = _matmul(h, p["w_out"])
    return out + p["b_out"] if out_bias else out


def build_embedding(scope, vocab: int, d_model: int, name: str = "embedding"):
    return scope.param(name, (vocab, d_model), ("vocab", "embed"), scale=0.02)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype):
    return table[tokens].to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """logits = x @ tableᵀ; fp32 for a stable softmax."""
    return x.float() @ table.float().T


def _masked_mean(nll: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Mean token-level CE.  logits (..., V) fp32, labels (...) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def cross_entropy_fused(table: torch.Tensor, x: torch.Tensor,
                        labels: torch.Tensor, mask=None, chunk: int = 512):
    """Mean token CE from hidden states (B, S, D), one sequence chunk of
    fp32 logits (B, chunk, V) at a time, each chunk checkpointed as in
    the JAX version: its backward recomputes the chunk's logits, so one
    chunk's tile is live, not all of them.  (The model's loss is the
    ``fused_ce`` kernel's, whose backward recomputes the logits chunk by
    chunk as well.)"""
    b, s, _ = x.shape
    if s % chunk:
        chunk = s

    @checkpoint
    def chunk_nll(table, x_c, y_c, m_c):
        logits = x_c.float() @ table.float().T
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y_c.long()[..., None])[..., 0]
        nll = logz - gold
        if m_c is None:
            return nll.sum(), nll.numel()
        return (nll * m_c).sum(), m_c.sum()

    tot = cnt = 0.0
    for c0 in range(0, s, chunk):
        m = None if mask is None else mask[:, c0:c0 + chunk].float()
        t, c = chunk_nll(table, x[:, c0:c0 + chunk],
                         labels[:, c0:c0 + chunk], m)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(torch.as_tensor(cnt, dtype=torch.float32,
                                             device=x.device), min=1.0)

