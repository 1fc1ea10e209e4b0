"""xLSTM blocks: the chunkwise mLSTM (matrix memory) and the recurrent
sLSTM (port of ``repro.models.xlstm``).

* **mLSTM** is a gated linear-attention recurrence, computed in its
  *chunkwise dual form*: masked matrix products within a chunk, and a
  Python loop across chunks that carries the (heads, hd, hd) matrix
  memory, as the JAX package's ``lax.scan`` does.  Its input gates are
  soft-capped at ``exp(min(ĩ, I_GATE_CAP))`` (the JAX package's
  documented deviation from running-max restabilisation); every other
  exponent is ≤ 0, so the chunked form is stable in fp32.
* **sLSTM** has a true elementwise recurrence: a Python loop over time
  with block-diagonal per-head recurrent weights and the paper's (m, n)
  exponential-gating stabilisers.  No kernel runs in it (the JAX
  package has none): a forward over S positions is S host iterations
  per layer.

Blocks alternate mLSTM / sLSTM (``num_layers`` = 24 → 12 pairs).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    build_gelu_mlp,
    build_rms_norm,
    gelu_mlp,
    rms_norm,
)

I_GATE_CAP = 8.0


# ======================================================================
# mLSTM
# ======================================================================

def build_mlstm(scope, cfg):
    d = cfg.d_model
    inner = int(d * cfg.xlstm.mlstm_proj_factor)
    h = cfg.num_heads
    hd = inner // h
    assert hd * h == inner, (inner, h)
    scope.param("w_up", (d, inner), ("embed", "ff"))
    scope.param("w_gate", (d, inner), ("embed", "ff"))
    scope.param("wq", (inner, h, hd), ("ff", "heads", None))
    scope.param("wk", (inner, h, hd), ("ff", "heads", None))
    scope.param("wv", (inner, h, hd), ("ff", "heads", None))
    scope.param("w_if", (d, 2 * h), ("embed", "heads"))
    scope.param("b_if", (2 * h,), ("heads",), init="zeros")
    scope.param("norm", (inner,), ("ff",), init="ones")
    scope.param("w_down", (inner, d), ("ff", "embed"))


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, hd, hd) matrix memory
    n: torch.Tensor  # (B, H, hd) normalizer


def _mlstm_gates(p, x):
    """Returns (log_i capped, log_f), each (B, S, H) fp32."""
    gf = (x @ p["w_if"].to(x.dtype)).float() + p["b_if"]
    h = gf.shape[-1] // 2
    log_i = torch.clamp(gf[..., :h], max=I_GATE_CAP)
    log_f = F.logsigmoid(gf[..., h:])
    return log_i, log_f


def _mlstm_qkv(p, cfg, x):
    inner = x @ p["w_up"].to(x.dtype)
    gate = x @ p["w_gate"].to(x.dtype)
    q = torch.einsum("bsf,fhk->bshk", inner, p["wq"].to(x.dtype))
    k = torch.einsum("bsf,fhk->bshk", inner, p["wk"].to(x.dtype))
    v = torch.einsum("bsf,fhk->bshk", inner, p["wv"].to(x.dtype))
    return q, k, v, gate


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int,
                    state: Optional[MLSTMState] = None):
    """Chunkwise mLSTM.  q/k/v (b,s,h,p); gates (b,s,h) fp32.  Returns
    (y (b,s,h,p) fp32, the final MLSTMState).  ``chunk`` falls back to
    ``s`` when it does not divide ``s``, as in the JAX package."""
    b, s, nh, p = q.shape
    if s % chunk:
        chunk = s
    L = chunk
    scale = 1.0 / math.sqrt(p)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    if state is None:
        C = q.new_zeros((b, nh, p, p), dtype=torch.float32)
        n = q.new_zeros((b, nh, p), dtype=torch.float32)
    else:
        C, n = state.C.float(), state.n.float()
    ys = []
    for c0 in range(0, s, L):
        q_, k_, v_ = (t[:, c0:c0 + L].float() for t in (q, k, v))
        li_, lf_ = log_i[:, c0:c0 + L], log_f[:, c0:c0 + L]
        cum = torch.cumsum(lf_, dim=1)                # (b,L,h) ≤ 0
        total = cum[:, -1, :]
        # intra: scores[t,j] = exp(cum_t − cum_j + li_j) (q_t·k_j)/√p, j ≤ t
        G = torch.einsum("bihp,bjhp->bijh", q_, k_) * scale
        decay = cum[:, :, None, :] - cum[:, None, :, :] + li_[:, None, :, :]
        # double where, as the SSD's: a masked (j > t) entry's decay is
        # −Σ log_f over (t, j] + li_j > 0, whose exp overflows past ~88,
        # and 0·inf = NaN in the backward unless the argument is masked
        # first.  The forward is the JAX package's; its gradient, which
        # has no first where, is NaN wherever a masked decay overflows
        # (long chunks) and equal to this one elsewhere (ROADMAP §3)
        decay = torch.where(mask, decay, 0.0)
        Wt = torch.where(mask, torch.exp(decay), 0.0) * G
        num_intra = torch.einsum("bijh,bjhp->bihp", Wt, v_)
        den_intra = Wt.sum(2)                         # (b,L,h)
        # inter: the carried matrix memory
        qd = q_ * torch.exp(cum)[..., None]
        num_inter = torch.einsum("blhp,bhpv->blhv", qd, C) * scale
        den_inter = torch.einsum("blhp,bhp->blh", qd, n) * scale
        num = num_intra + num_inter
        den = den_intra + den_inter
        ys.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # state update to the chunk's end
        w_end = torch.exp(total[:, None, :] - cum + li_)      # (b,L,h)
        C = torch.exp(total)[:, :, None, None] * C + torch.einsum(
            "blh,blhp,blhv->bhpv", w_end, k_, v_)
        n = torch.exp(total)[:, :, None] * n + torch.einsum(
            "blh,blhp->bhp", w_end, k_)
    return torch.cat(ys, dim=1), MLSTMState(C=C, n=n)


def _mlstm_out(p, cfg, x, h_out, gate):
    """(B, S, H, hd) cell outputs → the block's (B, S, D) output."""
    b, s = x.shape[:2]
    y = h_out.reshape(b, s, -1).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(gate)
    return y @ p["w_down"].to(x.dtype)


def mlstm_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill path.  x (B,S,D) -> (B,S,D)."""
    q, k, v, gate = _mlstm_qkv(p, cfg, x)
    log_i, log_f = _mlstm_gates(p, x)
    y, _ = mlstm_chunkwise(q, k, v, log_i, log_f, cfg.xlstm.chunk_size)
    return _mlstm_out(p, cfg, x, y, gate)


def mlstm_decode_step(p, cfg, x: torch.Tensor, state: MLSTMState
                      ) -> Tuple[torch.Tensor, MLSTMState]:
    """x (B,1,D): the one-token recurrent update.  Returns (out (B,1,D),
    the new state)."""
    q, k, v, gate = _mlstm_qkv(p, cfg, x)
    log_i, log_f = _mlstm_gates(p, x)
    i_ = torch.exp(log_i[:, 0])                       # (B,H)
    f_ = torch.exp(log_f[:, 0])
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    C = f_[:, :, None, None] * state.C.float() + i_[:, :, None, None] * \
        torch.einsum("bhp,bhv->bhpv", kf, vf)
    n = f_[:, :, None] * state.n.float() + i_[:, :, None] * kf
    scale = 1.0 / math.sqrt(q.shape[-1])
    num = torch.einsum("bhp,bhpv->bhv", qf, C) * scale
    den = torch.einsum("bhp,bhp->bh", qf, n) * scale
    h_out = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return _mlstm_out(p, cfg, x, h_out[:, None], gate), MLSTMState(
        C=C.to(state.C.dtype), n=n.to(state.n.dtype))


# ======================================================================
# sLSTM
# ======================================================================

def build_slstm(scope, cfg):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    scope.param("w_in", (d, 4 * d), ("embed", "ff"))
    scope.param("b_in", (4 * d,), ("ff",), init="zeros")
    scope.param("r", (h, dh, 4 * dh), ("heads", None, None), scale=0.02)
    scope.param("norm", (d,), ("embed",), init="ones")
    scope.param("w_out", (d, d), ("embed", "embed"))
    # post-recurrence MLP (the sLSTM block's up/down projection)
    build_gelu_mlp(scope.sub("mlp"), d, int(d * cfg.xlstm.slstm_proj_factor))
    build_rms_norm(scope, "mlp_norm", d)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D) cell
    n: torch.Tensor  # (B, D) normalizer
    m: torch.Tensor  # (B, D) stabilizer
    h: torch.Tensor  # (B, D) hidden (feeds the recurrent weights)


def init_slstm_state(cfg, batch: int, device) -> SLSTMState:
    """The zero state, its stabilizer m at −20 (as the JAX package's)."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, m=z - 20.0, h=z)


def slstm_state_axes() -> SLSTMState:
    a = ("batch", "embed")
    return SLSTMState(c=a, n=a, m=a, h=a)


def _slstm_cell(p, cfg, x_t: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """One timestep.  x_t (B,D): the input projection is applied here."""
    b, d = x_t.shape
    h_ = cfg.num_heads
    dh = d // h_
    raw = (x_t @ p["w_in"].to(x_t.dtype)).float() + p["b_in"]
    hprev = state.h.reshape(b, h_, dh)
    rec = torch.einsum("bhd,hde->bhe", hprev, p["r"].float())
    raw = raw + rec.reshape(b, 4 * d)
    zt, it, ft, ot = raw.chunk(4, dim=-1)
    m_new = torch.maximum(ft + state.m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + state.m - m_new)
    c_new = f_ * state.c + i_ * torch.tanh(zt)
    n_new = f_ * state.n + i_
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1.0)
    return SLSTMState(c=c_new, n=n_new, m=m_new, h=h_new)


def _slstm_out(p, cfg, x, hs):
    y = hs.to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype)


def slstm_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D): a Python loop over time (the sLSTM's nature)."""
    state = init_slstm_state(cfg, x.shape[0], x.device)
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_cell(p, cfg, x[:, t], state)
        hs.append(state.h)
    return _slstm_out(p, cfg, x, torch.stack(hs, dim=1))


def slstm_decode_step(p, cfg, x: torch.Tensor, state: SLSTMState
                      ) -> Tuple[torch.Tensor, SLSTMState]:
    st = _slstm_cell(p, cfg, x[:, 0], state)
    return _slstm_out(p, cfg, x, st.h[:, None, :]), st


def slstm_block_mlp(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM block's post-recurrence MLP (pre-norm residual)."""
    return gelu_mlp(p["mlp"], rms_norm(x, p["mlp_norm"], cfg.norm_eps))
