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

On a (data, model) mesh, in the rules' layout:

* the mLSTM runs on the rank's heads.  ``w_up`` and ``w_gate`` are split
  on ``ff`` and ``wq``/``wk``/``wv`` on their ``ff`` rows (heads whole:
  the axis-reuse rule), so a rank's q, k and v are partial sums over
  ``ff`` for every head: they are reduce-scattered onto the rank's heads
  (``tp_mlstm_qkv``).  ``w_if``/``b_if`` (embed, 2h) are split on
  ``heads``, which hands rank r the columns [r·2h/n, (r+1)·2h/n): input
  gates of some heads or forget gates of others, never its own heads'
  pair; they are gathered whole (``tp_mlstm_gates``, the backward summed:
  each rank reads its heads' columns) and each rank takes its heads'
  input and forget gates.  The cell output, head-major, is the rank's
  ``ff`` block: the norm sums its squares over "model" and ``w_down`` is
  row-parallel.
* the sLSTM's recurrence runs whole on every model rank: ``w_in``'s
  column split does not follow the gate layout (``chunk(4)`` over z, i,
  f, o), and splitting the cells would need a collective at every
  position.  ``w_in``, ``b_in`` and ``r`` are gathered once a forward
  (:func:`repro_torch.sharding.collectives.gather_columns`: under
  tensor parallelism each rank keeps its block of the gradient, which
  is the same on every rank), so the collectives of a step do not grow
  with the sequence.  The GELU MLP after it is column-parallel then
  row-parallel, ``b_out`` added after the sum.
* under ``seq_shard`` every recurrence sees the whole sequence: the
  rank's chunk is gathered at the block's entry, and the mLSTM's output
  reduce-scattered back to it (the sLSTM keeps its chunk of the
  hidden states).
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
    rms_norm_split,
)
from repro_torch.sharding import collectives as C

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


def _mlstm_inner(cfg) -> int:
    return int(cfg.d_model * cfg.xlstm.mlstm_proj_factor)


def _mlstm_split(p, cfg) -> bool:
    """Whether the layer's weights are this rank's block of the ``ff``
    columns (a model axis splits them); the rank then runs its heads."""
    if C.shard_offset(p["w_up"].shape[1], _mlstm_inner(cfg),
                      "mlstm ff") is None:
        return False
    if cfg.num_heads % C.model_size():
        raise ValueError(f"the mLSTM's {cfg.num_heads} heads do not split "
                         f"over a model axis of {C.model_size()} that "
                         f"splits its ff columns")
    return True


def _mlstm_gates(p, cfg, x, split: bool):
    """Returns (log_i capped, log_f), each (B, S, H) fp32: over the
    rank's heads where ``split``."""
    w, b = p["w_if"], p["b_if"]
    h = cfg.num_heads
    if w.shape[1] != 2 * h:
        # the rank's columns of (embed, 2h) hold no head's pair: both
        # gathered whole in one call, the gradient summed over "model"
        d, c = w.shape
        off = C.shard_offset(c, 2 * h, "mlstm gates")
        wb = C.gather_model(torch.cat([w, b[None].to(w.dtype)]),
                            (slice(0, d + 1), slice(off, off + c)),
                            (d + 1, 2 * h), C.model_where("mlstm_gates"))
        w, b = wb[:d], wb[d].to(b.dtype)
    gf = (x @ w.to(x.dtype)).float() + b
    log_i = torch.clamp(gf[..., :h], max=I_GATE_CAP)
    log_f = F.logsigmoid(gf[..., h:])
    if split:
        return C.seq_chunk(log_i, -1), C.seq_chunk(log_f, -1)
    return log_i, log_f


def _mlstm_qkv(p, cfg, x, split: bool):
    inner = x @ p["w_up"].to(x.dtype)
    gate = x @ p["w_gate"].to(x.dtype)
    q = torch.einsum("bsf,fhk->bshk", inner, p["wq"].to(x.dtype))
    k = torch.einsum("bsf,fhk->bshk", inner, p["wk"].to(x.dtype))
    v = torch.einsum("bsf,fhk->bshk", inner, p["wv"].to(x.dtype))
    if split:
        # partial sums over the rank's ff rows, onto the rank's heads
        q, k, v = C.reduce_scatter(torch.stack([q, k, v], 2), "mlstm_qkv",
                                   3).unbind(2)
    return q, k, v, gate


def _mlstm_in(p, cfg, x):
    """The block's input, its projections, gates and split: ``x`` through
    ``region_in`` (under tensor parallelism its cotangent summed over
    "model", under ``seq_shard`` the chunk gathered)."""
    split = _mlstm_split(p, cfg)
    x = C.region_in(x, "mlstm_in", split=split)
    q, k, v, gate = _mlstm_qkv(p, cfg, x, split)
    log_i, log_f = _mlstm_gates(p, cfg, x, split)
    return x, q, k, v, gate, log_i, log_f, split


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


def _mlstm_out(p, cfg, x, h_out, gate, split: bool):
    """(B, S, H, hd) cell outputs → the block's (B, S, D) output (the
    rank's heads: the norm's sum and ``w_down``'s output summed over
    "model")."""
    y = h_out.reshape(*h_out.shape[:2], -1).to(x.dtype)
    y = rms_norm_split(y, p["norm"], _mlstm_inner(cfg), "mlstm_norm",
                       cfg.norm_eps) * F.silu(gate)
    return C.region_out(y @ p["w_down"].to(x.dtype), "mlstm_out",
                        split=split)


def mlstm_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill path.  x (B,S,D) -> (B,S,D) (under ``seq_shard`` the
    rank's chunk in and out)."""
    x, q, k, v, gate, log_i, log_f, split = _mlstm_in(p, cfg, x)
    y, _ = mlstm_chunkwise(q, k, v, log_i, log_f, cfg.xlstm.chunk_size)
    return _mlstm_out(p, cfg, x, y, gate, split)


def mlstm_decode_step(p, cfg, x: torch.Tensor, state: MLSTMState
                      ) -> Tuple[torch.Tensor, MLSTMState]:
    """x (B,1,D): the one-token recurrent update.  Returns (out (B,1,D),
    the new state)."""
    x, q, k, v, gate, log_i, log_f, split = _mlstm_in(p, cfg, x)
    i_ = torch.exp(log_i[:, 0])                       # (B,H)
    f_ = torch.exp(log_f[:, 0])
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    C_ = f_[:, :, None, None] * state.C.float() + i_[:, :, None, None] * \
        torch.einsum("bhp,bhv->bhpv", kf, vf)
    n = f_[:, :, None] * state.n.float() + i_[:, :, None] * kf
    scale = 1.0 / math.sqrt(q.shape[-1])
    num = torch.einsum("bhp,bhpv->bhv", qf, C_) * scale
    den = torch.einsum("bhp,bhp->bh", qf, n) * scale
    h_out = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return _mlstm_out(p, cfg, x, h_out[:, None], gate, split), MLSTMState(
        C=C_.to(state.C.dtype), n=n.to(state.n.dtype))


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


def abstract_slstm_state(cfg, batch: int,
                         dtype: torch.dtype = torch.float32) -> SLSTMState:
    """The state's shapes and dtypes as empty ``meta`` tensors (the JAX
    package's ``abstract_slstm_state``: fp32 whatever ``dtype``)."""
    z = torch.empty((batch, cfg.d_model), dtype=torch.float32,
                    device="meta")
    return SLSTMState(c=z, n=z, m=z, h=z)


def slstm_state_axes() -> SLSTMState:
    a = ("batch", "embed")
    return SLSTMState(c=a, n=a, m=a, h=a)


def _slstm_weights(p, cfg):
    """``p`` with ``w_in``, ``b_in`` and ``r`` whole: a model axis's
    blocks gathered in one call (:func:`repro_torch.sharding.
    collectives.gather_columns`)."""
    d = cfg.d_model
    w_in, b_in, r = C.gather_columns(
        [(p["w_in"], 1, 4 * d), (p["b_in"], 0, 4 * d),
         (p["r"], 0, cfg.num_heads)], "slstm_weights")
    return dict(p, w_in=w_in, b_in=b_in, r=r)


def _slstm_cell(p, cfg, x_t: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """One timestep.  x_t (B,D): the input projection is applied here
    (``p``'s recurrent weights whole: :func:`_slstm_weights`)."""
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
    """x (B,S,D): a Python loop over time (the sLSTM's nature).  Under
    ``seq_shard`` the rank's chunk is gathered whole, the recurrence runs
    over the whole sequence, and the rank keeps its chunk."""
    seq = C.tokens_split() == "seq"
    xs = C.gather_seq(x, "sp_slstm_in") if seq else x
    w = _slstm_weights(p, cfg)
    state = init_slstm_state(cfg, xs.shape[0], xs.device)
    hs = []
    for t in range(xs.shape[1]):
        state = _slstm_cell(w, cfg, xs[:, t], state)
        hs.append(state.h)
    hs = torch.stack(hs, dim=1)
    return _slstm_out(p, cfg, x, C.seq_chunk(hs) if seq else hs)


def slstm_decode_step(p, cfg, x: torch.Tensor, state: SLSTMState
                      ) -> Tuple[torch.Tensor, SLSTMState]:
    st = _slstm_cell(_slstm_weights(p, cfg), cfg, x[:, 0], state)
    return _slstm_out(p, cfg, x, st.h[:, None, :]), st


def slstm_block_mlp(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM block's post-recurrence MLP (pre-norm residual); over a
    model axis that splits its ``ff`` columns, column-parallel then
    row-parallel with ``b_out`` added after the sum."""
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if C.shard_offset(p["mlp"]["w_in"].shape[1],
                      int(cfg.d_model * cfg.xlstm.slstm_proj_factor),
                      "slstm mlp") is None:
        return gelu_mlp(p["mlp"], h)
    out = gelu_mlp(p["mlp"], C.region_in(h, "mlp_in"), out_bias=False)
    return C.region_out(out, "mlp_out") + p["mlp"]["b_out"]
