"""Mamba2 (SSD) block in the chunked dual form (port of
``repro.models.ssm``).

Within a chunk the recurrence is a masked matrix product; across chunks
a Python loop carries the (heads, state, head_dim) SSM state, as the
JAX package's ``lax.scan`` does.  All decay exponents are ≤ 0 by
construction (A < 0, dt > 0), so the chunked exponentials cannot
overflow, except in the masked upper triangle, which is zeroed before
its ``exp`` (see :func:`ssd_chunked`).

Recurrence (per head h, state n, channel p):
    H_t = exp(dt_t A_h) H_{t-1} + dt_t B_t x_tᵀ
    y_t = C_tᵀ H_t + D_h x_t

On a (data, model) mesh the layer runs on the rank's heads, which is
the rules' layout: ``wz``, ``wx``, ``conv_w``, ``norm`` and ``w_out`` are
split on ``ff`` and ``wdt``, ``dt_bias``, ``A_log``, ``D_skip`` on
``heads``, and since ``inner`` is head-major a rank's ``ff`` block is
exactly its heads' channels: the depthwise conv and the SSD need no
other rank.  ``wB`` and ``wC`` are whole; each rank uses B and C for its
heads only, so their cotangents are summed over "model"
(``tp_mamba_bc``).  The gated norm over ``inner`` sums the squares over
"model" forward and backward (:func:`~repro_torch.models.layers.
rms_norm_split`), and ``w_out`` is row-parallel (``region_out``).
Under ``seq_shard`` the layer gathers the rank's chunk of the sequence
at its entry and reduce-scatters its output back to it.  The decode
state follows the blocks: ``MambaState.ssm`` on the rank's heads,
``conv`` on its ``ff`` columns.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm_split
from repro_torch.sharding import collectives as C


def build_mamba2(scope, cfg):
    ssm = cfg.ssm
    d = cfg.d_model
    inner = ssm.expand * d
    nheads = inner // ssm.head_dim
    scope.param("wz", (d, inner), ("embed", "ff"))
    scope.param("wx", (d, inner), ("embed", "ff"))
    scope.param("wB", (d, ssm.state_dim), ("embed", "state"))
    scope.param("wC", (d, ssm.state_dim), ("embed", "state"))
    scope.param("wdt", (d, nheads), ("embed", "heads"))
    scope.param("dt_bias", (nheads,), ("heads",), init="zeros")
    scope.param("A_log", (nheads,), ("heads",), init="zeros")
    scope.param("D_skip", (nheads,), ("heads",), init="ones")
    scope.param("conv_w", (ssm.conv_width, inner), (None, "ff"),
                init="small_uniform")
    scope.param("norm", (inner,), ("ff",), init="ones")
    scope.param("w_out", (inner, d), ("ff", "embed"))


class MambaState(NamedTuple):
    ssm: torch.Tensor   # (B, H, N, P)
    conv: torch.Tensor  # (B, W-1, inner) trailing inputs for the causal conv


def init_mamba_state(cfg, batch: int, dtype: torch.dtype,
                     device) -> MambaState:
    ssm = cfg.ssm
    inner = ssm.expand * cfg.d_model
    nheads = inner // ssm.head_dim
    return MambaState(
        ssm=torch.zeros((batch, nheads, ssm.state_dim, ssm.head_dim),
                        dtype=dtype, device=device),
        conv=torch.zeros((batch, ssm.conv_width - 1, inner), dtype=dtype,
                         device=device),
    )


def abstract_mamba_state(cfg, batch: int, dtype: torch.dtype) -> MambaState:
    """The state's shapes and dtypes as empty ``meta`` tensors (the
    JAX package's ``abstract_mamba_state``): nothing allocated."""
    return init_mamba_state(cfg, batch, dtype, "meta")


def mamba_state_axes() -> MambaState:
    return MambaState(ssm=("batch", "heads", "state", None),
                      conv=("batch", None, "ff"))


def _causal_conv(x, w, prev=None):
    """Depthwise causal conv. x (B,S,inner); w (W,inner); prev (B,W-1,inner)."""
    W = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, W):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out, (xp[:, -(W - 1):, :] if W > 1 else prev)


def _inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def _split(p, cfg) -> bool:
    """Whether the layer's weights are this rank's block of the ``ff``
    columns (and of the heads): a model axis splits them."""
    return C.shard_offset(p["wz"].shape[1], _inner(cfg),
                          "mamba2 ff") is not None


def _project(p, cfg, x, conv_prev=None):
    """The projections of the normed ``x``.  Where the weights are the
    rank's blocks, the column-parallel ones read ``x`` through
    ``region_in`` (its cotangent summed over "model"; under
    ``seq_shard`` the chunk gathered over the sequence), and B and C,
    which every rank computes whole, have their cotangent summed."""
    ssm = cfg.ssm
    split = _split(p, cfg)
    xc = C.region_in(x, "mamba_in", split=split)
    if C.tokens_split() == "seq":
        x = xc
    z = xc @ p["wz"].to(x.dtype)
    xin = xc @ p["wx"].to(x.dtype)
    xin, conv_state = _causal_conv(xin, p["conv_w"].to(x.dtype), conv_prev)
    xin = F.silu(xin)
    B = x @ p["wB"].to(x.dtype)
    C_ = x @ p["wC"].to(x.dtype)
    if split:
        B, C_ = C.copy_to_model(torch.stack([B, C_]),
                                "tp_mamba_bc").unbind(0)
    dt = F.softplus((xc @ p["wdt"].to(x.dtype)).float() + p["dt_bias"])
    nheads = p["A_log"].shape[0]
    xh = xin.reshape(*xin.shape[:-1], nheads, ssm.head_dim)
    return z, xh, B, C_, dt, conv_state


def _out(p, cfg, y, z, dtype):
    """The gated norm over ``inner`` and the output projection of the
    heads' ``y`` (B, S, H, P) (this rank's heads: the norm's sum and the
    row-parallel output summed over "model")."""
    y = y.reshape(*y.shape[:2], -1)
    y = rms_norm_split(y * F.silu(z), p["norm"], _inner(cfg), "mamba_norm",
                       cfg.norm_eps)
    return C.region_out(y @ p["w_out"].to(dtype), "mamba_out",
                        split=_split(p, cfg))


def ssd_chunked(xh, dt, A, B, C, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD. xh (b,s,h,p); dt (b,s,h) fp32; A (h,)<0; B/C (b,s,n).

    Returns (y (b,s,h,p) fp32, h_final (b,h,n,p) fp32).  ``chunk``
    falls back to ``s`` when it does not divide ``s``, as in the JAX
    package.
    """
    b, s, nh, p = xh.shape
    n = B.shape[-1]
    if s % chunk:
        chunk = s
    L = chunk
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    h = (xh.new_zeros((b, nh, n, p), dtype=torch.float32) if h0 is None
         else h0.float())
    ys = []
    for c0 in range(0, s, L):
        x_ = xh[:, c0:c0 + L].float()                 # (b,L,h,p)
        dt_ = dt[:, c0:c0 + L]                        # (b,L,h)
        B_ = B[:, c0:c0 + L].float()                  # (b,L,n)
        C_ = C[:, c0:c0 + L].float()
        dA = dt_ * A[None, None, :]                   # (b,L,h), ≤ 0
        cum = torch.cumsum(dA, dim=1)
        total = cum[:, -1, :]                         # (b,h)
        # intra-chunk: masked matrix product
        G = torch.einsum("bin,bjn->bij", C_, B_)
        decay = cum[:, :, None, :] - cum[:, None, :, :]   # (b,i,j,h)
        # double where: masked (i<j) entries have decay > 0, so their exp
        # overflows and 0·inf = NaN in the backward unless the argument
        # itself is masked first
        decay = torch.where(mask, decay, 0.0)
        M = torch.where(mask, torch.exp(decay), 0.0)
        W = G[..., None] * M * dt_[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", W, x_)
        # inter-chunk: the carried state
        y_inter = torch.einsum("bln,blh,bhnp->blhp", C_, torch.exp(cum), h)
        # state update to the chunk's end
        to_end = torch.exp(total[:, None, :] - cum)   # (b,L,h)
        S_c = torch.einsum("blh,bln,blhp->bhnp", to_end * dt_, B_, x_)
        h = torch.exp(total)[:, :, None, None] * h + S_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def mamba2_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill path. x (B,S,D) -> (B,S,D) (under ``seq_shard`` the
    rank's chunk in and out)."""
    ssm = cfg.ssm
    z, xh, B, C_, dt, _ = _project(p, cfg, x)
    A = -torch.exp(p["A_log"].float())
    y, _ = ssd_chunked(xh, dt, A, B, C_, ssm.chunk_size)
    y = y.to(x.dtype) + p["D_skip"].to(x.dtype)[None, None, :, None] * xh
    return _out(p, cfg, y, z, x.dtype)


def mamba2_decode_step(p, cfg, x: torch.Tensor,
                       state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One-token recurrent step. x (B,1,D).  Returns (out (B,1,D), the
    new state)."""
    z, xh, B, C_, dt, conv_state = _project(p, cfg, x, conv_prev=state.conv)
    A = -torch.exp(p["A_log"].float())
    lam = torch.exp(dt[:, 0] * A[None, :])  # (B,H)
    h = state.ssm.float()
    upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], B[:, 0].float(),
                       xh[:, 0].float())
    h_new = lam[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", C_[:, 0].float(), h_new)
    y = y.to(x.dtype) + p["D_skip"].to(x.dtype)[None, :, None] * xh[:, 0]
    return _out(p, cfg, y[:, None], z, x.dtype), MambaState(
        ssm=h_new.to(state.ssm.dtype), conv=conv_state)
