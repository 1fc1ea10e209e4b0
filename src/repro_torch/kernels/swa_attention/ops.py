"""Wrapper of the ``swa_attention`` CUDA kernel (``csrc/swa_attention.cu``).

``swa_attention(q, k, v, *, window)`` is sliding-window causal attention
in the model layout — q ``(B, S, H, hd)``, k/v ``(B, S, KV, hd)`` — over
the keys ``(t − window, t]`` of each query ``t``; a window ≥ S is plain
causal attention.  Any S; fp32 or bf16; any head dim on the CPU, and on
the card the kernel's instances, hd 32, 64, 96 or 128; the output is
``(B, S, H, hd)`` in ``q.dtype``.  This is the contract of the JAX
package's wrapper (``repro.kernels.swa_attention.ops``), which pads and
transposes for its kernel; this kernel reads the model layout through
strides and masks the ragged edge itself.

For tensors on the CPU it computes the plain version in ``ref.py``; for
tensors on a CUDA device it launches the kernel, or raises — nothing
falls back; for tensors on ``meta`` (the dry-run's shape-only trace) it
returns an empty output of the right shape.  Each call records its
work (:func:`cost`) with an active cost counter
(:func:`repro_torch.analysis.cost.kernel_call`).  The kernel is built at first use (:mod:`repro_torch.kernels.build`)
and loaded with ``ctypes``.  ``swa_attention.launches`` counts the kernel
launches made through this wrapper.

The call is a ``torch.autograd.Function`` in the form ``torch.func``
composes with (``forward`` without ``ctx``, ``setup_context``, a
``vmap`` rule), on both devices:

* its backward is plain PyTorch, the same math the JAX package
  differentiates (``repro.models.attention.attend``): the masked scores
  are recomputed from the saved q, k, v, and the gradients formed from
  them and the saved output;
* its ``jvp`` rule (forward mode) is plain PyTorch too: with the same
  P, Ṡ = (q̇·kᵀ + q·k̇ᵀ)/√hd, Ṗ = P ⊙ (Ṡ − rowsum(P ⊙ Ṡ)) and
  Ȯ = Ṗ·V + P·V̇;
* its backward is :func:`~repro_torch.kernels.autograd.first_order`:
  not recorded for a second reverse pass, but its ops carry forward-mode
  tangents, so ``torch.func.jvp`` of ``torch.func.grad`` (a
  Hessian-vector product) runs through it;
* its ``vmap`` rule folds the mapped dimension into the batch, so the
  kernel launches once per call however many agents are mapped over.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.analysis.cost import kernel_call
from repro_torch.kernels import build as _build
from repro_torch.kernels.autograd import first_order
from repro_torch.kernels.swa_attention.ref import NEG, swa_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_attention.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernel has an instance for (csrc/swa_attention.cu)
HEAD_DIMS = (32, 64, 96, 128)
# query rows per block of the kernel (csrc/swa_attention.cu)
BLOCK_Q = 64
# the arithmetic each dtype runs on: 3×TF32 tensor-core products for fp32
# inputs, bf16 tensor-core products for bf16 (P in two bf16 parts for
# P·V; fp32 softmax and sums)
PATHS = {torch.float32: "tf32x3", torch.bfloat16: "bf16-mma"}


def cost(b: int, s: int, h: int, kv: int, hd: int, window: int,
         dtype: torch.dtype) -> dict:
    """The work of one call: ``flops``, the function's (the two products,
    4·hd per query, visible key and head, over the window's pairs
    Σ_q min(q + 1, W), not the plain version's S×S; the softmax's 5 per
    pair and head; the normalisation's one per output element);
    ``hbm_bytes``, q, k, v read once and the output written once;
    ``path`` and ``path_flops``, the operations the tensor cores run
    (3×TF32: three products per product; bf16: Q·Kᵀ once, P·V twice
    with P in two bf16 parts)."""
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    products = 4 * hd * h * b * pairs
    itemsize = dtype.itemsize
    return {"flops": products + 5 * h * b * pairs + b * s * h * hd,
            "hbm_bytes": (2 * b * s * h * hd + 2 * b * s * kv * hd)
            * itemsize,
            "path": PATHS[dtype],
            "path_flops": (3 * products if dtype == torch.float32
                           else 3 * products // 2)}


def library_path() -> Path:
    """Where the shared library for the current source lives."""
    return _build.library_path(SOURCE)


def build() -> Path:
    """Compile the kernel if its library is not built yet; returns the
    library's path."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.swa_attention_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.swa_attention_launch.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"swa_attention: expected q (B,S,H,hd) and k, v "
                         f"(B,S,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"swa_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if min(b, s, h, kv) < 1 or h % kv:
        raise ValueError(f"swa_attention: need non-empty shapes and KV "
                         f"dividing H, got H={h}, KV={kv}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"swa_attention: dtypes differ {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"swa_attention: takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"swa_attention: devices differ {q.device}, "
                         f"{k.device}, {v.device}")
    if window < 1:
        raise ValueError(f"swa_attention: window must be ≥ 1, got {window}")


def check_head_dim(hd: int) -> None:
    """Raise unless the kernel has an instance for head dim ``hd`` (the
    CUDA path's test; the plain version takes any hd)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"swa_attention: head dim {hd} not supported on "
                         f"the card (the kernel is built for {HEAD_DIMS})")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int) -> torch.Tensor:
    """The plain version on the CPU, an empty result on ``meta``, the
    kernel on a CUDA device; its work recorded with any cost counter."""
    b, s, h, hd = q.shape
    work = cost(b, s, h, k.shape[2], hd, window, q.dtype)
    with kernel_call("swa_attention", work["flops"], work["hbm_bytes"]):
        return _run(q, k, v, window)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         window: int) -> torch.Tensor:
    if q.device.type == "cpu":
        # in the kernel's layout (a contiguous output), so that what
        # follows runs the same ops on every device
        return swa_attention_ref(q, k, v, window=window).contiguous()
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention: unsupported device {q.device}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("swa_attention: the head dim must be contiguous")
    b, s, h, hd = q.shape
    check_head_dim(hd)
    if -(-s // BLOCK_Q) * h * b >= 2 ** 31:
        raise ValueError(f"swa_attention: shape {tuple(q.shape)} exceeds "
                         f"the kernel's grid (2^31 − 1 blocks)")
    lib = _library()
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(st for x in (q, k, v, out)
                                      for st in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swa_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], hd, min(window, s), strides,
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"swa_attention: kernel launch failed with CUDA "
                           f"error {err}")
    swa_attention.launches += 1
    return out


def _grouped(x: torch.Tensor, kv: int) -> torch.Tensor:
    """``(B, S, H, hd)`` → ``(B, S, KV, rep, hd)`` in fp32: query head h
    is row ``h % rep`` of kv group ``h // rep``."""
    return x.float().unflatten(2, (kv, x.shape[2] // kv))


def _probabilities(q, k, v, window: int):
    """``(qg, kf, vf, keep, P)``: the grouped fp32 operands, the window
    mask ``(S, S)`` and P = softmax of the masked scores
    ``(B, KV, rep, S, S)``, recomputed as the kernel forms them."""
    s, scale = q.shape[1], 1.0 / math.sqrt(q.shape[-1])
    qg, kf, vf = _grouped(q, k.shape[2]), k.float(), v.float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    pos = torch.arange(s, device=q.device)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    p = torch.softmax(scores.masked_fill(~keep, NEG), dim=-1)
    return qg, kf, vf, keep, p


def swa_attention_jvp(q, k, v, dq, dk, dv, *, window: int):
    """The output's tangent along ``(dq, dk, dv)`` (any may be
    ``None``), in plain PyTorch: Ṡ = (q̇·kᵀ + q·k̇ᵀ)/√hd inside the
    window, Ṗ = P ⊙ (Ṡ − rowsum(P ⊙ Ṡ)), Ȯ = Ṗ·V + P·V̇, per kv group.
    Arithmetic in fp32; the tangent comes back in ``q.dtype``."""
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kf, vf, keep, p = _probabilities(q, k, v, window)
    terms = []
    if dq is not None:
        terms.append(torch.einsum("bqgrd,bkgd->bgrqk", _grouped(dq, kv), kf))
    if dk is not None:
        terms.append(torch.einsum("bqgrd,bkgd->bgrqk", qg, dk.float()))
    out = torch.zeros_like(qg)
    if terms:
        ds = sum(terms[1:], terms[0]).masked_fill(~keep, 0.0) * scale
        dp = p * (ds - (p * ds).sum(-1, keepdim=True))
        out = out + torch.einsum("bgrqk,bkgd->bqgrd", dp, vf)
    if dv is not None:
        out = out + torch.einsum("bgrqk,bkgd->bqgrd", p, dv.float())
    return out.flatten(2, 3).to(q.dtype)


def swa_attention_backward(q, k, v, o, do, *, window: int):
    """(dq, dk, dv) of sliding-window causal attention, in plain PyTorch.

    With the masked scores S = q·kᵀ/√hd recomputed as the kernel forms
    them (−1e30 outside ``(t − window, t]``), P = softmax(S):
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(dO ⊙ O)),
    dQ = dS·K/√hd, dK = dSᵀ·Q/√hd; the query heads of a kv group
    (``h // (H/KV)``) sum into its dK and dV.  Arithmetic in fp32;
    the gradients come back in the inputs' dtypes.  Only tensor
    operations, so ``torch.func.vmap`` maps it like any function.
    """
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kf, vf, keep, p = _probabilities(q, k, v, window)
    og = _grouped(o, kv)
    dog = _grouped(do, kv)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)  # (B, KV, rep, S)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
    return (dq.flatten(2, 3).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class SwaAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) with a plain
    backward, a plain ``jvp`` rule and a ``vmap`` rule."""

    @staticmethod
    def forward(q, k, v, window):
        return _forward(q, k, v, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window = inputs
        ctx.window = window
        ctx.save_for_backward(q, k, v, output)
        ctx.save_for_forward(q, k, v)

    @staticmethod
    @first_order
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*swa_attention_backward(q, k, v, o, do, window=ctx.window),
                None)

    @staticmethod
    def jvp(ctx, dq, dk, dv, _dwindow):
        q, k, v = ctx.saved_tensors
        return swa_attention_jvp(q, k, v, dq, dk, dv, window=ctx.window)

    @staticmethod
    def vmap(info, in_dims, q, k, v, window):
        # fold the mapped dim into B (an unmapped input is expanded to
        # it): one launch for every mapped slice at once
        n = info.batch_size

        def fold(x, dim):
            x = (x.expand(n, *x.shape) if dim is None
                 else x.movedim(dim, 0))
            return x.flatten(0, 1)

        out = SwaAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                 fold(v, in_dims[2]), window)
        return out.unflatten(0, (n, -1)), 0


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """Sliding-window causal attention, ``(B, S, H, hd)`` in ``q.dtype``;
    differentiable (in reverse and in forward mode), and mapped by
    ``torch.func.vmap`` in one launch."""
    _check(q, k, v, window)
    return SwaAttention.apply(q, k, v, window)


swa_attention.launches = 0
