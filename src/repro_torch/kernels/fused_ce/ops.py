"""Wrapper of the ``fused_ce`` CUDA kernel (``csrc/fused_ce.cu``).

``fused_ce_nll(x, table, labels)`` is the per-token negative
log-likelihood ``logsumexp_v(x_t · table_v) − x_t · table_{labels_t}``
in fp32 for x ``(T, D)``, table ``(V, D)`` (fp32 or bf16) and integer
labels ``(T,)``, without forming the ``(T, V)`` logits.
``fused_ce(x, table, labels)`` is its mean over the tokens, for x
``(B, S, D)`` or ``(T, D)`` and labels of the matching leading shape —
the contract of the JAX package's wrapper (``repro.kernels.fused_ce.ops``),
which pads T and the vocab for its kernel; this kernel masks both edges
itself and reads x and the table through strides.

For tensors on the CPU it computes the plain version in ``ref.py``; for
tensors on a CUDA device it launches the kernel, or raises — nothing
falls back; for tensors on ``meta`` (the dry-run's shape-only trace) it
returns empty outputs of the right shapes.  Each call records its work
(:func:`cost`) with an active cost counter
(:func:`repro_torch.analysis.cost.kernel_call`).  The kernel is built at first use (:mod:`repro_torch.kernels.build`)
and loaded with ``ctypes``.  ``fused_ce.launches`` counts the kernel
launches made through this module.

The call is a ``torch.autograd.Function`` in the form ``torch.func``
composes with (``forward`` without ``ctx``, ``setup_context``, a
``vmap`` rule), on both devices:

* its forward returns the NLL and the logsumexp (both differentiable:
  :func:`fused_ce_nll_lse`; :func:`fused_ce_nll` reads the NLL);
* its backward is plain PyTorch (the JAX package, too, differentiates a
  plain chunked loss, ``repro.models.layers.cross_entropy_fused``): the
  logits are recomputed ``BACKWARD_CHUNK`` tokens at a time,
  P = exp(logits − lse), the one-hot of the labels subtracted, scaled by
  the incoming gradient (plus P scaled by the logsumexp's), then
  dx = (P − Y)·table and dtable += (P − Y)ᵀ·x;
* its ``jvp`` rule (forward mode) is plain PyTorch too, chunked like
  the backward: the tangent of the NLL is
  ``Σ_v p_v·(ẋ·t_v + x·ṫ_v) − (ẋ·t_gold + x·ṫ_gold)``, that of the
  logsumexp the sum alone;
* its backward is :func:`~repro_torch.kernels.autograd.first_order`:
  not recorded for a second reverse pass, but its ops carry forward-mode
  tangents, so ``torch.func.jvp`` of ``torch.func.grad`` (a
  Hessian-vector product) runs through it;
* its ``vmap`` rule maps the mapped dimension onto the kernel's group
  axis: each agent's tokens, with the shared table (group stride 0) or
  with its own, all in ONE launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.analysis.cost import kernel_call
from repro_torch.kernels import build as _build
from repro_torch.kernels.autograd import first_order
from repro_torch.kernels.fused_ce.ref import fused_ce_lse_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_ce.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODES = {torch.int32: 0, torch.int64: 1}

# the kernel's tiles (csrc/fused_ce.cu) and the sizes it is built for:
# every model config of the repository (D ≤ 5120, V ≤ 151936) fits
BLOCK_T = 128
BLOCK_V = 128
MAX_D = 16384
MAX_V = 1 << 24
MAX_GRID = 65535
# blocks to aim for per SM over the launch when the vocab is split into
# ranges (one block fits an SM at a time: 8 waves keep the last one short)
BLOCKS_PER_SM = 8
# the arithmetic each dtype runs on: 3×TF32 tensor-core products for fp32
# inputs, bf16 tensor-core products for bf16 (fp32 sums in both)
PATHS = {torch.float32: "tf32x3", torch.bfloat16: "bf16-mma"}
# tokens per recomputed logits chunk in the backward (the JAX package's
# default chunk of cross_entropy_fused)
BACKWARD_CHUNK = 512


def cost(g: int, t: int, d: int, v: int, dtype: torch.dtype, *,
         label_bytes: int = 8, shared_table: bool = False) -> dict:
    """The work of one call over ``g`` groups of ``t`` tokens: ``flops``,
    the function's (2·T·D·V for the logits, then the online logsumexp's
    max, subtract, exp and sum per logit, and its log and the NLL's
    subtraction per token); ``hbm_bytes``, x, the table (once when the
    groups share it), the labels read once and the NLL and logsumexp
    written once; ``path`` and ``path_flops``, the operations the tensor
    cores run (3×TF32: three products per product)."""
    itemsize = dtype.itemsize
    products = 2 * g * t * d * v
    tables = 1 if shared_table else g
    return {"flops": products + 4 * g * t * v + 3 * g * t,
            "hbm_bytes": (g * t * d + tables * v * d) * itemsize
            + g * t * label_bytes + 2 * g * t * 4,
            "path": PATHS[dtype],
            "path_flops": 3 * products if dtype == torch.float32
            else products}


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
    lib.fused_ce_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fused_ce_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def vocab_split(groups: int, tokens: int, vocab: int, sms: int):
    """``(nsplit, tiles_per_split)``: the vocab's ``BLOCK_V``-entry tiles
    cut into ranges so that the launch holds about ``BLOCKS_PER_SM``
    blocks per SM (the kernel's plan; a function of the shapes and the
    card only, so repeated launches sum in the same order)."""
    tiles_v = -(-vocab // BLOCK_V)
    blocks = groups * -(-tokens // BLOCK_T)
    nsplit = max(1, min(tiles_v, -(-BLOCKS_PER_SM * sms // blocks)))
    per = -(-tiles_v // nsplit)
    return -(-tiles_v // per), per


def _check(x: torch.Tensor, table: torch.Tensor,
           labels: torch.Tensor) -> None:
    if x.ndim != 2 or table.ndim != 2 or labels.ndim != 1:
        raise ValueError(f"fused_ce: expected x (T, D), table (V, D) and "
                         f"labels (T,), got {tuple(x.shape)}, "
                         f"{tuple(table.shape)}, {tuple(labels.shape)}")
    (t, d), v = x.shape, table.shape[0]
    if table.shape[1] != d or labels.shape[0] != t:
        raise ValueError(f"fused_ce: table {tuple(table.shape)} or labels "
                         f"{tuple(labels.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if min(t, d, v) < 1:
        raise ValueError(f"fused_ce: empty shapes T={t}, D={d}, V={v}")
    if d > MAX_D or v > MAX_V:
        raise ValueError(f"fused_ce: D={d}, V={v} outside the kernel's "
                         f"range (D ≤ {MAX_D}, V ≤ {MAX_V})")
    if x.dtype != table.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_ce: x and table must share float32 or "
                        f"bfloat16, got {x.dtype}, {table.dtype}")
    if labels.dtype not in _LABEL_CODES:
        raise TypeError(f"fused_ce: labels must be int32 or int64, got "
                        f"{labels.dtype}")
    if not (x.device == table.device == labels.device):
        raise ValueError(f"fused_ce: devices differ {x.device}, "
                         f"{table.device}, {labels.device}")


def _forward(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor):
    """``(nll, lse)`` ``(G, T)`` fp32 for a group of token matrices x
    ``(G, T, D)``, tables ``(G, V, D)`` and labels ``(G, T)``: the plain
    version on the CPU, empty results on ``meta``, the kernel on a CUDA
    device; its work recorded with any cost counter."""
    g, t, d = x.shape
    work = cost(g, t, d, table.shape[1], x.dtype,
                label_bytes=labels.element_size(),
                shared_table=g > 1 and table.stride(0) == 0)
    with kernel_call("fused_ce", work["flops"], work["hbm_bytes"]):
        return _run(x, table, labels)


def _run(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor):
    if x.device.type == "cpu":
        return fused_ce_lse_ref(x, table, labels)
    if x.device.type == "meta":
        return (torch.empty(x.shape[:2], dtype=torch.float32, device="meta"),
                torch.empty(x.shape[:2], dtype=torch.float32, device="meta"))
    if x.device.type != "cuda":
        raise ValueError(f"fused_ce: unsupported device {x.device}")
    if x.stride(-1) != 1 or table.stride(-1) != 1:
        raise ValueError("fused_ce: the D axis of x and table must be "
                         "contiguous")
    g, t, d = x.shape
    v = table.shape[1]
    nsplit, per = vocab_split(g, t, v, _sm_count(x.device.index))
    if g > MAX_GRID or nsplit > MAX_GRID or g * t >= 2 ** 31:
        raise ValueError(f"fused_ce: {g} groups of {t} tokens exceed the "
                         f"kernel's grid")
    lib = _library()
    part = torch.empty((g, nsplit, t, 3), dtype=torch.float32,
                       device=x.device)
    nll = torch.empty((g, t), dtype=torch.float32, device=x.device)
    lse = torch.empty((g, t), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 6)(x.stride(0), x.stride(1),
                                   table.stride(0), table.stride(1),
                                   labels.stride(0), labels.stride(1))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_ce_launch(
            x.data_ptr(), table.data_ptr(), labels.data_ptr(),
            part.data_ptr(), nll.data_ptr(), lse.data_ptr(), g, t, v, d,
            nsplit, per, strides, _DTYPE_CODES[x.dtype],
            _LABEL_CODES[labels.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ce: kernel launch failed with CUDA error "
                           f"{err}")
    fused_ce.launches += 1
    return nll, lse


def fused_ce_backward(x, table, labels, lse, dnll, *, chunk: int,
                      dlse=None):
    """(dx, dtable) of Σ dnll ⊙ nll (+ Σ dlse ⊙ lse, where ``dlse`` is
    given), in plain PyTorch, for the grouped layout of :func:`_forward`.
    The logits are recomputed ``chunk`` tokens at a time (the (T, V)
    matrix never exists whole); arithmetic in fp32, the gradients in the
    inputs' dtypes.  Only out-of-place tensor operations, so
    ``torch.func.vmap`` maps it like any function."""
    tf = table.float()
    vocab = torch.arange(table.shape[-2], device=x.device)
    dx, dtable = [], None
    for t0 in range(0, x.shape[-2], chunk):
        xc = x[..., t0:t0 + chunk, :].float()
        logits = xc @ tf.transpose(-1, -2)
        p = torch.exp(logits - lse[..., t0:t0 + chunk, None])
        gold = vocab == labels[..., t0:t0 + chunk, None]
        q = torch.where(gold, p - 1.0, p) * dnll[..., t0:t0 + chunk, None]
        # a zero logsumexp cotangent adds exact zeros: the plain loss's
        # gradient is unchanged bit for bit
        p = q if dlse is None else q + p * dlse[..., t0:t0 + chunk, None]
        dx.append(p @ tf)
        part = p.transpose(-1, -2) @ xc
        dtable = part if dtable is None else dtable + part
    return torch.cat(dx, -2).to(x.dtype), dtable.to(table.dtype)


def fused_ce_jvp(x, table, labels, lse, dx, dtable, *, chunk: int):
    """The tangents ``(dnll, dlse)`` of :func:`_forward`'s outputs along
    the input tangents ``(dx, dtable)`` (either may be ``None``), in
    plain PyTorch: with P = exp(logits − lse) recomputed ``chunk``
    tokens at a time and the logits' tangent L̇ = ẋ·tableᵀ + x·ṫableᵀ,
    dlse = Σ_v P ⊙ L̇ and dnll = dlse − L̇_gold.  fp32 throughout."""
    tf = table.float()
    dtf = None if dtable is None else dtable.float()
    dnll, dlse = [], []
    for t0 in range(0, x.shape[-2], chunk):
        xc = x[..., t0:t0 + chunk, :].float()
        p = torch.exp(xc @ tf.transpose(-1, -2)
                      - lse[..., t0:t0 + chunk, None])
        terms = []
        if dx is not None:
            terms.append(dx[..., t0:t0 + chunk, :].float()
                         @ tf.transpose(-1, -2))
        if dtf is not None:
            terms.append(xc @ dtf.transpose(-1, -2))
        dl = sum(terms[1:], terms[0]) if terms else torch.zeros_like(p)
        dlse_c = (p * dl).sum(-1)
        gold = torch.gather(dl, -1,
                            labels[..., t0:t0 + chunk, None].long())[..., 0]
        dlse.append(dlse_c)
        dnll.append(dlse_c - gold)
    return torch.cat(dnll, -1), torch.cat(dlse, -1)


class FusedCE(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) over a group of
    token matrices, with a plain backward, a plain ``jvp`` rule and a
    ``vmap`` rule."""

    @staticmethod
    def forward(x, table, labels):
        return _forward(x, table, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, table, labels = inputs
        _, lse = output
        # lse is not marked non-differentiable: the backward reads it,
        # and under forward-over-reverse it must carry its tangent there
        ctx.save_for_backward(x, table, labels, lse)
        ctx.save_for_forward(x, table, labels, lse)

    @staticmethod
    @first_order
    def backward(ctx, dnll, dlse):
        x, table, labels, lse = ctx.saved_tensors
        return (*fused_ce_backward(x, table, labels, lse, dnll,
                                   chunk=BACKWARD_CHUNK, dlse=dlse), None)

    @staticmethod
    def jvp(ctx, dx, dtable, _dlabels):
        x, table, labels, lse = ctx.saved_tensors
        return fused_ce_jvp(x, table, labels, lse, dx, dtable,
                            chunk=BACKWARD_CHUNK)

    @staticmethod
    def vmap(info, in_dims, x, table, labels):
        # the mapped dim becomes part of the group axis; an unmapped
        # input is expanded to it (a table without copying: stride 0)
        n = info.batch_size

        def fold(t, dim):
            t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
            return t.flatten(0, 1)

        nll, lse = FusedCE.apply(fold(x, in_dims[0]), fold(table, in_dims[1]),
                                 fold(labels, in_dims[2]))
        return (nll.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


def fused_ce_nll(x: torch.Tensor, table: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL ``(T,)`` fp32; differentiable in x and table (in
    reverse and in forward mode), and mapped by ``torch.func.vmap`` in
    one launch."""
    _check(x, table, labels)
    nll, _ = FusedCE.apply(x[None], table[None], labels[None])
    return nll[0]


def fused_ce_nll_lse(x: torch.Tensor, table: torch.Tensor,
                     labels: torch.Tensor):
    """``(nll, lse)`` ``(T,)`` fp32: the per-token NLL and the logsumexp
    over the table's rows, both differentiable (a vocabulary split over
    ranks combines the ranks' logsumexps)."""
    _check(x, table, labels)
    nll, lse = FusedCE.apply(x[None], table[None], labels[None])
    return nll[0], lse[0]


def fused_ce(x: torch.Tensor, table: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL. x (B, S, D) or (T, D); labels matching the
    leading dims."""
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
        labels = labels.reshape(-1)
    return fused_ce_nll(x, table, labels).mean()


fused_ce.launches = 0
