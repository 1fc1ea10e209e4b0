"""Wrapper of the ``gain_reduce`` CUDA kernel (``csrc/gain_reduce.cu``).

``gain_reduce(g, h)`` returns ``[gᵀg, gᵀh]`` in fp32 for each row of
two ``(A, N)`` (or 1-D, ``A = 1``) tensors of equal shape and dtype,
fp32 or bf16.  For tensors on the CPU it computes the plain version in
``ref.py``; for tensors on a CUDA device it launches the kernel, or
raises — nothing falls back; for tensors on ``meta`` (the dry-run's
shape-only trace) it returns an empty result of the right shape.  Each
call records its work (:func:`cost`) with an active cost counter
(:func:`repro_torch.analysis.cost.kernel_call`).

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file (:mod:`repro_torch.kernels.build`), and
loaded with ``ctypes``.
``gain_reduce.launches`` counts the kernel launches made through this
wrapper.

Under ``torch.func.vmap`` (the frontier maps the whole train step over
its grid of lanes) the ``vmap`` rule of :class:`GainReduce` moves each
mapped dim to the front and folds it into the kernel's rows: one launch
serves every lane, counted once, and the ``(rows, 2)`` result is
unfolded to the lanes.  Nested maps fold level by level into the same
one launch.  On the CPU the rule folds the same way and computes the
plain version.  The kernel has no gradient: a CUDA input that requires
grad raises instead of giving a result detached from the graph.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from repro_torch.analysis.cost import kernel_call
from repro_torch.kernels import build as _build
from repro_torch.kernels.gain_reduce.ref import gain_reduce_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gain_reduce.cu"
BUILD_DIR = SOURCE.parent.parent / "build"
NVCC_FLAGS = _build.NVCC_FLAGS

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def cost(rows: int, n: int, dtype: torch.dtype) -> dict:
    """The work of one call: ``flops``, 2·rows·n multiply-adds (gᵀg and
    gᵀh); ``hbm_bytes``, g and h read once and the (rows, 2) fp32 result
    written once; ``path`` and ``path_flops``, fp32 FMAs on the CUDA
    cores."""
    itemsize = dtype.itemsize
    flops = 4 * rows * n
    return {"flops": flops, "hbm_bytes": 2 * rows * n * itemsize + rows * 8,
            "path": "fp32-fma", "path_flops": flops}


def library_path() -> Path:
    """Where the shared library for the current source lives."""
    return _build.library_path(SOURCE)


def build() -> Path:
    """Compile the kernel if its library is not built yet (see
    :mod:`repro_torch.kernels.build`); returns the library's path."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.gain_reduce_splits.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.gain_reduce_splits.restype = ctypes.c_int64
    lib.gain_reduce_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gain_reduce_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _splits(n: int, code: int) -> int:
    """Stage-1 blocks per row of ``n`` elements (the kernel's plan)."""
    return _library().gain_reduce_splits(n, code)


def _check(g: torch.Tensor, h: torch.Tensor) -> None:
    if g.shape != h.shape:
        raise ValueError(f"gain_reduce: shapes differ {tuple(g.shape)} "
                         f"vs {tuple(h.shape)}")
    if g.dtype != h.dtype:
        raise TypeError(f"gain_reduce: dtypes differ {g.dtype} vs {h.dtype}")
    if g.device != h.device:
        raise ValueError(f"gain_reduce: devices differ {g.device} vs "
                         f"{h.device}")
    if g.ndim not in (1, 2) or g.shape[-1] < 1 or (g.ndim == 2
                                                   and g.shape[0] < 1):
        raise ValueError(f"gain_reduce: expected non-empty (A, N) or (N,) "
                         f"rows, got {tuple(g.shape)}")


def gain_reduce(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``[gᵀg, gᵀh]`` per row, fp32, shape ``g.shape[:-1] + (2,)``."""
    _check(g, h)
    if g.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"gain_reduce: unsupported device {g.device}")
    if g.device.type == "cuda" and (g.requires_grad or h.requires_grad):
        raise RuntimeError(
            "gain_reduce: the kernel has no gradient; call it on tensors "
            "that do not require grad")
    if any(is_functorch_wrapped_tensor(x) for x in (g, h)):
        return GainReduce.apply(g, h)
    return GainReduce.forward(g, h)


class GainReduce(torch.autograd.Function):
    """The kernel (on the CPU, its plain version) with a ``vmap`` rule
    that folds the mapped dims into the rows, and no backward."""

    @staticmethod
    def forward(g, h):
        rows, n = (1, g.shape[0]) if g.ndim == 1 else tuple(g.shape)
        work = cost(rows, n, g.dtype)
        with kernel_call("gain_reduce", work["flops"], work["hbm_bytes"]):
            if g.device.type == "cpu":
                return gain_reduce_ref(g, h)
            if g.device.type == "meta":
                return torch.empty(g.shape[:-1] + (2,), dtype=torch.float32,
                                   device="meta")
            return _launch(g, h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, g, h):
        n = info.batch_size

        def fold(t, dim):
            # the mapped dim first (an unmapped input is expanded to it),
            # then lanes × rows as one row axis of a contiguous tensor
            t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
            return t.reshape(-1, t.shape[-1]).contiguous()

        out = GainReduce.apply(fold(g, in_dims[0]), fold(h, in_dims[1]))
        # one lane's rows: its input's shape without the mapped dim
        dim = in_dims[0]
        lane = g.shape if dim is None else g.shape[:dim] + g.shape[dim + 1:]
        return out.reshape(n, *lane[:-1], 2), 0


def _launch(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel over plain, contiguous CUDA rows."""
    _check(g, h)
    code = _DTYPE_CODES.get(g.dtype)
    if code is None:
        raise TypeError(f"gain_reduce: the kernel takes float32 or "
                        f"bfloat16, got {g.dtype}")
    if not (g.is_contiguous() and h.is_contiguous()):
        raise ValueError("gain_reduce: inputs must be contiguous")
    lib = _library()
    rows, n = (1, g.shape[0]) if g.ndim == 1 else tuple(g.shape)
    out = torch.empty((rows, 2), dtype=torch.float32, device=g.device)
    nsplit = _splits(n, code)
    scratch = (torch.empty((rows, nsplit, 2), dtype=torch.float32,
                           device=g.device) if nsplit > 1 else None)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gain_reduce_launch(
            g.data_ptr(), h.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            rows, n, code, stream,
        )
    if err != 0:
        raise RuntimeError(f"gain_reduce: kernel launch failed with CUDA "
                           f"error {err}")
    gain_reduce.launches += 1
    return out[0] if g.ndim == 1 else out


gain_reduce.launches = 0
