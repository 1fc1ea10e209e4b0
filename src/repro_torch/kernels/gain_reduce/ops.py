"""Wrapper of the ``gain_reduce`` CUDA kernel (``csrc/gain_reduce.cu``).

``gain_reduce(g, h)`` returns ``[gᵀg, gᵀh]`` in fp32 for each row of
two ``(A, N)`` (or 1-D, ``A = 1``) tensors of equal shape and dtype,
fp32 or bf16.  For tensors on the CPU it computes the plain version in
``ref.py``; for tensors on a CUDA device it launches the kernel, or
raises — nothing falls back.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file (named by a hash of the source, so an edited
source is rebuilt), and loaded with ``ctypes``.
``gain_reduce.launches`` counts the kernel launches made through this
wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.gain_reduce.ref import gain_reduce_ref

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "gain_reduce.cu"
BUILD_DIR = _HERE / "build"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building gain_reduce needs the "
                       "CUDA toolkit")


def library_path() -> Path:
    """Where the shared library for the current source lives."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgain_reduce_{tag}.so"


def build() -> Path:
    """Compile the kernel if its library is not built yet; returns the
    library's path.  ``nvcc``'s messages (``-Xptxas -v``: registers,
    shared memory, spills) are kept beside it as ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


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
    if g.device.type == "cpu":
        return gain_reduce_ref(g, h)
    if g.device.type != "cuda":
        raise ValueError(f"gain_reduce: unsupported device {g.device}")
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
