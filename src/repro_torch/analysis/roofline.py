"""Three-term roofline of one NVIDIA H100 SXM (port of
``repro.analysis.roofline``, whose constants are the TPU's).

    compute    = flops      / (chips × peak of the step's path)
    memory     = HBM bytes  / (chips × HBM_BW)
    collective = wire bytes / LINK_BW

The flops and bytes are :mod:`repro_torch.analysis.cost`'s counts of the
traced step.  The compute peak is the one of the arithmetic path the
step takes, and the record names it: a float32 step's products run on
the CUDA cores (the port keeps ``torch.backends.cuda.matmul.allow_tf32``
off, so fp32 SGEMM is 67 TFLOP/s; with it on, TF32 at 494.7), a bf16
step's on the tensor cores (989).  ``LINK_BW``, the collective term,
waits for the multi-device port (ROADMAP queue 1 item 11.2): until then
it is 0 and so is ``t_collective``.

MODEL_FLOPS (analytic "useful" compute) = 6·N·D for training (fwd+bwd)
and 2·N·D for inference, with N = active parameter count — the ratio
MODEL_FLOPS / counted flops exposes recompute, probe and dispatch work.

Peaks from NVIDIA's H100 SXM data sheet, dense (no sparsity), at the
card's full 700 W: bf16 989 TFLOP/s, TF32 494.7, fp32 67 (CUDA cores),
HBM 3.35 TB/s, 80 GB.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

# peak rate of each arithmetic path, ops/s (the kernels' ``path`` names
# included: ``tf32x3`` and ``bf16-mma`` run on the tensor cores,
# ``fp32-fma`` on the CUDA cores)
PEAK_FLOPS: Dict[str, float] = {
    "fp32": 67e12,
    "fp32-fma": 67e12,
    "tf32": 494.7e12,
    "tf32x3": 494.7e12,
    "bf16": 989e12,
    "bf16-mma": 989e12,
}
HBM_BW = 3.35e12        # bytes/s
HBM_BYTES = 80e9        # bytes
LINK_BW = 0.0           # bytes/s of a link: multi-device, item 11.2


def step_path(compute_dtype: str) -> str:
    """The path a step's products take at ``compute_dtype``."""
    if compute_dtype == "bfloat16":
        return "bf16"
    if compute_dtype == "float32":
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"
    raise ValueError(f"no roofline path for compute dtype {compute_dtype!r}")


def kernel_bound(flops: float, nbytes: float, path: str) -> Tuple[float,
                                                                   str]:
    """``(ms, bound_by)``: the least time of one kernel call that runs
    ``flops`` operations on ``path`` and moves ``nbytes`` (each input
    read once, each output written once), and which of the two bounds
    it (``"operations"`` or ``"bytes"``)."""
    t_ops = flops / PEAK_FLOPS[path] * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_global: float
    path: str = "bf16"
    collectives: Dict[str, dict] = field(default_factory=dict)
    peak_memory_per_device: Optional[float] = None

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.path]

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / LINK_BW if LINK_BW else 0.0

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        counted = self.flops_per_device * self.chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def bound_step_time(self) -> float:
        """Lower bound on step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model FLOPs utilization implied by the roofline."""
        t = self.bound_step_time
        if not t:
            return 0.0
        return self.model_flops_global / (self.chips * self.peak_flops * t)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "path": self.path,
            "peak_flops": self.peak_flops,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu_bound,
            "collectives": self.collectives,
            "peak_memory_per_device": self.peak_memory_per_device,
        }


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6·N_active·D train, 2·N_active·D/token decode."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n * shape.global_batch
