"""Device resolution for the port's entry points.

Entry points run on the card by default (``device="cuda"``).  Asking
for CUDA on a machine without it raises; nothing falls back to the CPU
on its own — the CPU runs only where the caller names it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a concrete ``torch.device`` (``"cuda"`` becomes the
    current card's index, so it compares equal to a tensor's device)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not "
                "available; pass device='cpu' to run the port's plain "
                "versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
