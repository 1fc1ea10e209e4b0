"""Trace-level materialization checks over the aten ops a step
dispatches (port of ``repro.analysis.hlo_stats``' ``shape_census`` and
``scan_flops_note``).

The JAX package reads them off the lowered program's IR text; the port
has no IR, so they read what :class:`repro_torch.analysis.cost.
CostCounter` saw while the step ran under it: every dispatched op's
name and the shapes of its outputs (below ``torch.func`` and autograd,
so a vmapped step's per-agent buffers appear with their agent axis).
The hand-written kernels' plain versions are muted there, as in the
cost counts.  ``collective_stats`` is the counter's
:class:`~repro_torch.analysis.cost.CollectiveLog`.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.analysis.cost import CostCounter

# aten ops that move or re-view data (``scan_flops_note``'s "transpose"
# and "reshape")
_TRANSPOSES = ("transpose", "t", "permute", "movedim", "swapaxes")
_RESHAPES = ("reshape", "view", "_unsafe_view", "flatten", "unflatten",
             "expand", "squeeze", "unsqueeze")


def shape_census(counter: CostCounter) -> Dict[tuple, int]:
    """Count the array-buffer shapes (dim tuples) the traced ops
    produced: a padded epilogue layout shows up as ``(P, s_max, ...)``
    buffers that a correctly-sized blocked layout never creates, so a
    test can assert a shape's absence."""
    return dict(counter.shapes)


def scan_flops_note(counter: CostCounter) -> Dict[str, int]:
    """Counts of ops that hint at remat or layout waste: transposes,
    reshapes, and the IR's ``while`` loops and fusions, which eager
    PyTorch does not have (always 0)."""
    ops = counter.op_names
    return {"transpose": sum(ops.get(k, 0) for k in _TRANSPOSES),
            "reshape": sum(ops.get(k, 0) for k in _RESHAPES),
            "while": 0, "fusion": 0}
