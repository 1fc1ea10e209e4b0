"""Op-level cost of a traced step (port of ``repro.analysis.hlo_cost``).

The JAX package reads XLA's compiled HLO, and needs a trip-count-aware
walk because ``cost_analysis`` counts a ``while`` body once.  The port
runs eagerly: every aten op that reaches the dispatcher is one kernel
on the card, which reads its operands from HBM and writes its outputs
there, and Python loops replace ``while`` bodies, so the trip counts
are the real ones.  :class:`CostCounter` is a ``TorchDispatchMode``
that counts, per op (the rules of ``hlo_cost.CostAnalyzer``):

* **flops** — ``2·M·N·K`` for the products (``mm``/``bmm``/``mv``/
  ``dot``, and ``addmm``/``baddbmm`` plus one per output element for the
  add; ``einsum`` and ``matmul`` reach the dispatcher as these), one per
  output element for a pointwise op, the input's elements for a
  reduction, 5 and 4 per element for a softmax's forward and backward,
  none for data movement (copies, ``cat``, gathers, scatters, sorts);
* **HBM bytes** — operand bytes plus output bytes; views, ``empty``,
  ``detach`` and their kind are free (``_FREE_OPS``); a gather reads
  what it produces (twice its output, plus its indices); an in-place
  update of a region reads and writes the region (twice the update,
  the KV-cache write); a fill or a copy into a tensor does not read
  its target;
* **device ops** — a count, and a per-op-name table (:meth:`top`).

The hand-written kernels report their own costs: each kernel's
``ops.py`` calls :func:`kernel_call` with the work of the function (the
window's work for ``swa_attention``, not its plain version's S×S) and
each input read once and each output written once, and the counter
skips the aten ops of a plain version run inside that call.  So one
step counts the same on the CPU, on ``meta`` and on the card.  The
kernels' backward and ``jvp`` rules are plain PyTorch and count as such.

:class:`MemoryTracker` is the counterpart of XLA's ``memory_analysis()``:
the high-water of the storage allocated while it is active and live at
once, found by following every new storage to its release.

Collectives (the counterpart of ``repro.analysis.hlo_stats``'s
``collective_stats``): every collective the port issues goes through a
:class:`~repro_torch.launch.mesh.Mesh` method, which records its kind,
operand bytes and group size with :func:`collective_call` on the mesh's
:class:`CollectiveLog` and on every active counter.  Wire bytes follow
the ring algorithms' factors for a group of n: all-reduce 2·b·(n−1)/n,
all-gather b·(n−1), reduce-scatter and all-to-all b·(n−1)/n,
collective-permute b.  A step on one card issues none: ``wire_bytes``
is 0 and ``collectives`` empty.  With no ``while`` loops
``unannotated_whiles`` is always 0.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops with no device work of their own (hlo_cost._FREE_OPS); views are
# free too (``OpOverload.is_view``)
_FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "_unsafe_view",
    "_reshape_alias", "resize_", "set_", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type",
})
# products: the operand whose last dim is the contraction, and whether
# the op adds a tensor to the product
_PRODUCTS = {"mm": (0, False), "bmm": (0, False), "mv": (0, False),
             "dot": (0, False), "vdot": (0, False), "addmm": (1, True),
             "baddbmm": (1, True), "addmv": (1, True)}
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "norm", "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
    "cumsum", "cumprod", "argmax", "argmin", "all", "any", "nansum",
    "count_nonzero",
})
# flops per element: max, subtract, exp, sum, divide (log) forward;
# product, sum, subtract, product backward
_SOFTMAX = {"_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 4,
            "_log_softmax_backward_data": 4}
# copies: data movement, not arithmetic (XLA's copy and convert)
_MOVES = frozenset({"clone", "_to_copy", "copy_", "contiguous"})
# ops that read only what they produce
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "take"})
# in-place updates of a region of their first operand: the update is
# the last tensor operand
_UPDATES = frozenset({"index_put_", "index_copy_", "index_add_",
                      "scatter_", "scatter_add_", "scatter_reduce_",
                      "masked_scatter_"})
# ops that write their first operand (or a new tensor) without reading it
_OVERWRITES = frozenset({"copy_", "fill_", "zero_", "zeros_like",
                         "ones_like", "full_like", "new_zeros", "new_ones",
                         "new_full", "normal_", "uniform_", "random_"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_leaves(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def op_cost(func, args, kwargs, out) -> Optional[Tuple[float, float,
                                                        float]]:
    """``(flops, dot_flops, hbm_bytes)`` of one aten op, or ``None`` for
    a free one."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _FREE_OPS:
        return None
    ins, outs = tensor_leaves((args, kwargs)), tensor_leaves(out)
    out_bytes = sum(_nbytes(t) for t in outs)
    if name in _GATHERS:
        nbytes = 2 * out_bytes + sum(_nbytes(t) for t in ins[1:])
    elif name in _UPDATES:
        nbytes = 2 * _nbytes(ins[-1]) + sum(_nbytes(t) for t in ins[1:-1])
    elif name in _OVERWRITES:
        nbytes = sum(_nbytes(t) for t in ins[1:]) + out_bytes
    else:
        nbytes = sum(_nbytes(t) for t in ins) + out_bytes
    numel = outs[0].numel() if outs else 0
    dot = 0.0
    if name in _PRODUCTS:
        which, adds = _PRODUCTS[name]
        k = args[which].shape[-1]
        dot = 2.0 * max(numel, 1) * k
        flops = dot + (numel if adds else 0)
    elif name in _MOVES:
        flops = 0.0
    elif torch.Tag.pointwise in func.tags:
        flops = float(numel)
    elif name in _REDUCTIONS:
        flops = float(ins[0].numel()) if ins else 0.0
    elif name in _SOFTMAX:
        flops = float(_SOFTMAX[name] * numel)
    else:
        flops = 0.0
    return flops, dot, float(nbytes)


def wire_bytes(kind: str, operand_bytes: float, group_size: int) -> float:
    """Bytes one rank sends for one collective (``hlo_stats``' factors)."""
    n = max(int(group_size), 1)
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (n - 1) / n
    if kind == "all-gather":
        return float(operand_bytes * (n - 1))
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * (n - 1) / n
    if kind in ("collective-permute", "gather"):
        return float(operand_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


class CollectiveLog:
    """Per-kind ``{count, operand_bytes, wire_bytes}`` of the collectives
    recorded on it, and the same per call-site tag and per kind and mesh
    axes (``"all-reduce@model"``; a call recorded without its axes goes
    under ``"@mesh"``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._kinds: Dict[str, dict] = {}
        self._tags: Dict[str, dict] = {}
        self._axes: Dict[str, dict] = {}

    def record(self, kind: str, operand_bytes: int, group_size: int,
               tag: str, axes=None) -> None:
        wire = wire_bytes(kind, operand_bytes, group_size)
        where = f"{kind}@{','.join(axes) if axes else 'mesh'}"
        for table, key in ((self._kinds, kind), (self._tags, tag),
                           (self._axes, where)):
            row = table.setdefault(key, {"count": 0, "operand_bytes": 0,
                                         "wire_bytes": 0.0})
            row["count"] += 1
            row["operand_bytes"] += int(operand_bytes)
            row["wire_bytes"] += wire

    def stats(self) -> Dict[str, dict]:
        """``hlo_stats.collective_stats``' table: kind → counts."""
        return {k: dict(v) for k, v in self._kinds.items()}

    def by_tag(self) -> Dict[str, dict]:
        return {k: dict(v) for k, v in self._tags.items()}

    def by_axis(self) -> Dict[str, dict]:
        """``"kind@axes"`` → counts: which mesh axes each kind ran over."""
        return {k: dict(v) for k, v in self._axes.items()}


def total_wire_bytes(stats: Dict[str, dict]) -> float:
    """The wire bytes of a :meth:`CollectiveLog.stats` table."""
    return float(sum(s["wire_bytes"] for s in stats.values()))


def collective_call(log: CollectiveLog, kind: str, operand_bytes: int,
                    group_size: int, tag: str, axes=None) -> None:
    """Record one collective (over the mesh ``axes``, where given) on
    ``log`` and on every active counter."""
    log.record(kind, operand_bytes, group_size, tag, axes)
    for c in _ACTIVE:
        c.collectives.record(kind, operand_bytes, group_size, tag, axes)


@dataclass
class OpCost:
    count: int = 0
    flops: float = 0.0
    hbm_bytes: float = 0.0


# the counters active now, innermost last (kernel_call records on each)
_ACTIVE: List["CostCounter"] = []


class CostCounter(TorchDispatchMode):
    """Counts the flops, HBM bytes and device ops of what runs while it
    is active (``with CostCounter() as c: step(...)``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.device_ops = 0
        self.by_op: Dict[str, OpCost] = defaultdict(OpCost)
        self.collectives = CollectiveLog()
        # every dispatched op's name and its outputs' shapes (costed or
        # not): repro_torch.analysis.hlo_stats reads them
        self.op_names: Dict[str, int] = defaultdict(int)
        self.shapes: Dict[tuple, int] = defaultdict(int)
        self._muted = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add(self, name: str, flops: float, hbm_bytes: float,
            dot_flops: float = 0.0) -> None:
        self.flops += flops
        self.dot_flops += dot_flops
        self.hbm_bytes += hbm_bytes
        self.device_ops += 1
        row = self.by_op[name]
        row.count += 1
        row.flops += flops
        row.hbm_bytes += hbm_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._muted:
            self.op_names[func.overloadpacket.__name__] += 1
            for t in tensor_leaves(out):
                self.shapes[tuple(t.shape)] += 1
            cost = op_cost(func, args, kwargs, out)
            if cost is not None:
                flops, dot, nbytes = cost
                self.add(func.overloadpacket.__name__, flops, nbytes, dot)
        return out

    def top(self, n: int, key: str = "hbm_bytes") -> List[Tuple[str,
                                                              OpCost]]:
        """The ``n`` op names with the most ``key``."""
        return sorted(self.by_op.items(),
                      key=lambda kv: -getattr(kv[1], key))[:n]


def summarize(cost: CostCounter) -> dict:
    """``hlo_cost.summarize``'s keys (no ``while`` loops), and the device
    ops."""
    return {
        "flops": cost.flops,
        "hbm_bytes": cost.hbm_bytes,
        "wire_bytes": total_wire_bytes(cost.collectives.stats()),
        "collectives": cost.collectives.stats(),
        "unannotated_whiles": 0,
        "device_ops": cost.device_ops,
    }


def kernel_call(name: str, flops: float, hbm_bytes: float):
    """A context that records one launch of the hand-written kernel
    ``name`` on every active counter and mutes them for what runs inside
    it (the plain version on the CPU, an empty result on ``meta``, the
    launch on the card); with no counter active, an empty context."""
    if not _ACTIVE:
        return contextlib.nullcontext()
    return _muted(list(_ACTIVE), f"kernel:{name}", flops, hbm_bytes)


@contextlib.contextmanager
def _muted(active, name: str, flops: float, hbm_bytes: float):
    for c in active:
        c.add(name, flops, hbm_bytes)
        c._muted += 1
    try:
        yield
    finally:
        for c in active:
            c._muted -= 1


class MemoryTracker(TorchDispatchMode):
    """The high-water (``peak_bytes``) of the storage allocated while it
    is active and live at once.  A storage is new when an op's output
    lies in it and none of the op's inputs does; it is live until the
    storage itself is freed, whatever the tensors that held it (a
    storage's Python object lives exactly as long as the storage, so a
    finalizer on it marks the release)."""

    def __init__(self):
        super().__init__()
        self.peak_bytes = 0
        self.live_bytes = 0
        self._live: Dict[int, int] = {}  # storage address -> bytes

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def new_bytes(self, tree) -> int:
        """Bytes of the live storages of ``tree``'s tensors that were
        allocated while the tracker was active (each storage once)."""
        keys = {t.untyped_storage()._cdata for t in tensor_leaves(tree)}
        return sum(self._live[k] for k in keys if k in self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = None
        for t in tensor_leaves(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            if inputs is None:
                inputs = {x.untyped_storage()._cdata
                          for x in tensor_leaves((args, kwargs))}
            if key in inputs:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key)
        return out
