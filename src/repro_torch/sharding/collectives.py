"""The collectives that XLA's SPMD partitioner inserts in the JAX
package, written out for the port's ranks (port-only).

The JAX package annotates tensors with their layout and lets XLA derive
the communication.  The port has no partitioner, so a model running on
a (data, model) mesh calls these itself.  Each is a
``torch.autograd.Function`` in the form ``torch.func`` composes with
(``forward`` without ``ctx``, ``setup_context``, a ``vmap`` rule that
issues ONE collective for every mapped slice, and a ``jvp`` rule for
forward mode), so they run inside the train step's per-agent
``vmap(grad)`` and under ``gain_quadratic``'s ``jvp(grad)``:

* :func:`reduce_from_model` — all_reduce (sum) forward, identity
  backward: the row-parallel output of a layer whose cotangent is the
  same on every model rank;
* :func:`copy_to_model` — identity forward, all_reduce backward (built
  from :func:`reduce_from_model`, so that the backward itself carries
  forward-mode tangents): a replicated tensor entering a computation
  split over the model axis;
* :func:`gather_from_data` — the global (over the data axes) tensor from
  this rank's block: a zero-filled buffer holding the block, summed over
  the data group (exact, and the one collective gloo runs on CUDA
  tensors); over the model axis, the same call makes a per-agent
  gradient's blocks whole (:func:`repro_torch.sharding.constraint.
  whole_over_model`);
* :func:`vocab_parallel_nll` — the cross-entropy over a vocabulary split
  over the model axis: each rank runs the ``fused_ce`` kernel on its
  block of the table, and the ranks combine the logsumexps and the gold
  logits;
* :func:`gather_vocab` — a serving step's logits over the rank's block
  of the vocabulary, made whole over the model axis.

The model axis of the running step comes from :func:`tensor_parallel`,
a context that the mesh step enters for the duration of a call; with no
context every layer computes whole.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_ce.ops import fused_ce_nll_lse


@dataclass(frozen=True)
class Where:
    """A collective's mesh, axes and log tag, with the reduction op."""

    mesh: object
    axes: Tuple[str, ...]
    tag: str
    op: str = "sum"


@dataclass(frozen=True)
class ModelAxis:
    """The model axis of a running mesh step: its size and this rank's
    index on it."""

    mesh: object
    axes: Tuple[str, ...] = ("model",)

    @property
    def size(self) -> int:
        return self.mesh.axes_size(self.axes)

    @property
    def index(self) -> int:
        return self.mesh.axes_index(self.axes)

    def where(self, tag: str, op: str = "sum") -> Where:
        return Where(self.mesh, self.axes, tag, op)


_TP: contextvars.ContextVar[Optional[ModelAxis]] = contextvars.ContextVar(
    "tensor_parallel_axis", default=None)


@contextlib.contextmanager
def tensor_parallel(axis: Optional[ModelAxis]):
    """Run the body with ``axis`` as the model axis (None: none)."""
    token = _TP.set(axis)
    try:
        yield axis
    finally:
        _TP.reset(token)


def _need_axis(what: str) -> ModelAxis:
    axis = _TP.get()
    if axis is None:
        raise RuntimeError(
            f"{what}: the weights are split over a model axis but no mesh "
            f"step is running (repro_torch.sharding.collectives."
            f"tensor_parallel)")
    return axis


def shard_offset(local: int, whole: int, what: str) -> Optional[int]:
    """Where this rank's block of a dim of size ``whole`` starts, given
    the block's size ``local``; None where the dim is whole here."""
    if local == whole:
        return None
    axis = _need_axis(what)
    if local * axis.size != whole:
        raise ValueError(f"{what}: a block of {local} is not 1/"
                         f"{axis.size} of {whole}")
    return axis.index * local


def _fold(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    return x if dim is None else x.movedim(dim, 0)


def _out_dim(dim: Optional[int]) -> Optional[int]:
    return None if dim is None else 0


class _AllReduce(torch.autograd.Function):
    """All-reduce forward, identity backward (``op`` "max" only on
    inputs that carry no gradient)."""

    @staticmethod
    def forward(x, where):
        y = x.contiguous().clone()
        where.mesh.all_reduce(y, where.tag, where.axes, op=where.op)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.where = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, dx, _dwhere):
        if ctx.where.op != "sum":
            return torch.zeros_like(dx)
        return _AllReduce.apply(dx, ctx.where)

    @staticmethod
    def vmap(info, in_dims, x, where):
        return (_AllReduce.apply(_fold(x, in_dims[0]), where),
                _out_dim(in_dims[0]))


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(x, where):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.where = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.where), None

    @staticmethod
    def jvp(ctx, dx, _dwhere):
        return dx.clone()

    @staticmethod
    def vmap(info, in_dims, x, where):
        return (_CopyToModel.apply(_fold(x, in_dims[0]), where),
                _out_dim(in_dims[0]))


def reduce_from_model(x: torch.Tensor, tag: str = "tp_reduce") -> torch.Tensor:
    """Sum ``x`` over the model axis (identity backward); ``x`` itself
    where no model axis runs."""
    axis = _TP.get()
    if axis is None or axis.size == 1:
        return x
    return _AllReduce.apply(x, axis.where(tag))


def copy_to_model(x: torch.Tensor, tag: str = "tp_copy") -> torch.Tensor:
    """``x`` (its cotangent summed over the model axis); ``x`` itself
    where no model axis runs."""
    axis = _TP.get()
    if axis is None or axis.size == 1:
        return x
    return _CopyToModel.apply(x, axis.where(tag))


def max_over_model(x: torch.Tensor, tag: str = "tp_max") -> torch.Tensor:
    """The elementwise maximum over the model axis of a tensor that
    carries no gradient (a stabilising shift)."""
    axis = _TP.get()
    if axis is None or axis.size == 1:
        return x
    return _AllReduce.apply(x, axis.where(tag, op="max"))


def gather_from_data(x: torch.Tensor, index: Tuple[slice, ...],
                     shape: Tuple[int, ...], where: Where) -> torch.Tensor:
    """The tensor of ``shape`` whose block ``index`` is this rank's
    ``x``, from every rank of ``where``'s axes: a zero-filled buffer
    summed over them (leading dims of ``x`` beyond ``shape``'s, an agent
    axis, ride along).  Its backward is the identity on the block: right
    where the cotangent is the same on every rank of the axes."""
    pad = []
    for s, n in reversed(list(zip(index, shape))):
        pad += [s.start, n - s.stop]
    return _AllReduce.apply(F.pad(x, pad), where)


def gather_vocab(logits: torch.Tensor, vocab_size: int,
                 tag: str = "tp_logits") -> torch.Tensor:
    """Logits ``(..., V / tp)`` over this rank's block of a vocabulary
    split over the model axis, made whole ``(..., V)`` on every model
    rank (the zero-padded block summed: exact); ``logits`` itself where
    the vocabulary is whole here."""
    v0 = shard_offset(logits.shape[-1], vocab_size, "gather_vocab")
    if v0 is None:
        return logits
    lead = tuple(logits.shape[:-1])
    index = tuple(slice(0, n) for n in lead) + (
        slice(v0, v0 + logits.shape[-1]),)
    return gather_from_data(logits, index, lead + (vocab_size,),
                            _need_axis("gather_vocab").where(tag))


def vocab_parallel_nll(x: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, vocab_size: int
                       ) -> torch.Tensor:
    """Per-token NLL ``(T,)`` fp32 of x ``(T, D)`` against this rank's
    block ``table`` ``(V / tp, D)`` of a vocabulary of ``vocab_size``,
    split over the model axis.

    Each rank runs the ``fused_ce`` kernel on its block (labels outside
    it point at row 0, whose NLL is not read) for its logsumexp lse_r;
    the ranks combine lse = m + log Σ_r exp(lse_r − m) with m the
    maximum over them.  The gold logit x_t · table[label_t] is formed
    exactly by the rank that holds the label's row (a row-wise dot, not
    lse_r − nll_r) and summed over the ranks (one term is not zero).
    Gradients: through the kernel's backward at the global softmax
    (its logsumexp cotangent), and x's summed over the model axis."""
    v0 = shard_offset(table.shape[0], vocab_size, "vocab_parallel_nll")
    if v0 is None:
        return fused_ce_nll_lse(x, table, labels)[0]
    rel = labels.long() - v0
    inside = (rel >= 0) & (rel < table.shape[0])
    rows = torch.where(inside, rel, torch.zeros_like(rel))
    xc = copy_to_model(x, "ce_copy")
    _, lse_r = fused_ce_nll_lse(xc, table, rows)
    gold_r = torch.where(inside, (xc.float() * table[rows].float()).sum(-1),
                         torch.zeros_like(lse_r))
    m = max_over_model(lse_r.detach(), "ce_max")
    lse = m + torch.log(reduce_from_model(torch.exp(lse_r - m), "ce_lse"))
    return lse - reduce_from_model(gold_r, "ce_gold")
