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
  tensors);
* :func:`gather_seq` / :func:`scatter_seq` — sequence parallelism
  (``seq_shard``): a chunk of the sequence made whole over the model axis
  (the zero-padded chunk summed; its backward sums the cotangent over
  the ranks and keeps the chunk: a reduce-scatter), and a row-parallel
  partial sum reduced and cut to the rank's chunk (its backward the
  gather); :func:`gather_ids` makes token ids, labels or a mask whole
  over the sequence (no gradient); :func:`region_in` and
  :func:`region_out` pick, at the entry to a region the model ranks
  compute together and at its exit, tensor parallelism's collective or
  sequence parallelism's;
* :func:`gather_model` — a weight's model block made whole for a rank
  that computes on its own tokens (``inner_batch_shard``): the gather,
  whose backward sums the ranks' cotangents and keeps the block (also
  the mLSTM's gate columns, of which each rank uses its own heads');
* :func:`sum_over_model` — a sum over a dim that the model ranks split
  (a gated norm's sum of squares over the ``ff`` columns), its cotangent
  summed too (each rank's comes from its own columns);
  :func:`reduce_scatter` — a partial sum over the model axis, each rank
  keeping its block of one dim (the mLSTM's q, k and v: partial over
  ``ff``, kept on the rank's heads), the backward the gather;
* :func:`vocab_parallel_nll` — the cross-entropy over a vocabulary split
  over the model axis: each rank runs the ``fused_ce`` kernel on its
  block of the table, and the ranks combine the logsumexps and the gold
  logits;
* :func:`gather_vocab` — a serving step's logits over the rank's block
  of the vocabulary, made whole over the model axis;
* :func:`gather_columns` — blocks made whole, in one call, for a
  computation that every model rank repeats (a moe router's logits over
  the rank's experts, the sLSTM's recurrent weights): its backward keeps
  the rank's block of the cotangent, or where the ranks split the
  tokens sums their shares first; :func:`whole_term` — a term every rank computes whole from
  all of an agent's tokens (the router's aux loss) with 1/n of its
  cotangent on each rank, so the split modes' sums count it once;
* :func:`gather_rows` / :func:`own_rows` — a serving batch's rows made
  whole over the data axes (:func:`batch_rows`: the moe router sees the
  whole batch, as JAX's one global computation does) and the rank's
  rows again.

The model axis of the running step comes from :func:`tensor_parallel`,
a context that the mesh step enters for the duration of a call; with no
context every layer computes whole.  The axis also says what of the
tokens the model ranks split (:func:`tokens_split`): nothing (tensor
parallelism: every model rank holds the same tokens), ``"seq"`` (each
holds its chunk of the sequence) or ``"rows"`` (its rows of each
agent's batch).  Gloo reduces CUDA tensors in ``all_reduce`` only, so
every gather and reduce-scatter here is an ``all_reduce`` of a
zero-filled buffer, or one followed by a slice.
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
    """The model axis of a running mesh step: its size, this rank's
    index on it, and what of the tokens it splits (``split``: None,
    ``"seq"`` or ``"rows"``)."""

    mesh: object
    axes: Tuple[str, ...] = ("model",)
    split: Optional[str] = None

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


def tokens_split() -> Optional[str]:
    """What of the tokens the running step's model ranks split: None
    (no model axis, or tensor parallelism), ``"seq"`` or ``"rows"``."""
    axis = _TP.get()
    return None if axis is None or axis.size == 1 else axis.split


def model_size() -> int:
    """The running step's model axis's size (1 without one)."""
    axis = _TP.get()
    return 1 if axis is None else axis.size


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
    """``x``, which every model rank holds whole and uses for its part of
    a split computation (its cotangent summed over the model axis);
    ``x`` itself where no model axis runs, and where the model ranks
    split the tokens: there ``x`` came from :func:`gather_seq`, whose
    backward sums, or is a whole weight, which the gather hook sums at
    its use."""
    axis = _TP.get()
    if axis is None or axis.size == 1 or axis.split is not None:
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
                       labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
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
    (its logsumexp cotangent), and x's summed over the model axis
    (:func:`copy_to_model`)."""
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


def _sum_both(x: torch.Tensor, where: Where) -> torch.Tensor:
    """``x`` summed over ``where``'s axes, its cotangent summed over them
    too (tag ``<tag>_grad``): the sum of terms that each rank's own
    tokens use."""
    back = Where(where.mesh, where.axes, where.tag + "_grad", where.op)
    return _CopyToModel.apply(_AllReduce.apply(x, where), back)


def _pad_dim(x: torch.Tensor, dim: int, before: int, after: int
             ) -> torch.Tensor:
    return F.pad(x, [0, 0] * (x.ndim - 1 - dim) + [before, after])


def seq_chunk(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of a tensor whole along the sequence ``dim``."""
    axis = _need_axis("seq_chunk")
    s = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * s, s)


def gather_seq(x: torch.Tensor, tag: str, dim: int = 1) -> torch.Tensor:
    """This rank's chunk ``x`` of the sequence (along ``dim``) made whole
    on every model rank: the chunk zero-padded and summed over "model"
    (exact).  Its backward sums the cotangent over the ranks (each holds
    the share of its heads, ``ff`` columns or vocabulary block) and
    keeps the chunk: a reduce-scatter."""
    axis = _need_axis("gather_seq")
    s = x.shape[dim]
    return _sum_both(_pad_dim(x, dim, axis.index * s,
                              (axis.size - 1 - axis.index) * s),
                     axis.where(tag))


def scatter_seq(x: torch.Tensor, tag: str, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of ``x`` summed over "model": a row-parallel
    output's reduce-scatter back to the sequence chunk.  Its backward
    gathers the chunk's cotangent over the sequence."""
    axis = _need_axis("scatter_seq")
    return seq_chunk(_sum_both(x, axis.where(tag)), dim)


def gather_ids(x: torch.Tensor, tag: str, dim: int = 1) -> torch.Tensor:
    """Token ids, labels or a mask: under ``seq_shard`` this rank's chunk
    of the sequence made whole (summed as fp32, exact below 2^24; no
    gradient), else ``x``."""
    if tokens_split() != "seq":
        return x
    axis = _TP.get()
    s = x.shape[dim]
    whole = _AllReduce.apply(_pad_dim(x.float(), dim, axis.index * s,
                                      (axis.size - 1 - axis.index) * s),
                             axis.where(tag))
    return whole.to(x.dtype)


def seq_positions(x: torch.Tensor) -> torch.Tensor:
    """(B, S) absolute positions 0 … S−1 of the sequence of the
    activation ``x``: under ``seq_shard`` the whole sequence whose chunk
    ``x`` (B, S / tp, D) is."""
    n = model_size() if tokens_split() == "seq" else 1
    return torch.arange(x.shape[1] * n,
                        device=x.device).expand(x.shape[0], -1)


def region_in(x: torch.Tensor, tag: str, split: bool = True
              ) -> torch.Tensor:
    """The input ``x`` of a region that the model ranks compute together
    (a layer's attention or MLP, the logits): under tensor parallelism,
    where the region's weights are split over the ranks (``split``),
    ``x`` with its cotangent summed over them (:func:`copy_to_model`,
    tag ``tp_<tag>``), else ``x``; under ``seq_shard`` the rank's chunk
    gathered over the sequence (:func:`gather_seq`, ``sp_<tag>``), which
    a split region needs and attention, which mixes the tokens, needs
    split or not; else ``x``."""
    if tokens_split() == "seq":
        return gather_seq(x, "sp_" + tag)
    return copy_to_model(x, "tp_" + tag) if split else x


def region_out(x: torch.Tensor, tag: str, split: bool = True
               ) -> torch.Tensor:
    """The output ``x`` of a region :func:`region_in` entered: where its
    weights are split (``split``), each rank's partial sum, summed over
    the model ranks (tensor parallelism: :func:`reduce_from_model`, tag
    ``tp_<tag>``) or reduce-scattered back to the rank's chunk of the
    sequence (``seq_shard``: :func:`scatter_seq`, ``sp_<tag>``); where
    they are whole, ``x`` (each rank computed all of it), cut to the
    rank's chunk under ``seq_shard``."""
    if tokens_split() == "seq":
        return scatter_seq(x, "sp_" + tag) if split else seq_chunk(x)
    return reduce_from_model(x, "tp_" + tag) if split else x


def gather_model(x: torch.Tensor, index: Tuple[slice, ...],
                 shape: Tuple[int, ...], where: Where) -> torch.Tensor:
    """A weight of ``shape`` whose block ``index`` is this rank's ``x``,
    made whole on every rank of ``where``'s axes for a computation on
    the rank's own tokens: the zero-filled buffer summed; its backward
    sums the ranks' cotangents and keeps the block."""
    pad = []
    for s, n in reversed(list(zip(index, shape))):
        pad += [s.start, n - s.stop]
    return _sum_both(F.pad(x, pad), where)


def _prefixed_tag(tag: str) -> str:
    return ("sp_" if tokens_split() == "seq" else "tp_") + tag


def model_where(tag: str) -> Where:
    """The running step's model axis, tagged ``tp_<tag>`` (``sp_<tag>``
    under ``seq_shard``)."""
    return _need_axis(tag).where(_prefixed_tag(tag))


def sum_over_model(x: torch.Tensor, tag: str) -> torch.Tensor:
    """``x``, each rank's partial sum over its block of a dim that the
    model ranks split, summed over "model"; its cotangent summed over
    "model" too, since each rank's comes from its own block (tag
    ``tp_<tag>``, ``sp_<tag>`` under ``seq_shard``, and ``…_grad``);
    ``x`` itself where no model axis runs."""
    axis = _TP.get()
    if axis is None or axis.size == 1:
        return x
    return _sum_both(x, axis.where(_prefixed_tag(tag)))


def reduce_scatter(x: torch.Tensor, tag: str, dim: int) -> torch.Tensor:
    """Each rank's partial sum ``x`` summed over "model", the rank
    keeping its block of ``dim`` (tag ``tp_<tag>`` or ``sp_<tag>``); the
    backward gathers the blocks' cotangents whole (:func:`scatter_seq`
    along any dim)."""
    return scatter_seq(x, _prefixed_tag(tag), dim)


def copy_over(x: torch.Tensor, where: Where) -> torch.Tensor:
    """``x`` itself, its cotangent summed over ``where``'s axes: a weight
    that every rank holds whole and uses on its own tokens."""
    return _CopyToModel.apply(x, where)


def whole_term(x: torch.Tensor) -> torch.Tensor:
    """A term that every model rank computes whole, from all of an
    agent's tokens, while the ranks split the tokens (``seq_shard``,
    ``inner_batch_shard``): its value, with 1/n of its cotangent on each
    of the n ranks, so that the sum over "model" that the split modes
    give every gradient counts it once (a moe layer's aux loss); ``x``
    itself where the ranks split no tokens."""
    if tokens_split() is None:
        return x
    share = x / model_size()
    return x.detach() + (share - share.detach())


_ROWS: contextvars.ContextVar[Optional[Where]] = contextvars.ContextVar(
    "batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(where: Optional[Where]):
    """Run the body with a serving batch's rows split over ``where``'s
    axes (None: whole here): a layer that must see the whole batch (the
    moe router's capacity and drops) gathers them
    (:func:`gather_rows`)."""
    token = _ROWS.set(where)
    try:
        yield where
    finally:
        _ROWS.reset(token)


def _rows_split() -> bool:
    """Whether the running serving step's batch rows are split."""
    where = _ROWS.get()
    return where is not None and where.mesh.axes_size(where.axes) > 1


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows ``x`` (dim 0) of a serving batch made whole over
    the batch's axes (the zero-padded block summed: exact; a serving
    step takes no gradient), else ``x``."""
    if not _rows_split():
        return x
    where = _ROWS.get()
    n, i = where.mesh.axes_size(where.axes), where.mesh.axes_index(
        where.axes)
    b = x.shape[0]
    return _AllReduce.apply(_pad_dim(x, 0, i * b, (n - 1 - i) * b), where)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a serving batch that :func:`gather_rows` made
    whole, else ``x``."""
    if not _rows_split():
        return x
    where = _ROWS.get()
    n, i = where.mesh.axes_size(where.axes), where.mesh.axes_index(
        where.axes)
    b = x.shape[0] // n
    return x.narrow(0, i * b, b)


def gather_columns(blocks, tag: str):
    """Tensors made whole over "model" from this rank's blocks, for a
    computation that every model rank repeats on the same tokens (a moe
    router's logits over the rank's experts, the sLSTM's recurrent
    weights, which a model rank cannot split without a collective per
    position): ``blocks`` is a list of ``(x, dim, whole)``, this rank's
    block ``x`` of a tensor whose ``dim`` has size ``whole`` (``x``
    itself where it is whole here).  The split ones go through ONE
    ``all_reduce`` of their zero-padded blocks, flattened together
    (exact).  Under tensor parallelism every rank's loss is the whole
    one, so the cotangent is the same on every rank and the backward
    keeps the rank's block of it (tag ``tp_<tag>``: summed, the gradient
    would be n× too large); where the ranks split the tokens each rank's
    cotangent is its share, and the backward sums them first
    (``sp_<tag>``, ``…_grad``).  Returns the whole tensors."""
    out = [x for x, _, _ in blocks]
    split = [i for i, (x, dim, whole) in enumerate(blocks)
             if x.shape[dim] != whole]
    if not split:
        return out
    flat, shapes = [], []
    for i in split:
        x, dim, whole = blocks[i]
        s = x.shape[dim]
        off = shard_offset(s, whole, "gather_columns")
        x = _pad_dim(x, dim, off, whole - off - s)
        flat.append(x.reshape(-1))
        shapes.append(x.shape)
    buf, axis = torch.cat(flat), _need_axis("gather_columns")
    if tokens_split() is None:
        buf = _AllReduce.apply(buf, axis.where("tp_" + tag))
    else:
        buf = _sum_both(buf, axis.where("sp_" + tag))
    for i, part, shape in zip(split, buf.split([f.numel() for f in flat]),
                              shapes):
        out[i] = part.reshape(shape)
    return out
