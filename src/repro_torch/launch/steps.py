"""Step construction: the train, prefill and serve steps of an LM, on
one card or on one rank of a (data, model) mesh (port of
``repro.launch.steps``).

* ``plan_run`` fixes the run: the model config, the workload shape, the
  agents (the paper's m: the product of the agent axes' sizes, the data
  axes, or a multiple of it), the sharding rules and the
  :class:`TrainConfig`.  Its memory knobs are the JAX package's:
  ``remat`` checkpoints every block of the model (its backward
  recomputes the block's activations), ``attn_q_block`` bounds the
  score tile of non-causal attention (the causal kernel forms none),
  ``microbatches`` sums each agent's loss over that many equal slices
  of its batch, and ``fsdp`` (ZeRO-3, on by default above
  ``FSDP_PARAM_THRESHOLD`` parameters) shards the parameters' ``embed``
  dim over the data axes.  ``cache_seq_shard`` moves the KV cache's
  positions onto "model" (flash-decoding: the decode attention's heads
  give it up).  ``seq_shard`` puts the sequence on "model" (each model
  rank holds its chunk: sequence parallelism in every family, train
  and prefill, a prefill that fills a KV cache too; a no-op where the
  whole sequence does not divide: whisper's frames or tokens, the vlm's
  patches and tokens together; and for the hybrid's and ssm's prefill
  that fills a cache, which replays the whole prompt) and
  ``inner_batch_shard`` each agent's batch rows
  (each model rank computes on its rows with the weights gathered whole
  at use: the model axis as data parallelism within an agent).  With no
  mesh, or a model axis of 1, the plan is the JAX package's on a
  one-device (1, 1) mesh: the rules resolve and shard nothing, and
  every knob changes nothing.
* ``build_train_step`` wires the model's loss into the event-triggered
  train step (:func:`repro_torch.core.api.make_triggered_train_step`);
  on a mesh it is the rank's step (:class:`MeshTrainStep`), with the
  state's and the batch's shardings (JAX returns them beside the jitted
  step).  ``fleet_shard=True`` swaps in the fleet-sharded step's
  two-level gateway reduce.
* ``build_prefill_step`` / ``build_serve_step`` cover prefill (the full
  sequence's forward; with ``cache_len`` also the cache that decode
  reads) and the decode shapes (one token against a ``seq_len`` cache,
  written in place).  They return the step with its parameters and
  inputs: drawn from seed 0 on a real device, the abstract stand-ins on
  ``meta``.  On a mesh each is the rank's :class:`MeshServeStep`, with
  its parameters' blocks (each rank draws the whole model leaf by leaf
  and keeps its blocks) and its rows of the inputs.
* ``lower_for`` is the dry-run's counterpart of ``jit(...).lower``: the
  plan's step with its ``meta`` state and inputs, traced on demand for
  its cost (:mod:`repro_torch.analysis.cost`) and memory.

On a mesh the agents live on the data axes and the model ranks of one
data coordinate hold the same agents; tensor parallelism over "model"
splits the heads, kv heads, ``ff`` columns, experts and vocabulary of
every family (the divisibility guard replicates what does not divide);
the parameters and optimizer state at rest are each rank's blocks
(:mod:`repro_torch.sharding.placement`).  Every agent's gradient and
lookahead probe run batched on the rank's device, through the
``swa_attention`` and ``fused_ce`` kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.analysis.cost import CostCounter, MemoryTracker, tensor_leaves
from repro_torch.configs.base import (
    InputShape,
    ModelConfig,
    TrainConfig,
    TriggerConfig,
)
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import (
    build,
    input_axes,
    input_specs,
    long_context_variant,
)
from repro_torch.models.transformer import dtype_of
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding.rules import (
    NamedSharding,
    PartitionSpec,
    resolve_pspec,
    resolve_rules,
    shard_tree,
    tree_shardings,
)
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

FSDP_PARAM_THRESHOLD = 20e9


@dataclass(frozen=True)
class RunPlan:
    cfg: ModelConfig
    shape: InputShape
    fsdp: bool
    agent_axes: Tuple[str, ...]
    num_agents: int
    train_cfg: TrainConfig
    rules: dict
    seq_shard: bool = False
    inner_batch_shard: bool = False


def plan_run(
    cfg: ModelConfig,
    shape: InputShape,
    mesh=None,
    *,
    num_agents: Optional[int] = None,
    comm: Optional[object] = None,
    trigger: Optional[TriggerConfig] = None,
    optimizer: str = "sgd",
    lr: float = 1e-2,
    fsdp: Optional[bool] = None,
    seq_shard: bool = False,
    remat: bool = False,
    attn_q_block: Optional[int] = None,
    inner_batch_shard: bool = False,
    cache_seq_shard: bool = False,
    microbatches: int = 1,
) -> RunPlan:
    """The JAX package's plan on ``mesh`` (None: one device).

    ``num_agents`` defaults to the product of the agent axes' sizes, as
    JAX's; a multiple of it runs that many agents, as many on each data
    coordinate."""
    mesh = mesh if mesh is not None else Mesh(("data", "model"), (1, 1))
    if shape.name == "long_500k":
        cfg = long_context_variant(cfg)
    if remat or attn_q_block:
        cfg = cfg.replace(remat=remat, attn_q_block=attn_q_block)
    if fsdp is None:
        fsdp = cfg.param_count() > FSDP_PARAM_THRESHOLD
    # agents always live on the data axes (each data slice computes its
    # own agents' gradients); FSDP additionally shards the parameters'
    # embed dim over the same axes
    multipod = "pod" in mesh.axis_names
    agent_axes: Tuple[str, ...] = ("pod", "data") if multipod else ("data",)
    slices = int(math.prod(mesh.shape[a] for a in agent_axes))
    num_agents = slices if num_agents is None else int(num_agents)
    if num_agents % slices:
        raise ValueError(f"{num_agents} agents do not split over the "
                         f"{slices} slices of the agent axes {agent_axes}")
    trigger = trigger or TriggerConfig(kind="gain_lookahead", lam=0.0)
    if comm is not None and not isinstance(comm, str):
        from repro_torch.comm import CommPolicy

        # policies and per-agent lists as spec strings, so TrainConfig
        # stays a hashable frozen dataclass
        comm = (str(comm) if isinstance(comm, CommPolicy)
                else tuple(str(p) for p in comm))
    train_cfg = TrainConfig(
        lr=lr,
        optimizer=optimizer,
        num_agents=num_agents,
        microbatches=microbatches,
        trigger=trigger,
        comm=comm,
    )
    rules = resolve_rules(mesh, fsdp=fsdp, agent_axes=agent_axes,
                          seq_shard=seq_shard,
                          inner_batch_shard=inner_batch_shard,
                          cache_seq_shard=cache_seq_shard)
    return RunPlan(cfg=cfg, shape=shape, fsdp=fsdp, agent_axes=agent_axes,
                   num_agents=num_agents, train_cfg=train_cfg, rules=rules,
                   seq_shard=seq_shard, inner_batch_shard=inner_batch_shard)


def _tokens_split(batch_axes, batch_specs, batch_shardings, mesh):
    """What of the tokens a mesh step's model ranks split, and the
    batch's layout for it: ``"seq"`` where the rules put the sequence on
    "model" (``seq_shard``), ``"rows"`` where they put an agent's rows
    there (``inner_batch_shard``), None where neither knob is on or its
    dim does not divide.

    The sequence the model ranks chunk must divide as a whole: an
    encoder-decoder's frames and its decoder tokens both (the port
    chunks both or neither), the vlm's patch prefix and its tokens
    together (P + S, :func:`repro_torch.models.transformer._prefixed`).
    Where it does not, ``seq_shard`` is a no-op, as JAX's divisibility
    guard makes it: every sequence of the batch stays whole on the model
    ranks (JAX would still chunk a leaf that divides; the step computes
    the same).  Returns ``(split, batch_shardings)``."""
    def split_of(key):
        spec = tuple(batch_shardings[key].spec)
        if "model" not in spec:
            return None
        return ("seq" if batch_axes[key][spec.index("model")] == "seq"
                else "rows")

    keys = [k for k, sh in batch_shardings.items()
            if isinstance(sh, NamedSharding)]
    chunked = [k for k in keys if split_of(k) == "seq"]
    if not chunked:
        return split_of("tokens"), batch_shardings
    n = mesh.shape["model"]

    def length(key):
        return batch_specs[key].shape[batch_axes[key].index("seq")]

    seqs = [k for k in keys if "seq" in batch_axes[k]]
    whole = [length(k) for k in seqs]
    if "patch_embeds" in batch_specs:
        whole.append(batch_specs["patch_embeds"].shape[-2] + length("tokens"))
    if len(chunked) == len(seqs) and all(s % n == 0 for s in whole):
        return "seq", batch_shardings
    out = dict(batch_shardings)
    for k in seqs:
        spec = tuple(out[k].spec) + (None,) * (len(batch_axes[k])
                                               - len(out[k].spec))
        out[k] = NamedSharding(out[k].mesh, PartitionSpec(*(
            None if a == "seq" else e
            for a, e in zip(batch_axes[k], spec))))
    return None, out


class MeshTrainStep:
    """A rank's ``step(state, batch, scale=None, chan_scale=None) ->
    (state, metrics)`` on a mesh, with the layouts the caller needs:

    * ``state_shardings`` — the :class:`~repro_torch.sharding.rules.
      NamedSharding` tree of the state at rest (``shard_tree(global
      state, state_shardings)`` places a global state on the mesh;
      ``gather_tree`` assembles it);
    * ``batch_shardings`` — the batch's (its agent axis over the data
      axes; the step also takes the global batch and keeps its rows);
    * ``placement`` — :class:`~repro_torch.sharding.placement.Placement`.
    """

    def __init__(self, step, placement, state_shardings, batch_shardings):
        self.step, self.placement = step, placement
        self.state_shardings = state_shardings
        self.batch_shardings = batch_shardings

    def __call__(self, state, batch, scale=None, chan_scale=None):
        return self.step(state, batch, scale, chan_scale)


def build_train_step(plan: RunPlan, *, compute_dtype: str,
                     param_dtype: Optional[str] = None,
                     device: DeviceLike = "cuda", mesh=None,
                     fleet_shard: bool = False, agent_metrics: bool = False,
                     hetero_dispatch: str = "hybrid"):
    """``train_step(state, batch) -> (state, metrics)`` for the plan's
    model at ``compute_dtype`` on ``device``; on a ``mesh`` of more than
    one rank, this rank's :class:`MeshTrainStep`.

    ``param_dtype`` (default: ``compute_dtype``) is the dtype the state
    holds the parameters at, as the JAX package's: the model casts each
    weight to the compute dtype where it reads it, so each agent's
    gradient, its EF memory, a delay line's payloads and the update are
    at the parameters' dtype.  The caller builds the state at that dtype
    (``init_train_state`` keeps the parameters' dtype), and the step
    raises a ``TypeError`` on a state whose parameters are at another,
    on one card and on the mesh; on a mesh the state's shardings and the
    gather hook are laid out at that dtype.

    The plan's ``comm`` may be a per-agent tuple (``plan_run(comm=...)``
    takes a sequence of policies or spec strings), with adaptive
    triggers, lossy channels and delay or retransmit lines: the state
    that :func:`repro_torch.core.api.init_train_state` builds from
    ``plan.train_cfg`` carries the controller rows ``(m, CTRL_WIDTH)``
    and the channel slot, and on a mesh ``state_shardings`` lays every
    per-agent slot over the data axes (JAX's ``agent_pspec``), so each
    data slice holds its own agents' rows.  ``hetero_dispatch`` picks the
    heterogeneous path (``StepOptions.hetero_dispatch``: ``"hybrid"``,
    the JAX package's, ``"switch"`` or ``"unroll"``), on one card and on
    the mesh.

    Tensor parallelism (a "model" axis larger than 1) runs every family:
    dense, moe (the expert axis, or each expert's ``ff`` where the guard
    replicates it), vlm, audio, hybrid (zamba2's Mamba2 layers on the
    rank's heads, its shared attention block as the dense one's) and ssm
    (xlstm's mLSTM on the rank's heads, its sLSTM recurrence whole on
    every rank), with ``seq_shard`` and ``inner_batch_shard``.
    ``fleet_shard=True`` runs the fleet-sharded step
    (:func:`repro_torch.sharding.agent_shard.make_sharded_train_step`):
    the gateways are the data coordinates.  ``agent_metrics`` adds the
    per-agent vectors (``StepOptions.agent_metrics``): the fleet's, or
    under ``fleet_shard`` the rank's gateway's."""
    cfg = plan.cfg.replace(compute_dtype=compute_dtype)
    model = build(cfg)
    pdt = dtype_of(param_dtype or compute_dtype)
    if mesh is None or mesh.size == 1:
        optimizer = opt_lib.from_config(plan.train_cfg)
        return _held_at(pdt, make_triggered_train_step(
            model.loss_fn, optimizer, plan.train_cfg, device=device,
            options=StepOptions(agent_metrics=agent_metrics,
                                hetero_dispatch=hetero_dispatch)))
    from repro_torch.sharding.placement import Placement

    dev = resolve_device(device)
    shapes, axes = model.init(abstract=True, dtype=pdt)
    tcfg = plan.train_cfg
    batch_axes = input_axes(cfg, plan.shape, num_agents=tcfg.num_agents)
    batch_specs = input_specs(cfg, plan.shape, num_agents=tcfg.num_agents)
    split, batch_shardings = _tokens_split(
        batch_axes, batch_specs,
        tree_shardings(batch_axes, batch_specs, plan.rules, mesh), mesh)
    placement = Placement(
        mesh, axes, shapes, plan.rules, tcfg.num_agents,
        grad_clip=tcfg.grad_clip, split=split,
        batch_shardings=batch_shardings,
        batch_shapes={p: tuple(x.shape) for p, x in
                      tree_flatten_with_path(batch_specs)})
    # clipping runs on the whole aggregate (Placement.update_block)
    optimizer = opt_lib.from_config(dataclasses.replace(tcfg, grad_clip=0.0))
    options = StepOptions(mesh=mesh if fleet_shard else None,
                          rules=plan.rules if fleet_shard else None,
                          agent_metrics=agent_metrics,
                          hetero_dispatch=hetero_dispatch)
    step = make_triggered_train_step(model.loss_fn, optimizer, tcfg,
                                     device=dev, options=options,
                                     placement=placement)
    state = init_train_state(shapes, optimizer, tcfg, device="meta")
    state_shardings = placement.state_shardings(state, tcfg.optimizer)
    return MeshTrainStep(_held_at(pdt, step), placement, state_shardings,
                         batch_shardings)


def _held_at(dtype: torch.dtype, step):
    """``step`` that first checks the state's parameters are at
    ``dtype``."""
    def held(state, batch, *args, **kwargs):
        for path, x in tree_flatten_with_path(state.params):
            if x.dtype != dtype:
                raise TypeError(
                    f"parameter {'/'.join(map(str, path))} is {x.dtype}; "
                    f"the step holds the parameters at {dtype}")
        return step(state, batch, *args, **kwargs)

    return held


def _params(model, dtype: torch.dtype, device: torch.device):
    """The model's parameters at ``dtype``: drawn from seed 0 on a real
    device, the abstract stand-ins on ``meta``."""
    if device.type == "meta":
        return model.init(abstract=True, dtype=dtype)[0]
    return model.init(torch.Generator(device=device).manual_seed(0),
                      dtype=dtype)[0]


def _materialize(specs: dict, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator) -> dict:
    """Real inputs of ``specs``' shapes and dtypes on ``device``: token
    ids uniform over the vocabulary, embeddings standard normal."""
    out = {}
    for key, spec in specs.items():
        if spec.dtype.is_floating_point:
            out[key] = torch.randn(spec.shape, generator=gen, device=device,
                                   dtype=torch.float32).to(spec.dtype)
        else:
            out[key] = torch.randint(0, cfg.vocab_size, spec.shape,
                                     generator=gen, device=device,
                                     dtype=spec.dtype)
    return out


class MeshServeStep:
    """A rank's prefill or serve step on a mesh, with the layouts the
    caller needs (the JAX package returns its specs beside the jitted
    step):

    * ``param_shardings`` — the parameters' (the step takes the rank's
      blocks at rest: ``shard_tree(global params, param_shardings)``);
    * ``batch_shardings`` — the inputs': the prefill batch's, or the
      serve step's ``{"cache", "tokens", "pos"}``;
    * ``cache_shardings`` — the KV cache's (:func:`~repro_torch.models.
      attention.kv_cache_axes` through the plan's rules: its kv heads over
      "model", or with ``cache_seq_shard`` its positions); None for a
      prefill step without a cache;
    * ``logits_sharding`` — the logits': this rank's rows of the batch
      (the batch's data coordinate), the whole vocabulary on every model
      rank (``logits_sharding.gather`` assembles the whole batch's).

    A call takes the batch or the tokens (its argument ``rows_arg`` after
    the parameters) whole or as the rank's rows (it keeps its rows), and
    the cache as the rank's block.  :meth:`active`
    is the context the call runs in: the model axis, the activation hook
    and, with ``fsdp``, the gather hook; any model call inside it runs
    on the rank's blocks.  Under ``fsdp`` the JAX package installs no
    gather hook for serving and lets XLA move what a use needs; here each
    data-split block is gathered over the data axes at its use (the
    model's ``constrain_params`` sites), which is
    the same math as the whole weight."""

    def __init__(self, fn, rows_arg: int, mesh, plan: RunPlan, axes,
                 shapes, *, batch_axes, batch_specs,
                 cache_len: Optional[int] = None, cache_axes=None,
                 cache_specs=None, cross_len: Optional[int] = None):
        from repro_torch.sharding import collectives as C
        from repro_torch.sharding.constraint import (
            make_act_hook,
            make_gather_hook,
        )

        self.fn, self.rows_arg, self.mesh = fn, rows_arg, mesh
        rules = plan.rules
        self.param_shardings = tree_shardings(axes, shapes, rules, mesh)
        self.batch_shardings = tree_shardings(batch_axes, batch_specs, rules,
                                              mesh)
        self.cache_shardings = (None if cache_axes is None else
                                tree_shardings(cache_axes, cache_specs,
                                               rules, mesh))
        self.logits_sharding = NamedSharding(mesh, resolve_pspec(
            (plan.shape.global_batch,), ("batch",), rules, mesh))
        self._batch = plan.shape.global_batch
        self._whole = {p[0]: tuple(x.shape) for p, x in
                       tree_flatten_with_path(batch_specs) if len(p) == 1}
        self._gather = (make_gather_hook(mesh, axes, rules, shapes)
                        if plan.fsdp else None)
        self._act = make_act_hook(mesh, rules, cache_len=cache_len,
                                  cross_len=cross_len)
        # the batch's rows over the data axes: a moe layer routes the
        # whole batch, as JAX's one global computation does
        rows = self.logits_sharding
        self._rows = (C.Where(mesh, rows.axes, "moe_rows")
                      if rows.axes else None)
        n = mesh.shape.get("model", 1)
        # a prefill under seq_shard: each model rank's chunk of the
        # sequence (the model's sequence parallelism)
        self.split = None
        if "seq" in batch_axes.get("tokens", ()):
            self.split, self.batch_shardings = _tokens_split(
                batch_axes, batch_specs, self.batch_shardings, mesh)
        self._axis = C.ModelAxis(mesh, split=self.split) if n > 1 else None

    @contextlib.contextmanager
    def active(self):
        from repro_torch.sharding import collectives as C
        from repro_torch.sharding.constraint import (
            reset_act_hook,
            reset_gather_hook,
            set_act_hook,
            set_gather_hook,
        )

        g, a = set_gather_hook(self._gather), set_act_hook(self._act)
        try:
            with C.tensor_parallel(self._axis), C.batch_rows(self._rows):
                yield self
        finally:
            reset_act_hook(a)
            reset_gather_hook(g)

    def rows(self, tree):
        """This rank's rows of a tree of per-request leaves (whole, or
        already the rank's rows); under ``seq_shard`` also its chunk of a
        prefill batch's sequence (a whole one is cut)."""
        rows = self.logits_sharding

        def cut(x):
            return rows.local(x) if x.shape[0] == self._batch else x

        tree = tree_map(cut, tree)
        if self.split != "seq":
            return tree

        def chunk(key, sh, x):
            spec = tuple(sh.spec)
            if "model" not in spec:
                return x
            d = spec.index("model")
            if x.shape[d] != self._whole[key][d]:
                return x
            return NamedSharding(self.mesh, PartitionSpec(*(
                e if e == "model" else None for e in spec))).local(x)

        return {k: chunk(k, self.batch_shardings[k], x)
                for k, x in tree.items()}

    def __call__(self, params, *args):
        args = list(args)
        args[self.rows_arg] = self.rows(args[self.rows_arg])
        with self.active():
            return self.fn(params, *args)


def _rank_params(model, shardings, dtype: torch.dtype,
                 device: torch.device):
    """This rank's blocks of the model's parameters drawn from seed 0 on
    ``device``: the whole model's draws, each leaf cut to its block as
    it is drawn, so the rank holds its blocks and one whole leaf."""
    if device.type == "meta":
        return _meta_blocks(shardings, model.init(abstract=True,
                                                  dtype=dtype)[0])
    by_path = dict(tree_flatten_with_path(shardings))

    def place(path, leaf):
        sh = by_path[path]
        return leaf if not sh.axes else sh.local(leaf)

    return model.init(torch.Generator(device=device).manual_seed(0),
                      dtype=dtype, place=place)[0]


def _meta_blocks(shardings, tree):
    """``meta`` stand-ins of this rank's block of every leaf."""
    return tree_map(lambda sh, x: torch.empty(
        sh.shard_shape(x.shape), dtype=x.dtype, device="meta"),
        shardings, tree)


def build_prefill_step(plan: RunPlan, *, compute_dtype: str = "bfloat16",
                       device: DeviceLike = "cuda", mesh=None,
                       cache_len: Optional[int] = None,
                       init_params: bool = True):
    """Full-sequence forward (inference prefill).  Returns ``(step,
    params, batch)`` with ``step(params, batch) -> logits``: the
    parameters at ``compute_dtype`` and the batch of ``input_specs``,
    drawn from seed 0 on ``device``, or their ``meta`` stand-ins.  With
    ``cache_len`` the step is the model's ``prefill``: ``step(params,
    batch) -> (logits, cache)``, the cache of ``cache_len`` slots that
    the serve step continues from.  ``init_params=False`` draws no
    parameters (None in their place: the caller holds them).

    On a ``mesh`` of more than one rank the step is the rank's
    :class:`MeshServeStep`, the parameters its blocks and the batch its
    rows; the logits are its rows' over the whole vocabulary, and the
    cache its block (``step.cache_shardings``).  Under ``seq_shard``
    each model rank runs its chunk of the prompt (with ``cache_len``
    too: the cache holds every position of the rank's kv heads, or
    under ``cache_seq_shard`` every head at its positions) and the
    logits are the whole sequence's.  A moe model routes the whole
    batch (its rows gathered over the data axes).  The hybrid and ssm
    families' prefill with ``cache_len`` replays the whole prompt through
    the rank's decode step (``seq_shard`` chunks nothing there), and
    fills the states and the shared block's KV cache in the plan's
    layout."""
    cfg = plan.cfg.replace(compute_dtype=compute_dtype)
    model = build(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(compute_dtype)
    specs = input_specs(cfg, plan.shape)
    gen = None if dev.type == "meta" else torch.Generator(
        device=dev).manual_seed(0)

    if cache_len is None:
        def prefill_step(params, batch):
            logits, _ = model.forward(params, batch)
            return logits
    else:
        def prefill_step(params, batch):
            return model.prefill(params, batch, cache_len)

    if mesh is None or mesh.size == 1:
        params = _params(model, dtype, dev) if init_params else None
        batch = specs if gen is None else _materialize(specs, cfg, dev, gen)
        return prefill_step, params, batch
    shapes, axes = model.init(abstract=True, dtype=dtype)
    cache_kw = {}
    if cache_len is not None:
        # whisper's cross-attention cache holds the encoder's frames
        cache, cache_axes = model.init_cache(
            plan.shape.global_batch,
            plan.shape.seq_len if cfg.is_encoder_decoder else cache_len,
            device="meta", dtype=dtype)
        cache_kw = dict(_cache_lens(cache), cache_axes=cache_axes,
                        cache_specs=cache)
    batch_axes = input_axes(cfg, plan.shape)
    if cache_len is not None and cfg.arch_type in ("hybrid", "ssm"):
        # the recurrent prefill replays the prompt token by token: every
        # model rank takes the whole prompt
        batch_axes = {k: tuple(None if a == "seq" else a for a in ax)
                      for k, ax in batch_axes.items()}
    step = MeshServeStep(prefill_step, 0, mesh, plan, axes, shapes,
                         batch_axes=batch_axes, batch_specs=specs,
                         **cache_kw)
    params = (_rank_params(model, step.param_shardings, dtype, dev)
              if init_params else None)
    batch = (_meta_blocks(step.batch_shardings, specs) if gen is None
             else step.rows(_materialize(specs, cfg, dev, gen)))
    return step, params, batch


def _cache_lens(cache) -> dict:
    """A serving mesh step's cache lengths, from any layout
    ``init_cache`` returns: the KV cache's slots; an encoder-decoder's
    self-attention slots and cross-attention frames; the hybrid's shared
    attention block's slots; none for the ssm, whose states hold no
    positions."""
    if not isinstance(cache, dict):
        return dict(cache_len=cache.k.shape[2])
    if "cross_k" in cache:
        return dict(cache_len=cache["self"].k.shape[2],
                    cross_len=cache["cross_k"].shape[2])
    if "attn" in cache:
        return dict(cache_len=cache["attn"].k.shape[2])
    return {}


def build_serve_step(plan: RunPlan, *, compute_dtype: str = "bfloat16",
                     device: DeviceLike = "cuda", mesh=None,
                     init_params: bool = True):
    """One-token decode against a ``seq_len`` cache (decode shapes).
    Returns ``(step, params, (cache, tokens, pos))`` with ``step(params,
    cache, tokens, pos) -> (logits, cache)``, the cache written in place
    (the JAX package donates it): on ``device`` a zero cache (the
    model's ``init_cache``), tokens drawn from seed 0 and the 0-d int32
    position ``seq_len − 1``; on ``meta`` the stand-ins.
    ``init_params=False`` draws no parameters (None in their place).

    On a ``mesh`` of more than one rank the step is the rank's
    :class:`MeshServeStep`: it takes the parameters' blocks, the cache's
    block (``step.cache_shardings``) and the tokens (whole or the rank's
    rows), and returns its rows' logits over the whole vocabulary and
    its cache block; the returned parameters, cache and tokens are the
    rank's."""
    cfg = plan.cfg.replace(compute_dtype=compute_dtype)
    model = build(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(compute_dtype)
    specs = input_specs(cfg, plan.shape)
    inputs = specs
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
        inputs = dict(
            _materialize({"tokens": specs["tokens"]}, cfg, dev, gen),
            cache=model.init_cache(plan.shape.global_batch,
                                   plan.shape.seq_len, device=dev)[0],
            pos=torch.tensor(plan.shape.seq_len - 1, dtype=torch.int32,
                             device=dev))

    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    if mesh is None or mesh.size == 1:
        return serve_step, (_params(model, dtype, dev) if init_params
                            else None), (
            inputs["cache"], inputs["tokens"], inputs["pos"])
    shapes, axes = model.init(abstract=True, dtype=dtype)
    in_axes = input_axes(cfg, plan.shape)
    step = MeshServeStep(serve_step, 1, mesh, plan, axes, shapes,
                         batch_axes=in_axes, batch_specs=specs,
                         cache_axes=in_axes["cache"],
                         cache_specs=specs["cache"],
                         **_cache_lens(specs["cache"]))
    local = (_meta_blocks(step.batch_shardings, specs) if dev.type == "meta"
             else shard_tree(inputs, step.batch_shardings))
    params = (_rank_params(model, step.param_shardings, dtype, dev)
              if init_params else None)
    return step, params, (local["cache"], local["tokens"], local["pos"])


@dataclass
class Lowered:
    """A step with its ``meta`` arguments: the counterpart of JAX's
    ``Lowered``/``Compiled`` for the dry-run.  :meth:`cost` and
    :meth:`memory` trace the step once (nothing is allocated or
    computed) and keep what the trace found."""

    step: Callable
    args: tuple
    _cost: Optional[CostCounter] = None
    _memory: Optional[dict] = None

    def _trace(self) -> None:
        with CostCounter() as counter, MemoryTracker() as tracker:
            out = self.step(*self.args)
        outputs = tracker.new_bytes(out)
        self._cost = counter
        self._memory = {
            "argument_bytes": self.argument_bytes,
            "temp_bytes": tracker.peak_bytes - outputs,
            "output_bytes": outputs,
        }

    @property
    def argument_bytes(self) -> int:
        """The state and batch (or parameters and inputs), exact."""
        return sum(t.nbytes for t in tensor_leaves(self.args))

    def cost(self) -> CostCounter:
        """The traced step's flops, HBM bytes and device ops."""
        if self._cost is None:
            self._trace()
        return self._cost

    def memory(self) -> dict:
        """``argument_bytes``, ``temp_bytes`` (the high-water of the storage the step allocates,
        less its outputs) and ``output_bytes`` (the outputs' new storage:
        an argument written in place adds nothing)."""
        if self._memory is None:
            self._trace()
        return self._memory


def lower_for(plan: RunPlan, *, compute_dtype: str = "bfloat16") -> Lowered:
    """The right step for the plan's shape kind, with its ``meta`` state
    and inputs (parameters at ``compute_dtype``, as the JAX package's)."""
    meta = torch.device("meta")
    if plan.shape.kind == "train":
        cfg = plan.cfg.replace(compute_dtype=compute_dtype)
        model = build(cfg)
        params = _params(model, dtype_of(compute_dtype), meta)
        state = init_train_state(params, opt_lib.from_config(plan.train_cfg),
                                 plan.train_cfg, device=meta)
        batch = input_specs(cfg, plan.shape, num_agents=plan.num_agents)
        step = build_train_step(plan, compute_dtype=compute_dtype,
                                device=meta)
        return Lowered(step, (state, batch))
    if plan.shape.kind == "prefill":
        step, params, batch = build_prefill_step(
            plan, compute_dtype=compute_dtype, device=meta)
        return Lowered(step, (params, batch))
    step, params, inputs = build_serve_step(plan, compute_dtype=compute_dtype,
                                            device=meta)
    return Lowered(step, (params,) + inputs)
