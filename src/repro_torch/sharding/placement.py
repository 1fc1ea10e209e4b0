"""Where an LM train step's state lives on a (data, model) mesh
(port-only).

In the JAX package one SPMD program holds the global state, laid out by
the step's shardings, and XLA moves what each device needs.  The port's
ranks are separate programs, so the layout is explicit.  A
:class:`Placement` says, for one rank:

* at rest, the rank holds its block of every parameter and optimizer
  leaf (``param_shardings``: ZeRO-3's ``embed`` over the data axes with
  ``fsdp``, the tensor-parallel dims over "model") and the per-agent
  slots of its own agents (the ``agent`` rule's axes: agents live on the
  data axes, and the model ranks of one data coordinate hold the same
  agents): the controller and channel rows whole, and the EF memory and
  a delay line's payloads as the rank's model block of each leaf
  (:meth:`state_shardings`);
* in a step, :meth:`gather_params` gathers each ZeRO-3 leaf over the
  data axes once at the start of the round into this rank's
  tensor-parallel block (with ``fsdp`` off the round reads the blocks at
  rest, with no copy); the model reads those blocks (:meth:`active`
  installs the gather hook of :mod:`repro_torch.sharding.constraint`,
  the model axis of :mod:`repro_torch.sharding.collectives` with what of
  the tokens the model ranks split, and the model blocks of
  :mod:`repro_torch.sharding.blocks`), and each agent's gradient with
  respect to them is this rank's model block of each leaf, as the JAX
  package pins it (``constrain_params(g, "")``).  The comm epilogue runs
  on those blocks: EF memory, payload, probe and HVP are blocks, and
  what needs a whole leaf (int8's scale, top-k's threshold, the sketch,
  the gains' sums, the byte counts) reads it through
  :mod:`~repro_torch.sharding.blocks`; the aggregate's sums and the
  agents' metric vectors are reduced over the agent axes
  (:meth:`partial_payload`, :meth:`masked_mean`) on block-sized
  buffers, and each rank applies its own block of the update
  (:meth:`update_block`: with ``fsdp`` the block's data part).

With ``fsdp`` the round's gathered blocks live for the step: the
ZeRO-3 memory saving is the state at rest, not the step's peak.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.sharding import blocks
from repro_torch.sharding import collectives as C
from repro_torch.sharding.constraint import (
    make_gather_hook,
    reset_gather_hook,
    set_gather_hook,
    strip_data_axes,
)
from repro_torch.sharding.rules import (
    NamedSharding,
    PartitionSpec,
    agent_axis_names,
    resolve_pspec,
    split_spec,
    tree_shardings,
)
from repro_torch.utils.tree import (
    tree_flatten_with_path,
    tree_map,
    tree_unflatten,
)


class Placement:
    """One rank's layout of a mesh train step (see the module doc).

    ``axes`` and ``shapes`` are the model's logical-axes tree and its
    global parameter tree (``meta`` tensors do); ``rules`` the plan's
    rule table; ``num_agents`` the fleet's m; ``split`` what of the
    tokens the model ranks split (None, ``"seq"`` or ``"rows"``) and
    ``batch_shardings`` the batch's layout and ``batch_shapes`` its
    global shapes by leaf path (the step cuts the rank's part of a
    global batch by them)."""

    def __init__(self, mesh, axes, shapes, rules: dict, num_agents: int,
                 *, grad_clip: float = 0.0, split=None,
                 batch_shardings=None, batch_shapes=None):
        self.mesh, self.rules, self.num_agents = mesh, rules, num_agents
        # clipping by the global norm runs on the aggregate's blocks (the
        # step's optimizer clips nothing)
        self.grad_clip = grad_clip
        # per batch leaf: its dims after the agent axis whole, and the
        # model part of its layout (where "model" splits the tokens)
        self._batch_cuts = None
        if batch_shardings is not None:
            self._batch_cuts = {}
            for path, sh in tree_flatten_with_path(batch_shardings):
                spec = tuple(sh.spec)[1:]
                if "model" in spec:
                    self._batch_cuts[path] = (
                        tuple(batch_shapes[path][1:]),
                        NamedSharding(mesh, PartitionSpec(None, *(
                            e if e == "model" else None for e in spec))))
        self.param_shardings = tree_shardings(axes, shapes, rules, mesh)
        self.hook = make_gather_hook(mesh, axes, rules, shapes, split)
        model = tuple(a for a in ("model",) if a in mesh.axis_names)
        self.model_axis = (C.ModelAxis(mesh, model, split)
                           if model and mesh.axes_size(model) > 1 else None)
        # each leaf's layout over "model" alone (the per-agent trees')
        self.model_shardings = tree_shardings(
            axes, shapes, strip_data_axes(rules), mesh)
        self.layouts = None
        if self.model_axis is not None:
            specs = dict(tree_flatten_with_path(self.model_shardings))
            self.layouts = {}
            for path, ref in tree_flatten_with_path(shapes):
                sh = specs[path]
                self.layouts[path] = (blocks.LeafBlock(
                    tuple(ref.shape), sh.slices(ref.shape), self.model_axis)
                    if sh.axes else None)
        spec = resolve_pspec((num_agents,), ("agent",), rules, mesh)
        self.agent_axes: Tuple[str, ...] = tuple(
            a for a in mesh.axis_names
            if a in agent_axis_names(mesh, rules)) if spec else ()
        self.gateways = mesh.axes_size(self.agent_axes)
        self.gateway = mesh.axes_index(self.agent_axes)
        per = num_agents // self.gateways
        self.agents = range(self.gateway * per, (self.gateway + 1) * per)
        self.agent_sharding = NamedSharding(mesh, spec)

    # -- layout ----------------------------------------------------------

    @contextlib.contextmanager
    def active(self):
        """The gather hook and the model axis, for one step's call."""
        token = set_gather_hook(self.hook)
        try:
            with C.tensor_parallel(self.model_axis), \
                    blocks.model_blocks(self.layouts):
                yield self
        finally:
            reset_gather_hook(token)

    def gather_params(self, params, tag: str = "param_gather"):
        """The round's parameter tree from this rank's blocks at rest:
        each leaf that ZeRO-3 splits gathered over the data axes (one
        collective per leaf) into this rank's model block, the layout the
        model reads; the other leaves as they are.  No collective runs
        over "model"."""
        return tree_map(lambda sh, x: NamedSharding(
            self.mesh, split_spec(sh.spec)[0]).gather(x, tag),
            self.param_shardings, params)

    def sq_norm(self, tree) -> torch.Tensor:
        """The squared L2 norm of the whole tree whose model blocks
        ``tree`` holds (one ``all_reduce`` over "model" of the blocks'
        part; the leaves every model rank holds whole counted once)."""
        with blocks.model_blocks(self.layouts):
            split, whole = blocks.split_leaves(tree)
        total = sum((x.float() * x.float()).sum() for x in whole) if whole \
            else None
        if split:
            part = sum((x.float() * x.float()).sum() for x in split)
            part = self.mesh.all_reduce(part.reshape(1), "grad_norm",
                                        ("model",))[0]
            total = part if total is None else part + total
        return total

    def update_block(self, agg, norm_sq=None):
        """This rank's block at rest of the aggregate (its model blocks)
        that the optimizer applies: clipped by the whole tree's norm first
        where the config clips (``norm_sq``, its square, when the caller
        has it), then with ``fsdp`` each leaf's data part."""
        if self.grad_clip:
            agg = clip_by_global_norm(agg, self.grad_clip, torch.sqrt(
                self.sq_norm(agg) if norm_sq is None else norm_sq))
        return tree_map(lambda sh, x: NamedSharding(
            self.mesh, split_spec(sh.spec)[0]).local(x),
            self.param_shardings, agg)

    def local_rows(self, tree):
        """This rank's part of a batch: its agents' rows (leaves with the
        fleet's m rows, or already the rank's), then, where the model
        ranks split the tokens, its rows or chunk of each agent's (a
        leaf whole there is cut; the rank's part is kept)."""
        lo, hi, m = self.agents.start, self.agents.stop, self.num_agents
        cuts = self._batch_cuts or {}

        def cut(path, x):
            if x.shape[0] == m:
                x = x[lo:hi]
            elif x.shape[0] != hi - lo:
                raise ValueError(
                    f"per-agent leaf with leading axis {x.shape[0]}: "
                    f"expected the fleet's {m} agents or this rank's "
                    f"{hi - lo}")
            whole, model = cuts.get(path, (None, None))
            if model is None or tuple(x.shape[1:]) != whole:
                return x
            return model.local(x)

        if tree is None:
            return None
        return tree_unflatten(tree, [cut(p, x) for p, x in
                                     tree_flatten_with_path(tree)])

    # -- reductions over the agent axes ---------------------------------

    def agent_columns(self, cols: torch.Tensor) -> torch.Tensor:
        """``(m, k)`` from this rank's ``(m / #gateways, k)`` rows of k
        per-agent vectors: a zero-filled buffer holding the rank's rows,
        summed over the agent axes (exact)."""
        if self.gateways == 1:
            return cols
        out = cols.new_zeros((self.num_agents,) + tuple(cols.shape[1:]))
        out[self.agents.start:self.agents.stop] = cols
        return self.mesh.all_reduce(out, "agent_vectors", self.agent_axes)

    @staticmethod
    def partial_payload(leaves: list, weights: torch.Tensor) -> torch.Tensor:
        """Σ_i ``weights_i · sent_i`` over this rank's agents, for each
        leaf of ``leaves`` (a payload tree's leaves, a leading agent axis
        each) in order, written into one flat buffer.  Each entry of the
        list is released once summed (the caller holds no other
        reference), so the payload shrinks as the buffer fills."""
        flat = leaves[0].new_empty(sum(x[0].numel() for x in leaves))
        at = 0
        for i in range(len(leaves)):
            s = leaves[i]
            leaves[i] = None
            a = weights.reshape((-1,) + (1,) * (s.ndim - 1)).to(s.dtype)
            n = s[0].numel()
            torch.sum(s * a, 0, out=flat[at:at + n].view(s.shape[1:]))
            at += n
            del s, a
        return flat

    def masked_mean(self, leaves: list, skeleton, weights: torch.Tensor,
                    den: torch.Tensor):
        """Eq. (10) over every agent: Σ_i ``weights_i · sent_i`` / ``den``.
        ``leaves`` is this rank's agents' payload tree flattened
        (``tree_leaves``; ``skeleton`` its structure), released as
        :meth:`partial_payload` sums it; the flat buffer is reduced over
        the agent axes in one ``all_reduce``, divided in place and
        returned as views."""
        sizes = [x.shape[1:] for x in leaves]
        flat = self.partial_payload(leaves, weights)
        if self.gateways > 1:
            self.mesh.all_reduce(flat, "payload", self.agent_axes)
        flat.div_(den.to(flat.dtype))
        out, at = [], 0
        for z in sizes:
            n = int(torch.Size(z).numel())
            out.append(flat[at:at + n].view(z))
            at += n
        return tree_unflatten(skeleton, out)

    # -- the state's layout ----------------------------------------------

    def state_shardings(self, state, optimizer_name: str):
        """The :class:`NamedSharding` tree of a TrainState whose slots
        are ``state``'s (the step's state at rest: parameters and
        optimizer state by the parameters' shardings, the per-agent
        slots by the agent axes, and the EF memory ``(m, *leaf)`` and a
        delay line's payloads ``(m, L, *leaf)`` also by each leaf's
        model layout: the rank's model block of every agent's leaf; the
        host-int step None)."""
        agent = self.agent_sharding
        params = self.param_shardings
        opt = {"sgd": (), "momentum": params}.get(optimizer_name)
        if optimizer_name == "adamw":
            from repro_torch.optim.optimizers import AdamState

            opt = AdamState(mu=params, nu=params)
        elif opt is None:
            raise ValueError(f"unknown optimizer {optimizer_name!r}")

        def per_agent(tree):
            return None if tree is None else tree_map(lambda _: agent, tree)

        lead = tuple(agent.spec)[:1] or (None,)

        def blocks_of(tree, depth: int):
            # (agents, [line,] *leaf): the agents over the agent axes, the
            # leaf by its model layout
            return None if tree is None else tree_map(
                lambda sh, _: NamedSharding(self.mesh, PartitionSpec(
                    *lead, *(None,) * depth, *sh.spec)),
                self.model_shardings, tree)

        net = state.net_state
        if isinstance(net, tuple) and isinstance(net[1], dict):
            line = net[1]
            net = (agent, {"meta": per_agent(line["meta"]),
                           "buf": blocks_of(line["buf"], 1)})
        else:
            net = per_agent(net)
        return type(state)(None, params, opt, blocks_of(state.ef_memory, 0),
                           per_agent(state.ctrl_state), net)

