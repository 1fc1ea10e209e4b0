"""Where an LM train step's state lives on a (data, model) mesh
(port-only).

In the JAX package one SPMD program holds the global state, laid out by
the step's shardings, and XLA moves what each device needs.  The port's
ranks are separate programs, so the layout is explicit.  A
:class:`Placement` says, for one rank:

* at rest, the rank holds its block of every parameter and optimizer
  leaf (``param_shardings``: ZeRO-3's ``embed`` over the data axes with
  ``fsdp``, the tensor-parallel dims over "model") and the per-agent
  slots (EF memory, controller and channel rows) of its own agents (the
  ``agent`` rule's axes: agents live on the data axes, and the model
  ranks of one data coordinate hold the same agents);
* in a step, :meth:`gather_params` gathers each ZeRO-3 leaf over the
  data axes once at the start of the round into this rank's
  tensor-parallel block (with ``fsdp`` off the round reads the blocks at
  rest, with no copy); the model reads those blocks (:meth:`active`
  installs the gather hook of :mod:`repro_torch.sharding.constraint`
  and the model axis of :mod:`repro_torch.sharding.collectives`), and
  each agent's gradient with respect to them is made whole over "model"
  once, right after the backward
  (:func:`~repro_torch.sharding.constraint.whole_over_model`), so the
  per-agent gradient, EF memory and payloads are global trees (the comm
  epilogue reads whole leaves) while the probe is formed on the blocks;
  the aggregate's sums and the agents' metric vectors are reduced over
  the agent axes (:meth:`partial_payload`, :meth:`masked_mean`), and
  each rank applies its own block of the update (:meth:`local`).

With ``fsdp`` the round's gathered blocks live for the step: the
ZeRO-3 memory saving is the state at rest, not the step's peak.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.sharding import collectives as C
from repro_torch.sharding.constraint import (
    make_gather_hook,
    reset_gather_hook,
    set_gather_hook,
)
from repro_torch.sharding.rules import (
    NamedSharding,
    agent_axis_names,
    resolve_pspec,
    shard_tree,
    split_spec,
    tree_shardings,
)
from repro_torch.utils.tree import tree_map, tree_unflatten


class Placement:
    """One rank's layout of a mesh train step (see the module doc).

    ``axes`` and ``shapes`` are the model's logical-axes tree and its
    global parameter tree (``meta`` tensors do); ``rules`` the plan's
    rule table; ``num_agents`` the fleet's m."""

    def __init__(self, mesh, axes, shapes, rules: dict, num_agents: int,
                 *, grad_clip: float = 0.0):
        self.mesh, self.rules, self.num_agents = mesh, rules, num_agents
        # clipping by the global norm runs on the global aggregate, before
        # the rank takes its block (the step's optimizer clips nothing)
        self.grad_clip = grad_clip
        self.shapes = shapes
        self.param_shardings = tree_shardings(axes, shapes, rules, mesh)
        self.hook = make_gather_hook(mesh, axes, rules, shapes)
        model = tuple(a for a in ("model",) if a in mesh.axis_names)
        self.model_axis = (C.ModelAxis(mesh, model)
                           if model and mesh.axes_size(model) > 1 else None)
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
            with C.tensor_parallel(self.model_axis):
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

    def global_like(self, params):
        """``meta`` stand-ins of the global parameter tree in the dtypes
        of ``params`` (the round's blocks): what a whole payload of the
        tree is sized and priced by."""
        return tree_map(lambda g, x: torch.empty(g.shape, dtype=x.dtype,
                                                 device="meta"),
                        self.shapes, params)

    def local(self, tree):
        """This rank's block of a global parameter-shaped tree."""
        return shard_tree(tree, self.param_shardings)

    def update_block(self, agg):
        """This rank's block of the aggregate the optimizer applies:
        clipped by its global norm first where the config clips."""
        if self.grad_clip:
            agg = clip_by_global_norm(agg, self.grad_clip)
        return self.local(agg)

    def local_rows(self, tree):
        """This rank's agents' rows of a per-agent tree (leaves with the
        fleet's m rows, or already the rank's)."""
        lo, hi, m = self.agents.start, self.agents.stop, self.num_agents

        def cut(x):
            if x.shape[0] == m:
                return x[lo:hi]
            if x.shape[0] == hi - lo:
                return x
            raise ValueError(
                f"per-agent leaf with leading axis {x.shape[0]}: expected "
                f"the fleet's {m} agents or this rank's {hi - lo}")

        return None if tree is None else tree_map(cut, tree)

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
        slots by the agent axes; the host-int step None)."""
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

        return type(state)(None, params, opt, per_agent(state.ef_memory),
                           per_agent(state.ctrl_state),
                           per_agent(state.net_state))

