"""Fleet-scale agent sharding: the hybrid train step over the ranks of a
``torch.distributed`` process group (port of
``repro.sharding.agent_shard``).

``make_sharded_train_step`` partitions the triggered train step's agent
axis over the mesh's ``agent`` axes (:mod:`repro_torch.sharding.rules`):
each rank is a *tier gateway* that runs the hybrid dispatch's gradient
prologue and comm epilogue for only its ``m / #gateways`` agents, and
the center's flat sum becomes a TWO-LEVEL reduce:

    agents --(local masked partial sum)--> gateway
    gateways --(one all_reduce of the payload-sized partial)--> center

plus one more ``all_reduce`` of the round's scalar sums packed into one
tensor (the metrics' column sums, the delivered count that divides the
payload, one slot per gateway for the ``any_tx`` maximum).  Two
collectives per step whatever m is, and their operands are one payload
and a few dozen floats: the center-side cost is O(#gateways).
``mesh.collectives`` (:mod:`repro_torch.analysis.cost`) counts them.

Per-rank state.  Parameters and optimizer state are replicated: every
rank applies the same reduced update.  The per-agent slots (EF memory,
controller rows, channel rows and delay lines) hold only the rank's own
agents; the step takes the global batch (or the rank's slice of it) and
takes its slice.  :func:`scatter_agents` cuts a global state into a
rank's, :func:`gather_agents` assembles the global state or metrics
from every rank's (CPU copies, for tests and checkpoints; never inside
a step).

The epilogue.  Each rank is its own program, so it runs the port's
blocked hybrid dispatch (:func:`repro_torch.core.api.hybrid_dispatch`)
on its own slice's policy mix, where JAX's SPMD program computes every
policy's branch for every agent and selects.  The per-agent values are
the blocked dispatch's either way.  Channel keys come from the rows'
global agent index and churn windows are indexed by it, so every rank
draws what the single-process step draws for its agents.

Sums re-associate: the payload is Σ over gateways of each gateway's sum,
where the hybrid step sums over all m at once, a few ULP apart (JAX's own
sharded step differs from its hybrid step the same way); integer-valued
accounting stays exact.

Sketch-native gateway aggregation.  For fleets whose every chain is one
terminal ``sketch(rows,cols,seed)`` stage, ``sketch_native=True`` merges
in sketch space: each agent's ``g + ef`` is encoded once, the gateway
sums the weighted (rows, cols) grids, ONE ``all_reduce`` carries
grid-sized operands, and the median decode runs once on the merged grid
(the decode-once estimate differs from the hybrid step's mean of
decodes: opt in).

The phases.  A step is :meth:`ShardedTrainStep.local` (everything before
the reduce, free of collectives, so it maps under ``torch.func.vmap``),
the two ``all_reduce`` calls, and :meth:`ShardedTrainStep.finish`.  The
frontier maps ``local`` and ``finish`` over its lanes and reduces the
lanes' stacked partials in the same two collectives.

A mesh with one gateway, or a fleet its gateways do not divide (which
:func:`~repro_torch.sharding.rules.agent_pspec` warns about), gives the
plain hybrid step, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.comm.compressors import (
    sketch_decode,
    sketch_encode,
    sketch_params,
)
from repro_torch.comm.error_feedback import ef_add
from repro_torch.comm.stats import (
    dense_bits,
    dense_entries,
    fold_sum,
    structural_bytes,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.api import (
    AGENT_METRIC_KEYS,
    StepOptions,
    TrainState,
    _warn_ctrl_state_missing,
    _warn_ef_memory_missing,
    _warn_net_state_missing,
    build_hybrid_machinery,
    hybrid_dispatch,
    make_triggered_train_step,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.net import channels as net_lib
from repro_torch.sharding import blocks
from repro_torch.sharding.rules import (
    PartitionSpec,
    agent_axis_names,
    agent_pspec,
    agent_shard_count,
    resolve_rules,
)
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.todo import todo
from repro_torch.utils.tree import (
    tree_add_scaled,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def sketch_native_params(chains) -> Optional[tuple]:
    """``(rows, cols, seed)`` iff EVERY agent's chain is a single terminal
    sketch stage with identical parameters: the condition under which
    the gateway merge is exactly a sum in sketch space."""
    if not chains or any(c is None or len(c.stages) != 1 for c in chains):
        return None
    params = {sketch_params(c) for c in chains}
    if len(params) != 1 or None in params:
        return None
    return params.pop()


def _check_span(mesh: Mesh, axes) -> None:
    """The gateways are the ranks' coordinates over the agent axes
    (row-major): the agent axes, in the mesh's order, must span it but
    for a "model" axis beside them, whose ranks hold one gateway's
    agents together."""
    rest = tuple(a for a in mesh.axis_names if a not in axes)
    if tuple(a for a in mesh.axis_names if a in axes) != tuple(axes) or (
            rest not in ((), ("model",))):
        raise todo(f"a fleet sharded over {axes!r} of a mesh with axes "
                   f"{mesh.axis_names!r}", "queue 1 item 11.2")


class ShardedTrainStep:
    """``step(state, batch, scale=None, chan_scale=None) -> (state,
    metrics)`` on one rank: :meth:`local`, the two ``all_reduce`` calls,
    :meth:`finish`.  ``state`` is the rank's (per-agent slots of its own
    agents); ``metrics`` are the fleet's scalars and the rank's per-agent
    vectors."""

    def __init__(self, *, mesh: Mesh, optimizer, cfg: TrainConfig, mach,
                 lo: int, hi: int, skp, agent_metrics: bool, churn,
                 device: torch.device, axes=None, placement=None):
        self.mesh, self.optimizer, self.mach = mesh, optimizer, mach
        # the gateways: this rank's coordinate over the agent axes
        self.axes = mesh.axis_names if axes is None else tuple(axes)
        self.gateway = mesh.axes_index(self.axes)
        self.gateways = mesh.axes_size(self.axes)
        self.placement = placement
        self.num_agents = cfg.num_agents
        self.lo, self.hi = lo, hi
        self.skp = skp
        self.agent_metrics = agent_metrics
        self.device = device
        self.chains = mach.chains[lo:hi]
        self._ratio_cache: dict = {}
        self.run = hybrid_dispatch(mach, range(lo, hi), device)
        self.churn = None
        if churn is not None:
            self.churn = (
                torch.tensor([j for j, _ in churn[lo:hi]], device=device),
                torch.tensor([e for _, e in churn[lo:hi]], device=device))

    # -- the phases ----------------------------------------------------

    def _local_batch(self, batch):
        def cut(x):
            if x.shape[0] == self.num_agents:
                return x[self.lo:self.hi]
            if x.shape[0] == self.hi - self.lo:
                return x
            raise ValueError(
                f"batch leaf with leading axis {x.shape[0]}: expected the "
                f"fleet's {self.num_agents} agents or this gateway's "
                f"{self.hi - self.lo}")

        return tree_map(cut, batch)

    def _flags(self, state: TrainState):
        mach = self.mach
        use_ef = mach.needs_ef and state.ef_memory is not None
        if mach.needs_ef and not use_ef:
            _warn_ef_memory_missing()
        use_ctrl = mach.needs_ctrl and state.ctrl_state is not None
        if mach.needs_ctrl and not use_ctrl:
            _warn_ctrl_state_missing()
        use_net = mach.needs_net and state.net_state is not None
        if mach.needs_net and not use_net:
            _warn_net_state_missing()
        return use_ef, use_ctrl, use_net

    def _ratios(self, params) -> torch.Tensor:
        """This gateway's agents' wire ratios (shapes only: the
        payloads are params-shaped in the params' dtype), copied to the
        device once per parameter layout."""
        key = (dense_bits(params), dense_entries(params, per_agent=False))
        if key not in self._ratio_cache:
            db, de = key
            self._ratio_cache[key] = torch.tensor(
                [c.ratio_for(db, entries=de) if c else 1.0
                 for c in self.chains], dtype=torch.float32,
                device=self.device)
        return self._ratio_cache[key]

    def local(self, state: TrainState, batch, scale=None, chan_scale=None):
        """Everything before the reduce, for this gateway's agents:
        ``(payload, scalars, carry)``.  ``payload`` is the flattened
        masked partial sum of the sent payloads (of the encoded grids
        under sketch-native), ``scalars`` the packed column sums and
        ``any_tx`` slots, ``carry`` the tensors :meth:`finish` reads."""
        for leaf in tree_leaves(state.params):
            if leaf.device != self.device:
                raise ValueError(
                    f"sharded step built for {self.device} got params on "
                    f"{leaf.device}")
        params, step = state.params, state.step
        use_ef, use_ctrl, use_net = self._flags(state)
        batch = self._local_batch(batch)
        mem = state.ef_memory if use_ef else None
        losses, grads, outs = self.run(
            params, step, batch, mem,
            state.ctrl_state if use_ctrl else None,
            state.net_state if use_net else None,
            scale, chan_scale, use_ef, use_ctrl, use_net)
        alphas, gains, sent, new_mem, new_ctrl = outs[:5]
        delivereds = outs[5] if use_net else alphas
        new_net = outs[6] if use_net else None
        outs = None
        act = None
        if self.churn is not None:
            # inactive agents: zero weight and bytes, frozen slots
            joins, leaves = self.churn
            act = ((step >= joins) & (step < leaves)).float()
            alphas, gains = alphas * act, gains * act
            delivereds = delivereds * act

            def freeze(new, old):
                return tree_map(lambda n, o: torch.where(
                    act.reshape((-1,) + (1,) * (n.ndim - 1)) > 0.5, n, o),
                    new, old)

            if use_ef:
                new_mem = freeze(new_mem, state.ef_memory)
            if use_ctrl:
                new_ctrl = freeze(new_ctrl, state.ctrl_state)
            if use_net:
                new_net = freeze(new_net, state.net_state)

        # agents -> gateway: the local masked partial sum
        if self.skp is not None:
            rows, cols, seed = self.skp

            def partial(g):
                enc = sketch_encode(g, rows, cols, seed)
                return (enc * delivereds.reshape(-1, 1, 1)).sum(0)

            parts = blocks.map_leaves(partial, ef_add(grads, mem))
            payload = torch.cat([x.reshape(-1) for x in tree_leaves(parts)])
            del parts
        elif self.placement is None:
            def partial(s):
                a = delivereds.reshape(
                    (-1,) + (1,) * (s.ndim - 1)).to(s.dtype)
                return (s * a).sum(0)

            parts = tree_map(partial, sent)
            payload = torch.cat([x.reshape(-1) for x in tree_leaves(parts)])
            del parts
        else:
            # an LM's payload (not under the frontier's vmap), leaf by leaf
            leaves = tree_leaves(sent)
            sent = None
            payload = self.placement.partial_payload(leaves, delivereds)

        ratios = self._ratios(blocks.global_like(params, lead=0))
        stale = net_lib.net_rows(new_net)[:, 0] if use_net else None
        cols = [losses, alphas, gains, alphas * ratios, delivereds]
        if use_net:
            cols += [delivereds * ratios,
                     stale if act is None else stale * act]
        if act is not None:
            cols += [act, losses * act]
        sums = fold_sum(torch.stack(cols, 1))
        # the any_tx maximum: this gateway's in its own slot, so the sum
        # over gateways holds every gateway's, exactly
        rank, size = self.gateway, self.gateways
        slots = torch.cat([sums.new_zeros(rank), alphas.max().reshape(1),
                           sums.new_zeros(size - rank - 1)])
        scalars = torch.cat([sums, slots])

        carry = {"alphas": alphas, "delivereds": delivereds,
                 "ratios": ratios}
        if use_ef:
            carry["mem"] = new_mem
        if use_ctrl:
            carry["ctrl"] = new_ctrl
        if use_net:
            carry["net"] = new_net
            carry["stale"] = stale
        if act is not None:
            carry["act"] = act
        return payload, scalars, carry

    def reduce(self, payload: torch.Tensor, scalars: torch.Tensor):
        """Gateways -> center: one ``all_reduce`` of the payload partials
        and one of the packed scalars (a leading lane axis, where the
        frontier stacks its lanes, rides in the same two calls)."""
        return (self.mesh.all_reduce(payload.contiguous(), "payload",
                                     self.axes),
                self.mesh.all_reduce(scalars.contiguous(), "scalars",
                                     self.axes))

    def finish(self, state: TrainState, carry: dict, payload: torch.Tensor,
               scalars: torch.Tensor, shapes=None):
        """The center's update from the reduced sums, and the round's
        metrics: ``(new state, metrics)``.  ``shapes`` is the round's
        parameter tree (an LM mesh rank's model blocks, whose byte counts
        read the whole leaves), where ``state`` holds the blocks at rest
        (an LM mesh's placement, which then takes its block of the
        update)."""
        params, step = state.params, state.step
        shapes = params if shapes is None else shapes
        m = self.num_agents
        use_net, churned = "net" in carry, "act" in carry
        names = ["loss", "tx", "gain", "priced", "dl"]
        if use_net:
            names += ["dpriced", "stale"]
        if churned:
            names += ["act", "loss_act"]
        k = len(names)
        sums = dict(zip(names, scalars[:k].unbind()))
        any_tx = scalars[k:].max()
        den = torch.clamp(sums["dl"], min=1.0)

        flat = tree_flatten_with_path(shapes)
        skeleton = tree_map(lambda _: None, shapes)
        agg, at = [], 0
        for path, p in flat:
            if self.skp is not None:
                rows, cols, seed = self.skp
                grid = payload[at:at + rows * cols].reshape(1, rows, cols)
                at += rows * cols
                with blocks.at_leaf(path):
                    agg.append(sketch_decode(grid / den, p.shape, p.dtype,
                                             rows, cols, seed)[0])
            else:
                total = payload[at:at + p.numel()].reshape(p.shape)
                at += p.numel()
                agg.append(total.to(p.dtype) / den.to(p.dtype))
        agg = tree_unflatten(skeleton, agg)
        if self.placement is None:
            agg_sq = sum((x.float() * x.float()).sum()
                         for x in tree_leaves(agg))
            update = agg
        else:
            agg_sq = self.placement.sq_norm(agg)
            update = self.placement.update_block(agg, agg_sq)
        updates, opt_state = self.optimizer.update(update, state.opt_state,
                                                   params, step)
        new_params = tree_add_scaled(params, updates, 1.0)

        sb = structural_bytes(blocks.global_like(shapes, lead=0),
                              per_agent=False)
        rate_den = torch.clamp(sums["act"], min=1.0) if churned else m
        loss = sums["loss_act"] if churned else sums["loss"]
        metrics = {
            "loss": loss / rate_den,
            "comm_rate": sums["tx"] / rate_den,
            "any_tx": any_tx,
            "num_tx": sums["tx"],
            "mean_gain": sums["gain"] / rate_den,
            "grad_norm": torch.sqrt(agg_sq),
            "wire_bytes": (sb * sums["priced"]).float(),
        }
        if churned:
            metrics["num_active"] = sums["act"]
        if use_net:
            metrics["wire_bytes_attempted"] = metrics["wire_bytes"]
            metrics["wire_bytes"] = (sb * sums["dpriced"]).float()
            metrics["num_delivered"] = sums["dl"]
            metrics["delivered_rate"] = sums["dl"] / rate_den
            metrics["mean_staleness"] = sums["stale"] / rate_den
        if self.agent_metrics:
            metrics["agent_tx"] = carry["alphas"]
            metrics["agent_bytes"] = (
                sb * carry["ratios"] * carry["delivereds"]).float()
            if churned:
                metrics["agent_active"] = carry["act"]
            if use_net:
                metrics["agent_delivered"] = carry["delivereds"]
                metrics["agent_staleness"] = carry["stale"]
            if "ctrl" in carry:
                metrics["agent_lam"] = carry["ctrl"][..., 0]
        new_state = TrainState(
            step + 1, new_params, opt_state,
            carry["mem"] if "mem" in carry else state.ef_memory,
            carry["ctrl"] if "ctrl" in carry else state.ctrl_state,
            carry["net"] if use_net else state.net_state)
        return new_state, metrics

    def __call__(self, state: TrainState, batch, scale=None,
                 chan_scale=None):
        pl = self.placement
        if pl is None:
            payload, scalars, carry = self.local(state, batch, scale,
                                                 chan_scale)
            payload, scalars = self.reduce(payload, scalars)
            return self.finish(state, carry, payload, scalars)
        with pl.active():
            # the round's parameter tree (an LM mesh: this rank's model
            # blocks), and the rank's part of the batch
            full = state._replace(params=pl.gather_params(state.params))
            payload, scalars, carry = self.local(
                full, pl.local_rows(batch), scale, chan_scale)
            payload, scalars = self.reduce(payload, scalars)
            return self.finish(state, carry, payload, scalars,
                               shapes=full.params)


def make_sharded_train_step(
    loss_fn: Callable,
    optimizer,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    policy=None,
    aux_loss_fn: Optional[Callable] = None,
    oracle: Optional[tuple] = None,
    rules: Optional[dict] = None,
    sketch_native: bool = False,
    agent_metrics: bool = False,
    churn=None,
    device: DeviceLike = "cuda",
    placement=None,
):
    """Build this rank's fleet-sharded ``train_step(state, batch,
    scale=None, chan_scale=None) -> (state, metrics)``.

    The contract of ``make_triggered_train_step(...,
    hetero_dispatch="hybrid")``: the same per-agent state slots, the
    frontier's ``scale``/``chan_scale`` coordinates and the same metric
    keys (METRIC_KEYS, NET_METRIC_KEYS with a channel slot,
    ``num_active`` under churn, the per-agent vectors of this rank's
    agents under ``agent_metrics``); values agree to a few ULP.

    ``rules`` defaults to ``resolve_rules(mesh)``; the agents shard over
    ``rules["agent"]``.  ``sketch_native`` needs a shardable mesh and a
    uniformly sketch-terminal fleet, and raises ``ValueError`` otherwise.
    ``device`` is this rank's device (``mesh.device``).  ``placement``
    (an LM on a (data, model) mesh, :mod:`repro_torch.sharding.
    placement`) makes the ranks' parameters their blocks: gathered for
    the round, the update applied block by block; the ranks of one data
    coordinate are one gateway."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a repro_torch.launch.mesh.Mesh (make_fleet_mesh"
            f" inside the ranks that spawn starts), got {type(mesh).__name__}")
    dev = resolve_device(device)
    rules = rules if rules is not None else resolve_rules(mesh)
    m = cfg.num_agents
    aspec = agent_pspec(mesh, m, rules)  # warns LOUDLY on replication
    axes = agent_axis_names(mesh, rules)
    shards = agent_shard_count(mesh, rules)
    if churn is not None:
        churn = StepOptions(churn=churn).churn
        if len(churn) != m:
            raise ValueError(
                f"churn schedule has {len(churn)} entries but num_agents={m}")

    mach = build_hybrid_machinery(loss_fn, cfg, policy=policy,
                                  aux_loss_fn=aux_loss_fn, oracle=oracle)
    skp = sketch_native_params(mach.chains) if sketch_native else None
    if sketch_native and skp is None:
        raise ValueError(
            "sketch_native=True requires every agent's chain to be a "
            "single terminal sketch(rows,cols,seed) stage with identical "
            "parameters — gateway merge is only a sum in sketch space "
            "when all agents share one sketch table")

    if shards <= 1 or aspec == PartitionSpec():
        if sketch_native:
            raise ValueError(
                "sketch_native=True needs a shardable agent axis "
                f"(got {shards} shard(s) over axes {axes!r} for m={m}): "
                "the decode-once estimator only exists on the gateway "
                "path — drop sketch_native or fix the mesh/fleet sizes")
        # one gateway (or the replication agent_pspec just warned
        # about): the sharded program IS the hybrid step
        return make_triggered_train_step(
            loss_fn, optimizer, cfg, policy=policy, aux_loss_fn=aux_loss_fn,
            oracle=oracle, device=dev, placement=placement,
            options=StepOptions(hetero_dispatch="hybrid", barriers=False,
                                agent_metrics=agent_metrics, churn=churn))
    if mesh.group is None:
        raise ValueError(
            f"mesh {mesh.axis_names!r} {mesh.axis_sizes!r} is a descriptor "
            "with no process group: build it with make_fleet_mesh inside "
            "the ranks (repro_torch.launch.mesh.spawn)")
    if mesh.device is not None and mesh.device != dev:
        raise ValueError(f"step built for {dev} on a mesh whose rank runs "
                         f"on {mesh.device}")
    _check_span(mesh, axes)
    agents = gateway_agents(mesh, m, axes)
    return ShardedTrainStep(
        mesh=mesh, optimizer=optimizer, cfg=cfg, mach=mach,
        lo=agents.start, hi=agents.stop, skp=skp,
        agent_metrics=agent_metrics, churn=churn, device=dev, axes=axes,
        placement=placement)


# ----------------------------------------------------------------------
# global <-> per-rank trees (CPU copies; never inside a step)
# ----------------------------------------------------------------------

def _map_agents(tree, per_agent: Callable, other: Callable):
    """``per_agent`` on the per-agent entries of a TrainState (its three
    slots) or of a metrics dict (the ``agent_*`` vectors), ``other`` on
    the rest; None stays None."""
    def on(fn, x):
        return None if x is None else tree_map(fn, x)

    if isinstance(tree, TrainState):
        return TrainState(tree.step, on(other, tree.params),
                          on(other, tree.opt_state),
                          on(per_agent, tree.ef_memory),
                          on(per_agent, tree.ctrl_state),
                          on(per_agent, tree.net_state))
    return {k: on(per_agent if k in AGENT_METRIC_KEYS else other, v)
            for k, v in tree.items()}


def gather_agents(tree, mesh: Mesh, *, axis: int = 0):
    """The global TrainState (or metrics dict) from every rank's: the
    per-agent tensors of all gateways concatenated along their agent
    axis ``axis`` (1 for a frontier's stacked state), everything else
    this rank's copy; all on the CPU.  Every rank must call it (an
    ``all_gather`` over ``mesh.cpu_group``, or over the agent axes' gloo
    group beside a model axis) and every rank gets the result.  A
    one-rank mesh returns CPU copies."""
    def cpu(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    if mesh.group is None or mesh.size == 1:
        return _map_agents(tree, cpu, cpu)
    axes = agent_axis_names(mesh)

    def cat(x):
        if axes == mesh.axis_names:
            parts = mesh.all_gather_cpu(cpu(x), "gather")
        elif mesh.backend == "gloo":
            parts = torch.stack(mesh.all_gather(cpu(x), "gather", axes))
        else:
            raise todo("gather_agents beside a model axis under "
                       f"{mesh.backend!r}", "queue 1 item 11.2")
        parts = parts.movedim(0, axis)
        return parts.reshape(parts.shape[:axis] + (-1,)
                             + parts.shape[axis + 2:])

    return _map_agents(tree, cat, cpu)


def scatter_agents(tree, mesh: Mesh, *, axis: int = 0,
                   device: Optional[DeviceLike] = None):
    """This rank's part of a global TrainState (or metrics dict): the
    per-agent tensors cut to the gateway's agents along ``axis``, all
    moved to ``device`` (default: the mesh's).  No communication."""
    dev = resolve_device(device if device is not None
                         else (mesh.device or "cpu"))
    axes = agent_axis_names(mesh)
    gateways = mesh.axes_size(axes) if mesh.group is not None else 1
    gateway = mesh.axes_index(axes) if mesh.group is not None else 0

    def cut(x):
        per = x.shape[axis] // gateways
        return x.narrow(axis, gateway * per, per).to(dev)

    return _map_agents(tree, cut, lambda x: x.to(dev) if isinstance(
        x, torch.Tensor) else x)


def gateway_agents(mesh: Mesh, num_agents: int, axes=None) -> range:
    """The global agent indices this rank serves (its gateway: its
    coordinate over the agent ``axes``, default all of the mesh's)."""
    if mesh.group is None:
        return range(num_agents)
    axes = mesh.axis_names if axes is None else axes
    per = num_agents // mesh.axes_size(axes)
    g = mesh.axes_index(axes)
    return range(g * per, (g + 1) * per)
