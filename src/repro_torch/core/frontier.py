"""Batched operating-point frontiers over the real triggered train step.

The port of ``repro.core.frontier``.  A frontier is the same training
run at many operating points: the base policy with every trigger's knob
multiplied by a ``scale`` (a fixed trigger's threshold λ/μ, an adaptive
trigger's rate or byte TARGET, so the same axis sweeps budgets:
:func:`budget_scales`).  An optional second coordinate, ``chan_scales``,
multiplies each lane's channel severity (loss probability, mean lag;
divides a rate channel's capacity), so a loss-rate × budget-scale
surface flattens into two aligned ``(G,)`` vectors.

Grid layout.  The engine stacks the ``TrainState`` ``G`` times (every
tensor leaf: parameters, optimizer state, EF memory, controller rows,
channel rows and delay lines) and maps the train step over the lanes
with ``torch.func.vmap``:

    vmap(step, in_dims=(state: 0, batch: None, scale: 0[, chan_scale: 0]))

Every lane advances its own state on the round's SHARED batch, the
comparable-operating-points convention of the simulator's sweep.  The
round index ``TrainState.step`` is a host int shared by the lanes, so
the channel keys ``fold_in(fold_in(PRNGKey(seed), step), uid)`` are the
same in every lane: common random numbers, a delivery lost at severity
s is lost at every severity ≥ s.  The step is built with
``agent_metrics=True`` (per-lane, per-agent wire accounting).

One batched step per round.  Where the JAX package compiles one
``scan(vmap(step))`` program, :func:`run_frontier` is a host loop over
the K rounds of ONE vmapped step: each round dispatches the step's ops
once for the whole grid (the loss is traced once per round, not once per
lane), and a ``gain_quadratic(kernel=true)`` precursor is one
``gain_reduce`` launch over all lanes' agents (the kernel's ``vmap``
rule folds the lanes into its rows).  Batches come from a round-indexed
``batch_fn(k)``, the contract of ``FleetSession`` and the simulator.

Sharded.  With ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` of
gateway ranks) every rank runs the fleet-sharded step for its agents:
the lanes' local phases (gradients, triggers, compressors, partial sums)
run under the frontier's ``vmap``, the lanes' partials are stacked, and
ONE payload ``all_reduce`` (and one of the packed scalars) per round
carries every lane, outside any ``vmap``; then the lanes' updates run
under ``vmap`` again.  The state each rank holds and returns is its own
(per-agent slots of its agents, a leading lane axis; gather it with
``gather_agents(..., axis=1)``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.api import (
    StepOptions,
    TrainState,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.sharding.agent_shard import ShardedTrainStep, scatter_agents
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map


class FrontierResult(NamedTuple):
    """One batched frontier run.

    ``state`` is the stacked final TrainState (a leading ``(G,)`` axis on
    every tensor leaf; ``step`` stays the shared host int); ``metrics``
    maps each train-step metric to its ``(G, K)`` trajectory (``(G, K,
    m)`` for the per-agent vectors); ``scales`` is the ``(G,)`` grid and
    ``chan_scales`` the per-lane severity grid, or ``None``.
    """

    state: TrainState
    metrics: Dict[str, torch.Tensor]
    scales: torch.Tensor
    chan_scales: Optional[torch.Tensor] = None


def stack_states(state: TrainState, grid_size: int) -> TrainState:
    """Broadcast one TrainState into ``grid_size`` identical lanes (each
    tensor leaf copied, ``step`` shared)."""

    def stack(tree):
        return None if tree is None else tree_map(
            lambda x: x.unsqueeze(0).expand(grid_size, *x.shape).clone(),
            tree)

    return TrainState(state.step, *(stack(f) for f in state[1:]))


def budget_scales(targets, base: float, *,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """Absolute per-round budget targets → a ``(G,)`` float32 scale grid
    on ``device``: an adaptive policy built with base target ``base``
    (bytes for ``budget_window``, rate for ``budget_dual``) swept at
    ``budget_scales(targets, base)`` runs one lane per target."""
    if base <= 0:
        raise ValueError(f"base target must be positive, got {base!r}")
    return (torch.as_tensor(targets, dtype=torch.float32,
                            device=resolve_device(device))
            / torch.tensor(base, dtype=torch.float32))


def make_frontier_step(
    loss_fn: Callable,
    optimizer,
    cfg,
    *,
    policy=None,
    aux_loss_fn: Optional[Callable] = None,
    oracle: Optional[tuple] = None,
    hetero_dispatch: str = "hybrid",
    channel_axis: bool = False,
    mesh=None,
    rules=None,
    churn=None,
    device: DeviceLike = "cuda",
):
    """Build ``batched_step(states, batch, scales[, chan_scales]) ->
    (states, metrics)``.

    Lane ``i`` advances its own TrainState at threshold scale
    ``scales[i]`` (and, where ``chan_scales`` is given, channel severity
    ``chan_scales[i]``) on the shared ``batch``; metrics carry a leading
    ``(G,)`` axis.  ``channel_axis`` is accepted for the JAX package's
    signature and changes nothing: the axis is there exactly when
    ``chan_scales`` is passed.  ``hetero_dispatch`` passes through to
    the step (the ``switch`` and ``unroll`` loops map over the grid like
    ``hybrid``).  ``mesh``/``rules`` select the fleet-sharded step (the
    module docstring's "Sharded"; ``hetero_dispatch`` is ignored there).
    Use :func:`run_frontier` for the whole-run loop."""
    step = make_triggered_train_step(
        loss_fn, optimizer, cfg, policy=policy, aux_loss_fn=aux_loss_fn,
        oracle=oracle, device=device,
        options=StepOptions(hetero_dispatch=hetero_dispatch, barriers=False,
                            agent_metrics=True, mesh=mesh, rules=rules,
                            churn=churn))
    sharded = isinstance(step, ShardedTrainStep)

    def batched_step(states: TrainState, batch, scales, chan_scales=None):
        # the lanes' tensors are mapped; empty slots (None) and the
        # shared host step are not, and the step keeps that layout
        leaves, spec = pytree.tree_flatten(tuple(states[1:]))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        chan_dim = None if chan_scales is None else 0

        def fill(tensors):
            it = iter(tensors)
            return TrainState(states.step, *pytree.tree_unflatten(
                [next(it) if isinstance(x, torch.Tensor) else x
                 for x in leaves], spec))

        def out(new, metrics):
            return [x for x in pytree.tree_leaves(tuple(new[1:]))
                    if isinstance(x, torch.Tensor)], metrics

        if not sharded:
            def lane(tensors, scale, chan_scale):
                return out(*step(fill(tensors), batch, scale, chan_scale))

            new_tensors, metrics = torch.func.vmap(
                lane, in_dims=(0, 0, chan_dim))(tensors, scales,
                                                chan_scales)
            return TrainState(states.step + 1,
                              *fill(new_tensors)[1:]), metrics

        # the lanes' local phases, then the round's two collectives over
        # all lanes at once, then the lanes' updates
        payload, scalars, carry = torch.func.vmap(
            lambda t, s, c: step.local(fill(t), batch, s, c),
            in_dims=(0, 0, chan_dim))(tensors, scales, chan_scales)
        payload, scalars = step.reduce(payload, scalars)
        new_tensors, metrics = torch.func.vmap(
            lambda t, c, p, s: out(*step.finish(fill(t), c, p, s)))(
            tensors, carry, payload, scalars)
        return TrainState(states.step + 1, *fill(new_tensors)[1:]), metrics

    batched_step.sharded = sharded
    return batched_step


def run_frontier(
    loss_fn: Callable,
    optimizer,
    cfg,
    params: Any,
    *,
    scales,
    steps: int,
    batch_fn: Callable,
    policy=None,
    aux_loss_fn: Optional[Callable] = None,
    oracle: Optional[tuple] = None,
    hetero_dispatch: str = "hybrid",
    chan_scales=None,
    mesh=None,
    rules=None,
    churn=None,
    device: DeviceLike = "cuda",
) -> FrontierResult:
    """Run a whole loss-vs-communication frontier: ``steps`` rounds of
    one batched step over the ``(G,)`` grid ``scales`` on ``device``.

    ``scale`` 1.0 reproduces the base policy (λ·1.0 is exact in IEEE
    floats).  ``batch_fn(k)`` returns round ``k``'s per-agent batch,
    which every lane consumes; a drifting target evaluates its drift
    from ``k`` (:func:`repro_torch.data.synthetic.drifting_batch_fn`).
    ``chan_scales`` adds the channel-severity axis, aligned lane for lane
    with ``scales``; ``churn`` threads a per-agent ``((join, leave),
    ...)`` schedule to every lane (see :class:`StepOptions`).
    ``mesh``/``rules`` run the fleet-sharded step on this rank (see
    :func:`make_frontier_step`): every rank calls this with the same
    arguments, and its result holds its own agents' slots."""
    dev = resolve_device(device)
    scales = torch.as_tensor(scales, dtype=torch.float32).to(dev)
    if scales.ndim != 1:
        raise ValueError(
            f"scales must be a 1-D grid, got shape {tuple(scales.shape)}")
    grid = int(scales.shape[0])
    if chan_scales is not None:
        chan_scales = torch.as_tensor(chan_scales,
                                      dtype=torch.float32).to(dev)
        if chan_scales.shape != scales.shape:
            raise ValueError(
                f"chan_scales must align with scales lane-for-lane: got "
                f"{tuple(chan_scales.shape)} vs {tuple(scales.shape)}")
    batched_step = make_frontier_step(
        loss_fn, optimizer, cfg, policy=policy, aux_loss_fn=aux_loss_fn,
        oracle=oracle, hetero_dispatch=hetero_dispatch, mesh=mesh,
        rules=rules, churn=churn, device=dev)
    state0 = init_train_state(params, optimizer, cfg, policy=policy,
                              device=dev)
    if batched_step.sharded:
        state0 = scatter_agents(state0, mesh, device=dev)
    states = stack_states(state0, grid)
    history = []
    for k in range(steps):
        states, metrics = batched_step(states, batch_fn(k), scales,
                                       chan_scales)
        history.append(metrics)
    # grid-major (G, K, ...), as the JAX engine presents them
    metrics = {name: torch.stack([m[name] for m in history], 1)
               for name in history[0]} if history else {}
    return FrontierResult(state=states, metrics=metrics, scales=scales,
                          chan_scales=chan_scales)


def frontier_curve(result: FrontierResult) -> Dict[str, torch.Tensor]:
    """Reduce a frontier run to its per-point curve coordinates.

    Returns ``(G,)`` tensors: ``final_loss`` (last-round train loss),
    ``wire_bytes`` / ``transmissions`` (run totals), ``comm_rate`` (run
    mean), plus ``agent_bytes`` ``(G, m)`` run totals, the final
    ``agent_lam`` of adaptive policies, the mean ``num_active`` under
    churn, and on lossy frontiers ``chan_scale``,
    ``wire_bytes_attempted``, ``delivered_rate`` and the last
    ``mean_staleness``."""
    m = result.metrics
    curve = {
        "scale": result.scales,
        "final_loss": m["loss"][:, -1],
        "wire_bytes": m["wire_bytes"].sum(1),
        "transmissions": m["num_tx"].sum(1),
        "comm_rate": m["comm_rate"].mean(1),
    }
    if "agent_bytes" in m:
        curve["agent_bytes"] = m["agent_bytes"].sum(1)
    if "agent_lam" in m:
        curve["agent_lam"] = m["agent_lam"][:, -1]
    if "num_active" in m:
        curve["num_active"] = m["num_active"].mean(1)
    if result.chan_scales is not None:
        curve["chan_scale"] = result.chan_scales
    if "wire_bytes_attempted" in m:
        curve["wire_bytes_attempted"] = m["wire_bytes_attempted"].sum(1)
        curve["delivered_rate"] = m["delivered_rate"].mean(1)
        curve["mean_staleness"] = m["mean_staleness"][:, -1]
    return curve
