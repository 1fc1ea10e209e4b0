"""The paper's event-triggered round as a PyTorch train step.

The port of ``repro.core.api``.  ``make_triggered_train_step`` turns a
per-batch loss into one round over an m-agent fleet:

  1. per-agent stochastic gradients → ``torch.func.vmap`` of
     ``torch.func.grad_and_value`` over the batch's leading agent axis
  2. local trigger decisions α_k^i    → the policy's Trigger stage
                                        (eq. 11/28/31), all agents at once
  3. wire format of what IS sent      → the policy's compressor chain
                                        (+ error-feedback residuals)
  4. server aggregation, eq. (10)     → masked mean over the agent axis
  5. parameter update                 → the functional optimizer

The execution paths of the JAX package:

* **homogeneous** — one policy for every agent: the whole round runs
  batched over the agent axis;
* **heterogeneous ``"hybrid"``** (the default) — per-agent policies
  dedupe into a :class:`~repro_torch.comm.bank.StageBank`.  Phase 1
  computes every agent's gradient and the bank's distinct gain
  precursors once for all agents (a ``gain_quadratic(kernel=true)``
  precursor is ONE batched ``gain_reduce`` launch per round, however
  many tiers share it); phase 2 runs each distinct policy's epilogue on
  its own block of agents and merges the blocks back into agent order;
* **heterogeneous ``"switch"``** — a host loop over the agents (where
  JAX scans them): each agent's own unbatched gradient, then the bank
  branch its policy picks, on a block of one agent; the trigger
  computes its own precursor, so a kernel-gated agent launches
  ``gain_reduce`` once for itself;
* **heterogeneous ``"unroll"``** — the reference loop over agents with
  every stage inlined (channel draw, trigger, EF, compressors, the
  delay line or retransmit buffer), line for line as the JAX package's
  documented oracle.

The three heterogeneous paths agree to float tolerance, and exactly in
their decisions, deliveries and staleness counters; ``switch`` and
``unroll`` dispatch ~m times the host ops of ``hybrid``.

Adaptive (budget) triggers carry per-agent controller rows in
``TrainState.ctrl_state``, ``(m, CTRL_WIDTH)``: each policy block reads
and writes its own agents' rows; a policy with no adaptive trigger keeps
``ctrl_state=None`` and runs no extra op.

Lossy wires (``@ channel``, :mod:`repro_torch.net.channels`) carry
per-agent channel rows in ``TrainState.net_state``: each round draws
delivery before the trigger, escalates starved agents' knobs, folds
dropped payloads back into EF whole, aggregates eq. (10) over the
DELIVERED payloads (on a delay line, the matured ones at their
staleness-discounted weights) and splits the wire metrics into
attempted and delivered bytes.  A homogeneous delay or retransmit
policy runs through the stage bank as a one-policy bank.  ``@ ideal``
and channel-free policies allocate no slot and run the channel-free
program.  ``StepOptions.churn`` masks agents outside their ``[join,
leave)`` windows: zero weight, zero bytes, frozen per-agent state, and
every rate over the active agents.

The step composes with ``torch.func.vmap`` over a leading grid axis of
its state, ``scale`` and ``chan_scale`` (:mod:`repro_torch.core.frontier`):
nothing in it writes in place into an input, branches on a tensor's
value or reads one back to the host.

``TrainConfig.microbatches`` = m > 1 makes each agent's loss (and aux
loss) the mean over m equal slices of its batch (:func:`_microbatched`),
as the JAX package does; the plain step is not microbatched there
either.

``StepOptions.mesh`` routes to the fleet-sharded step
(:func:`repro_torch.sharding.agent_shard.make_sharded_train_step`): the
hybrid dispatch partitioned over the gateways of a
:class:`~repro_torch.launch.mesh.Mesh`, built on the same
:class:`HybridMachinery` and :func:`hybrid_dispatch` as the hybrid path
here, so the two cannot drift.  Every tensor stays on the step's device;
a state on another device is an error, not a silent copy.

``placement`` (a :class:`~repro_torch.sharding.placement.Placement`,
which :func:`repro_torch.launch.steps.build_train_step` makes for an LM
on a (data, model) mesh) runs the step on one rank of the mesh, as the
JAX package's step runs under ``jit`` with its agent axis sharded over
data: the rank's parameters and optimizer state at rest are its blocks,
gathered over the data axes at the start of the round (the model reads
its tensor-parallel blocks, and each agent's gradient is this rank's
model block of each leaf, as JAX pins it); its agents are its data
coordinate's, and so are the rows of its per-agent slots (EF memory,
controller rows, a channel's rows and a delay or retransmit line; the EF
memory and the line's payloads in model blocks); the comm epilogue runs
on the blocks (:mod:`repro_torch.sharding.blocks`); the masked mean's
sums and the agents' metric vectors are reduced over the agent axes;
and the rank applies its block of the update.  Per-agent policies run every
dispatch path over the rank's agents, each agent's policy the one its
global index names, so a data slice may run policies that another does
not: every collective inside an epilogue (the probe's forward) runs
over "model" alone, among the ranks that hold the same agents.  The
per-agent metric vectors are the fleet's.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.comm.bank import (
    agent_prologue,
    batch_prologue,
    build_stage_bank,
)
from repro_torch.comm.error_feedback import ef_add, ef_init, ef_residual
from repro_torch.comm.policy import (
    CommPolicy,
    ctrl_init,
    normalize_policy,
    resolve_policy,
)
from repro_torch.comm.registry import StageSpec
from repro_torch.comm.stats import (
    dense_bits,
    dense_entries,
    per_agent_wire_bytes,
    round_metrics,
    structural_bytes,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.aggregation import masked_mean
from repro_torch.net import channels as net_lib
from repro_torch.sharding import blocks
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import (
    tree_add_scaled,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

METRIC_KEYS = ("loss", "comm_rate", "any_tx", "num_tx", "mean_gain",
               "grad_norm", "wire_bytes")

# emitted only by steps whose state carries a channel slot: the
# attempted/delivered split of the wire metrics
NET_METRIC_KEYS = ("wire_bytes_attempted", "num_delivered",
                   "delivered_rate", "mean_staleness")
# emitted only by churn-carrying steps
CHURN_METRIC_KEYS = ("num_active",)

# per-agent metric vectors emitted under ``StepOptions.agent_metrics``
# (agent_lam with controllers, agent_delivered and agent_staleness with
# a channel slot, agent_active under churn)
AGENT_METRIC_KEYS = ("agent_tx", "agent_bytes", "agent_lam",
                     "agent_delivered", "agent_staleness", "agent_active")

# the heterogeneous-network execution paths (the default is [0])
DISPATCH_MODES = ("hybrid", "switch", "unroll")


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Execution options for :func:`make_triggered_train_step` (the
    fields of the JAX struct).

    ``hetero_dispatch`` picks the heterogeneous path (``"hybrid"``,
    ``"switch"`` or ``"unroll"``).  ``scale``/``chan_scale`` pin the
    step's operating point (a call-time value wins); ``churn`` is a
    per-agent tuple of ``(join, leave)`` rounds (agent ``i`` is active
    while ``join <= step < leave``).  ``barriers`` is accepted and has
    no effect: JAX pins XLA's fusions with it, and PyTorch runs each op
    as it is dispatched, with no fusion to pin.  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`) swaps in the fleet-sharded
    step partitioned over the mesh's agent axes; ``rules`` overrides its
    sharding rules and ``sketch_native`` turns on the gateway
    sketch-space merge; ``hetero_dispatch`` is ignored there (the
    sharded step is the hybrid dispatch, partitioned)."""

    hetero_dispatch: str = "hybrid"
    barriers: bool = True
    agent_metrics: bool = False
    scale: Optional[float] = None
    chan_scale: Optional[float] = None
    mesh: Any = None
    rules: Optional[dict] = None
    sketch_native: bool = False
    churn: Optional[Tuple[Tuple[int, int], ...]] = None

    def __post_init__(self):
        if self.hetero_dispatch not in DISPATCH_MODES:
            raise ValueError(
                f"unknown hetero_dispatch {self.hetero_dispatch!r}: "
                f"expected one of "
                f"{', '.join(repr(m) for m in DISPATCH_MODES)}"
            )
        if self.churn is not None:
            pairs = tuple(tuple(int(v) for v in p) for p in self.churn)
            for p in pairs:
                if len(p) != 2:
                    raise ValueError(
                        f"churn entries must be (join, leave) pairs, "
                        f"got {p!r}"
                    )
                if p[0] >= p[1]:
                    raise ValueError(
                        f"churn (join, leave) must satisfy join < "
                        f"leave, got {p!r}"
                    )
            object.__setattr__(self, "churn", pairs)


class TrainState(NamedTuple):
    step: int                         # round index (a host-side int)
    params: Any                       # a tree (dict) of tensors
    opt_state: Any
    ef_memory: Optional[Any] = None   # error-feedback residuals (A, *param)
    ctrl_state: Optional[Any] = None  # controller rows (A, CTRL_WIDTH)
    # channel rows (A, NET_WIDTH), or the (rows, line) pair of a
    # payload-buffering channel; None for channel-free and @ ideal
    net_state: Optional[Any] = None


def _policies(resolved):
    return resolved if isinstance(resolved, tuple) else (resolved,)


def init_train_state(params, optimizer, cfg: TrainConfig, policy=None, *,
                     device: DeviceLike = "cuda") -> TrainState:
    """The initial state on ``device``; EF memory is allocated iff the
    resolved policy (or any per-agent policy) carries error feedback,
    the controller slot iff any trigger is adaptive, and the channel
    slot iff any policy attaches a non-trivial channel (``@ ideal``
    allocates none)."""
    dev = resolve_device(device)
    params = tree_map(lambda v: torch.as_tensor(v).to(dev), params)
    resolved = normalize_policy(resolve_policy(cfg, policy), cfg.num_agents)
    ef = (ef_init(params, cfg.num_agents)
          if any(p.needs_ef for p in _policies(resolved)) else None)
    ctrl = ctrl_init(resolved, cfg.num_agents)
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        ef_memory=ef,
        ctrl_state=None if ctrl is None else ctrl.to(dev),
        net_state=net_lib.net_init(resolved, cfg.num_agents, params,
                                   device=dev),
    )


def _warn_ef_memory_missing():
    warnings.warn(
        "policy requests error feedback (+ef) but state.ef_memory is None "
        "— pass the same policy to init_train_state to allocate it; "
        "running WITHOUT error feedback",
        UserWarning,
        stacklevel=3,
    )


def _warn_ctrl_state_missing():
    warnings.warn(
        "policy has an adaptive budget trigger but state.ctrl_state is "
        "None — pass the same policy to init_train_state to allocate "
        "it; running OPEN-LOOP at the trigger's lam0 (no adaptation)",
        UserWarning,
        stacklevel=3,
    )


def _warn_net_state_missing():
    warnings.warn(
        "policy attaches a lossy channel (@ ...) but state.net_state is "
        "None — pass the same policy to init_train_state to allocate "
        "it; running over an IDEAL wire (no losses simulated)",
        UserWarning,
        stacklevel=3,
    )


def _take(tree, rows):
    """Rows ``rows`` (a slice or an index tensor) of every leaf."""
    if tree is None:
        return None
    return tree_map(lambda v: v[rows], tree)


def _cat(parts):
    """Per-agent blocks concatenated in order (None stays None)."""
    if parts[0] is None:
        return None
    return tree_map(lambda *xs: torch.cat(xs), *parts)


def _block_index(rows: Tuple[int, ...], device: torch.device):
    """A contiguous block as a slice (a view, no gather); otherwise an
    index tensor on the step's device."""
    if rows == tuple(range(rows[0], rows[0] + len(rows))):
        return slice(rows[0], rows[0] + len(rows))
    return torch.tensor(rows, dtype=torch.long, device=device)


def _compress_leafwise(chain, skeleton, leaves: list, memory, alphas,
                       delivered):
    """The homogeneous round's payloads ``C(g + ef)`` and new EF memory
    (None without ``memory``), leaf by leaf with the tree functions' own
    ops.  ``leaves`` is the gradient tree flattened by
    ``tree_flatten_with_path`` (``skeleton`` its structure); each entry
    is released once used, so of the per-agent trees (each m × the
    parameters: ~14 GB for an m = 2 step of one mixtral layer) one leaf
    of ``g + ef`` is live beside the results, where whole-tree ops would
    hold the gradients and ``g + ef`` too."""
    mem = None if memory is None else dict(tree_flatten_with_path(memory))
    sent, resid = [], []
    for i in range(len(leaves)):
        path, g = leaves[i]
        leaves[i] = None
        g_eff = ef_add(g, None if mem is None else mem[path])
        del g
        with blocks.at_leaf(path):
            s = chain.compress_tree(g_eff)
        sent.append(s)
        if mem is not None:
            resid.append(ef_residual(g_eff, s, alphas, delivered=delivered))
        del g_eff, s
    return (tree_unflatten(skeleton, sent),
            None if mem is None else tree_unflatten(skeleton, resid))


def _check_options(opts: StepOptions, cfg: TrainConfig):
    if opts.churn is not None and len(opts.churn) != cfg.num_agents:
        raise ValueError(
            f"churn schedule has {len(opts.churn)} entries but "
            f"num_agents={cfg.num_agents}"
        )


def _microbatched(fn, m: int):
    """``fn(params, batch) -> scalar`` over ``m`` equal microbatches.

    Each batch leaf is cut along its leading axis into ``m`` equal
    slices; the result is the fp32 sum of ``fn`` over the slices, in
    order from 0, over ``m``, as the JAX package's scan sums them.  Its
    gradient is the full batch's (the loss is a token mean over equal
    slices).  A Python loop under ``grad`` keeps every slice's graph, as
    JAX's scan keeps its residuals, so the peak falls only where a
    block is rematerialised.  A batch that ``m`` does not divide raises,
    as JAX's reshape does."""

    def looped(params, batch):
        leaves = tree_leaves(batch)
        n = leaves[0].shape[0]
        if any(x.shape[0] % m for x in leaves):
            raise ValueError(
                f"microbatches={m} does not divide the agent's batch of "
                f"{n}")
        k = n // m
        tot = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for j in range(m):
            tot = tot + fn(params,
                           tree_map(lambda x: x[j * k:(j + 1) * k], batch))
        return tot / m

    return looped


def make_triggered_train_step(
    loss_fn: Callable,
    optimizer,
    cfg: TrainConfig,
    *,
    policy=None,
    aux_loss_fn: Optional[Callable] = None,
    oracle: Optional[tuple] = None,
    options: Optional[StepOptions] = None,
    device: DeviceLike = "cuda",
    placement=None,
):
    """Build ``train_step(state, batch, scale=None, chan_scale=None)
    -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` is one agent's local empirical
    loss, written for ONE agent's batch; the step vmaps it over the
    leading agent axis (size ``cfg.num_agents``) of every batch leaf.
    ``policy`` is a :class:`CommPolicy`, a spec string or a per-agent
    sequence of either; omitted, it resolves from ``cfg.comm``.
    ``aux_loss_fn(params, batch) -> scalar`` (e.g. an MoE load-balance
    term) is added to the differentiated objective, in every dispatch
    path, but not to the reported loss or the trigger's gain.
    A trigger's ``kernel=true`` option routes its reductions through the
    ``gain_reduce`` kernel.  ``oracle`` is the ``(Σ, w*)`` pair the
    ``gain_exact`` trigger requires.

    ``scale`` multiplies every fixed trigger's threshold (an adaptive
    trigger's target); ``chan_scale`` a channel's severity.  Either may
    be a float or a 0-dim tensor on the step's device; ``None`` falls
    back to ``StepOptions``' value.

    The step runs on ``device``: its state and batch must live there.
    Metrics are 0-dim (and, with ``agent_metrics``, ``(A,)``) tensors on
    that device; nothing is copied to the host inside the step.

    ``placement`` runs the step on one rank of an LM mesh (the module
    doc); with ``StepOptions.mesh`` it goes to the fleet-sharded step.
    """
    dev = resolve_device(device)
    opts = options or StepOptions()
    if opts.mesh is not None:
        # the hybrid step partitioned over the mesh's gateways
        # (microbatching and policy resolution happen inside)
        from repro_torch.sharding.agent_shard import make_sharded_train_step

        step = make_sharded_train_step(
            loss_fn, optimizer, cfg, opts.mesh, policy=policy,
            aux_loss_fn=aux_loss_fn, oracle=oracle, rules=opts.rules,
            sketch_native=opts.sketch_native,
            agent_metrics=opts.agent_metrics, churn=opts.churn, device=dev,
            placement=placement)
        if opts.scale is None and opts.chan_scale is None:
            return step

        def pinned(state, batch, scale=None, chan_scale=None):
            return step(state, batch,
                        opts.scale if scale is None else scale,
                        opts.chan_scale if chan_scale is None else chan_scale)

        return pinned
    _check_options(opts, cfg)
    agent_metrics = opts.agent_metrics
    if cfg.microbatches > 1:
        loss_fn = _microbatched(loss_fn, cfg.microbatches)
        if aux_loss_fn is not None:
            aux_loss_fn = _microbatched(aux_loss_fn, cfg.microbatches)
    resolved = normalize_policy(resolve_policy(cfg, policy), cfg.num_agents)
    hetero: Optional[Tuple[CommPolicy, ...]] = (
        resolved if isinstance(resolved, tuple) else None
    )
    if (hetero is None and resolved.needs_net
            and resolved.channel_model().depth > 0):
        # a homogeneous delay / retransmit policy runs as a one-policy
        # bank: the payload line's epilogue lives in one place
        hetero = (resolved,) * cfg.num_agents
    dispatch = opts.hetero_dispatch
    # the global indices of the agents whose rows the step holds: every
    # agent, or on a mesh rank its data coordinate's
    mine = range(cfg.num_agents) if placement is None else placement.agents
    prologue = batch_prologue(loss_fn, aux_loss_fn)
    per_agent_grad = agent_prologue(loss_fn, aux_loss_fn)

    if hetero is None:
        trigger = resolved.build_trigger(loss_fn=loss_fn, probe_eps=cfg.lr,
                                         oracle=oracle)
        chain = resolved.chain()
        needs_ef = resolved.needs_ef
        needs_ctrl = resolved.is_adaptive
        channel = resolved.channel_model() if resolved.needs_net else None
        needs_net = channel is not None
        chains = (chain,)
    else:
        mach = _machinery(hetero, loss_fn, aux_loss_fn, cfg, oracle)
        bank = mach.bank
        needs_ef, needs_ctrl, needs_net = (mach.needs_ef, mach.needs_ctrl,
                                           mach.needs_net)
        chains = mach.chains
        hybrid_run = hybrid_dispatch(mach, mine, dev)
        branches = _branches(bank)
        # the unrolled loop's stages, agent by agent (built once per
        # distinct policy: the bank's own)
        stages = [(bank.triggers[b], bank.chains[b], bank.ef_flags[b],
                   bank.adaptive_flags[b], bank.channels[b])
                  for b in bank.agent_index]
    if opts.churn is not None:
        joins = torch.tensor([opts.churn[i][0] for i in mine], device=dev)
        leaves = torch.tensor([opts.churn[i][1] for i in mine], device=dev)

    def check_device(state: TrainState):
        for leaf in tree_leaves(state.params):
            if leaf.device != dev:
                raise ValueError(
                    f"train step built for {dev} got params on "
                    f"{leaf.device}; move the state with "
                    f"init_train_state(..., device=...) or "
                    f"repro_torch.convert"
                )

    def freeze(new, old, act):
        """``new`` where the agent is active, ``old`` where not."""
        return tree_map(lambda n, o: torch.where(
            act.reshape((-1,) + (1,) * (n.ndim - 1)) > 0.5, n, o), new, old)

    # The heterogeneous paths.  Each returns the round's losses and the
    # epilogue's outputs in agent order: (alphas, gains, sent, new EF
    # memory, controller rows), then (delivered, net state) with a
    # channel slot.

    def hybrid_round(state, batch, scale, chan_scale, use_ef, use_ctrl,
                     use_net):
        losses, _, merged = hybrid_run(
            state.params, state.step, batch,
            state.ef_memory if use_ef else None,
            state.ctrl_state if use_ctrl else None,
            state.net_state if use_net else None,
            scale, chan_scale, use_ef, use_ctrl, use_net)
        return losses, merged

    def switch_round(state, batch, scale, chan_scale, use_ef, use_ctrl,
                     use_net):
        params, step = state.params, state.step
        mem = state.ef_memory if use_ef else None
        ctrl = state.ctrl_state if use_ctrl else None
        net = state.net_state if use_net else None
        epilogues = branches[use_ef, use_ctrl, use_net]
        losses, outs = [], []
        for j, i in enumerate(mine):
            # agent i (row j) alone: its own gradient, then its policy's
            # branch on a block of one (no precursor: the trigger
            # computes it, and its channel keys)
            b = bank.agent_index[i]
            rows = slice(j, j + 1)
            agent_batch = _take(batch, rows)
            loss, g = per_agent_grad(params, agent_batch)
            losses.append(loss)
            outs.append(epilogues[b](
                params, g, agent_batch, loss, step, _take(mem, rows),
                _take(ctrl, rows), scale, None, _take(net, rows),
                chan_scale))
        return torch.cat(losses), [_cat([o[k] for o in outs])
                                   for k in range(len(outs[0]))]

    def trigger_call(trig, adaptive, use_ctrl, params, g, agent_batch, main,
                     step, ctrl_row, scale, delivered=None):
        """One trigger evaluation under either protocol: ``(alpha, gain,
        new controller row)``, the row None without a controller slot."""
        if adaptive:
            row = ctrl_row if use_ctrl else trig.ctrl0.to(dev).expand(
                main.shape[0], -1)
            kw = {} if delivered is None else {"delivered": delivered}
            (alpha, gain), new_row = trig(params, g, agent_batch, main, step,
                                          row, scale, **kw)
            return alpha, gain, (new_row if use_ctrl else None)
        alpha, gain = trig(params, g, agent_batch, main, step, scale)
        return alpha, gain, (ctrl_row if use_ctrl else None)

    def unroll_round(state, batch, scale, chan_scale, use_ef, use_ctrl,
                     use_net):
        # the reference loop over agents, every stage inlined, each on a
        # block of one agent
        params, step = state.params, state.step
        per, ctrl_rows, net_rows_out = [], [], []
        for j, i in enumerate(mine):
            trig_i, chain_i, ef_i, ad_i, chan_i = stages[i]
            rows = slice(j, j + 1)
            agent_batch = _take(batch, rows)
            main, g = per_agent_grad(params, agent_batch)
            use_chan = use_net and chan_i is not None
            use_retx = use_chan and chan_i.retx_k > 0
            use_delay = use_chan and chan_i.depth > 0 and not use_retx
            net_i = _take(state.net_state, rows) if use_net else None
            if use_retx:
                d, stale, pending, commit = net_lib.retx_round(
                    chan_i, net_i, step, chan_scale,
                    net_lib.tx_cost(g, chain_i))
                eff_scale = net_lib.stale_scale(scale, chan_i.boost, stale,
                                                ad_i)
            elif use_delay:
                d, stale, commit = net_lib.delay_round(chan_i, net_i, step,
                                                       chan_scale)
                eff_scale = net_lib.stale_scale(scale, chan_i.boost, stale,
                                                ad_i)
            elif use_chan:
                d, stale, finalize = net_lib.channel_round(
                    chan_i, net_lib.net_rows(net_i), step, chan_scale,
                    net_lib.tx_cost(g, chain_i))
                eff_scale = net_lib.stale_scale(scale, chan_i.boost, stale,
                                                ad_i)
            else:
                d, eff_scale = None, scale
            alpha, gain, new_row = trigger_call(
                trig_i, ad_i, use_ctrl, params, g, agent_batch, main, step,
                _take(state.ctrl_state, rows) if use_ctrl else None,
                eff_scale, delivered=d if (use_chan and ad_i) else None)
            ctrl_rows.append(new_row)
            agent_ef = ef_i and use_ef
            mem_i = _take(state.ef_memory, rows) if agent_ef else None
            g_eff = ef_add(g, mem_i)
            s = chain_i.compress_tree(g_eff) if chain_i else g_eff
            if use_retx:
                # alpha becomes the realized attempt, the server sees the
                # buffered payload on re-offer rounds, and the EF fold
                # waits for the final failure
                attempt, out_s, delivered, fold, new_net_i = commit(alpha, s)
                resid = tree_map(
                    torch.add, ef_residual(g_eff, s, alpha * (1.0 - pending)),
                    fold) if agent_ef else None
                net_rows_out.append(new_net_i)
                per.append((main, attempt, gain, out_s, resid, delivered))
                continue
            resid = ef_residual(g_eff, s, alpha,
                                delivered=d if use_chan else None
                                ) if agent_ef else None
            if use_delay:
                # the payload enqueues; the server sees the matured head
                # at its staleness weight
                s, delivered, new_net_i = commit(alpha * d, s)
                net_rows_out.append(new_net_i)
            elif use_chan:
                delivered = alpha * d
                new_rows = finalize(delivered)
                net_rows_out.append((new_rows, net_i[1])
                                    if isinstance(net_i, tuple) else new_rows)
            else:
                # a channel-free agent: delivery IS the decision
                delivered = alpha
                if use_net:
                    net_rows_out.append(net_i)
            per.append((main, alpha, gain, s, resid, delivered))
        new_ef = None
        if use_ef:
            zeros = tree_map(lambda v: torch.zeros_like(v[:1]),
                             state.ef_memory)
            new_ef = _cat([p[4] if p[4] is not None else zeros for p in per])
        merged = [_cat([p[k] for p in per]) for k in (1, 2, 3)] + [
            new_ef, _cat(ctrl_rows) if use_ctrl else None]
        if use_net:
            merged += [_cat([p[5] for p in per]), _cat(net_rows_out)]
        return _cat([p[0] for p in per]), merged

    def train_step(state: TrainState, batch, scale=None, chan_scale=None):
        if placement is None:
            return round_(state, batch, scale, chan_scale)
        with placement.active():
            return round_(state, batch, scale, chan_scale)

    def round_(state: TrainState, batch, scale, chan_scale):
        check_device(state)
        at_rest = state.params
        if placement is not None:
            # the round's parameter tree; the batch's rows of this
            # rank's agents
            state = state._replace(params=placement.gather_params(at_rest))
            batch = placement.local_rows(batch)
        if scale is None:
            scale = opts.scale
        if chan_scale is None:
            chan_scale = opts.chan_scale
        params, step = state.params, state.step
        use_ef = needs_ef and state.ef_memory is not None
        if needs_ef and not use_ef:
            _warn_ef_memory_missing()
        use_ctrl = needs_ctrl and state.ctrl_state is not None
        if needs_ctrl and not use_ctrl:
            _warn_ctrl_state_missing()
        # the channel engages only when the state carries its rows
        use_net = needs_net and state.net_state is not None
        if needs_net and not use_net:
            _warn_net_state_missing()
        new_ctrl, new_net = state.ctrl_state, state.net_state
        ds = None
        if hetero is None:
            losses, grads = prologue(params, batch)
            eff_scale = scale
            if use_net:
                # the delivery draw comes BEFORE the trigger; staleness
                # escalates a starved agent's threshold or target
                ds, stale, finalize = net_lib.channel_round(
                    channel, state.net_state, step, chan_scale,
                    net_lib.tx_cost(grads, chain))
                eff_scale = net_lib.stale_scale(scale, channel.boost, stale,
                                                needs_ctrl)
            kw = {"delivered": ds} if (use_net and needs_ctrl) else {}
            if needs_ctrl:
                ctrl_rows = (state.ctrl_state if use_ctrl else
                             trigger.ctrl0.to(dev).expand(losses.shape[0], -1))
                (alphas, gains), ctrl_rows = trigger(
                    params, grads, batch, losses, step, ctrl_rows, eff_scale,
                    **kw)
                if use_ctrl:
                    new_ctrl = ctrl_rows
            else:
                alphas, gains = trigger(params, grads, batch, losses, step,
                                        eff_scale)
            if chain:
                skeleton = tree_map(lambda _: None, grads)
                flat = tree_flatten_with_path(grads)
                grads = None  # the list holds the gradient leaves now
                sent, new_ef = _compress_leafwise(
                    chain, skeleton, flat,
                    state.ef_memory if use_ef else None, alphas, ds)
                if not use_ef:
                    new_ef = state.ef_memory
            else:
                sent, new_ef = grads, state.ef_memory
            if use_net:
                delivereds = alphas * ds
                new_net = finalize(delivereds)
            else:
                delivereds = alphas
        else:
            run = {"hybrid": hybrid_round, "switch": switch_round,
                   "unroll": unroll_round}[dispatch]
            losses, merged = run(state, batch, scale, chan_scale, use_ef,
                                 use_ctrl, use_net)
            alphas, gains, sent, new_mem, ctrl_rows = merged[:5]
            delivereds = merged[5] if use_net else alphas
            if use_net:
                new_net = merged[6]
            new_ef = new_mem if use_ef else state.ef_memory
            if use_ctrl:
                new_ctrl = ctrl_rows

        act = None
        if opts.churn is not None:
            # agents outside [join, leave) are masked out of the round:
            # zero weight and bytes, frozen per-agent state
            act = ((step >= joins) & (step < leaves)).float()
            alphas, gains = alphas * act, gains * act
            delivereds = delivereds * act
            if new_ef is not None and new_ef is not state.ef_memory:
                new_ef = freeze(new_ef, state.ef_memory, act)
            if new_ctrl is not None and new_ctrl is not state.ctrl_state:
                new_ctrl = freeze(new_ctrl, state.ctrl_state, act)
            if use_net:
                new_net = freeze(new_net, state.net_state, act)

        stale_col = net_lib.net_rows(new_net)[:, 0] if use_net else None
        if placement is not None:
            # the fleet's vectors from every rank's agents: one reduce
            cols = [losses, alphas, gains, delivereds]
            cols += [stale_col] if use_net else []
            cols += [act] if act is not None else []
            fleet = placement.agent_columns(torch.stack(
                [c.float() for c in cols], 1)).unbind(1)
            losses, alphas, gains, delivereds = fleet[:4]
            stale_col = fleet[4] if use_net else None
            act = fleet[-1] if act is not None else None
        # wire ratios against the gradients' native dtype width (of the
        # whole leaves, where the payload is model blocks)
        sizes = blocks.global_like(sent)
        db = dense_bits(sizes)
        sb = structural_bytes(sizes, per_agent=True)
        de = dense_entries(sizes, per_agent=True)
        del sizes
        # eq. (10) over what was DELIVERED (the decisions, when lossless)
        if placement is None:
            agg = masked_mean(sent, delivereds)
        else:
            mine = delivereds[placement.agents.start:placement.agents.stop]
            skeleton = tree_map(lambda _: None, sent)
            payload = tree_leaves(sent)
            sent = None  # the list holds the payload leaves now
            agg = placement.masked_mean(
                payload, skeleton, mine,
                torch.clamp(delivereds.sum(), min=1.0))
        sent = None  # the payloads' memory is free for the update
        if placement is None:
            agg_sq = sum((x.float() * x.float()).sum()
                         for x in tree_leaves(agg))
            updates, opt_state = optimizer.update(agg, state.opt_state,
                                                  params, step)
            new_params = tree_add_scaled(params, updates, 1.0)
        else:
            # this rank's block of the update, on its block at rest
            agg_sq = placement.sq_norm(agg)
            updates, opt_state = optimizer.update(
                placement.update_block(agg, agg_sq), state.opt_state,
                at_rest, step)
            new_params = tree_add_scaled(at_rest, updates, 1.0)
        ratios = tuple(
            c.ratio_for(db, entries=de) if c else 1.0 for c in chains
        )
        metrics = round_metrics(
            losses, alphas, gains, structural=sb, ratios=ratios,
            delivered=delivereds if use_net else None, staleness=stale_col,
            active=act)
        metrics["grad_norm"] = torch.sqrt(agg_sq)
        if agent_metrics:
            metrics["agent_tx"] = alphas
            # delivered bytes under a channel
            metrics["agent_bytes"] = per_agent_wire_bytes(
                delivereds, structural=sb, ratios=ratios)
            if act is not None:
                metrics["agent_active"] = act
            if use_net:
                metrics["agent_delivered"] = delivereds
                metrics["agent_staleness"] = stale_col
            if needs_ctrl and new_ctrl is not None:
                # the controllers' per-agent thresholds
                lam = new_ctrl[..., 0]
                metrics["agent_lam"] = lam if placement is None else (
                    placement.agent_columns(lam[:, None])[:, 0])
        return (
            TrainState(step + 1, new_params, opt_state, new_ef,
                       new_ctrl, new_net),
            metrics,
        )

    return train_step


def make_plain_train_step(loss_fn: Callable, optimizer, cfg: TrainConfig,
                          **kw):
    """Dense baseline: every agent always transmits (synchronous SGD).

    The resolved policy (or each per-agent policy) with its trigger
    replaced by ``always``; compressors, EF and channels stay.  ``kw``
    are :func:`make_triggered_train_step`'s keywords."""
    resolved = normalize_policy(resolve_policy(cfg, kw.pop("policy", None)),
                                cfg.num_agents)
    dense = StageSpec("always")
    if isinstance(resolved, tuple):
        policy = tuple(dataclasses.replace(p, trigger=dense)
                       for p in resolved)
    else:
        policy = dataclasses.replace(resolved, trigger=dense)
    return make_triggered_train_step(loss_fn, optimizer, cfg, policy=policy,
                                     **kw)


class HybridMachinery(NamedTuple):
    """The resolved policy machinery behind the hybrid dispatch (the JAX
    package's named tuple).

    :func:`make_triggered_train_step`'s hybrid path and the fleet-sharded
    step (:mod:`repro_torch.sharding.agent_shard`) both run
    :func:`hybrid_dispatch` over it: the same per-agent ops, over all
    agents or over one gateway's slice.  ``grad_prologue`` is batched
    over the agents (``(params, batch) -> (losses (A,), grads)``), where
    the JAX package's is one agent's ``value_and_grad`` that its callers
    vmap."""

    bank: Any                        # deduped StageBank over the agents
    grad_prologue: Callable          # (params, batch) -> (losses, grads)
    prologue_fns: Tuple[Callable, ...]
    scan_batch_free: bool            # epilogues never touch the batch
    chains: Tuple[Any, ...]          # per-agent chain (wire pricing)
    needs_ef: bool
    needs_ctrl: bool
    needs_net: bool


def _machinery(policies: Tuple[CommPolicy, ...], loss_fn, aux_loss_fn,
               cfg: TrainConfig, oracle) -> HybridMachinery:
    bank = build_stage_bank(policies, loss_fn=loss_fn, probe_eps=cfg.lr,
                            oracle=oracle)
    prologue_fns, _ = bank.prologues()
    return HybridMachinery(
        bank=bank,
        grad_prologue=batch_prologue(loss_fn, aux_loss_fn),
        prologue_fns=tuple(prologue_fns),
        scan_batch_free=bank.epilogue_batch_free,
        chains=bank.agent_chains(),
        needs_ef=bank.needs_ef,
        needs_ctrl=bank.needs_ctrl,
        needs_net=bank.needs_net,
    )


def build_hybrid_machinery(
    loss_fn: Callable,
    cfg: TrainConfig,
    *,
    policy=None,
    aux_loss_fn: Optional[Callable] = None,
    oracle: Optional[tuple] = None,
) -> HybridMachinery:
    """Resolve a policy into the hybrid dispatch's stage-bank machinery.

    ``cfg.microbatches`` wraps the losses (:func:`_microbatched`); a
    homogeneous policy is widened to a per-agent tuple, so the bank is
    always a (deduped: one policy then) :class:`StageBank`."""
    if cfg.microbatches > 1:
        loss_fn = _microbatched(loss_fn, cfg.microbatches)
        if aux_loss_fn is not None:
            aux_loss_fn = _microbatched(aux_loss_fn, cfg.microbatches)
    resolved = normalize_policy(resolve_policy(cfg, policy), cfg.num_agents)
    hetero = (resolved if isinstance(resolved, tuple)
              else (resolved,) * cfg.num_agents)
    return _machinery(hetero, loss_fn, aux_loss_fn, cfg, oracle)


def _branches(bank) -> dict:
    """The bank's epilogues for every (EF, controller, channel) slot
    combination."""
    return {(has_mem, has_ctrl, has_net):
            bank.epilogues(has_mem, has_ctrl, has_net)
            for has_mem in (False, True)
            for has_ctrl in (False, True)
            for has_net in (False, True)}


def hybrid_dispatch(mach: HybridMachinery, agents: Sequence[int],
                    device: torch.device) -> Callable:
    """The hybrid dispatch's round over the global agent indices
    ``agents`` (every agent, or one gateway's slice), as

        run(params, step, batch, mem, ctrl, net, scale, chan_scale,
            use_ef, use_ctrl, use_net) -> (losses, grads, outs)

    where the batch and the per-agent slots (``None`` where unused) hold
    the rows of ``agents`` in order, and ``outs`` is the epilogue's
    ``[alphas, gains, sent, new EF memory, controller rows]`` (then
    ``[delivered, net state]`` with a channel slot) in the same order.
    Phase 1 computes the gradients and every distinct gain precursor
    once for all the rows (a kernel-gated precursor is one
    ``gain_reduce`` launch); phase 2 runs each distinct policy's
    epilogue on its own block of rows.  Channel keys come from the rows'
    agent-index column, so a gateway draws its agents' global keys."""
    bank = mach.bank
    block_rows, inv_order = bank.policy_blocks(agents)
    present = tuple(p for p, rows in enumerate(block_rows) if rows)
    blocks = tuple(_block_index(block_rows[p], device) for p in present)
    inv_ix = None if inv_order == tuple(range(len(inv_order))) else (
        torch.tensor(inv_order, dtype=torch.long, device=device))
    branches = _branches(bank)
    batch_free = mach.scan_batch_free

    def merge(parts):
        """Concatenate per-block results and restore row order."""
        merged = _cat(parts)
        return merged if inv_ix is None else _take(merged, inv_ix)

    def run(params, step, batch, mem, ctrl, net, scale, chan_scale, use_ef,
            use_ctrl, use_net):
        losses, grads = mach.grad_prologue(params, batch)
        # phase 1: every distinct gain precursor, once for all rows
        pres = torch.stack(
            [fn(params, grads, batch, losses).float()
             for fn in mach.prologue_fns], 1) if mach.prologue_fns else None
        # every row's channel keys, one derivation per seed
        keys = {seed: net_lib.round_keys(
            seed, step, net_lib.net_rows(net)[:, 2])
            for seed in bank.key_seeds} if use_net else None
        # phase 2: each distinct policy's epilogue on its own block
        epilogues = branches[use_ef, use_ctrl, use_net]
        outs = [
            epilogues[p](params, _take(grads, rows),
                         None if batch_free else _take(batch, rows),
                         losses[rows], step, _take(mem, rows),
                         _take(ctrl, rows), scale,
                         None if pres is None else pres[rows],
                         _take(net, rows), chan_scale, _take(keys, rows))
            for rows, p in zip(blocks, present)
        ]
        return losses, grads, [merge([o[k] for o in outs])
                               for k in range(len(outs[0]))]

    return run
