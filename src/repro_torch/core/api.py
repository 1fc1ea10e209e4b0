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

Two execution paths, as in the JAX package:

* **homogeneous** — one policy for every agent: the whole round runs
  batched over the agent axis;
* **heterogeneous ``"hybrid"``** — per-agent policies dedupe into a
  :class:`~repro_torch.comm.bank.StageBank`.  Phase 1 computes every
  agent's gradient and the bank's distinct gain precursors once for all
  agents (a ``gain_quadratic(kernel=true)`` precursor is ONE batched
  ``gain_reduce`` launch per round, however many tiers share it);
  phase 2 runs each distinct policy's epilogue on its own block of
  agents and merges the blocks back into agent order.

Adaptive (budget) triggers carry per-agent controller rows in
``TrainState.ctrl_state``, ``(m, CTRL_WIDTH)``: each policy block reads
and writes its own agents' rows; a policy with no adaptive trigger keeps
``ctrl_state=None`` and runs no extra op.

The ``"switch"``/``"unroll"`` dispatch paths, lossy channels, churn and
the fleet-sharded mesh path are not ported yet: asking for one raises
``NotImplementedError`` with its ROADMAP item.  Every tensor stays on
the step's device; a state on another device is an error, not a silent
copy.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm.bank import batch_prologue, build_stage_bank
from repro_torch.comm.error_feedback import ef_add, ef_init, ef_residual
from repro_torch.comm.policy import (
    CommPolicy,
    ctrl_init,
    normalize_policy,
    resolve_policy,
)
from repro_torch.comm.stats import (
    comm_stats,
    dense_bits,
    dense_entries,
    fold_sum,
    per_agent_wire_bytes,
    structural_bytes,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.aggregation import masked_mean
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.todo import not_ported, todo
from repro_torch.utils.tree import tree_add_scaled, tree_leaves, tree_map

METRIC_KEYS = ("loss", "comm_rate", "any_tx", "num_tx", "mean_gain",
               "grad_norm", "wire_bytes")

# emitted only by lossy-channel / churn-carrying steps in the JAX
# package; kept so the key sets stay comparable
NET_METRIC_KEYS = ("wire_bytes_attempted", "num_delivered",
                   "delivered_rate", "mean_staleness")
CHURN_METRIC_KEYS = ("num_active",)

# per-agent metric vectors emitted under ``StepOptions.agent_metrics``
# (agent_tx, agent_bytes and, with controllers, agent_lam; the rest
# belong to the lossy and churn paths)
AGENT_METRIC_KEYS = ("agent_tx", "agent_bytes", "agent_lam",
                     "agent_delivered", "agent_staleness", "agent_active")

# the heterogeneous-network execution paths (the default is [0])
DISPATCH_MODES = ("hybrid", "switch", "unroll")

_DISPATCH_ITEM = "queue 1 item 6"


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Execution options for :func:`make_triggered_train_step` (the
    fields of the JAX struct; this slice runs ``hetero_dispatch=
    "hybrid"``, ``agent_metrics`` and a fixed ``scale``, and raises on
    the others)."""

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


class TrainState(NamedTuple):
    step: int                         # round index (a host-side int)
    params: Any                       # a tree (dict) of tensors
    opt_state: Any
    ef_memory: Optional[Any] = None   # error-feedback residuals (A, *param)
    ctrl_state: Optional[Any] = None  # controller rows (A, CTRL_WIDTH)
    net_state: Optional[Any] = None   # lossy channels (not ported)


def _policies(resolved):
    return resolved if isinstance(resolved, tuple) else (resolved,)


def init_train_state(params, optimizer, cfg: TrainConfig, policy=None, *,
                     device: DeviceLike = "cuda") -> TrainState:
    """The initial state on ``device``; EF memory is allocated iff the
    resolved policy (or any per-agent policy) carries error feedback,
    the controller slot iff any trigger is adaptive."""
    dev = resolve_device(device)
    params = tree_map(lambda v: torch.as_tensor(v).to(dev), params)
    resolved = normalize_policy(resolve_policy(cfg, policy), cfg.num_agents)
    if any(p.needs_net for p in _policies(resolved)):
        raise todo("lossy '@ channel' wires", "queue 1 item 7")
    ef = (ef_init(params, cfg.num_agents)
          if any(p.needs_ef for p in _policies(resolved)) else None)
    ctrl = ctrl_init(resolved, cfg.num_agents)
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        ef_memory=ef,
        ctrl_state=None if ctrl is None else ctrl.to(dev),
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


def _take(tree, rows):
    """Rows ``rows`` (a slice or an index tensor) of every leaf."""
    if tree is None:
        return None
    return tree_map(lambda v: v[rows], tree)


def _block_index(rows: Tuple[int, ...], device: torch.device):
    """A contiguous block as a slice (a view, no gather); otherwise an
    index tensor on the step's device."""
    if rows == tuple(range(rows[0], rows[0] + len(rows))):
        return slice(rows[0], rows[0] + len(rows))
    return torch.tensor(rows, dtype=torch.long, device=device)


def _check_options(opts: StepOptions, cfg: TrainConfig, aux_loss_fn):
    if opts.mesh is not None:
        raise todo("the fleet-sharded step (StepOptions.mesh)",
                   "queue 1 item 11")
    if opts.churn is not None:
        raise todo("scenario churn (StepOptions.churn)", "queue 1 item 7")
    if opts.chan_scale is not None:
        raise todo("channel-severity scaling (StepOptions.chan_scale)",
                   "queue 1 item 7")
    if aux_loss_fn is not None:
        raise todo("auxiliary losses (aux_loss_fn)", "queue 1 item 10")
    if cfg.microbatches > 1:
        raise todo("microbatched gradients (TrainConfig.microbatches)",
                   "queue 1 item 10")


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
):
    """Build ``train_step(state, batch, scale=None) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` is one agent's local empirical
    loss, written for ONE agent's batch; the step vmaps it over the
    leading agent axis (size ``cfg.num_agents``) of every batch leaf.
    ``policy`` is a :class:`CommPolicy`, a spec string or a per-agent
    sequence of either; omitted, it resolves from ``cfg.comm``.
    A trigger's ``kernel=true`` option routes its reductions through the
    ``gain_reduce`` kernel.  ``oracle`` is the ``(Σ, w*)`` pair the
    ``gain_exact`` trigger requires.

    The step runs on ``device``: its state and batch must live there.
    Metrics are 0-dim (and, with ``agent_metrics``, ``(A,)``) tensors on
    that device; nothing is copied to the host inside the step.
    """
    dev = resolve_device(device)
    opts = options or StepOptions()
    _check_options(opts, cfg, aux_loss_fn)
    agent_metrics = opts.agent_metrics
    resolved = normalize_policy(resolve_policy(cfg, policy), cfg.num_agents)
    hetero: Optional[Tuple[CommPolicy, ...]] = (
        resolved if isinstance(resolved, tuple) else None
    )
    prologue = batch_prologue(loss_fn)

    if hetero is None:
        if resolved.needs_net:
            raise todo("lossy '@ channel' wires", "queue 1 item 7")
        trigger = resolved.build_trigger(loss_fn=loss_fn, probe_eps=cfg.lr,
                                         oracle=oracle)
        chain = resolved.chain()
        needs_ef = resolved.needs_ef
        needs_ctrl = resolved.is_adaptive
        chains = (chain,)
    else:
        if opts.hetero_dispatch != "hybrid":
            raise todo(f"hetero_dispatch={opts.hetero_dispatch!r}",
                       _DISPATCH_ITEM)
        bank = build_stage_bank(hetero, loss_fn=loss_fn, probe_eps=cfg.lr,
                                oracle=oracle)
        needs_ef = bank.needs_ef
        needs_ctrl = bank.needs_ctrl
        chains = bank.agent_chains()
        prologue_fns, _ = bank.prologues()
        batch_free = bank.epilogue_batch_free
        block_rows, inv_order = bank.policy_blocks()
        blocks = tuple(_block_index(r, dev) for r in block_rows)
        in_order = inv_order == tuple(range(len(inv_order)))
        inv_ix = None if in_order else torch.tensor(
            inv_order, dtype=torch.long, device=dev)
        branches = {(has_mem, has_ctrl): bank.epilogues(has_mem, has_ctrl)
                    for has_mem in (False, True)
                    for has_ctrl in (False, True)}

    def merge(parts):
        """Concatenate per-block results and restore agent order."""
        if parts[0] is None:
            return None
        if isinstance(parts[0], dict):
            return {k: merge([p[k] for p in parts]) for k in parts[0]}
        out = torch.cat(parts)
        return out if inv_ix is None else out[inv_ix]

    def check_device(state: TrainState):
        for leaf in tree_leaves(state.params):
            if leaf.device != dev:
                raise ValueError(
                    f"train step built for {dev} got params on "
                    f"{leaf.device}; move the state with "
                    f"init_train_state(..., device=...) or "
                    f"repro_torch.convert"
                )

    def train_step(state: TrainState, batch, scale=None):
        check_device(state)
        if scale is None:
            scale = opts.scale
        params, step = state.params, state.step
        use_ef = needs_ef and state.ef_memory is not None
        if needs_ef and not use_ef:
            _warn_ef_memory_missing()
        use_ctrl = needs_ctrl and state.ctrl_state is not None
        if needs_ctrl and not use_ctrl:
            _warn_ctrl_state_missing()
        losses, grads = prologue(params, batch)
        new_ctrl = state.ctrl_state
        if hetero is None:
            if needs_ctrl:
                ctrl_rows = (state.ctrl_state if use_ctrl else
                             trigger.ctrl0.to(dev).expand(losses.shape[0], -1))
                (alphas, gains), ctrl_rows = trigger(
                    params, grads, batch, losses, step, ctrl_rows, scale)
                if use_ctrl:
                    new_ctrl = ctrl_rows
            else:
                alphas, gains = trigger(params, grads, batch, losses, step,
                                        scale)
            if chain:
                g_eff = ef_add(grads, state.ef_memory if use_ef else None)
                sent = chain.compress_tree(g_eff)
                new_ef = (ef_residual(g_eff, sent, alphas) if use_ef
                          else state.ef_memory)
            else:
                sent, new_ef = grads, state.ef_memory
        else:
            # phase 1: every distinct gain precursor, once for all agents
            pres = torch.stack(
                [fn(params, grads, batch, losses).float()
                 for fn in prologue_fns], 1) if prologue_fns else None
            mem = state.ef_memory if use_ef else None
            ctrl = state.ctrl_state if use_ctrl else None
            # phase 2: each distinct policy's epilogue on its own block
            outs = [
                epi(params, _take(grads, rows),
                    None if batch_free else _take(batch, rows),
                    losses[rows], step, _take(mem, rows), _take(ctrl, rows),
                    scale, None if pres is None else pres[rows])
                for rows, epi in zip(blocks, branches[use_ef, use_ctrl])
            ]
            alphas, gains, sent, new_mem, ctrl_rows = (
                merge([o[k] for o in outs]) for k in range(5))
            new_ef = new_mem if use_ef else state.ef_memory
            if use_ctrl:
                new_ctrl = ctrl_rows

        agg = masked_mean(sent, alphas)
        updates, opt_state = optimizer.update(agg, state.opt_state, params,
                                              step)
        new_params = tree_add_scaled(params, updates, 1.0)
        # wire ratios against the gradients' native dtype width
        db = dense_bits(sent)
        sb = structural_bytes(sent, per_agent=True)
        de = dense_entries(sent, per_agent=True)
        ratios = tuple(
            c.ratio_for(db, entries=de) if c else 1.0 for c in chains
        )
        stats = comm_stats(alphas, gains, structural=sb, ratios=ratios)
        metrics = {
            "loss": fold_sum(losses) / losses.shape[0],
            "comm_rate": stats.comm_rate,
            "any_tx": stats.any_tx,
            "num_tx": stats.num_tx,
            "mean_gain": stats.mean_gain,
            "grad_norm": torch.sqrt(sum(
                (x.float() * x.float()).sum() for x in tree_leaves(agg)
            )),
            "wire_bytes": stats.wire_bytes,
        }
        if agent_metrics:
            metrics["agent_tx"] = alphas
            metrics["agent_bytes"] = per_agent_wire_bytes(
                alphas, structural=sb, ratios=ratios)
            if needs_ctrl and new_ctrl is not None:
                # the controllers' per-agent thresholds
                metrics["agent_lam"] = new_ctrl[..., 0]
        return (
            TrainState(step + 1, new_params, opt_state, new_ef,
                       new_ctrl, state.net_state),
            metrics,
        )

    return train_step


__getattr__ = not_ported(__name__, {
    "HybridMachinery": "queue 1 item 11",
    "build_hybrid_machinery": "queue 1 item 11",
    "make_plain_train_step": _DISPATCH_ITEM,
})
