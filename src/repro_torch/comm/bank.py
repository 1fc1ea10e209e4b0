"""Stage banks — per-agent heterogeneous policies as a two-phase program.

The port of ``repro.comm.bank``.  A :class:`StageBank` dedupes the
per-agent policies of a heterogeneous network and splits each agent's
round into the two phases the hybrid dispatch runs separately:

**Phase 1 — the shared gradient prologue.**  The per-agent
``value_and_grad`` of the local loss, batched over the agent axis
(:func:`batch_prologue`), plus the bank's deduped trigger gain
precursors (:meth:`StageBank.prologues`), each evaluated ONCE for all
agents ("union-computed").

**Phase 2 — the comm epilogue.**  Everything that differs between
policies — trigger gate, error-feedback fold-in, compressor chain,
residual update — is built per DISTINCT policy by
:meth:`StageBank.epilogues` with one signature::

    epilogue(params, grads, batch, losses, step, ef_mem, ctrl=None,
             scale=None, pre=None, net=None, chan_scale=None, keys=None)
        -> (alpha, gain, sent, new_ef_mem, new_ctrl)
         | (alpha, gain, sent, new_ef_mem, new_ctrl, delivered, new_net)

where every per-agent operand carries the leading axis of the block of
agents that hold the policy (:meth:`StageBank.policy_blocks`), and
``pre`` is that block's ``(B, P)`` precursor matrix.  ``ctrl`` is the
block's ``(B, CTRL_WIDTH)`` controller rows, or ``None`` when the state
carries no controller slot: an adaptive branch then gates open-loop at
its ``lam0`` and returns ``None``; a plain branch passes its rows
through untouched.

When the state carries a channel slot, ``net`` is the block's rows (or
``(rows, line)`` pair), ``keys`` the block's rows of the round's keys
per channel seed (``{seed: (B, 2)}``, derived once for all agents; a
branch derives its own when absent), and every branch returns the
7-tuple: the
channel draw comes first (independent of this round's decision), then
the staleness escalation of the trigger knob, the gate, the compressor
and EF (a dropped payload folds back whole), and ``delivered`` is
``alpha × d`` — or, on a delay line, the matured payload's application
weight, with ``sent`` the matured payload.  A branch with no channel
(or ``@ ideal``) delivers what it decides and passes its slot through.

The ``switch`` dispatch runs the same branches agent by agent instead:
each agent's gradient from its own unbatched prologue
(:func:`agent_prologue`), then its bank branch on a block of one agent,
with no precursor (the trigger recomputes it) and no keys (the branch
derives its agent's own).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.comm.compressors import CompressorChain
from repro_torch.comm.error_feedback import ef_add, ef_residual
from repro_torch.comm.policy import CommPolicy
from repro_torch.comm.triggers import TriggerFn
from repro_torch.net import channels as net_lib
from repro_torch.sharding.constraint import constrain_params
from repro_torch.utils.tree import tree_map

# the uniform comm-epilogue signature; "AgentStage" is the JAX package's
# pre-hybrid name for it, kept as an alias
AgentEpilogue = Callable[..., tuple]
AgentStage = AgentEpilogue


def _grad_fn(loss_fn: Callable, aux_loss_fn: Optional[Callable]):
    """``(params, batch) -> (grads, loss)``: the gradient of the
    objective ``loss_fn + aux_loss_fn`` (of ``loss_fn`` alone without an
    aux) and the value of ``loss_fn``, as the JAX package's
    ``objective``: the aux term shapes the update, never the reported
    loss or the trigger's gain."""
    if aux_loss_fn is None:
        grad_fn = torch.func.grad_and_value(loss_fn)

        def grads_and_main(params, batch):
            grads, main = grad_fn(params, batch)
            # the JAX package pins each agent's gradient to the data-free
            # layout here (repro.core.api): on a mesh rank, its model
            # blocks (a no-op without a mesh hook)
            return constrain_params(grads, ""), main

        return grads_and_main

    def objective(params, batch):
        main = loss_fn(params, batch)
        return main + aux_loss_fn(params, batch), main

    grad_fn = torch.func.grad_and_value(objective, has_aux=True)

    def grads_and_main(params, batch):
        grads, (_, main) = grad_fn(params, batch)
        return constrain_params(grads, ""), main

    return grads_and_main


def batch_prologue(loss_fn: Callable,
                   aux_loss_fn: Optional[Callable] = None) -> Callable:
    """Phase 1 of the hybrid dispatch: the per-agent gradient of
    ``loss_fn(params, agent_batch) -> scalar`` (plus ``aux_loss_fn``'s,
    when given), batched over agents.

    Returns ``prologue(params, batch) -> (losses (A,), grads)`` — the
    user loss under ``torch.func.vmap`` of ``torch.func.grad_and_value``
    (the JAX package's ``vmap(value_and_grad)``), with ``params`` shared
    and every ``batch`` leaf split on its leading agent axis.
    """
    batched = torch.func.vmap(_grad_fn(loss_fn, aux_loss_fn),
                              in_dims=(None, 0))

    def prologue(params, batch):
        grads, losses = batched(params, batch)
        return losses, grads

    return prologue


def agent_prologue(loss_fn: Callable,
                   aux_loss_fn: Optional[Callable] = None) -> Callable:
    """The per-agent gradient of the ``switch``/``unroll`` dispatch
    loops: ``loss_fn``'s ``torch.func.grad_and_value`` on ONE agent's
    batch, unbatched (the JAX package's per-agent ``value_and_grad``).

    Returns ``prologue(params, agent_batch) -> (loss (1,), grads)``:
    ``agent_batch`` leaves carry a leading axis of one agent, and so do
    the loss and every gradient leaf, so the result is a one-agent block
    for the agent-batched stages."""
    grad_fn = _grad_fn(loss_fn, aux_loss_fn)

    def prologue(params, agent_batch):
        grads, loss = grad_fn(params, tree_map(lambda v: v[0], agent_batch))
        return loss.unsqueeze(0), tree_map(lambda v: v.unsqueeze(0), grads)

    return prologue


@dataclass(frozen=True)
class StageBank:
    """Deduped per-agent policies plus their built stages.

    ``policies`` is the bank (first-seen order); ``agent_index[i]`` maps
    agent ``i`` to its bank entry.
    """

    policies: Tuple[CommPolicy, ...]
    agent_index: Tuple[int, ...]
    triggers: Tuple[TriggerFn, ...]
    chains: Tuple[CompressorChain, ...]
    ef_flags: Tuple[bool, ...]
    adaptive_flags: Tuple[bool, ...] = ()
    # per-branch built ChannelModel; None for channel-free branches and
    # trivial (@ ideal) channels, which run identically
    channels: Tuple[Optional[net_lib.ChannelModel], ...] = ()

    @property
    def needs_ef(self) -> bool:
        return any(self.ef_flags)

    @property
    def needs_ctrl(self) -> bool:
        """Any bank policy carrying closed-loop controller state?"""
        return any(self.adaptive_flags)

    @property
    def needs_net(self) -> bool:
        """Any bank policy carrying a non-trivial lossy channel?"""
        return any(c is not None for c in self.channels)

    @property
    def key_seeds(self) -> Tuple[int, ...]:
        """The distinct seeds of the bank's channels that draw from
        keys: one key derivation per seed serves every branch."""
        return tuple(sorted({c.seed for c in self.channels
                             if c is not None and c.keyed}))

    @property
    def net_depth(self) -> int:
        """The deepest payload buffer across the bank's channels (0: no
        delay or retransmit channel, the slot is the bare rows)."""
        return max((c.depth for c in self.channels if c is not None),
                   default=0)

    def agent_chains(self) -> Tuple[CompressorChain, ...]:
        """Per-AGENT compressor chains (for wire-byte accounting)."""
        return tuple(self.chains[i] for i in self.agent_index)

    @property
    def epilogue_batch_free(self) -> bool:
        """Can the epilogues run WITHOUT the per-agent batch?  True when
        every trigger's batch use lives in a prologue (or it uses none)."""
        return all(
            getattr(t, "prologue_key", None) is not None
            or getattr(t, "uses_batch", True) is False
            for t in self.triggers
        )

    def policy_blocks(self, agents: Optional[Sequence[int]] = None
                      ) -> Tuple[Tuple[Tuple[int, ...], ...],
                                 Tuple[int, ...]]:
        """Static sort-by-policy layout for the blocked epilogue dispatch.

        Returns ``(block_rows, inv)``: ``block_rows[p]`` are branch
        ``p``'s rows (agent order within the block), and ``inv[i]`` is
        row ``i``'s position in the concatenation of the blocks, so
        ``cat(outs)[inv]`` restores row order.  The rows are the agents,
        or, with ``agents`` (a gateway's slice of global agent indices),
        positions in ``agents``; a policy none of them holds has an
        empty block.
        """
        agents = range(len(self.agent_index)) if agents is None else agents
        rows: list = [[] for _ in self.policies]
        for i, a in enumerate(agents):
            rows[self.agent_index[a]].append(i)
        perm = [i for r in rows for i in r]
        inv = [0] * len(perm)
        for pos, i in enumerate(perm):
            inv[i] = pos
        return tuple(tuple(r) for r in rows), tuple(inv)

    def prologues(self) -> Tuple[Tuple[Callable, ...], Tuple[int, ...]]:
        """The bank's deduped trigger prologues (phase-1 gain precursors).

        Returns ``(fns, index)``: the DISTINCT precursor computations
        (deduped by ``trig.prologue_key``) and, per bank branch, its
        entry in ``fns`` (``-1`` for triggers with no precursor).
        """
        keys: list = []
        fns: list = []
        index: list = []
        for trig in self.triggers:
            key = getattr(trig, "prologue_key", None)
            if key is None:
                index.append(-1)
                continue
            if key not in keys:
                keys.append(key)
                fns.append(trig.prologue)
            index.append(keys.index(key))
        return tuple(fns), tuple(index)

    def epilogues(self, has_ef_memory: bool, has_ctrl_state: bool = False,
                  has_net_state: bool = False) -> Tuple[AgentEpilogue, ...]:
        """The comm-epilogue branch per bank policy.  With
        ``has_ef_memory=False`` EF is off for every branch and all of
        them return ``None`` memory; with ``has_ctrl_state=False`` the
        controllers run open-loop and every branch returns ``None``
        rows; with ``has_net_state=True`` every branch returns the
        7-tuple, otherwise the classic 5-tuple."""
        adaptive = self.adaptive_flags or (False,) * len(self.triggers)
        channels = self.channels or (None,) * len(self.triggers)
        _, pre_index = self.prologues()
        return tuple(
            _make_epilogue(trig, chain, use_ef=ef and has_ef_memory,
                           adaptive=ad, use_ctrl=has_ctrl_state,
                           pre_index=pidx, channel=chan,
                           use_net=has_net_state)
            for trig, chain, ef, ad, pidx, chan in zip(
                self.triggers, self.chains, self.ef_flags, adaptive,
                pre_index, channels
            )
        )


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def _make_epilogue(trig: TriggerFn, chain: CompressorChain, *,
                   use_ef: bool, adaptive: bool = False,
                   use_ctrl: bool = False, pre_index: int = -1,
                   channel=None, use_net: bool = False) -> AgentEpilogue:
    def epilogue(params, grads, batch, losses, step, ef_mem, ctrl=None,
                 scale=None, pre=None, net=None, chan_scale=None, keys=None):
        # the branch selects its own column of the (B, P) precursors
        kw = {"pre": pre[:, pre_index]} if (
            pre is not None and pre_index >= 0
        ) else {}
        # the channel draw comes FIRST (independent of this round's
        # alpha), so the controllers can price delivered transmissions;
        # retx shares the payload slot with delay, retx_k tells them apart
        use_chan = use_net and channel is not None and net is not None
        use_retx = use_chan and channel.retx_k > 0
        use_delay = use_chan and channel.depth > 0 and not use_retx
        # the block's rows of the round's keys, when derived for all
        # agents at once ({seed: (B, 2)})
        key = None if keys is None or not use_chan else keys.get(channel.seed)
        if use_retx:
            d, stale, pending, commit = net_lib.retx_round(
                channel, net, step, chan_scale,
                net_lib.tx_cost(grads, chain), key)
        elif use_delay:
            d, stale, commit = net_lib.delay_round(channel, net, step,
                                                   chan_scale, key)
        elif use_chan:
            d, stale, finalize = net_lib.channel_round(
                channel, net_lib.net_rows(net), step, chan_scale,
                net_lib.tx_cost(grads, chain), key)
        if use_chan:
            scale = net_lib.stale_scale(scale, channel.boost, stale,
                                        adaptive)
            if adaptive:
                kw["delivered"] = d
        if adaptive:
            # the controller reads its rows (or, with no slot, its static
            # initial row: open-loop lam0 gating) and emits new rows only
            # when there is a slot to carry them
            rows = ctrl if use_ctrl else trig.ctrl0.to(
                losses.device).expand(losses.shape[0], -1)
            (alpha, gain), new_rows = trig(params, grads, batch, losses,
                                           step, rows, scale, **kw)
            new_ctrl = new_rows if use_ctrl else None
        else:
            alpha, gain = trig(params, grads, batch, losses, step, scale,
                               **kw)
            new_ctrl = ctrl  # pass the (unused) rows through unchanged
        g_eff = ef_add(grads, ef_mem if use_ef else None)
        sent = chain.compress_tree(g_eff) if chain else g_eff
        if use_retx:
            # alpha becomes the realized wire ATTEMPT, ``sent`` what the
            # server receives, and the expired buffered payload folds
            # back to EF only on final failure
            attempt, out_sent, delivered, fold, new_net = commit(alpha,
                                                                 sent)
            if ef_mem is None:
                new_mem = None
            elif use_ef:
                # a compression residual only when THIS round's gradient
                # went to the wire; a lost first offer waits in the buffer
                a_cur = alpha * (1.0 - pending)
                new_mem = tree_map(
                    lambda ge, se, f: (ge - se) * _bcast(a_cur, ge) + f,
                    g_eff, sent, fold)
            else:
                new_mem = tree_map(torch.zeros_like, ef_mem)
            return (attempt, gain, out_sent, new_mem, new_ctrl, delivered,
                    new_net)
        if use_delay:
            # enqueue the payload iff alpha × d; ``sent`` becomes the
            # matured head, ``delivered`` its application weight
            out_sent, delivered, new_net = commit(alpha * d, sent)
        elif use_chan:
            delivered = alpha * d
            new_rows = finalize(delivered)
            # in a delay-carrying bank the slot is the (rows, line) pair:
            # pass the (unused) line through
            new_net = ((new_rows, net[1]) if isinstance(net, tuple)
                       else new_rows)
        else:
            delivered, new_net = alpha, net  # lossless: delivery = decision
        if ef_mem is None:
            new_mem = None
        elif use_ef:
            # a dropped or rejected transmission folds its WHOLE payload
            # back (on a delay line d is the accept indicator)
            new_mem = ef_residual(g_eff, sent, alpha,
                                  delivered=d if use_chan else None)
        else:
            # silent bank members never leak stale memory
            new_mem = tree_map(torch.zeros_like, ef_mem)
        if use_delay:
            sent = out_sent
        if use_net:
            return alpha, gain, sent, new_mem, new_ctrl, delivered, new_net
        return alpha, gain, sent, new_mem, new_ctrl

    return epilogue


def build_stage_bank(
    policies: Sequence[CommPolicy],
    *,
    loss_fn: Optional[Callable] = None,
    probe_eps: float = 1e-2,
    oracle: Optional[tuple] = None,
) -> StageBank:
    """Dedupe per-agent policies and build their trigger/chain stages."""
    if not policies:
        raise ValueError("empty policy list")
    bank: list = []
    index: list = []
    seen: dict = {}
    for p in policies:
        if p not in seen:
            seen[p] = len(bank)
            bank.append(p)
        index.append(seen[p])
    return StageBank(
        policies=tuple(bank),
        agent_index=tuple(index),
        triggers=tuple(
            p.build_trigger(loss_fn=loss_fn, probe_eps=probe_eps,
                            oracle=oracle)
            for p in bank
        ),
        chains=tuple(p.chain() for p in bank),
        ef_flags=tuple(p.needs_ef for p in bank),
        adaptive_flags=tuple(p.is_adaptive for p in bank),
        channels=tuple(p.channel_model() if p.needs_net else None
                       for p in bank),
    )
