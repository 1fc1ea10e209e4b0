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

    epilogue(params, grads, batch, losses, step, ef_mem,
             ctrl=None, scale=None, pre=None)
        -> (alpha, gain, sent, new_ef_mem, new_ctrl)

where every per-agent operand carries the leading axis of the block of
agents that hold the policy (:meth:`StageBank.policy_blocks`), and
``pre`` is that block's ``(B, P)`` precursor matrix.

This slice serves ideal wires only: a bank policy naming any other
``@ channel`` raises when the bank is built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.comm.compressors import CompressorChain
from repro_torch.comm.error_feedback import ef_add, ef_residual
from repro_torch.comm.policy import CommPolicy
from repro_torch.comm.triggers import TriggerFn
from repro_torch.utils.todo import todo
from repro_torch.utils.tree import tree_map

AgentEpilogue = Callable[..., tuple]


def batch_prologue(loss_fn: Callable) -> Callable:
    """Phase 1 of the hybrid dispatch: the per-agent gradient of
    ``loss_fn(params, agent_batch) -> scalar``, batched over agents.

    Returns ``prologue(params, batch) -> (losses (A,), grads)`` — the
    user loss under ``torch.func.vmap`` of ``torch.func.grad_and_value``
    (the JAX package's ``vmap(value_and_grad)``), with ``params`` shared
    and every ``batch`` leaf split on its leading agent axis.
    """
    grad_fn = torch.func.grad_and_value(loss_fn)
    batched = torch.func.vmap(grad_fn, in_dims=(None, 0))

    def prologue(params, batch):
        grads, losses = batched(params, batch)
        return losses, grads

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

    @property
    def needs_ef(self) -> bool:
        return any(self.ef_flags)

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

    def policy_blocks(self) -> Tuple[Tuple[Tuple[int, ...], ...],
                                     Tuple[int, ...]]:
        """Static sort-by-policy layout for the blocked epilogue dispatch.

        Returns ``(block_rows, inv)``: ``block_rows[p]`` are branch
        ``p``'s agent indices (agent order within the block), and
        ``inv[i]`` is agent ``i``'s position in the concatenation of the
        blocks, so ``cat(outs)[inv]`` restores agent order.
        """
        rows: list = [[] for _ in self.policies]
        for i, p in enumerate(self.agent_index):
            rows[p].append(i)
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

    def epilogues(self, has_ef_memory: bool) -> Tuple[AgentEpilogue, ...]:
        """The comm-epilogue branch per bank policy.  With
        ``has_ef_memory=False`` EF is off for every branch and all of
        them return ``None`` memory."""
        _, pre_index = self.prologues()
        return tuple(
            _make_epilogue(trig, chain, use_ef=ef and has_ef_memory,
                           pre_index=pidx)
            for trig, chain, ef, pidx in zip(
                self.triggers, self.chains, self.ef_flags, pre_index
            )
        )


def _make_epilogue(trig: TriggerFn, chain: CompressorChain, *,
                   use_ef: bool, pre_index: int = -1) -> AgentEpilogue:
    def epilogue(params, grads, batch, losses, step, ef_mem, ctrl=None,
                 scale=None, pre=None):
        # the branch selects its own column of the (B, P) precursors
        kw = {"pre": pre[:, pre_index]} if (
            pre is not None and pre_index >= 0
        ) else {}
        alpha, gain = trig(params, grads, batch, losses, step, scale, **kw)
        g_eff = ef_add(grads, ef_mem if use_ef else None)
        sent = chain.compress_tree(g_eff) if chain else g_eff
        if ef_mem is None:
            new_mem = None
        elif use_ef:
            new_mem = ef_residual(g_eff, sent, alpha)
        else:
            # silent bank members never leak stale memory
            new_mem = tree_map(torch.zeros_like, ef_mem)
        return alpha, gain, sent, new_mem, ctrl

    return epilogue


def build_stage_bank(
    policies: Sequence[CommPolicy],
    *,
    loss_fn: Optional[Callable] = None,
    probe_eps: float = 1e-2,
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
    if any(p.needs_net for p in bank):
        raise todo("lossy '@ channel' wires", "queue 1 item 7")
    return StageBank(
        policies=tuple(bank),
        agent_index=tuple(index),
        triggers=tuple(
            p.build_trigger(loss_fn=loss_fn, probe_eps=probe_eps)
            for p in bank
        ),
        chains=tuple(p.chain() for p in bank),
        ef_flags=tuple(p.needs_ef for p in bank),
    )
