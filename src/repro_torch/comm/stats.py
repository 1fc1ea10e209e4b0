"""CommStats — unified communication accounting for one training round.

The port of ``repro.comm.stats``: the same wire-byte model,

    effective bytes = structural bytes × compression ratio × comm rate,

with *structural bytes* one agent's dense gradient bytes (a Python int,
known from shapes alone), the *ratio* from the policy's compressor chain
against the gradients' native dtype width, and the *comm rate* the
trigger's per-round transmit fraction.

Under a lossy channel the bytes split in two: the ATTEMPTED bytes price
the decisions (what agents put on the wire), the DELIVERED bytes what
arrived (on a delay line, the matured payloads at their application
weights) — the bytes the budget controllers answer for and the
``CommRollup`` counts as ``wire_bytes``.  Under churn every mean and
rate divides by the ACTIVE agents.  :func:`round_metrics` assembles a
round's scalar record with both splits from ONE left fold over the
stacked per-agent columns.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from repro_torch.utils.tree import tree_leaves


class CommStats(NamedTuple):
    """Per-round communication record (f32 0-dim tensors)."""

    comm_rate: torch.Tensor   # mean_i alpha_i            (per-round rate)
    any_tx: torch.Tensor      # max_i alpha_i             (Thm 2's counter)
    num_tx: torch.Tensor      # sum_i alpha_i
    mean_gain: torch.Tensor   # mean of per-agent estimated gains
    wire_bytes: torch.Tensor  # effective bytes on the wire this round


def structural_bytes(grads, *, per_agent: bool = True) -> int:
    """Dense bytes of a gradient dict; with ``per_agent=True`` the
    leading agent axis is excluded (ONE agent's dense payload)."""
    total = 0
    for leaf in tree_leaves(grads):
        n = leaf.numel()
        if per_agent:
            n //= leaf.shape[0]
        total += int(n) * leaf.element_size()
    return total


def dense_entries(grads, *, per_agent: bool = True) -> int:
    """Dense entry count of a gradient dict (agent axis excluded with
    ``per_agent=True``) — what a fixed-payload wire is priced against."""
    total = 0
    for leaf in tree_leaves(grads):
        n = leaf.numel()
        if per_agent:
            n //= leaf.shape[0]
        total += int(n)
    return total


def dense_bits(grads) -> float:
    """Size-weighted native bits per gradient entry (32 for fp32)."""
    leaves = tree_leaves(grads)
    entries = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    return 8.0 * nbytes / max(entries, 1)


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-fold sum over the leading axis: ``((x0 + x1) + x2) + …``.

    The association is fixed (the JAX package's summary metrics are
    folded the same way), so both packages add the same terms in the
    same order.  Trailing axes fold independently, which lets one fold
    over a stacked ``(A, k)`` tensor serve k per-agent vectors.
    """
    total = x[0]
    for i in range(1, int(x.shape[0])):
        total = total + x[i]
    return total


def per_agent_wire_bytes(alphas: torch.Tensor, *, structural: int,
                         ratios: Sequence[float]) -> torch.Tensor:
    """``(A,)`` effective bytes per agent: ``structural × ratio_i ×
    alpha_i`` (a single-element ``ratios`` broadcasts)."""
    r = torch.tensor(tuple(float(x) for x in ratios), dtype=torch.float32,
                     device=alphas.device)
    return (structural * r * alphas).float()


def _ratio_tensor(ratios: Sequence[float], like: torch.Tensor):
    """The per-agent ratios as a device vector (None when one ratio
    prices every agent)."""
    if len(ratios) == 1:
        return None
    return torch.tensor(tuple(ratios), dtype=torch.float32,
                        device=like.device)


def _wire_scale(structural: int, ratios: Sequence[float]) -> float:
    """What multiplies the folded priced column: ``structural × ratio``
    for one ratio, ``structural`` when the ratios ride in the column."""
    return structural * ratios[0] if len(ratios) == 1 else structural


def round_metrics(losses: torch.Tensor, alphas: torch.Tensor,
                  gains: torch.Tensor, *, structural: int,
                  ratios: Sequence[float],
                  delivered: Optional[torch.Tensor] = None,
                  staleness: Optional[torch.Tensor] = None,
                  active: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """A round's scalar metrics from its ``(A,)`` per-agent vectors.

    Always: ``loss``, ``comm_rate``, ``any_tx``, ``num_tx``,
    ``mean_gain``, ``wire_bytes``.  With ``delivered`` (a channel's
    delivery vector): ``wire_bytes`` becomes the DELIVERED bytes, and
    ``wire_bytes_attempted``, ``num_delivered``, ``delivered_rate`` and
    ``mean_staleness`` (of ``staleness``) join.  With ``active`` (the
    churn mask, by which ``alphas``, ``gains`` and ``delivered`` are
    already multiplied): every mean divides by the active count, and
    ``num_active`` joins.  Each column is folded left to right, the
    same adds as a fold of its own."""
    ratios = tuple(float(r) for r in ratios)
    r = _ratio_tensor(ratios, alphas)
    priced = (lambda v: v) if r is None else (lambda v: v * r)
    cols = {"loss": losses, "tx": alphas, "gain": gains,
            "priced": priced(alphas)}
    if delivered is not None:
        cols.update(dl=delivered, dpriced=priced(delivered),
                    stale=staleness)
    if active is not None:
        cols.update(act=active, loss_act=losses * active)
        if delivered is not None:
            cols["stale_act"] = staleness * active
    sums = dict(zip(cols, fold_sum(torch.stack(list(cols.values()),
                                               1)).unbind()))
    a = alphas.shape[0]
    scale = _wire_scale(structural, ratios)
    out = {
        "loss": sums["loss"] / a,
        "comm_rate": sums["tx"] / a,
        "any_tx": alphas.max(),
        "num_tx": sums["tx"],
        "mean_gain": sums["gain"] / a,
        "wire_bytes": (scale * sums["priced"]).float(),
    }
    n_act = None
    if active is not None:
        n_act = torch.clamp(sums["act"], min=1.0)
        out.update(loss=sums["loss_act"] / n_act,
                   comm_rate=sums["tx"] / n_act,
                   mean_gain=sums["gain"] / n_act,
                   num_active=sums["act"])
    if delivered is not None:
        out["wire_bytes_attempted"] = out["wire_bytes"]
        out["wire_bytes"] = (scale * sums["dpriced"]).float()
        out["num_delivered"] = sums["dl"]
        if n_act is None:
            out["delivered_rate"] = sums["dl"] / a
            out["mean_staleness"] = sums["stale"] / a
        else:
            out["delivered_rate"] = sums["dl"] / n_act
            out["mean_staleness"] = sums["stale_act"] / n_act
    return out


def comm_stats(alphas: torch.Tensor, gains: torch.Tensor, *,
               structural: int, ratios: Sequence[float]) -> CommStats:
    """Assemble the round record from per-agent ``(A,)`` decisions and
    gains; ``ratios`` is one wire ratio per agent (or one for all).

    The three per-agent sums come from ONE fold over the stacked
    ``(A, 3)`` columns — per column the same adds as three folds."""
    ratios = tuple(float(r) for r in ratios)
    r = _ratio_tensor(ratios, alphas)
    priced = alphas if r is None else alphas * r
    num_tx, gain_sum, priced_sum = fold_sum(
        torch.stack([alphas, gains, priced], 1)).unbind()
    scale = _wire_scale(structural, ratios)
    a = alphas.shape[0]
    return CommStats(
        comm_rate=num_tx / a,
        any_tx=alphas.max(),
        num_tx=num_tx,
        mean_gain=gain_sum / a,
        wire_bytes=(scale * priced_sum).float(),
    )
