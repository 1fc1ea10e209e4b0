"""CommStats — unified communication accounting for one training round.

The port of ``repro.comm.stats``: the same wire-byte model,

    effective bytes = structural bytes × compression ratio × comm rate,

with *structural bytes* one agent's dense gradient bytes (a Python int,
known from shapes alone), the *ratio* from the policy's compressor chain
against the gradients' native dtype width, and the *comm rate* the
trigger's per-round transmit fraction.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

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


def comm_stats(alphas: torch.Tensor, gains: torch.Tensor, *,
               structural: int, ratios: Sequence[float]) -> CommStats:
    """Assemble the round record from per-agent ``(A,)`` decisions and
    gains; ``ratios`` is one wire ratio per agent (or one for all).

    The three per-agent sums come from ONE fold over the stacked
    ``(A, 3)`` columns — per column the same adds as three folds."""
    ratios = tuple(float(r) for r in ratios)
    if len(ratios) == 1:
        priced = alphas
    else:
        priced = alphas * torch.tensor(ratios, dtype=torch.float32,
                                       device=alphas.device)
    num_tx, gain_sum, priced_sum = fold_sum(
        torch.stack([alphas, gains, priced], 1)).unbind()
    scale = structural * ratios[0] if len(ratios) == 1 else structural
    a = alphas.shape[0]
    return CommStats(
        comm_rate=num_tx / a,
        any_tx=alphas.max(),
        num_tx=num_tx,
        mean_gain=gain_sum / a,
        wire_bytes=(scale * priced_sum).float(),
    )
