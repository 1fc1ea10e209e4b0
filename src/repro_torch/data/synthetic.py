"""Synthetic LM token streams (port of ``repro.data.synthetic``).

The stream has learnable structure: a fixed random bigram Markov chain
over the vocabulary, whose transition logits are Gumbel draws.  The
distribution is the JAX package's; the draws come from a
``torch.Generator`` and so differ from JAX's threefry draws (ROADMAP
queue 1 item 2): tests that need the JAX package's tokens pass them in.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils.todo import not_ported


def _gumbel(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, −log(−log(u)) for u uniform on [tiny, 1),
    as ``jax.random.gumbel`` forms them (in place: the bigram table of a
    49152-token vocabulary is 9.7 GB)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    tiny = torch.finfo(torch.float32).tiny
    return u.clamp_(min=tiny).log_().neg_().log_().neg_()


def markov_logits(vocab: int, gen: torch.Generator,
                  temperature: float = 1.0) -> torch.Tensor:
    """A fixed random bigram transition table (vocab, vocab) of logits."""
    return _gumbel((vocab, vocab), gen).div_(temperature)


def sample_lm_tokens(gen: torch.Generator, batch: int, seq_len: int,
                     vocab: int,
                     table_gen: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """(batch, seq_len) int32 tokens from a fixed bigram chain, on
    ``gen``'s device.  The table comes from ``table_gen`` (by default a
    generator seeded with 7, as the JAX package's table key)."""
    if table_gen is None:
        table_gen = torch.Generator(device=gen.device).manual_seed(7)
    logits = markov_logits(vocab, table_gen)
    tok = torch.randint(0, vocab, (batch,), generator=gen, device=gen.device)
    out = [tok]
    for _ in range(seq_len - 1):
        # a categorical draw from each row: argmax of logits + Gumbel noise
        tok = torch.argmax(logits[tok] + _gumbel((batch, vocab), gen), -1)
        out.append(tok)
    return torch.stack(out, 1).to(torch.int32)


__getattr__ = not_ported(__name__, {
    "lm_batch": "queue 1 item 10",
    "batch_iterator": "queue 1 item 10",
    "drifting_problem": "queue 1 item 3",
    "drifting_batch_fn": "queue 1 item 3",
})
