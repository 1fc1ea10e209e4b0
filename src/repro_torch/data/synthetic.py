"""Synthetic LM token streams (port of ``repro.data.synthetic``).

The stream has learnable structure: a fixed random bigram Markov chain
over the vocabulary, whose transition logits are Gumbel draws.  The
distribution is the JAX package's; the draws come from a
``torch.Generator`` and so differ from JAX's threefry draws (ROADMAP
queue 1 item 2): tests that need the JAX package's tokens pass them in.

At a 49152-token vocabulary the bigram table is a 9.7 GB fp32 tensor,
so a stream draws it once (:func:`batch_iterator`) and hands it to every
batch through ``logits=``, where the JAX package draws it anew per call.

The drifting-target regression (:func:`drifting_problem`,
:func:`drifting_batch_fn`) draws its direction as JAX does
(``repro_torch.random.normal``) and its round-indexed batches from
:func:`step_generator`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.whisper_medium import DECODER_LEN
from repro_torch.utils.device import DeviceLike, resolve_device


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


def table_generator(device: DeviceLike) -> torch.Generator:
    """The bigram table's generator: seeded with 7, as the JAX package's
    table key ``PRNGKey(7)``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(7)


def sample_lm_tokens(gen: torch.Generator, batch: int, seq_len: int,
                     vocab: int,
                     table_gen: Optional[torch.Generator] = None, *,
                     logits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(batch, seq_len) int32 tokens from a fixed bigram chain, on
    ``gen``'s device.  The chain's table is ``logits`` when given (a
    :func:`markov_logits` table drawn once per stream), else drawn here
    from ``table_gen`` (by default :func:`table_generator`)."""
    if logits is None:
        if table_gen is None:
            table_gen = table_generator(gen.device)
        logits = markov_logits(vocab, table_gen)
    elif logits.shape != (vocab, vocab):
        raise ValueError(f"bigram table {tuple(logits.shape)} does not "
                         f"match vocab {vocab}")
    tok = torch.randint(0, vocab, (batch,), generator=gen, device=gen.device)
    out = [tok]
    for _ in range(seq_len - 1):
        # a categorical draw from each row: argmax of logits + Gumbel noise
        tok = torch.argmax(logits[tok] + _gumbel((batch, vocab), gen), -1)
        out.append(tok)
    return torch.stack(out, 1).to(torch.int32)


def step_generator(seed: int, step: int, device: DeviceLike) -> torch.Generator:
    """The generator of step (or serving round) ``step`` of a seeded
    stream: seeded from ``(seed, step)`` through numpy's SeedSequence
    (distinct streams for distinct pairs), as the JAX streams fold the
    step into their key."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed((int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))
    return gen


def lm_batch(cfg: ModelConfig, shape: InputShape, gen: torch.Generator,
             num_agents: int = 1, global_batch: Optional[int] = None,
             seq_len: Optional[int] = None, *,
             logits: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """One training batch on ``gen``'s device, leaves shaped
    ``(num_agents, per_agent_batch, ...)``, as the JAX package forms it:
    ``tokens`` and ``labels`` (the tokens shifted by one), int32, of S
    positions; for vlm also ``patch_embeds`` (``num_patches`` stubbed
    vision-tower outputs, 0.02·N(0, 1)); for audio ``frame_embeds`` (S
    stubbed encoder frames, 0.02·N(0, 1)) and decoder ``tokens`` and
    ``labels`` of min(S, ``DECODER_LEN``) positions.  ``logits`` is the
    stream's bigram table."""
    b = global_batch or shape.global_batch
    s = seq_len or shape.seq_len
    if b % num_agents:
        raise ValueError(f"global batch {b} does not split over "
                         f"{num_agents} agents")
    per = b // num_agents
    # audio: the decoder's tokens are the first DECODER_LEN + 1 of the
    # chain the JAX package draws S + 1 long (the same distribution)
    n_tok = min(s, DECODER_LEN) if cfg.is_encoder_decoder else s
    toks = sample_lm_tokens(gen, b, n_tok + 1, cfg.vocab_size, logits=logits)
    batch = {
        "tokens": toks[:, :-1].reshape(num_agents, per, n_tok),
        "labels": toks[:, 1:].reshape(num_agents, per, n_tok),
    }
    if cfg.arch_type == "vlm" and cfg.num_patches:
        batch["patch_embeds"] = 0.02 * torch.randn(
            (num_agents, per, cfg.num_patches, cfg.d_model), generator=gen,
            device=gen.device)
    if cfg.is_encoder_decoder:
        batch = {"frame_embeds": 0.02 * torch.randn(
            (num_agents, per, s, cfg.d_model), generator=gen,
            device=gen.device), **batch}
    return batch


def batch_iterator(cfg: ModelConfig, shape: InputShape, *,
                   num_agents: int = 1, seed: int = 0,
                   global_batch: Optional[int] = None,
                   seq_len: Optional[int] = None,
                   device: DeviceLike = "cuda", start: int = 0
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite deterministic batch stream on ``device``: batch ``k``
    from :func:`step_generator` ``(seed, k)`` for ``k = start, start +
    1, ...`` (a resumed run sees the batches the unbroken one would
    have), every batch from one bigram table drawn when the stream
    starts."""
    logits = markov_logits(cfg.vocab_size, table_generator(device))
    step = start
    while True:
        yield lm_batch(cfg, shape, step_generator(seed, step, device),
                       num_agents=num_agents, global_batch=global_batch,
                       seq_len=seq_len, logits=logits)
        step += 1


# ----------------------------------------------------------------------
# Drifting-target regression (non-stationary rounds)
# ----------------------------------------------------------------------

def _drift_direction(problem, seed: int) -> torch.Tensor:
    """The unit direction ``u`` of the drift: ``normal(PRNGKey(seed))``
    over ``w*``'s shape, as JAX draws it, normalized."""
    u = prng.normal(prng.PRNGKey(seed, device=problem.device),
                    tuple(problem.w_star.shape))
    return u / torch.sqrt(torch.sum(u * u))


def _drifted(problem, u: torch.Tensor, step: int, amp: float, period: int):
    # 2π·k/period in float32, as the JAX package forms the phase
    phase = np.float32(np.float32(2.0 * np.pi) * np.float32(step)) \
        / np.float32(period)
    s = torch.sin(torch.tensor(float(phase), dtype=torch.float32,
                               device=u.device))
    return dataclasses.replace(
        problem, w_star=problem.w_star + float(amp) * s * u)


def drifting_problem(problem, step: int, *, amp: float = 1.0,
                     period: int = 32, seed: int = 0):
    """The paper's regression Problem with a smoothly drifting target.

    ``w*(k) = w* + amp · sin(2πk / period) · u`` for a fixed random unit
    direction ``u`` drawn from ``seed`` (``repro_torch.random.normal``
    under ``PRNGKey(seed)``, as the JAX package draws it): the optimum
    circles its nominal value, so triggers that went quiet at
    convergence must re-open and delayed payloads land on a target that
    has moved.  ``step`` is the round index, a host int."""
    return _drifted(problem, _drift_direction(problem, seed), step, amp,
                    period)


def drifting_batch_fn(problem, *, amp: float = 1.0, period: int = 32,
                      seed: int = 0):
    """A round-indexed ``batch_fn(k)`` over a drifting target, the
    contract of ``FleetSession`` and ``repro_torch.core.frontier``.

    Round ``k`` draws fresh per-agent batches from
    :func:`step_generator` ``(seed + 1, k)``, as the fleet session draws
    its rounds, at round ``k``'s drifted ``w*``; the drift direction is
    drawn once."""
    from repro_torch.core import regression as R

    u = _drift_direction(problem, seed)

    def batch_fn(k: int):
        return R.agent_batches(
            _drifted(problem, u, k, amp, period),
            step_generator(seed + 1, k, problem.device))

    return batch_fn
