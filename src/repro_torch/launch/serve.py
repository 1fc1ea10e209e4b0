"""Serving entry point: the decode demo (port of ``repro.launch.serve``).

Prefill a prompt batch, then step the decode loop, one token per request
per step against the KV cache::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

It runs on the card unless ``--device cpu`` is given.  Weights come from
``--seed``, prompts from the synthetic bigram chain (seed 7), both drawn
with ``torch.Generator``s.  Greedy decoding is the default;
``--temperature > 0`` samples.  The fleet endpoint (``--fleet``) is not
ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import synthetic as D
from repro_torch.models import Model, build
from repro_torch.utils.device import resolve_device
from repro_torch.utils.todo import todo


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--fleet", action="store_true",
                    help="the streaming fleet session (not ported yet)")
    return ap.parse_args(argv)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) tokens."""
    return torch.argmax(logits, dim=-1)[:, None]


def sampler(temperature: float, gen: torch.Generator) -> Callable:
    """(B, V) logits -> (B, 1) tokens drawn from softmax(logits / T)."""

    def pick(logits: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    return pick


def prefill_prompt(model: Model, params, prompts: torch.Tensor,
                   cache_len: int, pick: Callable = greedy):
    """Run the prompts; returns (first new tokens (B, 1), prefill logits
    (B, S, V), cache)."""
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  cache_len=cache_len)
    return pick(logits[:, -1]), logits, cache


def decode_tokens(model: Model, params, cache, toks: torch.Tensor,
                  start_pos: int, steps: int, pick: Callable = greedy):
    """``steps`` decode steps from ``toks`` at position ``start_pos``;
    returns (the tokens (B, steps), the last step's logits (B, V))."""
    out, logits = [], None
    for i in range(steps):
        step_logits, cache = model.decode_step(params, cache, toks,
                                               start_pos + i)
        logits = step_logits[:, 0]
        toks = pick(logits)
        out.append(toks)
    return torch.cat(out, dim=1), logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_decode(args) -> int:
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build(cfg)
    params, _ = model.init(torch.Generator(device=device)
                           .manual_seed(args.seed))
    cache_len = args.cache_len or (args.prompt_len + args.gen + 8)
    prompts = D.sample_lm_tokens(
        torch.Generator(device=device).manual_seed(7), args.batch,
        args.prompt_len, cfg.vocab_size)
    pick = greedy
    if args.temperature > 0:
        pick = sampler(args.temperature, torch.Generator(device=device)
                       .manual_seed(args.seed + 1))

    t0 = time.perf_counter()
    toks, _, cache = prefill_prompt(model, params, prompts, cache_len, pick)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest, _ = decode_tokens(model, params, cache, toks, args.prompt_len,
                            args.gen - 1, pick)
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen = torch.cat([toks, rest], dim=1).cpu()
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"batch={args.batch} cache_len={cache_len}")
    print(f"prefill: {args.prompt_len} tokens in {t_prefill:.2f}s")
    print(f"decode:  {args.gen} steps in {t_decode:.2f}s "
          f"({args.batch * args.gen / max(t_decode, 1e-9):.1f} tok/s "
          f"batched)")
    for b in range(min(args.batch, 2)):
        print(f"request {b}: prompt…{prompts[b, -8:].tolist()} "
              f"-> {gen[b].tolist()}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.fleet:
        raise todo("serve.py --fleet (the streaming fleet endpoint)",
                   "queue 1 item 9")
    return serve_decode(args)


if __name__ == "__main__":
    raise SystemExit(main())
