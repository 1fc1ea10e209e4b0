"""Serving drivers: the one-shot decode demo and the streaming fleet
endpoint (port of ``repro.launch.serve``).  Both run on the card unless
``--device cpu`` is given.

Decode demo (default) — prefill a prompt batch, then step the decode
loop, one token per request per step against the KV cache::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Weights come from ``--seed``, prompts from the synthetic bigram chain
(seed 7), both drawn with ``torch.Generator``s.  Greedy decoding is the
default; ``--temperature > 0`` samples.

Fleet mode (``--fleet``) — a continuous m=64 tiered training session
(:class:`repro_torch.launch.session.FleetSession`): observation streams
feed the triggered train step round after round while the rollup is
served live as JSON (``/stats.json``) and Prometheus text
(``/metrics``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet \\
        --mix tiered_m64_adaptive --rounds 0 --telemetry-port 9100 \\
        --telemetry-file /tmp/fleet.json --log-every 100

``--rounds 0`` serves until interrupted; ``--telemetry-port 0`` picks
an ephemeral port (printed on startup).  ``--ckpt-dir`` arms crash-safe
checkpointing in the JAX package's format: a killed run relaunched with
the same directory auto-resumes from the latest complete checkpoint
(``--no-resume`` starts fresh).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.data import synthetic as D
from repro_torch.models import Model, build
from repro_torch.utils.device import resolve_device

# the m=64 fleet scenarios --fleet can serve
# (repro_torch.configs.paper_linreg)
FLEET_MIXES = (
    "tiered_m64", "tiered_m64_adaptive", "tiered_m64_edge_heavy",
    "tiered_m64_backbone_heavy", "tiered_m64_one_big",
    "tiered_m64_lossy", "tiered_m64_adaptive_lossy",
)


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(list_archs()))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    fleet = ap.add_argument_group("fleet mode")
    fleet.add_argument("--fleet", action="store_true",
                       help="run the streaming fleet session instead of "
                            "the decode demo")
    fleet.add_argument("--mix", default="tiered_m64_adaptive",
                       choices=FLEET_MIXES,
                       help="which m=64 tier mix to serve")
    fleet.add_argument("--rounds", type=int, default=0,
                       help="rounds to serve (0 = until interrupted)")
    fleet.add_argument("--lam-base", type=float, default=1.0)
    fleet.add_argument("--telemetry-port", type=int, default=None,
                       help="serve /stats.json + /metrics on this port "
                            "(0 = ephemeral)")
    fleet.add_argument("--telemetry-file", default=None,
                       help="write rollup JSON snapshots to this path")
    fleet.add_argument("--log-every", type=int, default=100,
                       help="rounds between stdout/file telemetry flushes")
    fleet.add_argument("--ckpt-dir", default=None,
                       help="crash-safe session checkpoints under this "
                            "directory (enables auto-resume on relaunch)")
    fleet.add_argument("--ckpt-every", type=int, default=50,
                       help="rounds between session checkpoints")
    fleet.add_argument("--no-resume", action="store_true",
                       help="ignore existing checkpoints in --ckpt-dir "
                            "and start fresh")
    fleet.add_argument("--watchdog", type=float, default=0.0,
                       help="seconds without a completed round before a "
                            "stall degradation event is logged (0 = off)")
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
    (B, S, V), or (B, 1, V) for a recurrent (hybrid, ssm) prefill,
    cache)."""
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


def serve_fleet(args) -> int:
    from repro_torch.configs import paper_linreg as PL
    from repro_torch.launch.session import (
        SessionOptions,
        build_linreg_fleet_session,
        file_sink,
    )

    net = getattr(PL, args.mix.upper())
    sink = None
    options = SessionOptions(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=not args.no_resume, watchdog_timeout=args.watchdog)
    session = build_linreg_fleet_session(
        net=net, lam_base=args.lam_base, seed=args.seed,
        device=args.device, options=options,
        on_round=lambda k, m: _fleet_log(session, sink, k, args.log_every))
    if args.ckpt_dir and session.round_index:
        print(f"resumed from checkpoint at round {session.round_index} "
              f"({args.ckpt_dir})", flush=True)
    if args.telemetry_file:
        sink = file_sink(args.telemetry_file, session.rollup,
                         every=args.log_every)
    server = None
    if args.telemetry_port is not None:
        server = session.serve_telemetry(port=args.telemetry_port)
        print(f"telemetry: {server.url}/stats.json  {server.url}/metrics",
              flush=True)
    print(f"fleet: mix={net.name} m={net.num_agents} "
          f"rounds={args.rounds or 'until-interrupted'}", flush=True)
    try:
        n = session.run(rounds=args.rounds)
    except KeyboardInterrupt:
        n = session.rollup.rounds
    finally:
        if args.ckpt_dir:
            session.checkpoint()
        if sink is not None:
            sink.flush()
        if server is not None:
            server.stop()
    snap = session.rollup.snapshot()
    print(f"served {n} rounds at {snap['rounds_per_sec']:.1f} rounds/s, "
          f"final loss {snap['gauges'].get('loss', float('nan')):.4f}",
          flush=True)
    return 0


def _fleet_log(session, sink, k, every):
    if sink is not None:
        sink(k, None)
    if every and (k + 1) % every == 0:
        s = session.rollup.snapshot()
        print(f"round {s['rounds']}: loss={s['gauges'].get('loss'):.4f} "
              f"comm_rate={s['gauges'].get('comm_rate'):.3f} "
              f"{s['rounds_per_sec_window']:.1f} rounds/s", flush=True)


def serve_decode(args) -> int:
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.arch_type == "audio":
        # as the JAX CLI: a prompt of tokens is no input for an encoder of
        # audio frames
        raise SystemExit("whisper decoding is driven through prefill (the "
                         "encoder frames) and decode_step; the CLI demo "
                         "serves the token-prompted LM families")
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
        return serve_fleet(args)
    return serve_decode(args)


if __name__ == "__main__":
    raise SystemExit(main())
