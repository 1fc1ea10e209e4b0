"""End-to-end training entry point: event-triggered data-parallel training of
an LM (any family of the model zoo) on the deterministic synthetic token
stream (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 200 --comm "gain_lookahead(lam=0.01)"

The communication stack is one ``--comm`` spec (repro_torch.comm
syntax): trigger, then optional chained compressors, then ``+ef``::

    --comm "gain_lookahead(lam=0.01,decay=inv_t)|topk(0.05)|int8+ef"
    --comm "always|int8 ; never"     # per-agent heterogeneous (needs --agents 2)

The legacy ``--trigger/--lam/--mu/--period/--quantize/--topk/
--error-feedback`` flags still work and map onto the same spec.

It runs on the card unless ``--device cpu`` is given; all ``--agents``
run batched on the one device (default 1, the JAX CLI's data-axis size
on one device).  Under a process group's launcher (``torchrun``: its
``WORLD_SIZE`` and ``RANK`` in the environment), the CLI joins the group
(``nccl`` with a card per rank, else ``gloo``), builds
``make_host_mesh()`` over it, as the JAX CLI builds its mesh over every
local device, and runs each rank's share of the sharded step: an agent
per rank by default (``--agents`` replicates them on every rank, as
JAX's ``agent`` rule of None does), the parameters at rest as its
blocks; rank 0 prints and writes the checkpoints (gathered).  Each step computes every agent's gradient and its
lookahead probe through the ``fused_ce`` kernel and, in every causal
self-attention, the ``swa_attention`` kernel.
Weights come from ``--seed``; batches from one bigram stream on the
device.  Metrics reach the host only on log steps; the transmission and
wire-byte totals are summed on the device and read once at the end.

``--ckpt-dir`` writes the bare ``TrainState`` every ``--ckpt-every``
steps and after the last one, in the JAX package's checkpoint format
(either package restores it); ``--resume`` continues from the latest
checkpoint there at its step, on the batches the unbroken run would
have drawn.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.base import InputShape, TriggerConfig
from repro_torch.core.api import init_train_state
from repro_torch.data import synthetic as D
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import choose_backend, make_host_mesh
from repro_torch.models import build
from repro_torch.models.transformer import dtype_of
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding.rules import gather_tree, shard_tree
from repro_torch.utils.device import resolve_device


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m", choices=list(list_archs()))
    ap.add_argument("--reduced", action="store_true", help="smoke-scale variant")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--agents", type=int, default=None, help="default: 1")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--comm", default=None, metavar="SPEC",
                    help="communication policy spec, e.g. "
                         "'gain_lookahead(lam=0.01)|topk(0.05)|int8+ef'; "
                         "';'-separated for per-agent policies. Supersedes "
                         "the legacy trigger/compression flags below.")
    # legacy flag spellings — assembled into a --comm spec when --comm is
    # not given:
    ap.add_argument("--trigger", default="gain_lookahead",
                    choices=["gain_lookahead", "gain_quadratic", "grad_norm",
                             "periodic", "always", "never"])
    ap.add_argument("--lam", type=float, default=0.0)
    ap.add_argument("--lam-decay", default="const",
                    choices=["const", "inv_t", "geometric"],
                    help="diminishing-λ schedule (paper eq.-23 remark)")
    ap.add_argument("--mu", type=float, default=0.0)
    ap.add_argument("--period", type=int, default=1)
    ap.add_argument("--quantize", action="store_true", help="int8 wire format")
    ap.add_argument("--topk", type=float, default=0.0,
                    help="top-k sparsified wire (fraction of entries kept)")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _legacy_comm_spec(args) -> str:
    """Assemble the legacy trigger/compression flags into a --comm spec."""
    from repro_torch.comm import from_train_config

    trig = TriggerConfig(kind=args.trigger, lam=args.lam, mu=args.mu,
                         period=args.period, lam_decay=args.lam_decay)
    legacy = argparse.Namespace(trigger=trig, quantize_grads=args.quantize,
                                topk_frac=args.topk,
                                error_feedback=args.error_feedback)
    return str(from_train_config(legacy))


def _join_group(device: str):
    """Join the launcher's process group (``torchrun`` sets WORLD_SIZE,
    RANK and the rendezvous address); this rank's device.  Nothing
    without a launcher, or with one rank."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = torch.device(device)
    if world <= 1 or dist.is_initialized():
        return resolve_device(device)
    backend = choose_backend(world, dev)
    if dev.type == "cuda":
        resolve_device(device)
        index = int(os.environ.get("LOCAL_RANK", "0")) if backend == "nccl" \
            else (dev.index or 0)
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    dist.init_process_group(backend, init_method="env://")
    return dev


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    dev = _join_group(args.device)
    mesh = make_host_mesh(device=dev) if dist.is_initialized() else None
    lead = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    over = {}
    if args.layers:
        over["num_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
        over["head_dim"] = args.d_model // cfg.num_heads
    if args.vocab:
        over["vocab_size"] = args.vocab
    if over:
        cfg = cfg.replace(**over)

    shape = InputShape("train_cli", seq_len=args.seq, global_batch=args.batch,
                       kind="train")
    comm = args.comm or _legacy_comm_spec(args)
    plan = S.plan_run(cfg, shape, mesh, comm=comm, optimizer=args.optimizer,
                      lr=args.lr, microbatches=args.microbatches)
    if args.agents:
        plan = dataclasses.replace(
            plan, num_agents=args.agents,
            train_cfg=dataclasses.replace(plan.train_cfg,
                                          num_agents=args.agents))
        plan.rules["agent"] = None  # a custom agent count is replicated
    where = f"device={dev}" + ("" if mesh is None
                               else f" mesh={mesh.shape}")
    if lead:
        print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
              f"agents={plan.num_agents} comm={comm!r} {where}")

    step_fn = S.build_train_step(plan, compute_dtype=args.dtype, device=dev,
                                 mesh=mesh)
    model = build(plan.cfg.replace(compute_dtype=args.dtype))
    params, _ = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                           dtype=dtype_of(args.dtype))
    opt = opt_lib.from_config(plan.train_cfg)
    state = init_train_state(params, opt, plan.train_cfg, device=dev)

    start = 0
    if args.resume and args.ckpt_dir and checkpointer.latest_step(args.ckpt_dir):
        state = checkpointer.restore(args.ckpt_dir, state)
        start = int(state.step)
        if lead:
            print(f"resumed from step {start}")
    shardings = getattr(step_fn, "state_shardings", None)
    if shardings is not None:
        # every rank drew the same global state: keep this rank's blocks
        state = shard_tree(state, shardings)

    def save(step: int) -> None:
        full = state if shardings is None else gather_tree(state, shardings)
        if lead:
            checkpointer.save(args.ckpt_dir, step, full)

    batches = D.batch_iterator(cfg, shape, num_agents=plan.num_agents,
                               seed=args.seed, device=dev, start=start)

    # summed on the device in float64, as the JAX CLI sums host floats
    tx_total = bytes_total = torch.zeros((), dtype=torch.float64, device=dev)
    t0 = time.time()
    for step in range(start, args.steps):
        state, m = step_fn(state, next(batches))
        tx_total = tx_total + m["num_tx"]
        bytes_total = bytes_total + m["wire_bytes"]
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                  f"comm_rate {float(m['comm_rate']):.2f}  "
                  f"gain {float(m['mean_gain']):+.2e}  "
                  f"|g| {float(m['grad_norm']):.3f}  "
                  f"({(time.time()-t0)/(step-start+1):.2f}s/step)",
                  flush=True)
        if args.ckpt_every and args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1)

    total_rounds = (args.steps - start) * plan.num_agents
    tx, wire = float(tx_total), float(bytes_total)
    if lead:
        print(f"\ndone: {args.steps - start} steps, transmissions "
              f"{tx:.0f}/{total_rounds} ("
              f"{100 * tx / max(total_rounds, 1):.1f}% of dense), "
              f"effective wire {wire / 1e6:.2f} MB")
    if args.ckpt_dir:
        save(args.steps)
        if lead:
            print(f"checkpoint -> {args.ckpt_dir}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
