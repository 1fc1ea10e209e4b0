"""Hillclimb driver: trace ONE (arch × shape) with explicit knob settings
and print the three roofline terms and the top HBM contributors, so each
hypothesis→change→measure iteration is a single command (port of
``repro.launch.hillclimb``; the step is traced on ``meta`` tensors, see
:mod:`repro_torch.launch.dryrun`).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen3-32b \\
      --shape train_4k --remat --flash 512 [--optimizer sgd] \\
      [--trigger gain_lookahead] [--microbatches 2]

The traced step runs on one card, a (1, 1) mesh, where the JAX
package's hillclimb runs on its production mesh: ``--inner-batch``,
``--seq-shard`` and ``--cache-seq-shard`` plan their rules and, with no
model axis to split, change nothing (as in JAX on a mesh whose model
axis is 1), and ``--fsdp on`` plans ZeRO-3, which on one card shards
nothing.  ``--multi-pod`` raises (ROADMAP queue 1 item 11.2).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

SAVE_DIR = Path("experiments/hillclimb_torch")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--flash", type=int, default=None, help="attn q-block size")
    ap.add_argument("--inner-batch", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--fsdp", default=None, choices=["on", "off"])
    ap.add_argument("--trigger", default="gain_lookahead")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--top", type=int, default=8, help="top HBM contributors")
    ap.add_argument("--save", default=None, help="record JSON under this tag")
    args = ap.parse_args(argv)

    from repro_torch.analysis.roofline import (
        HBM_BYTES,
        Roofline,
        model_flops,
        step_path,
    )
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import TriggerConfig
    from repro_torch.launch import steps as S
    from repro_torch.utils.todo import todo

    if args.multi_pod:
        raise todo("the multi-pod mesh (--multi-pod)", "queue 1 item 11.2")
    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    fsdp = None if args.fsdp is None else args.fsdp == "on"
    plan = S.plan_run(
        cfg, shape,
        trigger=TriggerConfig(kind=args.trigger),
        optimizer=args.optimizer, fsdp=fsdp,
        remat=args.remat, attn_q_block=args.flash,
        inner_batch_shard=args.inner_batch, seq_shard=args.seq_shard,
        cache_seq_shard=args.cache_seq_shard,
        microbatches=args.microbatches,
    )
    lowered = S.lower_for(plan, compute_dtype=args.dtype)
    cost = lowered.cost()
    ma = lowered.memory()
    roof = Roofline(
        arch=args.arch, shape=args.shape, mesh="h100x1", chips=1,
        flops_per_device=cost.flops, bytes_per_device=cost.hbm_bytes,
        wire_bytes_per_device=0.0,
        model_flops_global=model_flops(plan.cfg, shape),
        path=step_path(args.dtype),
        peak_memory_per_device=float(sum(ma.values())),
    )
    knobs = dict(remat=args.remat, flash=args.flash, trigger=args.trigger,
                 optimizer=args.optimizer, microbatches=args.microbatches,
                 dtype=args.dtype)
    print(f"=== {args.arch} × {args.shape} ({roof.mesh}) knobs={knobs}")
    mem = roof.peak_memory_per_device
    print(f"mem/dev      {mem/1e9:10.2f} GB "
          f"(fits H100 {HBM_BYTES/1e9:.0f} GB: "
          f"{'OK' if mem < HBM_BYTES else 'OVER'})")
    print(f"t_compute    {roof.t_compute:10.4f} s   ({roof.path}, "
          f"{roof.peak_flops/1e12:g} TFLOP/s)")
    print(f"t_memory     {roof.t_memory:10.4f} s")
    print(f"t_collective {roof.t_collective:10.4f} s   -> bottleneck: {roof.bottleneck}")
    print(f"useful_flops {roof.useful_flop_ratio:10.3f}   MFU bound: {roof.mfu_bound:.4f}")
    print(f"device ops   {cost.device_ops:10d}")
    print(f"top-{args.top} HBM contributors:")
    for op, row in cost.top(args.top):
        print(f"  {row.hbm_bytes/1e9:10.1f} GB  {op:36s} ×{row.count}")

    if args.save:
        SAVE_DIR.mkdir(parents=True, exist_ok=True)
        rec = {"arch": args.arch, "shape": args.shape, "mesh": roof.mesh,
               "knobs": knobs, "roofline": roof.to_dict(),
               "mem_per_dev": roof.peak_memory_per_device}
        out = SAVE_DIR / f"{args.arch}_{args.shape}_{args.save}.json"
        out.write_text(json.dumps(rec, indent=2))
        print(f"saved -> {out}")


if __name__ == "__main__":
    main()
