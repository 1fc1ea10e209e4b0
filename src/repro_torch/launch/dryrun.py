"""Dry-run of the port on one H100: trace every (arch × shape) pair's
step on ``meta`` tensors (port of ``repro.launch.dryrun``).

The JAX dry-run lowers and compiles each pair for a 256- or 512-chip
v5e mesh and reads XLA's HLO.  The port's dry-run has no mesh yet
(ROADMAP queue 1 item 11.2): each pair is the plan's step on one card, traced on
``meta`` tensors (:func:`repro_torch.launch.steps.lower_for`), so
nothing is allocated and every pair traces at full width, kimi-k2's
1 T parameters included, on a CPU as on the card.

Per pair we record to
``experiments/dryrun_torch/<arch>_<shape>_h100x1_<base|opt>.json``:

  * ``memory_analysis`` — argument / temp / output bytes: the "does it
    fit the H100's 80 GB" reckoning
  * ``cost``            — the counted flops / HBM bytes / device ops
    (:mod:`repro_torch.analysis.cost`; the JAX record's ``hlo_cost``)
  * ``roofline``        — the three terms + bottleneck + MFU bound on
    the H100 (:mod:`repro_torch.analysis.roofline`)

``--opt`` is the JAX package's optimized variant, ``remat=True,
attn_q_block=512``; on decode shapes its ``cache_seq_shard`` belongs to
the mesh, and the pair is recorded as skipped.  A pair the JAX package
skips (``runs_shape``) is skipped with its reason.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all            # subprocess per arch
  python -m repro_torch.launch.dryrun --all --opt
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH = "h100x1"
COMPUTE_DTYPE = "bfloat16"  # the JAX dry-run's


def record_name(arch: str, shape_name: str, opt: bool) -> str:
    return f"{arch}_{shape_name}_{MESH}_{'opt' if opt else 'base'}"


def run_one(arch: str, shape_name: str, opt: bool, out_dir: Path) -> dict:
    from repro_torch.analysis.cost import summarize
    from repro_torch.analysis.roofline import Roofline, model_flops, step_path
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import runs_shape

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    name = record_name(arch, shape_name, opt)

    ok, reason = runs_shape(cfg, shape)
    if ok and opt and shape.kind == "decode":
        # the JAX --opt of a decode shape is flash-decoding's
        # cache_seq_shard, a sharding of the cache over the mesh's model
        # axis: the one-card dry-run has no mesh to split it over
        ok, reason = False, ("cache_seq_shard needs a mesh: ROADMAP queue 1 "
                             "item 11.2.5")
    if not ok:
        rec = {"name": name, "status": "skipped", "reason": reason}
        (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.time()
    kw = dict(remat=True, attn_q_block=512) if opt else {}
    plan = S.plan_run(cfg, shape, **kw)
    lowered = S.lower_for(plan, compute_dtype=COMPUTE_DTYPE)
    cost = lowered.cost()
    ma = lowered.memory()
    t_trace = time.time() - t0

    total = ma["argument_bytes"] + ma["temp_bytes"] + ma["output_bytes"]
    roof = Roofline(
        arch=arch,
        shape=shape_name,
        mesh=MESH,
        chips=1,
        flops_per_device=cost.flops,
        bytes_per_device=cost.hbm_bytes,
        wire_bytes_per_device=0.0,
        model_flops_global=model_flops(plan.cfg, shape),
        path=step_path(COMPUTE_DTYPE),
        peak_memory_per_device=float(total),
    )
    rec = {
        "name": name,
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH,
        "tag": "opt" if opt else "base",
        "chips": 1,
        "trace_seconds": round(t_trace, 1),
        "plan": {
            "fsdp": False,
            "num_agents": plan.num_agents,
            "agent_axes": [],
            "remat": plan.cfg.remat,
            "attn_q_block": plan.cfg.attn_q_block,
            "swa_window": plan.cfg.swa_window,
        },
        "memory_analysis": dict(ma, total_bytes=total),
        "cost": summarize(cost),
        "roofline": roof.to_dict(),
    }
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--opt", action="store_true", help="remat+flash optimized variant")
    ap.add_argument("--all", action="store_true", help="all (arch × shape), subprocess per arch")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--force", action="store_true", help="recompute cached results")
    args = ap.parse_args(argv)

    from repro_torch.utils.todo import todo

    if args.multi_pod or args.both_meshes:
        raise todo("the multi-pod dry-run (--multi-pod, --both-meshes)",
                   "queue 1 item 11.2")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    from repro_torch.configs import SHAPES, list_archs

    if args.all:
        src = str(Path(__file__).resolve().parents[2])
        path = os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                               if p)
        failures = 0
        for arch in list_archs():
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--out", str(out_dir)]
            if args.opt:
                cmd.append("--opt")
            if args.force:
                cmd.append("--force")
            print(f"=== {arch} ===", flush=True)
            r = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": path})
            failures += r.returncode != 0
        return 1 if failures else 0

    archs = [args.arch] if args.arch else list(list_archs())
    shapes = [args.shape] if args.shape else list(SHAPES)

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            name = record_name(arch, shape_name, args.opt)
            path = out_dir / f"{name}.json"
            if path.exists() and not args.force:
                rec = json.loads(path.read_text())
                print(f"[cached] {name}: {rec.get('status')}", flush=True)
                continue
            try:
                rec = run_one(arch, shape_name, args.opt, out_dir)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(
                        f"[ok] {name}: mem/dev="
                        f"{rec['memory_analysis']['total_bytes']/1e9:.2f}GB "
                        f"t_comp={r['t_compute_s']:.4f}s t_mem={r['t_memory_s']:.4f}s "
                        f"t_coll={r['t_collective_s']:.4f}s -> {r['bottleneck']} "
                        f"({rec['trace_seconds']}s trace)",
                        flush=True,
                    )
                else:
                    print(f"[skip] {name}: {rec['reason']}", flush=True)
            except Exception as e:
                n_fail += 1
                print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                path.write_text(
                    json.dumps({"name": name, "status": "error", "error": str(e)})
                )
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
