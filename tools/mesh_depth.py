"""Run chip_smoke.py's [mesh] and [mesh serve] phases alone (their one
spawn of 4 gloo ranks sharing the card), after the kernels' build and
the [ce] check of the vocabulary block a [mesh] rank launches on.

    python3 tools/mesh_depth.py          # llama3.2-3b at chip_smoke's depth
    python3 tools/mesh_depth.py 4 2

tries each depth in turn (the layers of MESH_RUNS["llama"]) until one
passes, printing the phases' lines, and writes the passing run's records
to chiprun_out/mesh_<layers>.json.

    python3 tools/mesh_depth.py --up 4 6 8 10

searches upward instead: llama's fsdp_off job alone at each depth, on
the 4 ranks with no single-process reference (which would not fit past
a few layers) and no serving, until a depth fails; prints each depth's
per-rank peaks and writes chiprun_out/mesh_depth.json with the deepest
that passed.  ``--jobs fsdp_off,seq`` picks other llama jobs.

    python3 tools/mesh_depth.py --arch mixtral-8x7b --up 1 2

does the same for another arch of MESH_RUNS (its depth, and by default
its first job: mixtral's ``moe`` on the (data 1, model 4) mesh);
``--arch`` before the depths also picks whose depth the first form
tries.  Needs one card.
"""
import json
import os
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
import chip_smoke as cs  # noqa: E402

# read again by every spawned rank, which re-imports this module: the
# run whose depth is searched and the depth, and for the upward search
# the jobs it runs with no holds
RUN = os.environ.get("MESH_DEPTH_RUN", "llama")
if "MESH_LAYERS" in os.environ:
    cs.MESH_RUNS[RUN]["layers"] = int(os.environ["MESH_LAYERS"])
if "MESH_DEPTH_JOBS" in os.environ:
    cs.MESH_ONLY = tuple(os.environ["MESH_DEPTH_JOBS"].split(","))
    cs.MESH_HOLD = False


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_depth: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.fused_ce import ops as ce_ops
    from repro_torch.kernels.fused_ce import ref as ce_ref
    from repro_torch.kernels.gain_reduce import ops as gr_ops
    from repro_torch.kernels.swa_attention import ops as swa_ops

    card = cs.nvidia_smi()
    print("[card]", card, torch.__version__, torch.version.cuda, flush=True)
    cs.phase_build(gr_ops, swa_ops, ce_ops)
    gen = torch.Generator(device="cuda").manual_seed(4)
    print(json.dumps(cs._ce_mesh_block(torch, ce_ops, ce_ref, gen)))
    torch.cuda.empty_cache()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    args = sys.argv[1:]
    global RUN
    if args and args[0] == "--arch":
        RUN = next(name for name, run in cs.MESH_RUNS.items()
                   if run["arch"] == args[1])
        os.environ["MESH_DEPTH_RUN"] = RUN
        args = args[2:]
    if args and args[0] == "--up":
        return search_up(torch, card, args[1:], out)
    for layers in args or [str(cs.MESH_RUNS[RUN]["layers"])]:
        os.environ["MESH_LAYERS"] = layers
        cs.MESH_RUNS[RUN]["layers"] = int(layers)
        t0 = time.perf_counter()
        try:
            mesh, serve = cs.phase_mesh(torch, card)
        except Exception:
            traceback.print_exc()
            print(f"[depth] {RUN} at {layers} layers failed after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            continue
        print(f"[depth] {RUN} at {layers} layers passed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        (out / f"mesh_{layers}.json").write_text(json.dumps(
            {"mesh": mesh, "mesh_serve": serve}, default=str, indent=1))
        return 0
    return 1


def search_up(torch, card: str, args: list, out: Path) -> int:
    """The upward search (the module doc): 0 when the first depth passed."""
    jobs = next(job for job, spec in cs.MESH_JOBS.items() if spec[0] == RUN)
    if args and args[0] == "--jobs":
        jobs, args = args[1], args[2:]
    # read again by every spawned rank
    os.environ["MESH_DEPTH_JOBS"] = jobs
    cs.MESH_ONLY, cs.MESH_HOLD = tuple(jobs.split(",")), False
    rows = []
    for layers in args:
        os.environ["MESH_LAYERS"] = layers
        cs.MESH_RUNS[RUN]["layers"] = int(layers)
        t0 = time.perf_counter()
        try:
            mesh, _ = cs.phase_mesh(torch, card)
        except Exception:
            traceback.print_exc()
            print(f"[depth] {RUN} at {layers} layers failed after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            break
        peaks = {job: rec["peak_gb_ranks"] for job, rec in
                 mesh["jobs"].items()}
        rows.append({"layers": int(layers), "peak_gb_ranks": peaks,
                     "seconds": time.perf_counter() - t0})
        print(f"[depth] {RUN} at {layers} layers passed in "
              f"{time.perf_counter() - t0:.1f} s; peak GB per rank {peaks}",
              flush=True)
    deepest = rows[-1]["layers"] if rows else None
    arch = cs.MESH_RUNS[RUN]["arch"]
    print(f"[depth] deepest {arch} [mesh] that fits on the 4 ranks "
          f"({jobs}): {deepest} layers ({card})", flush=True)
    (out / "mesh_depth.json").write_text(json.dumps(
        {"card": card, "arch": arch, "jobs": jobs, "passed": rows,
         "deepest": deepest}, indent=1))
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
