#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (any failure exits nonzero; no result line is printed then):

1. build   — prints the card's name and power limit, compiles the
             ``gain_reduce`` CUDA kernel from
             ``src/repro_torch/kernels/gain_reduce/csrc/`` with nvcc for
             sm_90a, and prints nvcc's register/shared-memory report.
2. kernel  — holds the kernel against its plain PyTorch version and
             against the exact (float64) sum on the card, at the fleet's
             (64, 32), the m=4096 fleet's (4096, 32), one (1, 2^26) row
             and the ragged (64, 33), (4096, 31) and (3, 1_000_003), in
             fp32 and bf16, each aligned and one element off alignment;
             integer-valued inputs must come out exact, and a repeated
             launch bitwise equal.
3. slice   — serves the n=32, m=64, N=32 tiered fleet with its metered
             tiers gated by ``gain_quadratic(kernel=true)`` through the
             hybrid dispatch for 200 rounds, with the launch counter set
             to 0 just before and read just after: exactly one kernel
             launch per round, finite losses, a falling loss, and the
             first 10 rounds equal to the same session on the CPU.
4. times   — the kernel's, its plain version's and ``torch.linalg.vecdot``'s
             times at each shape beside the bytes-over-bandwidth bound:
             per call by CUDA events (median of 100 calls after
             warm-up), and on the device by the profiler.
5. profile — 20 more rounds of the same session under torch.profiler:
             device ops per round, device-busy time per round, the
             device's idle share against the unprofiled round time, the
             kernels that take the most device time, and the host
             operators that take the most host time.

Before the last line come the ``{"kernels": [...]}`` record and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  The full record is also
written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# fp32 rate outside the tensor cores (the kernel's arithmetic is fp32 FMA)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SHAPES = ((64, 32), (4096, 32), (1, 1 << 26))
TIMED_RUNS = 100
ROUNDS = 200
CHECK_ROUNDS = 10
PROFILED_ROUNDS = 20


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# Rows the kernel is checked at beyond the timed shapes: lengths that are
# not a multiple of the 16-byte group (the masked scalar loads), and one
# ragged row long enough to span many blocks (the second-stage sum of
# per-block partials) with several rows (the partials' row offsets).
RAGGED_SHAPES = ((64, 33), (4096, 31), (3, 1_000_003))
CHECK_SHAPES = SHAPES + RAGGED_SHAPES
RTOL, ATOL_PER_MASS = 1e-5, 1e-6  # kernel vs plain, every shape
U32 = 2.0 ** -24                   # unit roundoff of fp32


def _threads_for(items: int) -> int:
    t = 32
    while t < 256 and t < items:
        t *= 2
    return t


def summation_depth(n: int, width: int):
    """(stage-1 blocks per row, the longest chain of fp32 roundings any
    product passes through) in the kernel, for a row of n elements and
    loads of ``width`` elements — ``make_plan`` of csrc/gain_reduce.cu:
    each thread's serial run of fused multiply-adds, its block's tree
    (≤ 10 shuffle levels), and, when the row spans several blocks, the
    second stage's serial run over partials and its tree."""
    threads = _threads_for(-(-n // width))
    per_pass = threads * width
    chunk = per_pass * 8
    nsplit = -(-n // chunk)
    if nsplit > 65535:
        chunk = -(-(-(-n // 65535)) // per_pass) * per_pass
        nsplit = -(-n // chunk)
    depth = -(-min(chunk, n) // per_pass) * width + 10
    if nsplit > 1:
        depth += -(-nsplit // _threads_for(nsplit)) + 10
    return nsplit, depth


def error_bound(n: int, width: int) -> float:
    """Worst-case |kernel − exact sum| / Σ|terms|: a sum whose every term
    passes through at most d roundings errs by at most
    γ_d = d·u / (1 − d·u) times Σ|terms| (u = 2^-24).  The products
    themselves are exact inside the fused multiply-add, and bf16 inputs
    widen exactly to fp32, so the same bound holds for both dtypes."""
    d = summation_depth(n, width)[1]
    return d * U32 / (1 - d * U32)


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median time of one ``fn()`` call over ``runs`` calls after
    warm-up, by CUDA events recorded around each call: device time plus
    any host dispatch during which the device waits."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(rows: int, n: int, itemsize: int):
    """Least time (ms) for the same work: every input byte read once
    and the (rows, 2) fp32 output written once over HBM bandwidth, vs
    4 flops per element pair at the fp32 peak."""
    nbytes = 2 * rows * n * itemsize + rows * 2 * 4
    flops = 4 * rows * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(gr_ops) -> dict:
    t0 = time.perf_counter()
    lib = gr_ops.build()
    seconds = time.perf_counter() - t0
    log = Path(f"{lib}.log")
    print(f"[build] {lib.relative_to(REPO)} in {seconds:.1f} s")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")
    return {"library": str(lib.relative_to(REPO)), "seconds": seconds}


def _rows(make, rows: int, n: int, offset: int):
    """A contiguous (rows, n) view that starts ``offset`` elements into
    its buffer: offset 1 puts it off the 16-byte alignment the vector
    loads need, so the kernel takes its scalar loads."""
    return make(rows * n + offset)[offset:].view(rows, n)


def _normal_rows(torch, gen, dtype, rows: int, n: int, offset: int):
    def make(size):
        return torch.randn((size,), generator=gen, device="cuda").to(dtype)

    return _rows(make, rows, n, offset)


def _integer_rows(torch, gen, dtype, rows: int, n: int, offset: int):
    """Integers in [-3, 3], sparse enough that every partial sum of gᵢ²
    or gᵢhᵢ stays below 2^22: all of them are exact in fp32 and bf16,
    so any order of summation gives the exact result, bit for bit.  A
    dropped, doubled or misplaced element or partial shows as a nonzero
    difference."""
    density = min(1.0, 2.0 ** 22 / (9 * n))

    def make(size):
        vals = torch.randint(-3, 4, (size,), generator=gen, device="cuda")
        keep = torch.rand((size,), generator=gen, device="cuda") < density
        return (vals * keep).to(dtype)

    return _rows(make, rows, n, offset)


def phase_kernel(torch, gr_ops, ref) -> list:
    """Kernel vs plain version on the card, at every checked shape and
    dtype, aligned and one element off alignment.  Three checks each:

    - normal inputs, kernel vs plain: ``RTOL``·|plain| + ``ATOL_PER_MASS``
      ·Σ|terms| (both sum the same fp32 products in different orders);
    - normal inputs, kernel vs the exact (float64) sum: ``error_bound``
      ·Σ|terms|, derived from the kernel's own order of summation;
    - integer inputs (``_integer_rows``): kernel, plain and exact sum
      bitwise equal;

    and a repeated launch is bitwise equal."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, n in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            width = 16 // torch.empty((), dtype=dtype).element_size()
            nsplit, _ = summation_depth(n, width)
            code = 0 if dtype == torch.float32 else 1
            if nsplit != gr_ops._splits(n, code):
                raise AssertionError(f"summation_depth's plan for n={n} "
                                     "differs from the kernel's")
            bound = error_bound(n, width)
            for offset in (0, 1):
                g = _normal_rows(torch, gen, dtype, rows, n, offset)
                h = _normal_rows(torch, gen, dtype, rows, n, offset)
                got = gr_ops.gain_reduce(g, h)
                again = gr_ops.gain_reduce(g, h)
                want = ref.gain_reduce_ref(g, h)
                gf, hf = g.double(), h.double()
                exact = torch.stack([(gf * gf).sum(-1), (gf * hf).sum(-1)],
                                    -1)
                mass = torch.stack([(gf * gf).sum(-1),
                                    (gf * hf).abs().sum(-1)], -1)
                torch.cuda.synchronize()
                name = (f"gain_reduce {rows}x{n} {str(dtype)[6:]} "
                        f"offset {offset}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: repeated launch differs")
                err = (got.double() - want.double()).abs()
                if not bool((err <= RTOL * want.double().abs()
                             + ATOL_PER_MASS * mass).all()):
                    raise AssertionError(
                        f"{name}: kernel disagrees with its plain version "
                        f"(max err {err.max().item():.3e})")
                err_exact = (got.double() - exact).abs()
                ratio = (err_exact / (bound * mass)).max().item()
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"{name}: kernel error {err_exact.max().item():.3e} "
                        f"exceeds its derived bound (x{ratio:.3g})")
                gi = _integer_rows(torch, gen, dtype, rows, n, offset)
                hi = _integer_rows(torch, gen, dtype, rows, n, offset)
                got_i = gr_ops.gain_reduce(gi, hi)
                want_i = ref.gain_reduce_ref(gi, hi)
                gd, hd = gi.double(), hi.double()
                exact_i = torch.stack([(gd * gd).sum(-1), (gd * hd).sum(-1)],
                                      -1)
                if not (torch.equal(got_i, want_i)
                        and torch.equal(got_i.double(), exact_i)):
                    bad = (got_i.double() - exact_i).abs().max().item()
                    raise AssertionError(
                        f"{name}: integer inputs not summed exactly (kernel "
                        f"off by {bad}, plain off by "
                        f"{(want_i.double() - exact_i).abs().max().item()})")
                vector = n % width == 0 and offset == 0
                results.append({
                    "shape": [rows, n], "dtype": str(dtype)[6:],
                    "offset": offset,
                    "loads": "vector" if vector else "scalar",
                    "splits": nsplit,
                    "max_abs_err": err.max().item(), "rtol": RTOL,
                    "atol_per_abs_mass": ATOL_PER_MASS,
                    "max_abs_err_vs_exact": err_exact.max().item(),
                    "bound_per_abs_mass": bound,
                    "err_over_bound": ratio,
                    "integer_exact": True, "bitwise_repeat": True,
                })
                print(f"[kernel] {rows}x{n} {str(dtype)[6:]} offset "
                      f"{offset} ({results[-1]['loads']} loads, {nsplit} "
                      f"split{'s' if nsplit > 1 else ''}): vs plain "
                      f"{err.max().item():.3e} within {RTOL}·|plain| + "
                      f"{ATOL_PER_MASS}·Σ|gh|; vs exact "
                      f"{err_exact.max().item():.3e} = {ratio:.2e} of the "
                      f"bound {bound:.2e}·Σ|gh|; integers exact; repeat "
                      f"bitwise equal")
                del g, h, gi, hi, gf, hf, gd, hd
    covered = {(r["loads"], r["splits"] > 1) for r in results}
    if len(covered) != 4:
        raise AssertionError(f"load/split paths not all covered: {covered}")
    return results


def phase_slice(torch, gr_ops):
    """The main path: the m=64 quadratic-gated fleet served on the card."""
    from repro_torch.configs.paper_linreg import (
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.convert import to_numpy
    from repro_torch.core import regression as R
    from repro_torch.launch.session import (
        build_linreg_fleet_session,
        round_generator,
    )

    cfg = TIERED_M64_CFG
    seed = 0
    dev = torch.device("cuda", torch.cuda.current_device())
    problem = R.make_problem(cfg, round_generator(seed, 0, dev), device=dev)

    def batch_fn(k):
        return R.agent_batches(problem, round_generator(seed + 1, k, dev))

    history, history_loss, stamps = [], [], []

    def on_round(k, metrics):
        stamps.append(time.perf_counter())
        if k < CHECK_ROUNDS:
            history.append(metrics)
        history_loss.append(float(metrics["loss"]))

    session = build_linreg_fleet_session(
        net=TIERED_M64_QUADRATIC, cfg_lr=cfg, seed=seed, device=dev,
        batch_fn=batch_fn, on_round=on_round)

    gr_ops.gain_reduce.launches = 0
    session.run(ROUNDS)
    torch.cuda.synchronize()
    launches = gr_ops.gain_reduce.launches

    if launches != ROUNDS:
        raise AssertionError(f"main path launched gain_reduce {launches} "
                             f"times in {ROUNDS} rounds (want 1 per round)")
    if not all(math.isfinite(v) for v in history_loss):
        raise AssertionError("non-finite loss on the card")
    if not history_loss[-1] < history_loss[0]:
        raise AssertionError(f"loss did not fall: {history_loss[0]} -> "
                             f"{history_loss[-1]}")
    steady = (len(stamps) - 1 - CHECK_ROUNDS) / (stamps[-1]
                                                 - stamps[CHECK_ROUNDS])

    # the same session on the CPU, on the same batches
    cpu_hist = []
    cpu = build_linreg_fleet_session(
        net=TIERED_M64_QUADRATIC, cfg_lr=cfg, seed=seed, device="cpu",
        batch_fn=lambda k: tuple(x.cpu() for x in batch_fn(k)),
        on_round=lambda k, m: cpu_hist.append(m))
    cpu.run(CHECK_ROUNDS)
    # free-running over 10 rounds: the card's matmuls and reductions sum
    # in other orders than the CPU's, and the gaps compound round over
    # round, so floats get rtol 1e-4 / atol 1e-5; decisions stay exact
    import numpy as np

    for k, (a, b) in enumerate(zip(history, cpu_hist)):
        for key in ("agent_tx", "num_tx", "any_tx"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"round {k}: {key} differs card vs CPU")
        for key in b:
            if not np.allclose(a[key], b[key], rtol=1e-4, atol=1e-5):
                raise AssertionError(
                    f"round {k}: {key} differs card vs CPU: {a[key]} vs "
                    f"{b[key]}")
    card_w = to_numpy(session.state.params)["w"]
    print(f"[slice] {ROUNDS} rounds, m={cfg.num_agents} n={cfg.n} "
          f"N={cfg.samples_per_agent}: gain_reduce launches {launches}; "
          f"loss {history_loss[0]:.4f} -> {history_loss[-1]:.4f}; "
          f"first {CHECK_ROUNDS} rounds match the CPU session; "
          f"{steady:.1f} rounds/s after round {CHECK_ROUNDS}")
    snap = session.rollup.snapshot()
    return session, {
        "rounds": ROUNDS, "launches": launches,
        "loss_first": history_loss[0], "loss_last": history_loss[-1],
        "rounds_per_s": steady, "num_tx_total": snap["counters"]["num_tx"],
        "wire_bytes_total": snap["counters"]["wire_bytes"],
        "w_norm": float(np.linalg.norm(card_w)),
    }


def phase_profile(torch, session, round_ms: float) -> dict:
    """Device time of served rounds, from a torch.profiler trace.

    Busy time is the sum of the card's kernel and copy intervals (one
    stream, so they do not overlap); the idle share compares it with
    the round time measured WITHOUT the profiler in the main run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session.run(PROFILED_ROUNDS)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    # host side: self time of the traced operators and runtime calls
    # (what is not in them is Python between the calls)
    host = [(a.key, a.self_cpu_time_total, a.count)
            for a in prof.key_averages()
            if a.device_type == DeviceType.CPU and a.self_cpu_time_total > 0]
    host_ms = sum(t for _, t, _ in host) / 1e3 / PROFILED_ROUNDS
    host_top = sorted(host, key=lambda x: -x[1])[:8]
    if not by_name:
        raise AssertionError("the profiler saw no device activity")
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / PROFILED_ROUNDS
    kernels = sum(c for _, c in by_name.values()) / PROFILED_ROUNDS
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    idle = 1.0 - busy_ms / round_ms
    print(f"[profile] per round: {kernels:.0f} device ops, device busy "
          f"{busy_ms:.4f} ms of {round_ms:.4f} ms (unprofiled) -> idle "
          f"share {idle:.3f}")
    for name, (t, c) in top:
        print(f"[profile]   {t / 1e3 / PROFILED_ROUNDS:.4f} ms/round "
              f"x{c / PROFILED_ROUNDS:.0f}  {name[:90]}")
    print(f"[profile] host, under the profiler: {host_ms:.3f} ms/round "
          f"of self time in traced operators and runtime calls")
    for name, t, c in host_top:
        print(f"[profile]   host {t / 1e3 / PROFILED_ROUNDS:.4f} ms/round "
              f"x{c / PROFILED_ROUNDS:.0f}  {name[:80]}")
    return {"rounds": PROFILED_ROUNDS, "device_ops_per_round": kernels,
            "device_busy_ms_per_round": busy_ms,
            "round_ms_unprofiled": round_ms, "idle_share": idle,
            "top": [{"name": n, "ms_per_round": t / 1e3 / PROFILED_ROUNDS,
                     "per_round": c / PROFILED_ROUNDS}
                    for n, (t, c) in top],
            "host_self_ms_per_round": host_ms,
            "host_top": [{"name": n, "ms_per_round": t / 1e3 / PROFILED_ROUNDS,
                          "per_round": c / PROFILED_ROUNDS}
                         for n, t, c in host_top]}


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` call: the summed durations of the
    kernels it runs, from a torch.profiler trace of ``calls`` calls
    (free of the host's dispatch time that CUDA events include)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler saw no device activity")
    return total_us / calls / 1e3


def phase_times(torch, gr_ops, ref) -> list:
    """Per shape and dtype: the kernel, its plain version and two
    ``vecdot`` calls, first by CUDA events around each call (what a
    caller waits, host dispatch included), then by the profiler's
    device time (what the card spends).  The profiler runs last: its
    callbacks slow every later launch on the host."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for rows, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
            h = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
            fns = {
                "": lambda g=g, h=h: gr_ops.gain_reduce(g, h),
                "plain_": lambda g=g, h=h: ref.gain_reduce_ref(g, h),
                "library_": lambda g=g, h=h: (torch.linalg.vecdot(g, g),
                                              torch.linalg.vecdot(g, h)),
            }
            bound_ms, bound_by = bound(rows, n, g.element_size())
            cases.append(({"shape": [rows, n],
                           "dtype": str(dtype).split(".")[-1],
                           "bound_ms": bound_ms, "bound_by": bound_by}, fns))
    before = gr_ops.gain_reduce.launches
    for row, fns in cases:
        for key, fn in fns.items():
            row[f"{key}ms"] = time_ms(fn)
    for row, fns in cases:
        for key, fn in fns.items():
            row[f"{key}device_ms"] = device_ms(torch, fn)
    gr_ops.gain_reduce.launches = before  # timing launches do not count
    for row, _ in cases:
        (rows, n), dt = row["shape"], row["dtype"]
        print(f"[times] {rows}x{n} {dt}: per call (events) kernel "
              f"{row['ms']:.4f} / plain {row['plain_ms']:.4f} / vecdot x2 "
              f"{row['library_ms']:.4f} ms; on the device kernel "
              f"{row['device_ms']:.5f} / plain {row['plain_device_ms']:.5f}"
              f" / vecdot x2 {row['library_device_ms']:.5f} ms; bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return [row for row, _ in cases]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # full-precision fp32 products and convolutions on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.gain_reduce import ops as gr_ops
    from repro_torch.kernels.gain_reduce import ref

    card = nvidia_smi()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    record = {"card": card, "build": phase_build(gr_ops)}
    record["kernel_checks"] = phase_kernel(torch, gr_ops, ref)
    session, record["slice"] = phase_slice(torch, gr_ops)
    record["times"] = phase_times(torch, gr_ops, ref)
    record["profile"] = phase_profile(
        torch, session, 1e3 / record["slice"]["rounds_per_s"])

    main_shape = record["times"][0]
    assert main_shape["shape"] == [64, 32] and main_shape["dtype"] == "float32"
    main_check = record["kernel_checks"][0]
    kernels = {"kernels": [{
        "name": "gain_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/gain_reduce/csrc/gain_reduce.cu",
        "replaces": "src/repro/kernels/gain_reduce/kernel.py:44",
        "launches": record["slice"]["launches"],
        "max_abs_err": main_check["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "device_ms": main_shape["device_ms"],
        "plain_device_ms": main_shape["plain_device_ms"],
        "library_device_ms": main_shape["library_device_ms"],
        "shape": main_shape["shape"],
        "dtype": main_shape["dtype"],
    }]}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=2))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
