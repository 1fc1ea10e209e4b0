"""Fig 1 (Right): the gain trigger (eq. 11 + 30) against the
gradient-magnitude baseline (eq. 31, Remark 3).

Paper setup: n=10, random diagonal 𝔼xxᵀ, random w*, N=20, ε=0.2, K=10,
m=2; sweep λ (gain) and μ (grad-norm), compare J-vs-communication
curves.  Claim: at matched communication the gain trigger reaches lower
J, quantified as the per-budget J ratio (grad-norm over gain).

The problem is a random draw, and the J ratio is a property of the
draw: one draw can miss the claim where most draws make it.  So the
figure draws the problem from each of ``PROBLEM_SEEDS`` (the JAX
script's problem seed 10 and the nine after it), runs every draw on the
same trials, and asserts the claims on the MEDIAN over the draws of each
ratio.  The curves in the payload are those of seed 10; ``per_seed``
holds every draw's ratios.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from repro_torch.configs.paper_linreg import FIG1_RIGHT
from repro_torch.core import regression as R
from repro_torch.figures import seeded
from repro_torch.utils.device import DeviceLike

LAMBDAS = [0.0, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0]
MUS = [0.0, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0, 3000.0]
TRIALS = 512
PROBLEM_SEEDS = tuple(range(10, 20))


def _j_at_budget(curve, budget):
    """Final J interpolated at a communication budget."""
    xs = np.array([c for c, _ in curve])
    ys = np.array([j for _, j in curve])
    return float(np.interp(budget, xs, ys))


def _draw(seed: int, trials: int, device: DeviceLike) -> dict:
    """The two frontiers and the per-budget J ratios of one problem
    draw, on the trials of seed 11."""
    problem = R.make_problem(FIG1_RIGHT, seeded(seed, device), device=device)
    # BOTH trigger families in one sweep: the λ axis next to the μ axis
    grid = R.grid_concat(R.lambda_grid(LAMBDAS), R.mu_grid(MUS))
    Js, comms, _ = torch.stack(R.frontier(
        R.sweep(problem, seeded(11, device), FIG1_RIGHT.steps, grid,
                trials))).tolist()
    points = list(zip(comms, Js))
    gain_curve = sorted(points[:len(LAMBDAS)])
    norm_curve = sorted(points[len(LAMBDAS):])

    budgets = np.linspace(2, FIG1_RIGHT.steps * 2 * 0.9, 8)
    ratios, per_budget = [], []
    for b in budgets:
        jg, jn = _j_at_budget(gain_curve, b), _j_at_budget(norm_curve, b)
        per_budget.append({"budget": float(b), "J_gain": jg,
                           "J_grad_norm": jn})
        ratios.append(jn / max(jg, 1e-9))
    # the paper's operating regime is the LOW-communication end
    low = ratios[:max(2, len(ratios) // 3)]
    return {"gain_curve": gain_curve, "norm_curve": norm_curve,
            "per_budget": per_budget,
            "ratios": {"problem_seed": seed,
                       "mean_J_ratio_grad_over_gain": float(np.mean(ratios)),
                       "low_budget_J_ratio": float(np.mean(low)),
                       "max_J_ratio": float(max(ratios))}}


def run(device: DeviceLike = "cuda", smoke: bool = False) -> dict:
    trials = 32 if smoke else TRIALS
    draws = [_draw(seed, trials, device) for seed in PROBLEM_SEEDS]
    per_seed = [d["ratios"] for d in draws]

    def median(key):
        return statistics.median(r[key] for r in per_seed)

    low, top = median("low_budget_J_ratio"), median("max_J_ratio")
    first = draws[0]
    payload = {
        "config": "fig1_right (n=10, random diag cov, N=20, eps=0.2, K=10, "
                  "m=2)",
        "trials": trials,
        "problem_seeds": list(PROBLEM_SEEDS),
        "gain_curve": [{"comm": c, "J": j} for c, j in first["gain_curve"]],
        "grad_norm_curve": [{"comm": c, "J": j}
                            for c, j in first["norm_curve"]],
        "per_budget": first["per_budget"],
        "per_seed": per_seed,
        "claims": {
            "mean_J_ratio_grad_over_gain":
                median("mean_J_ratio_grad_over_gain"),
            "low_budget_J_ratio": low,
            "gain_better_at_low_budget": bool(low > 1.15),
            "gain_significantly_better_somewhere": bool(top > 1.3),
            "seeds_gain_better_at_low_budget": sum(
                r["low_budget_J_ratio"] > 1.15 for r in per_seed),
        },
    }
    if not smoke:
        assert payload["claims"]["gain_significantly_better_somewhere"], \
            payload["claims"]
        assert payload["claims"]["gain_better_at_low_budget"], \
            payload["claims"]
    return payload
