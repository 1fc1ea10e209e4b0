"""Theorem 1 / Theorem 2 bound tightness (paper §3).

For a λ grid, the measured quantities of ``gain_exact`` runs next to the
theoretical bounds: Thm 1's bound on 𝔼J(w_N) (held with 2 % slack for
the Monte-Carlo mean) and Thm 2's almost-sure bound on Σ_k max_i α_k^i.
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper_linreg import FIG2_LEFT
from repro_torch.core import regression as R
from repro_torch.core import theory as T
from repro_torch.figures import seeded
from repro_torch.utils.device import DeviceLike

LAMBDAS = [0.05, 0.1, 0.2, 0.5, 1.0]
TRIALS = 512
STEPS = 60


def run(device: DeviceLike = "cuda", smoke: bool = False) -> dict:
    trials = 64 if smoke else TRIALS
    problem = R.make_problem(FIG2_LEFT, seeded(0, device), device=device)
    w0 = torch.zeros(problem.n, device=problem.device)
    J0 = float(problem.J(w0))
    Js = float(problem.J_star())
    trG = float(T.gradient_covariance_trace(
        problem.sigma_diag, w0, problem.w_star, problem.noise_std,
        problem.n_samples))
    # every λ on the same trials (the JAX script reuses one key per λ)
    res = R.sweep(problem, seeded(2, device), STEPS,
                  R.lambda_grid(LAMBDAS, mode="gain_exact"), trials)
    mean_J = res.J_traj[:, :, -1].mean(1).tolist()
    silence = (1.0 - res.alphas).mean((1, 2, 3)).tolist()
    any_tx = res.alphas.amax(-1).sum(-1)             # (G, T)
    max_any, mean_any = any_tx.amax(1).tolist(), any_tx.mean(1).tolist()
    rows = []
    for i, lam in enumerate(LAMBDAS):
        b1 = float(T.thm1_bound(J0, Js, problem.eps, problem.sigma_diag,
                                trG, lam, silence[i], STEPS))
        b2 = float(T.thm2_comm_bound(J0, Js, lam))
        rows.append({
            "lam": lam,
            "mean_J_N": mean_J[i], "thm1_bound": b1,
            "thm1_holds": mean_J[i] <= b1 * 1.02,
            "max_any_tx": max_any[i], "mean_any_tx": mean_any[i],
            "thm2_bound": b2, "thm2_holds_as": max_any[i] <= b2 + 1e-6,
        })
    payload = {"steps": STEPS, "trials": trials, "rows": rows,
               "all_bounds_hold": all(r["thm1_holds"] and r["thm2_holds_as"]
                                      for r in rows)}
    if not smoke:
        assert payload["all_bounds_hold"], payload
    return payload
