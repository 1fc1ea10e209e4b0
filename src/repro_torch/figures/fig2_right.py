"""Fig 2 (Right): the exact gain (eq. 28, needs the data distribution)
against the estimated gain (eq. 30, data only).

Paper setup: the Fig 2 problem, N=5 samples per agent, ε=0.2, a single
time step, sweeping λ.  Claim: "we do not observe a significant
difference due to the estimation procedure".
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper_linreg import FIG2_RIGHT
from repro_torch.core import regression as R
from repro_torch.figures import seeded
from repro_torch.utils.device import DeviceLike

LAMBDAS = [0.0, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2]
TRIALS = 2048


def run(device: DeviceLike = "cuda", smoke: bool = False) -> dict:
    trials = 64 if smoke else TRIALS
    problem = R.make_problem(FIG2_RIGHT, seeded(0, device), device=device)
    # one sweep over BOTH gain variants; every grid point shares the
    # trials' batches, so per-λ decisions are comparable
    L = len(LAMBDAS)
    grid = R.grid_concat(R.lambda_grid(LAMBDAS, mode="gain_exact"),
                         R.lambda_grid(LAMBDAS, mode="gain_estimated"))
    res = R.sweep(problem, seeded(1, device), FIG2_RIGHT.steps, grid, trials)
    Js, comms, _ = torch.stack(R.frontier(res)).tolist()
    agree = (res.alphas[:L] == res.alphas[L:]).float().mean(
        (1, 2, 3)).tolist()
    rows = [{"lam": float(lam), "J_exact": Js[i], "J_estimated": Js[L + i],
             "comm_exact": comms[i], "comm_estimated": comms[L + i],
             "alpha_agreement": agree[i]}
            for i, lam in enumerate(LAMBDAS)]
    # "no significant difference": relative gap in J small across the sweep
    gaps = [abs(r["J_exact"] - r["J_estimated"]) / max(r["J_exact"], 1e-9)
            for r in rows]
    payload = {
        "config": "fig2_right (n=2, eps=0.2, N=5, K=1)",
        "trials": trials,
        "rows": rows,
        "claims": {
            "max_relative_J_gap": max(gaps),
            "no_significant_difference": max(gaps) < 0.08,
            "decision_agreement_min": min(agree),
        },
    }
    if not smoke:
        assert payload["claims"]["no_significant_difference"], \
            payload["claims"]
    return payload
