"""Fig 2 (Left): the communication-rate vs learning-performance trade-off
of the gain trigger (eq. 11 + 30).

Paper setup: n=2, 𝔼xxᵀ=diag(3,1), w*=(3,5), w₀=0, ε=0.1, N=5, K=10,
m=2 agents; sweep λ, mean J(w_K) against total comm Σ_k Σ_i α_k^i.
Claim: the curve is monotone — larger λ ⇒ less communication ⇒ higher
final J.
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper_linreg import FIG2_LEFT
from repro_torch.core import regression as R
from repro_torch.figures import seeded
from repro_torch.utils.device import DeviceLike

LAMBDAS = [0.0, 0.02, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4]
TRIALS = 512


def run(device: DeviceLike = "cuda", smoke: bool = False) -> dict:
    trials = 32 if smoke else TRIALS
    problem = R.make_problem(FIG2_LEFT, seeded(0, device), device=device)
    # the whole λ frontier is ONE batched sweep
    res = R.sweep(problem, seeded(1, device), FIG2_LEFT.steps,
                  R.lambda_grid(LAMBDAS), trials)
    Js, comms, any_tx = torch.stack(R.frontier(res)).tolist()
    rows = [{"lam": lam, "mean_final_J": J, "total_comm": c,
             "total_any_tx": a}
            for lam, J, c, a in zip(LAMBDAS, Js, comms, any_tx)]
    max_comm = FIG2_LEFT.steps * FIG2_LEFT.num_agents
    payload = {
        "config": "fig2_left (n=2, cov=diag(3,1), w*=(3,5), eps=0.1, N=5, "
                  "K=10, m=2)",
        "trials": trials,
        "rows": rows,
        "claims": {
            "comm_monotone_decreasing_in_lambda": all(
                a >= b - 1e-6 for a, b in zip(comms, comms[1:])),
            "comm_range_spans_tradeoff": comms[0] > 0.9 * max_comm
            and comms[-1] < 0.2 * max_comm,
            "J_degrades_as_comm_drops": Js[-1] > Js[0],
        },
    }
    if not smoke:
        assert all(payload["claims"].values()), payload["claims"]
    return payload
