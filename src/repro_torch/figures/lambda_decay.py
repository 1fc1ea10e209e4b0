"""Diminishing-λ schedules (the paper's post-eq.(23) remark: "choose a
diminishing parameter λ to eliminate this effect").

Constant λ, λ/(1+k), λ·ρ^k and always-transmit on the Fig 2 setup:
steady-state J against total communication.  Claim: the diminishing
schedules recover the dense steady state while keeping a large part of
the early-round savings; constant λ keeps its penalty.
"""
from __future__ import annotations

from repro_torch.configs.paper_linreg import FIG2_LEFT
from repro_torch.core import regression as R
from repro_torch.figures import seeded
from repro_torch.utils.device import DeviceLike

STEPS, TRIALS, LAM0 = 120, 512, 2.0


def run(device: DeviceLike = "cuda", smoke: bool = False) -> dict:
    trials = 32 if smoke else TRIALS
    steps = 40 if smoke else STEPS
    problem = R.make_problem(FIG2_LEFT, seeded(0, device), device=device)
    names_specs = (
        ("always", "always"),
        ("const λ=2", f"gain_exact(lam={LAM0})"),
        ("inv_t λ0=2", f"gain_exact(lam={LAM0},decay=inv_t)"),
        ("geometric λ0=2", f"gain_exact(lam={LAM0},decay=geometric)"),
    )
    # all four schedules are one sweep grid (the decay id is a knob)
    grid = R.grid_from_specs([spec for _, spec in names_specs])
    res = R.sweep(problem, seeded(1, device), steps, grid, trials)
    steady = res.J_traj[:, :, -10:].mean((1, 2)).tolist()
    comm = res.alphas.sum((2, 3)).mean(1).tolist()
    rows = [{"schedule": name, "steady_J": steady[i], "total_comm": comm[i]}
            for i, (name, _) in enumerate(names_specs)]
    dense = rows[0]
    decayed = [r for r in rows if "λ0" in r["schedule"]]
    payload = {
        "steps": steps, "trials": trials, "rows": rows,
        "claims": {
            "decay_recovers_dense_J": all(
                r["steady_J"] < dense["steady_J"] * 1.3 for r in decayed),
            "decay_saves_communication": all(
                r["total_comm"] < 0.95 * dense["total_comm"]
                for r in decayed),
            "const_keeps_penalty":
                rows[1]["steady_J"] > dense["steady_J"] * 1.3,
        },
    }
    if not smoke:
        assert all(payload["claims"].values()), payload["claims"]
    return payload
