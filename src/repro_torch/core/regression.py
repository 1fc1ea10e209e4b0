"""The paper's linear-regression setup (§2, §4), drawn with torch.

The port of ``repro.core.regression``'s problem and data model: x ~
N(0, Σ) with diagonal Σ, y = xᵀw* + η, η ~ N(0, σ²).  Every random draw
comes from an explicit ``torch.Generator`` on the problem's device
(torch's streams differ from ``jax.random``'s, so parity tests carry the
JAX-drawn problem and batches across with :mod:`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.configs.paper_linreg import LinRegConfig
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.todo import not_ported


@dataclasses.dataclass(frozen=True)
class Problem:
    """A concrete linreg instance (distribution known to the oracle)."""

    sigma_diag: torch.Tensor  # diag(𝔼xxᵀ), shape (n,)
    w_star: torch.Tensor      # true weights, shape (n,)
    noise_std: float
    eps: float                # SGD stepsize ε
    n_samples: int            # N per agent per iteration
    num_agents: int           # m

    @property
    def n(self) -> int:
        return int(self.w_star.shape[0])

    @property
    def device(self) -> torch.device:
        return self.w_star.device

    def J(self, w: torch.Tensor) -> torch.Tensor:
        d = w - self.w_star
        return 0.5 * ((self.sigma_diag * d * d).sum() + self.noise_std ** 2)

    def J_star(self) -> float:
        return 0.5 * self.noise_std ** 2

    def grad_true(self, w: torch.Tensor) -> torch.Tensor:
        return self.sigma_diag * (w - self.w_star)


def make_problem(cfg: LinRegConfig, generator: torch.Generator, *,
                 device: DeviceLike = "cuda") -> Problem:
    """Build a Problem from a paper config; its random parts are drawn
    from ``generator``, which must live on ``device``."""
    dev = resolve_device(device)
    if cfg.cov_diag:
        sigma = torch.tensor(cfg.cov_diag, dtype=torch.float32, device=dev)
    else:
        lo, hi = cfg.cov_range
        sigma = lo + (hi - lo) * torch.rand(
            cfg.n, generator=generator, device=dev)
    if cfg.w_star:
        w_star = torch.tensor(cfg.w_star, dtype=torch.float32, device=dev)
    else:
        w_star = 3.0 * torch.randn(cfg.n, generator=generator, device=dev)
    return Problem(
        sigma_diag=sigma,
        w_star=w_star,
        noise_std=cfg.noise_std,
        eps=cfg.stepsize,
        n_samples=cfg.samples_per_agent,
        num_agents=cfg.num_agents,
    )


def agent_batches(problem: Problem, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's fresh samples for ALL agents, stacked on a leading
    agent axis: ``((m, N, n), (m, N))``."""
    m, N, n = problem.num_agents, problem.n_samples, problem.n
    dev = problem.device
    xs = torch.randn((m, N, n), generator=generator, device=dev) \
        * problem.sigma_diag.sqrt()
    ys = xs @ problem.w_star + problem.noise_std * torch.randn(
        (m, N), generator=generator, device=dev)
    return xs, ys


__getattr__ = not_ported(__name__, {
    name: "queue 1 item 3"
    for name in ("sample_batch", "empirical_gradient", "RunResult",
                 "TriggerKnobs", "MODES", "DECAYS", "make_knobs",
                 "grid_from_points", "grid_from_specs", "lambda_grid",
                 "mu_grid", "grid_concat", "run", "run_knobs", "run_many",
                 "sweep", "frontier", "lambda_sweep", "mu_sweep")
})
