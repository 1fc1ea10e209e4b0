"""The paper's linear-regression setup (§2, §4) and its closed-form
simulator, on torch.

The port of ``repro.core.regression``.  Data model (paper §4): x ~
N(0, Σ) with diagonal Σ, y = xᵀw* + η, η ~ N(0, σ²).  Closed forms:

    J(w)  = ½ 𝔼(y − xᵀw)²   = ½[(w−w*)ᵀ Σ (w−w*) + σ²]
    ∇J(w) = Σ (w − w*),      ∇²J = Σ,      J(w*) = σ²/2

Each round, each of the m agents draws N fresh samples, forms the
empirical gradient (eq. 7), evaluates its trigger, and the server
applies eq. (10).

**One batched program per frontier.**  A :class:`TriggerKnobs` value
(mode index, λ, μ, decay id — see ``MODES`` and ``DECAYS``) fixes one
operating point; ``(G,)`` knob tensors form a grid.  :func:`sweep` runs
the whole ``(G, T)`` grid × trials at once: the K rounds are a Python
loop over tensors of shape ``(G, T, m, …)``, every mode's gain is formed
and the grid point's own is picked by ``torch.where`` over its mode
index (where the JAX package's ``lax.switch`` picks it), and there is no
loop over grid points or trials.  Every grid point shares the same T
trials' batches, as in the JAX package, so frontiers are comparable
across points.

**Batches.**  Every random draw comes from an explicit
``torch.Generator`` on the problem's device; torch's streams differ from
``jax.random``'s, so the engine takes its per-round batches from a
*batch source*: a ``torch.Generator`` (one ``(T, m, N, n)`` draw per
round, never the whole run at once) or a callable ``k -> (xs, ys)``
(the parity tests pass the JAX-drawn batches that way).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.comm.triggers import _eps_terms, linreg_gain_exact
from repro_torch.configs.paper_linreg import LinRegConfig
from repro_torch.utils.device import DeviceLike, resolve_device

# k -> (xs, ys): round k's samples, (T, m, N, n) and (T, m, N) for a
# trial-batched run (sweep, run_many), (m, N, n) and (m, N) for one run
BatchSource = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]
Batches = Union[torch.Generator, BatchSource]


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
        """J of ``w (..., n)``, one value per leading index."""
        d = w - self.w_star
        return 0.5 * ((self.sigma_diag * d * d).sum(-1)
                      + self.noise_std ** 2)

    def J_star(self) -> float:
        return 0.5 * self.noise_std ** 2

    def grad_true(self, w: torch.Tensor) -> torch.Tensor:
        return self.sigma_diag * (w - self.w_star)

    def rho(self) -> float:
        """ρ = max_i (1 − ε λ_i(Σ))² — Thm 1's contraction factor."""
        return float(((1.0 - self.eps * self.sigma_diag) ** 2).max())

    def max_stable_eps(self) -> float:
        return float(2.0 / self.sigma_diag.max())


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


def _draw(problem: Problem, generator: torch.Generator, lead: Tuple[int, ...]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lead + (N, n)`` samples x ~ N(0, Σ) and their ``lead + (N,)``
    responses y = xᵀw* + η, drawn from ``generator`` on the device."""
    N, n, dev = problem.n_samples, problem.n, problem.device
    xs = torch.randn(lead + (N, n), generator=generator, device=dev) \
        * problem.sigma_diag.sqrt()
    ys = xs @ problem.w_star + problem.noise_std * torch.randn(
        lead + (N,), generator=generator, device=dev)
    return xs, ys


def sample_batch(problem: Problem, generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N fresh i.i.d. samples for one agent (eq. 4 + §4 Gaussian model):
    ``((N, n), (N,))``."""
    return _draw(problem, generator, ())


def agent_batches(problem: Problem, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's fresh samples for ALL agents, stacked on a leading
    agent axis: ``((m, N, n), (m, N))``."""
    return _draw(problem, generator, (problem.num_agents,))


def trial_batches(problem: Problem, generator: torch.Generator,
                  num_trials: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's fresh samples for every trial and agent:
    ``((T, m, N, n), (T, m, N))``."""
    return _draw(problem, generator, (num_trials, problem.num_agents))


def empirical_gradient(w: torch.Tensor, xs: torch.Tensor,
                       ys: torch.Tensor) -> torch.Tensor:
    """Eq. (7): g = (1/N) Σ (x xᵀ w − x y), for one agent's
    ``xs (N, n)``, ``ys (N,)``."""
    resid = xs @ w - ys
    return xs.T @ resid / xs.shape[0]


class RunResult(NamedTuple):
    J_traj: torch.Tensor   # (..., K+1) exact J(w_k) along the run
    alphas: torch.Tensor   # (..., K, m) transmit decisions
    gains: torch.Tensor    # (..., K, m) gains used by the trigger
    w_final: torch.Tensor  # (..., n)

    @property
    def total_comm(self) -> torch.Tensor:
        """Paper Fig-2-Left x-axis: Σ_k Σ_i α_k^i."""
        return self.alphas.sum((-2, -1))

    @property
    def total_any_tx(self) -> torch.Tensor:
        """Thm 2's LHS: Σ_k max_i α_k^i."""
        return self.alphas.amax(-1).sum(-1)


# ----------------------------------------------------------------------
# Trigger knobs — the sweep engine's grid coordinates
# ----------------------------------------------------------------------

# the mode index order (the JAX package's lax.switch branch order)
MODES: Tuple[str, ...] = (
    "gain_exact", "gain_estimated", "grad_norm", "always", "never"
)
DECAYS: Tuple[str, ...] = ("const", "inv_t", "geometric")


class TriggerKnobs(NamedTuple):
    """One simulator operating point as tensors (on the CPU until the
    engine moves them): 0-dim for a single run (:func:`run_knobs`),
    ``(G,)`` for a sweep grid (:func:`sweep`).  ``mode`` indexes
    ``MODES``, ``decay`` indexes ``DECAYS``; ``lam``/``mu`` are the
    thresholds (the one the selected mode ignores is unused)."""

    mode: torch.Tensor   # int32 index into MODES
    lam: torch.Tensor    # f32 gain threshold λ
    mu: torch.Tensor     # f32 grad-norm threshold μ
    decay: torch.Tensor  # int32 index into DECAYS (λ schedule)


def make_knobs(mode: str = "gain_estimated", lam: float = 0.0,
               mu: float = 0.0, lam_decay: str = "const") -> TriggerKnobs:
    """Scalar knobs from the string/float arguments."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if lam_decay not in DECAYS:
        raise ValueError(f"unknown lam_decay {lam_decay!r}")
    return TriggerKnobs(
        mode=torch.tensor(MODES.index(mode), dtype=torch.int32),
        lam=torch.tensor(lam, dtype=torch.float32),
        mu=torch.tensor(mu, dtype=torch.float32),
        decay=torch.tensor(DECAYS.index(lam_decay), dtype=torch.int32),
    )


def grid_from_points(points: Sequence[dict]) -> TriggerKnobs:
    """Stack per-point ``make_knobs`` kwargs into a ``(G,)`` grid."""
    if not points:
        raise ValueError("empty sweep grid")
    knobs = [make_knobs(**p) for p in points]
    return TriggerKnobs(*(torch.stack(x) for x in zip(*knobs)))


def grid_from_specs(specs: Sequence) -> TriggerKnobs:
    """A grid from policy specs (trigger-only, like :func:`run`)."""
    return grid_from_points([_policy_to_sim_args(s) for s in specs])


def lambda_grid(lams: Sequence[float], mode: str = "gain_estimated",
                lam_decay: str = "const") -> TriggerKnobs:
    """The Fig-2-Left axis: one grid point per λ."""
    return grid_from_points(
        [dict(mode=mode, lam=float(v), lam_decay=lam_decay) for v in lams]
    )


def mu_grid(mus: Sequence[float]) -> TriggerKnobs:
    """The grad-norm baseline axis: one grid point per μ."""
    return grid_from_points([dict(mode="grad_norm", mu=float(m)) for m in mus])


def grid_concat(*grids: TriggerKnobs) -> TriggerKnobs:
    """Concatenate sweep grids (e.g. a λ family next to a μ family)."""
    return TriggerKnobs(*(torch.cat(x) for x in zip(*grids)))


def _policy_to_sim_args(policy):
    """A CommPolicy (or spec string) → this simulator's closed-form knobs.

    The simulator keeps the paper's O(Nn) closed forms instead of the
    generic trigger functions, so only the linreg-expressible triggers
    are accepted; compressor stages are rejected (use the train-step API
    for compressed wire formats)."""
    from repro_torch.comm import CommPolicy, spec_is_adaptive

    pol = CommPolicy.parse_one(policy)
    if pol.compressors or pol.error_feedback:
        raise ValueError(
            f"the regression simulator models the trigger only; policy "
            f"{pol} carries compressor/EF stages — use "
            f"repro_torch.core.api.make_triggered_train_step for those"
        )
    t = pol.trigger
    if spec_is_adaptive(t):
        raise ValueError(
            f"trigger {t.name!r} is a closed-loop budget controller: it "
            f"carries per-agent state the closed-form simulator does not "
            f"model — use repro_torch.core.api.make_triggered_train_step "
            f"for adaptive policies"
        )
    if t.name not in MODES:
        raise ValueError(f"trigger {t.name!r} not supported by the simulator")
    if t.arg("decay_rate") is not None:
        raise ValueError(
            "the simulator's geometric schedule uses the paper's rate "
            "λ·ρ^k (ρ from the problem); an explicit decay_rate is only "
            "honoured by the train-step API"
        )
    return dict(
        mode=t.name,
        lam=float(t.arg("lam", 0.0)),
        mu=float(t.arg("mu", 0.0)),
        lam_decay=t.arg("decay", "const"),
    )


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------

def _source(problem: Problem, batches: Batches,
            num_trials: Optional[int]) -> BatchSource:
    """A batch source with a trial axis: a Generator draws
    ``(T, m, N, n)`` per round; a callable for one run (``num_trials``
    None) gets a trial axis of 1 added."""
    if isinstance(batches, torch.Generator):
        return lambda k: trial_batches(problem, batches, num_trials or 1)
    if not callable(batches):
        raise TypeError(f"batches must be a torch.Generator or a callable "
                        f"k -> (xs, ys), got {type(batches).__name__}")
    if num_trials is None:
        return lambda k: tuple(x[None] for x in batches(k))
    return batches


def _simulate(problem: Problem, source: BatchSource, steps: int,
              grid: TriggerKnobs, num_trials: int,
              w0: Optional[torch.Tensor]) -> RunResult:
    """Eq. (10) + (11) for ``steps`` rounds over a ``(G,)`` grid and the
    source's ``num_trials`` trials: leaves ``(G, T, ...)``."""
    dev = problem.device
    eps = problem.eps
    e, half_e2 = _eps_terms(eps)
    mode, lam, mu, decay = (x.to(dev) for x in grid)
    # per grid point, broadcast over (T, m)
    mode, mu = mode[:, None, None], mu[:, None, None]
    # Thm 1's ρ, for the paper's geometric schedule λ·ρ^k
    rho = ((1.0 - eps * problem.sigma_diag) ** 2).max()
    sigma_full = torch.diag(problem.sigma_diag)
    n, N = problem.n, problem.n_samples
    w0 = (torch.zeros(n, dtype=torch.float32, device=dev) if w0 is None
          else w0.to(dev, torch.float32))
    w = w0.expand(mode.shape[0], num_trials, n)
    Js, alphas, gains = [problem.J(w)], [], []
    for k in range(steps):
        xs, ys = source(k)                       # (T, m, N, n), (T, m, N)
        kf = float(k)
        lam_k = torch.where(decay == 0, lam,
                            torch.where(decay == 1, lam / (1.0 + kf),
                                        lam * rho ** kf))[:, None, None]
        # eq. (7) per (grid point, trial, agent): (G, T, m, n)
        resid = torch.einsum("tinj,gtj->gtin", xs, w) - ys
        g = torch.einsum("tinj,gtin->gtij", xs, resid) / N
        # every mode's gain; the grid point's mode picks its own
        exact = linreg_gain_exact(w[:, :, None], g, eps, sigma_full,
                                  problem.w_star)
        xg = torch.einsum("tinj,gtij->gtin", xs, g)
        estimated = ((-e * g) * g).sum(-1) + half_e2 * (xg * xg).mean(-1)
        gsq = (g * g).sum(-1)
        zero = torch.zeros_like(gsq)
        gain = torch.where(mode == 0, exact, torch.where(
            mode == 1, estimated, torch.where(mode == 2, -e * gsq, zero)))
        alpha = torch.where(mode <= 1, gain <= -lam_k, torch.where(
            mode == 2, gsq >= mu, mode == 3)).float()
        # eq. (10): the mean over transmitting agents, a hold if none
        denom = torch.clamp(alpha.sum(-1), min=1.0)[..., None]
        w = w - eps * (alpha[..., None] * g).sum(-2) / denom
        Js.append(problem.J(w))
        alphas.append(alpha)
        gains.append(gain)
    return RunResult(J_traj=torch.stack(Js, -1), alphas=torch.stack(alphas, 2),
                     gains=torch.stack(gains, 2), w_final=w)


def _point(knobs: TriggerKnobs) -> TriggerKnobs:
    """Scalar knobs as a one-point grid."""
    return TriggerKnobs(*(torch.as_tensor(x).reshape(1) for x in knobs))


def run(problem: Problem, batches: Batches, steps: int,
        mode: str = "gain_estimated", lam: float = 0.0, mu: float = 0.0,
        w0: Optional[torch.Tensor] = None, lam_decay: str = "const",
        policy=None) -> RunResult:
    """Simulate eq. (10)+(11) for ``steps`` rounds.

    batches: a ``torch.Generator`` on the problem's device, or a
          callable ``k -> (xs (m, N, n), ys (m, N))``.
    policy: a spec string (e.g. ``"gain_estimated(lam=0.3)"``) or
          CommPolicy; supersedes mode/lam/mu/lam_decay when given.
    mode: gain_exact (11+28) | gain_estimated (11+30) | grad_norm (31) |
          always (plain synchronous SGD) | never.
    lam_decay: "const" | "inv_t" (λ_k = λ/(k+1)) | "geometric"
          (λ_k = λ·ρ^k).
    """
    if policy is not None:
        sim = _policy_to_sim_args(policy)
        mode, lam, mu, lam_decay = (
            sim["mode"], sim["lam"], sim["mu"], sim["lam_decay"]
        )
    return run_knobs(problem, batches, steps,
                     make_knobs(mode, lam, mu, lam_decay), w0=w0)


def run_knobs(problem: Problem, batches: Batches, steps: int,
              knobs: TriggerKnobs,
              w0: Optional[torch.Tensor] = None) -> RunResult:
    """:func:`run` at scalar knobs: leaves ``J_traj (K+1,)``,
    ``alphas/gains (K, m)``, ``w_final (n,)``."""
    res = _simulate(problem, _source(problem, batches, None), int(steps),
                    _point(knobs), 1, w0)
    return RunResult(*(x[0, 0] for x in res))


def run_many(problem: Problem, batches: Batches, steps: int,
             num_trials: int, **kw) -> RunResult:
    """Monte-Carlo :func:`run` over ``num_trials`` trials (one batched
    program): leaves gain a leading trial axis.  A callable source gives
    ``(T, m, N, n)`` per round."""
    w0 = kw.pop("w0", None)
    policy = kw.pop("policy", None)
    if policy is not None:
        kw = _policy_to_sim_args(policy)
    res = _simulate(problem, _source(problem, batches, num_trials),
                    int(steps), _point(make_knobs(**kw)), num_trials, w0)
    return RunResult(*(x[0] for x in res))


def sweep(problem: Problem, batches: Batches, steps: int,
          grid: TriggerKnobs, num_trials: int) -> RunResult:
    """One batched program for an entire frontier.

    ``grid`` carries ``(G,)`` knob tensors; every grid point runs on the
    SAME ``num_trials`` trials' batches.  Returns a :class:`RunResult`
    whose leaves have leading ``(G, trial)`` axes: ``J_traj (G,T,K+1)``,
    ``alphas/gains (G,T,K,m)``, ``w_final (G,T,n)``.
    """
    return _simulate(problem, _source(problem, batches, num_trials),
                     int(steps), grid, num_trials, None)


def frontier(res: RunResult):
    """Per-point frontier coordinates: (mean final J, mean total comm
    Σ_k Σ_i α, mean any-tx Σ_k max_i α), each a mean over trials."""
    J = res.J_traj[..., -1].mean(-1)
    comm = res.alphas.sum((-2, -1)).mean(-1)
    any_tx = res.alphas.amax(-1).sum(-1).mean(-1)
    return J, comm, any_tx


def lambda_sweep(problem: Problem, batches: Batches, steps: int, lams,
                 num_trials: int, mode: str = "gain_estimated"):
    """Fig 2 (Left): mean final J and mean total comm per λ."""
    return frontier(sweep(problem, batches, steps,
                          lambda_grid(lams, mode=mode), num_trials))


def mu_sweep(problem: Problem, batches: Batches, steps: int, mus,
             num_trials: int):
    """Grad-norm baseline sweep (Fig 1 Right comparison axis)."""
    J, comm, _ = frontier(sweep(problem, batches, steps, mu_grid(mus),
                                num_trials))
    return J, comm


