"""The port's closed-form simulator, theory and figure drivers against
the JAX package, on the CPU.

The JAX engine draws its batches inside its compiled scan (threefry);
the port's engine takes them from a batch source.  So every comparison
here passes the JAX-drawn batches in — for a run, round k's batch of
``split(key, steps)[k]`` split over the m agents, and for a sweep or
``run_many`` the same per trial of ``split(key, T)`` — on the JAX
package's problem, carried across by ``convert.problem_from_jax``.

Tolerances (ROADMAP's parity contract):

* decisions (``alphas``) exactly, except a decision whose gain lies
  within ``1e-5`` (relative) of its threshold: the run is then compared
  only up to that round;
* ``J_traj`` and ``w_final`` within ``rtol = 1e-5, atol = 1e-6``;
* ``gains`` within ``rtol = 1e-5`` and ``atol = 1e-5 · max|gain|`` of
  the run: a gain is a difference of two terms of ε‖g‖²'s size
  (−ε gᵀ∇J against ½ε² gᵀΣg), and where they nearly cancel, the
  packages' other summation orders leave rounding of the terms' size;
* ``core/theory.py`` within ``rtol = 1e-6``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_linreg import FIG1_RIGHT, FIG2_LEFT
from repro.core import regression as JR
from repro.core import theory as JT
from repro_torch import convert
from repro_torch.core import regression as R
from repro_torch.core import theory as T
from repro_torch.figures import FIGURES

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TRIALS = 8
CONFIGS = {"fig2_left": (FIG2_LEFT, 0), "fig1_right": (FIG1_RIGHT, 10)}


def _problems(name):
    cfg, seed = CONFIGS[name]
    jp = JR.make_problem(cfg, jax.random.key(seed))
    return cfg, jp, convert.problem_from_jax(jax.device_get(jp),
                                             device="cpu")


def _jax_run_batches(jp, key, steps):
    """The batches JAX's ``run_knobs`` draws: ``(K, m, N, n)``, ``(K, m, N)``."""
    def per_step(k):
        keys = jax.random.split(k, jp.num_agents)
        return jax.vmap(lambda k_: JR.sample_batch(jp, k_))(keys)

    return jax.vmap(per_step)(jax.random.split(key, steps))


def _run_source(jp, key, steps):
    xs, ys = (torch.from_numpy(np.array(x)) for x in jax.device_get(
        _jax_run_batches(jp, key, steps)))
    return lambda k: (xs[k], ys[k])


def _trial_source(jp, key, steps, trials):
    """The batches of JAX's ``sweep``/``run_many``: per trial key of
    ``split(key, T)``, that trial's run batches; ``k -> (T, m, N, n)``."""
    xs, ys = (torch.from_numpy(np.array(x)) for x in jax.device_get(
        jax.vmap(lambda k: _jax_run_batches(jp, k, steps))(
            jax.random.split(key, trials))))
    return lambda k: (xs[:, k], ys[:, k])


def _thresholds(knobs, problem, steps):
    """Each run's per-round threshold in gain units ``(..., K)``: −λ_k
    for the gain modes, −ε·μ for grad_norm (its gain is −ε‖g‖²)."""
    mode, lam, mu, decay = (np.asarray(x, np.float64)[..., None]
                            for x in knobs)
    k = np.arange(steps, dtype=np.float64)
    rho = float(((1.0 - problem.eps * np.asarray(problem.sigma_diag)) ** 2)
                .max())
    lam_k = np.where(decay == 0, lam,
                     np.where(decay == 1, lam / (1 + k), lam * rho ** k))
    return np.where(mode == 2, -problem.eps * mu, -lam_k)


def _check(got: R.RunResult, want, thresholds) -> int:
    """Hold a port result to a JAX one run by run (leading axes alike;
    ``thresholds`` broadcasts to them and the rounds); returns the number
    of runs cut at a near-threshold decision."""
    want = R.RunResult(*(np.asarray(x) for x in want))
    got = R.RunResult(*(x.numpy() for x in got))
    lead, K = want.alphas.shape[:-2], want.alphas.shape[-2]
    thr = np.broadcast_to(thresholds, lead + (K,))
    cut = 0
    for idx in np.ndindex(*lead):
        ga, wa = got.alphas[idx], want.alphas[idx]
        rounds = K
        if not np.array_equal(ga, wa):
            k, i = np.argwhere(ga != wa)[0]
            t = thr[idx][k]
            gain = want.gains[idx][k, i]
            assert abs(gain - t) <= RTOL * max(1.0, abs(t)), (
                f"run {idx}: decision differs at round {k}, agent {i}, "
                f"gain {gain} far from its threshold {t}")
            np.testing.assert_array_equal(ga[:k], wa[:k])
            rounds, cut = k, cut + 1
        gw = want.gains[idx][:rounds]
        np.testing.assert_allclose(
            got.gains[idx][:rounds], gw, rtol=RTOL,
            atol=RTOL * float(np.abs(gw).max(initial=0.0)), err_msg=str(idx))
        np.testing.assert_allclose(got.J_traj[idx][:rounds + 1],
                                   want.J_traj[idx][:rounds + 1],
                                   rtol=RTOL, atol=ATOL, err_msg=str(idx))
        if rounds == K:
            np.testing.assert_allclose(got.w_final[idx], want.w_final[idx],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=str(idx))
    return cut


# ----------------------------------------------------------------------
# run_knobs over every mode and decay, and the sweep family
# ----------------------------------------------------------------------

ALL_POINTS = [dict(mode=m, lam=(0.4 if m == "gain_estimated" else 1.0),
                   mu=3.0, lam_decay=d)
              for m in R.MODES for d in R.DECAYS]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_knobs_every_mode_and_decay_matches_jax(name):
    cfg, jp, tp = _problems(name)
    key = jax.random.key(7)
    jgrid = JR.grid_from_points(ALL_POINTS)
    # JAX's run_knobs at every point (vmapped: one trace for all 15)
    want = jax.device_get(jax.vmap(
        lambda kn: JR.run_knobs(jp, key, cfg.steps, kn))(jgrid))
    source = _run_source(jp, key, cfg.steps)
    got = [R.run_knobs(tp, source, cfg.steps, R.make_knobs(**p))
           for p in ALL_POINTS]
    got = R.RunResult(*(torch.stack(x) for x in zip(*got)))
    assert got.J_traj.shape == (len(ALL_POINTS), cfg.steps + 1)
    assert got.alphas.shape == (len(ALL_POINTS), cfg.steps, cfg.num_agents)
    _check(got, want, _thresholds(jgrid, tp, cfg.steps))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sweep_frontier_and_wrappers_match_jax(name):
    cfg, jp, tp = _problems(name)
    key = jax.random.key(3)
    source = _trial_source(jp, key, cfg.steps, TRIALS)
    lams, mus = [0.0, 0.1, 0.4, 1.6], [1.0, 10.0]
    jgrid = JR.grid_concat(JR.lambda_grid(lams),
                           JR.lambda_grid(lams, mode="gain_exact",
                                          lam_decay="inv_t"),
                           JR.mu_grid(mus))
    tgrid = R.grid_concat(R.lambda_grid(lams),
                          R.lambda_grid(lams, mode="gain_exact",
                                        lam_decay="inv_t"),
                          R.mu_grid(mus))
    want = jax.device_get(JR.sweep(jp, key, cfg.steps, jgrid, TRIALS))
    got = R.sweep(tp, source, cfg.steps, tgrid, TRIALS)
    assert got.alphas.shape == (len(tgrid.mode), TRIALS, cfg.steps,
                                cfg.num_agents)
    thr = _thresholds(jgrid, tp, cfg.steps)[:, None]
    assert _check(got, want, thr) == 0
    for a, b in zip(R.frontier(got), JR.frontier(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    # the wrappers: JAX's lambda_sweep / mu_sweep are the frontiers of
    # its sweep over their grid families, which are sub-grids of the one
    # above (grid points are independent under its vmap)
    part = lambda rows: JR.RunResult(*(x[rows] for x in want))
    L = len(lams)
    for a, b in zip(R.lambda_sweep(tp, source, cfg.steps, lams, TRIALS),
                    JR.frontier(part(slice(0, L)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for a, b in zip(R.mu_sweep(tp, source, cfg.steps, mus, TRIALS),
                    JR.frontier(part(slice(2 * L, None)))[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_many_and_run_match_jax(name):
    cfg, jp, tp = _problems(name)
    key = jax.random.key(5)
    policy = "gain_estimated(lam=0.2)"
    want = jax.device_get(JR.run_many(jp, key, cfg.steps, TRIALS,
                                      policy=policy))
    got = R.run_many(tp, _trial_source(jp, key, cfg.steps, TRIALS),
                     cfg.steps, TRIALS, policy=policy)
    assert got.J_traj.shape == (TRIALS, cfg.steps + 1)
    thr = np.full((cfg.steps,), -0.2)
    _check(got, want, thr)
    np.testing.assert_array_equal(got.total_comm.numpy(),
                                  np.asarray(want.alphas).sum((1, 2)))
    # one run with w0 and the knob arguments
    w0 = np.linspace(-1, 1, cfg.n).astype(np.float32)
    want = jax.device_get(JR.run(jp, key, cfg.steps, mode="grad_norm",
                                 mu=2.0, w0=jnp.asarray(w0)))
    got = R.run(tp, _run_source(jp, key, cfg.steps), cfg.steps,
                mode="grad_norm", mu=2.0, w0=torch.from_numpy(w0))
    _check(got, want, np.full((cfg.steps,), -tp.eps * 2.0))
    assert float(got.total_comm) == float(np.asarray(want.total_comm))
    assert float(got.total_any_tx) == float(np.asarray(want.total_any_tx))


def test_generator_source_draws_per_round_and_runs_on_its_problem():
    """The default batch source: a Generator, one ``(T, m, N, n)`` draw
    per round (the same stream gives the same run)."""
    cfg, _, tp = _problems("fig2_left")
    calls = []
    draw = R.trial_batches

    def spy(problem, gen, trials):
        calls.append(trials)
        return draw(problem, gen, trials)

    R.trial_batches = spy
    try:
        a = R.sweep(tp, torch.Generator().manual_seed(3), cfg.steps,
                    R.lambda_grid([0.0, 1.0]), 4)
    finally:
        R.trial_batches = draw
    assert calls == [4] * cfg.steps
    b = R.sweep(tp, torch.Generator().manual_seed(3), cfg.steps,
                R.lambda_grid([0.0, 1.0]), 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    xs, ys = R.sample_batch(tp, torch.Generator().manual_seed(0))
    assert xs.shape == (tp.n_samples, tp.n) and ys.shape == (tp.n_samples,)


def test_empirical_gradient_matches_jax():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((7, 3)).astype(np.float32)
    ys = rng.standard_normal(7).astype(np.float32)
    w = rng.standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(
        R.empirical_gradient(*(torch.from_numpy(a) for a in (w, xs, ys))),
        np.asarray(JR.empirical_gradient(w, xs, ys)), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# grids and the policy bridge
# ----------------------------------------------------------------------

def test_grid_builders_match_jax():
    pairs = [
        (R.make_knobs("grad_norm", mu=2.5), JR.make_knobs("grad_norm", mu=2.5)),
        (R.lambda_grid([0.1, 0.2], mode="gain_exact", lam_decay="geometric"),
         JR.lambda_grid([0.1, 0.2], mode="gain_exact",
                        lam_decay="geometric")),
        (R.mu_grid([1.0, 3.0]), JR.mu_grid([1.0, 3.0])),
        (R.grid_concat(R.lambda_grid([0.5]), R.mu_grid([4.0])),
         JR.grid_concat(JR.lambda_grid([0.5]), JR.mu_grid([4.0]))),
        (R.grid_from_specs(["always", "gain_exact(lam=2.0,decay=inv_t)",
                            "grad_norm(mu=3.0)"]),
         JR.grid_from_specs(["always", "gain_exact(lam=2.0,decay=inv_t)",
                             "grad_norm(mu=3.0)"])),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
    assert R.MODES == JR.MODES and R.DECAYS == JR.DECAYS
    for bad in (dict(mode="warp"), dict(lam_decay="cubic")):
        with pytest.raises(ValueError, match="unknown"):
            R.make_knobs(**bad)
    with pytest.raises(ValueError, match="empty sweep grid"):
        R.grid_from_points([])


@pytest.mark.parametrize("spec,match", [
    ("budget_dual(rate=0.5)", "closed-loop budget controller"),
    ("gain_estimated(lam=0.1)|int8", "models the trigger only"),
    ("gain_lookahead(lam=0.1)", "not supported by the simulator"),
    ("gain_exact(lam=0.1,decay=geometric,decay_rate=0.9)",
     "explicit decay_rate"),
])
def test_policy_to_sim_args_rejections_match_jax(spec, match):
    with pytest.raises(ValueError, match=match):
        JR._policy_to_sim_args(spec)
    with pytest.raises(ValueError, match=match):
        R._policy_to_sim_args(spec)


def test_policy_to_sim_args_accepts_what_jax_accepts():
    for spec in ("gain_exact(lam=2.0,decay=inv_t)", "grad_norm(mu=3.0)",
                 "always", "never", "gain_estimated(0.3)"):
        assert R._policy_to_sim_args(spec) == JR._policy_to_sim_args(spec)


# ----------------------------------------------------------------------
# theory
# ----------------------------------------------------------------------

def test_theory_matches_jax():
    sig = [3.0, 1.0, 0.5]
    w, ws = [0.0, 0.5, -1.0], [3.0, 5.0, 1.0]
    eps, lam, N = 0.1, 0.3, 12
    silence = np.linspace(0.1, 0.6, N).astype(np.float32)
    trg = T.gradient_covariance_trace(sig, w, ws, 1.0, 5)
    jtrg = JT.gradient_covariance_trace(jnp.asarray(sig), jnp.asarray(w),
                                        jnp.asarray(ws), 1.0, 5)
    pairs = [
        (T.rho(eps, sig), JT.rho(eps, sig)),
        (trg, jtrg),
        (T.thm1_bound(40.0, 0.5, eps, sig, float(trg), lam, 0.25, N),
         JT.thm1_bound(40.0, 0.5, eps, sig, float(jtrg), lam, 0.25, N)),
        (T.thm1_bound(40.0, 0.5, eps, sig, float(trg), lam,
                      torch.from_numpy(silence), N),
         JT.thm1_bound(40.0, 0.5, eps, sig, float(jtrg), lam, silence, N)),
        (T.steady_state_bound(0.5, eps, sig, float(trg), lam),
         JT.steady_state_bound(0.5, eps, sig, float(jtrg), lam)),
        (torch.tensor(T.thm2_comm_bound(40.0, 0.5, lam)),
         JT.thm2_comm_bound(40.0, 0.5, lam)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert T.stable_eps_range(sig) == JT.stable_eps_range(sig)


# ----------------------------------------------------------------------
# the figure drivers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", FIGURES)
def test_figure_driver_smoke_on_cpu(name):
    """Each driver at ``smoke=True`` on the CPU: its payload has the
    JAX script's shape (the same claim keys), with finite numbers."""
    mod = importlib.import_module(f"repro_torch.figures.{name}")
    payload = mod.run(device="cpu", smoke=True)
    keys = {"fig1_right": {"gain_curve", "grad_norm_curve", "per_budget",
                           "per_seed", "claims"},
            "fig2_left": {"rows", "claims"},
            "fig2_right": {"rows", "claims"},
            "lambda_decay": {"rows", "claims"},
            "theory_bounds": {"rows", "all_bounds_hold"}}[name]
    assert keys <= payload.keys()
    flat = [v for r in payload.get("rows", []) for v in r.values()
            if isinstance(v, float)]
    assert all(np.isfinite(flat))
    if name == "theory_bounds":
        assert all(r["thm2_holds_as"] for r in payload["rows"])
    if name == "fig1_right":
        # the claims are the medians over the JAX seed and the nine after
        seeds = payload["per_seed"]
        assert [r["problem_seed"] for r in seeds] == list(range(10, 20))
        assert payload["claims"]["low_budget_J_ratio"] == np.median(
            [r["low_budget_J_ratio"] for r in seeds])
