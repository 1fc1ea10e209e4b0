"""The port's batched frontier (``repro_torch.core.frontier``) and the
drifting target (``repro_torch.data.synthetic``) against the JAX
package, on the CPU.

Contract (ROADMAP's): floats within ``rtol=1e-5, atol=1e-6``; decisions,
deliveries, staleness and ``num_tx`` exactly.  Where the JAX engine
draws its batches inside its scan (``split(key, steps)``), the port
takes the same JAX-drawn batches through a round-indexed ``batch_fn``.

* the cases of tests/test_frontier.py: one lane against the plain step
  loop (with and without controller rows), ``scale`` as the λ axis, the
  None controller slot, shapes and ``frontier_curve``, the argument
  checks, the toy tier mix; in place of JAX's one-compile test, a
  counting loss shows the loss traced once per round for any grid;
* ``run_frontier`` against JAX ``run_frontier`` on every dispatch path,
  with and without ``chan_scales``;
* the channel axis (tests/test_net.py:327-380,
  tests/test_async_net.py:119, 226, 322), the adaptive mix
  (tests/test_adaptive.py:211), and the two frontier cells of
  tests/test_dispatch_differential.py against JAX ``unroll``;
* ``drifting_problem`` / ``drifting_batch_fn`` against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import regression as JR
from repro.core.frontier import budget_scales as jbudget_scales
from repro.core.frontier import run_frontier as jrun_frontier
from repro.data.synthetic import drifting_problem as jdrifting_problem
from repro.optim import optimizers as jopt_lib
from repro_torch import convert
from repro_torch.comm import CTRL_WIDTH, CommPolicy
from repro_torch.comm.compressors import _f32_bits
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_linreg import (
    HETERO_M8,
    HETERO_M8_NET,
    TIERED_M64,
    LinRegConfig,
    TieredNetwork,
    _lossy,
    _tiers,
)
from repro_torch.core import regression as R
from repro_torch.core.api import (
    DISPATCH_MODES,
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.core.frontier import (
    FrontierResult,
    budget_scales,
    frontier_curve,
    make_frontier_step,
    run_frontier,
    stack_states,
)
from repro_torch.data.synthetic import (
    drifting_batch_fn,
    drifting_problem,
    step_generator,
)
from repro_torch.optim import optimizers as opt_lib
from test_torch_fleet import jloss, tloss

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
EXACT_KEYS = ("agent_tx", "num_tx", "any_tx", "agent_delivered",
              "agent_staleness", "agent_active", "num_active")
TOY = LinRegConfig(name="toy", n=6, num_agents=4, samples_per_agent=8,
                   stepsize=0.1, steps=6)
TOY64 = LinRegConfig(name="toy64", n=6, num_agents=64, samples_per_agent=8,
                     stepsize=0.1, steps=2)
STEPS = 6
MIXED_M4 = ("always",
            "gain_lookahead(lam=1.0)|fp16",
            "gain_lookahead(lam=2.0)|int8+ef",
            "gain_lookahead(lam=4.0)|topk(0.5)|int8+ef")


@pytest.fixture(scope="module")
def jproblem():
    return JR.make_problem(TOY, jax.random.key(0))


@pytest.fixture(scope="module")
def problem():
    return R.make_problem(TOY, step_generator(0, 0, "cpu"), device="cpu")


def _params():
    return {"w": torch.zeros(TOY.n)}


def _cfg(comm, num_agents=TOY.num_agents, lr=TOY.stepsize):
    return TrainConfig(lr=lr, optimizer="sgd", num_agents=num_agents,
                       comm=comm)


def _batches(problem, steps=STEPS, seed=7):
    return [R.agent_batches(problem, step_generator(seed, k, "cpu"))
            for k in range(steps)]


def _frontier(cfg, batches, scales, **kw):
    return run_frontier(tloss, opt_lib.from_config(cfg), cfg, _params(),
                        scales=scales, steps=len(batches),
                        batch_fn=lambda k: batches[k], device="cpu", **kw)


def _plain_loop(cfg, batches, scale=None):
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(
        tloss, opt, cfg, device="cpu",
        options=StepOptions(agent_metrics=True))
    state = init_train_state(_params(), opt, cfg, device="cpu")
    hist = []
    for batch in batches:
        args = (state, batch) if scale is None else (state, batch, scale)
        state, m = step(*args)
        hist.append(convert.to_numpy(m))
    return state, hist


def _leaves(tree):
    return jax.tree_util.tree_leaves(convert.to_numpy(tree))


def _tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


def _lane(state, g):
    return type(state)(state.step, *(
        None if f is None else jax.tree_util.tree_map(lambda x: x[g], f)
        for f in state[1:]))


def _assert_metrics(got, want, tag=""):
    """``(G, K, ...)`` (or per-round) metric dicts under the contract."""
    assert set(got) == set(want), tag
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (tag, k, a.shape, b.shape)
        if k in EXACT_KEYS:
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}:{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag}:{k}")


def _wire_steps(comm, buf):
    """Each agent's rounding step of its wire format at each slot of a
    delay line ``buf`` ``(..., A, L, n)``: the port's ``spacing`` of the
    agent's chain at the slot's largest entry (one int8 level, an fp16
    ULP; 0 uncompressed), shaped ``(..., A, L, 1)``."""
    A, n = buf.shape[-3], buf.shape[-1]
    specs = (comm,) * A if isinstance(comm, str) else comm
    return np.stack([CommPolicy.parse(p).chain().spacing(
        torch.from_numpy(np.ascontiguousarray(buf[..., i, :, :]).reshape(
            -1, n))).amax(-1).numpy().reshape(buf.shape[:-3] + (-1,))
        for i, p in enumerate(specs)], -2)[..., None]


def _assert_states(got, want, tag="", comm=None):
    """Two TrainStates (stacked or not) under the contract.  EF memory
    carries the gradient's rounding: it is held to RTOL of each agent's
    ``max|g + ef|`` (ROADMAP §3), of which ``254·max|ef|`` is a lower
    bound (an int8 residual is at most half a level, 1/254 of it).  A
    delay line's buffered payloads may sit one rounding step of their
    agent's wire format apart (``comm``'s, at the slot's largest
    element: ``_wire_steps``), where an element fell on a rounding
    boundary (ROADMAP §3: the JAX paths split there too)."""
    for field in ("step", "params", "opt_state", "ctrl_state"):
        la = _leaves(getattr(got, field))
        lb = _leaves(getattr(want, field))
        assert len(la) == len(lb), (tag, field)
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag}:{field}")
    a_net, b_net = (convert.to_numpy(x.net_state) for x in (got, want))
    assert (a_net is None) == (b_net is None), tag
    if isinstance(b_net, tuple):
        a_rows, a_line = a_net
        b_rows, b_line = b_net
        for a, b in ((a_rows, b_rows), (a_line["meta"], b_line["meta"])):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag}:net_state")
        a, b = a_line["buf"]["w"], np.asarray(b_line["buf"]["w"])
        step = _wire_steps(comm, b)
        assert np.all(np.abs(a - b) <= ATOL + RTOL * np.abs(b) + step), (
            tag, "delay line", np.abs(a - b).max())
    elif b_net is not None:
        np.testing.assert_allclose(a_net, b_net, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag}:net_state")
    assert (got.ef_memory is None) == (want.ef_memory is None), tag
    for a, b in zip(_leaves(got.ef_memory), _leaves(want.ef_memory)):
        scale = 254.0 * np.abs(b).max(-1, keepdims=True)
        assert np.all(np.abs(a - b) <= ATOL + RTOL * scale), (
            tag, "ef_memory", np.abs(a - b).max())


# ----------------------------------------------------------------------
# one lane against the plain train-step loop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("comm", ["gain_lookahead(lam=0.3)|int8+ef",
                                  "budget_dual(rate=0.4)|int8+ef"])
def test_frontier_step_single_lane_matches_plain_loop(problem, comm):
    """One lane at scale 1.0, driven round by round, is the plain train
    step: params, EF memory, controller rows and every metric."""
    cfg = _cfg(comm)
    opt = opt_lib.from_config(cfg)
    bstep = make_frontier_step(tloss, opt, cfg, device="cpu")
    states = stack_states(init_train_state(_params(), opt, cfg,
                                           device="cpu"), 1)
    if "budget" in comm:
        assert states.ctrl_state.shape == (1, TOY.num_agents, CTRL_WIDTH)
    batches = _batches(problem)
    hist = []
    for batch in batches:
        states, m = bstep(states, batch, torch.ones(1))
        hist.append(convert.to_numpy(m))
    ref_state, ref_hist = _plain_loop(cfg, batches)
    _assert_states(_lane(states, 0), ref_state)
    for got, want in zip(hist, ref_hist):
        _assert_metrics({k: v[0] for k, v in got.items()}, want)


def test_run_frontier_single_lane_matches_plain_loop(problem):
    cfg = _cfg("gain_lookahead(lam=0.3)|int8+ef")
    batches = _batches(problem)
    res = _frontier(cfg, batches, [1.0])
    ref_state, ref_hist = _plain_loop(cfg, batches)
    _assert_states(_lane(res.state, 0), ref_state)
    _assert_metrics({k: v[0] for k, v in convert.to_numpy(
        res.metrics).items()},
        {k: np.stack([h[k] for h in ref_hist]) for k in ref_hist[0]})


def test_plain_policies_keep_none_ctrl_state_through_engine(problem):
    res = _frontier(_cfg(MIXED_M4), _batches(problem, 3), [0.5, 1.0])
    assert res.state.ctrl_state is None
    assert "agent_lam" not in res.metrics


def test_scale_is_the_lambda_axis(problem):
    """Base policy λ=1 at scale 3 ≡ policy λ=3 at scale 1, bit for bit."""
    def pols(lam):
        return ("always", f"gain_lookahead(lam={lam})|int8+ef",
                f"gain_lookahead(lam={2 * lam})|fp16", "never")

    batches = _batches(problem)
    a = _frontier(_cfg(pols(1.0)), batches, [3.0])
    b = _frontier(_cfg(pols(3.0)), batches, [1.0])
    assert _tree_equal(a.state, b.state)
    assert all(torch.equal(a.metrics[k], b.metrics[k]) for k in a.metrics)


def test_loss_traced_once_per_round_for_any_grid(problem):
    """The port's counterpart of JAX's one-compile test: the vmapped step
    runs the loss the same number of times per round for 1 lane and for
    16 (the grid is a batch dimension, not a loop)."""
    counts = []
    batches = _batches(problem, 3)
    for grid in (1, 16):
        calls = [0]

        def loss_fn(params, batch):
            calls[0] += 1
            return tloss(params, batch)

        cfg = _cfg(MIXED_M4)
        res = run_frontier(loss_fn, opt_lib.from_config(cfg), cfg,
                           _params(), scales=torch.linspace(0.0, 4.0, grid),
                           steps=3, batch_fn=lambda k: batches[k],
                           device="cpu")
        assert res.metrics["loss"].shape == (grid, 3)
        counts.append(calls[0])
    assert counts[0] == counts[1], counts
    assert counts[0] <= 3 * 4, f"{counts[0]} loss traces in 3 rounds"


def test_frontier_shapes_and_curve(problem):
    res = _frontier(_cfg(MIXED_M4), _batches(problem), [0.0, 1.0, 8.0])
    assert isinstance(res, FrontierResult)
    assert res.state.params["w"].shape == (3, TOY.n)
    assert res.state.step == STEPS
    assert res.metrics["wire_bytes"].shape == (3, STEPS)
    assert res.metrics["agent_bytes"].shape == (3, STEPS, 4)
    curve = frontier_curve(res)
    assert curve["final_loss"].shape == (3,)
    assert curve["agent_bytes"].shape == (3, 4)
    total = curve["wire_bytes"].numpy()
    np.testing.assert_allclose(curve["agent_bytes"].numpy().sum(1), total,
                               rtol=1e-6)
    assert total[2] <= total[0] + 1e-6
    assert np.all(np.isfinite(curve["final_loss"].numpy()))


def test_frontier_argument_checks(problem):
    batches = _batches(problem, 2)
    with pytest.raises(ValueError, match="1-D"):
        _frontier(_cfg("always"), batches, torch.ones(2, 2))
    with pytest.raises(ValueError, match="align"):
        _frontier(_cfg("always @ bernoulli(p=0.5)"), batches, [1.0, 1.0],
                  chan_scales=[1.0])
    with pytest.raises((TypeError, ValueError), match="Mesh"):
        _frontier(_cfg("always"), batches, [1.0], mesh=object())


def test_budget_scales_match_jax():
    got = budget_scales([10.0, 22.4, 44.8], 44.8, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbudget_scales([10.0, 22.4, 44.8], 44.8)))
    with pytest.raises(ValueError, match="positive"):
        budget_scales([1.0], 0.0, device="cpu")


def test_tiered_toy_frontier_smoke(problem):
    """A 1-agent-per-tier mix through the engine: the dense backbone
    outspends every compressed tier at any λ."""
    net = TieredNetwork("toy_tiers", _tiers(1, 1, 1, 1, n=TOY.n))
    scales = [0.0, 0.3, 1.0, 3.0, 10.0]
    res = _frontier(_cfg(net.policies(lam_base=1.0)), _batches(problem),
                    scales)
    agent_bytes = frontier_curve(res)["agent_bytes"].numpy()
    tier = np.asarray(net.tier_index())
    assert agent_bytes.shape == (len(scales), 4)
    assert np.all(agent_bytes[:, tier == 0]
                  >= agent_bytes[:, tier > 0] - 1e-6)


# ----------------------------------------------------------------------
# against JAX run_frontier, on JAX-drawn batches
# ----------------------------------------------------------------------

def _jax_frontier(comm, jproblem, scales, steps, key, *, n=TOY.n,
                  dispatch="unroll", **kw):
    """JAX ``run_frontier`` and the batches its scan drew (its
    ``split(key, steps)`` round keys) as the port's tensors."""
    m = len(comm) if isinstance(comm, tuple) else TOY.num_agents
    cfg = JTrainConfig(lr=TOY.stepsize, optimizer="sgd", num_agents=m,
                       comm=comm)
    res = jrun_frontier(jloss, jopt_lib.from_config(cfg), cfg,
                        {"w": jnp.zeros(n)}, scales=scales, steps=steps,
                        batch_fn=lambda k: JR.agent_batches(jproblem, k),
                        key=key, hetero_dispatch=dispatch, **kw)
    batches = [convert.to_torch(jax.device_get(JR.agent_batches(jproblem, k)),
                                "cpu")
               for k in jax.random.split(key, steps)]
    return res, batches


def _port_frontier(comm, batches, scales, *, n=TOY.n, dispatch="hybrid",
                   **kw):
    m = len(comm) if isinstance(comm, tuple) else TOY.num_agents
    cfg = _cfg(comm, num_agents=m)
    return run_frontier(tloss, opt_lib.from_config(cfg), cfg,
                        {"w": torch.zeros(n)}, scales=scales,
                        steps=len(batches), batch_fn=lambda k: batches[k],
                        hetero_dispatch=dispatch, device="cpu", **kw)


def _assert_frontiers(got, want, comm, tag=""):
    _assert_metrics(convert.to_numpy(got.metrics),
                    jax.device_get(want.metrics), tag)
    _assert_states(got.state, jax.device_get(want.state), tag, comm)


FRONTIER_MIX = ("always",
                "budget_dual(rate=0.3)",
                "gain_quadratic(lam=0.5,kernel=true)|int8+ef",
                "budget_window(bytes=3.0,window=8)|fp16"
                " @ bernoulli(p=0.3,seed=3)")


@pytest.mark.parametrize("chan_scales", [None, [0.0, 0.5, 1.0, 2.0]])
@pytest.mark.parametrize("path", DISPATCH_MODES)
def test_run_frontier_matches_jax(jproblem, path, chan_scales):
    """A mix with controllers, the kernel-gated quadratic gain and a
    lossy wire, 4 lanes × 6 rounds, against JAX ``unroll``."""
    scales = [0.0, 0.5, 1.0, 4.0]
    want, batches = _jax_frontier(FRONTIER_MIX, jproblem, scales, STEPS,
                                  jax.random.key(7), chan_scales=chan_scales)
    got = _port_frontier(FRONTIER_MIX, batches, scales, dispatch=path,
                         chan_scales=chan_scales)
    _assert_frontiers(got, want, FRONTIER_MIX, path)
    if chan_scales is not None:
        np.testing.assert_array_equal(got.chan_scales.numpy(), chan_scales)
        assert set(frontier_curve(got)) >= {
            "chan_scale", "wire_bytes_attempted", "delivered_rate",
            "mean_staleness"}


@pytest.mark.parametrize("channel", ["ideal", "delay"])
def test_m4_frontier_three_paths_match_jax_unroll(jproblem, channel):
    """tests/test_dispatch_differential.py's m = 4 frontier cell: the
    port's three paths under the grid vmap against JAX ``unroll``."""
    net = TieredNetwork("toy4", _tiers(1, 1, 1, 1, n=TOY.n))
    if channel == "delay":
        net = _lossy(net, "toy4_delay", "delay(dist=geometric,lag=2.0,"
                     "max_lag=4,discount=0.5,seed=5)")
    comm = net.policies(lam_base=1.0)
    scales = [0.0, 0.5, 1.0, 4.0]
    want, batches = _jax_frontier(comm, jproblem, scales, TOY.steps - 2,
                                  jax.random.key(5))
    for path in DISPATCH_MODES:
        _assert_frontiers(_port_frontier(comm, batches, scales,
                                         dispatch=path), want, comm, path)


@pytest.mark.parametrize("channel", ["ideal", "delay"])
def test_m64_frontier_matches_jax_unroll(channel):
    """tests/test_dispatch_differential.py's m = 64 frontier cell
    (``TIERED_M64`` at TOY64, 3 lanes, 4 rounds): the port's ``hybrid``
    and ``switch`` against JAX ``unroll`` (the reference's own ``hybrid``
    and ``switch`` split there, ROADMAP §3)."""
    jproblem = JR.make_problem(TOY64, jax.random.key(42))
    net = TieredNetwork("toy64", _tiers(*(t.count for t in TIERED_M64.tiers),
                                        n=TOY64.n))
    if channel == "delay":
        net = _lossy(net, "toy64_delay", "delay(dist=geometric,lag=2.0,"
                     "max_lag=4,discount=0.5,seed=5)")
    comm = net.policies(lam_base=1.0)
    scales = [0.0, 1.0, 4.0]
    want, batches = _jax_frontier(comm, jproblem, scales, 4,
                                  jax.random.key(17), n=TOY64.n)
    for path in ("hybrid", "switch"):
        _assert_frontiers(_port_frontier(comm, batches, scales, n=TOY64.n,
                                         dispatch=path), want, comm, path)


def test_adaptive_mix_hybrid_equals_unroll_under_frontier_vmap(jproblem):
    """tests/test_adaptive.py:211: controller agents in the mix; each lane's
    controller rows evolve on their own, on every path alike."""
    mix = ("always", "budget_dual(rate=0.3)",
           "gain_lookahead(lam=0.5)|int8+ef",
           "budget_window(bytes=3.0,window=8)|fp16")
    want, batches = _jax_frontier(mix, jproblem, [0.5, 1.0], 6,
                                  jax.random.key(23))
    hy = _port_frontier(mix, batches, [0.5, 1.0], dispatch="hybrid")
    un = _port_frontier(mix, batches, [0.5, 1.0], dispatch="unroll")
    assert hy.state.ctrl_state.shape == (2, TOY.num_agents, CTRL_WIDTH)
    _assert_frontiers(hy, want, mix, "hybrid")
    _assert_frontiers(un, want, mix, "unroll")
    _assert_metrics(convert.to_numpy(hy.metrics),
                    convert.to_numpy(un.metrics), "hybrid vs unroll")


# ----------------------------------------------------------------------
# the channel axis
# ----------------------------------------------------------------------

def test_chan_scale_zero_lane_is_lossless(problem):
    """Severity 0 delivers every attempted byte inside the same grid as a
    lossy lane, and matches the channel-free frontier to tolerance."""
    batches = _batches(problem, 4)
    res = _frontier(_cfg("gain_lookahead(lam=0.5)|int8+ef @ "
                         "bernoulli(p=0.4)"), batches, [1.0, 1.0],
                    chan_scales=[0.0, 1.0])
    curve = frontier_curve(res)
    assert float(curve["delivered_rate"][0]) == 1.0
    assert float(curve["wire_bytes"][0]) == float(
        curve["wire_bytes_attempted"][0])
    base = _frontier(_cfg("gain_lookahead(lam=0.5)|int8+ef"), batches, [1.0])
    np.testing.assert_allclose(res.state.params["w"][0].numpy(),
                               base.state.params["w"][0].numpy(), rtol=1e-6)
    assert base.chan_scales is None
    assert "delivered_rate" not in frontier_curve(base)


def test_ideal_bitwise_under_frontier_grid_vmap():
    """HETERO_M8's mix, plain against ``@ ideal`` on every tier, under
    the grid vmap: states and every metric bit for bit."""
    problem = R.make_problem(HETERO_M8, step_generator(30, 0, "cpu"),
                             device="cpu")
    batches = [R.agent_batches(problem, step_generator(31, k, "cpu"))
               for k in range(4)]

    def run_with(policies):
        cfg = TrainConfig(lr=HETERO_M8.stepsize, optimizer="sgd",
                          num_agents=HETERO_M8.num_agents, comm=policies)
        return run_frontier(tloss, opt_lib.from_config(cfg), cfg,
                            {"w": torch.zeros(HETERO_M8.n)},
                            scales=[0.7, 1.0], steps=4,
                            batch_fn=lambda k: batches[k], device="cpu")

    plain = HETERO_M8_NET.policies(lam_base=1.0)
    rp = run_with(plain)
    ri = run_with(tuple(f"{p} @ ideal" for p in plain))
    assert ri.state.net_state is None
    assert _tree_equal(rp.state, ri.state)
    assert set(rp.metrics) == set(ri.metrics)
    assert all(torch.equal(rp.metrics[k], ri.metrics[k]) for k in rp.metrics)


def test_delivery_key_is_common_across_lanes(problem):
    """Two lanes draw the same channel realization: delivery is a
    function of (seed, step, uid), never of the lane's scale."""
    res = _frontier(_cfg(("always @ bernoulli(p=0.5,seed=9)",) * 4),
                    _batches(problem), [0.5, 2.0])
    ad = res.metrics["agent_delivered"].numpy()  # (G, K, A)
    np.testing.assert_array_equal(ad[0], ad[1])
    assert 0.0 < ad.mean() < 1.0


def test_delay_chan_scale_multiplies_mean_lag(problem):
    """The severity axis stretches a delay wire's mean lag: the harsher
    lane's tail staleness dominates, inside one grid."""
    batches = _batches(problem, 24)
    res = _frontier(_cfg(("always @ delay(dist=geometric,lag=2.0,max_lag=6,"
                          "seed=2)",) * 4), batches, [1.0, 1.0],
                    chan_scales=[0.25, 2.0])
    ms = res.metrics["mean_staleness"].numpy()  # (G, T)
    assert ms[1, 8:].mean() > ms[0, 8:].mean()


def test_churn_under_frontier_vmap(problem):
    """The schedule reaches every lane; benched rounds ship no bytes."""
    T = 8
    churn = ((0, T), (0, T), (3, T), (0, 5))
    res = _frontier(_cfg(("always|int8+ef",) * 4), _batches(problem, T),
                    [0.5, 1.0], churn=churn)
    na = res.metrics["num_active"].numpy()  # (G, T)
    want = np.asarray([3.0 if (i < 3 or i >= 5) else 4.0 for i in range(T)])
    for lane in na:
        np.testing.assert_array_equal(lane, want)
    np.testing.assert_allclose(frontier_curve(res)["num_active"].numpy(),
                               want.mean(), rtol=1e-6)
    ab = res.metrics["agent_bytes"].numpy()  # (G, T, A)
    assert not np.any(ab[:, :3, 2]) and not np.any(ab[:, 5:, 3])


# ----------------------------------------------------------------------
# the drifting target
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_drifting_problem_matches_jax(jproblem, seed):
    """w*(k) = w* + amp·sin(2πk/period)·u with u from ``normal`` under
    ``PRNGKey(seed)``: within 2e-7 of JAX's (``normal``'s last-place gap,
    ROADMAP §3, and one float32 sine)."""
    tproblem = convert.problem_from_jax(jproblem, device="cpu")
    for k in (0, 1, 5, 16, 17, 239):
        want = np.asarray(jdrifting_problem(jproblem, k, amp=2.0, period=16,
                                            seed=seed).w_star)
        got = drifting_problem(tproblem, k, amp=2.0, period=16,
                               seed=seed).w_star.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7,
                                   err_msg=str(k))
    # the nominal problem is untouched
    np.testing.assert_array_equal(tproblem.w_star.numpy(),
                                  np.asarray(jproblem.w_star))


def test_drifting_batch_fn_draws_round_k_at_its_drifted_target(jproblem):
    tproblem = convert.problem_from_jax(jproblem, device="cpu")
    batch_fn = drifting_batch_fn(tproblem, amp=2.0, period=16, seed=0)
    for k in (0, 4, 9):
        xs, ys = batch_fn(k)
        want = R.agent_batches(
            drifting_problem(tproblem, k, amp=2.0, period=16, seed=0),
            step_generator(1, k, "cpu"))
        assert torch.equal(xs, want[0]) and torch.equal(ys, want[1])
    # the drift moves the responses: round 4 (a quarter period) differs
    # from the nominal problem's draw on the same generator
    nominal = R.agent_batches(tproblem, step_generator(1, 4, "cpu"))
    assert not torch.equal(batch_fn(4)[1], nominal[1])
    res = run_frontier(tloss, opt_lib.from_config(_cfg("always")),
                       _cfg("always"), _params(), scales=[1.0], steps=4,
                       batch_fn=batch_fn, device="cpu")
    assert np.all(np.isfinite(res.metrics["loss"].numpy()))


def _integer_batches(steps, seed=11):
    """Integer-valued ``(xs, ys)`` rounds for TOY: with ``lr`` 1/8, 8
    samples and 4 agents every value of the first three rounds is dyadic
    and short, so every fp32 sum is exact in any order."""
    rng = np.random.default_rng(seed)
    m, N, n = TOY.num_agents, TOY.samples_per_agent, TOY.n
    return [(torch.from_numpy(rng.integers(-2, 3, (m, N, n)).astype(
                np.float32)),
             torch.from_numpy(rng.integers(-3, 4, (m, N)).astype(
                 np.float32)))
            for _ in range(steps)]


def test_every_compressor_runs_under_the_grid(problem):
    """``sketch``, ``bf16`` and ``randk`` under the grid vmap: each lane
    equals the plain step pinned at its scale.  ``randk``'s salt is the
    bit pattern of an fp32 sum, which the vmapped and the plain step may
    round an ULP apart (ROADMAP §3) and then salt different subsets, so
    its lanes are held on integer-valued rounds, where every sum is
    exact; the salt's bit cast (formed without a dtype view) is held to
    the view's, under vmap as well."""
    comm = ("always", "gain_lookahead(lam=0.5)",
            "gain_lookahead(lam=0.1)|sketch(rows=2,cols=4,seed=1)",
            "always|bf16")
    randk = ("always|randk(0.5)+ef", "gain_lookahead(lam=0.5)|randk(0.5)+ef",
             "always|randk(frac=0.25,seed=3)+ef",
             "gain_lookahead(lam=2.0)|randk(frac=0.5,seed=1)+ef")
    for spec, cfg, batches in (
            (comm, _cfg(comm), _batches(problem, 4)),
            (randk, _cfg(randk, lr=0.125), _integer_batches(3))):
        res = _frontier(cfg, batches, [0.5, 2.0])
        for g, scale in enumerate((0.5, 2.0)):
            ref_state, hist = _plain_loop(cfg, batches, scale=scale)
            _assert_metrics({k: v[g] for k, v in convert.to_numpy(
                res.metrics).items()},
                {k: np.stack([h[k] for h in hist]) for k in hist[0]},
                f"{spec[-1]} {g}")
            _assert_states(_lane(res.state, g), ref_state, str(g), spec)
    # the salted subsets moved EF memory: the randk lanes did real work
    assert np.abs(convert.to_numpy(res.state.ef_memory)["w"]).max() > 0
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4000) * 10.0 ** rng.integers(-45, 38, 4000)
         ).astype(np.float32)
    x = torch.from_numpy(np.concatenate(
        [x[np.isfinite(x)], np.float32([0.0, -0.0, 1e-45, -3.4e38])]))
    assert torch.equal(_f32_bits(x), x.view(torch.int32))
    assert torch.equal(torch.func.vmap(_f32_bits)(x[:4000].reshape(4, -1)),
                       x[:4000].view(torch.int32).reshape(4, -1))
