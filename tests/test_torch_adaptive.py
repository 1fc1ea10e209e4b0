"""The port's budget controllers, the linreg closed-form triggers,
``periodic`` and the ``bf16`` wire against the JAX package, on the CPU.

* each trigger, fed the same numpy inputs, against its JAX counterpart
  vmapped over agents: gains and controller rows within ``rtol = 1e-5,
  atol = 1e-6``, decisions exactly;
* the adaptive toy tiers at TOY64 (64 agents, n = 6) through the hybrid
  step against the JAX ``unroll`` step for 20 rounds, each round from
  the JAX state (the harness of tests/test_torch_fleet.py, which also
  holds the controller rows);
* the served fleet's default — ``TIERED_M64_ADAPTIVE`` — for 10 rounds
  against the JAX session on the JAX batches;
* ``gain_estimated``, ``gain_exact`` and ``periodic`` inside the
  homogeneous train step, on the flat weight vector the JAX closed
  forms require;
* ``bf16`` chains against the JAX chains.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommPolicy as JCommPolicy
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.paper_linreg import TIERED_M64_CFG, LinRegConfig
from repro.core import regression as JR
from repro.core.api import StepOptions as JStepOptions
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.launch.session import build_linreg_fleet_session as jbuild_session
from repro.optim import optimizers as jopt_lib
from repro_torch import convert
from repro_torch.comm import CommPolicy
from repro_torch.comm.policy import ctrl_init
from repro_torch.comm.triggers import CTRL_WIDTH
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_linreg import (
    TIERED_M64_ADAPTIVE,
    TieredNetwork,
    _adaptive_tiers,
)
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.launch.session import build_linreg_fleet_session
from repro_torch.optim import optimizers as opt_lib
from test_torch_fleet import _parity_run, tloss

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

TOY4 = LinRegConfig(name="toy4", n=6, num_agents=4, samples_per_agent=8,
                    stepsize=0.1, steps=4)
TOY64 = LinRegConfig(name="toy64", n=6, num_agents=64, samples_per_agent=8,
                     stepsize=0.1, steps=2)


def _jflat(w, batch):
    xs, ys = batch
    r = xs @ w - ys
    return 0.5 * jnp.mean(r * r)


def _tflat(w, batch):
    xs, ys = batch
    r = xs @ w - ys
    return 0.5 * torch.mean(r * r)


@pytest.fixture(scope="module")
def agents():
    """Six agents on a flat weight vector, from one numpy draw."""
    rng = np.random.default_rng(4)
    n, N, A = 5, 12, 6
    w = rng.standard_normal(n).astype(np.float32)
    xs = rng.standard_normal((A, N, n)).astype(np.float32)
    ys = rng.standard_normal((A, N)).astype(np.float32)
    jb = (jnp.asarray(xs), jnp.asarray(ys))
    jl, jg = jax.vmap(jax.value_and_grad(_jflat), in_axes=(None, 0))(
        jnp.asarray(w), jb)
    t = (torch.from_numpy(w), torch.tensor(np.asarray(jg)),
         (torch.from_numpy(xs), torch.from_numpy(ys)),
         torch.tensor(np.asarray(jl)))
    return (jnp.asarray(w), jg, jb, jl), t


ORACLE = (np.array([3.0, 1.0, 0.5, 2.0, 1.5], np.float32),
          np.array([1.0, -2.0, 0.5, 3.0, 0.0], np.float32))
FIXED_SPECS = ["gain_estimated(lam=0.05)", "gain_estimated(lam=0.05,decay=inv_t)",
               "gain_exact(lam=0.05)", "gain_exact(lam=0.5,decay=geometric)",
               "periodic(period=3)", "periodic(period=2)"]


@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("spec", FIXED_SPECS)
def test_new_fixed_triggers_match_jax(agents, spec, scale):
    (jp, jg, jb, jl), (tp, tg, tb, tl) = agents
    eps, step = 0.1, 3
    jtrig = JCommPolicy.parse(spec).build_trigger(
        loss_fn=_jflat, probe_eps=eps, oracle=ORACLE)
    ttrig = CommPolicy.parse(spec).build_trigger(
        loss_fn=_tflat, probe_eps=eps, oracle=ORACLE)
    jalpha, jgain = jax.vmap(
        lambda g, b, loss: tuple(jtrig(jp, g, b, loss, jnp.int32(step),
                                       scale)))(jg, jb, jl)
    talpha, tgain = ttrig(tp, tg, tb, tl, step, scale)
    np.testing.assert_allclose(tgain.numpy(), np.asarray(jgain), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(talpha.numpy(), np.asarray(jalpha))
    if hasattr(jtrig, "prologue"):
        assert ttrig.prologue_key == jtrig.prologue_key
        again = ttrig(tp, tg, tb, tl, step, scale,
                      pre=ttrig.prologue(tp, tg, tb, tl))
        np.testing.assert_array_equal(again.alpha.numpy(), talpha.numpy())


def test_gain_exact_needs_the_oracle():
    with pytest.raises(ValueError, match="oracle"):
        CommPolicy.parse("gain_exact(lam=1.0)").build_trigger()


BUDGET_SPECS = ["budget_dual(rate=0.5)", "budget_dual(rate=0.3,eta=0.8,lam0=0.2)",
                "budget_window(bytes=9.0)", "budget_window(bytes=3.0,window=8)|fp16",
                "budget_window(bytes=2.0)|topk(0.2)|int8+ef"]


@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("spec", BUDGET_SPECS)
def test_budget_controllers_match_jax_over_rounds(agents, spec, scale):
    """Five controller steps from the initial rows, each on the same
    gradients: decisions, gains and the rows ``[λ, signal, |gain|]``."""
    (jp, jg, jb, jl), (tp, tg, tb, tl) = agents
    params_j, params_t = {"w": jp}, {"w": tp}
    loss_j = lambda p, b: _jflat(p["w"], b)
    loss_t = lambda p, b: _tflat(p["w"], b)
    jtrig = JCommPolicy.parse(spec).build_trigger(loss_fn=loss_j,
                                                  probe_eps=0.1)
    ttrig = CommPolicy.parse(spec).build_trigger(loss_fn=loss_t,
                                                 probe_eps=0.1)
    A = tl.shape[0]
    jrows = jnp.broadcast_to(jtrig.ctrl0, (A, CTRL_WIDTH))
    trows = ctrl_init(CommPolicy.parse(spec), A)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    for k in range(5):
        (ja, jgn), jrows = jax.vmap(
            lambda g, b, loss, c: jtrig(params_j, {"w": g}, b, loss, k, c,
                                        scale))(jg, jb, jl, jrows)
        (ta, tgn), trows = ttrig(params_t, {"w": tg}, tb, tl, k, trows,
                                 scale)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tgn.numpy(), np.asarray(jgn), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(trows.numpy(), np.asarray(jrows),
                                   rtol=RTOL, atol=ATOL, err_msg=f"round {k}")
    assert trows.shape == (A, CTRL_WIDTH)


def test_adaptive_toy64_hybrid_matches_jax_unroll():
    """The adaptive toy tiers at m = 64: 20 hybrid rounds against JAX's
    unroll path, controller rows included."""
    net = TieredNetwork("toy64_adaptive", _adaptive_tiers(8, 16, 24, 16,
                                                          n=TOY64.n))
    specs = net.policies()
    assert sum(CommPolicy.parse(s).is_adaptive for s in specs) == 56
    _parity_run(TOY64, specs, "unroll", alt="hybrid", rounds=20)


def test_homogeneous_budget_window_matches_jax():
    _parity_run(TOY4, "budget_window(bytes=9.0)|int8+ef", "hybrid",
                rounds=12)


def test_fleet_session_default_serves_the_adaptive_mix():
    """``build_linreg_fleet_session`` with no ``net`` serves
    ``TIERED_M64_ADAPTIVE``; 10 rounds on the JAX session's batches
    match the JAX session: rollup, params and controller rows."""
    seed, rounds = 0, 10
    jsession = jbuild_session(seed=seed)
    jsession.run(rounds)
    problem = JR.make_problem(TIERED_M64_CFG, jax.random.key(seed))
    key = jax.random.key(seed + 1)

    def batch_fn(k):
        return convert.to_torch(jax.device_get(JR.agent_batches(
            problem, jax.random.fold_in(key, k))), "cpu")

    session = build_linreg_fleet_session(seed=seed, device="cpu",
                                         batch_fn=batch_fn)
    assert session.run(rounds) == rounds
    js, ts = jsession.rollup.snapshot(), session.rollup.snapshot()
    assert list(ts["tiers"]) == [t.name for t in TIERED_M64_ADAPTIVE.tiers]
    assert session.state.ctrl_state.shape == (64, CTRL_WIDTH)
    assert ts["counters"]["num_tx"] == js["counters"]["num_tx"]
    assert ts["budget_violation_rounds"] == js["budget_violation_rounds"]
    for name, jrow in js["tiers"].items():
        trow = ts["tiers"][name]
        for col in ("agents", "tx_total", "violations"):
            assert trow[col] == jrow[col], (name, col)
        for col in jrow:
            if isinstance(jrow[col], float):
                np.testing.assert_allclose(trow[col], jrow[col], rtol=RTOL,
                                           atol=ATOL, err_msg=(name, col))
    np.testing.assert_allclose(
        convert.to_numpy(session.state.params)["w"],
        np.asarray(jsession.state.params["w"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(convert.to_numpy(session.state.ctrl_state),
                               np.asarray(jsession.state.ctrl_state),
                               rtol=RTOL, atol=ATOL)


def test_convert_carries_controller_state():
    cfg = JTrainConfig(lr=0.1, optimizer="sgd", num_agents=4,
                       comm=("always", "budget_dual(rate=0.3)",
                             "budget_window(bytes=4.0)|fp16", "never"))
    jstate = jinit({"w": jnp.zeros(6)}, jopt_lib.from_config(cfg), cfg)
    jstate = jstate._replace(ctrl_state=jstate.ctrl_state.at[1, 0].set(0.7))
    tstate = convert.state_from_jax(jax.device_get(jstate), device="cpu")
    assert tstate.ctrl_state.dtype == torch.float32
    np.testing.assert_array_equal(tstate.ctrl_state.numpy(),
                                  np.asarray(jstate.ctrl_state))
    tcfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=4, comm=cfg.comm)
    fresh = init_train_state({"w": torch.zeros(6)},
                             opt_lib.from_config(tcfg), tcfg, device="cpu")
    np.testing.assert_array_equal(
        fresh.ctrl_state.numpy(),
        np.asarray(jinit({"w": jnp.zeros(6)}, jopt_lib.from_config(cfg),
                         cfg).ctrl_state))
    plain = TrainConfig(lr=0.1, optimizer="sgd", num_agents=4, comm="always")
    assert init_train_state({"w": torch.zeros(6)}, opt_lib.sgd(0.1), plain,
                            device="cpu").ctrl_state is None


@pytest.mark.parametrize("spec", ["gain_estimated(lam=0.05)",
                                  "gain_exact(lam=0.5,decay=inv_t)",
                                  "periodic(period=2)",
                                  "gain_estimated(lam=0.02)|bf16"])
def test_linreg_triggers_in_the_train_step_match_jax(spec):
    """Four homogeneous rounds on the flat weight vector, each from the
    JAX state, with the problem oracle for ``gain_exact``."""
    jp = JR.make_problem(TOY4, jax.random.key(2))
    oracle = (np.asarray(jp.sigma_diag), np.asarray(jp.w_star))
    jcfg = JTrainConfig(lr=TOY4.stepsize, optimizer="sgd", num_agents=4,
                        comm=spec)
    tcfg = TrainConfig(lr=TOY4.stepsize, optimizer="sgd", num_agents=4,
                       comm=spec)
    jo, to = jopt_lib.from_config(jcfg), opt_lib.from_config(tcfg)
    jstep = jax.jit(jmake(_jflat, jo, jcfg, oracle=oracle,
                          options=JStepOptions(agent_metrics=True)))
    tstep = make_triggered_train_step(_tflat, to, tcfg, oracle=oracle,
                                      options=StepOptions(agent_metrics=True),
                                      device="cpu")
    jstate = jinit(jnp.zeros(TOY4.n), jo, jcfg)
    for k in range(4):
        batch = JR.agent_batches(jp, jax.random.fold_in(jax.random.key(9), k))
        tstate = convert.state_from_jax(jax.device_get(jstate), device="cpu")
        tnext, tm = tstep(tstate, convert.to_torch(jax.device_get(batch),
                                                   "cpu"))
        jnext, jm = jax.device_get(jstep(jstate, batch))
        assert set(tm) == set(jm)
        np.testing.assert_array_equal(tm["agent_tx"].numpy(),
                                      np.asarray(jm["agent_tx"]))
        for key in jm:
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(tnext.params.numpy(),
                                   np.asarray(jnext.params), rtol=RTOL,
                                   atol=ATOL)
        jstate = jnext


def test_open_loop_controller_warns_and_equals_fixed_lambda():
    """With no controller slot an adaptive policy gates open-loop at its
    lam0 — the same ops as ``gain_lookahead(lam=lam0)`` — and warns."""
    cfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=4,
                      comm="budget_dual(rate=0.3,lam0=0.02)")
    fixed = TrainConfig(lr=0.1, optimizer="sgd", num_agents=4,
                        comm="gain_lookahead(lam=0.02)")
    opt = opt_lib.sgd(0.1)
    gen = torch.Generator().manual_seed(1)
    batch = (torch.randn(4, 8, 6, generator=gen),
             torch.randn(4, 8, generator=gen))
    state = init_train_state({"w": torch.zeros(6)}, opt, cfg, device="cpu")
    assert state.ctrl_state.shape == (4, CTRL_WIDTH)
    step = make_triggered_train_step(tloss, opt, cfg, device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        a, ma = step(state._replace(ctrl_state=None), batch)
    assert any("OPEN-LOOP" in str(w.message) for w in rec)
    b, mb = make_triggered_train_step(tloss, opt, fixed, device="cpu")(
        state._replace(ctrl_state=None), batch)
    assert a.ctrl_state is None
    assert torch.equal(a.params["w"], b.params["w"])
    assert all(torch.equal(ma[k], mb[k]) for k in mb)
    # closed loop: the rows move
    c, _ = step(state, batch)
    assert not torch.equal(c.ctrl_state, state.ctrl_state)


BF16_CHAINS = ["bf16", "int8|bf16", "bf16|int8", "topk(0.05)|bf16",
               "fp16|bf16"]


@pytest.mark.parametrize("chain", BF16_CHAINS)
def test_bf16_chain_matches_jax(chain):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 64)) * 3.0).astype(np.float32)
    x[2] = 0.0
    x[3, :4] = [1e-3, -1e-3, 3e38, -2.5]  # near bf16's largest
    spec = f"always|{chain}"
    jchain = JCommPolicy.parse(spec).chain()
    tchain = CommPolicy.parse(spec).chain()
    want = np.asarray(jax.vmap(jchain.compress)(jnp.asarray(x)))
    got = tchain.compress(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for bits in (32.0, 16.0):
        assert tchain.ratio_for(bits) == jchain.ratio_for(bits)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(CommPolicy.parse("always|bf16").chain().compress(xb),
                       xb)
