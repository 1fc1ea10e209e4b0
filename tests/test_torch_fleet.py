"""The PyTorch port's triggered train step and fleet session against the
JAX package, on the CPU.

Both packages run on the same inputs: the JAX ``Problem`` and the
JAX-drawn batches are carried across by ``repro_torch.convert``.  Every
round is a parity check of one step: both steps start from the same
state (the JAX step's previous output) and take the same batch, so the
comparison measures the step itself and float noise does not compound.

Agreement (ROADMAP's parity contract): parameters and float metrics
within ``rtol=1e-5, atol=1e-6``; transmit decisions (``agent_tx``,
``num_tx``) exactly, except for an agent whose gain lies within that
tolerance of its threshold.  Error-feedback memory is the residual
``g − C(g)`` of two nearly equal numbers, so it inherits the absolute
rounding of ``g`` itself: the two packages sum each gradient's dot
products in different orders (XLA vs ATen), one ULP of ``|g|`` apart.
It is held to ``rtol=1e-5`` of the agent's gradient scale
``max|g + ef|`` (plus ``atol=1e-6``), which is that ULP with a wide
margin; a compression that rounds differently (an int8 level) would
exceed it by three orders of magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommPolicy as JCommPolicy
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.paper_linreg import (
    HETERO_M8,
    TIERED_M64_CFG,
    LinRegConfig,
    TierSpec as JTierSpec,
    TieredNetwork as JTieredNetwork,
)
from repro.core import regression as JR
from repro.core.api import StepOptions as JStepOptions
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.launch.session import build_linreg_fleet_session as jbuild_session
from repro.optim import optimizers as jopt_lib
from repro_torch import convert
from repro_torch.comm.policy import CommPolicy
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_linreg import (
    HETERO_M8_NET,
    TIERED_M64_QUADRATIC,
)
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.kernels.gain_reduce import ops as gr_ops
from repro_torch.core import regression as R
from repro_torch.launch.session import build_linreg_fleet_session
from repro_torch.optim import optimizers as opt_lib

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

TOY4 = LinRegConfig(name="toy4", n=6, num_agents=4, samples_per_agent=8,
                    stepsize=0.1, steps=4)


def jloss(params, batch):
    xs, ys = batch
    r = xs @ params["w"] - ys
    return 0.5 * jnp.mean(r * r)


def tloss(params, batch):
    xs, ys = batch
    r = xs @ params["w"] - ys
    return 0.5 * torch.mean(r * r)


def _jax_net(net):
    """The JAX package's TieredNetwork with the port's tier layout."""
    return JTieredNetwork(net.name, tuple(
        JTierSpec(**dataclasses.asdict(t)) for t in net.tiers))


def _thresholds(specs, ctrl=None, net=None):
    """Per-agent transmit threshold −λ (None for ungated triggers); an
    adaptive trigger's λ is its row of the controller state ``ctrl``,
    and a fixed λ under a channel with ``boost`` is divided by the
    staleness factor ``1 + boost·s`` of the channel rows ``net``."""
    out = []
    rows = None if net is None else np.asarray(
        net[0] if isinstance(net, tuple) else net)
    for i, spec in enumerate(specs):
        pol = CommPolicy.parse(spec)
        trig = pol.trigger
        lam = (float(np.asarray(ctrl)[i, 0]) if pol.is_adaptive
               else trig.arg("lam"))
        if (rows is not None and not pol.is_adaptive and pol.needs_net
                and lam is not None):
            f = 1.0 + np.float32(pol.channel_model().boost) * rows[i, 0]
            lam = float(np.float32(lam) * (np.float32(1.0) / f))
        out.append(None if trig.name in ("always", "never")
                   else -float(np.float32(0.0 if lam is None else lam)))
    assert all(CommPolicy.parse(s).trigger.arg("decay") is None
               for s in specs), "thresholds assume a constant λ"
    return out


def _jax_gains(specs, cfg, params, batch, ctrl=None):
    """Per-agent gains from the JAX package's own triggers (used only
    to vet a decision that differs between the packages)."""
    gains = []
    for i, spec in enumerate(specs):
        pol = JCommPolicy.parse(spec)
        trig = pol.build_trigger(loss_fn=jloss, probe_eps=cfg.lr)
        b = tuple(x[i] for x in batch)
        loss, g = jax.value_and_grad(jloss)(params, b)
        if pol.is_adaptive:
            gains.append(float(trig(params, g, b, loss, 0, ctrl[i])[0][1]))
        else:
            gains.append(float(trig(params, g, b, loss, 0)[1]))
    return np.asarray(gains)


# the integer-valued realization of a round: decisions, deliveries,
# staleness counters and the churn mask are held exactly
EXACT_KEYS = ("agent_tx", "num_tx", "any_tx", "agent_delivered",
              "agent_staleness", "agent_active", "num_active")


def _mismatch(tnext, tm, jnext, jm, g_eff):
    """Why the port's round disagrees with a reference round, or None."""
    for key in EXACT_KEYS:
        if key in jm and not np.array_equal(tm[key], jm[key]):
            return key
    for key in jm:
        if not np.allclose(tm[key], jm[key], rtol=RTOL, atol=ATOL):
            return f"{key}: {tm[key]} vs {jm[key]}"
    tp = convert.to_numpy(tnext.params)["w"]
    jp = np.asarray(jnext.params["w"])
    if not np.allclose(tp, jp, rtol=RTOL, atol=ATOL):
        return f"params: max diff {np.abs(tp - jp).max()}"
    if (tnext.ef_memory is None) != (jnext.ef_memory is None):
        return "EF memory slot"
    if jnext.ef_memory is not None:
        scale = np.abs(g_eff).max(axis=1, keepdims=True)
        diff = np.abs(convert.to_numpy(tnext.ef_memory)["w"]
                      - np.asarray(jnext.ef_memory["w"]))
        if not np.all(diff <= ATOL + RTOL * scale):
            return f"ef_memory: max diff {diff.max()}"
    if (tnext.ctrl_state is None) != (jnext.ctrl_state is None):
        return "controller slot"
    if jnext.ctrl_state is not None and not np.allclose(
            convert.to_numpy(tnext.ctrl_state),
            np.asarray(jnext.ctrl_state), rtol=RTOL, atol=ATOL):
        return "controller rows"
    if (tnext.net_state is None) != (jnext.net_state is None):
        return "channel slot"
    if jnext.net_state is not None:
        tn = jax.tree_util.tree_leaves(convert.to_numpy(tnext.net_state))
        jn = jax.tree_util.tree_leaves(jax.device_get(jnext.net_state))
        if len(tn) != len(jn):
            return "channel slot layout"
        if not np.array_equal(tn[0], jn[0]):
            return "channel rows"
        for a, b in zip(tn[1:], jn[1:]):
            if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
                return "delay line"
    return None


def _parity_run(cfg_lr, specs, dispatch, *, alt=None, rounds=10, seed=0,
                churn=None, chan_scale=None, port_dispatch="hybrid",
                optimizer="sgd", lr=None, microbatches=1):
    """Run the port's step and the JAX step (``dispatch`` path) from the
    same state each round and compare (controller rows included).
    ``port_dispatch`` is the port's path, or a tuple of paths: each is
    held to JAX, and in a round where none of them meets a threshold
    tie, to the first path too.

    Where the two JAX dispatch paths themselves disagree on a round (a
    value on a compressor's rounding boundary, as ROADMAP §3 records),
    the port must match the ``alt`` path instead.  Returns the number of
    kernel launches counted (none on the CPU).
    """
    comm = specs if isinstance(specs, str) else tuple(specs)
    m = cfg_lr.num_agents
    agent_specs = (comm,) * m if isinstance(comm, str) else comm
    lr = cfg_lr.stepsize if lr is None else lr
    paths = ((port_dispatch,) if isinstance(port_dispatch, str)
             else tuple(port_dispatch))
    jcfg = JTrainConfig(lr=lr, optimizer=optimizer, num_agents=m, comm=comm,
                        microbatches=microbatches)
    tcfg = TrainConfig(lr=lr, optimizer=optimizer, num_agents=m, comm=comm,
                       microbatches=microbatches)
    jopt, topt = jopt_lib.from_config(jcfg), opt_lib.from_config(tcfg)

    def jax_step(mode):
        return jax.jit(jmake(jloss, jopt, jcfg, options=JStepOptions(
            hetero_dispatch=mode, agent_metrics=True, churn=churn,
            chan_scale=chan_scale)))

    jstep = jax_step(dispatch)
    alt_step = jax_step(alt) if alt else None
    tsteps = {d: make_triggered_train_step(
        tloss, topt, tcfg, options=StepOptions(
            hetero_dispatch=d, agent_metrics=True, churn=churn,
            chan_scale=chan_scale),
        device="cpu") for d in paths}
    problem = JR.make_problem(cfg_lr, jax.random.key(seed))
    jstate = jinit({"w": jnp.zeros(cfg_lr.n)}, jopt, jcfg)
    tstate = init_train_state({"w": torch.zeros(cfg_lr.n)}, topt, tcfg,
                              device="cpu")
    ties = dict.fromkeys(paths, 0)
    splits = dict.fromkeys(paths, 0)
    launches0 = gr_ops.gain_reduce.launches
    for k in range(rounds):
        batch = JR.agent_batches(
            problem, jax.random.fold_in(jax.random.key(seed + 13), k))
        if k:
            tstate = convert.state_from_jax(jax.device_get(jstate),
                                            device="cpu")
        g_eff = np.asarray(jax.vmap(jax.grad(jloss), in_axes=(None, 0))(
            jstate.params, batch)["w"])
        if jstate.ef_memory is not None:
            g_eff = g_eff + np.asarray(jstate.ef_memory["w"])
        jnext, jm = jstep(jstate, batch)
        jm = jax.device_get(jm)
        outs, settled = {}, True
        for d, tstep in tsteps.items():
            tnext, tm = tstep(tstate, convert.to_torch(
                jax.device_get(batch), "cpu"))
            tm = convert.to_numpy(tm)
            assert tnext.step == int(jnext.step) == k + 1
            assert set(tm) == set(jm)
            outs[d] = (tnext, tm)

            differ = np.flatnonzero(tm["agent_tx"] != jm["agent_tx"])
            if differ.size:
                # a decision may differ only where the gain sits on its
                # threshold to within the float tolerance
                thresholds = _thresholds(agent_specs, jstate.ctrl_state,
                                         jax.device_get(jstate.net_state))
                gains = _jax_gains(agent_specs, tcfg, jstate.params, batch,
                                   jstate.ctrl_state)
                for i in differ:
                    assert thresholds[i] is not None, (d, k, i)
                    assert abs(gains[i] - thresholds[i]) <= (
                        ATOL + RTOL * abs(thresholds[i])), (d, k, i,
                                                            gains[i])
                ties[d] += 1
                settled = False
            else:
                why = _mismatch(tnext, tm, jnext, jm, g_eff)
                if why is not None:
                    assert alt_step is not None, f"{d} round {k}: {why}"
                    anext, am = alt_step(jstate, batch)
                    why_alt = _mismatch(tnext, tm, anext,
                                        jax.device_get(am), g_eff)
                    assert why_alt is None, (
                        f"{d} round {k}: port vs JAX {dispatch}: {why}; "
                        f"vs JAX {alt}: {why_alt}")
                    splits[d] += 1
                    settled = False
        first, *rest = paths
        if settled:
            # the port's paths against each other, from the same state
            for d in rest:
                why = _mismatch(*outs[d], *outs[first], g_eff)
                assert why is None, f"round {k}: {d} vs {first}: {why}"
        jstate = jnext
    for d in paths:
        assert ties[d] <= 1, f"{d}: {ties[d]} rounds with threshold ties"
        assert splits[d] <= 1, (f"{d}: {splits[d]} rounds where the JAX "
                                f"paths split")
    return gr_ops.gain_reduce.launches - launches0


def test_homogeneous_quadratic_kernel_int8_ef_m4():
    spec = "gain_quadratic(lam=0.05,kernel=true)|int8+ef"
    _parity_run(TOY4, spec, "hybrid")


def test_hetero_m8_tiers_hybrid_vs_jax_unroll():
    specs = HETERO_M8_NET.policies(lam_base=1.0)
    assert len(set(specs)) == 4
    _parity_run(HETERO_M8, specs, "unroll", alt="hybrid")


def test_tiered_m64_quadratic_hybrid_vs_jax_hybrid():
    specs = TIERED_M64_QUADRATIC.policies(lam_base=1.0)
    assert sum("gain_quadratic" in s for s in specs) == 56
    rounds = 10
    # the metered tiers share ONE gain precursor: one launch per round
    # (on the CPU the wrapper runs its plain version, and counts none)
    assert _parity_run(TIERED_M64_CFG, specs, "hybrid", rounds=rounds) == 0


def test_hybrid_step_reduces_all_agents_in_one_kernel_call(monkeypatch):
    """The quadratic precursor of the m=64 mix reaches the kernel
    wrapper once per round, with every agent's (A, n) rows stacked."""
    calls = []
    real = gr_ops.gain_reduce

    def spy(g, h):
        calls.append(tuple(g.shape))
        return real(g, h)

    monkeypatch.setattr(gr_ops, "gain_reduce", spy)
    cfg_lr = TIERED_M64_CFG
    cfg = TrainConfig(lr=cfg_lr.stepsize, optimizer="sgd",
                      num_agents=cfg_lr.num_agents,
                      comm=TIERED_M64_QUADRATIC.policies(1.0))
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(tloss, opt, cfg, device="cpu")
    state = init_train_state({"w": torch.zeros(cfg_lr.n)}, opt, cfg,
                             device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = (torch.randn(64, cfg_lr.samples_per_agent, cfg_lr.n,
                         generator=gen),
             torch.randn(64, cfg_lr.samples_per_agent, generator=gen))
    for _ in range(3):
        state, _ = step(state, batch)
    assert calls == [(64, cfg_lr.n)] * 3


def test_fleet_session_matches_jax_session():
    """Five served rounds of the m=64 quadratic fleet: the port's
    session, fed the JAX session's batches, rolls up the same
    counters."""
    seed, rounds, net = 0, 5, TIERED_M64_QUADRATIC
    jsession = jbuild_session(net=_jax_net(net), seed=seed)
    jsession.run(rounds)
    problem = JR.make_problem(TIERED_M64_CFG, jax.random.key(seed))
    key = jax.random.key(seed + 1)

    def batch_fn(k):
        return convert.to_torch(jax.device_get(JR.agent_batches(
            problem, jax.random.fold_in(key, k))), "cpu")

    session = build_linreg_fleet_session(net=net, seed=seed, device="cpu",
                                         batch_fn=batch_fn)
    assert session.run(rounds) == rounds
    assert session.round_index == rounds
    js, ts = jsession.rollup.snapshot(), session.rollup.snapshot()
    assert ts["rounds"] == js["rounds"] == rounds
    assert ts["counters"]["num_tx"] == js["counters"]["num_tx"]
    assert ts["budget_violation_rounds"] == js["budget_violation_rounds"]
    np.testing.assert_allclose(ts["counters"]["wire_bytes"],
                               js["counters"]["wire_bytes"], rtol=RTOL)
    for key in js["gauges"]:
        np.testing.assert_allclose(ts["gauges"][key], js["gauges"][key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert list(ts["tiers"]) == list(js["tiers"])
    for name, jrow in js["tiers"].items():
        trow = ts["tiers"][name]
        for col in ("agents", "tx_total", "violations"):
            assert trow[col] == jrow[col], (name, col)
        np.testing.assert_allclose(trow["bytes_total"], jrow["bytes_total"],
                                   rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(
        convert.to_numpy(session.state.params)["w"],
        np.asarray(jsession.state.params["w"]), rtol=RTOL, atol=ATOL)


def test_problem_carried_from_jax():
    jprob = JR.make_problem(TIERED_M64_CFG, jax.random.key(5))
    prob = convert.problem_from_jax(jprob, device="cpu")
    assert (prob.n, prob.num_agents, prob.n_samples) == (32, 64, 32)
    w = np.linspace(-1.0, 1.0, 32).astype(np.float32)
    np.testing.assert_allclose(float(prob.J(torch.from_numpy(w))),
                               float(jprob.J(jnp.asarray(w))), rtol=RTOL)
    np.testing.assert_allclose(prob.grad_true(torch.from_numpy(w)).numpy(),
                               np.asarray(jprob.grad_true(jnp.asarray(w))),
                               rtol=RTOL, atol=ATOL)
    assert prob.J_star() == float(jprob.J_star())
    xs, ys = R.agent_batches(prob, torch.Generator().manual_seed(0))
    assert xs.shape == (64, 32, 32) and ys.shape == (64, 32)


def test_session_batches_are_reproducible_per_round():
    a = build_linreg_fleet_session(net=TIERED_M64_QUADRATIC, seed=3,
                                   device="cpu")
    b = build_linreg_fleet_session(net=TIERED_M64_QUADRATIC, seed=3,
                                   device="cpu")
    a.run(2)
    b.run(1)
    b.run(1)
    for x, y in zip(convert.to_numpy(a.state.params).values(),
                    convert.to_numpy(b.state.params).values()):
        np.testing.assert_array_equal(x, y)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_linreg_fleet_session(net=TIERED_M64_QUADRATIC)
    cfg = TrainConfig(optimizer="sgd", num_agents=2, comm="always")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_triggered_train_step(tloss, opt_lib.from_config(cfg), cfg)


def test_unported_paths_raise_with_roadmap_pointer():
    """A mesh that is not the port's ``Mesh`` is refused (the sharded
    step needs its process group), and ``build_hybrid_machinery`` builds
    the hybrid dispatch's machinery; the switch/unroll dispatch, a lossy
    homogeneous step,
    ``masked_mean_quantized``, the drifting problem and a microbatched
    step now run (``microbatches=2`` halves each agent's batch: the
    mean of the halves' mean losses is the whole batch's)."""
    cfg = TrainConfig(optimizer="sgd", num_agents=2,
                      comm=("always", "never"))
    opt = opt_lib.from_config(cfg)
    for dispatch in ("switch", "unroll"):
        step = make_triggered_train_step(
            tloss, opt, cfg, device="cpu",
            options=StepOptions(hetero_dispatch=dispatch))
        _, m = step(init_train_state({"w": torch.ones(3)}, opt, cfg,
                                     device="cpu"),
                    (torch.ones(2, 4, 3), torch.zeros(2, 4)))
        assert float(m["num_tx"]) == 1.0
    with pytest.raises((TypeError, ValueError), match="Mesh"):
        make_triggered_train_step(tloss, opt, cfg, device="cpu",
                                  options=StepOptions(mesh=object()))
    lossy = TrainConfig(optimizer="sgd", num_agents=2,
                        comm="always|int8 @ bernoulli(p=1.0)")
    step = make_triggered_train_step(tloss, opt, lossy, device="cpu")
    state = init_train_state({"w": torch.ones(3)}, opt, lossy, device="cpu")
    batch = (torch.ones(2, 4, 3), torch.zeros(2, 4))
    state, m = step(state, batch)
    assert float(m["num_delivered"]) == 0.0 and float(m["num_tx"]) == 2.0
    np.testing.assert_array_equal(state.params["w"].numpy(), 1.0)
    from repro_torch.core import aggregation

    agg, mem = aggregation.masked_mean_quantized(
        {"w": torch.ones(2, 3)}, torch.ones(2))
    np.testing.assert_array_equal(agg["w"].numpy(), 1.0)
    assert mem is None
    micro = TrainConfig(optimizer="sgd", num_agents=2, comm="always",
                        microbatches=2)
    whole = dataclasses.replace(micro, microbatches=1)
    batch = (torch.arange(24.0).reshape(2, 4, 3) / 10, torch.ones(2, 4))
    (s_m, m_m), (s_w, m_w) = (
        make_triggered_train_step(tloss, opt, c, device="cpu")(
            init_train_state({"w": torch.ones(3)}, opt, c, device="cpu"),
            batch)
        for c in (micro, whole))
    np.testing.assert_allclose(float(m_m["loss"]), float(m_w["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(s_m.params["w"].numpy(),
                               s_w.params["w"].numpy(), rtol=1e-6)
    assert float(m_m["num_tx"]) == 2.0
    from repro_torch.data import synthetic

    assert callable(synthetic.drifting_problem)
    from repro_torch.core.api import HybridMachinery, build_hybrid_machinery

    mach = build_hybrid_machinery(tloss, cfg)
    assert isinstance(mach, HybridMachinery)
    assert mach.bank.agent_index == (0, 1) and len(mach.chains) == 2
    assert (mach.needs_ef, mach.needs_ctrl, mach.needs_net) == (
        False, False, False)
    losses, grads = mach.grad_prologue({"w": torch.ones(3)},
                                       (torch.ones(2, 4, 3),
                                        torch.zeros(2, 4)))
    np.testing.assert_allclose(losses.numpy(), 4.5)
    assert grads["w"].shape == (2, 3)
