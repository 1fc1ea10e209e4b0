"""The port's heterogeneous dispatch paths (``hybrid``, ``switch``,
``unroll``) and ``make_plain_train_step`` against the JAX package, on
the CPU.

Every comparison runs the harness of tests/test_torch_fleet.py
(``_parity_run``): each round both packages start from the JAX step's
state and take the same JAX-drawn batch.  The contract is ROADMAP's:
parameters and float metrics within ``rtol=1e-5, atol=1e-6``; decisions,
deliveries, staleness and ``num_tx`` exactly, except for a gain within
that tolerance of its threshold; EF memory within ``rtol=1e-5`` of each
agent's ``max|g + ef|``.  Where the JAX paths themselves split on a
rounding boundary (ROADMAP §3), the port may match the other JAX path,
once per run.

* m = 4: each port path against the same JAX path over the channel ×
  controller matrix of tests/test_dispatch_differential.py (and under
  AdamW);
* m = 64 (``TOY64``): every ``TIER_MIXES`` layout × channel ×
  controller, the port's three paths against JAX ``hybrid`` and, round
  by round, against each other;
* ``make_plain_train_step``, churn across the paths, and a
  ``gain_quadratic(kernel=true)`` policy under ``switch``/``unroll``
  (one ``gain_reduce`` call per kernel-gated agent).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import regression as JR
from repro.core.api import init_train_state as jinit
from repro.core.api import make_plain_train_step as jmake_plain
from repro.optim import optimizers as jopt_lib
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_linreg import (
    TIER_MIXES,
    LinRegConfig,
    TieredNetwork,
    _adaptive_tiers,
    _lossy,
    _tiers,
)
from repro_torch.core.api import (
    DISPATCH_MODES,
    StepOptions,
    init_train_state,
    make_plain_train_step,
    make_triggered_train_step,
)
from repro_torch.kernels.gain_reduce import ops as gr_ops
from repro_torch.optim import optimizers as opt_lib
from test_torch_fleet import ATOL, RTOL, TOY4, _parity_run, jloss, tloss
from test_torch_net import M4_SPECS

torch.set_num_threads(1)

TOY64 = LinRegConfig(name="toy64", n=6, num_agents=64, samples_per_agent=8,
                     stepsize=0.1, steps=2)

# one channel per wire family, seeded (tests/test_dispatch_differential.py)
CHANNELS = {
    "ideal": None,
    "bernoulli": "bernoulli(p=0.3,seed=3)",
    "delay": "delay(dist=geometric,lag=2.0,max_lag=4,discount=0.5,seed=5)",
}
CONTROLLERS = ("fixed", "adaptive")


def _net(counts, controller, channel, n):
    tiers = (_tiers(*counts, n=n) if controller == "fixed"
             else _adaptive_tiers(*counts, n=n))
    net = TieredNetwork(f"tiers_{controller}", tiers)
    if CHANNELS[channel] is None:
        return net
    return _lossy(net, f"{net.name}_{channel}", CHANNELS[channel])


@pytest.mark.parametrize("path", DISPATCH_MODES)
@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("channel", tuple(CHANNELS))
def test_m4_matrix_each_path_matches_its_jax_path(channel, controller,
                                                  path):
    net = _net((1, 1, 1, 1), controller, channel, TOY4.n)
    _parity_run(TOY4, net.policies(), path,
                alt="unroll" if path != "unroll" else "hybrid",
                rounds=TOY4.steps, port_dispatch=path)


@pytest.mark.parametrize("path", ("switch", "unroll"))
@pytest.mark.parametrize("spec", M4_SPECS)
def test_m4_every_channel_under_switch_and_unroll(spec, path):
    """Each wire of tests/test_torch_net.py (loss, burst loss, the token
    bucket, the delay line, both retransmit modes) on two agents beside
    two channel-free ones, so the per-agent loops run it, against JAX
    ``unroll``."""
    mix = (spec, "always", spec, "gain_lookahead(lam=0.5)|fp16")
    _parity_run(TOY4, mix, "unroll", alt="hybrid", rounds=5,
                port_dispatch=path)


@pytest.mark.parametrize("path", DISPATCH_MODES)
def test_m4_paths_under_adamw(path):
    """The optimizer's slots ride the same contract (the delay wire, the
    case tests/test_dispatch_differential.py runs under AdamW)."""
    net = _net((1, 1, 1, 1), "fixed", "delay", TOY4.n)
    _parity_run(TOY4, net.policies(), path,
                alt="unroll" if path != "unroll" else "hybrid",
                rounds=TOY4.steps, port_dispatch=path, optimizer="adamw",
                lr=0.05)


M64_GRID = [(mix, chan, ctrl) for mix in TIER_MIXES for chan in CHANNELS
            for ctrl in CONTROLLERS]


@pytest.mark.parametrize(
    "mix,channel,controller", M64_GRID,
    ids=[f"{m.name}-{c}-{t}" for m, c, t in M64_GRID])
def test_m64_three_paths_match_jax_hybrid_and_each_other(mix, channel,
                                                         controller):
    """Every tier mix at TOY64 × wire × controller family: the port's
    three paths held to JAX ``hybrid`` (the reference's ``unroll`` takes
    a compile per agent at m = 64) and, each round, to one another."""
    net = _net(tuple(t.count for t in mix.tiers), controller, channel,
               TOY64.n)
    _parity_run(TOY64, net.policies(), "hybrid", rounds=TOY64.steps,
                seed=42, port_dispatch=DISPATCH_MODES)


@pytest.mark.parametrize("spec", [
    ("always", "gain_lookahead(lam=1.0)|fp16",
     "gain_lookahead(lam=2.0)|int8+ef @ bernoulli(p=0.3,seed=3)",
     "budget_dual(rate=0.3)|topk(0.5)|int8+ef"),
    "gain_lookahead(lam=0.5)|int8+ef @ delay(dist=geometric,lag=2.0,"
    "max_lag=4,seed=5)",
])
def test_plain_train_step_matches_jax(spec):
    """``make_plain_train_step``: the policies with ``always`` for the
    trigger (compressors, EF and channels kept), against JAX's, from the
    JAX state each round."""
    comm = spec if isinstance(spec, str) else tuple(spec)
    jcfg = JTrainConfig(lr=TOY4.stepsize, optimizer="sgd",
                        num_agents=TOY4.num_agents, comm=comm)
    tcfg = TrainConfig(lr=TOY4.stepsize, optimizer="sgd",
                       num_agents=TOY4.num_agents, comm=comm)
    jopt, topt = jopt_lib.from_config(jcfg), opt_lib.from_config(tcfg)
    jstep = jax.jit(jmake_plain(jloss, jopt, jcfg))
    tstep = make_plain_train_step(tloss, topt, tcfg, device="cpu")
    # the plain step's state carries the policy's slots but no controller
    jstate = jinit({"w": jnp.zeros(TOY4.n)}, jopt, jcfg)._replace(
        ctrl_state=None)
    problem = JR.make_problem(TOY4, jax.random.key(0))
    for k in range(4):
        batch = JR.agent_batches(problem,
                                 jax.random.fold_in(jax.random.key(13), k))
        tstate = convert.state_from_jax(jax.device_get(jstate), device="cpu")
        jnext, jm = jstep(jstate, batch)
        tnext, tm = tstep(tstate, convert.to_torch(jax.device_get(batch),
                                                   "cpu"))
        tm, jm = convert.to_numpy(tm), jax.device_get(jm)
        assert set(tm) == set(jm)
        assert float(tm["num_tx"]) == TOY4.num_agents
        for key in jm:
            np.testing.assert_allclose(tm[key], jm[key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k}:{key}")
        np.testing.assert_allclose(tnext.params["w"].numpy(),
                                   np.asarray(jnext.params["w"]), rtol=RTOL,
                                   atol=ATOL)
        jstate = jnext


@pytest.mark.parametrize("path", DISPATCH_MODES)
def test_churn_agrees_across_dispatch_paths(path):
    """Churn under each path (tests/test_async_net.py:303's schedule and
    mix): the mask applies after the dispatch, so every path carries it."""
    comm = ("always",
            "gain_lookahead(lam=1.0)|fp16",
            "gain_lookahead(lam=2.0)|int8+ef"
            " @ delay(dist=geometric,lag=2.0,max_lag=4,seed=5)",
            "gain_lookahead(lam=4.0)|topk(0.5)|int8+ef"
            " @ bernoulli(p=0.3,seed=3)")
    churn = ((0, 6), (1, 6), (2, 5), (0, 3))
    _parity_run(TOY4, comm, "unroll", alt="hybrid", rounds=6, churn=churn,
                port_dispatch=path)


def test_kernel_policy_under_switch_and_unroll(monkeypatch):
    """A ``gain_quadratic(kernel=true)`` tier under each path: one
    ``gain_reduce`` call per round for all agents under ``hybrid``, one
    per kernel-gated agent under ``switch``/``unroll`` (the trigger
    computes its own precursor there), and every path matches JAX."""
    calls = {"n": 0}
    inner = gr_ops.gain_reduce

    def counting(g, h):
        calls["n"] += 1
        return inner(g, h)

    counting.launches = 0
    monkeypatch.setattr(gr_ops, "gain_reduce", counting)
    comm = ("always",
            "gain_quadratic(lam=0.05,kernel=true)|int8+ef",
            "gain_quadratic(lam=0.05,kernel=true)|int8+ef",
            "gain_lookahead(lam=0.5)|fp16")
    per_round = {"hybrid": 1, "switch": 2, "unroll": 2}
    for path in DISPATCH_MODES:
        calls["n"] = 0
        _parity_run(TOY4, comm, "unroll", alt="hybrid", rounds=4,
                    port_dispatch=path)
        assert calls["n"] == 4 * per_round[path], (path, calls["n"])


def test_barriers_change_nothing():
    """``barriers`` has no effect in PyTorch: a step built without them
    gives the same round bit for bit."""
    comm = ("always", "gain_lookahead(lam=1.0)|int8+ef")
    cfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=2, comm=comm)
    opt = opt_lib.from_config(cfg)
    batch = (torch.linspace(-1, 1, 2 * 8 * 3).reshape(2, 8, 3),
             torch.linspace(0, 1, 16).reshape(2, 8))
    outs = []
    for barriers in (True, False):
        step = make_triggered_train_step(
            tloss, opt, cfg, device="cpu",
            options=StepOptions(hetero_dispatch="switch", barriers=barriers))
        state = init_train_state({"w": torch.zeros(3)}, opt, cfg,
                                 device="cpu")
        outs.append(step(state, batch))
    (s0, m0), (s1, m1) = outs
    assert torch.equal(s0.params["w"], s1.params["w"])
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
