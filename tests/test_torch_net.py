"""The port's lossy channels (``repro_torch.net.channels``) through the
train step, on the CPU: the spec surface, the ``net_state`` slot and
its None-is-free contract, each channel's semantics, the whole-payload
EF fold on a drop, staleness escalation and delivered-byte pricing
(the cases of tests/test_net.py but its frontier ones), then parity
with the JAX package:

* each channel's draw on the same keys, bit for bit;
* m = 4 steps against JAX ``unroll`` and the m = 64 tier fleets
  (``TIERED_M64`` × {bernoulli, delay} × {fixed, adaptive} at TOY64)
  against JAX ``hybrid``, round by round from the JAX state: decisions,
  deliveries and staleness exactly (but a gain on its threshold), floats
  within ``rtol=1e-5, atol=1e-6`` (the harness of tests/test_torch_fleet.py);
* ``convert.state_from_jax`` with a channel slot in both forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommPolicy as JCommPolicy
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.paper_linreg import LinRegConfig
from repro.core.api import init_train_state as jinit
from repro.net import channels as jnet
from repro.optim import optimizers as jopt_lib
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.comm import CommPolicy
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_linreg import (
    TIERED_M64,
    TieredNetwork,
    _adaptive_tiers,
    _lossy,
    _tiers,
)
from repro_torch.core import regression as R
from repro_torch.core.api import (
    NET_METRIC_KEYS,
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.data.synthetic import step_generator
from repro_torch.net.channels import (
    NET_WIDTH,
    build_channel,
    channel_round,
    net_init,
    spec_is_trivial,
    stale_scale,
    tx_cost,
)
from repro_torch.optim import optimizers as opt_lib
from test_torch_fleet import _parity_run, tloss

torch.set_num_threads(1)

TOY = LinRegConfig(name="toy", n=6, num_agents=4, samples_per_agent=8,
                   stepsize=0.1, steps=6)
TOY64 = LinRegConfig(name="toy64", n=6, num_agents=64, samples_per_agent=8,
                     stepsize=0.1, steps=2)


@pytest.fixture(scope="module")
def problem():
    return R.make_problem(TOY, step_generator(0, 0, "cpu"), device="cpu")


def _params():
    return {"w": torch.zeros(TOY.n)}


def _cfg(comm, num_agents=TOY.num_agents):
    return TrainConfig(lr=TOY.stepsize, optimizer="sgd",
                       num_agents=num_agents, comm=comm)


def _batch(problem, i):
    return R.agent_batches(problem, step_generator(7, i, "cpu"))


def _run(cfg, problem, steps, state=None, **opts):
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(tloss, opt, cfg, device="cpu",
                                     options=StepOptions(**opts))
    if state is None:
        state = init_train_state(_params(), opt, cfg, device="cpu")
    hist = []
    for i in range(steps):
        state, m = step(state, _batch(problem, i))
        hist.append(convert.to_numpy(m))
    return state, hist


def _leaves(tree):
    return jax.tree_util.tree_leaves(convert.to_numpy(tree))


def _tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(x, y) for x, y in zip(la, lb))


def _hist_equal(ha, hb):
    return all(set(ma) == set(mb)
               and all(np.array_equal(ma[k], mb[k]) for k in ma)
               for ma, mb in zip(ha, hb))


# ----------------------------------------------------------------------
# spec surface
# ----------------------------------------------------------------------

def test_channel_spec_round_trips():
    pol = CommPolicy.parse(
        "gain_lookahead(lam=0.1)|topk(0.05)|int8+ef @ bernoulli(p=0.2)")
    assert pol.channel is not None and pol.channel.name == "bernoulli"
    assert " @ bernoulli(p=0.2)" in str(pol)
    assert CommPolicy.parse(str(pol)) == pol
    ge = CommPolicy.parse(
        "always @ gilbert_elliott(p_gb=0.2,p_loss_bad=0.9,seed=4)")
    assert CommPolicy.parse(str(ge)) == ge
    pols = tuple(CommPolicy.parse(s) for s in
                 ("always", "always @ bernoulli(p=0.5)"))
    assert [p.needs_net for p in pols] == [False, True]


@pytest.mark.parametrize("spec,match", [
    ("always @ nope", "unknown channel"),
    ("always @ bernoulli(p=1.5)", r"\[0, 1\]"),
    ("always @ rate(bytes_per_round=0)", "positive"),
    ("always @ rate(burst=0.5)", "burst"),
    ("always @ delay(lag=5,max_lag=4)", "lag"),
    ("always @ delay(max_lag=0)", "max_lag"),
    ("always @ delay(discount=-1)", "discount"),
    ("always @ retx(k=0)", "retx k"),
    ("always @ retx(model=rate)", "loss channel"),
])
def test_bad_channel_specs_error(spec, match):
    with pytest.raises(ValueError, match=match):
        CommPolicy.parse(spec).channel_model()


def test_delivery_key_derivation_order():
    """``fold_in(fold_in(PRNGKey(seed), step), uid)``: step folded
    first, against an explicit JAX re-derivation over a grid."""
    model = build_channel(
        CommPolicy.parse("always @ bernoulli(p=0.5,seed=9)").channel)
    rows = torch.tensor([[0.0, 0.0, float(u)] for u in range(3)])
    for step in range(4):
        d, _, _ = channel_round(model, rows, step, None, 1.0)
        want = [float(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(9), step), uid)) >= 0.5)
            for uid in range(3)]
        np.testing.assert_array_equal(d.numpy(), want, err_msg=str(step))


def test_ideal_channel_is_statically_free():
    assert spec_is_trivial(CommPolicy.parse("always @ ideal").channel)
    for spec in ("always", "always @ ideal"):
        pol = CommPolicy.parse(spec)
        assert not pol.needs_net
        assert net_init(pol, 4) is None
    assert CommPolicy.parse("always @ bernoulli(p=0.2)").needs_net


def test_ideal_and_channel_free_runs_are_bitwise_equal(problem):
    base = "gain_lookahead(lam=0.5)|int8+ef"
    s_plain, h_plain = _run(_cfg(base), problem, steps=5)
    s_ideal, h_ideal = _run(_cfg(f"{base} @ ideal"), problem, steps=5)
    assert s_ideal.net_state is None
    assert _tree_equal(s_plain, s_ideal)
    assert _hist_equal(h_plain, h_ideal)
    assert not set(NET_METRIC_KEYS) & set(h_ideal[0])


# ----------------------------------------------------------------------
# net_state slot
# ----------------------------------------------------------------------

def test_net_state_layout_and_init():
    spec = "always|int8 @ rate(bytes_per_round=8,burst=2)"
    ns = net_init(CommPolicy.parse(spec), 3)
    assert ns.shape == (3, NET_WIDTH) and ns.dtype == torch.float32
    np.testing.assert_array_equal(
        ns.numpy(), np.asarray(jnet.net_init(JCommPolicy.parse(spec), 3)))
    np.testing.assert_array_equal(ns[:, 1].numpy(), 16.0)
    specs = ("always", "always @ bernoulli(p=0.5)",
             "always @ rate(bytes_per_round=4,burst=3)")
    ns2 = net_init(tuple(CommPolicy.parse(s) for s in specs), 3)
    np.testing.assert_array_equal(ns2.numpy(), np.asarray(jnet.net_init(
        tuple(JCommPolicy.parse(s) for s in specs), 3)))


def test_missing_net_state_warns_and_runs_lossless(problem):
    cfg = _cfg("always @ bernoulli(p=1.0)")
    opt = opt_lib.from_config(cfg)
    state = init_train_state(_params(), opt, cfg,
                             device="cpu")._replace(net_state=None)
    with pytest.warns(UserWarning, match="net_state"):
        state2, hist = _run(cfg, problem, steps=3, state=state)
    s_ideal, h_ideal = _run(_cfg("always"), problem, steps=3)
    assert _tree_equal(state2.params, s_ideal.params)
    assert _hist_equal(hist, h_ideal)


# ----------------------------------------------------------------------
# channel semantics
# ----------------------------------------------------------------------

def test_bernoulli_p0_matches_ideal_and_p1_freezes(problem):
    s_ideal, _ = _run(_cfg("always"), problem, steps=4)
    s_p0, h_p0 = _run(_cfg("always @ bernoulli(p=0.0)"), problem, steps=4)
    np.testing.assert_array_equal(s_p0.params["w"].numpy(),
                                  s_ideal.params["w"].numpy())
    assert float(h_p0[-1]["mean_staleness"]) == 0.0
    assert float(h_p0[-1]["delivered_rate"]) == 1.0
    assert float(h_p0[-1]["wire_bytes"]) == float(
        h_p0[-1]["wire_bytes_attempted"])
    s_p1, h_p1 = _run(_cfg("always @ bernoulli(p=1.0)"), problem, steps=4)
    np.testing.assert_array_equal(s_p1.params["w"].numpy(), 0.0)
    assert float(h_p1[-1]["delivered_rate"]) == 0.0
    assert float(h_p1[-1]["wire_bytes"]) == 0.0
    assert float(h_p1[-1]["wire_bytes_attempted"]) > 0.0
    np.testing.assert_array_equal(s_p1.net_state[:, 0].numpy(), 4.0)


def test_ef_folds_whole_gradient_back_on_drop(problem):
    """After K all-dropped rounds the EF memory is exactly the sum of
    the raw per-agent gradients, and the params never moved."""
    state, _ = _run(_cfg("always|int8+ef @ bernoulli(p=1.0)"), problem,
                    steps=3)
    grad = torch.func.vmap(torch.func.grad(tloss), in_dims=(None, 0))
    expect = sum(grad(_params(), _batch(problem, i))["w"] for i in range(3))
    np.testing.assert_allclose(state.ef_memory["w"].numpy(), expect.numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(state.params["w"].numpy(), 0.0)


def test_gilbert_elliott_state_machine():
    model = build_channel(CommPolicy.parse(
        "always @ gilbert_elliott(p_gb=0.0,p_bg=0.0,"
        "p_loss_good=0.0,p_loss_bad=1.0)").channel)
    key = tr.PRNGKey(0)[None]
    d, aux = model.draw(key, torch.zeros(1), None, 0.0)
    assert float(d) == 1.0 and float(aux) == 0.0   # pinned good
    d, aux = model.draw(key, torch.ones(1), None, 0.0)
    assert float(d) == 0.0 and float(aux) == 1.0   # pinned bad
    d, _ = model.draw(key, torch.ones(1), 0.0, 0.0)
    assert float(d) == 1.0                         # severity 0: lossless


def test_rate_token_bucket_is_deterministic():
    model = build_channel(CommPolicy.parse(
        "always @ rate(bytes_per_round=4,burst=2)").channel)
    aux = torch.full((1,), model.init_aux)
    got = []
    for _ in range(6):
        d, aux_mid = model.draw(None, aux, None, 8.0)
        got.append(float(d))
        aux = model.update(aux_mid, d, 8.0)
    assert got == [1.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    narrow = build_channel(CommPolicy.parse(
        "always @ rate(bytes_per_round=4,burst=1)").channel)
    aux = torch.full((1,), narrow.init_aux)
    for _ in range(3):
        d, aux_mid = narrow.draw(None, aux, None, 8.0)
        assert float(d) == 0.0
        aux = narrow.update(aux_mid, d, 8.0)


def test_tx_cost_prices_one_agent_dense_times_ratio():
    g = {"w": torch.zeros(3, 10)}  # 3 agents x 10 fp32 → 40 dense bytes
    assert tx_cost(g, None) == 40.0
    assert tx_cost(g, CommPolicy.parse("always|int8").chain()) == 10.0
    sk = CommPolicy.parse("always|sketch(rows=3,cols=8)").chain()
    assert tx_cost(g, sk) == 40.0


@pytest.mark.parametrize("scale", [None, 2.0])
@pytest.mark.parametrize("adaptive", [False, True])
def test_stale_scale_matches_jax(scale, adaptive):
    stale = np.asarray([0.0, 1.0, 4.0, 17.0], np.float32)
    s = torch.tensor(2.0)
    assert stale_scale(s, 0.0, torch.tensor(5.0), adaptive=False) is s
    got = stale_scale(scale, 0.5, torch.from_numpy(stale), adaptive)
    want = jax.vmap(lambda st: jnet.stale_scale(
        scale, 0.5, st, adaptive))(jnp.asarray(stale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_controller_prices_delivered_not_attempted(problem):
    base = "budget_dual(rate=0.3,lam0=0.5)|int8"
    _, h_ideal = _run(_cfg(base), problem, steps=8, agent_metrics=True)
    _, h_lossy = _run(_cfg(f"{base} @ bernoulli(p=1.0)"), problem,
                      steps=8, agent_metrics=True)
    assert float(h_lossy[-1]["agent_lam"].mean()) < float(
        h_ideal[-1]["agent_lam"].mean())


# ----------------------------------------------------------------------
# draws and steps against the JAX package
# ----------------------------------------------------------------------

DRAW_SPECS = ("bernoulli(p=0.3,seed=3)", "gilbert_elliott(seed=2)",
              "gilbert_elliott(p_gb=0.5,p_bg=0.2,p_loss_good=0.3,seed=6)",
              "rate(bytes_per_round=6,burst=2)", "retx(k=2,p=0.4,seed=1)",
              "retx(model=gilbert_elliott,seed=4)")


@pytest.mark.parametrize("chan_scale", [None, 0.0, 0.5, 2.0])
@pytest.mark.parametrize("spec", DRAW_SPECS)
def test_channel_draws_match_jax(spec, chan_scale):
    """The draw over 16 agents × 5 steps from random channel states:
    delivery and the state it carries, bitwise."""
    tm = CommPolicy.parse(f"always @ {spec}").channel_model()
    jm = JCommPolicy.parse(f"always @ {spec}").channel_model()
    rng = np.random.default_rng(3)
    aux = (rng.integers(0, 2, 16) if "gilbert" in spec
           else rng.integers(0, 4, 16) * 3.0).astype(np.float32)
    uid = np.arange(16, dtype=np.float32)
    cs = None if chan_scale is None else np.float32(chan_scale)
    for step in range(5):
        rows = np.stack([np.zeros(16, np.float32), aux, uid], 1)
        d, _, fin = channel_round(tm, torch.from_numpy(rows), step,
                                  chan_scale, 12.0)
        new = fin(d)
        jd, jnew = jax.vmap(lambda r: (lambda o: (o[0], o[2](o[0])))(
            jnet.channel_round(jm, r, jnp.int32(step), cs, 12.0)))(
            jnp.asarray(rows))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
        aux = new[:, 1].numpy()


@pytest.mark.parametrize("chan_scale", [None, 0.5, 2.0])
def test_delay_maturity_matches_jax(chan_scale):
    for spec in ("delay(dist=geometric,lag=2.0,max_lag=4,seed=5)",
                 "delay(dist=deterministic,lag=3,max_lag=4)"):
        tm = CommPolicy.parse(f"always @ {spec}").channel_model()
        jm = JCommPolicy.parse(f"always @ {spec}").channel_model()
        age = np.tile(np.arange(6, dtype=np.float32), 3)
        keys = jax.random.split(jax.random.PRNGKey(1), age.size)
        cs = None if chan_scale is None else np.float32(chan_scale)
        got = tm.mature(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                        torch.from_numpy(age), chan_scale)
        want = jax.vmap(lambda k, a: jm.mature(k, a, cs))(keys,
                                                          jnp.asarray(age))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


M4_SPECS = (
    "always|int8+ef @ bernoulli(p=0.3,seed=3)",
    "gain_lookahead(lam=0.5)|int8+ef @ bernoulli(p=0.2,boost=0.05)",
    "budget_dual(rate=0.5)|int8+ef @ gilbert_elliott(seed=2)",
    "budget_window(bytes=9.0)|int8+ef @ bernoulli(p=0.4,seed=8)",
    "always|int8 @ rate(bytes_per_round=8,burst=2)",
    "gain_lookahead(lam=0.3)|int8+ef @ delay(dist=geometric,lag=2.0,"
    "max_lag=4,discount=0.5,seed=5)",
    "budget_dual(rate=0.5)|topk(0.5)|int8+ef @ delay(dist=deterministic,"
    "lag=2,max_lag=3)",
    "gain_lookahead(lam=0.3)|int8+ef @ retx(k=2,p=0.4,seed=1)",
    "gain_lookahead(lam=0.3)|int8+ef @ retx(k=1,fresh=true,p=0.4,seed=1)",
)


@pytest.mark.parametrize("spec", M4_SPECS)
def test_m4_lossy_steps_match_jax_unroll(spec):
    _parity_run(TOY, spec, "unroll", alt="hybrid", rounds=6)


@pytest.mark.parametrize("chan_scale", [0.0, 0.5, 2.0])
def test_m4_chan_scale_matches_jax(chan_scale):
    """A pinned severity (``StepOptions.chan_scale``) through a mixed
    bank: loss, burst loss, a token bucket and a delay line."""
    specs = ("always|int8+ef @ bernoulli(p=0.3,seed=3)",
             "gain_lookahead(lam=0.4)|fp16 @ gilbert_elliott(seed=2)",
             "always|int8 @ rate(bytes_per_round=8,burst=2)",
             "gain_lookahead(lam=0.3)|int8+ef @ delay(dist=geometric,"
             "lag=2.0,max_lag=4,seed=5)")
    _parity_run(TOY, specs, "unroll", alt="hybrid", rounds=5,
                chan_scale=chan_scale)


def _m4_net(kind, channel):
    tiers = (_tiers(1, 1, 1, 1, n=TOY.n) if kind == "fixed"
             else _adaptive_tiers(1, 1, 1, 1, n=TOY.n))
    return _lossy(TieredNetwork(f"toy4_{kind}", tiers), "toy4", channel)


CHANNELS = {
    "bernoulli": "bernoulli(p=0.3,seed=3)",
    "delay": "delay(dist=geometric,lag=2.0,max_lag=4,discount=0.5,seed=5)",
}


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
@pytest.mark.parametrize("channel", list(CHANNELS))
def test_m4_tier_mix_matches_jax_unroll(channel, kind):
    net = _m4_net(kind, CHANNELS[channel])
    _parity_run(TOY, net.policies(), "unroll", alt="hybrid", rounds=6)


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
@pytest.mark.parametrize("channel", list(CHANNELS))
def test_m64_fleet_matches_jax_hybrid(channel, kind):
    """``TIERED_M64``'s layout (fixed λ or controllers) at TOY64 with
    the channel on its metered tiers, 2 rounds against JAX hybrid."""
    tiers = (_tiers(*(t.count for t in TIERED_M64.tiers), n=TOY64.n)
             if kind == "fixed" else
             _adaptive_tiers(*(t.count for t in TIERED_M64.tiers),
                             n=TOY64.n))
    net = _lossy(TieredNetwork(f"toy64_{kind}", tiers), "toy64",
                 CHANNELS[channel])
    _parity_run(TOY64, net.policies(), "hybrid", rounds=2, seed=42)


@pytest.mark.parametrize("form", ["rows", "rows_and_line"])
def test_state_from_jax_carries_net_state(form):
    channel = ("bernoulli(p=0.2)" if form == "rows" else
               "delay(dist=geometric,lag=2.0,max_lag=3)")
    specs = ("always", f"always|int8+ef @ {channel}")
    jcfg = JTrainConfig(lr=0.1, optimizer="sgd", num_agents=2, comm=specs)
    jstate = jinit({"w": jnp.arange(4.0)}, jopt_lib.from_config(jcfg), jcfg)
    tstate = convert.state_from_jax(jax.device_get(jstate), device="cpu")
    if form == "rows":
        assert isinstance(tstate.net_state, torch.Tensor)
    else:
        rows, line = tstate.net_state
        assert set(line) == {"meta", "buf"}
        assert tuple(line["buf"]["w"].shape) == (2, 3, 4)
    assert _tree_equal(tstate.net_state, jax.device_get(jstate.net_state))
    cfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=2, comm=specs)
    mine = init_train_state({"w": torch.arange(4.0)},
                            opt_lib.from_config(cfg), cfg, device="cpu")
    assert _tree_equal(mine.net_state, tstate.net_state)
