"""The port's latency channel and scenario churn, on the CPU: the cases
of tests/test_async_net.py but its frontier and dispatch ones.

Delay semantics: payloads enter a fixed-depth per-agent FIFO inside
``net_state``; a matured head is applied with the weight ``w = 1 / (1 +
discount · max(age − 1, 0))`` (``agent_delivered`` reports ``w``);
maturity is forced at ``max_lag``; a full line tail-drops into EF.
Churn: ``StepOptions.churn`` holds per-agent ``(join, leave)`` rounds;
an inactive agent contributes nothing and its state is frozen.  The
churned and delayed fleets are also held to the JAX package's hybrid
step, round by round (the harness of tests/test_torch_fleet.py).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_linreg import churn_schedule as jchurn_schedule
from repro_torch import convert
from repro_torch.comm import CommPolicy
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_linreg import (
    TIERED_M64,
    TIERED_M64_DELAYED,
    LinRegConfig,
    TieredNetwork,
    _lossy,
    _tiers,
    churn_schedule,
)
from repro_torch.core import regression as R
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.data.synthetic import step_generator
from repro_torch.net.channels import build_channel, channel_round, net_init
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


def _run(comm, problem, steps=8, churn=None, chan_scale=None,
         call_scale=None):
    cfg = TrainConfig(lr=TOY.stepsize, optimizer="sgd",
                      num_agents=TOY.num_agents, comm=comm)
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(
        tloss, opt, cfg, device="cpu",
        options=StepOptions(agent_metrics=True, churn=churn,
                            chan_scale=chan_scale))
    state = init_train_state(_params(), opt, cfg, device="cpu")
    hist = []
    for i in range(steps):
        state, m = step(state, R.agent_batches(
            problem, step_generator(7, i, "cpu")), chan_scale=call_scale)
        hist.append(convert.to_numpy(m))
    return state, hist


def _tree_equal(a, b):
    la = jax.tree_util.tree_leaves(convert.to_numpy(a))
    lb = jax.tree_util.tree_leaves(convert.to_numpy(b))
    return len(la) == len(lb) and all(
        np.array_equal(x, y) for x, y in zip(la, lb))


# bernoulli(p=0.5,seed=9) delivery over (step, uid) in the partitionable
# threefry layout, the golden for the fold ORDER: a swap of the two folds
# gives another matrix.  (tests/test_async_net.py commits the matrix of
# the older, non-partitionable layout, which JAX 0.9 no longer draws.)
_DELIVERY_GOLDEN = np.asarray([
    [0, 1, 1, 1],
    [1, 1, 0, 0],
    [1, 1, 0, 0],
    [0, 1, 0, 1],
    [0, 1, 1, 0],
    [0, 0, 1, 0],
], np.float32)


def test_delivery_key_fold_order():
    """Against the golden and against JAX's own draw, key by key; the
    realization varies along both axes."""
    model = build_channel(
        CommPolicy.parse_one("always @ bernoulli(p=0.5,seed=9)").channel)
    rows = torch.tensor([[0.0, 0.0, float(u)] for u in range(4)])
    got = np.stack([channel_round(model, rows, step, None, 1.0)[0].numpy()
                    for step in range(_DELIVERY_GOLDEN.shape[0])])
    np.testing.assert_array_equal(got, _DELIVERY_GOLDEN)
    want = [[float(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(9), step), uid)) >= 0.5) for uid in range(4)]
        for step in range(_DELIVERY_GOLDEN.shape[0])]
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got.tolist()}) > 1
    assert len({tuple(c) for c in got.T.tolist()}) > 1


# ----------------------------------------------------------------------
# delay line
# ----------------------------------------------------------------------

def test_delay_net_state_is_rows_plus_line():
    params = _params()
    pol = CommPolicy.parse_one(
        "always @ delay(dist=deterministic,lag=3,max_lag=4)")
    rows, line = net_init(pol, 4, params)
    assert tuple(rows.shape) == (4, 3)
    np.testing.assert_array_equal(rows[:, 2].numpy(), np.arange(4.0))
    assert tuple(line["meta"].shape) == (4, 4, 2)
    assert tuple(line["buf"]["w"].shape) == (4, 4, TOY.n)
    assert not line["meta"].any()
    bern = CommPolicy.parse_one("always @ bernoulli(p=0.5)")
    assert tuple(net_init(bern, 4, params).shape) == (4, 3)
    with pytest.raises(ValueError, match="delay"):
        net_init(pol, 4)


def test_deterministic_delay_delivers_after_lag(problem):
    _, hist = _run(("always @ delay(dist=deterministic,lag=3,max_lag=4,"
                    "discount=1.0)",) * 4, problem)
    delivered = np.asarray([m["agent_delivered"][0] for m in hist])
    stale = np.asarray([m["agent_staleness"][0] for m in hist])
    np.testing.assert_allclose(delivered, [0, 0, 0] + [1.0 / 3.0] * 5,
                               rtol=1e-6)
    np.testing.assert_array_equal(stale, [1, 2, 3, 0, 0, 0, 0, 0])


def test_zero_discount_weight_is_arrival_indicator(problem):
    _, hist = _run(("always @ delay(dist=deterministic,lag=3,max_lag=4)",)
                   * 4, problem)
    delivered = np.asarray([m["agent_delivered"] for m in hist])
    np.testing.assert_array_equal(np.unique(delivered), [0.0, 1.0])
    np.testing.assert_array_equal(delivered[3:], 1.0)


def test_force_maturity_at_max_lag(problem):
    sg, hg = _run(("always @ delay(dist=geometric,lag=1.0,max_lag=1,"
                   "seed=4)",) * 4, problem)
    sd, hd = _run(("always @ delay(dist=deterministic,lag=1,max_lag=1,"
                   "seed=4)",) * 4, problem)
    assert _tree_equal(sg, sd)
    for mg, md in zip(hg, hd):
        for k in md:
            np.testing.assert_array_equal(mg[k], md[k], err_msg=k)
    np.testing.assert_array_equal(
        [m["agent_delivered"][0] for m in hg], [0] + [1] * 7)


def test_geometric_delay_staleness_is_bounded_by_max_lag(problem):
    _, hist = _run(("always @ delay(dist=geometric,lag=2.0,max_lag=4,"
                    "seed=11)",) * 4, problem, steps=16)
    stale = np.asarray([m["agent_staleness"] for m in hist])
    assert float(stale.max()) <= 4.0
    delivered = np.asarray([m["agent_delivered"] for m in hist])
    assert 0.0 < float(delivered[1:].mean()) < 1.0


def test_delay_chan_scale_multiplies_mean_lag(problem):
    """A harsher severity stretches the mean lag: the tail staleness of
    the severity-2 run dominates the severity-0.25 run's; the call-time
    value and the pinned option give the same run."""
    comm = ("always @ delay(dist=geometric,lag=2.0,max_lag=6,seed=2)",) * 4
    _, mild = _run(comm, problem, steps=24, chan_scale=0.25)
    _, harsh = _run(comm, problem, steps=24, call_scale=2.0)
    _, pinned = _run(comm, problem, steps=24, chan_scale=2.0)
    ms = lambda h: np.mean([m["mean_staleness"] for m in h[8:]])
    assert ms(harsh) > ms(mild)
    for a, b in zip(harsh, pinned):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ----------------------------------------------------------------------
# scenario churn
# ----------------------------------------------------------------------

def test_all_active_churn_matches_no_churn_bitwise(problem):
    T = 6
    comm = ("always|int8+ef",) * 4
    s0, h0 = _run(comm, problem, steps=T, churn=None)
    s1, h1 = _run(comm, problem, steps=T, churn=((0, T),) * 4)
    assert _tree_equal(s0.params, s1.params)
    assert _tree_equal(s0.ef_memory, s1.ef_memory)
    assert set(h1[0]) - set(h0[0]) == {"num_active", "agent_active"}
    for m0, m1 in zip(h0, h1):
        for k in m0:
            np.testing.assert_array_equal(m1[k], m0[k], err_msg=k)
    np.testing.assert_array_equal([m["num_active"] for m in h1], 4.0)


def test_churn_masks_joins_and_leaves(problem):
    T = 6
    churn = ((0, T), (0, T), (2, T), (0, 2))
    _, hist = _run(("always|int8+ef",) * 4, problem, steps=T, churn=churn)
    for i, m in enumerate(hist):
        want = np.asarray([1.0, 1.0, float(i >= 2), float(i < 2)],
                          np.float32)
        np.testing.assert_array_equal(m["agent_active"], want, err_msg=i)
        assert float(m["num_active"]) == float(want.sum())
        np.testing.assert_array_equal(m["agent_bytes"] > 0, want > 0)
        assert float(m["comm_rate"]) == 1.0


def test_churned_agent_state_is_frozen(problem):
    T = 8
    churn = ((0, T), (0, T), (0, T), (4, T))
    comm = ("gain_lookahead(lam=0.5)|int8+ef"
            " @ delay(dist=deterministic,lag=2,max_lag=3)",) * 4
    _, hist = _run(comm, problem, steps=T, churn=churn)
    for m in hist[:4]:
        assert float(m["agent_tx"][3]) == 0.0
        assert float(m["agent_bytes"][3]) == 0.0
        assert float(m["agent_staleness"][3]) == 0.0  # frozen at its start
    assert any(float(m["agent_tx"][3]) > 0.0 for m in hist[4:])


def test_churn_mix_matches_jax_hybrid():
    """Churn over a mixed bank (lossless, fp16, a delay line, a lossy
    top-k tier) against the JAX hybrid step."""
    T = 6
    churn = ((0, T), (1, T), (2, 5), (0, 3))
    comm = ("always",
            "gain_lookahead(lam=1.0)|fp16",
            "gain_lookahead(lam=2.0)|int8+ef"
            " @ delay(dist=geometric,lag=2.0,max_lag=4,seed=5)",
            "gain_lookahead(lam=4.0)|topk(0.5)|int8+ef"
            " @ bernoulli(p=0.3,seed=3)")
    _parity_run(TOY, comm, "hybrid", rounds=T, churn=churn)


def test_churned_m64_delayed_fleet_matches_jax_hybrid():
    """``TIERED_M64_DELAYED``'s tiers at TOY64 under ``churn_schedule``
    over 8 rounds: late agents join at round 2, early ones leave at 6."""
    tiers = _tiers(*(t.count for t in TIERED_M64.tiers), n=TOY64.n)
    net = _lossy(TieredNetwork("toy64", tiers), "toy64_delayed",
                 TIERED_M64_DELAYED.tiers[1].policy.split(" @ ")[1])
    churn = churn_schedule(net, 8)
    assert {j for j, _ in churn} == {0, 2} and {e for _, e in churn} == {6, 8}
    _parity_run(TOY64, net.policies(), "hybrid", rounds=8, seed=42,
                churn=churn)


def test_churn_schedule_helper_matches_jax():
    from test_torch_fleet import _jax_net

    for steps in (8, 40, 240):
        sched = churn_schedule(TIERED_M64, steps)
        assert sched == jchurn_schedule(_jax_net(TIERED_M64), steps)
        for (join, leave), tier in zip(sched, TIERED_M64.tier_index()):
            assert 0 <= join < leave <= steps
            if tier == 0:
                assert (join, leave) == (0, steps)


@pytest.mark.parametrize("churn,match", [
    (((0, 4),) * 3, "churn schedule has 3"),
    (((0, 4, 5),) * 4, "pairs"),
    (((3, 3),) * 4, "join < leave"),
])
def test_churn_is_validated(churn, match):
    cfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=4,
                      comm=("always",) * 4)
    opt = opt_lib.from_config(cfg)
    with pytest.raises(ValueError, match=match):
        make_triggered_train_step(tloss, opt, cfg, device="cpu",
                                  options=StepOptions(churn=churn))
