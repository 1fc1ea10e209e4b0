"""The port's fleet-sharded train step (``repro_torch.sharding.agent_shard``)
over gloo ranks on the CPU, against the JAX package.

The ranks are processes that ``repro_torch.launch.mesh.spawn`` starts
(``tests/torch_shard_ranks.py`` holds their programs, which import no
JAX); every spawn has a timeout, so a hung rank fails the test instead of
the suite.  One module fixture runs the G = 4 gateway programs in one
spawn; the test process runs the JAX side on the same numpy inputs:

* every ``TIER_MIXES`` fleet and ``TIERED_M64_ADAPTIVE_LOSSY`` (3 rounds),
  a churned delay fleet and the kernel-gated ``TIERED_M64_QUADRATIC``
  (its ``gain_reduce`` through the plain version here) against the JAX
  package's hybrid step: every float within ``rel < 5e-6`` (JAX's own
  sharded-vs-hybrid contract, tests/test_shard_fleet.py), decisions,
  deliveries, staleness and the churn mask exactly;
* the O(#gateways) evidence: the counted ``all_reduce`` operand bytes of
  one step are equal at m = 256 and m = 1024;
* the sharded ``run_frontier`` at 2 and 8 lanes against JAX's unsharded
  ``run_frontier``, with one payload ``all_reduce`` per round;
* sketch-native against the JAX package's sharded sketch-native step
  (run in a subprocess under ``--xla_force_host_platform_device_count=4``,
  as tests/test_shard_fleet.py does);
* a sharded session that resumes an unsharded port checkpoint, and whose
  checkpoint the JAX package's unsharded session restores bitwise.

And one test at G = 8.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks as ranks
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.paper_linreg import TIER_MIXES as JTIER_MIXES
from repro.configs.paper_linreg import TierSpec as JTierSpec
from repro.configs.paper_linreg import TieredNetwork as JTieredNetwork
from repro.core import regression as JR
from repro.core.api import StepOptions as JStepOptions
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.core.frontier import run_frontier as jrun_frontier
from repro.launch.session import SessionOptions as JSessionOptions
from repro.launch.session import build_linreg_fleet_session as jbuild_session
from repro.optim import optimizers as jopt_lib
from repro_torch import convert
from repro_torch.configs.paper_linreg import (
    TIER_MIXES,
    TIERED_M64,
    TIERED_M64_ADAPTIVE_LOSSY,
    TIERED_M64_CFG,
    TIERED_M64_DELAYED,
    TIERED_M64_QUADRATIC,
    churn_schedule,
)
from repro_torch.launch.mesh import spawn
from repro_torch.launch.session import (
    SessionOptions,
    build_linreg_fleet_session,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, M, STEPS, G = 6, 64, 3, 4
REL = 5e-6  # tests/test_shard_fleet.py's sharded-vs-hybrid contract
TIMEOUT_S = 240
EXACT_KEYS = ("agent_tx", "num_tx", "any_tx", "agent_delivered",
              "agent_staleness", "agent_active", "num_active",
              "num_delivered")
SKETCH_POLICY = "gain_lookahead(lam=0.5)|sketch(rows=5,cols=16,seed=3)+ef"
FRONTIER_SCALES = {2: (0.5, 2.0), 8: tuple(np.linspace(0.5, 2.0, 8))}
SESSION_NET = TIERED_M64_QUADRATIC


def jloss(params, batch):
    return 0.5 * jnp.mean((batch["xs"] @ params["w"] - batch["ys"]) ** 2)


def _jbatch(key, m=M):
    kx, ky = jax.random.split(key)
    return {"xs": jax.random.normal(kx, (m, 8, N)),
            "ys": jax.random.normal(ky, (m, 8))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


PARAMS0 = {"w": np.asarray(jax.random.normal(jax.random.key(0), (N,)))}
BATCHES = [_np(_jbatch(jax.random.fold_in(jax.random.key(13), i)))
           for i in range(STEPS)]
FRONTIER_KEYS = jax.random.split(jax.random.key(5), STEPS)
FRONTIER_BATCHES = [_np(_jbatch(k)) for k in FRONTIER_KEYS]


def _jax_net(net):
    return JTieredNetwork(net.name, tuple(
        JTierSpec(**dataclasses.asdict(t)) for t in net.tiers))


def _cases():
    churn = churn_schedule(TIERED_M64_DELAYED, STEPS)
    return ([(net.name, net.policies(lam_base=1.0), None)
             for net in TIER_MIXES + (TIERED_M64_ADAPTIVE_LOSSY,
                                      TIERED_M64_QUADRATIC)]
            + [("churned", TIERED_M64_DELAYED.policies(lam_base=1.0),
                churn)])


def _session_batches(rounds):
    problem = JR.make_problem(TIERED_M64_CFG, jax.random.key(0))
    key = jax.random.key(1)
    return [_np(JR.agent_batches(problem, jax.random.fold_in(key, k)))
            for k in range(rounds)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The G = 4 programs' results on every rank, from one spawn, after
    an unsharded port session has written its round-2 checkpoint for
    them."""
    ckpt_dir = str(tmp_path_factory.mktemp("shard_ckpt"))
    batches = _session_batches(4)
    first = build_linreg_fleet_session(
        net=SESSION_NET, device="cpu",
        batch_fn=lambda k: tuple(convert.to_torch(batches[k], "cpu")),
        options=SessionOptions(ckpt_dir=ckpt_dir))
    first.run(2)
    first.checkpoint()
    jobs = {
        "fleets": ("run_fleets", (_cases(), PARAMS0, BATCHES)),
        "bytes": ("operand_bytes", ((256, 1024), N)),
        "sketch": ("sketch_native", (SKETCH_POLICY, PARAMS0, BATCHES,
                                     4096)),
        "session": ("session", (SESSION_NET, ckpt_dir, 2, batches)),
    }
    for lanes, scales in FRONTIER_SCALES.items():
        jobs[f"frontier{lanes}"] = ("frontier", (
            TIERED_M64.policies(lam_base=1.0), PARAMS0, scales,
            FRONTIER_BATCHES))
    out = spawn(ranks.run_jobs, G, timeout_s=TIMEOUT_S, backend="gloo",
                device="cpu", args=(jobs,))
    return out, ckpt_dir, batches


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not a.size:
        return 0.0
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(a))))


def _hold_metrics(got, want, tag):
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    for key in want:
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=f"{tag} {key}")
        else:
            assert _rel(want[key], got[key]) < REL, (tag, key)


def _hold_state(got, want, tag):
    """A gathered port state against a JAX state, leaf by leaf."""
    want = convert.state_from_jax(jax.device_get(want), device="cpu")
    assert got.step == want.step, tag
    for name in ("params", "opt_state", "ef_memory", "ctrl_state",
                 "net_state"):
        g = jax.tree_util.tree_leaves(getattr(got, name))
        w = jax.tree_util.tree_leaves(convert.to_numpy(getattr(want, name)))
        assert len(g) == len(w), (tag, name)
        for x, y in zip(g, w):
            if name == "net_state" and x.ndim == 2 and x.shape[1] == 3:
                np.testing.assert_array_equal(x, y, err_msg=tag)
            else:
                assert _rel(y, x) < REL, (tag, name)


def _jax_fleet(comm, churn):
    cfg = JTrainConfig(lr=ranks.LR, optimizer="sgd", num_agents=M,
                       comm=comm)
    opt = jopt_lib.from_config(cfg)
    step = jax.jit(jmake(jloss, opt, cfg, options=JStepOptions(
        hetero_dispatch="hybrid", barriers=False, agent_metrics=True,
        churn=churn)))
    state = jinit({"w": jnp.asarray(PARAMS0["w"])}, opt, cfg)
    metrics = []
    for b in BATCHES:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b))
        metrics.append(_np(m))
    return state, metrics


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_sharded_step_matches_jax_hybrid(sharded, case):
    """Each fleet's 3 gathered rounds against the JAX hybrid step: every
    metric of every round, then the final state, slot by slot; every
    rank holds the same replicated parameters."""
    out, _, _ = sharded
    _, comm, churn = next(c for c in _cases() if c[0] == case)
    jstate, jmetrics = _jax_fleet(comm, churn)
    state, metrics = out[0]["fleets"][case]
    for k, (got, want) in enumerate(zip(metrics, jmetrics)):
        _hold_metrics(got, want, f"{case} round {k}")
    _hold_state(state, jstate, case)
    for other in out[1:]:
        np.testing.assert_array_equal(other["fleets"][case][0].params["w"],
                                      state.params["w"])
    if churn is not None:
        active = [float(m["num_active"]) for m in metrics]
        assert active[0] < M and active == [
            sum(j <= k < e for j, e in churn) for k in range(STEPS)]


def test_all_reduce_operand_bytes_are_flat_in_m(sharded):
    """Two all_reduce calls per step, one payload (n × 4 bytes) and one
    of packed scalars, with the same operand bytes at m = 256 and
    m = 1024: O(#gateways), not O(m)."""
    out, _, _ = sharded
    tags = out[0]["bytes"]
    assert tags[256] == tags[1024], tags
    assert set(tags[256]) == {"payload", "scalars"}
    assert tags[256]["payload"]["count"] == 1
    assert tags[256]["scalars"]["count"] == 1
    assert tags[256]["payload"]["operand_bytes"] == N * 4
    # five column sums and one any_tx slot per gateway, fp32
    assert tags[256]["scalars"]["operand_bytes"] == (5 + G) * 4
    # ring all-reduce: 2·b·(n−1)/n on the wire
    assert tags[256]["payload"]["wire_bytes"] == 2 * N * 4 * (G - 1) / G


@pytest.mark.parametrize("lanes", sorted(FRONTIER_SCALES))
def test_sharded_frontier_matches_jax_unsharded(sharded, lanes):
    """The sharded frontier's lanes against JAX's unsharded
    ``run_frontier`` on the same rounds, and one payload all_reduce per
    round for all lanes (its operand the lanes' stacked payloads)."""
    out, _, _ = sharded
    state, metrics, tags = out[0][f"frontier{lanes}"]
    comm = TIERED_M64.policies(lam_base=1.0)
    cfg = JTrainConfig(lr=ranks.LR, optimizer="sgd", num_agents=M,
                       comm=comm)
    ref = jrun_frontier(
        jloss, jopt_lib.from_config(cfg), cfg,
        {"w": jnp.asarray(PARAMS0["w"])},
        scales=jnp.asarray(FRONTIER_SCALES[lanes], jnp.float32),
        steps=STEPS, batch_fn=lambda k: _jbatch(k), key=jax.random.key(5))
    want = _np(ref.metrics)
    for key in want:
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(metrics[key], want[key],
                                          err_msg=key)
        else:
            assert _rel(want[key], metrics[key]) < REL, key
    assert _rel(np.asarray(ref.state.params["w"]), state.params["w"]) < REL
    assert tags["payload"]["count"] == STEPS
    assert tags["payload"]["operand_bytes"] == STEPS * lanes * N * 4
    assert tags["scalars"]["count"] == STEPS


def _jax_sketch_native():
    """JAX's sharded sketch-native step on 4 forced host devices, on the
    test's rounds: the final params."""
    code = f"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.core.api import init_train_state
from repro.optim import optimizers as opt_lib
from repro.sharding.agent_shard import make_sharded_train_step

N, M = {N}, {M}
assert len(jax.devices()) == 4, jax.devices()
mesh = jax.make_mesh((4,), ("data",))

def loss_fn(params, batch):
    return 0.5 * jnp.mean((batch["xs"] @ params["w"] - batch["ys"]) ** 2)

def make_batch(key):
    kx, ky = jax.random.split(key)
    return {{"xs": jax.random.normal(kx, (M, 8, N)),
            "ys": jax.random.normal(ky, (M, 8))}}

cfg = TrainConfig(lr={ranks.LR}, optimizer="sgd", num_agents=M,
                  comm="{SKETCH_POLICY}")
opt = opt_lib.from_config(cfg)
step = jax.jit(make_sharded_train_step(loss_fn, opt, cfg, mesh,
                                       sketch_native=True))
state = init_train_state({{"w": jax.random.normal(jax.random.key(0), (N,))}},
                         opt, cfg)
for i in range({STEPS}):
    state, m = step(state, make_batch(jax.random.fold_in(jax.random.key(13), i)))
print(json.dumps({{"w": np.asarray(state.params["w"]).tolist(),
                  "num_tx": float(m["num_tx"]),
                  "wire_bytes": float(m["wire_bytes"])}}))
"""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=TIMEOUT_S)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_sketch_native_matches_jax_sharded(sharded):
    """Sketch-native merges against JAX's sharded sketch-native step,
    within the dense gateway's params (rows=5/cols=16 resolve n=6
    collision-free), and moves fewer all_reduce bytes than the dense
    gateway at n = 4096."""
    out, _, _ = sharded
    params, ops = out[0]["sketch"]
    want = _jax_sketch_native()
    got, num_tx, wire = params[True]
    assert _rel(want["w"], got) < REL
    assert num_tx == want["num_tx"] and wire == want["wire_bytes"]
    dense, dense_tx, dense_wire = params[False]
    assert (num_tx, wire) == (dense_tx, dense_wire)
    assert float(np.max(np.abs(dense - got))) < 1e-5
    assert ops[True] < ops[False], ops


def test_sharded_session_checkpoint_crosses_packages(sharded):
    """The sharded session resumed the unsharded port checkpoint of round
    2, served rounds 2 and 3, and wrote round 4 from the gathered state:
    the JAX package's unsharded session restores it bitwise, and it is
    the unbroken unsharded run's within the contract.  Each gateway's
    rollup counts its own agents' tiers."""
    out, ckpt_dir, batches = sharded
    start, end, state, _ = out[0]["session"]
    assert (start, end) == (2, 4)
    assert [o["session"][2].params["w"].tobytes() for o in out] == [
        state.params["w"].tobytes()] * G
    jsession = jbuild_session(net=_jax_net(SESSION_NET),
                              options=JSessionOptions(ckpt_dir=ckpt_dir))
    assert jsession.round_index == 4
    np.testing.assert_array_equal(np.asarray(jsession.state.params["w"]),
                                  state.params["w"])
    unbroken = build_linreg_fleet_session(
        net=SESSION_NET, device="cpu",
        batch_fn=lambda k: tuple(convert.to_torch(batches[k], "cpu")))
    unbroken.run(4)
    assert _rel(unbroken.state.params["w"].numpy(), state.params["w"]) < REL
    tiers = [set(o["session"][3]["tiers"]) for o in out]
    # 8/16/24/16 agents over four gateways of 16
    assert tiers == [{"backbone", "metro"}, {"metro", "edge"}, {"edge"},
                     {"sensor"}]
    assert all(o["session"][3]["restarts"] == 1 for o in out)


def test_eight_gateways_match_jax_hybrid():
    """G = 8 gateways of 8 agents: the gathered rounds against the JAX
    hybrid step."""
    out = spawn(ranks.run_fleets, 8, timeout_s=TIMEOUT_S, backend="gloo",
                device="cpu", args=(
                    [("tiered_m64", TIERED_M64.policies(lam_base=1.0),
                      None)], PARAMS0, BATCHES))
    jstate, jmetrics = _jax_fleet(TIERED_M64.policies(lam_base=1.0), None)
    state, metrics = out[0]["tiered_m64"]
    for k, (got, want) in enumerate(zip(metrics, jmetrics)):
        _hold_metrics(got, want, f"G=8 round {k}")
    _hold_state(state, jstate, "G=8")


def test_spawn_raises_when_a_rank_fails_or_hangs():
    """A rank that raises makes ``spawn`` raise, and a run past its time
    limit raises ``TimeoutError``; either way the ranks are killed."""
    with pytest.raises(RuntimeError, match="rank 1 exited with code 1"):
        spawn(ranks.fail_on_rank, 2, timeout_s=TIMEOUT_S, backend="gloo",
              device="cpu", args=(1,))
    start = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        spawn(ranks.sleep_for, 2, timeout_s=5, backend="gloo",
              device="cpu", args=(600,))
    assert time.monotonic() - start < 60


def test_jax_tier_mixes_are_the_ports():
    """The fleets above are the JAX package's TIER_MIXES."""
    assert [n.policies(1.0) for n in TIER_MIXES] == [
        n.policies(1.0) for n in JTIER_MIXES]
