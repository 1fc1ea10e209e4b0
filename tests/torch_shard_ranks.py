"""Rank programs for tests/test_torch_shard_fleet.py.

Each function runs on one gloo rank that ``repro_torch.launch.mesh.spawn``
starts on the CPU (``fn(mesh, *args)``), imports nothing of JAX, and
returns numpy copies of the gathered (global) trees, so that the test
process can hold them against the JAX package.  Inputs arrive as numpy
arrays drawn by the test from JAX's keys.
"""
import time

import torch

from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.core.frontier import run_frontier
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding.agent_shard import (
    gather_agents,
    make_sharded_train_step,
    scatter_agents,
)

LR = 0.1


def loss_fn(params, batch):
    return 0.5 * torch.mean((batch["xs"] @ params["w"] - batch["ys"]) ** 2)


def _setup(comm, m):
    cfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=m, comm=comm)
    return cfg, opt_lib.from_config(cfg)


def _batch(b):
    return convert.to_torch(b, "cpu")


def _tags(mesh):
    return {k: dict(v) for k, v in mesh.collectives.by_tag().items()}


def run_jobs(mesh, jobs):
    """``{name: (function name, args)}``: each job's result, in one
    spawn (each spawn pays the ranks' start-up)."""
    return {name: globals()[fn](mesh, *args)
            for name, (fn, args) in jobs.items()}


def fail_on_rank(mesh, bad):
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    return mesh.rank


def sleep_for(mesh, seconds):
    time.sleep(seconds)
    return mesh.rank


def run_fleets(mesh, cases, params0, batches):
    """Each ``(name, comm, churn)`` case: len(batches) rounds of the
    sharded step from ``params0``; the gathered state after the last
    round and every round's gathered metrics."""
    torch.set_num_threads(1)
    out = {}
    for name, comm, churn in cases:
        cfg, opt = _setup(comm, len(batches[0]["xs"]))
        step = make_triggered_train_step(
            loss_fn, opt, cfg, device="cpu",
            options=StepOptions(agent_metrics=True, churn=churn, mesh=mesh))
        state = scatter_agents(
            init_train_state(convert.to_torch(params0, "cpu"), opt, cfg,
                             device="cpu"), mesh)
        metrics = []
        for b in batches:
            state, m = step(state, _batch(b))
            metrics.append(convert.to_numpy(gather_agents(m, mesh)))
        out[name] = (convert.to_numpy(gather_agents(state, mesh)), metrics)
    return out


def operand_bytes(mesh, sizes, n):
    """The all_reduce calls of one sharded step per fleet size m (half
    ``gain_lookahead|fp16``, half ``always``): ``{m: {tag: counts}}``."""
    torch.set_num_threads(1)
    out = {}
    for m in sizes:
        comm = (("gain_lookahead(lam=1.0)|fp16",) * (m // 2)
                + ("always",) * (m // 2))
        cfg, opt = _setup(comm, m)
        step = make_sharded_train_step(loss_fn, opt, cfg, mesh,
                                       device="cpu")
        state = scatter_agents(
            init_train_state({"w": torch.zeros(n)}, opt, cfg, device="cpu"),
            mesh)
        gen = torch.Generator().manual_seed(m)
        batch = {"xs": torch.randn(m, 8, n, generator=gen),
                 "ys": torch.randn(m, 8, generator=gen)}
        mesh.collectives.reset()
        step(state, batch)
        out[m] = _tags(mesh)
    return out


def frontier(mesh, comm, params0, scales, batches):
    """The sharded ``run_frontier`` over ``scales`` on the given rounds'
    batches: gathered state and metrics, and the collectives per tag."""
    torch.set_num_threads(1)
    cfg, opt = _setup(comm, len(batches[0]["xs"]))
    mesh.collectives.reset()
    res = run_frontier(loss_fn, opt, cfg, convert.to_torch(params0, "cpu"),
                       scales=scales, steps=len(batches),
                       batch_fn=lambda k: _batch(batches[k]), mesh=mesh,
                       device="cpu")
    tags = _tags(mesh)
    return (convert.to_numpy(gather_agents(res.state, mesh, axis=1)),
            convert.to_numpy(gather_agents(res.metrics, mesh, axis=2)), tags)


def sketch_native(mesh, comm, params0, batches, big_n):
    """The dense gateway and the sketch-native merge on the same rounds
    (params of each), then one step of ``always|sketch(rows=5,cols=64,
    seed=3)`` at n = ``big_n``: the all_reduce operand bytes of each."""
    torch.set_num_threads(1)
    cfg, opt = _setup(comm, len(batches[0]["xs"]))
    params = {}
    for native in (False, True):
        step = make_sharded_train_step(loss_fn, opt, cfg, mesh,
                                       sketch_native=native, device="cpu")
        state = scatter_agents(init_train_state(
            convert.to_torch(params0, "cpu"), opt, cfg, device="cpu"), mesh)
        for b in batches:
            state, m = step(state, _batch(b))
        params[native] = (state.params["w"].numpy(), float(m["num_tx"]),
                          float(m["wire_bytes"]))
    m = len(batches[0]["xs"])
    cfgb, optb = _setup("always|sketch(rows=5,cols=64,seed=3)", m)
    batch = {"xs": torch.zeros(m, 8, big_n), "ys": torch.zeros(m, 8)}
    ops = {}
    for native in (False, True):
        step = make_sharded_train_step(loss_fn, optb, cfgb, mesh,
                                       sketch_native=native, device="cpu")
        state = scatter_agents(init_train_state(
            {"w": torch.zeros(big_n)}, optb, cfgb, device="cpu"), mesh)
        mesh.collectives.reset()
        step(state, batch)
        ops[native] = mesh.collectives.stats()["all-reduce"]["operand_bytes"]
    return params, ops


def session(mesh, net, ckpt_dir, rounds, batches):
    """A sharded fleet session that resumes from ``ckpt_dir``, serves
    ``rounds`` more rounds on the given batches and checkpoints: the
    gathered state, the round index and this rank's rollup."""
    from repro_torch.launch.session import (
        SessionOptions,
        build_linreg_fleet_session,
    )

    torch.set_num_threads(1)
    s = build_linreg_fleet_session(
        net=net, device="cpu", mesh=mesh,
        batch_fn=lambda k: tuple(convert.to_torch(batches[k], "cpu")),
        options=SessionOptions(ckpt_dir=ckpt_dir))
    start = s.round_index
    s.run(rounds)
    s.checkpoint()
    return (start, s.round_index, convert.to_numpy(gather_agents(s.state, mesh)),
            s.rollup.snapshot())
