"""The port's sharding rules (``repro_torch.sharding.rules``), meshes
(``repro_torch.launch.mesh``), the sharded step's refusals and fallback
and the collective log, in one process on the CPU.

The rules are held to the JAX package's over a grid of shapes, logical
axes and meshes (host, fleet, single-pod, multi-pod); JAX's side reads
the ``fake_mesh`` stand-in of tests/test_sharding.py, the port's its own
``Mesh`` descriptors.
"""
import itertools
import warnings

import numpy as np
import pytest
import torch

from repro.analysis.hlo_stats import collective_stats
from repro.sharding import rules as jrules
from repro_torch.analysis.cost import (
    CollectiveLog,
    CostCounter,
    collective_call,
    summarize,
    total_wire_bytes,
)
from repro_torch.comm.policy import CommPolicy
from repro_torch.configs.base import TrainConfig
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.launch.mesh import (
    Mesh,
    choose_backend,
    make_fleet_mesh,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import rules
from repro_torch.sharding.agent_shard import (
    gather_agents,
    make_sharded_train_step,
    scatter_agents,
    sketch_native_params,
)

torch.set_num_threads(1)

MESHES = {
    "host": ((1, 1), ("data", "model")),
    "fleet4": ((4,), ("data",)),
    "fleet8": ((8,), ("data",)),
    "fleet_model": ((8, 2), ("data", "model")),
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}
LOGICAL = ("layer", "vocab", "embed", "heads", "kv_heads", "ff", "expert",
           "state", "batch", "agent", "seq", "cache_seq", "inner_batch",
           "decode_heads", "unknown", None)
DIMS = (1, 2, 9, 16, 32, 63, 64, 256, 4096)
FLAGS = [dict(zip(("fsdp", "seq_shard", "inner_batch_shard",
                   "cache_seq_shard"), v))
         for v in itertools.product((False, True), repeat=4)]


def fake_mesh(shape, axes):
    """tests/test_sharding.py's stand-in for a JAX mesh."""

    class M:
        axis_names = axes

        def __init__(self):
            self.shape = dict(zip(axes, shape))

    return M()


def _pair(name):
    shape, axes = MESHES[name]
    return fake_mesh(shape, axes), Mesh(axes, shape)


def _agent_axes(axes):
    return ("pod", "data") if "pod" in axes else ("data",)


def tloss(params, batch):
    xs, ys = batch
    r = xs @ params["w"] - ys
    return 0.5 * torch.mean(r * r)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_rules_match_jax(mesh_name):
    jmesh, tmesh = _pair(mesh_name)
    for flags in FLAGS:
        for agent_axes in (("data",), _agent_axes(tmesh.axis_names)):
            got = rules.resolve_rules(tmesh, agent_axes=agent_axes, **flags)
            want = jrules.resolve_rules(jmesh, agent_axes=agent_axes,
                                        **flags)
            assert got == want, (mesh_name, flags)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_pspec_matches_jax_over_a_grid(mesh_name):
    """Every 1-, 2- and 3-dim tensor over the grid's sizes and logical
    names: the same spec as JAX's (unknown names, axis reuse and
    non-divisible sizes replicated alike)."""
    jmesh, tmesh = _pair(mesh_name)
    agent_axes = _agent_axes(tmesh.axis_names)
    for flags in (FLAGS[0], FLAGS[-1]):
        jr = jrules.resolve_rules(jmesh, agent_axes=agent_axes, **flags)
        tr = rules.resolve_rules(tmesh, agent_axes=agent_axes, **flags)
        for rank in (1, 2, 3):
            names = itertools.islice(
                itertools.product(LOGICAL, repeat=rank), 0, None, 7)
            for axes in names:
                for dims in ((d,) * rank for d in DIMS):
                    want = jrules.resolve_pspec(dims, axes, jr, jmesh)
                    got = rules.resolve_pspec(dims, axes, tr, tmesh)
                    assert tuple(got) == tuple(want), (mesh_name, dims, axes)
                    assert repr(got) == repr(want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("m", [1, 4, 7, 63, 64, 256, 1024])
def test_agent_pspec_matches_jax_and_warns_alike(mesh_name, m):
    jmesh, tmesh = _pair(mesh_name)
    agent_axes = _agent_axes(tmesh.axis_names)
    jr = jrules.resolve_rules(jmesh, agent_axes=agent_axes)
    tr = rules.resolve_rules(tmesh, agent_axes=agent_axes)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jrules.agent_pspec(jmesh, m, jr)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = rules.agent_pspec(tmesh, m, tr)
    assert tuple(got) == tuple(want)
    assert len(tw) == len(jw)
    assert rules.agent_axis_names(tmesh, tr) == jrules.agent_axis_names(
        jmesh, jr)
    assert rules.agent_shard_count(tmesh, tr) == jrules.agent_shard_count(
        jmesh, jr)


def test_agent_pspec_warns_loudly_on_replication():
    mesh = Mesh(("data", "model"), (8, 2))
    r = rules.resolve_rules(mesh)
    with pytest.warns(UserWarning, match="REPLICATION"):
        assert rules.agent_pspec(mesh, 63, r) == rules.PartitionSpec()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert rules.agent_pspec(mesh, 64, r) == rules.PartitionSpec("data")


def test_tree_pspecs_match_jax():
    jmesh, tmesh = _pair("single_pod")
    axes = {"a": ("vocab", "embed"),
            "nested": {"b": ("layer", "embed", "ff")}}
    shapes = {"a": (32000, 512), "nested": {"b": (4, 512, 2048)}}
    want = jrules.tree_pspecs(axes, shapes, jrules.resolve_rules(jmesh),
                              jmesh)
    got = rules.tree_pspecs(
        axes, {"a": torch.empty(32000, 512, device="meta"),
               "nested": shapes["nested"]},
        rules.resolve_rules(tmesh), tmesh)
    assert tuple(got["a"]) == tuple(want["a"]) == ("model",)
    assert tuple(got["nested"]["b"]) == tuple(want["nested"]["b"])
    # tree_shardings: JAX's spec and block shape (NamedSharding over an
    # AbstractMesh of the single pod's shape)
    from jax.sharding import AbstractMesh
    from jax.sharding import NamedSharding as JNamedSharding

    amesh = AbstractMesh(tmesh.axis_sizes, tmesh.axis_names)
    sh = rules.tree_shardings(axes, shapes, rules.resolve_rules(tmesh),
                              tmesh)
    for got_sh, spec, shape in ((sh["a"], want["a"], shapes["a"]),
                                (sh["nested"]["b"], want["nested"]["b"],
                                 shapes["nested"]["b"])):
        assert tuple(got_sh.spec) == tuple(spec)
        assert got_sh.shard_shape(shape) == JNamedSharding(
            amesh, spec).shard_shape(shape)


def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.size == 512 and multi.group is None
    host = make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.rank == 0
    fleet = make_fleet_mesh(device="cpu")
    assert fleet.shape == {"data": 1} and fleet.group is None
    with pytest.raises(ValueError, match="4 fleet shards"):
        make_fleet_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="model=2"):
        make_host_mesh(2)
    assert choose_backend(4, "cpu") == "gloo"
    assert Mesh(("pod", "data"), (2, 4), (1, 2)).rank == 6


def _fleet(comm, m=8, n=4):
    cfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=m, comm=comm)
    return cfg, opt_lib.from_config(cfg)


def test_one_gateway_falls_back_to_the_hybrid_step():
    """A one-rank fleet mesh gives the plain hybrid step: bitwise the
    unsharded step's rounds."""
    cfg, opt = _fleet(("gain_lookahead(lam=0.5)|int8+ef",) * 4
                      + ("always|fp16",) * 4)
    mesh = make_fleet_mesh(1, device="cpu")
    step = make_sharded_train_step(tloss, opt, cfg, mesh, device="cpu",
                                   agent_metrics=True)
    ref = make_triggered_train_step(
        tloss, opt, cfg, device="cpu",
        options=StepOptions(agent_metrics=True, barriers=False))
    gen = torch.Generator().manual_seed(0)
    s1 = s2 = init_train_state({"w": torch.zeros(4)}, opt, cfg,
                               device="cpu")
    for _ in range(3):
        batch = (torch.randn(8, 8, 4, generator=gen),
                 torch.randn(8, 8, generator=gen))
        s1, m1 = step(s1, batch)
        s2, m2 = ref(s2, batch)
        assert set(m1) == set(m2)
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    assert torch.equal(s1.params["w"], s2.params["w"])
    assert torch.equal(s1.ef_memory["w"], s2.ef_memory["w"])
    # gather and scatter on one gateway are copies
    g = gather_agents(s1, mesh)
    assert torch.equal(g.ef_memory["w"], s1.ef_memory["w"])
    assert torch.equal(scatter_agents(g, mesh).ef_memory["w"],
                       s1.ef_memory["w"])


def test_sketch_native_eligibility():
    def chains(*specs):
        return tuple(CommPolicy.parse(s).chain() for s in specs)

    assert sketch_native_params(chains(
        "always|sketch(rows=5,cols=64)", "gain_lookahead(lam=1.0)"
        "|sketch(rows=5,cols=64)+ef")) == (5, 64, 0)
    assert sketch_native_params(chains("always|sketch(rows=5,cols=16,"
                                       "seed=3)")) == (5, 16, 3)
    for bad in (("always|int8",), ("always",),
                ("always|sketch(rows=5,cols=64)",
                 "always|sketch(rows=5,cols=32)"),
                ("always|topk(0.5)|sketch(rows=5,cols=64)",)):
        assert sketch_native_params(chains(*bad)) is None, bad
    assert sketch_native_params(()) is None


def test_sharded_step_refusals():
    cfg, opt = _fleet("always|int8", m=4)
    one = make_fleet_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="sketch"):
        make_sharded_train_step(tloss, opt, cfg, one, sketch_native=True,
                                device="cpu")
    mixed, opt2 = _fleet(("always|sketch(rows=5,cols=64)",
                          "always|sketch(rows=5,cols=32)") * 2, m=4)
    with pytest.raises(ValueError, match="identical"):
        make_sharded_train_step(tloss, opt2, mixed, one, sketch_native=True,
                                device="cpu")
    sk, opt3 = _fleet("always|sketch(rows=5,cols=64)", m=4)
    with pytest.raises(ValueError, match="shardable"):
        make_sharded_train_step(tloss, opt3, sk, one, sketch_native=True,
                                device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        make_sharded_train_step(tloss, opt, cfg, object(), device="cpu")
    with pytest.raises(ValueError, match="churn"):
        make_sharded_train_step(tloss, opt, cfg, one, churn=((0, 9),),
                                device="cpu")
    # four gateways described but no process group behind them
    with pytest.raises(ValueError, match="descriptor"):
        make_sharded_train_step(tloss, opt, cfg, Mesh(("data",), (4,)),
                                device="cpu")
    # a fleet that four gateways do not divide replicates, LOUDLY, and
    # is the hybrid step
    odd, opt4 = _fleet("always", m=7)
    with pytest.warns(UserWarning, match="REPLICATION"):
        step = make_sharded_train_step(tloss, opt4, odd,
                                       Mesh(("data",), (4,)), device="cpu")
    _, m = step(init_train_state({"w": torch.ones(3)}, opt4, odd,
                                 device="cpu"),
                (torch.ones(7, 2, 3), torch.zeros(7, 2)))
    assert float(m["num_tx"]) == 7.0


def test_collective_log_matches_hlo_stats_factors():
    """The ring factors of ``repro.analysis.hlo_stats`` on the same
    operands: all-reduce 2·b·(n−1)/n, all-gather b·(n−1)."""
    hlo = "\n".join([
        "%a = f32[32] all-reduce(f32[32] %x), replica_groups={{0,1,2,3}}",
        "%b = f32[9] all-reduce(f32[9] %y), replica_groups={{0,1,2,3}}",
        "%c = f32[64] all-gather(f32[16] %z), replica_groups={{0,1,2,3}}",
    ])
    want = collective_stats(hlo)
    log = CollectiveLog()
    with CostCounter() as counter:
        collective_call(log, "all-reduce", 32 * 4, 4, "payload")
        collective_call(log, "all-reduce", 9 * 4, 4, "scalars")
        collective_call(log, "all-gather", 16 * 4, 4, "gather")
    for stats in (log.stats(), counter.collectives.stats()):
        assert set(stats) == set(want)
        for kind in want:
            assert stats[kind]["count"] == want[kind]["count"]
            assert stats[kind]["operand_bytes"] == want[kind]["operand_bytes"]
            np.testing.assert_allclose(stats[kind]["wire_bytes"],
                                       want[kind]["wire_bytes"], atol=1)
    assert log.by_tag()["payload"]["operand_bytes"] == 128
    assert summarize(counter)["collectives"] == counter.collectives.stats()
    assert summarize(counter)["wire_bytes"] == total_wire_bytes(log.stats())
    log.reset()
    assert log.stats() == {} and total_wire_bytes(log.stats()) == 0.0
