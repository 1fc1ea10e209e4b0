"""The port's mesh layout (``NamedSharding``, ``tree_shardings``,
``ShardingConfig``, ``kv_cache_axes``, ``sharding/constraint.py``) against
the JAX package's in one process, the shape census, the collectives'
rules under ``torch.func``, and the spawn's failures and the train CLI
under ``torchrun`` over gloo ranks on the CPU.

JAX's block shapes come from ``NamedSharding(AbstractMesh, spec).
shard_shape``; its per-device blocks on a real (2, 2) mesh are held in
tests/test_torch_mesh_lm.py (a subprocess with 4 forced host devices).
"""
import dataclasses
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

import torch_mesh_ranks as ranks
from repro.configs import get_config as jget
from repro.configs import list_archs
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.models import attention as JA
from repro.models import build as jbuild
from repro.models import decode as JDEC
from repro.sharding import rules as jrules
from repro_torch.analysis.cost import CostCounter
from repro_torch.analysis.hlo_stats import scan_flops_note, shape_census
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShardingConfig, TrainConfig
from repro_torch.configs.paper_linreg import TIERED_M64_ONE_BIG
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models import attention as A
from repro_torch.models import build
from repro_torch.models import decode as DEC
from repro_torch.models.transformer import layer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import collectives as C
from repro_torch.sharding import constraint
from repro_torch.sharding.rules import (
    NamedSharding,
    PartitionSpec,
    resolve_rules,
    shard_tree,
    tree_shardings,
)
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {(2, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def _leaves(tree):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += [((k,) + p, x) for p, x in _leaves(tree[k])]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for n, x in zip(tree._fields, tree):
            out += [((n,) + p, y) for p, y in _leaves(x)]
    else:
        out.append(((), tree))
    return out


@pytest.mark.parametrize("sizes", sorted(MESHES))
def test_tree_shardings_shard_shapes_match_jax(sizes):
    """Every arch's parameter and cache axes trees, fsdp off and on: the
    port's ``tree_shardings`` gives JAX's spec and JAX's block shape."""
    axes_names = MESHES[sizes]
    tmesh = Mesh(axes_names, sizes)
    jmesh = AbstractMesh(sizes, axes_names)
    for arch in list_archs():
        cfg = get_config(arch)
        params, axes = build(cfg).init(abstract=True)
        cache, cache_axes = DEC.init_cache(cfg, 2, 64, device="meta")
        jm = jbuild(jget(arch))
        jparams, jaxes = jm.init(abstract=True)
        jcache, jcache_axes = JDEC.init_cache(jm.cfg, 2, 64, abstract=True)
        for fsdp in (False, True):
            rules = resolve_rules(tmesh, fsdp=fsdp)
            jr = jrules.resolve_rules(jmesh, fsdp=fsdp)
            for tree, ax, jtree, jax_ in ((params, axes, jparams, jaxes),
                                          (cache, cache_axes, jcache,
                                           jcache_axes)):
                got = _leaves(tree_shardings(ax, tree, rules, tmesh))
                want = jrules.tree_pspecs(jax_, jtree, jr, jmesh)
                shapes = dict(_leaves(tree))
                flat_want = jax.tree_util.tree_leaves(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))
                flat_shapes = jax.tree_util.tree_leaves(jtree)
                assert len(got) == len(flat_want)
                for (path, sh), spec, js in zip(got, flat_want, flat_shapes):
                    assert tuple(sh.spec) == tuple(spec), (arch, path)
                    shape = tuple(shapes[path].shape)
                    assert shape == tuple(js.shape), (arch, path)
                    assert sh.shard_shape(shape) == JNamedSharding(
                        jmesh, spec).shard_shape(shape), (arch, path)


def test_named_sharding_local_and_slices():
    """A rank's block by its coordinates, row-major over an entry's axes
    (pod before data, as JAX places them)."""
    x = torch.arange(8 * 6).reshape(8, 6)
    for pod in range(2):
        for data in range(2):
            mesh = Mesh(("pod", "data", "model"), (2, 2, 3), (pod, data, 1))
            sh = NamedSharding(mesh, PartitionSpec(("pod", "data"), "model"))
            assert sh.shard_shape(x.shape) == (2, 2)
            i = 2 * pod + data
            assert torch.equal(sh.local(x), x[2 * i:2 * i + 2, 2:4])
            assert sh.axes == ("pod", "data", "model")
    rep = NamedSharding(Mesh(("data", "model"), (2, 2), (1, 1)),
                        PartitionSpec())
    assert rep.local(x) is x and rep.shard_shape(x.shape) == (8, 6)
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(Mesh(("data",), (4,), (0,)),
                      PartitionSpec("data")).shard_shape((6,))


def test_sharding_config_and_kv_cache_axes_match_jax():
    assert dataclasses.asdict(ShardingConfig()).keys() == dataclasses.asdict(
        JShardingConfig()).keys()
    assert dataclasses.asdict(ShardingConfig()) == dataclasses.asdict(
        JShardingConfig())
    assert tuple(A.kv_cache_axes()) == tuple(JA.kv_cache_axes())


def test_gather_hook_moves_per_agent_trees_between_blocks_and_whole():
    """On a (2, 2) mesh without a process group at model index 1: the
    hook's "" takes a global per-agent tree to this rank's model blocks
    and keeps blocks; the placement's layouts
    (``repro_torch.sharding.blocks``, what the comm epilogue reads) cut
    the same blocks and widen them back to the whole leaves' shapes
    (``global_like``); a named site passes the blocks at rest
    through and refuses a global leaf."""
    cfg = reduced(get_config("smollm-135m"))
    params, axes = build(cfg).init(torch.Generator().manual_seed(0))
    mesh = Mesh(("data", "model"), (2, 2), (0, 1))
    rules = resolve_rules(mesh, fsdp=False)
    shardings = tree_shardings(axes, params, rules, mesh)
    g = tree_map(lambda x: torch.stack([x, 2 * x]), params)
    token = constraint.set_gather_hook(
        constraint.make_gather_hook(mesh, axes, rules, params))
    from repro_torch.sharding import blocks as B
    from repro_torch.sharding.placement import Placement

    layouts = Placement(mesh, axes, params, rules, 2).layouts
    try:
        blocks = constraint.constrain_params(g, "")
        kept = constraint.constrain_params(blocks, "")
        with B.model_blocks(layouts):
            whole = B.global_like(blocks)
        split = 0
        for (path, sh), (_, x), (_, b), (_, w), (_, k) in zip(
                tree_flatten_with_path(shardings),
                tree_flatten_with_path(g), tree_flatten_with_path(blocks),
                tree_flatten_with_path(whole), tree_flatten_with_path(kept)):
            index = (Ellipsis,) + sh.slices(x.shape[1:])
            assert torch.equal(b, x[index]), path
            assert k is b, path
            cut = x if layouts[path] is None else layouts[path].cut(x)
            assert torch.equal(cut, b), path
            assert w.shape == x.shape and w.dtype == x.dtype, path
            split += b.shape != x.shape
        assert split == 8  # the 7 stacked weights and the table
        rest = shard_tree(params, shardings)
        lp = layer(rest["blocks"], 0)
        out = constraint.constrain_params(lp, "blocks")
        assert all(x is y for (_, x), (_, y) in zip(
            tree_flatten_with_path(out), tree_flatten_with_path(lp)))
        with pytest.raises(ValueError, match="neither"):
            constraint.constrain_params(layer(params["blocks"], 0), "blocks")
    finally:
        constraint.reset_gather_hook(token)


def test_constraint_hooks_without_a_mesh_are_no_ops():
    """No hook: ``constrain_params``/``constrain_act`` return their
    argument.  A hook on a one-rank mesh keeps every leaf; the whole-tree
    key "" (the per-agent gradient and probe) passes through; the
    activation hook passes a replicated activation and the batch's dim
    (a serving rank holds its rows) through, and takes the rank's block
    of a dim that it splits over "model"."""
    cfg = get_config("smollm-135m")
    params, axes = build(cfg).init(abstract=True)
    tree = {"a": torch.zeros(3)}
    assert constraint.constrain_params(tree, "x") is tree
    assert constraint.constrain_act(tree["a"], ("batch",)) is tree["a"]
    one = Mesh(("data", "model"), (1, 1), (0, 0))
    rules = resolve_rules(one, fsdp=True)
    token = constraint.set_gather_hook(
        constraint.make_gather_hook(one, axes, rules, params))
    try:
        lp = layer(params["blocks"], 0)
        out = constraint.constrain_params(lp, "blocks")
        assert all(x is y for (_, x), (_, y) in zip(
            tree_flatten_with_path(out), tree_flatten_with_path(lp)))
        assert constraint.constrain_params(params, "") is params
    finally:
        constraint.reset_gather_hook(token)
    big = Mesh(("data", "model"), (16, 16))
    hook = constraint.make_act_hook(big, resolve_rules(big))
    x = torch.empty(32, 8, device="meta")
    assert hook(x, (None, None)) is x
    assert hook(x, ("batch", None)) is x
    rank = Mesh(("data", "model"), (2, 2), (0, 1))
    y = torch.arange(8.0).reshape(2, 4)
    split = constraint.make_act_hook(rank, resolve_rules(rank))
    assert torch.equal(split(y, (None, "heads")), y[:, 2:])
    assert constraint.strip_data_axes(resolve_rules(
        Mesh(("pod", "data", "model"), (2, 2, 2)), fsdp=True))["embed"] is None


@pytest.mark.parametrize("arch,seq,cfg,split", [
    ("whisper-medium", 449, {}, None),   # 448 tokens divide, frames not
    ("whisper-medium", 450, {}, "seq"),
    ("phi-3-vision-4.2b", 16, {"num_patches": 15}, None),   # 31 positions
    ("phi-3-vision-4.2b", 16, {}, "seq"),
])
def test_seq_shard_guard_takes_the_whole_sequence(arch, seq, cfg, split):
    """``seq_shard`` chunks a family's sequence only where the model axis
    divides all of it (whisper's frames and tokens; the vlm's patches
    and tokens together): elsewhere the train and prefill steps keep
    every sequence of the batch whole on the model ranks."""
    from repro_torch.configs import reduced
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S

    mesh = Mesh(("data", "model"), (2, 2), (0, 1))
    plan = S.plan_run(reduced(get_config(arch)).replace(**cfg),
                      InputShape("t", seq, 4, "train"), mesh, num_agents=2,
                      seq_shard=True)
    train = S.build_train_step(plan, compute_dtype="float32", device="cpu",
                               mesh=mesh)
    prefill, _, _ = S.build_prefill_step(plan, compute_dtype="float32",
                                         device="meta", mesh=mesh,
                                         init_params=False)
    assert prefill.split == split
    for step in (train, prefill):
        chunked = {k for k, sh in step.batch_shardings.items()
                   if "model" in tuple(sh.spec)}
        assert chunked == (set() if split is None else
                           {"tokens", "labels"} | ({"frame_embeds"}
                                                   if "whisper" in arch
                                                   else set())), chunked


def test_collectives_are_identities_without_a_model_axis():
    x = torch.randn(3, 4)
    for fn in (C.reduce_from_model, C.copy_to_model, C.max_over_model):
        assert fn(x) is x
    assert C.shard_offset(4, 4, "t") is None
    with pytest.raises(RuntimeError, match="no mesh step is running"):
        C.shard_offset(2, 4, "t")


def test_one_big_tier_epilogue_materializes_no_padded_copies():
    """tests/test_shard_fleet.py's trace guarantee on the port's hybrid
    step: for the 2+2+2+58 one-big fleet the census of the ops' output
    shapes has no (4, 58, ...) or (232, ...) buffer, and the big tier's
    block of 58 exists."""
    n, m = 6, 64
    assert sorted(t.count for t in TIERED_M64_ONE_BIG.tiers) == [2, 2, 2, 58]

    def loss_fn(params, batch):
        return 0.5 * torch.mean((batch["xs"] @ params["w"] - batch["ys"]) ** 2)

    cfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=m,
                      comm=TIERED_M64_ONE_BIG.policies(lam_base=1.0))
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(
        loss_fn, opt, cfg, device="cpu",
        options=StepOptions(hetero_dispatch="hybrid"))
    state = init_train_state({"w": torch.zeros(n)}, opt, cfg, device="cpu")
    batch = {"xs": torch.zeros(m, 8, n), "ys": torch.zeros(m, 8)}
    with CostCounter() as counter:
        step(state, batch)
    census = shape_census(counter)
    assert census, "the census saw no op"
    padded = {d for d in census
              if d[:2] == (4, 58) or (d and d[0] == 4 * 58)}
    assert not padded, sorted(padded)
    assert any(d and d[0] == 58 for d in census), sorted(census)
    note = scan_flops_note(counter)
    assert note["while"] == note["fusion"] == 0 and note["reshape"] > 0


def test_spawn_fails_fast_on_a_rank_error_and_on_a_collective_mismatch():
    """A rank that raises, and ranks whose collectives differ in order
    (one waits in a barrier, the other in an all_reduce), make ``spawn``
    raise within its timeout, not hang."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 exited"):
        spawn(ranks.fail_on_rank, 4, timeout_s=60, device="cpu", args=(2,),
              model=2)
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn(ranks.mismatched_collectives, 4, timeout_s=15, device="cpu",
              args=(None,), model=2)
    assert time.monotonic() - t0 < 90


def _cli(*args, torchrun=0):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable]
    if torchrun:
        with socket.socket() as sock:  # a free port on this host
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cmd += ["-m", "torch.distributed.run", f"--nproc_per_node={torchrun}",
                "--master_addr=127.0.0.1", f"--master_port={port}"]
    cmd += ["-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
            "--steps", "2", "--seq", "16", "--batch", "8", *args]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_cli_under_torchrun_builds_the_host_mesh(tmp_path):
    """``torchrun`` with 4 gloo ranks: the CLI's mesh is (data 4, model
    1), an agent per rank, rank 0 alone prints; its step lines and
    totals equal the single-process CLI with ``--agents 4`` (the same
    seed and global batches), and its checkpoint (gathered) is the one
    that run writes."""
    mesh_out = _cli("--ckpt-dir", str(tmp_path / "mesh"), torchrun=4)
    single = _cli("--agents", "4", "--ckpt-dir", str(tmp_path / "one"))
    assert "mesh={'data': 4, 'model': 1}" in mesh_out
    assert mesh_out.count("arch=") == 1

    def lines(text):
        return [re.sub(r"\(\d+\.\d+s/step\)", "", ln).strip()
                for ln in text.splitlines() if ln.startswith(("step", "done"))]

    assert lines(mesh_out) == lines(single)
    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs import reduced

    cfg = TrainConfig(optimizer="sgd", num_agents=4, comm="gain_lookahead")
    params, _ = build(reduced(get_config("smollm-135m"))).init(
        torch.Generator().manual_seed(0))
    like = init_train_state(params, opt_lib.from_config(cfg), cfg,
                            device="cpu")
    got = checkpointer.restore(tmp_path / "mesh", like)
    want = checkpointer.restore(tmp_path / "one", like)
    assert got.step == want.step == 2
    for (path, x), (_, y) in zip(tree_flatten_with_path(got.params),
                                 tree_flatten_with_path(want.params)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6, msg=str(path))
