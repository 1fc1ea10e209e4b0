"""The port's LM train step over a (data, model) mesh of gloo ranks on
the CPU (``repro_torch.launch.steps.build_train_step(mesh=...)``),
against the JAX package.

One module fixture runs every rank program in one spawn of 4 ranks
(``tests/torch_mesh_ranks.py``, which imports no JAX); the test process
runs the JAX side on the same inputs (the JAX package's weights, its
``lm_batch`` draws), and a JAX subprocess with 4 forced host devices,
started beside the spawn, runs what needs a JAX mesh.  The jobs:

* reduced smollm-135m (2 layers, d 256, vocab 512) at (data 2, model 2)
  with 4/2 heads (every head, kv head, ff column and vocab row split),
  for fsdp off/on × ``fleet_shard`` off/on × ``gain_lookahead(lam=0.01)``
  with and without ``|int8+ef``; then 4/1 heads (kv replicated, heads
  split), 3/1 (attention replicated: smollm's guard case at model 2), a
  vocabulary of 511 that model 2 does not divide, one
  ``gain_quadratic`` step and one with ``remat``;
* a data-only (4, 1) mesh with fsdp on (the other five families':
  tests/test_torch_mesh_families.py).

Each job takes STEPS steps, each from the JAX step's state (the gaps do
not compound), against ``make_triggered_train_step`` unsharded: JAX's
SPMD partitioning does not change what the step computes, and its own
sharded entry point is held to the same inputs where it runs (fsdp off;
fsdp on over an ``AxisType.Auto`` mesh).  The contract (ROADMAP §3):
metrics and parameters within ``rtol = 1e-5, atol = 1e-6``, decisions
exact but for a gain within 1e-5 of its threshold, EF memory within
``rtol = 1e-5`` of each agent's ``max|g + ef|``; with an int8 wire an
element whose ``g + ef`` lies within that gap of a rounding boundary
may land one level apart (counted).  The families are held to their
own tests' gaps over the step's largest update (hybrid 2.5e-4, xlstm
2.5e-5, whisper 1e-5 of the whole step: its cross-attention's
cancellation).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.configs.base import InputShape as JShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.api import StepOptions as JStepOptions
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.data import synthetic as JD
from repro.models import build as jbuild
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.comm import CommPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models import build
from repro_torch.models import decode as DEC
from repro_torch.sharding.rules import resolve_rules, tree_shardings
from repro_torch.utils.tree import tree_flatten_with_path

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR, RTOL, ATOL = 0.1, 1e-5, 1e-6
P1 = "gain_lookahead(lam=0.01)"
P2 = P1 + "|int8+ef"
PQ = "gain_quadratic(lam=0.01)"
SEQ, PER, STEPS = 16, 2, 2
TIMEOUT_S = 420
FAMILIES = {"mixtral-8x7b": 1e-5, "zamba2-1.2b": 2.5e-4,
            "xlstm-350m": 2.5e-5, "whisper-medium": 1e-5,
            "phi-3-vision-4.2b": 1e-5}


def _job(policy, fsdp, fleet, *, arch="smollm-135m", cfg=None, model=2,
         m=2, steps=STEPS, remat=False, seq=SEQ):
    return dict(arch=arch, cfg=cfg or {}, model=model, m=m, policy=policy,
                fsdp=fsdp, fleet_shard=fleet, steps=steps, remat=remat,
                seq=seq)


def _jobs():
    jobs = {}
    for pol, tag in ((P1, "lookahead"), (P2, "int8")):
        for fsdp in (False, True):
            for fleet in (False, True):
                jobs[f"{tag}_fsdp{int(fsdp)}_fleet{int(fleet)}"] = _job(
                    pol, fsdp, fleet)
    jobs["kv_replicated"] = _job(P1, False, True, cfg={"num_kv_heads": 1})
    jobs["heads_replicated"] = _job(P2, True, False,
                                    cfg={"num_heads": 3, "num_kv_heads": 1})
    jobs["vocab_511"] = _job(P1, True, True, cfg={"vocab_size": 511})
    jobs["quadratic"] = _job(PQ, False, False, steps=1)
    jobs["remat"] = _job(P1, True, False, steps=1, remat=True)
    jobs["data_only_smollm-135m"] = _job(P1, True, False, model=1, m=4,
                                         steps=1)
    return jobs


JOBS = _jobs()


def jax_config(arch, cfg_items):
    """JAX's reduced ``arch`` with the overrides ``cfg_items`` (a
    ``"moe"`` or ``"xlstm"`` entry holds that sub-config's, as sorted
    items)."""
    over = dict(cfg_items)
    jcfg = jreduced(jget(arch))
    for sub in ranks.SUB_CONFIGS:
        if sub in over:
            over[sub] = dataclasses.replace(getattr(jcfg, sub),
                                            **dict(over[sub]))
    return jcfg.replace(**over)


@functools.lru_cache(maxsize=None)
def _jax_model(arch, cfg_items):
    jm = jbuild(jax_config(arch, cfg_items))
    return jm, jax.device_get(jm.init(jax.random.key(0))[0])


def _key(job):
    return (job["arch"], tuple(sorted(job["cfg"].items())), job["policy"],
            job["m"], job["seq"])


@functools.lru_cache(maxsize=None)
def _jax_chain(key):
    """The JAX package's unsharded step from its initial state over STEPS
    batches: ``(batches, states, metrics)``."""
    arch, cfg_items, policy, m, seq = key
    jm, jp = _jax_model(arch, cfg_items)
    jcfg = JTrainConfig(lr=LR, optimizer="sgd", num_agents=m, comm=policy)
    jo = jopt.from_config(jcfg)
    step = jax.jit(jmake(jm.loss_fn, jo, jcfg,
                         options=JStepOptions(agent_metrics=True)))
    shape = JShape("mesh", seq, m * PER, "train")
    batches, states, metrics = [], [jinit(jp, jo, jcfg)], []
    for k in range(STEPS):
        b = jax.device_get(JD.lm_batch(jm.cfg, shape,
                                       jax.random.key(100 + k),
                                       num_agents=m))
        nxt, met = jax.device_get(step(states[-1], b))
        batches.append(b)
        states.append(nxt)
        metrics.append(met)
    return batches, [jax.device_get(s) for s in states], metrics


@functools.lru_cache(maxsize=None)
def _jax_terms(key, k):
    """Each agent's ``g + ef`` and lookahead gain at the chain's state k
    (the JAX package's values, to vet an int8 element or a decision)."""
    arch, cfg_items, _, _, _ = key
    jm, _ = _jax_model(arch, cfg_items)
    batches, states, _ = _jax_chain(key)

    def one(params, b):
        loss, g = jax.value_and_grad(jm.loss_fn)(params, b)
        probe = jax.tree_util.tree_map(lambda p, x: p - LR * x, params, g)
        return g, jm.loss_fn(probe, b) - loss

    grads, gains = jax.device_get(jax.vmap(one, in_axes=(None, 0))(
        states[k].params, batches[k]))
    g_eff = _flat(grads)
    if states[k].ef_memory is not None:
        ef = _flat(states[k].ef_memory)
        g_eff = {p: g + ef[p] for p, g in g_eff.items()}
    return g_eff, np.asarray(gains)


def _flat(tree):
    """``{"a/b/c": numpy leaf}`` of a JAX or port tree."""
    return {"/".join(str(p) for p in path): np.asarray(x) for path, x in
            tree_flatten_with_path(convert.to_torch(jax.device_get(tree),
                                                    "cpu"))}


def rank_args(jobs):
    """The spawn's jobs: each with the JAX chain's batches and states."""
    out = {}
    for name, job in jobs.items():
        batches, states, _ = _jax_chain(_key(job))
        state_np = [convert.to_numpy(convert.state_from_jax(s, device="cpu"))
                    ._replace(step=0) for s in states[:job["steps"]]]
        out[name] = ("train_run", (dict(
            job, lr=LR, batches=[{k: np.asarray(v) for k, v in b.items()}
                                 for b in batches[:job["steps"]]],
            states=state_np),))
    return out


JAX_MESH_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding
sys.path.insert(0, {src!r})
from repro.configs import get_config, list_archs, reduced
from repro.configs.base import InputShape, TrainConfig
from repro.core.api import init_train_state
from repro.data import synthetic as D
from repro.launch import steps as S
from repro.launch.mesh import make_host_mesh
from repro.models import build
from repro.models import decode as DEC
from repro.models.param import is_axes_leaf
from repro.optim import optimizers as opt_lib
from repro.sharding.rules import resolve_rules, tree_pspecs

out, arrays = {{"indices": {{}}, "facts": {{}}}}, {{}}
explicit = make_host_mesh(model=2)
auto = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)


def name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)


coords = {{d.id: [int(i) for i in np.argwhere(auto.devices == d)[0]]
          for d in auto.devices.flat}}
for arch in list_archs():
    cfg = get_config(arch)
    params, axes = build(cfg).init(abstract=True)
    _, cache_axes = DEC.init_cache(cfg, 2, 64, abstract=True)
    cache, _ = DEC.init_cache(cfg, 2, 64, abstract=True)
    rows = {{}}
    for tag, ax, tree in (("params", axes, params),
                          ("cache", cache_axes, cache)):
        for fsdp in (False, True):
            rules = resolve_rules(auto, fsdp=fsdp)
            specs = tree_pspecs(ax, tree, rules, auto)
            flat = jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]
            shapes = dict((name(p), s.shape) for p, s in
                          jax.tree_util.tree_flatten_with_path(tree)[0])
            for path, spec in flat:
                key = name(path)
                idx = NamedSharding(auto, spec).devices_indices_map(
                    shapes[key])
                rows[f"{{tag}}:{{fsdp}}:{{key}}"] = [
                    [coords[d.id], [[s.start or 0,
                                      shapes[key][i] if s.stop is None
                                      else s.stop]
                                     for i, s in enumerate(sl)]]
                    for d, sl in idx.items()]
    out["indices"][arch] = rows

cfg = reduced(get_config("smollm-135m"))
shape = InputShape("mesh", {seq}, {m} * {per}, "train")


def run(mesh, fsdp, fleet):
    plan = S.plan_run(cfg, shape, mesh, comm={policy!r}, lr={lr}, fsdp=fsdp)
    step, *_ = S.build_train_step(mesh, plan, compute_dtype="float32",
                                  fleet_shard=fleet)
    model = build(cfg)
    params = model.init(jax.random.key(0))[0]
    state = init_train_state(params, opt_lib.from_config(plan.train_cfg),
                             plan.train_cfg)
    batch = D.lm_batch(model.cfg, shape, jax.random.key(100),
                       num_agents={m})
    nxt, met = step(state, batch)
    return jax.device_get(nxt.params), float(met["num_tx"])


for label, mesh, fsdp, fleet in (
        ("explicit_fsdp", explicit, True, False),
        ("auto_fsdp_fleet", auto, True, True)):
    try:
        run(mesh, fsdp, fleet)
        out["facts"][label] = "ran"
    except Exception as e:
        out["facts"][label] = f"{{type(e).__name__}}: {{e}}"
for label, mesh, fsdp in (("fsdp_off", explicit, False),
                          ("fsdp_on", auto, True)):
    params, num_tx = run(mesh, fsdp, False)
    out["facts"][label] = num_tx
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        arrays[f"{{label}}/{{name(path)}}"] = np.asarray(x)
np.savez({npz!r}, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's results and the JAX subprocess's, run side by side."""
    npz = tmp_path_factory.mktemp("jax_mesh") / "sharded.npz"
    code = JAX_MESH_SCRIPT.format(src=str(ROOT / "src"), seq=SEQ, m=2,
                                  per=PER, policy=P1, lr=LR, npz=str(npz))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        jobs = dict(rank_args(JOBS), gather_methods=("gather_methods", (2,)))
        results = spawn(ranks.run_jobs, 4, timeout_s=TIMEOUT_S, device="cpu",
                        args=(jobs,))
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    jx = json.loads(out.strip().splitlines()[-1])
    with np.load(npz) as f:
        jx["sharded"] = {k: f[k] for k in f.files}
    return results, jx


def _int8_ties(g_eff: np.ndarray, band: float = RTOL) -> np.ndarray:
    """Elements of an ``(A, ...)`` leaf within ``band``·amax (1e-5) of an
    int8 rounding boundary of their agent's per-tensor scale."""
    dims = tuple(range(1, g_eff.ndim))
    scale = np.abs(g_eff).max(axis=dims, keepdims=True) / 127.0
    r = np.abs(g_eff / scale)
    return np.abs(r - np.floor(r) - 0.5) <= 127.0 * band


def _hold(name, job, got, k):
    """Step ``k`` of job ``name`` (rank 0's gathered result) against the
    JAX step from the same state.  Returns the number of elements one
    int8 level apart, or "tie" for a decision at its threshold.  A job's
    ``family_gap`` (the family's own single-process gap to JAX, for a
    family held at it on a model axis too) widens every check to it:
    decisions, metrics, EF memory, the int8 tie band and the update."""
    gap = job.get("family_gap", 0.0)
    band = max(RTOL, gap)
    _, states, metrics = _jax_chain(_key(job))
    jmet, jnext = metrics[k], states[k + 1]
    tx, jtx = got["metrics"]["agent_tx"], np.asarray(jmet["agent_tx"])
    if not np.array_equal(tx, jtx):
        lam = CommPolicy.parse(job["policy"]).trigger.arg("lam")
        gains = _jax_terms(_key(job), k)[1]
        odd = np.nonzero(tx != jtx)[0]
        assert np.all(np.abs(gains[odd] + lam) <= band * np.maximum(
            1, np.abs(gains[odd]))), f"{name}: decisions {tx} vs {jtx}"
        return "tie"
    for key in jmet:
        np.testing.assert_allclose(got["metrics"][key], np.asarray(jmet[key]),
                                   rtol=band, atol=ATOL,
                                   err_msg=f"{name} step {k}: {key}")
    want, before = _flat(jnext.params), _flat(states[k].params)
    assert got["params"].keys() == want.keys()
    tol = gap or (FAMILIES.get(job["arch"], 0.0) if job["model"] == 1
                  else 0.0)
    whole = max(np.abs(want[p] - before[p]).max() for p in want)
    int8 = "int8" in job["policy"]
    g_eff = _jax_terms(_key(job), k)[0] if int8 else None
    level = 0
    for path, w in want.items():
        leaf_step = np.abs(w - before[path]).max()
        atol = ATOL + tol * (whole if job["arch"] == "whisper-medium"
                             else leaf_step)
        bad = np.abs(got["params"][path] - w) > atol + RTOL * np.abs(w)
        if int8:
            tied = (_int8_ties(g_eff[path], band) & (jtx.reshape(
                (-1,) + (1,) * w.ndim) > 0)).any(0)
            level += int((bad & tied).sum())
            bad &= ~tied
        assert not bad.any(), f"{name} step {k}: params {path}"
    if jnext.ef_memory is not None:
        je = _flat(jnext.ef_memory)
        for path, w in je.items():
            dims = tuple(range(1, w.ndim))
            scale = np.abs(_jax_terms(_key(job), k)[0][path]).max(
                axis=dims, keepdims=True)
            bad = np.abs(got["ef"][path] - w) > ATOL + band * scale
            if int8:
                bad &= ~_int8_ties(g_eff[path], band)
            assert not bad.any(), f"{name} step {k}: EF memory {path}"
    return level


def check_job(results, name, job):
    """A job's steps, gathered on rank 0, against the JAX step; the four
    ranks agree on the fleet's metrics and on the parameters."""
    mine = [r[name] for r in results]
    outcomes = [_hold(name, job, mine[0]["steps"][k], k)
                for k in range(job["steps"])]
    assert outcomes.count("tie") < len(outcomes), outcomes
    for r in mine[1:]:
        for a, b in zip(r["steps"], mine[0]["steps"]):
            for key, v in b["metrics"].items():
                np.testing.assert_array_equal(a["metrics"][key], v)
            for path, v in b["params"].items():
                np.testing.assert_array_equal(a["params"][path], v)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_step_matches_jax(runs, name):
    check_job(runs[0], name, JOBS[name])


def test_jax_sharded_entry_point_agrees(runs):
    """JAX's own ``build_train_step(mesh, plan)`` on 4 host devices
    (fsdp off on ``make_host_mesh``'s mesh, fsdp on over an Auto mesh)
    and the port's mesh step from the same weights and batch."""
    results, jx = runs
    for label, job in (("fsdp_off", "lookahead_fsdp0_fleet0"),
                       ("fsdp_on", "lookahead_fsdp1_fleet0")):
        got = results[0][job]["steps"][0]
        assert float(got["metrics"]["num_tx"]) == jx["facts"][label]
        for path, v in got["params"].items():
            np.testing.assert_allclose(v, jx["sharded"][f"{label}/{path}"],
                                       rtol=RTOL, atol=ATOL, err_msg=path)


def test_jax_reference_failures_are_pinned(runs):
    """Two JAX paths fail on this JAX (ROADMAP §3): fsdp on an Explicit
    mesh (``with_sharding_constraint`` takes Auto axes only) and fsdp
    with ``fleet_shard`` (a mesh mismatch inside the shard_map).  A JAX
    that mends them changes these facts, and the oracle choice above."""
    facts = runs[1]["facts"]
    assert facts["explicit_fsdp"].startswith("ValueError") and (
        "Auto axes" in facts["explicit_fsdp"]), facts["explicit_fsdp"]
    assert facts["auto_fsdp_fleet"].startswith("ValueError") and (
        "should match the mesh" in facts["auto_fsdp_fleet"]), (
        facts["auto_fsdp_fleet"])


def test_local_blocks_match_jax_addressable_shards(runs):
    """Every arch's parameter and cache axes trees (fsdp off and on) on
    a (2, 2) mesh: each rank's ``NamedSharding.slices`` is the index of
    the JAX device at the same mesh coordinates."""
    indices = runs[1]["indices"]
    assert len(indices) == 10
    for arch, rows in indices.items():
        cfg = get_config(arch)
        params, axes = build(cfg).init(abstract=True)
        cache, cache_axes = DEC.init_cache(cfg, 2, 64, device="meta")
        for tag, ax, tree in (("params", axes, params),
                              ("cache", cache_axes, cache)):
            shapes = {"/".join(map(str, p)): x.shape
                      for p, x in tree_flatten_with_path(tree)}
            for fsdp in (False, True):
                for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    mesh = Mesh(("data", "model"), (2, 2), coords)
                    sh = tree_shardings(ax, tree, resolve_rules(
                        mesh, fsdp=fsdp), mesh)
                    for path, s in _flat_shardings(sh):
                        want = {tuple(c): b for c, b in
                                rows[f"{tag}:{fsdp}:{path}"]}[coords]
                        got = [[x.start, x.stop]
                               for x in s.slices(shapes[path])]
                        assert got == want, (arch, tag, fsdp, path)


def _flat_shardings(tree, prefix=()):
    """``(path, NamedSharding)`` in leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_shardings(tree[k], prefix + (k,))
    elif isinstance(tree, tuple):
        for n, x in zip(tree._fields, tree):
            yield from _flat_shardings(x, prefix + (n,))
    else:
        yield "/".join(map(str, prefix)), tree


def test_collective_log_and_blocks_at_rest(runs):
    """The collective log of one step against the count worked out from
    the code (reduced smollm, 2 layers, 4/2 heads, model 2), and the
    bytes each rank holds at rest."""
    results, _ = runs
    layers = 2
    # the stacked leaves: wq wk wv wo w_gate w_up w_down and the table
    # split over model; with fsdp every leaf's embed dim over data too
    # (also ln_attn, ln_ff and final_norm)
    leaves = 11
    for name, fsdp in (("lookahead_fsdp0_fleet0", False),
                       ("lookahead_fsdp1_fleet0", True)):
        r = results[0][name]
        tags = {k: v["count"] for k, v in r["steps"][0]["by_tag"].items()}
        want = {
            # forward, in the loss and in the probe: the attention's and
            # the SwiGLU's row-parallel outputs, the embedding, the
            # loss's max, logsumexp and gold combine
            "tp_attn_out": 2 * layers, "tp_mlp_out": 2 * layers,
            "tp_embed": 2, "ce_max": 2, "ce_lse": 2, "ce_gold": 2,
            # backward: the column-parallel inputs' gradients, the
            # loss's input; each agent's gradient stays the rank's model
            # blocks (no gather over model)
            "tp_attn_in": layers, "tp_mlp_in": layers, "ce_copy": 1,
            # the round: the agents' vectors and the payload over data,
            # the aggregate's norm over model; with fsdp each leaf
            # gathered over data (never over model; an all_gather on
            # these CPU tensors)
            "agent_vectors": 1, "payload": 1, "grad_norm": 1,
        }
        if fsdp:
            want["param_gather"] = leaves
        assert tags == want, (name, tags)
        axes = {k: v["count"] for k, v in r["steps"][0]["by_axis"].items()}
        assert axes == {"all-reduce@data": 2,
                        **({"all-gather@data": leaves} if fsdp else {}),
                        "all-reduce@model": sum(
                            v for k, v in want.items() if k.startswith(
                                ("tp_", "ce_", "grad_norm")))}, axes
        # operand bytes: the payload is the rank's model blocks in fp32
        # (half of every split leaf, the norms whole), the fsdp gather
        # each rank's blocks at rest
        ops = {k: v["operand_bytes"]
               for k, v in r["steps"][0]["by_tag"].items()}
        glob = r["global_param_bytes"]
        norm_bytes = (2 * layers + 1) * 256 * 4
        assert ops["payload"] == (glob - norm_bytes) // 2 + norm_bytes
        if fsdp:
            assert ops["param_gather"] == r["param_bytes"]
        # at rest: each rank's blocks, 1/4 (fsdp: data × model) or 1/2
        # (model only) of the split leaves; the step's memory tracker
        # reports each rank's peak: 2.05 parameter trees at this size
        # with each agent's gradient, EF memory and payload the rank's
        # blocks (3.20 when they were whole trees)
        assert r["param_bytes"] < r["global_param_bytes"] / (
            3 if fsdp else 1.5)
        peaks = [x[name]["steps"][0]["peak_bytes"] for x in results]
        assert max(peaks) < 2.5 * r["global_param_bytes"], peaks


def test_named_sharding_gathers_by_both_methods(runs):
    """``NamedSharding.gather`` on every rank of the (2, 2) mesh gives
    back the global tensor, for specs over data, model, both and
    neither.  It picks its collective by the backend and the tensor's
    device: gloo on these CPU tensors runs ``all_gather``, a replicated
    spec none (the zero-filled ``all_reduce``, gloo on CUDA tensors,
    runs in the card's ``[mesh]`` phase).  With ``dst`` the blocks go to
    that rank alone (the card's holds gather so), None elsewhere."""
    for r in runs[0]:
        got = r["gather_methods"]
        assert len(got) == 5, got
        for spec, (same, kinds, to_dst) in got.items():
            assert same and to_dst, spec
            assert kinds == ([] if spec == "PartitionSpec()"
                             else ["all-gather"]), (spec, kinds)


def test_remat_recomputes_the_forward_collectives(runs):
    """With remat the backward's recompute runs each block's forward
    again, its model-axis reductions included."""
    results, _ = runs
    plain = results[0]["lookahead_fsdp1_fleet0"]["steps"][0]["by_tag"]
    remat = results[0]["remat"]["steps"][0]["by_tag"]
    for tag in ("tp_attn_out", "tp_mlp_out"):
        assert remat[tag]["count"] == plain[tag]["count"] + 2, tag
    for tag in set(plain) - {"tp_attn_out", "tp_mlp_out"}:
        assert remat[tag]["count"] == plain[tag]["count"], tag
    launches = results[0]["remat"]["steps"][0]["launches"]
    assert launches == (3 * 2, 2)


def test_launches_per_rank_equal_the_single_process_step(runs):
    """Each rank launches the kernels' plain versions here as the
    single-process step does (2 × layers attention, 2 losses)."""
    results, _ = runs
    for name, job in JOBS.items():
        if job["remat"]:
            continue
        layers = reduced(get_config(job["arch"])).num_layers
        for r in results:
            for s in r[name]["steps"]:
                assert s["launches"] == (2 * layers, 2), (name, s["launches"])


def test_plan_run_mesh_matches_jax():
    """``plan_run`` on a mesh: JAX's agents, rules and FSDP default."""
    from repro.launch import steps as JS

    class FakeMesh:
        def __init__(self, shape, axes):
            self.axis_names, self.shape = axes, dict(zip(axes, shape))

    cfg, jcfg = reduced(get_config("smollm-135m")), jreduced(
        jget("smollm-135m"))
    shape = InputShape("t", 16, 32, "train")
    jshape = JShape("t", 16, 32, "train")
    for sizes, axes in (((2, 2), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        tm = Mesh(axes, sizes)
        for fsdp in (None, False, True):
            got = S.plan_run(cfg, shape, tm, fsdp=fsdp)
            want = JS.plan_run(jcfg, jshape, FakeMesh(sizes, axes),
                               fsdp=fsdp)
            assert (got.fsdp, got.agent_axes, got.num_agents) == (
                want.fsdp, want.agent_axes, want.num_agents)
            assert got.rules == want.rules
    one = S.plan_run(cfg, shape, fsdp=True)
    assert one.fsdp and one.num_agents == 1 and one.rules["embed"] == (
        "data",)
    assert S.plan_run(cfg, shape, num_agents=4).num_agents == 4
    with pytest.raises(ValueError, match="do not split"):
        S.plan_run(cfg, shape, Mesh(("data", "model"), (2, 2)), num_agents=3)
    # seq_shard and inner_batch_shard: JAX's rules on a mesh; with no
    # mesh they plan and shard nothing
    for knob in ("seq_shard", "inner_batch_shard"):
        got = S.plan_run(cfg, shape, Mesh(("data", "model"), (2, 2)),
                         **{knob: True})
        want = JS.plan_run(jcfg, jshape, FakeMesh((2, 2), ("data", "model")),
                           **{knob: True})
        assert got.rules == want.rules and getattr(got, knob)
        one = S.plan_run(cfg, shape, **{knob: True})
        assert getattr(one, knob) and one.num_agents == 1
    # cache_seq_shard is ported: JAX's rules
    tm = Mesh(("data", "model"), (2, 2))
    got = S.plan_run(cfg, shape, tm, cache_seq_shard=True)
    want = JS.plan_run(jcfg, jshape, FakeMesh((2, 2), ("data", "model")),
                       cache_seq_shard=True)
    assert got.rules == want.rules and got.rules["cache_seq"] == "model"
