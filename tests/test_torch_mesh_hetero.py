"""Per-agent policies, adaptive controllers, lossy channels and delay or
retransmit lines in the port's LM train step over a (data, model) mesh
of gloo ranks on the CPU (``repro_torch.launch.steps.build_train_step(
mesh=...)`` with a per-agent tuple ``comm``), against the JAX package.

One module fixture runs every job in one spawn of 4 ranks
(``tests/torch_mesh_ranks.py``, which imports no JAX) beside a JAX
subprocess with 4 forced host devices.  Reduced smollm-135m (2 layers,
d 256, vocab 512, 4/2 heads) on (data 2, model 2), m = 4 (two agents on
each data slice), 3 steps, each from the JAX chain's state (the gaps do
not compound).  The jobs:

1. ``_tiers``' four-tier tuple at lam = 0.01 (``always``, ``…|fp16``,
   ``…|int8+ef``, ``…|topk(0.05)|int8+ef``: two distinct policies on
   every data slice), fsdp off and on;
2. the same tuple with the second and third triggers swapped for
   ``budget_window(bytes=…)|fp16`` and ``budget_dual(rate=…)|int8+ef``
   (the controller slot) and the fourth agent ``@ bernoulli(p=0.2)``;
3. a homogeneous ``gain_lookahead(lam=0.01)|int8+ef @ delay(max_lag=2)``;
4. a homogeneous ``… @ retx(k=1, p=0.3)``;
5. job 1 under the ``switch`` and ``unroll`` dispatch paths;

and ``build_train_step(param_dtype="bfloat16")`` at float32 compute, on
one card and on the mesh (m = 2), the output table untied and tied.

The oracle: JAX's unsharded ``make_triggered_train_step`` (the chain's
states), and for the tuples JAX's own ``build_train_step`` on an
``AxisType.Auto`` mesh from the same states, where it runs (a delay or
retransmit line does not: ROADMAP §3).  The contract (ROADMAP §3):
metrics, parameters and controller rows within ``rtol = 1e-5, atol =
1e-6``; decisions and deliveries exact, except for a gain within 1e-5
of its threshold; EF memory and a line's payloads within ``rtol = 1e-5``
of each agent's ``max|g + ef|``; a rounding stage's output (an int8
level, an fp16 ULP: ``CompressorChain.rounding_ties``) may land one
step apart only where its input lies within that gap of a midpoint, and
such elements are counted.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
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
from repro_torch.core.api import init_train_state
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import spawn
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding.rules import NamedSharding, resolve_rules
from repro_torch.sharding.rules import agent_pspec as port_agent_pspec
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR, RTOL, ATOL = 0.1, 1e-5, 1e-6
SEQ, PER, M, STEPS = 16, 2, 4, 3
TIMEOUT_S = 420
LA = "gain_lookahead(lam=0.01)"
TIERS = ("always", LA + "|fp16", LA + "|int8+ef",
         LA + "|topk(0.05)|int8+ef")
# an fp16 payload of the reduced model is ~3.7 MB: the window's budget
# lets about half of the rounds through, the dual's rate a half
ADAPTIVE = ("always", "budget_window(bytes=2e6)|fp16",
            "budget_dual(rate=0.5)|int8+ef",
            LA + "|topk(0.05)|int8+ef @ bernoulli(p=0.2)")
DELAY = LA + "|int8+ef @ delay(max_lag=2)"
RETX = LA + "|int8+ef @ retx(k=1, p=0.3)"
BF16 = "always"


def _job(policy, *, fsdp=False, dispatch="hybrid", m=M, param_dtype=None,
         cfg=None):
    return dict(arch="smollm-135m", cfg=cfg or {}, model=2, m=m,
                policy=policy, fsdp=fsdp, fleet_shard=False,
                steps=STEPS if m == M else 1, dispatch=dispatch,
                param_dtype=param_dtype)


JOBS = {
    "tiers_fsdp0": _job(TIERS),
    "tiers_fsdp1": _job(TIERS, fsdp=True),
    "adaptive": _job(ADAPTIVE),
    "delay": _job(DELAY),
    "retx": _job(RETX),
    "tiers_switch": _job(TIERS, dispatch="switch"),
    "tiers_unroll": _job(TIERS, dispatch="unroll"),
    # bf16 parameters, the output table untied from the lookup's ...
    "bf16_params": _job(BF16, m=2, param_dtype="bfloat16",
                        cfg={"tie_embeddings": False}),
    # ... and tied, as smollm's and llama's are: the table's bf16
    # gradient sums its two reads' roundings (_hold_params)
    "bf16_tied": _job(BF16, m=2, param_dtype="bfloat16"),
}
# the jobs whose JAX oracle includes its sharded build_train_step
SHARDED = {"tiers_fsdp0": False, "tiers_fsdp1": True, "adaptive": False}


def _policies(job):
    pol = job["policy"]
    return tuple(pol) if isinstance(pol, tuple) else (pol,) * job["m"]


@functools.lru_cache(maxsize=None)
def _jax_model(cfg_items=()):
    jm = jbuild(jreduced(jget("smollm-135m")).replace(**dict(cfg_items)))
    return jm, jax.device_get(jm.init(jax.random.key(0))[0])


def _chain_key(job):
    return (job["policy"], job["m"], job["param_dtype"] or "float32",
            job["steps"], tuple(sorted(job["cfg"].items())))


@functools.lru_cache(maxsize=None)
def _jax_chain(key):
    """The JAX package's unsharded step (hybrid) from its initial state
    over the job's batches: ``(batches, states, metrics)``."""
    policy, m, pdt, steps, cfg_items = key
    jm, jp = _jax_model(cfg_items)
    jp = jax.tree_util.tree_map(lambda x: x.astype(pdt), jp)
    jcfg = JTrainConfig(lr=LR, optimizer="sgd", num_agents=m, comm=policy)
    jo = jopt.from_config(jcfg)
    step = jax.jit(jmake(jm.loss_fn, jo, jcfg,
                         options=JStepOptions(agent_metrics=True)))
    shape = JShape("mesh", SEQ, m * PER, "train")
    batches, states, metrics = [], [jinit(jp, jo, jcfg)], []
    for k in range(steps):
        b = jax.device_get(JD.lm_batch(jm.cfg, shape,
                                       jax.random.key(200 + k),
                                       num_agents=m))
        nxt, met = jax.device_get(step(states[-1], b))
        batches.append(b)
        states.append(nxt)
        metrics.append(met)
    return batches, [jax.device_get(s) for s in states], metrics


@functools.lru_cache(maxsize=None)
def _jax_terms(key, k):
    """Each agent's ``g + ef`` (fp32: the gradient with respect to the
    fp32 copy of the weights, before a lower-precision parameter dtype
    rounds it) and lookahead gain at the chain's state k."""
    jm, _ = _jax_model(key[-1])
    batches, states, _ = _jax_chain(key)
    params32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      states[k].params)

    def one(params, b):
        loss, g = jax.value_and_grad(jm.loss_fn)(params, b)
        probe = jax.tree_util.tree_map(lambda p, x: p - LR * x, params, g)
        return g, jm.loss_fn(probe, b) - loss

    grads, gains = jax.device_get(jax.vmap(one, in_axes=(None, 0))(
        params32, batches[k]))
    g_eff = _flat(grads)
    if states[k].ef_memory is not None:
        ef = _flat(states[k].ef_memory)
        g_eff = {p: g + ef[p].astype(np.float32) for p, g in g_eff.items()}
    return g_eff, np.asarray(gains)


TABLE = "embedding"


@functools.lru_cache(maxsize=None)
def _table_reads(key, k):
    """A tied table's per-agent fp32 cotangents of its two reads (the
    lookup's and the output projection's) at the chain's state k: the
    gradients of the untied model given the table as both tables."""
    policy, m, pdt, steps, cfg_items = key
    jm, _ = _jax_model(tuple(sorted(dict(cfg_items,
                                         tie_embeddings=False).items())))
    batches, states, _ = _jax_chain(key)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                    states[k].params)
    params = dict(params, out_embed=params[TABLE])
    grads = jax.device_get(jax.vmap(jax.grad(jm.loss_fn), in_axes=(None, 0))(
        params, batches[k]))
    return np.asarray(grads[TABLE]), np.asarray(grads["out_embed"])


def _flat(tree):
    """``{"a/b/c": numpy leaf}`` of a JAX or port tree (bf16 as fp32)."""
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
        else np.asarray(x), jax.device_get(tree))
    return {"/".join(str(p) for p in path): x.numpy() for path, x in
            tree_flatten_with_path(convert.to_torch(tree, "cpu"))}


def _port_state(jstate, param_dtype=None):
    """A JAX state as the port's on the CPU, the parameters at
    ``param_dtype`` (``convert`` carries no bf16 array: they cross as
    fp32, which holds every bf16 value)."""
    state = convert.state_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
        else x, jax.device_get(jstate)), device="cpu")
    if param_dtype is None:
        return state
    dt = getattr(torch, param_dtype)
    return state._replace(params=tree_map(lambda x: x.to(dt), state.params))


def _np32(x):
    return np.asarray(x, dtype=np.float32)


def rank_args():
    out = {}
    for name, job in JOBS.items():
        batches, states, _ = _jax_chain(_chain_key(job))
        state_np = [convert.to_numpy(_port_state(s))._replace(step=0)
                    for s in states[:job["steps"]]]
        out[name] = ("train_run", (dict(
            job, lr=LR, batches=[{k: np.asarray(v) for k, v in b.items()}
                                 for b in batches[:job["steps"]]],
            states=state_np),))
    return out


JAX_MESH_SCRIPT = r"""
import dataclasses, json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import AxisType
sys.path.insert(0, {src!r})
from repro.configs import get_config, reduced
from repro.configs.base import InputShape
from repro.core.api import init_train_state
from repro.launch import steps as S
from repro.launch.mesh import make_host_mesh
from repro.models import build
from repro.optim import optimizers as opt_lib

with open({inputs!r}, "rb") as f:
    jobs = pickle.load(f)
auto = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
coords = {{d.id: [int(i) for i in np.argwhere(auto.devices == d)[0]]
          for d in auto.devices.flat}}
cfg = reduced(get_config("smollm-135m"))
model = build(cfg)
params = model.init(jax.random.key(0))[0]
out, arrays = {{"facts": {{}}}}, {{}}


def name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)


def plan_for(policy, fsdp, mesh=auto):
    # JAX's plan_run gives a data slice one agent: m agents, m / 2 on
    # each data slice, by the plan's fields
    shape = InputShape("mesh", {seq}, {m} * {per}, "train")
    plan = S.plan_run(cfg, shape, mesh, comm=policy, lr={lr}, fsdp=fsdp)
    return dataclasses.replace(plan, num_agents={m}, train_cfg=(
        dataclasses.replace(plan.train_cfg, num_agents={m})))


for job, (policy, fsdp, states, batches) in jobs.items():
    plan = plan_for(policy, fsdp)
    step, *_ = S.build_train_step(auto, plan, compute_dtype="float32")
    template = init_train_state(params, opt_lib.from_config(plan.train_cfg),
                                plan.train_cfg)
    treedef = jax.tree_util.tree_structure(template)
    for k, (leaves, batch) in enumerate(zip(states, batches)):
        state = jax.tree_util.tree_unflatten(treedef, leaves)
        nxt, met = step(state, batch)
        for key, v in met.items():
            arrays[f"{{job}}/{{k}}/metrics/{{key}}"] = np.asarray(v)
        for path, x in jax.tree_util.tree_flatten_with_path(nxt.params)[0]:
            arrays[f"{{job}}/{{k}}/params/{{name(path)}}"] = np.asarray(x)
        if nxt.ef_memory is not None:
            for path, x in jax.tree_util.tree_flatten_with_path(
                    nxt.ef_memory)[0]:
                arrays[f"{{job}}/{{k}}/ef/{{name(path)}}"] = np.asarray(x)
        for slot in ("ctrl_state", "net_state"):
            v = getattr(nxt, slot)
            if v is None:
                continue
            arrays[f"{{job}}/{{k}}/{{slot}}"] = np.asarray(v)
            for shard in v.addressable_shards:
                c = coords[shard.device.id]
                arrays[f"{{job}}/{{k}}/{{slot}}@{{c[0]}}{{c[1]}}"] = np.asarray(
                    shard.data)

# the two reference faults: a delay line through build_train_step, and a
# decode step lowered on make_host_mesh's Explicit mesh
for label, mesh in (("delay_explicit", make_host_mesh(model=2)),
                    ("delay_auto", auto)):
    try:
        plan = plan_for({delay!r}, False, mesh)
        jitted, state_abs, batch_abs, *_ = S.build_train_step(
            mesh, plan, compute_dtype="float32")
        jitted.lower(state_abs, batch_abs)
        out["facts"][label] = "ran"
    except Exception as e:
        import traceback
        tb = traceback.extract_tb(e.__traceback__)[-1]
        out["facts"][label] = (f"{{type(e).__name__}}: {{e}} @ "
                               f"{{os.path.relpath(tb.filename, {root!r})}}:"
                               f"{{tb.lineno}}")
np.savez({npz!r}, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's results and the JAX subprocess's, run side by side."""
    import pickle

    tmp = tmp_path_factory.mktemp("jax_mesh_hetero")
    inputs = {}
    for job, fsdp in SHARDED.items():
        batches, states, _ = _jax_chain(_chain_key(JOBS[job]))
        inputs[job] = (JOBS[job]["policy"], fsdp,
                       [jax.tree_util.tree_leaves(s) for s in states[:STEPS]],
                       batches[:STEPS])
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    npz = tmp / "sharded.npz"
    code = JAX_MESH_SCRIPT.format(
        src=str(ROOT / "src"), root=str(ROOT), seq=SEQ, m=M, per=PER, lr=LR,
        delay=DELAY, inputs=str(tmp / "inputs.pkl"), npz=str(npz))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        results = spawn(ranks.run_jobs, 4, timeout_s=TIMEOUT_S, device="cpu",
                        model=2, args=(rank_args(),))
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    jx = json.loads(out.strip().splitlines()[-1])
    with np.load(npz) as f:
        jx["arrays"] = {k: f[k] for k in f.files}
    return results, jx


# ----------------------------------------------------------------------
# the contract
# ----------------------------------------------------------------------

def _chains(job):
    return [CommPolicy.parse(p).chain() for p in _policies(job)]


def _ties(job, g_eff, path):
    """Per agent, the spacing of a rounding stage whose input entry lies
    within ATOL + RTOL·max|g + ef| of a midpoint (0 elsewhere), for
    leaf ``path``: ``(A, *leaf)``."""
    x = torch.as_tensor(g_eff[path], dtype=torch.float32)
    out = torch.zeros_like(x)
    for i, chain in enumerate(_chains(job)):
        if chain is None or not chain.stages:
            continue
        xi = x[i:i + 1]
        tol = ATOL + RTOL * xi.abs().max()
        out[i:i + 1] = chain.rounding_ties(xi, tol)
    return out.numpy()


def _bf16_ulp(x):
    """One bf16 ULP of |x| (the spacing at x's binade)."""
    x = np.maximum(np.abs(np.asarray(x, dtype=np.float32)), 1e-30)
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


def _bf16_ties(x, tol):
    """Entries of an fp32 ``x`` within ``tol`` of a bf16 midpoint."""
    ulp = _bf16_ulp(x)
    lv = np.abs(x) / ulp
    return np.abs(lv - np.floor(lv) - 0.5) * ulp <= tol


def _decisions(name, job, k, got, want_tx):
    """Decisions equal, or apart only for a fixed-threshold agent whose
    gain lies within 1e-5 of it.  Returns whether any was a tie."""
    tx = got["metrics"]["agent_tx"]
    if np.array_equal(tx, want_tx):
        return False
    gains = _jax_terms(_chain_key(job), k)[1]
    for i in np.nonzero(tx != want_tx)[0]:
        trig = CommPolicy.parse(_policies(job)[i]).trigger
        assert trig.name == "gain_lookahead", (name, k, i, tx, want_tx)
        lam = trig.arg("lam")
        assert abs(gains[i] + lam) <= RTOL * max(1.0, abs(gains[i])), (
            f"{name} step {k}: decisions {tx} vs {want_tx}")
    return True


def _hold_params(name, job, k, got, want, before, weight):
    """Parameters within the contract; a rounding stage one step apart
    (its share ``lr · weight`` of the update) where an agent's input is
    tied.  Returns the number of tied elements used."""
    key = _chain_key(job)
    g_eff = _jax_terms(key, k)[0]
    used = 0
    for path, w in want.items():
        g = _np32(got["params"][path])
        w32 = _np32(w)
        bad = np.abs(g - w32) > ATOL + RTOL * np.abs(w32)
        if job["param_dtype"] == "bfloat16":
            # an agent's bf16 gradient is its fp32 gradient rounded once:
            # where that lies within RTOL·max|g| of a bf16 midpoint the
            # packages may round it one bf16 ULP apart, which moves the
            # update by lr / weight of that ULP and p + u, rounded to
            # bf16, by up to one ULP of the parameter more.  A tied
            # table's is its two reads' cotangents, each rounded so, and
            # their sum rounded, which the packages order and fuse
            # differently: each agent's may lie a ULP of either read and
            # of their sum apart anywhere on the table
            g_r = g_eff[path]
            if path == TABLE and dict(key[-1]).get("tie_embeddings", True):
                g_l, g_o = _table_reads(key, k)
                gt = np.ones(g_r.shape, bool)
                moved = (_bf16_ulp(g_l) + _bf16_ulp(g_o)
                         + _bf16_ulp(np.abs(g_l) + np.abs(g_o)))
            else:
                gt = np.stack([
                    _bf16_ties(g_r[i], RTOL * np.abs(g_r[i]).max())
                    for i in range(g_r.shape[0])])
                moved = gt * _bf16_ulp(g_r)
            tied = gt.any(0)
            near = np.abs(g - w32) <= ATOL + _bf16_ulp(w32) + LR * (
                moved.sum(0) / max(1.0, weight))
        else:
            spacing = _ties(job, g_eff, path).sum(0)
            near = np.abs(g - w32) <= (ATOL + RTOL * np.abs(w32) + LR
                                       * spacing / max(1.0, weight))
            tied = spacing > 0
        used += int((bad & tied & near).sum())
        bad &= ~(tied & near)
        assert not bad.any(), (
            f"{name} step {k}: params {path}, worst "
            f"{np.abs(g - w32)[bad].max():.3e} at {np.argwhere(bad)[:3]}")
    return used


def _hold_per_agent(name, job, k, got, want, what):
    """A per-agent tree (EF memory, a delay line's payloads) within RTOL
    of each agent's max|g + ef|, a rounding step apart where tied."""
    g_eff = _jax_terms(_chain_key(job), k)[0]
    for path, w in want.items():
        leaf = path.split("/", 2)[-1] if what == "line" else path
        w = _np32(w)
        g = _np32(got[path])
        ge = g_eff[leaf]
        dims = tuple(range(1, ge.ndim))
        scale = np.abs(ge).max(axis=dims, keepdims=True)
        spacing = _ties(job, g_eff, leaf)
        if what == "line":
            # (A, depth, *leaf): the line holds the payloads of earlier
            # rounds too; each slot within the agent's scale
            scale, spacing = scale[:, None], spacing[:, None]
        bad = np.abs(g - w) > ATOL + RTOL * scale + spacing
        assert not bad.any(), f"{name} step {k}: {what} {path}"


def _hold_metrics(name, job, k, got, want):
    """The fleet's metrics within the contract; with bf16 parameters the
    aggregate's norm within bf16's resolution (2^-8 of it: its entries
    are the bf16 gradients' mean)."""
    for mk in want:
        bf16 = job["param_dtype"] == "bfloat16" and mk == "grad_norm"
        np.testing.assert_allclose(
            _np32(got[mk]), _np32(want[mk]), rtol=2.0 ** -8 if bf16 else RTOL,
            atol=ATOL, err_msg=f"{name} step {k}: {mk}")


def check_job(results, jx, name, job):
    """A job's steps, gathered on rank 0, against the JAX chain (and JAX's
    sharded step where it runs); the four ranks agree."""
    key = _chain_key(job)
    _, states, metrics = _jax_chain(key)
    mine = [r[name] for r in results]
    ties = 0
    for k in range(job["steps"]):
        got = mine[0]["steps"][k]
        jmet, jnext = metrics[k], states[k + 1]
        want_tx = np.asarray(jmet["agent_tx"])
        tie = _decisions(name, job, k, got, want_tx)
        if "agent_delivered" in jmet:
            np.testing.assert_array_equal(
                got["metrics"]["agent_delivered"] > 0,
                np.asarray(jmet["agent_delivered"]) > 0)
        if tie:
            continue
        _hold_metrics(name, job, k, got["metrics"], jmet)
        weight = float(np.asarray(jmet.get("agent_delivered",
                                           jmet["agent_tx"])).sum())
        ties += _hold_params(name, job, k, got, _flat(jnext.params),
                             _flat(states[k].params), weight)
        if jnext.ef_memory is not None:
            _hold_per_agent(name, job, k, got["ef"], _flat(jnext.ef_memory),
                            "EF memory")
        if jnext.ctrl_state is not None:
            np.testing.assert_allclose(
                got["ctrl"][""], np.asarray(jnext.ctrl_state), rtol=RTOL,
                atol=ATOL, err_msg=f"{name} step {k}: controller rows")
        if jnext.net_state is not None:
            net = _flat(convert.state_from_jax(jnext, device="cpu")
                        .net_state)
            for path, w in net.items():
                if "buf" in path:
                    continue
                np.testing.assert_allclose(
                    _np32(got["net"][path]), _np32(w), rtol=RTOL, atol=ATOL,
                    err_msg=f"{name} step {k}: net {path}")
            line = {p: w for p, w in net.items() if "buf" in p}
            if line:
                _hold_per_agent(name, job, k, got["net"], line, "line")
        if name in SHARDED:
            _hold_sharded(jx, name, job, k, got)
    for r in mine[1:]:
        for a, b in zip(r["steps"], mine[0]["steps"]):
            for mk, v in b["metrics"].items():
                np.testing.assert_array_equal(a["metrics"][mk], v)
            for path, v in b["params"].items():
                np.testing.assert_array_equal(a["params"][path], v)
    return ties


def _hold_sharded(jx, name, job, k, got):
    """The port's step against JAX's ``build_train_step`` on the Auto
    mesh from the same state: the fleet's metrics, the parameters (the
    same tie allowance as against the chain) and the controller and
    channel rows."""
    arr = jx["arrays"]
    pre = f"{name}/{k}/"
    for mk in ("loss", "num_tx", "comm_rate", "mean_gain", "wire_bytes"):
        np.testing.assert_allclose(
            _np32(got["metrics"][mk]), arr[pre + "metrics/" + mk],
            rtol=RTOL, atol=ATOL, err_msg=f"{name} step {k}: JAX sharded {mk}")
    want = {p[len(pre + "params/"):]: v for p, v in arr.items()
            if p.startswith(pre + "params/")}
    weight = float(arr[pre + "metrics/num_tx"])
    _, states, _ = _jax_chain(_chain_key(job))
    _hold_params(name + " (JAX sharded)", job, k, got, want,
                 _flat(states[k].params), weight)
    for slot, key in (("ctrl_state", "ctrl"), ("net_state", "net")):
        if pre + slot in arr:
            np.testing.assert_allclose(
                _rows(got[key]), arr[pre + slot], rtol=RTOL, atol=ATOL,
                err_msg=f"{name} step {k}: JAX sharded {slot}")


def _rows(slot: dict):
    """The per-agent rows of a flattened controller or channel slot (the
    bare rows, or the first of a line's pair)."""
    return slot[""] if "" in slot else slot["0"]


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_hetero_step_matches_jax(runs, name):
    results, jx = runs
    apart = check_job(results, jx, name, JOBS[name])
    got = results[0][name]["steps"]
    total = sum(x.size for s in got for x in s["params"].values())
    assert apart < 0.01 * total, (apart, total)


def test_rank_rows_are_jax_addressable_shards(runs):
    """Each rank's controller and channel rows are the rows of JAX's
    addressable shard of the slot on the device at the same (data,
    model) coordinates, after every step (the agent axis over data; the
    two model ranks of a data slice hold the same rows)."""
    results, jx = runs
    arr = jx["arrays"]
    seen = 0
    for name in SHARDED:
        for r in results:
            c = "".join(str(x) for x in r[name]["coords"])
            for k, s in enumerate(r[name]["steps"]):
                for slot, key in (("ctrl_state", "ctrl"),
                                  ("net_state", "net")):
                    shard = arr.get(f"{name}/{k}/{slot}@{c}")
                    if shard is None:
                        continue
                    mine = _rows(s[f"{key}_local"])
                    assert mine.shape == shard.shape, (name, slot, c)
                    np.testing.assert_allclose(mine, shard, rtol=RTOL,
                                               atol=ATOL)
                    seen += 1
    # the adaptive job carries both slots, the tiers none
    assert seen == 2 * 4 * STEPS, seen


def test_state_shardings_lay_the_agent_slots_over_data():
    """``state_shardings`` gives the controller rows, the channel rows and
    both halves of a delay line's pair JAX's ``agent_pspec`` (P("data"))
    on their agent axis, and the line's payloads their leaf's model
    layout after it (the rank's model blocks): the two model ranks of a
    data slice hold its agents' rows, and the data slices tile the fleet
    (the spawn's jobs round-trip them through ``shard_tree`` and
    ``gather_tree``)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build
    from repro_torch.sharding.placement import Placement

    cfg = reduced(get_config("smollm-135m"))
    model = build(cfg)
    shapes, axes = model.init(abstract=True)
    for policy in (ADAPTIVE, DELAY):
        tcfg = S.plan_run(cfg, InputShape("t", SEQ, M * PER, "train"),
                          Mesh(("data", "model"), (2, 2)), num_agents=M,
                          comm=policy).train_cfg
        state = init_train_state(shapes, opt_lib.from_config(tcfg), tcfg,
                                 device="meta")
        rows = {}
        for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
            mesh = Mesh(("data", "model"), (2, 2), coords)
            rules = resolve_rules(mesh)
            assert port_agent_pspec(mesh, M, rules) == ("data",)
            pl = Placement(mesh, axes, shapes, rules, M)
            sh = pl.state_shardings(state, "sgd")
            slots = [x for x in tree_flatten_with_path(
                (sh.ctrl_state, sh.net_state)) if x[1] is not None]
            assert slots
            model = dict(tree_flatten_with_path(pl.model_shardings))
            for path, s in slots:
                want = ("data",)
                if "buf" in path:
                    want = ("data", None) + tuple(model[path[3:]].spec)
                assert isinstance(s, NamedSharding) and s.spec == want, (
                    path, s.spec)
                leaf = dict(tree_flatten_with_path(
                    (state.ctrl_state, state.net_state)))[path]
                rows.setdefault(path, {})[coords] = s.slices(leaf.shape)[0]
        for path, by in rows.items():
            assert by[(0, 0)] == by[(0, 1)] == slice(0, M // 2), path
            assert by[(1, 0)] == by[(1, 1)] == slice(M // 2, M), path


def _one_card_bf16(name):
    """JOBS[``name``] through ``build_train_step(param_dtype="bfloat16")``
    without a mesh: the state holds bf16 parameters, the model computes
    in fp32, and one step is JAX's (bf16's rounding allowed one ULP at a
    midpoint, counted); a state at fp32 is refused."""
    job = JOBS[name]
    key = _chain_key(job)
    batches, states, metrics = _jax_chain(key)
    cfg = reduced(get_config("smollm-135m")).replace(**job["cfg"])
    plan = S.plan_run(cfg, InputShape("t", SEQ, job["m"] * PER, "train"),
                      num_agents=job["m"], comm=job["policy"], lr=LR)
    step = S.build_train_step(plan, compute_dtype="float32",
                              param_dtype="bfloat16", device="cpu",
                              agent_metrics=True)
    batch = convert.to_torch(batches[0], "cpu")
    with pytest.raises(TypeError, match="bfloat16"):
        step(_port_state(states[0]), batch)
    state = _port_state(states[0], "bfloat16")
    assert all(x.dtype == torch.bfloat16 for _, x in
               tree_flatten_with_path(state.params))
    nxt, met = step(state, batch)
    assert all(x.dtype == torch.bfloat16 for _, x in
               tree_flatten_with_path(nxt.params))
    got = {"metrics": {k: v.numpy() for k, v in met.items()},
           "params": {"/".join(map(str, p)): x.float().numpy()
                      for p, x in tree_flatten_with_path(nxt.params)}}
    assert not _decisions(f"{name} one card", job, 0, got,
                          np.asarray(metrics[0]["agent_tx"]))
    _hold_metrics(f"{name} one card", job, 0, got["metrics"], metrics[0])
    weight = float(np.asarray(metrics[0]["agent_tx"]).sum())
    apart = _hold_params(f"{name} one card", job, 0, got,
                         _flat(states[1].params), _flat(states[0].params),
                         weight)
    total = sum(x.size for x in got["params"].values())
    assert apart < 0.01 * total, (apart, total)


def test_param_dtype_on_one_card_matches_jax():
    """An untied output table (``_one_card_bf16``)."""
    _one_card_bf16("bf16_params")


def test_param_dtype_tied_table_on_one_card_matches_jax():
    """A tied table, its two reads' bf16 roundings allowed
    (``_one_card_bf16``, ``_table_reads``)."""
    _one_card_bf16("bf16_tied")


def test_jax_reference_faults_are_pinned(runs):
    """JAX's ``build_train_step`` gives a delay line's net slot one
    ``(m, NET_WIDTH)`` array, where the line carries a ``(rows, line)``
    pair: it raises at ``src/repro/net/channels.py:487`` on either mesh
    (ROADMAP §3), which is why the delay and retransmit jobs hold to
    JAX's unsharded step.  A JAX that mends it changes this fact."""
    facts = runs[1]["facts"]
    for label in ("delay_explicit", "delay_auto"):
        assert facts[label].startswith("ValueError: too many values to "
                                       "unpack"), facts[label]
        assert facts[label].endswith("src/repro/net/channels.py:487"), (
            facts[label])
