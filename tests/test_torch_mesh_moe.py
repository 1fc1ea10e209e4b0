"""The moe family on the port's (data, model) mesh of gloo ranks on the
CPU, against the JAX package: the expert axis and each expert's ``ff``
columns over "model", with ``seq_shard`` and ``inner_batch_shard``,
then prefill and decode, and the prefill that fills a KV cache under
``seq_shard`` (dense and moe).

One module fixture runs every rank program in one spawn of 4 ranks
(``tests/torch_mesh_ranks.py``, which imports no JAX); the test process
runs the JAX side on the same inputs (the JAX package's weights and
``lm_batch`` draws).  Reduced mixtral-8x7b (2 layers, d 256, 4 experts
top-2, ``d_ff_expert`` 512, vocab 512) and kimi-k2 (the same with one
shared expert) at (data 2, model 2), m = 2 agents × 2 rows × 16 tokens:

* the expert split (4 experts: each rank holds 2), fsdp off and on, one
  ``fleet_shard`` step, and kimi-k2's shared experts beside them;
* the ``ff`` split (``num_experts=3``: the guard replicates the expert
  axis and splits every expert's ``ff`` columns);
* ``seq_shard`` and ``inner_batch_shard`` (the router sees the agent's
  whole token set: each rank gathers it before routing);
* a capacity factor of 0.5, which drops pairs: the step under each knob,
  and the dropped (token, k) pairs of every layer and agent, recorded
  on each rank, against JAX's (its router on its own layer inputs, its
  capacity, and the stable-sort dispatch oracle of
  tests/test_torch_moe.py);
* prefill and 4 decode steps in both cache layouts, and the prefill
  under ``seq_shard`` that fills the cache decode reads (smollm, the
  dense family, and mixtral);
* every family's train, prefill and serve steps build on a model axis
  (the hybrid and ssm families': tests/test_torch_mesh_recurrent.py).

The train jobs are held under tests/test_torch_mesh_lm.py's contract
(``check_job``: metrics and parameters within ``rtol = 1e-5, atol =
1e-6``, decisions exact but for a gain within 1e-5 of its threshold, EF
memory within ``rtol = 1e-5`` of each agent's ``max|g + ef|``, an int8
element at a rounding midpoint one level apart; on a model axis of 2
the harness grants no family allowance), and one ``gain_lookahead``
step of the expert split also to JAX's own sharded ``build_train_step``
on an ``AxisType.Auto`` mesh of 4 forced host devices (a subprocess
beside the spawn) within the same tolerance.  Serving is held as
tests/test_torch_mesh_serve.py holds it: logits within ``rtol = 1e-5,
atol = 1e-6`` (mixtral's at ``atol = 1e-5``, its single-process gap to
JAX: tests/test_torch_moe.py's ``LOGIT_TOL``), the cache within ``rtol =
1e-5`` of its largest value, positions exact.
"""
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

import test_torch_mesh_lm as lm
import torch_mesh_ranks as ranks
from repro.data import synthetic as JD
from repro.configs.base import InputShape as JShape
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Mesh, spawn
from test_torch_moe import _dropped_pairs

torch.set_num_threads(1)

P1, P2 = lm.P1, lm.P2
MIX, KIMI = "mixtral-8x7b", "kimi-k2-1t-a32b"
SEQ = {"seq_shard": True}
INNER = {"inner_batch_shard": True}
E3 = {"moe": (("num_experts", 3),)}
LOW = {"moe": (("capacity_factor", 0.5),)}
RTOL, ATOL = 1e-5, 1e-6
# the moe family's logits gap to JAX on one process
# (tests/test_torch_moe.py's LOGIT_TOL)
LOGIT_ATOL = {MIX: 1e-5}
TIMEOUT_S = 420


def _job(policy, fsdp, fleet=False, *, arch=MIX, cfg=None, knobs=None,
         steps=1):
    return dict(lm._job(policy, fsdp, fleet, arch=arch, cfg=cfg,
                        steps=steps), knobs=knobs or {})


JOBS = {
    "expert_lookahead": _job(P1, False),
    "expert_fsdp0": _job(P2, False, steps=2),
    "expert_fsdp1": _job(P1, True),
    "expert_fleet": _job(P1, True, True),
    "ff_fsdp0": _job(P2, False, cfg=E3),
    "ff_fsdp1": _job(P1, True, cfg=E3),
    "kimi_fsdp0": _job(P2, False, arch=KIMI),
    "kimi_fsdp1": _job(P1, True, arch=KIMI),
    "expert_seq": _job(P2, False, knobs=SEQ),
    "ff_seq": _job(P1, True, cfg=E3, knobs=SEQ),
    "kimi_seq": _job(P1, False, arch=KIMI, knobs=SEQ),
    "expert_inner": _job(P2, False, knobs=INNER),
    "kimi_inner": _job(P1, True, True, arch=KIMI, knobs=INNER),
    "drops_seq": _job(P1, False, cfg=LOW, knobs=SEQ),
    "drops_inner": _job(P1, False, cfg=LOW, knobs=INNER),
    "drops_tp": _job(P1, False, cfg=LOW),
}

# serving: B 4 × 16 prompt tokens into a cache of 32 slots, 4 decode
# steps, fsdp off (cache_seq_shard) and on (decode_heads)
B, PROMPT, CACHE, DECODE = 4, 16, 32, 4
SERVE = {f"{arch}_{'seq_' if seq else ''}{'cs' if cs else 'dh'}":
         dict(arch=arch, cfg={}, fsdp=not cs, cache_seq_shard=cs,
              seq_shard=seq)
         for arch, seqs in ((MIX, (False, True)), ("smollm-135m", (True,)))
         for cs in (False, True) for seq in seqs}


@functools.lru_cache(maxsize=None)
def _tokens():
    k1, k2 = jax.random.split(jax.random.key(11))
    return (np.asarray(jax.random.randint(k1, (B, PROMPT), 0, 512),
                       np.int32),
            np.asarray(jax.random.randint(k2, (B, DECODE), 0, 512),
                       np.int32))


@functools.lru_cache(maxsize=None)
def _jax_serving(arch):
    """JAX's unsharded prefill and DECODE decode steps."""
    jm, jp = lm._jax_model(arch, ())
    prompt, toks = _tokens()
    logits, cache = jm.prefill(jp, {"tokens": prompt}, cache_len=CACHE)
    out = {"logits": [np.asarray(logits)], "cache_prefill": _np_kv(cache)}
    step = jax.jit(jm.decode_step)
    for t in range(DECODE):
        logits, cache = step(jp, cache, toks[:, t:t + 1],
                             np.int32(PROMPT + t))
        out["logits"].append(np.asarray(logits))
    out["cache"] = _np_kv(cache)
    return out


def _np_kv(cache):
    return {name: np.asarray(getattr(cache, name))
            for name in ("k", "v", "pos_ids")}


@functools.lru_cache(maxsize=None)
def _drops_batch():
    """One global batch of the drops jobs' shape (m 2 × 2 rows × 16)."""
    jm, _ = lm._jax_model(MIX, tuple(LOW.items()))
    return jax.device_get(JD.lm_batch(jm.cfg, JShape("d", lm.SEQ, 4,
                                                     "train"),
                                      jax.random.key(5), num_agents=2))


def _rank_args():
    jobs = lm.rank_args(JOBS)
    prompt, toks = _tokens()
    for name, job in SERVE.items():
        _, jp = lm._jax_model(job["arch"], ())
        jobs[name] = ("serve_run", (dict(
            job, params=convert.to_numpy(convert.params_from_jax(
                jp, device="cpu")),
            prompt=prompt, decode=toks, cache_len=CACHE),))
    _, jp = lm._jax_model(MIX, tuple(LOW.items()))
    params = convert.to_numpy(convert.params_from_jax(jp, device="cpu"))
    batch = {k: np.asarray(v) for k, v in _drops_batch().items()}
    for knob, knobs in (("seq", SEQ), ("inner", INNER), ("tp", {})):
        jobs[f"routes_{knob}"] = ("moe_drops_run", (dict(
            arch=MIX, cfg=LOW, knobs=knobs, params=params, batch=batch),))
    return jobs


JAX_SHARDED_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import AxisType
sys.path.insert(0, {src!r})
from repro.configs import get_config, reduced
from repro.configs.base import InputShape
from repro.core.api import init_train_state
from repro.data import synthetic as D
from repro.launch import steps as S
from repro.models import build
from repro.optim import optimizers as opt_lib

auto = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out, arrays = {{}}, {{}}
for arch in {archs!r}:
    cfg = reduced(get_config(arch))
    for sub, items in {subs!r}.get(arch, ()):
        cfg = cfg.replace(**{{sub: dataclasses.replace(getattr(cfg, sub),
                                                      **dict(items))}})
    shape = InputShape("mesh", {seq}, {m} * {per}, "train")
    plan = S.plan_run(cfg, shape, auto, comm={policy!r}, lr={lr},
                      fsdp=False)
    step, *_ = S.build_train_step(auto, plan, compute_dtype="float32")
    model = build(cfg)
    state = init_train_state(model.init(jax.random.key(0))[0],
                             opt_lib.from_config(plan.train_cfg),
                             plan.train_cfg)
    batch = D.lm_batch(model.cfg, shape, jax.random.key(100),
                       num_agents={m})
    nxt, met = step(state, batch)
    out[arch] = float(met["num_tx"])
    for path, x in jax.tree_util.tree_flatten_with_path(
            jax.device_get(nxt.params))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        arrays[f"{{arch}}/{{key}}"] = np.asarray(x)
np.savez({npz!r}, **arrays)
print(json.dumps(out))
"""


def start_jax_sharded(archs, tmp, subs=None, policy=P1):
    """JAX's own sharded ``build_train_step`` for each reduced arch on an
    ``AxisType.Auto`` (data 2, model 2) mesh of 4 forced host devices,
    fsdp off, one ``policy`` step (``gain_lookahead(lam=0.01)``) from
    seed 0's weights and the first batch of tests/test_torch_mesh_lm.py's
    chain: a subprocess started beside the spawn.  ``subs`` maps an arch
    to its
    sub-config overrides (``(("xlstm", (("slstm_proj_factor", 1.5),)),)``).
    ``finish_jax_sharded`` reads its results."""
    root = pathlib.Path(__file__).resolve().parents[1]
    npz = tmp / "sharded.npz"
    code = JAX_SHARDED_SCRIPT.format(src=str(root / "src"), archs=archs,
                                     subs=subs or {}, seq=lm.SEQ, m=2,
                                     per=lm.PER, policy=policy, lr=lm.LR,
                                     npz=str(npz))
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, npz


def finish_jax_sharded(proc, npz):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    num_tx = json.loads(out.strip().splitlines()[-1])
    with np.load(npz) as f:
        return num_tx, {k: f[k] for k in f.files}


def hold_to_jax_sharded(results, jx, arch, job):
    """The port's first step of ``job`` (``gain_lookahead``, fsdp off)
    against JAX's sharded step from the same weights and batch: the
    decisions equal and every parameter within ``rtol = 1e-5, atol =
    1e-6``."""
    num_tx, arrays = jx
    got = results[0][job]["steps"][0]
    assert float(got["metrics"]["num_tx"]) == num_tx[arch]
    for path, v in got["params"].items():
        np.testing.assert_allclose(v, arrays[f"{arch}/{path}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{arch} {path}")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The spawn's results, and JAX's sharded step run beside it."""
    proc, npz = start_jax_sharded((MIX,), tmp_path_factory.mktemp("jax"))
    try:
        results = spawn(ranks.run_jobs, 4, timeout_s=TIMEOUT_S,
                        device="cpu", args=(_rank_args(),))
        jx = finish_jax_sharded(proc, npz)
    finally:
        if proc.poll() is None:
            proc.kill()
    return results, jx


@pytest.fixture(scope="module")
def runs(both):
    return both[0]


@pytest.mark.parametrize("name", sorted(JOBS))
def test_moe_mesh_step_matches_jax(runs, name):
    lm.check_job(runs, name, JOBS[name])


def test_expert_split_matches_jax_sharded_step(both):
    """JAX's own sharded step (expert axis on "model", an Auto mesh)
    and the port's mesh step from the same weights and batch."""
    hold_to_jax_sharded(*both, MIX, "expert_lookahead")


def _tags(runs, name):
    return {k: v["count"]
            for k, v in runs[0][name]["steps"][0]["by_tag"].items()}


def test_expert_split_collectives(runs):
    """The expert split under tensor parallelism (2 layers): per layer
    and forward (the loss's and the probe's) the router's logits made
    whole and the experts' partial outputs summed once; in the backward
    the gates' and the layer input's cotangents summed once.  The ff
    split has no logits gather; kimi's shared experts add no collective
    (one sum for the routed and the shared outputs)."""
    layers = 2
    for name in ("expert_fsdp0", "kimi_fsdp0", "ff_fsdp0"):
        tags = _tags(runs, name)
        logits = 0 if name.startswith("ff") else 2 * layers
        assert tags.get("tp_moe_logits", 0) == logits, (name, tags)
        assert tags["tp_moe_out"] == 2 * layers, (name, tags)
        assert tags["tp_moe_gates"] == layers, (name, tags)
        assert tags["tp_moe_in"] == layers, (name, tags)
    # seq_shard: the chunk gathered, the partial outputs reduce-scattered,
    # the logits' backward summed; no tensor-parallel moe collective
    tags = _tags(runs, "expert_seq")
    assert tags["sp_moe_in"] == 2 * layers and tags["sp_moe_out"] == (
        2 * layers) and tags["sp_moe_logits"] == 2 * layers, tags
    assert tags["sp_moe_logits_grad"] == layers, tags
    assert not [t for t in tags if t.startswith("tp_")], tags
    # inner_batch_shard: the agent's rows gathered before routing, every
    # weight whole
    tags = _tags(runs, "expert_inner")
    assert tags["rows_moe_in"] == 2 * layers, tags
    assert tags["rows_moe_in_grad"] == layers, tags


def test_launches_per_rank_equal_the_single_process_step(runs):
    """Each rank launches the kernels' plain versions as the
    single-process step does (2 × layers attention, 2 losses)."""
    for name, job in JOBS.items():
        for r in runs:
            for s in r[name]["steps"]:
                assert s["launches"] == (4, 2), (name, s["launches"])


def _jax_drops(batch):
    """JAX's dropped (token, k) pairs per agent and layer: each layer's
    input and router captured from its own forward (``jax.debug.
    callback``), its routing, capacity and the dispatch oracle."""
    jm, jp = lm._jax_model(MIX, tuple(LOW.items()))
    moe = jm.cfg.moe
    seen = []
    plain = JMOE.moe_layer

    def spy(p, cfg, x):
        jax.debug.callback(lambda r, h: seen.append((np.asarray(r),
                                                     np.asarray(h))),
                           p["router"], x, ordered=True)
        return plain(p, cfg, x)

    out = []
    JMOE.moe_layer = spy
    try:
        for a in range(batch["labels"].shape[0]):
            seen.clear()
            jax.block_until_ready(jm.loss_fn(
                jp, {k: v[a] for k, v in batch.items()}))
            jax.effects_barrier()
            layers = []
            for router, h in seen:
                xt = h.reshape(-1, h.shape[-1])
                probs = jax.nn.softmax(xt @ router, axis=-1)
                _, ids = jax.lax.top_k(probs, moe.experts_per_token)
                layers.append(_dropped_pairs(
                    np.asarray(ids), moe.num_experts, JMOE.capacity(
                        xt.shape[0], moe.experts_per_token,
                        moe.num_experts, moe.capacity_factor)))
            out.append(layers)
    finally:
        JMOE.moe_layer = plain
    return out


def test_dropped_pairs_equal_jax_under_both_knobs(runs):
    """Capacity factor 0.5 (each expert keeps 16 of an agent's 64
    pairs): every rank, on its chunk (``seq_shard``) or its row
    (``inner_batch_shard``) of each agent's tokens, or on all of them
    (tensor parallelism), drops exactly the pairs JAX's global routing
    drops, per agent and layer; and some pairs are dropped."""
    want = _jax_drops(_drops_batch())
    assert sum(len(d) for layers in want for d in layers) > 10, want
    for knob, tokens in (("seq", [1, 2, 8]), ("inner", [1, 1, 16]),
                         ("tp", [1, 2, 16])):
        for r in runs:
            got = r[f"routes_{knob}"]
            assert got["tokens"] == tokens, (knob, got["tokens"])
            assert got["split"] == {"tp": None, "seq": "seq"}.get(knob,
                                                                  "rows")
            for a, layers in zip(got["agents"], got["drops"]):
                assert len(layers) == len(want[a]) == 2
                for mask, jd in zip(layers, want[a]):
                    pairs = {divmod(int(j), mask.shape[1])
                             for j in np.flatnonzero(mask)}
                    assert pairs == jd, (knob, a)


def _close(got, want, what, scale=False, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    atol = atol + (RTOL * np.abs(want).max() if scale else 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_mesh_serving_matches_jax(runs, name):
    """Prefill (its logits and cache) and 4 decode steps against JAX's
    unsharded ``prefill`` / ``decode_step``, in both cache layouts; with
    ``seq_shard`` the prefill runs on each rank's chunk of the prompt and
    fills the cache decode reads (the whole sequence's K/V of its kv
    heads, or every head's K/V at its positions)."""
    job = SERVE[name]
    want = _jax_serving(job["arch"])
    got = runs[0][name]
    assert len(got["logits"]) == DECODE + 1
    for t, lg in enumerate(got["logits"]):
        _close(lg, want["logits"][t], f"{name} logits {t}",
               atol=LOGIT_ATOL.get(job["arch"], ATOL))
    for key in ("cache_prefill", "cache"):
        for leaf in ("k", "v", "pos_ids"):
            _close(got[key][leaf], want[key][leaf], f"{name} {key} {leaf}",
                   scale=True)
    for r in runs[1:]:
        for a, b in zip(r[name]["logits"], got["logits"]):
            np.testing.assert_array_equal(a, b)
    layers = 2
    for r in runs:
        assert r[name]["launches"] == [layers] + [0] * DECODE, name
    pre = {k: v["count"] for k, v in got["by_tag"][0].items()}
    if job["seq_shard"]:
        # the chunk gathered before each layer's projections, the whole
        # sequence's logits
        assert pre["sp_attn_in"] == layers and pre["sp_logits_in"] == 1, pre
    if job["arch"] == MIX:
        # the batch's rows gathered over data before routing: each
        # layer's in the prefill and in every decode step
        assert pre["moe_rows"] == layers, pre
        dec = {k: v["count"] for k, v in got["by_tag"][-1].items()}
        assert dec["moe_rows"] == layers and dec["tp_moe_out"] == layers, dec


def test_tensor_parallel_families():
    """Tensor parallelism takes every family (the guard that raised for
    the hybrid and ssm families is gone): the train, prefill and serve
    steps of each reduced arch build on ``meta`` at (data 2, model 2),
    and on a data-only mesh."""
    for mesh in (Mesh(("data", "model"), (2, 2), (0, 1)),
                 Mesh(("data", "model"), (4, 1), (1, 0))):
        for arch in ("smollm-135m", MIX, KIMI, "phi-3-vision-4.2b",
                     "whisper-medium", "zamba2-1.2b", "xlstm-350m"):
            cfg = reduced(get_config(arch))
            step = S.build_train_step(S.plan_run(cfg, InputShape(
                "t", 16, 4, "train"), mesh), compute_dtype="float32",
                device="meta", mesh=mesh)
            assert isinstance(step, S.MeshTrainStep), arch
            for build, kind in ((S.build_prefill_step, "prefill"),
                                (S.build_serve_step, "decode")):
                got, _, _ = build(S.plan_run(cfg, InputShape(
                    "d", 16, 4, kind), mesh), compute_dtype="float32",
                    device="meta", mesh=mesh)
                assert isinstance(got, S.MeshServeStep), (arch, kind)


def test_a_rank_block_owns_its_storage():
    """``NamedSharding.local`` copies the block, also where it is a
    contiguous slice (a leading dim: the experts, the vocabulary rows):
    a view kept the whole leaf's storage alive beside every rank's
    blocks (the moe job's first card run: the whole model and its whole
    EF zeros, 13.7 GB a rank)."""
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec

    x = torch.arange(8 * 3 * 2.0).reshape(8, 3, 2)
    for coords in ((0, 0), (0, 1)):
        mesh = Mesh(("data", "model"), (1, 2), coords)
        for spec in (PartitionSpec("model"), PartitionSpec(None, None,
                                                           "model")):
            block = NamedSharding(mesh, spec).local(x)
            assert block.is_contiguous()
            assert block.untyped_storage().nbytes() == block.nbytes
            assert block.untyped_storage().data_ptr() != (
                x.untyped_storage().data_ptr())
    assert NamedSharding(mesh, PartitionSpec()).local(x) is x
