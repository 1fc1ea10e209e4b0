"""The port's prefill and decode over a (data, model) mesh of gloo ranks
on the CPU (``repro_torch.launch.steps.build_prefill_step(mesh=...,
cache_len=...)`` and ``build_serve_step(mesh=...)``), against the JAX
package's sharded and unsharded serving.

One module fixture runs every job in one spawn of 4 ranks
(``tests/torch_mesh_ranks.py``, which imports no JAX) beside a JAX
subprocess with 4 forced host devices.  Reduced smollm-135m (2 layers,
d 256, vocab 512) on (data 2, model 2): B 4 × 16 prompt tokens into a
cache of 32 slots, then 4 decode steps teacher-forced on drawn tokens,
under both decode layouts (``decode_heads``: the cache split over its kv
heads; ``cache_seq_shard``: over its positions, flash-decoding), fsdp
off and on, for the configurations

* 4/2 heads (every head and kv head split);
* 4/1 heads (kv whole, query heads split);
* 3/1 heads (attention replicated: model 2 divides neither);
* a vocabulary of 511 (the table and the logits whole);
* ``swa_window`` 8, smaller than the prompt (the ring buffer of 8 slots
  split over positions under ``cache_seq_shard``, and the reference's
  ring-buffer defect mirrored: ROADMAP §3).

Held: the prefill's logits, each decode step's logits, the cache after
the prefill and after the last step, to JAX's unsharded ``prefill`` /
``decode_step`` and to its sharded ones on an ``AxisType.Auto`` mesh
(``_install_gather_hook(..., train=False)``, then ``jit`` with the
plan's parameter and cache shardings); each rank's cache block to JAX's
addressable shard at the same (data, model) coordinates.  Logits within
``rtol = 1e-5, atol = 1e-6``; the cache within ``rtol = 1e-5`` of its
largest value (a cached key carries RoPE's rounding, which
tests/test_torch_lm.py holds at 5e-5); positions exact.
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

import torch_mesh_ranks as ranks
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import build as jbuild
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.sharding import constraint as K
from repro_torch.sharding.rules import resolve_rules

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
B, PROMPT, CACHE, DECODE = 4, 16, 32, 4
TIMEOUT_S = 420
CONFIGS = {"kv2": {}, "kv1": {"num_kv_heads": 1},
           "h3": {"num_heads": 3, "num_kv_heads": 1},
           "v511": {"vocab_size": 511}, "swa8": {"swa_window": 8}}
JOBS = {f"{c}_{'cs' if cs else 'dh'}_fsdp{int(f)}":
        dict(config=c, cfg=CONFIGS[c], fsdp=f, cache_seq_shard=cs)
        for c in CONFIGS for cs in (False, True) for f in (False, True)}


@functools.lru_cache(maxsize=None)
def _jax_model(config):
    jm = jbuild(jreduced(jget("smollm-135m")).replace(**CONFIGS[config]))
    return jm, jax.device_get(jm.init(jax.random.key(0))[0])


@functools.lru_cache(maxsize=None)
def _tokens():
    """The prompt and the teacher-forced tokens (below every config's
    vocabulary)."""
    k1, k2 = jax.random.split(jax.random.key(7))
    return (np.asarray(jax.random.randint(k1, (B, PROMPT), 0, 511),
                       np.int32),
            np.asarray(jax.random.randint(k2, (B, DECODE), 0, 511),
                       np.int32))


@functools.lru_cache(maxsize=None)
def _jax_unsharded(config):
    """JAX's prefill then DECODE decode steps: the logits of each and the
    cache after the prefill and after the last step (numpy)."""
    jm, jp = _jax_model(config)
    prompt, toks = _tokens()
    logits, cache = jm.prefill(jp, {"tokens": prompt}, cache_len=CACHE)
    out = {"logits": [np.asarray(logits)],
           "cache_prefill": _np_cache(cache)}
    step = jax.jit(jm.decode_step)
    for t in range(DECODE):
        logits, cache = step(jp, cache, toks[:, t:t + 1],
                             np.int32(PROMPT + t))
        out["logits"].append(np.asarray(logits))
    out["cache"] = _np_cache(cache)
    return out


def _np_cache(cache):
    return {name: np.asarray(getattr(cache, name))
            for name in ("k", "v", "pos_ids")}


def rank_args():
    prompt, toks = _tokens()
    out = {}
    for name, job in JOBS.items():
        _, jp = _jax_model(job["config"])
        out[name] = ("serve_run", (dict(
            job, params=convert.to_numpy(convert.params_from_jax(
                jp, device="cpu")),
            prompt=prompt, decode=toks, cache_len=CACHE),))
    return out


JAX_MESH_SCRIPT = r"""
import json, os, sys, traceback
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
sys.path.insert(0, {src!r})
from repro.configs import get_config, reduced
from repro.configs.base import InputShape
from repro.launch import steps as S
from repro.launch.mesh import make_host_mesh
from repro.models import build
from repro.models import decode as DEC
from repro.sharding.rules import tree_pspecs

configs, jobs = {configs!r}, {jobs!r}
with np.load({tokens!r}) as f:
    prompt, toks = f["prompt"], f["decode"]
auto = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
coords = {{d.id: "".join(str(int(i)) for i in np.argwhere(auto.devices == d)[0])
          for d in auto.devices.flat}}
out, arrays = {{"facts": {{}}}}, {{}}


def ns(tree):
    return jax.tree_util.tree_map(
        lambda s: NamedSharding(auto, s), tree,
        is_leaf=lambda x: isinstance(x, P))


def record(prefix, cache):
    for leaf in ("k", "v", "pos_ids"):
        x = getattr(cache, leaf)
        arrays[f"{{prefix}}/{{leaf}}"] = np.asarray(x)
        for shard in x.addressable_shards:
            arrays[f"{{prefix}}/{{leaf}}@{{coords[shard.device.id]}}"] = (
                np.asarray(shard.data))


for name, job in jobs.items():
    cfg = reduced(get_config("smollm-135m")).replace(**configs[job["config"]])
    model = build(cfg)
    params = model.init(jax.random.key(0))[0]
    abstract, axes = model.init(abstract=True)
    knobs = dict(fsdp=job["fsdp"], cache_seq_shard=job["cache_seq_shard"])
    plan = S.plan_run(cfg, InputShape("serve", {prompt_len}, {b}, "prefill"),
                      auto, **knobs)
    S._install_gather_hook(auto, plan, axes, train=False)
    pspecs = tree_pspecs(axes, abstract, plan.rules, auto)
    cache_abs, cache_axes = DEC.init_cache(cfg, {b}, {cache}, abstract=True)
    cspecs = tree_pspecs(cache_axes, cache_abs, plan.rules, auto)
    prefill = jax.jit(lambda p, t: DEC.prefill(cfg, p, {{"tokens": t}},
                                               {cache}),
                      in_shardings=(ns(pspecs), ns(P("data"))),
                      out_shardings=(None, ns(cspecs)))
    decode = jax.jit(lambda p, c, t, pos: DEC.decode_step(cfg, p, c, t, pos),
                     in_shardings=(ns(pspecs), ns(cspecs), ns(P("data")),
                                   ns(P())),
                     out_shardings=(None, ns(cspecs)))
    logits, cache = prefill(params, prompt)
    arrays[f"{{name}}/logits/0"] = np.asarray(logits)
    record(f"{{name}}/cache_prefill", cache)
    for t in range({decode}):
        logits, cache = decode(params, cache, toks[:, t:t + 1],
                               np.int32({prompt_len} + t))
        arrays[f"{{name}}/logits/{{t + 1}}"] = np.asarray(logits)
    record(f"{{name}}/cache", cache)

# the reference fault: a decode shape lowered on make_host_mesh's
# Explicit mesh, where the prefill shape lowers
cfg = reduced(get_config("smollm-135m"))
explicit = make_host_mesh(model=2)
for label, kind in (("prefill_explicit", "prefill"),
                    ("decode_explicit", "decode")):
    plan = S.plan_run(cfg, InputShape("serve", {cache}, {b}, kind), explicit)
    try:
        S.lower_for(explicit, plan, compute_dtype="float32")
        out["facts"][label] = "ran"
    except Exception as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith({src!r})]
        where = (f"{{os.path.relpath(frames[-1].filename, {root!r})}}:"
                 f"{{frames[-1].lineno}}" if frames else "?")
        out["facts"][label] = f"{{type(e).__name__}}: {{e}} @ {{where}}"
np.savez({npz!r}, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's results and the JAX subprocess's, run side by side."""
    tmp = tmp_path_factory.mktemp("jax_mesh_serve")
    prompt, toks = _tokens()
    np.savez(tmp / "tokens.npz", prompt=prompt, decode=toks)
    npz = tmp / "sharded.npz"
    code = JAX_MESH_SCRIPT.format(
        src=str(ROOT / "src"), root=str(ROOT), configs=CONFIGS,
        jobs={k: {x: v[x] for x in ("config", "fsdp", "cache_seq_shard")}
              for k, v in JOBS.items()},
        tokens=str(tmp / "tokens.npz"), prompt_len=PROMPT, b=B,
        cache=CACHE, decode=DECODE, npz=str(npz))
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


def _close(got, want, what, scale=False):
    """Integers exact; floats within the contract, or with ``scale``
    within RTOL of the tensor's largest value (a cached key carries
    RoPE's sin and cos, which the packages round apart)."""
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    atol = ATOL + (RTOL * np.abs(want).max() if scale else 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_serving_matches_jax(runs, name):
    """Logits and caches, gathered on every rank, against JAX's unsharded
    and sharded serving; every rank's gathered results are the same."""
    results, jx = runs
    arr = jx["arrays"]
    want = _jax_unsharded(JOBS[name]["config"])
    got = results[0][name]
    assert len(got["logits"]) == DECODE + 1
    for t, lg in enumerate(got["logits"]):
        _close(lg, want["logits"][t], f"{name} logits {t} vs unsharded")
        _close(lg, arr[f"{name}/logits/{t}"], f"{name} logits {t} vs sharded")
    for key in ("cache_prefill", "cache"):
        for leaf in ("k", "v", "pos_ids"):
            g = got[key][leaf]
            _close(g, want[key][leaf], f"{name} {key} {leaf} vs unsharded",
                   scale=True)
            _close(g, arr[f"{name}/{key}/{leaf}"],
                   f"{name} {key} {leaf} vs sharded", scale=True)
    for r in results[1:]:
        for a, b in zip(r[name]["logits"], got["logits"]):
            np.testing.assert_array_equal(a, b)


def test_rank_cache_blocks_are_jax_addressable_shards(runs):
    """Each rank's cache block (after the prefill and after the last
    decode step) is JAX's addressable shard on the device at the same
    (data, model) coordinates: its rows of the batch, and its kv heads
    (``decode_heads``) or its slice of the positions
    (``cache_seq_shard``)."""
    results, jx = runs
    arr = jx["arrays"]
    for name, job in JOBS.items():
        for r in results:
            c = "".join(str(x) for x in r[name]["coords"])
            for key, block in (("cache_prefill", "block_prefill"),
                               ("cache", "block")):
                for leaf in ("k", "v", "pos_ids"):
                    shard = arr[f"{name}/{key}/{leaf}@{c}"]
                    mine = r[name][block][leaf]
                    assert mine.shape == shard.shape, (name, key, leaf, c)
                    _close(mine, shard, f"{name} {key} {leaf} at {c}",
                           scale=True)
        # the layouts: positions split under cache_seq_shard, kv heads
        # under decode_heads where model 2 divides them
        blk = results[0][name]["block"]["k"]
        kv = reduced(get_config("smollm-135m")).replace(
            **job["cfg"]).num_kv_heads
        slots = min(CACHE, job["cfg"].get("swa_window") or CACHE)
        if job["cache_seq_shard"]:
            assert blk.shape[2:4] == (slots // 2, kv), (name, blk.shape)
        else:
            assert blk.shape[2:4] == (slots, kv // 2 if kv % 2 == 0
                                      else kv), (name, blk.shape)


def test_collectives_and_launches_per_step(runs):
    """The collectives of a prefill and of a decode step (2 layers, 4/2
    heads, model 2), counted from the code, and the kernel launches:
    one ``swa_attention`` per layer in a prefill, none in a decode.

    Per layer the row-parallel attention and MLP outputs reduce over
    "model"; the embedding and the logits once a step.  Flash-decoding
    adds per layer the gathers of q, k_new and v_new, the scores' max
    and the sum beside the weighted values; its prefill gathers each
    layer's kv heads for the cache (k and v).  With fsdp every block
    used is gathered over data at its use."""
    results, _ = runs
    layers = 2
    for name, job in JOBS.items():
        if job["config"] != "kv2":
            continue
        r = results[0][name]
        pre = {k: v["count"] for k, v in r["by_tag"][0].items()}
        dec = {k: v["count"] for k, v in r["by_tag"][-1].items()}
        base = {"tp_embed": 1, "tp_attn_out": layers, "tp_mlp_out": layers,
                "tp_logits": 1}
        want_pre, want_dec = dict(base), dict(base)
        if job["cache_seq_shard"]:
            want_pre["act_gather"] = 2 * layers
            want_dec.update(act_gather=3 * layers, decode_max=layers,
                            decode_sum=layers)
        if job["fsdp"]:
            # the tied table twice (lookup and output), final_norm, and
            # each layer's 9 leaves
            gathers = 2 + 1 + 9 * layers
            want_pre["fsdp_gather"] = want_dec["fsdp_gather"] = gathers
        assert pre == want_pre, (name, pre)
        assert dec == want_dec, (name, dec)
        for x in results:
            assert x[name]["launches"] == [layers] + [0] * DECODE, (
                name, x[name]["launches"])


def test_jax_decode_on_the_explicit_mesh_is_pinned(runs):
    """A reference fault (ROADMAP §3): on ``make_host_mesh``'s Explicit
    mesh JAX lowers the prefill shape, and the decode shape raises in
    ``with_sharding_constraint`` inside the activation hook
    (``src/repro/sharding/constraint.py``), which is why the sharded
    oracle above runs on an ``AxisType.Auto`` mesh.  A JAX that mends it
    changes this fact."""
    facts = runs[1]["facts"]
    assert facts["prefill_explicit"] == "ran", facts
    fact = facts["decode_explicit"]
    assert "src/repro/sharding/constraint.py:" in fact, fact


def test_plan_and_one_rank_mesh():
    """``plan_run(cache_seq_shard=True)`` moves the cache's positions onto
    "model" and takes it from ``decode_heads``; a mesh of one rank keeps
    the one-card steps; a model axis takes the hybrid family too: its
    ``MeshServeStep`` builds on ``meta``, the cache laid out by its
    logical axes and the shared block's slots its cache length."""
    cfg = reduced(get_config("smollm-135m"))
    mesh = Mesh(("data", "model"), (2, 2))
    plan = S.plan_run(cfg, InputShape("d", CACHE, B, "decode"), mesh,
                      cache_seq_shard=True)
    assert plan.rules["cache_seq"] == "model"
    assert plan.rules["decode_heads"] is None
    assert plan.rules == resolve_rules(mesh, cache_seq_shard=True)
    one = Mesh(("data", "model"), (1, 1))
    hybrid = reduced(get_config("zamba2-1.2b"))
    for build in (S.build_prefill_step, S.build_serve_step):
        kind = "prefill" if build is S.build_prefill_step else "decode"
        step, params, _ = build(S.plan_run(cfg, InputShape(
            "d", CACHE, B, kind)), compute_dtype="float32", device="meta",
            mesh=one)
        assert not isinstance(step, S.MeshServeStep)
        kw = {"cache_len": CACHE} if kind == "prefill" else {}
        step, params, _ = build(S.plan_run(hybrid, InputShape(
            "d", CACHE, B, kind), mesh), compute_dtype="float32",
            device="meta", mesh=mesh, **kw)
        assert isinstance(step, S.MeshServeStep)
        assert step._act.positions(CACHE) == (0, CACHE)
        cache = step.cache_shardings["attn"].k
        assert tuple(cache.spec) == (None, "data", None, "model"), cache
        assert params["blocks"]["mamba"]["wz"].shape[-1] == (
            hybrid.ssm.expand * hybrid.d_model // 2)


def test_act_hook_layouts_on_one_rank():
    """The activation hook on the rank at model coordinate 1 of a
    (data 2, model 2) descriptor: a whole dim that the layout splits is
    sliced to the rank's block, a block it splits kept; a tensor that is
    neither raises; the cache's positions split only where the rules put
    ``cache_seq`` on "model" and model 2 divides them."""
    mesh = Mesh(("data", "model"), (2, 2), (0, 1))
    hook = K.make_act_hook(mesh, resolve_rules(mesh, cache_seq_shard=True),
                           cache_len=8)
    x = torch.arange(2 * 8 * 2 * 3.0).reshape(2, 8, 2, 3)
    axes = ("batch", "cache_seq", "kv_heads", None)
    got = hook(x, axes, (2, 8, 2, 3))
    assert torch.equal(got, x[:, 4:])
    assert torch.equal(hook(got, axes, (2, 8, 2, 3)), got)
    with pytest.raises(ValueError, match="activation hook"):
        hook(x[:, :3], axes, (2, 8, 2, 3))
    assert hook.positions(4) == (4, 8)
    plain = K.make_act_hook(mesh, resolve_rules(mesh), cache_len=8)
    assert plain.positions(8) == (0, 8)
    assert torch.equal(plain(x, axes, (2, 8, 2, 3)), x[:, :, 1:])
    odd = K.make_act_hook(mesh, resolve_rules(mesh, cache_seq_shard=True),
                          cache_len=7)
    assert odd.positions(7) == (0, 7)
    token = K.set_act_hook(hook)
    try:
        assert K.cache_positions(4) == (4, 8)
    finally:
        K.reset_act_hook(token)
    assert K.cache_positions(4) == (0, 4)
