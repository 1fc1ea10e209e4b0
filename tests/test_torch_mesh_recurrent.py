"""The hybrid (zamba2) and ssm (xlstm) families on the port's (data,
model) mesh of gloo ranks on the CPU, against the JAX package: tensor
parallelism for training and serving, with ``seq_shard``,
``inner_batch_shard`` and ``remat``, and serving on a data-only mesh.

One module fixture runs every rank program in one spawn of 4 ranks
(``tests/torch_mesh_ranks.py``, which imports no JAX); the test process
runs the JAX side on the same inputs (the JAX package's weights and
``lm_batch`` draws), and a JAX subprocess with 4 forced host devices,
started beside the spawn, runs JAX's own sharded step.  Reduced
zamba2-1.2b (2 Mamba2 layers of 8 heads, the shared attention block of
4/4 heads after each, d 256, vocab 512) and xlstm-350m (1 mLSTM/sLSTM
pair, 4 heads, d 256, vocab 512, its sLSTM MLP at ``slstm_proj_factor``
1.5 so that its 384 ``ff`` columns split at model 2 and 4), m = 2
agents × 2 rows × 16 tokens:

* (data 2, model 2), fsdp off and on: the Mamba2 layer on the rank's
  heads (its gated norm's sum of squares summed over "model" forward and
  backward), the mLSTM on the rank's heads (q, k, v reduce-scattered;
  the gate columns gathered), the sLSTM's recurrence whole on every rank
  (its weights gathered once a forward, each rank keeping its block of
  the gradient);
* ``seq_shard`` and ``inner_batch_shard``, one step with ``remat``, and
  one ``gain_quadratic`` step of each family (the HVP through the new
  collectives' ``jvp`` rules);
* (data 1, model 4), where the sLSTM's ``w_in`` gives each rank one gate
  type and the mLSTM's ``w_if`` each rank input or forget gates only;
* the ssm step's collective calls at 16 and 32 tokens: equal (no
  collective inside the sLSTM's loop over positions);
* serving: prefill (the prompt replayed through the rank's decode step)
  and 3 teacher-forced decode steps on (data 2, model 2), zamba2 in both
  cache layouts, and on the data-only (4, 1) mesh with fsdp off and on.

Tolerances.  Each family is held at its own single-process gap to JAX
(tests/test_torch_mesh_lm.py's ``FAMILIES``: zamba2 2.5e-4, xlstm 2.5e-5
of a leaf's largest value; tests/test_torch_hybrid.py and
tests/test_torch_xlstm.py measure them): the per-agent gradients per
leaf and agent within that of the agent's max|g|, the step's decisions,
metrics, EF memory, int8 tie band and update through ``check_job``'s
``family_gap``.  The gradients are also held to the port's own
single-process gradients on the same inputs within 1e-5 of the agent's
max|g| (the mesh's own gap: the norm-sum and gather-gradient traps move
a leaf by far more).  JAX's sharded step (fsdp off, Auto mesh) within
the family gap of the update plus ``rtol = 1e-5, atol = 1e-6``.
Serving: logits within ``atol = rtol`` 5e-5 (zamba2) and 1e-5 (xlstm),
tests/test_torch_hybrid.py's and tests/test_torch_xlstm.py's
``LOGIT_TOL``; every cache leaf within that of its largest value.
"""
import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

import test_torch_mesh_lm as lm
import test_torch_mesh_moe as moe
import torch_mesh_ranks as ranks
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import ssm as JSSM
from repro.models import xlstm as JXL
from repro_torch import convert
from repro_torch.comm.bank import batch_prologue
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import spawn
from repro_torch.models import build
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.utils.tree import tree_flatten_with_path

torch.set_num_threads(1)

Z, X = "zamba2-1.2b", "xlstm-350m"
# the sLSTM MLP's ff (int(256 · 1.5) = 384) splits at model 2 and 4;
# reduced xlstm's 341 would leave it whole
XCFG = {"xlstm": (("slstm_proj_factor", 1.5),)}
SEQ, INNER = {"seq_shard": True}, {"inner_batch_shard": True}
P2 = lm.P2
GAP = {Z: lm.FAMILIES[Z], X: lm.FAMILIES[X]}
RTOL, ATOL = lm.RTOL, lm.ATOL


def _job(arch, policy, fsdp, *, model=2, knobs=None, remat=False, seq=None,
         grads=False):
    return dict(lm._job(policy, fsdp, False, arch=arch,
                        cfg=XCFG if arch == X else {}, model=model, steps=1,
                        remat=remat, seq=seq or lm.SEQ),
                knobs=knobs or {}, family_gap=GAP[arch], grads=grads)


JOBS = {}
for _arch, _tag in ((Z, "zamba2"), (X, "xlstm")):
    JOBS.update({
        f"{_tag}_fsdp0": _job(_arch, P2, False, grads=True),
        f"{_tag}_fsdp1": _job(_arch, P2, True, grads=True),
        f"{_tag}_seq": _job(_arch, P2, False, knobs=SEQ, grads=True),
        f"{_tag}_inner": _job(_arch, P2, True, knobs=INNER, grads=True),
    })
JOBS["zamba2_remat"] = _job(Z, P2, False, remat=True)
# the HVP (jvp of the gradient) through every new collective's jvp rule
JOBS["zamba2_quadratic"] = _job(Z, lm.PQ, False)
JOBS["xlstm_quadratic"] = _job(X, lm.PQ, False)
JOBS["xlstm_model4"] = _job(X, P2, False, model=4, grads=True)
JOBS["xlstm_seq32"] = _job(X, P2, False, seq=32)

# serving: B 4 × 8 prompt tokens replayed into a cache of 16 slots (the
# shared attention block's), then 3 decode steps
B, PROMPT, CACHE, DECODE = 4, 8, 16, 3
SERVE = {
    "zamba2_dh": dict(arch=Z, fsdp=True, cache_seq_shard=False),
    "zamba2_cs": dict(arch=Z, fsdp=False, cache_seq_shard=True),
    "xlstm_tp": dict(arch=X, fsdp=False, cache_seq_shard=False),
    "zamba2_data_fsdp0": dict(arch=Z, fsdp=False, cache_seq_shard=False,
                              model=1),
    "zamba2_data_fsdp1": dict(arch=Z, fsdp=True, cache_seq_shard=False,
                              model=1),
    "xlstm_data_fsdp0": dict(arch=X, fsdp=False, cache_seq_shard=False,
                             model=1),
    "xlstm_data_fsdp1": dict(arch=X, fsdp=True, cache_seq_shard=False,
                             model=1),
}
LOGIT_TOL = {Z: 5e-5, X: 1e-5}


def _cfg_items(arch):
    return tuple(sorted((XCFG if arch == X else {}).items()))


@functools.lru_cache(maxsize=None)
def _tokens():
    k1, k2 = jax.random.split(jax.random.key(13))
    return (np.asarray(jax.random.randint(k1, (B, PROMPT), 0, 512),
                       np.int32),
            np.asarray(jax.random.randint(k2, (B, DECODE), 0, 512),
                       np.int32))


@functools.lru_cache(maxsize=None)
def _jax_serving(arch):
    """JAX's unsharded prefill (the replay) and DECODE decode steps."""
    jm, jp = lm._jax_model(arch, _cfg_items(arch))
    prompt, toks = _tokens()
    logits, cache = jm.prefill(jp, {"tokens": prompt}, cache_len=CACHE)
    out = {"logits": [np.asarray(logits)], "cache_prefill": _flat(cache)}
    step = jax.jit(jm.decode_step)
    for t in range(DECODE):
        logits, cache = step(jp, cache, toks[:, t:t + 1],
                             np.int32(PROMPT + t))
        out["logits"].append(np.asarray(logits))
    out["cache"] = _flat(cache)
    return out


def _flat(tree):
    """``{"a/b": numpy leaf}`` of a JAX cache, by the port's paths."""
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(x) for path, x in leaves}


def _rank_args():
    jobs = lm.rank_args(JOBS)
    prompt, toks = _tokens()
    for name, job in SERVE.items():
        _, jp = lm._jax_model(job["arch"], _cfg_items(job["arch"]))
        jobs[name] = ("serve_run", (dict(
            job, cfg=dict(_cfg_items(job["arch"])),
            params=convert.to_numpy(convert.params_from_jax(
                jp, device="cpu")),
            prompt=prompt, decode=toks, cache_len=CACHE),))
    return jobs


def _references(pool):
    """The references the tests read (each cached), one thread a chain:
    JAX's gradients and gains, the port's single-process gradients and
    JAX's serving."""
    def one(key):
        lm._jax_terms(key, 0)
        if any(j["grads"] for j in JOBS.values() if lm._key(j) == key):
            _port_grads(key)

    done = [pool.submit(one, k) for k in {lm._key(j) for j in JOBS.values()}]
    done += [pool.submit(_jax_serving, arch) for arch in (Z, X)]
    for f in done:
        f.result()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The spawn's results, and JAX's sharded step run beside it; the
    references are computed while the ranks run."""
    proc, npz = moe.start_jax_sharded((Z, X), tmp_path_factory.mktemp("jax"),
                                      subs={X: _cfg_items(X)}, policy=P2)
    try:
        # JAX compiles each chain on a thread of its own
        for arch in (Z, X):
            lm._jax_model(arch, _cfg_items(arch))
        keys = {lm._key(j) for j in JOBS.values()}
        with concurrent.futures.ThreadPoolExecutor(len(keys) + 2) as pool:
            list(pool.map(lm._jax_chain, keys))
            args = _rank_args()
            refs = pool.submit(_references, pool)
            results = spawn(ranks.run_jobs, 4, timeout_s=lm.TIMEOUT_S,
                            device="cpu", args=(args,))
            refs.result()
        jx = moe.finish_jax_sharded(proc, npz)
    finally:
        if proc.poll() is None:
            proc.kill()
    return results, jx


@pytest.fixture(scope="module")
def runs(both):
    return both[0]


@pytest.mark.parametrize("name", sorted(JOBS))
def test_recurrent_mesh_step_matches_jax(runs, name):
    """The step's decisions, metrics, EF memory and parameters against
    the JAX step from the same state (the family's gap)."""
    lm.check_job(runs, name, JOBS[name])


@functools.lru_cache(maxsize=None)
def _port_grads(key):
    """The port's single-process per-agent gradients at the JAX chain's
    first state and batch."""
    arch, cfg_items, _, _, _ = key
    batches, states, _ = lm._jax_chain(key)
    model = build(ranks.config(arch, cfg_items).replace(
        compute_dtype="float32"))
    params = convert.params_from_jax(states[0].params, device="cpu")
    _, grads = batch_prologue(model.loss_fn)(
        params, convert.to_torch(jax.device_get(batches[0]), "cpu"))
    return {"/".join(map(str, p)): g.detach().numpy()
            for p, g in tree_flatten_with_path(grads)}


@pytest.mark.parametrize("name", sorted(n for n, j in JOBS.items()
                                        if j["grads"]))
def test_per_agent_gradients_match_jax_and_one_process(runs, name):
    """Every agent's gradient computed on the mesh (each rank its blocks
    of its agents') against JAX's ``value_and_grad`` within the family's
    gap of the agent's max|g| per leaf, and against the port's
    single-process gradients within 1e-5 of it: a norm sum whose
    backward skips the other ranks' columns, or a gathered weight whose
    gradient is summed over ranks that computed the same thing, moves a
    leaf by far more."""
    job = JOBS[name]
    got = runs[0][name]["steps"][0]["grads"]
    want = lm._jax_terms(lm._key(job), 0)[0]   # g + ef, ef = 0 at start
    mine = _port_grads(lm._key(job))
    assert got.keys() == want.keys() == mine.keys()
    for path, w in want.items():
        dims = tuple(range(1, w.ndim))
        scale = np.abs(w).max(axis=dims, keepdims=True)
        for ref, tol, what in ((w, GAP[job["arch"]], "JAX"),
                               (mine[path], RTOL, "one process")):
            bad = np.abs(got[path] - ref) > ATOL + tol * scale
            assert not bad.any(), (
                f"{name} {path} vs {what}: "
                f"{float((np.abs(got[path] - ref) / scale).max()):.3e}")


def test_jax_sharded_step_agrees(both):
    """JAX's own sharded ``build_train_step`` (fsdp off,
    ``gain_lookahead(lam=0.01)|int8+ef``, an Auto (data 2, model 2)
    mesh) and the port's mesh step (``*_fsdp1``: the same policy; fsdp
    changes nothing of the step) from the same weights and batch: the
    decisions equal, the parameters within the family's gap of each
    leaf's update plus ``rtol = 1e-5, atol = 1e-6``, an element whose
    agent's ``g`` lies within that gap of an int8 rounding boundary one
    level apart at most (``check_job``'s exemption)."""
    results, (num_tx, arrays) = both
    for arch, job in ((Z, "zamba2_fsdp1"), (X, "xlstm_fsdp1")):
        got = results[0][job]["steps"][0]
        assert float(got["metrics"]["num_tx"]) == num_tx[arch]
        key = lm._key(JOBS[job])
        before = lm._flat(lm._jax_chain(key)[1][0].params)
        g_eff = lm._jax_terms(key, 0)[0]
        sent = got["metrics"]["agent_tx"] > 0
        for path, v in got["params"].items():
            w = arrays[f"{arch}/{path}"]
            step = np.abs(w - before[path]).max()
            bad = np.abs(v - w) > ATOL + GAP[arch] * step + RTOL * np.abs(w)
            bad &= ~(lm._int8_ties(g_eff[path], GAP[arch]) & sent.reshape(
                (-1,) + (1,) * w.ndim)).any(0)
            assert not bad.any(), f"{arch} {path}"


def _tags(runs, name):
    return {k: v["count"]
            for k, v in runs[0][name]["steps"][0]["by_tag"].items()}


def test_ssm_collectives_do_not_grow_with_the_sequence(runs):
    """The ssm step at 16 and at 32 tokens issues the same collectives,
    tag by tag: the sLSTM's weights are gathered once a forward, and
    nothing runs inside its loop over positions."""
    assert _tags(runs, "xlstm_fsdp0") == _tags(runs, "xlstm_seq32")


def test_recurrent_collectives(runs):
    """Per forward (the loss's and the probe's) and layer: the Mamba2
    layer's norm sum and row-parallel output, its B/C and input
    cotangents summed once in the backward, the norm sum's backward
    once; the mLSTM's q/k/v reduce-scatter, gate gather, norm sum and
    output, the sLSTM's one weight gather.  Under ``seq_shard`` the
    same with the chunk gathered at each recurrence's entry; under
    ``inner_batch_shard`` no tensor-parallel collective; ``remat``
    repeats the checkpointed Mamba2 layers' forward collectives."""
    layers, fwd = 2, 2
    tags = _tags(runs, "zamba2_fsdp0")
    for tag in ("tp_mamba_norm", "tp_mamba_out"):
        assert tags[tag] == fwd * layers, (tag, tags)
    for tag in ("tp_mamba_bc", "tp_mamba_in", "tp_mamba_norm_grad"):
        assert tags[tag] == layers, (tag, tags)
    remat = _tags(runs, "zamba2_remat")
    for tag in ("tp_mamba_norm", "tp_mamba_out"):
        assert remat[tag] == tags[tag] + layers, (tag, remat)
    tags = _tags(runs, "xlstm_fsdp0")
    for tag in ("tp_mlstm_qkv", "tp_mlstm_gates", "tp_mlstm_norm",
                "tp_mlstm_out", "tp_slstm_weights", "tp_mlp_out"):
        assert tags[tag] == fwd, (tag, tags)
    for tag in ("tp_mlstm_in", "tp_mlstm_qkv_grad", "tp_mlstm_gates_grad",
                "tp_mlstm_norm_grad", "tp_mlp_in"):
        assert tags[tag] == 1, (tag, tags)
    # the sLSTM keeps its block of the weights' gradient: no sum
    assert "tp_slstm_weights_grad" not in tags, tags
    seq = _tags(runs, "xlstm_seq")
    assert seq["sp_slstm_in"] == fwd and seq["sp_slstm_weights"] == fwd
    assert seq["sp_slstm_weights_grad"] == 1, seq
    assert not [t for t in seq if t.startswith("tp_")], seq
    for name in ("zamba2_inner", "xlstm_inner"):
        tags = _tags(runs, name)
        assert not [t for t in tags if t.startswith(("tp_", "sp_"))], tags
        assert tags["rows_gather"] > 0, tags


def test_launches_per_rank_equal_the_single_process_step(runs):
    """Each rank launches the kernels' plain versions as the
    single-process step does: zamba2 2 × its 2 attention sites, xlstm no
    attention; 2 losses."""
    for name, job in JOBS.items():
        # remat recomputes no attention: the shared block is not
        # checkpointed
        swa = 2 * 2 if job["arch"] == Z else 0
        for r in runs:
            for s in r[name]["steps"]:
                assert s["launches"] == (swa, 2), (name, s["launches"])


def _close(got, want, what, tol):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=ATOL + tol * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_mesh_serving_matches_jax(runs, name):
    """The replayed prefill's last logits and cache, then each decode
    step's logits and the final cache, against JAX's unsharded
    ``prefill`` / ``decode_step``; the ranks agree; no kernel launches
    (the replay and decode run no causal attention kernel)."""
    job = SERVE[name]
    want = _jax_serving(job["arch"])
    tol = LOGIT_TOL[job["arch"]]
    got = runs[0][name]
    assert len(got["logits"]) == DECODE + 1
    for t, lg in enumerate(got["logits"]):
        _close(lg, want["logits"][t], f"{name} logits {t}", tol)
    for key in ("cache_prefill", "cache"):
        assert got[key].keys() == want[key].keys()
        for leaf, w in want[key].items():
            _close(got[key][leaf], w, f"{name} {key} {leaf}", tol)
    for r in runs[1:]:
        for a, b in zip(r[name]["logits"], got["logits"]):
            np.testing.assert_array_equal(a, b)
    for r in runs:
        assert r[name]["launches"] == [0] * (DECODE + 1), name


def test_serving_cache_blocks(runs):
    """Each rank's cache block on (data 2, model 2): the Mamba2 states
    on the rank's heads and ``ff`` columns, the shared block's KV cache
    on its kv heads (``decode_heads``) or positions (``cache_seq_shard``),
    the mLSTM's states on its heads, the sLSTM's whole; on the data-only
    mesh every state whole over its rows."""
    cfg = reduced(get_config(Z))
    inner = cfg.ssm.expand * cfg.d_model
    rows = B // 2
    dh = runs[0]["zamba2_dh"]["block"]
    assert dh["mamba/ssm"].shape == (2, rows, 4, 32, 64)
    assert dh["mamba/conv"].shape == (2, rows, 3, inner // 2)
    assert dh["attn/k"].shape == (2, rows, CACHE, 2, 64)
    cs = runs[0]["zamba2_cs"]["block"]
    assert cs["attn/k"].shape == (2, rows, CACHE // 2, 4, 64)
    assert cs["attn/pos_ids"].shape == (2, CACHE // 2)
    xl = runs[0]["xlstm_tp"]["block"]
    assert xl["mlstm/C"].shape == (1, rows, 2, 128, 128)
    assert xl["slstm/h"].shape == (1, rows, 256)
    data = runs[0]["zamba2_data_fsdp1"]["block"]
    assert data["mamba/ssm"].shape == (2, 1, 8, 32, 64)


def test_abstract_states_match_jax():
    """``abstract_mamba_state`` and ``abstract_slstm_state``: ``meta``
    stand-ins of JAX's shapes and dtypes."""
    for arch in (Z, X):
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget(arch))
        for dtype, jdt in ((torch.float32, "float32"),
                           (torch.bfloat16, "bfloat16")):
            if arch == Z:
                got = SSM.abstract_mamba_state(cfg, 3, dtype)
                want = JSSM.abstract_mamba_state(jcfg, 3, jdt)
            else:
                got = XL.abstract_slstm_state(cfg, 3, dtype)
                want = JXL.abstract_slstm_state(jcfg, 3, jdt)
            assert type(got)._fields == type(want)._fields
            for g, w in zip(got, want):
                assert g.device.type == "meta"
                assert tuple(g.shape) == tuple(w.shape)
                assert str(g.dtype).split(".")[1] == str(w.dtype)
