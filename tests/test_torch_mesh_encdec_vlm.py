"""The audio (whisper-medium) and vlm (phi-3-vision) families on the
port's (data, model) mesh of gloo ranks on the CPU, against the JAX
package's unsharded steps.

One module fixture runs every rank program in one spawn of 4 ranks
(``tests/torch_mesh_ranks.py``, which imports no JAX); the test process
runs the JAX side on the same inputs.  Reduced whisper (2 + 2 layers,
d 256, 4 heads, GELU ``d_ff`` 512, vocab 512, 16 frames and 16 decoder
tokens) and reduced phi-3-vision (2 layers, d 256, 16 patches before 16
tokens) at (data 2, model 2), m = 2 agents × 2 rows:

* whisper: the encoder's and the decoder's self-attention and the
  cross-attention on the rank's heads (the encoder output made ready for
  the cross-attention once a forward), the GELU MLP column-parallel in
  and row-parallel out with ``b_out`` added once after the sum; the
  tied table of 512 rows split over the vocabulary;
* phi-3-vision: the dense block, the patch projection whole on every
  rank (its gradient not summed twice);
* each with fsdp off and on, ``seq_shard`` (whisper: the encoder on
  each rank's chunk of the frames, gathered whole once for the
  cross-attention; phi-3: the chunks of the P + S sequence of patches
  and tokens, the prefix cropped from the whole hidden) and
  ``inner_batch_shard``; ``seq_shard`` where the model axis does not
  divide the whole sequence (whisper's 449 frames, phi-3's 15 + 16
  positions) a no-op;
* prefill and 4 decode steps: phi-3's text prefill in both cache
  layouts; whisper's encode (its cross K/V in the cache layout) and 4
  decoder tokens in both layouts (flash-decoding splits the frames
  and the self-attention slots), and its encode under ``seq_shard`` (the
  encoder on the frame chunks).

The train jobs are held under tests/test_torch_mesh_lm.py's contract
(``check_job``; on a model axis of 2 the harness grants whisper no
family allowance), and one ``gain_lookahead`` step of each family with
fsdp off also to JAX's own sharded ``build_train_step`` on an
``AxisType.Auto`` mesh of 4 forced host devices (a subprocess beside
the spawn), within ``rtol = 1e-5, atol = 1e-6``.  Serving: logits within ``atol =
rtol = 1e-5`` (tests/test_torch_lm.py's ``LOGIT_TOL``), the cache within
``rtol = 1e-5`` of its largest value, positions exact.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import test_torch_mesh_lm as lm
import test_torch_mesh_moe as moe
import torch_mesh_ranks as ranks
from repro_torch import convert
from repro_torch.launch.mesh import spawn

torch.set_num_threads(1)

P1, P2 = lm.P1, lm.P2
WHISPER, VLM = "whisper-medium", "phi-3-vision-4.2b"
SEQ = {"seq_shard": True}
INNER = {"inner_batch_shard": True}
RTOL, ATOL = 1e-5, 1e-6
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT_S = 420


def _job(arch, policy, fsdp, knobs=None, fleet=False, cfg=None,
         seq=lm.SEQ):
    return dict(lm._job(policy, fsdp, fleet, arch=arch, cfg=cfg, steps=1,
                        seq=seq), knobs=knobs or {})


JOBS = {}
for _arch, _tag in ((WHISPER, "whisper"), (VLM, "vlm")):
    JOBS.update({
        f"{_tag}_lookahead": _job(_arch, P1, False),
        f"{_tag}_fsdp0": _job(_arch, P2, False),
        f"{_tag}_fsdp1": _job(_arch, P1, True),
        f"{_tag}_seq": _job(_arch, P2, False, SEQ),
        f"{_tag}_seq_fsdp1": _job(_arch, P1, True, SEQ, fleet=True),
        f"{_tag}_inner": _job(_arch, P1, False, INNER),
    })
# seq_shard where the model axis does not divide the whole sequence: a
# no-op (every sequence whole on the model ranks), as JAX's guard makes
# it.  Whisper at 449 frames (its 448 decoder tokens divide, the frames
# do not); phi-3 with 15 patches before its 16 tokens (31 positions).
UNDIVIDED = {"whisper_seq_449": _job(WHISPER, P1, False, SEQ, seq=449),
             "vlm_seq_p15": _job(VLM, P1, False, SEQ,
                                 cfg={"num_patches": 15})}
JOBS.update(UNDIVIDED)

B, PROMPT, CACHE, DECODE = 4, 16, 32, 4
FRAMES = 16
SERVE = {
    "vlm_dh": dict(arch=VLM, fsdp=True, cache_seq_shard=False),
    "vlm_cs": dict(arch=VLM, fsdp=False, cache_seq_shard=True),
    "whisper_dh": dict(arch=WHISPER, fsdp=True, cache_seq_shard=False),
    "whisper_cs": dict(arch=WHISPER, fsdp=False, cache_seq_shard=True),
    "whisper_seq_dh": dict(arch=WHISPER, fsdp=False, cache_seq_shard=False,
                           seq_shard=True),
}


@functools.lru_cache(maxsize=None)
def _inputs():
    """The text prompt, phi-3's teacher-forced tokens and whisper's frames
    (0.02 · N(0, 1), as tests/test_torch_whisper.py draws them)."""
    k1, k2 = jax.random.split(jax.random.key(13))
    frames = (0.02 * np.random.default_rng(11).standard_normal(
        (B, FRAMES, 256))).astype(np.float32)
    return (np.asarray(jax.random.randint(k1, (B, PROMPT), 0, 512),
                       np.int32),
            np.asarray(jax.random.randint(k2, (B, DECODE), 0, 512),
                       np.int32), frames)


def _serve_setup(arch):
    """(prompt, cache_len, first decode position) of an arch's job."""
    prompt, _, frames = _inputs()
    if arch == WHISPER:
        return frames, FRAMES, 0
    return prompt, CACHE, PROMPT


def _flat(tree):
    return {k: np.asarray(v) for k, v in lm._flat(tree).items()}


@functools.lru_cache(maxsize=None)
def _jax_serving(arch):
    """JAX's unsharded prefill (whisper: the encode, no logits) and
    DECODE decode steps."""
    jm, jp = lm._jax_model(arch, ())
    prompt, cache_len, pos0 = _serve_setup(arch)
    toks = _inputs()[1]
    key = "frame_embeds" if arch == WHISPER else "tokens"
    logits, cache = jm.prefill(jp, {key: prompt}, cache_len=cache_len)
    out = {"logits": [] if logits is None else [np.asarray(logits)],
           "cache_prefill": _flat(cache)}
    step = jax.jit(jm.decode_step)
    for t in range(DECODE):
        logits, cache = step(jp, cache, toks[:, t:t + 1], np.int32(pos0 + t))
        out["logits"].append(np.asarray(logits))
    out["cache"] = _flat(cache)
    return out


def _rank_args():
    jobs = lm.rank_args(JOBS)
    toks = _inputs()[1]
    for name, job in SERVE.items():
        _, jp = lm._jax_model(job["arch"], ())
        prompt, cache_len, pos0 = _serve_setup(job["arch"])
        jobs[name] = ("serve_run", (dict(
            job, cfg={}, params=convert.to_numpy(convert.params_from_jax(
                jp, device="cpu")),
            prompt=prompt, decode=toks, cache_len=cache_len, pos0=pos0),))
    return jobs


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The spawn's results, and JAX's sharded steps run beside it."""
    proc, npz = moe.start_jax_sharded((WHISPER, VLM),
                                      tmp_path_factory.mktemp("jax"))
    try:
        results = spawn(ranks.run_jobs, 4, timeout_s=TIMEOUT_S,
                        device="cpu", args=(_rank_args(),))
        jx = moe.finish_jax_sharded(proc, npz)
    finally:
        if proc.poll() is None:
            proc.kill()
    return results, jx


@pytest.fixture(scope="module")
def runs(both):
    return both[0]


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_step_matches_jax(runs, name):
    lm.check_job(runs, name, JOBS[name])


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_step_matches_jax_sharded_step(both, arch):
    """JAX's own sharded step (an Auto mesh, fsdp off) and the port's
    mesh step from the same weights and batch."""
    tag = "whisper" if arch == WHISPER else "vlm"
    moe.hold_to_jax_sharded(*both, arch, f"{tag}_lookahead")


def test_launches_per_rank_equal_the_single_process_step(runs):
    """Each rank launches the kernels' plain versions as the
    single-process step does: the decoder's causal self-attention once a
    layer in the loss's and the probe's forward (whisper's encoder and
    cross-attention are not causal: no kernel), the loss twice."""
    for name in JOBS:
        for r in runs:
            assert r[name]["steps"][0]["launches"] == (4, 2), name


def _tags(runs, name):
    return {k: v["count"]
            for k, v in runs[0][name]["steps"][0]["by_tag"].items()}


def test_whisper_collectives(runs):
    """Whisper under tensor parallelism (2 + 2 layers, 4 heads, model 2):
    per forward (the loss's and the probe's) each layer's attention and
    MLP outputs summed, each decoder layer's cross-attention output, and
    the encoder output made ready for the cross-attention once (its
    cotangent summed once in the backward, not once a layer).  Under
    ``seq_shard`` the encoder output is gathered once a forward."""
    enc, dec = 2, 2
    tags = _tags(runs, "whisper_fsdp0")
    assert tags["tp_attn_out"] == 2 * (enc + dec), tags
    assert tags["tp_mlp_out"] == 2 * (enc + dec), tags
    assert tags["tp_cross_out"] == 2 * dec, tags
    assert tags["tp_enc_out"] == 1, tags
    seq = _tags(runs, "whisper_seq")
    assert seq["sp_enc_out"] == 2 and seq["sp_enc_out_grad"] == 1, seq
    assert seq["sp_cross_in"] == 2 * dec and seq["sp_cross_out"] == 2 * dec
    assert not [t for t in seq if t.startswith("tp_")], seq


def test_vlm_prefix_under_seq_shard(runs):
    """phi-3 under ``seq_shard``: the token chunk gathered once to put the
    patch prefix before it, and the whole hidden gathered once to crop
    the prefix, in each forward; the patch projection's gradient summed
    over "model" once (each rank's chunk's share)."""
    tags = _tags(runs, "vlm_seq")
    assert tags["sp_prefix_in"] == 2 and tags["sp_prefix_out"] == 2, tags
    # the norms, final_norm and vision_proj's w and b
    assert tags["seq_param_grad"] == 2 * 2 + 1 + 2, tags
    assert "tp_prefix_in" not in tags


@pytest.mark.parametrize("name", sorted(UNDIVIDED))
def test_seq_shard_is_a_no_op_where_the_sequence_does_not_divide(runs,
                                                                 name):
    """Where the model axis does not divide the whole sequence, the step
    chunks nothing: no sequence-parallel collective, the tensor-parallel
    ones of the step without the knob (its JAX hold:
    ``test_mesh_step_matches_jax``)."""
    tags = _tags(runs, name)
    assert not [t for t in tags if t.startswith("sp_")], tags
    assert tags["tp_attn_out"] > 0, tags


def _close(got, want, what, scale=False, **tol):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    if scale:
        tol["atol"] = tol["atol"] + RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_mesh_serving_matches_jax(runs, name):
    """The prefill and 4 decode steps against JAX's unsharded ones: the
    logits, and the cache (gathered) after the prefill and after the
    last step."""
    job = SERVE[name]
    want = _jax_serving(job["arch"])
    got = runs[0][name]
    assert len(got["logits"]) == len(want["logits"])
    for t, lg in enumerate(got["logits"]):
        _close(lg, want["logits"][t], f"{name} logits {t}", **LOGIT_TOL)
    for key in ("cache_prefill", "cache"):
        assert got[key].keys() == want[key].keys()
        for leaf, w in want[key].items():
            _close(got[key][leaf], w, f"{name} {key} {leaf}", scale=True)
    for r in runs[1:]:
        for a, b in zip(r[name]["logits"], got["logits"]):
            np.testing.assert_array_equal(a, b)
    if job["arch"] == WHISPER:
        # the cross-attention on the rank's heads (decode_heads) or over
        # its frames (cache_seq_shard: the partial softmax combined)
        dec = {k: v["count"] for k, v in got["by_tag"][-1].items()}
        assert dec["tp_cross_out"] == 2, dec
        if job["cache_seq_shard"]:
            assert dec["decode_max"] == 2 * 2, dec
        blk = got["block"]["cross_k"]
        assert blk.shape[2:4] == ((FRAMES // 2, 4) if job["cache_seq_shard"]
                                  else (FRAMES, 2)), blk.shape
