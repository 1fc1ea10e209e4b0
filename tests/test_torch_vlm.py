"""The port's vlm family (phi-3-vision: a phi-3-mini decoder behind a
projection of stubbed CLIP patch embeddings) against the JAX package's,
on the CPU.

Weights are the JAX package's (``convert.params_from_jax``); patch
embeddings are drawn from a seed with numpy, tokens by the JAX
package's bigram chain.  On the CPU the causal self-attention runs the
``swa_attention`` kernel's plain version and the loss the ``fused_ce``
kernel's.  Two widths: ``reduced`` (d 256, 4 heads of 64, 16 patches)
and ``d_model`` 384, whose 4 heads of 96 are phi-3-vision's head dim.

Tolerances as tests/test_torch_lm.py and tests/test_torch_train.py
(fp32 on both sides, sums in other orders): logits at ``atol = rtol =
1e-5``, the loss within 1e-5, each gradient leaf within ``1e-5 ·
max|g|`` of that leaf, the cache at ``atol = 5e-5, rtol = 1e-5``; a
triggered step under tests/test_torch_train.py's ``_check_step``; greedy
tokens equal except at a near-tie of the JAX logits' top two.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import InputShape as JInputShape
from repro.data import synthetic as JD
from repro.models import build as jax_build
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.data import synthetic as TD
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.utils import tree as T
from test_torch_lm import _assert_same_tokens, _axes_leaves
from test_torch_moe import lm_batches, step_parity
from test_torch_train import _leaves

torch.set_num_threads(1)

ARCH = "phi-3-vision-4.2b"
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=5e-5, rtol=1e-5)
WIDTHS = {"hd64": None, "hd96": 384}


def _width(cfg, d_model):
    return cfg if d_model is None else cfg.replace(d_model=d_model,
                                                   head_dim=d_model // 4)


@functools.lru_cache(maxsize=None)
def _pair(width: str = "hd64"):
    """(JAX model, port model, JAX params, port params), reduced."""
    d = WIDTHS[width]
    jm = jax_build(_width(jax_reduced(jax_get_config(ARCH)), d))
    tm = build(_width(reduced(get_config(ARCH)), d))
    jp, _ = jm.init(jax.random.key(0))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, tm, jp, tp


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(jm, seq: int = 32) -> dict:
    """Two requests: ``num_patches`` patch embeddings of 0.02 · N(0, 1)
    (seed 12) and ``seq + 1`` tokens of the JAX package's chain."""
    patches = (0.02 * np.random.default_rng(12).standard_normal(
        (2, jm.cfg.num_patches, jm.cfg.d_model))).astype(np.float32)
    toks = np.asarray(JD.sample_lm_tokens(jax.random.key(7), 2, seq + 1,
                                          jm.cfg.vocab_size))
    return {"patch_embeds": patches, "tokens": toks[:, :-1],
            "labels": toks[:, 1:]}


@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_loss_and_gradient_with_the_patch_prefix(width):
    """``forward`` with the patch prefix returns the token positions'
    logits only; ``loss_fn`` crops the prefix; both and the gradient
    (``vision_proj`` included) against the JAX package's."""
    jm, tm, jp, tp = _pair(width)
    b = _batch(jm)
    fwd = {k: b[k] for k in ("patch_embeds", "tokens")}
    want, _ = jax.jit(jm.forward)(jp, fwd)
    got, aux = tm.forward(tp, convert.to_torch(fwd, "cpu"))
    assert got.shape == (2, 32, jm.cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    text, _ = tm.forward(tp, {"tokens": _t(b["tokens"])})
    assert float((text - got).abs().max()) > 1e-3  # the prefix is seen
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, b)
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(
        tp, convert.to_torch(b, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5
    want_g = _leaves(jax.device_get(jg))
    got_g = dict(T.tree_flatten_with_path(tg))
    assert got_g.keys() == want_g.keys()
    assert float(got_g[("vision_proj", "w")].abs().max()) > 0
    for path, g in got_g.items():
        w = want_g[path]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=str(path))


def test_init_tree_matches_jax():
    """Same paths, shapes and logical axes as JAX ``init``, the vision
    projection included (its bias zeros)."""
    jm, tm, jp, _ = _pair()
    jaxes = jm.init(jax.random.key(0))[1]
    tp, taxes = tm.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = T.tree_flatten_with_path(tp)
    assert [tuple(k.key for k in path) for path, _ in jflat] == \
        [path for path, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape), path
    assert jax.tree_util.tree_leaves(
        jaxes, is_leaf=lambda x: isinstance(x, tuple)) == _axes_leaves(taxes)
    assert not bool(tp["vision_proj"]["b"].any())


@pytest.mark.parametrize("width", list(WIDTHS))
def test_text_prefill_and_greedy_decode_match_jax(width):
    """The prefill takes the tokens only, as the JAX package's: logits
    and cache over 40 tokens, then 6 greedy decode steps."""
    jm, tm, jp, tp = _pair(width)
    toks = np.asarray(JD.sample_lm_tokens(jax.random.key(7), 2, 40,
                                          jm.cfg.vocab_size))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=48)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, 48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **CACHE_TOL)
    decode = jax.jit(jm.decode_step)
    want_logits = np.asarray(jl[:, -1])
    for i in range(6):
        tok = want_logits.argmax(-1)[:, None].astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(40 + i))
        tl, tc = tm.decode_step(tp, tc, _t(tok), 40 + i)
        want_logits = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_same_tokens(tl[:, 0].argmax(-1).numpy(), want_logits, i)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **CACHE_TOL)


def test_decode_from_a_jax_cache():
    """``cache_from_jax`` carries the JAX package's prefill cache across;
    one decode step gives the JAX package's logits."""
    jm, tm, jp, tp = _pair("hd96")
    toks = np.asarray(JD.sample_lm_tokens(jax.random.key(7), 2, 24,
                                          jm.cfg.vocab_size))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=30)
    tc = convert.cache_from_jax(jax.device_get(jc), device="cpu")
    tok = np.full((2, 1), 5, np.int32)
    want, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(tok),
                                      jnp.int32(24))
    got, _ = tm.decode_step(tp, tc, _t(tok), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_triggered_steps_match_jax():
    """Two ``gain_lookahead(lam=0.01)|int8+ef`` steps, m = 2, reduced
    phi-3-vision on the JAX package's ``lm_batch`` (16 patches and 16
    tokens per request), against the JAX package's ``unroll`` path."""
    jm, tm, jp, _ = _pair()
    batches = lm_batches(jm, 2, 2, 16, (500, 501))
    assert batches[0]["patch_embeds"].shape == (2, 2, 16, 256)
    outcomes = step_parity(jm, tm, jp, "gain_lookahead(lam=0.01)|int8+ef",
                           batches)
    assert outcomes.count("checked") >= 1, outcomes


def test_lm_batch_matches_jax_structure():
    """``lm_batch`` for vlm: tokens, labels and ``num_patches`` patch
    embeddings of 0.02 · N(0, 1), as the JAX package's."""
    cfg = reduced(get_config(ARCH))
    got = TD.lm_batch(cfg, InputShape("t", 24, 4, "train"),
                      torch.Generator().manual_seed(0), num_agents=2)
    want = JD.lm_batch(jax_reduced(jax_get_config(ARCH)),
                       JInputShape("t", 24, 4, "train"), jax.random.key(0),
                       num_agents=2)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert abs(float(got["patch_embeds"].std()) - 0.02) < 0.002


def test_train_cli_on_the_cpu(capsys):
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--seq", "16", "--batch", "2",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert re.search(rf"^arch={re.escape(ARCH)} .* device=cpu$", out, re.M)
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\S+)", out,
                                           re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses)), out


def test_serve_cli_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "10", "--gen",
                       "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={ARCH}")
    assert len(eval(lines[3].split("-> ")[1])) == 4
