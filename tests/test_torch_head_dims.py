"""The port's LM at the head dims the reference takes, on the CPU.

The JAX model's attention is plain einsums at any head dim.  The port's
causal self-attention runs the ``swa_attention`` kernel, whose CUDA
instances cover hd 32, 64, 96 and 128; its plain version (what a CPU
tensor gets) takes any hd.  Reduced smollm-135m (2 layers, 4 query and
2 kv heads) at ``d_model`` 128 (hd 32, what the CLIs' ``--reduced
--d-model 128`` gives) and 384 (hd 96, phi-3-vision's head dim) is
held to the JAX package's on the same weights
(``convert.params_from_jax``) and JAX-drawn tokens.

Tolerances as tests/test_torch_lm.py and tests/test_torch_train.py
(fp32 on both sides, sums in other orders): logits and the loss within
1e-5, each gradient leaf within ``1e-5 · max|g|`` of that leaf, the
cache's keys and values at ``atol = 5e-5, rtol = 1e-5``; greedy tokens
equal except at a near-tie of the JAX logits' top two.
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
from repro.kernels.swa_attention import ref as jax_swa_ref
from repro.models import build as jax_build
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.utils import tree as T
from test_torch_lm import _assert_same_tokens
from test_torch_train import _leaves

torch.set_num_threads(1)

ARCH = "smollm-135m"
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=5e-5, rtol=1e-5)
# d_model -> head dim at reduced's 4 heads
WIDTHS = {128: 32, 384: 96}


@functools.lru_cache(maxsize=None)
def _pair(d_model: int):
    """(JAX model, port model, JAX params, port params): reduced smollm at
    ``d_model`` with hd = d_model / 4, as the train CLI's ``--d-model``
    override sets it."""
    hd = d_model // 4
    jm = jax_build(jax_reduced(jax_get_config(ARCH)).replace(
        d_model=d_model, head_dim=hd))
    tm = build(reduced(get_config(ARCH)).replace(d_model=d_model,
                                                 head_dim=hd))
    jp, _ = jm.init(jax.random.key(0))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, tm, jp, tp


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("d_model", list(WIDTHS), ids=lambda d:
                         f"hd{WIDTHS[d]}")
def test_loss_and_gradient_match_jax(d_model, capsys):
    """``loss_fn`` on a JAX-drawn ``lm_batch`` of 2 × 16 tokens (seed 0)
    and its gradient leaf by leaf; the attention weights carry the head
    dim."""
    jm, tm, jp, tp = _pair(d_model)
    assert tm.cfg.head_dim_ == WIDTHS[d_model]
    shape = JInputShape("t", 16, 2, "train")
    batch = {k: v[0] for k, v in jax.device_get(
        JD.lm_batch(jm.cfg, shape, jax.random.key(0))).items()}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, batch)
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(
        tp, convert.to_torch(batch, "cpu"))
    with capsys.disabled():
        print(f"\n[head dims] hd {WIDTHS[d_model]}: loss JAX "
              f"{float(jl):.6f}, port {float(tl):.6f}")
    assert abs(float(tl) - float(jl)) <= 1e-5
    want = _leaves(jax.device_get(jg))
    got = dict(T.tree_flatten_with_path(tg))
    assert got.keys() == want.keys()
    assert got[("blocks", "attn", "wq")].shape[-1] == WIDTHS[d_model]
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("d_model", list(WIDTHS), ids=lambda d:
                         f"hd{WIDTHS[d]}")
def test_prefill_and_greedy_decode_match_jax(d_model):
    """Prefill logits and cache over 40 tokens, then 6 greedy decode
    steps, against the JAX package's."""
    jm, tm, jp, tp = _pair(d_model)
    toks = np.asarray(JD.sample_lm_tokens(jax.random.key(7), 2, 40,
                                          jm.cfg.vocab_size))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=48)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, 48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc.k.shape == (2, 2, 48, 2, WIDTHS[d_model])
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **CACHE_TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **CACHE_TOL)
    decode = jax.jit(jm.decode_step)
    want_logits = np.asarray(jl[:, -1])
    for i in range(6):
        tok = want_logits.argmax(-1)[:, None].astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(40 + i))
        tl, tc = tm.decode_step(tp, tc, _t(tok), 40 + i)
        want_logits = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_same_tokens(tl[:, 0].argmax(-1).numpy(), want_logits, i)


@pytest.mark.parametrize("hd", [32, 48, 96])
def test_swa_attention_plain_version_takes_any_head_dim(hd):
    """On a CPU tensor the wrapper computes the plain version at any hd,
    an hd with no kernel instance (48) too, against the JAX package's
    ``swa_attention_ref``, with a window and GQA."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((2, 70, h, hd)).astype(np.float32)
               for h in (6, 2, 2))
    want = jax_swa_ref.swa_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), window=24)
    got = swa_ops.swa_attention(_t(q), _t(k), _t(v), window=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_the_card_takes_only_the_kernels_instances():
    """The CUDA path's head-dim test: the four instances pass, any other
    hd raises (the card never falls back to the plain version)."""
    assert swa_ops.HEAD_DIMS == (32, 64, 96, 128)
    for hd in swa_ops.HEAD_DIMS:
        swa_ops.check_head_dim(hd)
    for hd in (16, 48, 80, 256):
        with pytest.raises(ValueError, match=f"head dim {hd} not supported"):
            swa_ops.check_head_dim(hd)


def test_train_cli_at_head_dim_32(capsys):
    """``--reduced --d-model 128`` (hd 32) trains on the CPU."""
    train_cli.main(["--arch", ARCH, "--reduced", "--d-model", "128",
                    "--device", "cpu", "--steps", "2", "--seq", "16",
                    "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\S+)", out,
                                           re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert re.search(r"^done: 2 steps, transmissions", out, re.M), out
