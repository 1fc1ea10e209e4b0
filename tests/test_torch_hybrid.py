"""The port's hybrid family (zamba2-1.2b: Mamba2 blocks and one shared
attention block) against the JAX package's, on the CPU.

Weights are the JAX package's (``convert.params_from_jax``); the SSD's
inputs are drawn from a seed with numpy, tokens by the JAX package's
bigram chain.  On the CPU the shared block's attention runs the
``swa_attention`` kernel's plain version and the loss the ``fused_ce``
kernel's.

Tolerances.  ``ssd_chunked`` and the Mamba2 block within ``rtol =
1e-5`` and ``atol = 1e-5 · max|want|`` of each output (fp32 chunk
products summed in other orders), its gradients the same per input; the
recurrent decode against the chunked forward likewise.  Through the
model the SSD's decays ``exp(cum_i − cum_j)`` exponentiate differences
of two prefix sums of dt·A (~50 in size at a 64-step chunk), so their
rounding is amplified, and each package sums them in its own order.
The reference's own cross-path gap measures it: the JAX model at chunk
32 against the same model at chunk 64 (the same function) differs by
1.1e-5 in the logits and 8.9e-5 · max|g| in a gradient leaf at 5
layers; the port against JAX by 1.8e-5 and 1.2e-4 · max|g| (measured
on these inputs).  So the model's paths are held at the reference's
own scale, where the dense and moe families hold 1e-5: logits within
``atol = rtol = HYBRID_TOL`` (5e-5), the loss within 1e-5, each
gradient leaf within ``HYBRID_GRAD_TOL`` (2.5e-4) · max|g|.  A
triggered step (``_check_hybrid_step``): decisions exact but at a gain
on its threshold, the float metrics within ``rtol = HYBRID_GRAD_TOL,
atol = 1e-6``, the EF memory within ``1e-6 + HYBRID_GRAD_TOL`` · each
agent's max|g + ef| per leaf, and the parameters within ``1e-6 + lr ·
HYBRID_GRAD_TOL`` · the leaf's max|g + ef| (the update's own scale:
an embedding entry of 0.01 takes updates of ~0.09); with an int8 wire
an entry within the tie band of a rounding boundary may land one level
apart, as tests/test_torch_train.py allows.  Greedy
tokens are equal except at a near-tie of the JAX logits' top two
(1e-4).
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
from repro.data import synthetic as JD
from repro.models import build as jax_build
from repro.models import ssm as JSSM
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.models import ssm as TSSM
from repro_torch.utils import tree as T
from test_torch_lm import _assert_same_tokens, _axes_leaves
from test_torch_moe import LR, lm_batches, step_parity
from test_torch_train import _leaves

torch.set_num_threads(1)

RTOL = 1e-5
HYBRID_TOL = 5e-5
HYBRID_GRAD_TOL = 2.5e-4
LOGIT_TOL = dict(atol=HYBRID_TOL, rtol=HYBRID_TOL)
ARCH = "zamba2-1.2b"
VARIANTS = {
    # 2 layers, a shared block after each: 2 sites
    "reduced": lambda c: c,
    # 5 layers in groups of 2: 3 sites, the last group short
    "every2_5layers": lambda c: c.replace(num_layers=5, shared_attn_every=2),
}


@functools.lru_cache(maxsize=None)
def _pair(variant: str):
    """(JAX model, port model, JAX params, port params), reduced."""
    fn = VARIANTS[variant]
    jm = jax_build(fn(jax_reduced(jax_get_config(ARCH))))
    tm = build(fn(reduced(get_config(ARCH))))
    jp, _ = jm.init(jax.random.key(0))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, tm, jp, tp


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


@functools.lru_cache(maxsize=None)
def _tokens(seq: int, vocab: int) -> np.ndarray:
    return np.asarray(JD.sample_lm_tokens(jax.random.key(7), 2, seq, vocab))


# ----------------------------------------------------------------------
# the SSD and the Mamba2 block
# ----------------------------------------------------------------------

def _ssd_inputs(seed: int, b=2, s=128, h=4, p=16, n=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(f)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(f)
    B = rng.standard_normal((b, s, n)).astype(f)
    C = rng.standard_normal((b, s, n)).astype(f)
    h0 = rng.standard_normal((b, h, n, p)).astype(f)
    return xh, dt, A, B, C, h0


SSD_CASES = {"divisible": (128, 32, False), "ragged": (100, 32, False),
             "h0": (96, 32, True)}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_jax(case):
    """``s % chunk == 0`` (4 chunks), ``s % chunk ≠ 0`` (one chunk of s,
    as the JAX package falls back) and a carried-in state ``h0``."""
    s, chunk, with_h0 = SSD_CASES[case]
    xh, dt, A, B, C, h0 = _ssd_inputs(1, s=s)
    h0 = h0 if with_h0 else None
    wy, wh = JSSM.ssd_chunked(xh, dt, A, B, C, chunk, h0=h0)
    gy, gh = TSSM.ssd_chunked(_t(xh), _t(dt), _t(A), _t(B), _t(C), chunk,
                              h0=None if h0 is None else _t(h0))
    assert gy.shape == xh.shape and gh.shape == (2, 4, 8, 16)
    _close(gy, wy, "y")
    _close(gh, wh, "h_final")


def test_ssd_chunked_gradient_matches_jax():
    """The gradient of a weighted sum of y and h_final with respect to
    every input, finite (the masked decays' double where), against
    ``jax.grad``."""
    xh, dt, A, B, C, h0 = _ssd_inputs(2, s=96)
    rng = np.random.default_rng(3)
    wy = rng.standard_normal(xh.shape).astype(np.float32)
    wh = rng.standard_normal(h0.shape).astype(np.float32)

    def jloss(*a):
        y, h = JSSM.ssd_chunked(*a[:5], 32, h0=a[5])
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    def tloss(*a):
        y, h = TSSM.ssd_chunked(*a[:5], 32, h0=a[5])
        return torch.sum(y * _t(wy)) + torch.sum(h * _t(wh))

    args = (xh, dt, A, B, C, h0)
    want = jax.grad(jloss, argnums=tuple(range(6)))(*args)
    got = torch.func.grad(tloss, argnums=tuple(range(6)))(
        *(_t(a) for a in args))
    for name, g, w in zip(("xh", "dt", "A", "B", "C", "h0"), got, want):
        assert bool(torch.isfinite(g).all()), name
        _close(g, w, name)


def _block0(params):
    return jax.tree_util.tree_map(lambda t: t[0], params["blocks"]["mamba"])


def test_mamba2_forward_and_decode_step_match_jax():
    """The chunked forward over 100 positions, and one recurrent step
    from a random state, against the JAX package's."""
    jm, tm, jp, tp = _pair("reduced")
    pj, pt = _block0(jp), _block0(tp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 100, tm.cfg.d_model)).astype(np.float32)
    _close(TSSM.mamba2_forward(pt, tm.cfg, _t(x)),
           jax.jit(lambda p, x: JSSM.mamba2_forward(p, jm.cfg, x))(pj, x),
           "forward")
    one = TSSM.init_mamba_state(tm.cfg, 2, torch.float32, "cpu")
    st = [rng.standard_normal(t.shape).astype(np.float32) for t in one]
    jy, jst = jax.jit(lambda p, x, s: JSSM.mamba2_decode_step(
        p, jm.cfg, x, s))(pj, x[:, :1], JSSM.MambaState(*st))
    ty, tst = TSSM.mamba2_decode_step(pt, tm.cfg, _t(x[:, :1]),
                                      TSSM.MambaState(*(_t(a) for a in st)))
    _close(ty, jy, "decode y")
    _close(tst.ssm, jst.ssm, "decode ssm state")
    _close(tst.conv, jst.conv, "decode conv state")


def test_recurrent_decode_equals_the_chunked_forward():
    """S = 80 recurrent steps from the zero state give the chunked
    forward's outputs (chunk 64: one full chunk and a short one do not
    divide 80, so the fallback's single chunk of 80)."""
    _, tm, _, tp = _pair("reduced")
    pt = _block0(tp)
    x = _t(np.random.default_rng(5).standard_normal(
        (2, 80, tm.cfg.d_model)).astype(np.float32))
    want = TSSM.mamba2_forward(pt, tm.cfg, x)
    st = TSSM.init_mamba_state(tm.cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(80):
        y, st = TSSM.mamba2_decode_step(pt, tm.cfg, x[:, t:t + 1], st)
        ys.append(y)
    _close(torch.cat(ys, 1), want.numpy(), "decode vs forward")


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_loss_and_gradient_match_jax(variant):
    """Logits of ``forward``; ``loss_fn`` and its gradient leaf by leaf,
    the shared block's summed over its sites."""
    jm, tm, jp, tp = _pair(variant)
    toks = _tokens(65, jm.cfg.vocab_size)
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks[:, :-1])})
    got, aux = tm.forward(tp, {"tokens": _t(toks[:, :-1])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert aux == 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, batch)
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(
        tp, convert.to_torch(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5
    want_g = _leaves(jax.device_get(jg))
    got_g = dict(T.tree_flatten_with_path(tg))
    assert got_g.keys() == want_g.keys()
    assert ("shared_attn", "attn", "wq") in got_g
    for path, g in got_g.items():
        w = want_g[path]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=HYBRID_GRAD_TOL * float(
                                       w.abs().max()),
                                   err_msg=str(path))


def test_init_tree_matches_jax():
    """Same paths, shapes and logical axes as JAX ``init``; the conv
    weights ``small_uniform`` on [−0.05, 0.05)."""
    jm, tm, jp, _ = _pair("every2_5layers")
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
    conv = tp["blocks"]["mamba"]["conv_w"]
    assert float(conv.min()) >= -0.05 and float(conv.max()) < 0.05
    assert abs(float(conv.std()) - 0.1 / 12 ** 0.5) < 0.002


@pytest.mark.parametrize("start", ["port_prefill", "jax_cache"])
def test_prefill_and_greedy_decode_match_jax(start):
    """The replayed prefill of 40 tokens (last logits (B, 1, V) and the
    cache), then 8 greedy decode steps against the JAX package's; from
    the port's own prefill, or from the JAX package's cache carried
    across with ``convert.cache_from_jax``."""
    jm, tm, jp, tp = _pair("every2_5layers")
    seq = 40
    toks = _tokens(seq, jm.cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=seq + 16)
    if start == "port_prefill":
        tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, seq + 16)
        assert tl.shape == (2, 1, jm.cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    else:
        tc = convert.cache_from_jax(jax.device_get(jc), device="cpu")
    assert tc["attn"].k.shape == (3, 2, seq + 16, 4, 64)
    assert tc["mamba"].ssm.shape == (5, 2, 8, 32, 64)
    _close(tc["mamba"].ssm, jc["mamba"].ssm, "ssm state")
    _close(tc["mamba"].conv, jc["mamba"].conv, "conv state")
    _close(tc["attn"].k, jc["attn"].k, "shared-attention keys")
    decode = jax.jit(jm.decode_step)
    want_logits = np.asarray(jl[:, -1])
    for i in range(8):
        tok = want_logits.argmax(-1)[:, None].astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(seq + i))
        tl, tc = tm.decode_step(tp, tc, _t(tok), seq + i)
        want_logits = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_same_tokens(tl[:, 0].argmax(-1).numpy(), want_logits, i)
    np.testing.assert_array_equal(tc["attn"].pos_ids.numpy(),
                                  np.asarray(jc["attn"].pos_ids))
    _close(tc["mamba"].ssm, jc["mamba"].ssm, "ssm state after decode")


def test_greedy_serving_equals_forward_argmax():
    """The CLI's replayed prefill and decode loop on the port equal
    greedy decoding built from ``forward``."""
    _, tm, _, tp = _pair("reduced")
    prompts = _t(_tokens(12, tm.cfg.vocab_size)).long()
    first, logits, cache = serve.prefill_prompt(tm, tp, prompts,
                                                cache_len=20)
    assert logits.shape == (2, 1, tm.cfg.vocab_size)
    rest, _ = serve.decode_tokens(tm, tp, cache, first, 12, 3)
    seq = prompts
    for _ in range(4):
        out, _ = tm.forward(tp, {"tokens": seq})
        seq = torch.cat([seq, out[:, -1].argmax(-1, keepdim=True)], 1)
    assert torch.equal(torch.cat([first, rest], 1), seq[:, 12:])


# ----------------------------------------------------------------------
# the triggered train step and the CLIs
# ----------------------------------------------------------------------

def _check_hybrid_step(policy, tnext, tmet, jnext, jmet, terms, *,
                       tol=HYBRID_GRAD_TOL):
    atol = 1e-6
    tx_t, tx_j = tmet["agent_tx"].numpy(), np.asarray(jmet["agent_tx"])
    if not np.array_equal(tx_t, tx_j):
        gains = terms()[1]
        odd = np.nonzero(tx_t != tx_j)[0]
        assert np.all(np.abs(gains[odd] + 0.01) <= tol * np.maximum(
            1, np.abs(gains[odd]))), f"decisions differ: {tx_t} vs {tx_j}"
        return "near-threshold decision"
    for key in jmet:
        np.testing.assert_allclose(tmet[key].numpy(), np.asarray(jmet[key]),
                                   rtol=tol, atol=atol, err_msg=key)
    g_eff = terms()[0]
    je, jp = _leaves(jnext.ef_memory), _leaves(jnext.params)
    tp = dict(T.tree_flatten_with_path(tnext.params))
    sent = tmet["agent_tx"] > 0
    for path, got in T.tree_flatten_with_path(tnext.ef_memory):
        g = g_eff[path]
        dims = tuple(range(1, g.ndim))
        amax = g.abs().amax(dim=dims, keepdim=True)
        # an entry within the tie band of an int8 rounding boundary
        r = (g / (amax / 127.0)).abs()
        tie = (r - r.floor() - 0.5).abs() <= 127.0 * tol
        bad = ((got - je[path]).abs() > atol + tol * amax) & ~tie
        assert not bool(bad.any()), f"EF memory {path}"
        level = (amax / 127.0 * tie * sent.reshape(amax.shape)).sum(0)
        diff = (tp[path] - jp[path]).abs()
        assert bool((diff <= atol + LR * (tol * amax.max() + level / 2)
                     ).all()), f"params {path}: {float(diff.max()):.3g}"
    return "checked"


def test_triggered_steps_match_jax():
    """Two ``gain_lookahead(lam=0.01)|int8+ef`` steps, m = 2, reduced
    zamba2, against the JAX package's ``unroll`` path."""
    jm, tm, jp, _ = _pair("reduced")
    batches = lm_batches(jm, 2, 2, 16, (200, 201))
    outcomes = step_parity(jm, tm, jp, "gain_lookahead(lam=0.01)|int8+ef",
                           batches, check=_check_hybrid_step)
    assert outcomes.count("checked") >= 1, outcomes


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b", ARCH])
def test_train_cli_on_the_cpu(arch, capsys):
    train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2", "--seq", "16", "--batch", "2",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert re.search(rf"^arch={re.escape(arch)} .* device=cpu$", out,
                     re.M), out
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", ARCH])
def test_clis_default_to_the_card(arch):
    """Without ``--device cpu`` the CLIs ask for the card, and here,
    without one, raise."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", arch, "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", arch, "--reduced", "--steps", "1"])
