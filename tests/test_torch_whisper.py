"""The port's audio family (whisper-medium: a non-causal encoder over
stubbed frame embeddings, a causal decoder with cross-attention) and
``attend_blockwise`` against the JAX package's, on the CPU.

Weights are the JAX package's (``convert.params_from_jax``); attention
inputs and frame embeddings are drawn from a seed with numpy, tokens by
the JAX package's bigram chain.  On the CPU the decoder's causal
self-attention runs the ``swa_attention`` kernel's plain version and the
loss the ``fused_ce`` kernel's.

Tolerances:

* ``attend_blockwise`` and the encoder: ``rtol = 1e-5``, ``atol = 1e-5 ·
  max|want|`` (fp32 sums in other orders); logits at ``atol = rtol =
  1e-5`` (tests/test_torch_lm.py's ``LOGIT_TOL``), the loss within 1e-5;
* ``sinusoidal_positions``: XLA's fp32 ``exp`` and ATen's round 48 and 7
  of whisper's 512 rates apart from the correctly rounded value, so the
  packages' rates may differ by an ULP (2^-24 relative, rates ≤ 1), and
  sin(pos · rate) then by up to pos · 2^-23: held to ``atol = S ·
  2^-22`` (1500 frames: 3.6e-4; measured 1.2e-4), and exactly equal at
  position 0;
* each gradient leaf within ``1e-5 · max|g|`` of that leaf, but the
  cross-attention's query and key weights and its norm: over encoder
  outputs of 0.02 · N(0, 1) frames the cross-attention is near uniform,
  so their gradient is a difference of nearly equal terms
  (P ⊙ (dP − rowsum)), some 10³ times smaller than the terms; their
  rounding scales with the terms, whose size is the gradient of the same
  attention's value weights, so they are held to ``1e-5 · max|g|`` of
  ``cross.wv`` (measured: 7.0e-5 of their own max, 1e-9 absolute);
* a triggered step under tests/test_torch_hybrid.py's
  ``_check_hybrid_step`` at 2.5e-4 · max|g|, that cancellation's scale;
  greedy tokens equal except at a near-tie of the JAX logits' top two.

Decode applies RoPE in the decoder's self-attention (the reference's
``decode_attend`` always does) where the training forward does not, so
the tests hold decode to JAX's decode, not to the forward.
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
from repro.models import attention as JA
from repro.models import build as jax_build
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.configs.whisper_medium import DECODER_LEN
from repro_torch.data import synthetic as TD
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as TA
from repro_torch.models import build
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.utils import tree as T
from test_torch_hybrid import _check_hybrid_step
from test_torch_lm import _assert_same_tokens, _axes_leaves
from test_torch_moe import lm_batches, step_parity
from test_torch_train import _leaves

torch.set_num_threads(1)

RTOL = 1e-5
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = 2.5e-4
ARCH = "whisper-medium"
FRAMES = 96
# the cross-attention leaves whose gradient is a cancellation, held at
# the scale of the same attention's value weights
CANCELLING = {("dec_blocks", "cross", "wq"), ("dec_blocks", "cross", "wk"),
              ("dec_blocks", "ln_cross")}


@functools.lru_cache(maxsize=None)
def _pair(q_block=None):
    """(JAX model, port model, JAX params, port params), reduced (2
    encoder and 2 decoder layers, d 256, 4 heads of 64)."""
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(attn_q_block=q_block)
    tcfg = reduced(get_config(ARCH)).replace(attn_q_block=q_block)
    jm, tm = jax_build(jcfg), build(tcfg)
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
def _batch(frames: int = FRAMES, dec: int = 40) -> dict:
    """Two requests: 0.02 · N(0, 1) frames (seed 11) and ``dec + 1``
    tokens of the JAX package's bigram chain."""
    d = _pair()[0].cfg.d_model
    frame_embeds = (0.02 * np.random.default_rng(11).standard_normal(
        (2, frames, d))).astype(np.float32)
    toks = np.asarray(JD.sample_lm_tokens(jax.random.key(7), 2, dec + 1,
                                          _pair()[0].cfg.vocab_size))
    return {"frame_embeds": frame_embeds, "tokens": toks[:, :-1],
            "labels": toks[:, 1:]}


# ----------------------------------------------------------------------
# attend_blockwise and the dispatch
# ----------------------------------------------------------------------

BLOCKWISE_CASES = {
    # name: (Sq, Sk, causal, window, q_block)
    "causal": (128, 128, True, None, 32),
    "windowed": (128, 128, True, 40, 32),
    "non_causal": (128, 128, False, None, 32),
    "ragged_q_block": (100, 100, True, None, 32),  # one block of 100
    "cross_sq_ne_sk": (64, 96, False, None, 16),
}


def _attn_inputs(sq: int, sk: int, seed: int, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, n, hd)).astype(np.float32)
            for s, n in ((sq, h), (sk, kv), (sk, kv))]


@pytest.mark.parametrize("case", list(BLOCKWISE_CASES))
def test_attend_blockwise_matches_jax(case):
    """Each case against the JAX package's ``attend_blockwise`` and the
    port's own ``attend`` (the same math in one block)."""
    sq, sk, causal, window, qb = BLOCKWISE_CASES[case]
    q, k, v = _attn_inputs(sq, sk, seed=sq + sk)
    want = JA.attend_blockwise(q, k, v, causal=causal, window=window,
                               q_block=qb)
    got = TA.attend_blockwise(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_block=qb)
    assert got.shape == q.shape
    _close(got, want, case)
    _close(got, TA.attend(_t(q), _t(k), _t(v), causal=causal,
                          window=window).numpy(), f"{case} vs attend")


def test_attend_blockwise_gradient_matches_jax():
    """The gradient of a weighted sum of the windowed blockwise output
    with respect to q, k and v, against ``jax.grad`` of the JAX
    package's (rematerialised) blocks."""
    q, k, v = _attn_inputs(96, 96, seed=5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(JA.attend_blockwise(q, k, v, causal=True, window=40,
                                           q_block=32) * w)

    def tloss(q, k, v):
        return torch.sum(TA.attend_blockwise(q, k, v, causal=True,
                                             window=40, q_block=32) * _t(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    got = torch.func.grad(tloss, argnums=(0, 1, 2))(_t(q), _t(k), _t(v))
    for name, g, wnt in zip("qkv", got, want):
        _close(g, wnt, name)


def test_attention_dispatch_follows_jax(monkeypatch):
    """Non-causal calls go blockwise when ``q_block`` is set and S >
    q_block, or S > ``BLOCKWISE_THRESHOLD``, else plain; a causal call
    goes to the ``swa_attention`` kernel (its plain version here)."""
    calls = []
    plain, blockwise = TA.attend, TA.attend_blockwise
    monkeypatch.setattr(TA, "attend", lambda *a, **k: calls.append(
        "attend") or plain(*a, **k))
    monkeypatch.setattr(TA, "attend_blockwise", lambda *a, **k: calls.append(
        ("blockwise", k.get("q_block"))) or blockwise(*a, **k))
    monkeypatch.setattr(TA, "BLOCKWISE_THRESHOLD", 64)
    q, k, v = (_t(a) for a in _attn_inputs(96, 96, seed=7))
    TA.attention(q, k, v, causal=False, q_block=32)
    TA.attention(q[:, :32], k, v, causal=False, q_block=32)
    TA.attention(q, k, v, causal=False)
    TA.attention(q[:, :64], k, v, causal=False)
    assert calls == [("blockwise", 32), "attend", ("blockwise", None),
                     "attend"]
    before = swa_ops.swa_attention.launches
    counted = []
    monkeypatch.setattr(swa_ops, "swa_attention_ref", lambda *a, **kw:
                        counted.append(1) or TA.attend(*a[:3], causal=True))
    TA.attention(q, k, v, causal=True, q_block=32)
    assert counted == [1] and swa_ops.swa_attention.launches == before


@pytest.mark.parametrize("seq,dim", [(1500, 1024), (FRAMES, 256)])
def test_sinusoidal_positions_match_jax(seq, dim):
    want = np.asarray(JL.sinusoidal_positions(seq, dim))
    got = TL.sinusoidal_positions(seq, dim)
    assert got.shape == (seq, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=seq * 2.0 ** -22)
    np.testing.assert_array_equal(got[0].numpy(), want[0])


def test_gelu_mlp_matches_jax():
    """``gelu_mlp`` (the tanh GELU, ``jax.nn.gelu``'s default) on the
    reduced encoder's first layer."""
    jm, tm, jp, tp = _pair()
    pj = jax.tree_util.tree_map(lambda t: t[0], jp["enc_blocks"]["mlp"])
    pt = jax.tree_util.tree_map(lambda t: t[0], tp["enc_blocks"]["mlp"])
    x = np.random.default_rng(8).standard_normal((2, 10, 256)).astype(
        np.float32)
    _close(TL.gelu_mlp(pt, _t(x)), JL.gelu_mlp(pj, x), "gelu_mlp")


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q_block", [None, 24, 40],
                         ids=["plain", "blockwise_4", "ragged_fallback"])
def test_whisper_encode_matches_jax(q_block):
    """The encoder over 96 frames: plain ``attend``, ``attend_blockwise``
    in 4 blocks of 24, and q_block 40, which does not divide 96 (one
    block); each against the JAX package's encoder at the same
    ``attn_q_block`` and against the port's plain encoder."""
    jm, tm, jp, tp = _pair(q_block)
    b = _batch()
    want = jax.jit(lambda p, f: JT.whisper_encode(
        jm.cfg, p, {"frame_embeds": f}))(jp, b["frame_embeds"])
    got = TT.whisper_encode(tm.cfg, tp, {"frame_embeds": _t(
        b["frame_embeds"])})
    assert got.shape == (2, FRAMES, 256)
    _close(got, want, "encoder")
    plain = TT.whisper_encode(_pair()[1].cfg, tp, {"frame_embeds": _t(
        b["frame_embeds"])})
    _close(got, plain.numpy(), "blockwise vs plain encoder")


def test_init_tree_matches_jax():
    """Same paths, shapes and logical axes as JAX ``init``: encoder and
    decoder stacks, cross-attention, ``dec_pos`` of ``DECODER_LEN``
    rows, no ``out_embed`` (the embedding is the output table)."""
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
    assert tp["dec_pos"].shape == (DECODER_LEN, 256)
    assert "out_embed" not in tp
    assert TT.output_table(tm.cfg, tp) is tp["embedding"]


def test_forward_loss_and_gradient_match_jax():
    """Logits of ``forward`` (the decoder over 40 tokens against 96
    frames); ``loss_fn`` and its gradient leaf by leaf."""
    jm, tm, jp, tp = _pair()
    b = _batch()
    fwd = {k: b[k] for k in ("frame_embeds", "tokens")}
    want, _ = jax.jit(jm.forward)(jp, fwd)
    got, aux = tm.forward(tp, convert.to_torch(fwd, "cpu"))
    assert got.shape == (2, 40, jm.cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, b)
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(
        tp, convert.to_torch(b, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5
    want_g = _leaves(jax.device_get(jg))
    got_g = dict(T.tree_flatten_with_path(tg))
    assert got_g.keys() == want_g.keys()
    for path, g in got_g.items():
        w = want_g[path]
        ref = want_g[("dec_blocks", "cross", "wv")] if path in CANCELLING \
            else w
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("start", ["port_prefill", "jax_cache"])
def test_prefill_and_greedy_decode_match_jax(start):
    """The prefill encodes the frames once (no logits) and fills every
    decoder layer's cross K/V; then 8 greedy decode steps from the
    first token, against the JAX package's; from the port's own
    prefill, or from the JAX package's cache carried across with
    ``convert.cache_from_jax``."""
    jm, tm, jp, tp = _pair()
    b = _batch()
    jl, jc = jm.prefill(jp, {"frame_embeds": jnp.asarray(b["frame_embeds"])},
                        cache_len=FRAMES)
    assert jl is None
    if start == "port_prefill":
        tl, tc = tm.prefill(tp, {"frame_embeds": _t(b["frame_embeds"])},
                            FRAMES)
        assert tl is None
    else:
        tc = convert.cache_from_jax(jax.device_get(jc), device="cpu")
    assert tc["cross_k"].shape == (2, 2, FRAMES, 4, 64)
    assert tc["self"].k.shape == (2, 2, DECODER_LEN, 4, 64)
    _close(tc["cross_k"], jc["cross_k"], "cross keys")
    _close(tc["cross_v"], jc["cross_v"], "cross values")
    decode = jax.jit(jm.decode_step)
    tok = b["tokens"][:, :1].astype(np.int32)
    for i in range(8):
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(i))
        tl, tc = tm.decode_step(tp, tc, _t(tok), i)
        want_logits = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_same_tokens(tl[:, 0].argmax(-1).numpy(), want_logits, i)
        tok = want_logits.argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(tc["self"].pos_ids.numpy(),
                                  np.asarray(jc["self"].pos_ids))
    _close(tc["self"].k, jc["self"].k, "decoder self-attention keys")


def test_triggered_steps_match_jax():
    """Two ``gain_lookahead(lam=0.01)|int8+ef`` steps, m = 2, reduced
    whisper (16 frames and 16 decoder tokens per request, the JAX
    package's ``lm_batch``), against the JAX package's ``unroll``
    path."""
    jm, tm, jp, _ = _pair()
    batches = lm_batches(jm, 2, 2, 16, (400, 401))
    assert batches[0]["frame_embeds"].shape == (2, 2, 16, 256)
    check = functools.partial(_check_hybrid_step, tol=STEP_TOL)
    outcomes = step_parity(jm, tm, jp, "gain_lookahead(lam=0.01)|int8+ef",
                           batches, check=check)
    assert outcomes.count("checked") >= 1, outcomes


def test_lm_batch_matches_jax_structure():
    """``lm_batch`` for audio: S encoder frames and min(S, DECODER_LEN)
    decoder tokens, as the JAX package's; the labels are the tokens
    shifted by one."""
    cfg = reduced(get_config(ARCH))
    shape = InputShape("t", 500, 4, "train")
    got = TD.lm_batch(cfg, shape, torch.Generator().manual_seed(0),
                      num_agents=2)
    want = JD.lm_batch(jax_reduced(jax_get_config(ARCH)),
                       JInputShape("t", 500, 4, "train"),
                       jax.random.key(0), num_agents=2)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["tokens"].shape == (2, 2, DECODER_LEN)
    assert abs(float(got["frame_embeds"].std()) - 0.02) < 0.001
    chain = TD.lm_batch(cfg, shape, torch.Generator().manual_seed(0))
    assert torch.equal(chain["tokens"][0, :, 1:], chain["labels"][0, :, :-1])


def test_train_cli_on_the_cpu(capsys):
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--seq", "16", "--batch", "2",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert re.search(rf"^arch={re.escape(ARCH)} .* device=cpu$", out, re.M)
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\S+)", out,
                                           re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses)), out


def test_serve_cli_exits_for_whisper():
    """As the JAX CLI: the decode demo serves token-prompted families."""
    with pytest.raises(SystemExit, match="whisper"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
