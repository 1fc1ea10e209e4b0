"""The port's ssm family (xlstm-350m: alternating mLSTM / sLSTM pairs)
against the JAX package's, on the CPU.

Weights are the JAX package's (``convert.params_from_jax``); the cells'
inputs are drawn from a seed with numpy, tokens by the JAX package's
bigram chain.  On the CPU the loss runs the ``fused_ce`` kernel's plain
version (no attention runs in this family).

Tolerances.  The cells (``mlstm_chunkwise``, ``mlstm_decode_step``,
``_slstm_cell``, ``slstm_forward``) within ``rtol = 1e-5`` and ``atol =
1e-5 · max|want|`` of each output (fp32 products summed in other
orders); the gradient of the chunkwise form the same per input.  The
mLSTM's chunked decays ``exp(cum_t − cum_j + li_j)`` exponentiate
differences of two prefix sums of the log forget gates (~45 in size at a
64-step chunk), so their rounding is amplified, as in the hybrid's SSD.
The reference's own cross-path gap measures it: the JAX model at chunk
32 against chunk 64 (the same function) differs by 2.6e-6 in the logits
and 6.9e-6 · max|g| in a gradient leaf at reduced size and S = 128, and
at chunk 64 against 128 by 4.4e-6 in the logits; the port against JAX
by 3.8e-6 and 1.0e-5 · max|g| (measured on these inputs).  So the
model's logits are held at ``atol = rtol = 1e-5`` (tests/test_torch_lm.py's
``LOGIT_TOL``), the loss within 1e-5, each gradient leaf within
``XLSTM_GRAD_TOL`` (2.5e-5) · max|g| of that leaf, about 3.6 times the
reference's own gap (tests/test_torch_hybrid.py holds the SSD at 2.8
times its own).  A triggered step under tests/test_torch_hybrid.py's
``_check_hybrid_step`` with this tolerance.  Greedy tokens are equal
except at a near-tie of the JAX logits' top two (1e-4).

The reference's gradient has no double where in the chunkwise mLSTM: a
masked (j > t) decay overflows past a chunk of ~100 steps and its
gradient turns NaN (ROADMAP §3), where the port's, masked first as the
SSD's is, stays finite; below that the two are the same function.
"""
import dataclasses
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
from repro.models import xlstm as JXL
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.models import xlstm as TXL
from repro_torch.utils import tree as T
from test_torch_hybrid import _check_hybrid_step
from test_torch_lm import _assert_same_tokens, _axes_leaves
from test_torch_moe import lm_batches, step_parity
from test_torch_train import _leaves

torch.set_num_threads(1)

RTOL = 1e-5
XLSTM_GRAD_TOL = 2.5e-5
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "xlstm-350m"


def _with_chunk(cfg, chunk: int):
    return cfg.replace(xlstm=dataclasses.replace(cfg.xlstm,
                                                 chunk_size=chunk))


@functools.lru_cache(maxsize=None)
def _pair(chunk: int = 64):
    """(JAX model, port model, JAX params, port params), reduced (2
    layers: one pair, d 256, 4 heads; the mLSTM's heads are 128 wide)."""
    jm = jax_build(_with_chunk(jax_reduced(jax_get_config(ARCH)), chunk))
    tm = build(_with_chunk(reduced(get_config(ARCH)), chunk))
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


def _pair0(params, name: str):
    return jax.tree_util.tree_map(lambda t: t[0], params["pairs"][name])


# ----------------------------------------------------------------------
# the mLSTM
# ----------------------------------------------------------------------

def _mlstm_inputs(seed: int, b=2, s=128, h=4, p=16):
    """q, k, v ~ N(0, 1); gates as the model forms them from N(0, 1)
    pre-activations: log_i capped at 8, log_f = log σ(·)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v = (rng.standard_normal((b, s, h, p)).astype(f) for _ in "qkv")
    log_i = np.minimum(2.0 * rng.standard_normal((b, s, h)),
                       JXL.I_GATE_CAP).astype(f)
    log_f = (-np.logaddexp(0.0, -(rng.standard_normal((b, s, h)) + 2.0))
             ).astype(f)
    C0 = rng.standard_normal((b, h, p, p)).astype(f)
    n0 = rng.standard_normal((b, h, p)).astype(f)
    return q, k, v, log_i, log_f, (C0, n0)


MLSTM_CASES = {"divisible": (128, 32, False), "ragged": (100, 32, False),
               "carried_state": (96, 32, True)}


@pytest.mark.parametrize("case", list(MLSTM_CASES))
def test_mlstm_chunkwise_matches_jax(case):
    """``s % chunk == 0`` (4 chunks), ``s % chunk ≠ 0`` (one chunk of s,
    as the JAX package falls back) and a carried-in state."""
    s, chunk, with_state = MLSTM_CASES[case]
    q, k, v, li, lf, st = _mlstm_inputs(1, s=s)
    jst = JXL.MLSTMState(*st) if with_state else None
    tst = TXL.MLSTMState(*(_t(a) for a in st)) if with_state else None
    wy, wstate = JXL.mlstm_chunkwise(q, k, v, li, lf, chunk, state=jst)
    gy, gstate = TXL.mlstm_chunkwise(_t(q), _t(k), _t(v), _t(li), _t(lf),
                                     chunk, state=tst)
    assert gy.shape == q.shape and gstate.C.shape == (2, 4, 16, 16)
    _close(gy, wy, "y")
    _close(gstate.C, wstate.C, "C")
    _close(gstate.n, wstate.n, "n")


def test_mlstm_chunkwise_gradient_matches_jax():
    """The gradient of a weighted sum of y and the final state with
    respect to q, k, v, both gates and the carried state, against
    ``jax.grad`` (chunks of 32: every decay finite in both)."""
    q, k, v, li, lf, (C0, n0) = _mlstm_inputs(2, s=96)
    rng = np.random.default_rng(3)
    wy = rng.standard_normal(q.shape).astype(np.float32)
    wc = rng.standard_normal(C0.shape).astype(np.float32)

    def jloss(q, k, v, li, lf, C0, n0):
        y, st = JXL.mlstm_chunkwise(q, k, v, li, lf, 32,
                                    state=JXL.MLSTMState(C0, n0))
        return jnp.sum(y * wy) + jnp.sum(st.C * wc) + jnp.sum(st.n)

    def tloss(q, k, v, li, lf, C0, n0):
        y, st = TXL.mlstm_chunkwise(q, k, v, li, lf, 32,
                                    state=TXL.MLSTMState(C0, n0))
        return torch.sum(y * _t(wy)) + torch.sum(st.C * _t(wc)) + \
            torch.sum(st.n)

    args = (q, k, v, li, lf, C0, n0)
    want = jax.grad(jloss, argnums=tuple(range(7)))(*args)
    got = torch.func.grad(tloss, argnums=tuple(range(7)))(
        *(_t(a) for a in args))
    for name, g, w in zip(("q", "k", "v", "log_i", "log_f", "C0", "n0"),
                          got, want):
        assert bool(torch.isfinite(g).all()), name
        _close(g, w, name)


def test_mlstm_gradient_is_finite_where_the_reference_is_nan():
    """At chunk 128 over 256 positions a masked decay overflows: the JAX
    package's model gradient is NaN there, the port's finite (its
    masked decays are zeroed before their exp), its forward equal to
    the JAX package's, and its gradient that of the same model at chunk
    64, where no decay overflows (within XLSTM_GRAD_TOL)."""
    jm, tm, jp, tp = _pair(128)
    toks = _tokens(257, jm.cfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, batch)
    assert any(bool(jnp.isnan(g).any())
               for g in jax.tree_util.tree_leaves(jg))
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(
        tp, convert.to_torch(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5
    tm64 = _pair(64)[1]
    tg64 = torch.func.grad(tm64.loss_fn)(tp, convert.to_torch(batch, "cpu"))
    want = dict(T.tree_flatten_with_path(tg64))
    for path, g in T.tree_flatten_with_path(tg):
        assert bool(torch.isfinite(g).all()), path
        np.testing.assert_allclose(
            g.numpy(), want[path].numpy(), rtol=0,
            atol=XLSTM_GRAD_TOL * float(want[path].abs().max()),
            err_msg=str(path))


def test_mlstm_block_and_decode_step_match_jax():
    """The mLSTM block's chunkwise forward over 100 positions, and one
    recurrent step from a random state, against the JAX package's."""
    jm, tm, jp, tp = _pair()
    pj, pt = _pair0(jp, "mlstm"), _pair0(tp, "mlstm")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 100, tm.cfg.d_model)).astype(np.float32)
    _close(TXL.mlstm_forward(pt, tm.cfg, _t(x)),
           jax.jit(lambda p, x: JXL.mlstm_forward(p, jm.cfg, x))(pj, x),
           "forward")
    st = (rng.standard_normal((2, 4, 128, 128)).astype(np.float32),
          rng.standard_normal((2, 4, 128)).astype(np.float32))
    jy, jst = jax.jit(lambda p, x, s: JXL.mlstm_decode_step(
        p, jm.cfg, x, s))(pj, x[:, :1], JXL.MLSTMState(*st))
    ty, tst = TXL.mlstm_decode_step(pt, tm.cfg, _t(x[:, :1]),
                                    TXL.MLSTMState(*(_t(a) for a in st)))
    _close(ty, jy, "decode y")
    _close(tst.C, jst.C, "decode C")
    _close(tst.n, jst.n, "decode n")


def test_mlstm_recurrent_steps_equal_the_chunkwise_form():
    """128 recurrent steps from the zero state give the chunkwise block's
    outputs (two chunks of 64)."""
    _, tm, _, tp = _pair()
    pt = _pair0(tp, "mlstm")
    x = _t(np.random.default_rng(5).standard_normal(
        (2, 128, tm.cfg.d_model)).astype(np.float32))
    want = TXL.mlstm_forward(pt, tm.cfg, x)
    st = TXL.MLSTMState(torch.zeros((2, 4, 128, 128)),
                        torch.zeros((2, 4, 128)))
    ys = []
    for t in range(128):
        y, st = TXL.mlstm_decode_step(pt, tm.cfg, x[:, t:t + 1], st)
        ys.append(y)
    _close(torch.cat(ys, 1), want.numpy(), "decode vs chunkwise")


# ----------------------------------------------------------------------
# the sLSTM
# ----------------------------------------------------------------------

def _slstm_state(seed: int, b: int, d: int):
    rng = np.random.default_rng(seed)
    c, n, h = (rng.standard_normal((b, d)).astype(np.float32)
               for _ in "cnh")
    return c, np.abs(n) + 0.5, rng.standard_normal((b, d)).astype(
        np.float32), h


def test_slstm_cell_and_decode_step_match_jax():
    """One cell step from a random state (m and n as a running stabiliser
    and normaliser), the decode step, the block's MLP, and the initial
    state (m = −20)."""
    jm, tm, jp, tp = _pair()
    pj, pt = _pair0(jp, "slstm"), _pair0(tp, "slstm")
    d = tm.cfg.d_model
    st = _slstm_state(6, 2, d)
    x = np.random.default_rng(7).standard_normal((2, 1, d)).astype(
        np.float32)
    want = JXL._slstm_cell(pj, jm.cfg, x[:, 0], JXL.SLSTMState(*st))
    got = TXL._slstm_cell(pt, tm.cfg, _t(x[:, 0]),
                          TXL.SLSTMState(*(_t(a) for a in st)))
    for name, g, w in zip(TXL.SLSTMState._fields, got, want):
        _close(g, w, f"cell {name}")
    jy, _ = JXL.slstm_decode_step(pj, jm.cfg, x, JXL.SLSTMState(*st))
    ty, _ = TXL.slstm_decode_step(pt, tm.cfg, _t(x),
                                  TXL.SLSTMState(*(_t(a) for a in st)))
    _close(ty, jy, "decode y")
    _close(TXL.slstm_block_mlp(pt, tm.cfg, _t(x)),
           JXL.slstm_block_mlp(pj, jm.cfg, x), "block MLP")
    init = TXL.init_slstm_state(tm.cfg, 3, "cpu")
    jinit = JXL.init_slstm_state(jm.cfg, 3)
    for g, w in zip(init, jinit):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_slstm_forward_matches_jax():
    """The sLSTM block's loop over 50 positions against the JAX
    package's ``lax.scan``."""
    jm, tm, jp, tp = _pair()
    pj, pt = _pair0(jp, "slstm"), _pair0(tp, "slstm")
    x = np.random.default_rng(8).standard_normal(
        (2, 50, tm.cfg.d_model)).astype(np.float32)
    _close(TXL.slstm_forward(pt, tm.cfg, _t(x)),
           jax.jit(lambda p, x: JXL.slstm_forward(p, jm.cfg, x))(pj, x),
           "forward")


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def test_init_tree_matches_jax():
    """Same paths, shapes and logical axes as JAX ``init``: the pairs'
    stacked axis, the sLSTM's recurrent weights at scale 0.02."""
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
    r = tp["pairs"]["slstm"]["r"]
    assert abs(float(r.std()) - 0.02) < 0.002


def test_forward_loss_and_gradient_match_jax():
    """Logits of ``forward`` over 128 positions (two mLSTM chunks);
    ``loss_fn`` and its gradient leaf by leaf."""
    jm, tm, jp, tp = _pair()
    toks = _tokens(129, jm.cfg.vocab_size)
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
    for path, g in got_g.items():
        w = want_g[path]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=XLSTM_GRAD_TOL * float(
                                       w.abs().max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("start", ["port_prefill", "jax_cache"])
def test_prefill_and_greedy_decode_match_jax(start):
    """The replayed prefill of 40 tokens (last logits (B, 1, V) and the
    states), then 8 greedy decode steps against the JAX package's; from
    the port's own prefill, or from the JAX package's cache carried
    across with ``convert.cache_from_jax``."""
    jm, tm, jp, tp = _pair()
    seq = 40
    toks = _tokens(seq, jm.cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=seq)
    if start == "port_prefill":
        tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, seq)
        assert tl.shape == (2, 1, jm.cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    else:
        tc = convert.cache_from_jax(jax.device_get(jc), device="cpu")
    assert tc["mlstm"].C.shape == (1, 2, 4, 128, 128)
    assert tc["slstm"].m.shape == (1, 2, 256)
    for name in ("mlstm", "slstm"):
        for field, g, w in zip(tc[name]._fields, tc[name], jc[name]):
            _close(g, w, f"{name}.{field}")
    decode = jax.jit(jm.decode_step)
    want_logits = np.asarray(jl[:, -1])
    for i in range(8):
        tok = want_logits.argmax(-1)[:, None].astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(seq + i))
        tl, tc = tm.decode_step(tp, tc, _t(tok), seq + i)
        want_logits = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_same_tokens(tl[:, 0].argmax(-1).numpy(), want_logits, i)
    _close(tc["mlstm"].C, jc["mlstm"].C, "matrix memory after decode")
    _close(tc["slstm"].h, jc["slstm"].h, "sLSTM h after decode")


def test_replayed_prefill_equals_the_forward():
    """The recurrent prefill's last logits equal the chunkwise forward's
    last position (the two forms of one model), and greedy serving
    through the CLI's functions equals greedy decoding from
    ``forward``."""
    _, tm, _, tp = _pair()
    prompts = _t(_tokens(12, tm.cfg.vocab_size)).long()
    first, logits, cache = serve.prefill_prompt(tm, tp, prompts,
                                                cache_len=12)
    out, _ = tm.forward(tp, {"tokens": prompts})
    np.testing.assert_allclose(logits[:, 0].numpy(), out[:, -1].numpy(),
                               **LOGIT_TOL)
    rest, _ = serve.decode_tokens(tm, tp, cache, first, 12, 3)
    seq = prompts
    for _ in range(4):
        out, _ = tm.forward(tp, {"tokens": seq})
        seq = torch.cat([seq, out[:, -1].argmax(-1, keepdim=True)], 1)
    assert torch.equal(torch.cat([first, rest], 1), seq[:, 12:])


def test_triggered_steps_match_jax():
    """Two ``gain_lookahead(lam=0.01)|int8+ef`` steps, m = 2, reduced
    xlstm, against the JAX package's ``unroll`` path (16 positions: one
    mLSTM chunk, every decay finite in both)."""
    jm, tm, jp, _ = _pair()
    batches = lm_batches(jm, 2, 2, 16, (300, 301))
    check = functools.partial(_check_hybrid_step, tol=XLSTM_GRAD_TOL)
    outcomes = step_parity(jm, tm, jp, "gain_lookahead(lam=0.01)|int8+ef",
                           batches, check=check)
    assert outcomes.count("checked") >= 1, outcomes


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
