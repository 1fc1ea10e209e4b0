"""Forward mode through the port's LM kernels, and the ``gain_quadratic``
trigger on an LM loss, against the plain versions and the JAX package.

The two LM kernels are ``torch.autograd.Function``s.  Forward over
reverse (``torch.func.jvp`` of ``torch.func.grad``: the Hessian-vector
product of ``gain_quadratic``) needs each Function's ``jvp`` rule AND a
backward whose ops carry the outer tangent.  A dropped tangent gives a
wrong product rather than an error, so every check here compares
values:

* the Functions' ``jvp`` (and the HVP through their backward) against
  ``torch.func`` of the plain versions (``ref.py``), whose every op has
  PyTorch's own forward-mode rule — fp32 within ``rtol = 1e-5`` and
  ``atol = 1e-5 · max|want|`` of each output (the Functions' backwards
  form dS = P ⊙ (dP − rowsum(dO ⊙ O)), autograd's softmax rule another
  expression, and where the exact value is 0 — a query that sees only
  itself — both leave rounding of the operands' scale), also under
  ``vmap``, with one forward per call;
* the HVP of ``reduced(smollm-135m)``'s loss against ``jax.jvp`` of
  ``jax.grad`` of the JAX model on the same weights, each leaf within
  ``1e-5 · max|Hv|`` of that leaf (the tolerance of the gradient's own
  check in tests/test_torch_train.py);
* two ``gain_quadratic(lam=0.01)`` steps with m = 2 against the JAX
  step, under the parity contract of tests/test_torch_train.py.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.api import StepOptions as JStepOptions
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core.api import StepOptions, make_triggered_train_step
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.fused_ce import ref as ce_ref
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention import ref as swa_ref
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils import tree as T
from test_torch_train import LR, _batch, _check_step, _leaves, _models

torch.set_num_threads(1)

RTOL = 1e-5
CE_SHAPES = [(37, 16, 50), (130, 48, 700)]
SWA_SHAPES = [(2, 20, 4, 2, 64, 7), (1, 33, 2, 1, 128, 64)]


def _rng_tensors(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)) for s in shapes]


def _ce_inputs(t, d, v, seed):
    x, tbl, dx, dt = _rng_tensors(seed, (t, d), (v, d), (t, d), (v, d))
    tbl = 0.2 * tbl
    lab = torch.from_numpy(
        np.random.default_rng(seed + 1).integers(0, v, t).astype(np.int64))
    return x, tbl, lab, dx, dt


def _swa_inputs(b, s, h, kv, hd, seed):
    return _rng_tensors(seed, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                        (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))


def _close(got, want):
    want = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("t,d,v", CE_SHAPES)
def test_fused_ce_jvp_and_hvp_match_plain(t, d, v):
    x, tbl, lab, dx, dt = _ce_inputs(t, d, v, seed=t)
    jvp = lambda f: torch.func.jvp(lambda a, b: f(a, b, lab), (x, tbl),
                                   (dx, dt))
    (o, do), (o_ref, do_ref) = jvp(ce_ops.fused_ce_nll), jvp(ce_ref.fused_ce_ref)
    _close(o, o_ref)
    _close(do, do_ref)
    # forward over reverse: the tangent runs through the plain backward,
    # including the saved logsumexp's
    loss = lambda f: (lambda p: (f(p[0], p[1], lab) ** 2).mean())
    hvp = lambda f: torch.func.jvp(torch.func.grad(loss(f)), ((x, tbl),),
                                   ((dx, dt),))[1]
    for got, want in zip(hvp(ce_ops.fused_ce_nll), hvp(ce_ref.fused_ce_ref)):
        _close(got, want)


@pytest.mark.parametrize("b,s,h,kv,hd,w", SWA_SHAPES)
def test_swa_attention_jvp_and_hvp_match_plain(b, s, h, kv, hd, w):
    q, k, v, dq, dk, dv = _swa_inputs(b, s, h, kv, hd, seed=s)
    jvp = lambda f: torch.func.jvp(lambda *a: f(*a, window=w), (q, k, v),
                                   (dq, dk, dv))
    (o, do), (o_ref, do_ref) = (jvp(swa_ops.swa_attention),
                                jvp(swa_ref.swa_attention_ref))
    _close(o, o_ref)
    _close(do, do_ref)
    loss = lambda f: (lambda p: (f(*p, window=w) ** 2).sum())
    hvp = lambda f: torch.func.jvp(torch.func.grad(loss(f)), ((q, k, v),),
                                   ((dq, dk, dv),))[1]
    for got, want in zip(hvp(swa_ops.swa_attention),
                         hvp(swa_ref.swa_attention_ref)):
        _close(got, want)


def _counting(monkeypatch):
    """Count the plain forwards that stand in for the kernels' launches."""
    calls = {"ce": 0, "swa": 0}
    ce_plain, swa_plain = ce_ops.fused_ce_lse_ref, swa_ops.swa_attention_ref

    def ce(*a, **kw):
        calls["ce"] += 1
        return ce_plain(*a, **kw)

    def swa(*a, **kw):
        calls["swa"] += 1
        return swa_plain(*a, **kw)

    monkeypatch.setattr(ce_ops, "fused_ce_lse_ref", ce)
    monkeypatch.setattr(swa_ops, "swa_attention_ref", swa)
    return calls


def test_vmapped_hvp_runs_each_forward_once_and_matches_plain(monkeypatch):
    """``vmap`` over agents of the HVP (as ``gain_quadratic`` maps it):
    one forward per kernel call, and each agent's product equal to the
    plain functions' per agent."""
    q, k, v, _, _, _ = _swa_inputs(1, 24, 4, 2, 64, seed=3)
    x, tbl, lab, _, _ = _ce_inputs(24, 64, 90, seed=4)
    wq = _rng_tensors(5, (64, 64), scale=0.1)[0]

    def loss(attn, ce):
        def f(p, xb):
            h = attn(q + (xb @ p["wq"])[None, :, None, :], k, v, window=9)
            return ce(h[0, :, 0] + xb, p["tbl"], lab).mean()
        return f

    params = {"wq": wq, "tbl": tbl}
    xs = torch.stack([x, 0.5 * x])
    tans = {"wq": torch.stack(_rng_tensors(6, (64, 64), (64, 64))),
            "tbl": torch.stack(_rng_tensors(7, (90, 64), (90, 64)))}

    def hvps(f):
        one = lambda t, xb: torch.func.jvp(
            lambda p: torch.func.grad(f)(p, xb), (params,), (t,))[1]
        return torch.func.vmap(one)(tans, xs)

    calls = _counting(monkeypatch)
    got = hvps(loss(swa_ops.swa_attention, ce_ops.fused_ce_nll))
    assert calls == {"ce": 1, "swa": 1}
    want = hvps(loss(swa_ref.swa_attention_ref, ce_ref.fused_ce_ref))
    for name in params:
        _close(got[name], want[name])


def test_backward_records_nothing_for_a_second_reverse_pass():
    """The gradient-only path keeps its memory: with ``create_graph``
    (as ``torch.func.grad`` runs it) the backwards record no graph."""
    x, tbl, lab, _, _ = _ce_inputs(16, 8, 20, seed=9)
    q, k, v, _, _, _ = _swa_inputs(1, 8, 2, 1, 64, seed=9)
    for f, leaf in ((lambda a: (ce_ops.fused_ce_nll(a, tbl, lab) ** 2).sum(),
                     x),
                    (lambda a: (swa_ops.swa_attention(a, k, v, window=4)
                                ** 2).sum(), q)):
        leaf = leaf.clone().requires_grad_(True)
        g, = torch.autograd.grad(f(leaf), leaf, create_graph=True)
        assert g.grad_fn is None and not g.requires_grad


# ----------------------------------------------------------------------
# the LM loss's HVP and the gain_quadratic step against the JAX package
# ----------------------------------------------------------------------

def test_lm_hvp_matches_jax():
    jm, tm, jp = _models()
    batch = {k: v[0] for k, v in _batch(1, 2, 16, 21).items()}
    rng = np.random.default_rng(22)
    jtan = jax.tree_util.tree_map(
        lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(jp))
    want = _leaves(jax.device_get(jax.jvp(
        lambda p: jax.grad(jm.loss_fn)(p, batch), (jp,), (jtan,))[1]))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    ttan = convert.params_from_jax(jtan, device="cpu")
    tb = convert.to_torch(batch, "cpu")
    got = torch.func.jvp(lambda p: torch.func.grad(tm.loss_fn)(p, tb),
                         (tp,), (ttan,))[1]
    got = dict(T.tree_flatten_with_path(got))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape, path
        assert bool(torch.isfinite(g).all()), path
        atol = 1e-5 * float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=str(path))


@functools.lru_cache(maxsize=None)
def _jax_quadratic_terms_fn():
    """Per agent, from the JAX package's own loss: the gradient and the
    quadratic gain −ε‖g‖² + (ε²/2)·gᵀHg (to vet a differing decision)."""
    jm = _models()[0]

    def one(params, b):
        g = jax.grad(jm.loss_fn)(params, b)
        _, hg = jax.jvp(lambda p: jax.grad(jm.loss_fn)(p, b), (params,), (g,))
        dot = lambda a, c: sum(jax.numpy.vdot(x, y) for x, y in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(c)))
        return g, -LR * dot(g, g) + 0.5 * LR * LR * dot(g, hg)

    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


def _jax_quadratic_terms(params, batch):
    grads, gains = jax.device_get(_jax_quadratic_terms_fn()(params, batch))
    return _leaves(grads), np.asarray(gains)


def test_gain_quadratic_steps_match_jax(monkeypatch):
    """2 ``gain_quadratic(lam=0.01)`` steps, m = 2, each from the JAX
    step's state: gains, gates, metrics and params held to the JAX step;
    the HVP's forward runs each kernel once per call under ``vmap``."""
    policy = "gain_quadratic(lam=0.01)"
    jm, tm, jp = _models()
    jcfg = JTrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=policy)
    tcfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=policy)
    jo, to = jopt.from_config(jcfg), opt_lib.from_config(tcfg)
    jstep = jax.jit(jmake(jm.loss_fn, jo, jcfg,
                          options=JStepOptions(agent_metrics=True)))
    tstep = make_triggered_train_step(tm.loss_fn, to, tcfg, device="cpu",
                                      options=StepOptions(agent_metrics=True))
    jstate = jinit(jp, jo, jcfg)
    calls = _counting(monkeypatch)
    outcomes = []
    for k in range(2):
        batch = _batch(2, 2, 16, 200 + k)
        tstate = convert.state_from_jax(jax.device_get(jstate), device="cpu")
        before = dict(calls)
        tnext, tmet = tstep(tstate, convert.to_torch(batch, "cpu"))
        # gradient prologue + the HVP's forward: 2 calls of each kernel
        assert calls["ce"] - before["ce"] == 2
        assert calls["swa"] - before["swa"] == 2 * tm.cfg.num_layers
        jnext, jmet = jax.device_get(jstep(jstate, batch))
        assert tnext.step == k + 1
        assert bool(torch.isfinite(tmet["mean_gain"]))
        assert math.isfinite(float(tmet["loss"]))
        terms = functools.partial(_jax_quadratic_terms, jstate.params, batch)
        outcomes.append(_check_step(policy, tnext, tmet, jnext, jmet, terms))
        jstate = jnext
    assert outcomes.count("checked") >= 1, outcomes
