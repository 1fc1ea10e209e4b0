"""The port's moe family (mixtral-8x7b, kimi-k2) against the JAX
package's, on the CPU.

Weights are the JAX package's (``convert.params_from_jax``), inputs are
drawn from a seed with numpy or by the JAX package's bigram chain.  On
the CPU the attention runs the ``swa_attention`` kernel's plain version
and the loss the ``fused_ce`` kernel's.

Tolerances (the parity contract):

* ``moe_layer``'s aux within ``rtol = 1e-5, atol = 1e-6``, its output
  within ``rtol = 1e-5`` and ``atol = 1e-5 · max|out|`` (the JAX init
  scales an expert weight by 1/√E, its leading axis, so outputs reach
  ~10³ and cancel in places: the rounding of a sum scales with its
  terms, not its result);
  the routed expert ids exactly, except where two experts' JAX router
  probabilities lie within 1e-6 of each other relative to their size (a
  near-tie a last-bit gap may flip); the dropped (token, k) pairs
  exactly;
* logits at ``LOGIT_TOL`` (``atol = rtol = 1e-5``, as
  tests/test_torch_lm.py), the loss within 1e-5, each gradient leaf
  within ``1e-5 · max|g|`` of that leaf; greedy tokens equal except at
  a near-tie of the JAX logits' top two (tests/test_torch_lm.py's
  ``NEAR_TIE``, 1e-4);
* triggered steps under tests/test_torch_train.py's ``_check_step``
  (decisions exact but at a gain on its threshold, floats within ``rtol
  = 1e-5, atol = 1e-6``, an int8 rounding midpoint one level apart).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.api import StepOptions as JStepOptions
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.data import synthetic as JD
from repro.models import build as jax_build
from repro.models import moe as JMOE
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core.api import StepOptions, make_triggered_train_step
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.models import moe as TMOE
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils import tree as T
from test_torch_lm import _assert_same_tokens, _axes_leaves
from test_torch_train import _check_step, _leaves

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
ROUTE_TIE = 1e-6
LR = 0.05
MOE_ARCHS = ("mixtral-8x7b", "kimi-k2-1t-a32b")


def _wide_kimi(cfg):
    """Reduced kimi with its own 384-way top-8 routing (narrow experts)."""
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=384, experts_per_token=8, d_ff_expert=16))


VARIANTS = {
    "mixtral": ("mixtral-8x7b", lambda c: c),
    "kimi": ("kimi-k2-1t-a32b", lambda c: c),
    "kimi-384-top8": ("kimi-k2-1t-a32b", _wide_kimi),
}


@functools.lru_cache(maxsize=None)
def _pair(variant: str):
    """(JAX model, port model, JAX params, port params), reduced."""
    arch, fn = VARIANTS[variant]
    jm = jax_build(fn(jax_reduced(jax_get_config(arch))))
    tm = build(fn(reduced(get_config(arch))))
    jp, _ = jm.init(jax.random.key(0))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, tm, jp, tp


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _x(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _layer0_moe(params):
    return jax.tree_util.tree_map(lambda t: t[0], params["blocks"]["moe"])


def _jax_routes(p, cfg, x: np.ndarray):
    """The JAX package's routing of ``moe_layer`` (its own ops): probs,
    expert ids, and the dropped (token, k) pairs."""
    moe = cfg.moe
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    _, ids = jax.lax.top_k(probs, moe.experts_per_token)
    return np.asarray(probs), np.asarray(ids), _dropped_pairs(
        np.asarray(ids), moe.num_experts,
        JMOE.capacity(xt.shape[0], moe.experts_per_token, moe.num_experts,
                      moe.capacity_factor))


def _dropped_pairs(ids: np.ndarray, num_experts: int, cap: int) -> set:
    """A numpy oracle: the (token, k) pairs past their expert's capacity,
    pairs taken in the stable order of their expert ids."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    seen = np.zeros(num_experts, np.int64)
    dropped = set()
    for j in order:
        e = flat[j]
        if seen[e] >= cap:
            dropped.add(divmod(int(j), ids.shape[1]))
        seen[e] += 1
    return dropped


def _port_dropped(experts: torch.Tensor, num_experts: int, cap: int) -> set:
    slot = TMOE.dispatch_slots(experts, num_experts, cap)
    k = experts.shape[1]
    return {divmod(int(j), k) for j in
            np.nonzero(slot.numpy() == num_experts * cap)[0]}


def _assert_same_routes(got: np.ndarray, want: np.ndarray,
                        probs: np.ndarray) -> int:
    """Expert ids equal, except where the swapped experts' probabilities
    are within ROUTE_TIE (relative) of each other.  Returns the count of
    such near-tie entries."""
    ties = 0
    for t, k in zip(*np.nonzero(got != want)):
        a, b = probs[t, got[t, k]], probs[t, want[t, k]]
        assert abs(a - b) <= ROUTE_TIE * max(a, b), (
            f"token {t}, k {k}: expert {got[t, k]} vs {want[t, k]} "
            f"(probs {a:.8g} vs {b:.8g})")
        ties += 1
    return ties


def _check_moe_layer(cfg_j, cfg_t, p_j, p_t, x: np.ndarray):
    jo, ja = jax.jit(lambda p, x: JMOE.moe_layer(p, cfg_j, x))(
        p_j, jnp.asarray(x))
    to, ta = TMOE.moe_layer(p_t, cfg_t, _t(x))
    probs, ids, dropped = _jax_routes(p_j, cfg_j, x)
    _, gates, experts = TMOE.route(p_t, cfg_t, _t(x).reshape(-1, x.shape[-1]))
    assert _assert_same_routes(experts.numpy(), ids, probs) == 0
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    moe = cfg_t.moe
    cap = TMOE.capacity(experts.shape[0], moe.experts_per_token,
                        moe.num_experts, moe.capacity_factor)
    assert _port_dropped(experts, moe.num_experts, cap) == dropped
    want = np.asarray(jo)
    np.testing.assert_allclose(to.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL, atol=ATOL)
    return dropped


# ----------------------------------------------------------------------
# capacity and the layer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0])
def test_capacity_matches_jax(factor):
    for t in (1, 4, 7, 64, 100, 1000, 4096, 65536):
        for k in (1, 2, 8):
            for e in (4, 8, 384):
                assert TMOE.capacity(t, k, e, factor) == \
                    JMOE.capacity(t, k, e, factor), (t, k, e, factor)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_layer_matches_jax(variant):
    """Output, aux, routing and the (empty or not) dropped set of the
    first layer's experts on N(0, 1) activations."""
    jm, tm, jp, tp = _pair(variant)
    x = _x(1, (2, 48, tm.cfg.d_model))
    _check_moe_layer(jm.cfg, tm.cfg, _layer0_moe(jp), _layer0_moe(tp), x)


@pytest.mark.parametrize("case", ["factor_0.25", "one_hot_expert"])
def test_capacity_drops_match_jax(case):
    """Tokens past capacity are dropped, the same (token, k) pairs as the
    JAX package's: a capacity factor of 0.25, and a router biased so that
    expert 0 takes nearly every token (far more than ``cap``)."""
    jm, tm, jp, _ = _pair("mixtral")
    p = jax.device_get(_layer0_moe(jp))
    cfg_j, cfg_t = jm.cfg, tm.cfg
    shift = 0.0
    if case == "factor_0.25":
        cfg_j = cfg_j.replace(moe=dataclasses.replace(cfg_j.moe,
                                                      capacity_factor=0.25))
        cfg_t = cfg_t.replace(moe=dataclasses.replace(cfg_t.moe,
                                                      capacity_factor=0.25))
    else:
        p = dict(p)
        p["router"] = np.array(p["router"])
        p["router"][:, 0] += 0.2
        shift = 1.0  # x·router[:, 0] gains 0.2·Σx ≈ 0.2·D
    x = _x(2, (4, 64, cfg_t.d_model)) + shift
    dropped = _check_moe_layer(cfg_j, cfg_t, p, convert.to_torch(p, "cpu"),
                               x)
    assert len(dropped) > 20, len(dropped)


def test_moe_layer_under_vmap_equals_a_loop():
    """``torch.func.vmap`` over 2 agents' activations (shared weights):
    each agent's output and aux equal the layer called on that agent
    alone (the train step's per-agent ``vmap(grad)``)."""
    _, tm, _, tp = _pair("kimi")
    p = _layer0_moe(tp)
    xs = _t(_x(3, (2, 2, 24, tm.cfg.d_model)))
    outs, auxes = torch.func.vmap(
        lambda x: TMOE.moe_layer(p, tm.cfg, x))(xs)
    for i in range(2):
        o, a = TMOE.moe_layer(p, tm.cfg, xs[i])
        np.testing.assert_allclose(outs[i].numpy(), o.numpy(), rtol=RTOL,
                                   atol=RTOL * float(o.abs().max()))
        np.testing.assert_allclose(float(auxes[i]), float(a), rtol=RTOL,
                                   atol=ATOL)


def test_combine_is_repeatable_and_sums_in_k_order():
    """Two calls are bitwise equal, and each token's output is its kept
    pairs' expert outputs weighted by their gates, summed over k."""
    _, tm, _, tp = _pair("mixtral")
    p = _layer0_moe(tp)
    x = _t(_x(4, (1, 40, tm.cfg.d_model)))
    a, _ = TMOE.moe_layer(p, tm.cfg, x)
    b, _ = TMOE.moe_layer(p, tm.cfg, x)
    assert torch.equal(a, b)
    xt = x[0]
    _, gates, experts = TMOE.route(p, tm.cfg, xt)
    want = torch.zeros_like(xt)
    for k in range(experts.shape[1]):
        e = experts[:, k]
        h = torch.nn.functional.silu(torch.einsum(
            "td,tdf->tf", xt, p["w_gate"][e])) * torch.einsum(
            "td,tdf->tf", xt, p["w_up"][e])
        want = want + gates[:, k:k + 1] * torch.einsum(
            "tf,tfd->td", h, p["w_down"][e])
    np.testing.assert_allclose(a[0].numpy(), want.numpy(), rtol=RTOL,
                               atol=RTOL * float(want.abs().max()))


# ----------------------------------------------------------------------
# model paths
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tokens(seq: int, vocab: int, batch: int = 2) -> np.ndarray:
    return np.asarray(JD.sample_lm_tokens(jax.random.key(7), batch, seq,
                                          vocab))


@pytest.mark.parametrize("variant", ["mixtral", "kimi"])
def test_forward_loss_and_gradient_match_jax(variant):
    """Logits and the summed aux of ``forward``; ``loss_fn`` (CE +
    router_aux_weight · aux) and its gradient, leaf by leaf."""
    jm, tm, jp, tp = _pair(variant)
    toks = _tokens(65, jm.cfg.vocab_size)
    want, want_aux = jax.jit(jm.forward)(
        jp, {"tokens": jnp.asarray(toks[:, :-1])})
    got, got_aux = tm.forward(tp, {"tokens": _t(toks[:, :-1])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, batch)
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(
        tp, convert.to_torch(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5
    want_g = _leaves(jax.device_get(jg))
    got_g = dict(T.tree_flatten_with_path(tg))
    assert got_g.keys() == want_g.keys()
    assert ("blocks", "moe", "router") in got_g
    for path, g in got_g.items():
        w = want_g[path]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("variant", ["mixtral", "kimi"])
def test_init_tree_matches_jax(variant):
    """Same paths, shapes and logical axes as JAX ``init``."""
    jm, tm, jp, _ = _pair(variant)
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


def test_prefill_and_greedy_decode_match_jax():
    """Reduced mixtral (W = 64): prefill of 100 tokens, then 8 greedy
    decode steps, each against the JAX package's; at decode T = B, so
    ``capacity`` gives its floor of 8."""
    jm, tm, jp, tp = _pair("mixtral")
    assert tm.cfg.swa_window == 64
    seq = 100
    toks = _tokens(seq, jm.cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=seq + 16)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, seq + 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    decode = jax.jit(jm.decode_step)
    want_logits = np.asarray(jl[:, -1])
    got_tok = tl[:, -1].argmax(-1).numpy()
    for i in range(8):
        _assert_same_tokens(got_tok, want_logits, i)
        tok = want_logits.argmax(-1)[:, None].astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(seq + i))
        tl, tc = tm.decode_step(tp, tc, _t(tok), seq + i)
        want_logits = np.asarray(jl[:, 0])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        got_tok = tl[:, 0].argmax(-1).numpy()
    np.testing.assert_array_equal(tc.pos_ids.numpy(), np.asarray(jc.pos_ids))


# ----------------------------------------------------------------------
# the triggered train step
# ----------------------------------------------------------------------

def lm_batches(jm, num_agents: int, per_agent: int, seq: int, seeds):
    """JAX-drawn ``lm_batch``es: leaves (num_agents, per_agent, seq)."""
    shape = JInputShape("test", seq, num_agents * per_agent, "train")
    return [jax.device_get(JD.lm_batch(jm.cfg, shape, jax.random.key(s),
                                       num_agents=num_agents))
            for s in seeds]


def _terms_fn(jm, lr: float, aux_loss_fn=None):
    """Per agent, from the JAX package's own loss: the gradient of the
    objective and the lookahead gain of the loss."""

    def one(params, b):
        loss, g = jax.value_and_grad(jm.loss_fn)(params, b)
        if aux_loss_fn is not None:
            g = jax.tree_util.tree_map(
                jnp.add, g, jax.grad(aux_loss_fn)(params, b))
        probe = jax.tree_util.tree_map(lambda p, x: p - lr * x, params, g)
        return g, jm.loss_fn(probe, b) - loss

    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


def step_parity(jm, tm, jp, policy: str, batches, *, aux=None,
                check=_check_step, microbatches: int = 1):
    """Triggered steps with m = 2 from the JAX step's state each round:
    the port's homogeneous step against JAX's ``unroll`` path (its
    reference loop over agents).  ``aux`` is a pair (JAX, port) of
    ``aux_loss_fn``s.  Returns the outcomes of ``check`` (by default
    tests/test_torch_train.py's ``_check_step``)."""
    jcfg = JTrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=policy,
                        microbatches=microbatches)
    tcfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=policy,
                       microbatches=microbatches)
    jo, to = jopt.from_config(jcfg), opt_lib.from_config(tcfg)
    jaux, taux = aux or (None, None)
    jstep = jax.jit(jmake(jm.loss_fn, jo, jcfg, policy=(policy, policy),
                          aux_loss_fn=jaux,
                          options=JStepOptions(hetero_dispatch="unroll",
                                               agent_metrics=True)))
    tstep = make_triggered_train_step(tm.loss_fn, to, tcfg, device="cpu",
                                      aux_loss_fn=taux,
                                      options=StepOptions(agent_metrics=True))
    terms_fn = _terms_fn(jm, LR, jaux)
    jstate = jinit(jp, jo, jcfg)
    outcomes = []
    for k, batch in enumerate(batches):
        tstate = convert.state_from_jax(jax.device_get(jstate), device="cpu")
        tnext, tmet = tstep(tstate, convert.to_torch(batch, "cpu"))
        jnext, jmet = jax.device_get(jstep(jstate, batch))
        assert tnext.step == k + 1 and math.isfinite(float(tmet["loss"]))

        def terms(state=jstate, batch=batch):
            grads, gains = jax.device_get(terms_fn(state.params, batch))
            g_eff = _leaves(grads)
            if state.ef_memory is not None:
                ef = _leaves(jax.device_get(state.ef_memory))
                g_eff = {p: g + ef[p] for p, g in g_eff.items()}
            return g_eff, np.asarray(gains)

        outcomes.append(check(policy, tnext, tmet, jnext, jmet, terms))
        jstate = jnext
    return outcomes


def test_triggered_steps_match_jax():
    """Two ``gain_lookahead(lam=0.01)|int8+ef`` steps, m = 2, reduced
    mixtral (its loss carries the router aux term)."""
    jm, tm, jp, _ = _pair("mixtral")
    batches = lm_batches(jm, 2, 2, 16, (100, 101))
    outcomes = step_parity(jm, tm, jp, "gain_lookahead(lam=0.01)|int8+ef",
                           batches)
    assert outcomes.count("checked") >= 1, outcomes


def test_step_with_an_aux_loss_fn_matches_jax():
    """``aux_loss_fn`` joins the differentiated objective, not the
    reported loss: one ``always`` step of reduced kimi with an L2 term on
    the router, against the JAX step with the same term."""
    jm, tm, jp, _ = _pair("kimi")
    batches = lm_batches(jm, 2, 2, 16, (102,))

    def jaux(params, batch):
        return 0.5 * jnp.sum(params["blocks"]["moe"]["router"] ** 2)

    def taux(params, batch):
        return 0.5 * torch.sum(params["blocks"]["moe"]["router"] ** 2)

    assert step_parity(jm, tm, jp, "always", batches,
                       aux=(jaux, taux)) == ["checked"]


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen",
                       "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch}") and "batch=2" in lines[0]
    generated = eval(lines[3].split("-> ")[1])
    assert len(generated) == 4 and all(0 <= t < 512 for t in generated)
