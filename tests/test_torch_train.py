"""The port's LM train path against the JAX package's, on the CPU.

``reduced(smollm-135m)`` (2 layers, d 256, 4/2 heads of 64, vocab 512)
with the JAX package's weights (``convert.params_from_jax``) and
JAX-drawn ``lm_batch`` tokens.  On the CPU the loss runs the
``fused_ce`` kernel's plain version and the attention the
``swa_attention`` kernel's, each inside its autograd Function, so the
gradients here come from the Functions' plain backwards and the
per-agent ``vmap`` from their vmap rules.

Tolerances:

* loss within 1e-5 (fp32 on both sides, sums in other orders); each
  gradient leaf within ``atol = 1e-5 · max|g|`` of that leaf (the
  leaves' scales differ by orders of magnitude);
* triggered steps (each from the JAX step's previous state, so the gaps
  do not compound): ROADMAP's parity contract — params and float
  metrics within ``rtol = 1e-5, atol = 1e-6``, decisions exact except
  for a gain within 1e-5 of its threshold, EF memory within ``rtol =
  1e-5`` of each agent's ``max|g + ef|`` per leaf.  With an int8 wire,
  one more exemption of the same kind: the two packages' gradients
  differ by a few ULPs, so an element whose ``g + ef`` lies within
  ``1e-5 · max|g + ef|`` of an int8 rounding boundary (in the JAX
  package's values) may round to the neighbouring level — its EF memory
  and the parameter it updates then differ by up to one level.  Every
  other element keeps the contract;
* optimizers and schedules on a toy tree: ``rtol = 1e-6, atol = 1e-7``
  (fp32 arithmetic in the same order; ``pow``/``cos`` may differ by an
  ULP).
"""
import functools
import math
import re
from types import SimpleNamespace

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
from repro.models import layers as JL
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.comm import CommPolicy, from_train_config
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape, TrainConfig, TriggerConfig
from repro_torch.core.api import StepOptions, make_triggered_train_step
from repro_torch.data import synthetic as TD
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import steps as S
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.models import layers as TL
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import schedules
from repro_torch.utils import tree as T

torch.set_num_threads(1)

ARCH = "smollm-135m"
RTOL, ATOL = 1e-5, 1e-6
LR = 0.05
POLICIES = ("always", "gain_lookahead(lam=0.01)",
            "gain_lookahead(lam=0.01)|int8+ef")


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, port model, JAX params), reduced."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    jm, tm = jax_build(jcfg), build(reduced(get_config(ARCH)))
    jp, _ = jm.init(jax.random.key(0))
    return jm, tm, jp


def _batch(num_agents: int, per_agent: int, seq: int, seed: int) -> dict:
    """A JAX-drawn ``lm_batch``: leaves (num_agents, per_agent, seq)."""
    jm = _models()[0]
    shape = JInputShape("test", seq, num_agents * per_agent, "train")
    return jax.device_get(JD.lm_batch(jm.cfg, shape, jax.random.key(seed),
                                      num_agents=num_agents))


def _leaves(tree) -> dict:
    return dict(T.tree_flatten_with_path(convert.to_torch(tree, "cpu")))


# ----------------------------------------------------------------------
# the loss and its gradient
# ----------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradient_match_jax(masked):
    jm, tm, jp = _models()
    batch = {k: v[0] for k, v in _batch(1, 2, 32, 3).items()}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(0).random((2, 32))
                              < 0.7).astype(np.float32)
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, batch)
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(
        tp, convert.to_torch(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5
    want = _leaves(jax.device_get(jg))
    got = dict(T.tree_flatten_with_path(tg))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape, path
        atol = 1e-5 * float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=str(path))


def test_loss_runs_both_kernels_once_per_call(monkeypatch):
    """The loss is ``fused_ce`` on the output table and attention is
    ``swa_attention`` in every layer: one forward each per call, also
    under the per-agent ``vmap(grad)`` of the train step's prologue."""
    _, tm, jp = _models()
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    batch = convert.to_torch(_batch(2, 2, 16, 4), "cpu")
    calls = {"ce": 0, "swa": 0}
    ce_plain, swa_plain = ce_ops.fused_ce_lse_ref, swa_ops.swa_attention_ref

    def ce(*a, **k):
        calls["ce"] += 1
        return ce_plain(*a, **k)

    def swa(*a, **k):
        calls["swa"] += 1
        return swa_plain(*a, **k)

    monkeypatch.setattr(ce_ops, "fused_ce_lse_ref", ce)
    monkeypatch.setattr(swa_ops, "swa_attention_ref", swa)
    grads, losses = torch.func.vmap(torch.func.grad_and_value(tm.loss_fn),
                                    in_dims=(None, 0))(tp, batch)
    assert calls == {"ce": 1, "swa": tm.cfg.num_layers}
    assert losses.shape == (2,)
    one = {k: v[1] for k, v in batch.items()}
    assert torch.equal(losses[1], tm.loss_fn(tp, one))


def test_plain_cross_entropies_match_jax():
    """``layers.cross_entropy`` and ``cross_entropy_fused`` (the plain
    counterparts) against the JAX package's, with and without a mask,
    and the fused one over several sequence chunks."""
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((2, 24, 16))).astype(np.float32)
    tbl = (0.3 * rng.standard_normal((40, 16))).astype(np.float32)
    lab = rng.integers(0, 40, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.5).astype(np.float32)
    logits = np.einsum("bsd,vd->bsv", x, tbl)
    t = torch.from_numpy
    for m in (None, mask):
        tm_ = None if m is None else t(m)
        np.testing.assert_allclose(
            float(TL.cross_entropy(t(logits), t(lab), tm_)),
            float(JL.cross_entropy(logits, lab, m)), rtol=1e-6, atol=1e-6)
        for chunk in (512, 8):
            np.testing.assert_allclose(
                float(TL.cross_entropy_fused(t(tbl), t(x), t(lab), tm_,
                                             chunk=chunk)),
                float(JL.cross_entropy_fused(tbl, x, lab, m, chunk=chunk)),
                rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# the triggered train step
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_terms_fn():
    """Per agent, from the JAX package's own loss: the gradient and the
    lookahead gain (jitted once for every step and policy)."""
    jm = _models()[0]

    def one(params, b):
        loss, g = jax.value_and_grad(jm.loss_fn)(params, b)
        probe = jax.tree_util.tree_map(lambda p, x: p - LR * x, params, g)
        return g, jm.loss_fn(probe, b) - loss

    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


def _jax_agent_terms(params, batch, ef_prev):
    """The JAX package's per-agent ``g + ef`` (tensor leaves by path)
    and lookahead gains — only to vet an element or a decision that
    differs."""
    grads, gains = jax.device_get(_jax_terms_fn()(params, batch))
    g_eff = _leaves(grads)
    if ef_prev is not None:
        ef = _leaves(jax.device_get(ef_prev))
        g_eff = {p: g + ef[p] for p, g in g_eff.items()}
    return g_eff, np.asarray(gains)


def _int8_ties(g_eff: torch.Tensor) -> torch.Tensor:
    """Elements of an ``(A, ...)`` leaf within 1e-5·amax of an int8
    rounding boundary of their agent's per-tensor scale."""
    dims = tuple(range(1, g_eff.ndim))
    scale = g_eff.abs().amax(dim=dims, keepdim=True) / 127.0
    r = (g_eff / scale).abs()
    return ((r - r.floor() - 0.5).abs() <= 127.0 * RTOL)


def _check_step(policy, tnext, tmet, jnext, jmet, terms):
    lam = CommPolicy.parse(policy).trigger.arg("lam")
    tx_t, tx_j = tmet["agent_tx"].numpy(), np.asarray(jmet["agent_tx"])
    if not np.array_equal(tx_t, tx_j):
        _, gains = terms()
        odd = np.nonzero(tx_t != tx_j)[0]
        assert lam is not None and np.all(
            np.abs(gains[odd] + lam) <= RTOL * np.maximum(1, np.abs(gains[odd]))
        ), f"decisions differ away from the threshold: {tx_t} vs {tx_j}"
        return "near-threshold decision"
    for key in jmet:
        np.testing.assert_allclose(tmet[key].numpy(), np.asarray(jmet[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    int8 = "int8" in policy
    g_eff = terms()[0] if jnext.ef_memory is not None else None
    jp, tp = _leaves(jnext.params), dict(T.tree_flatten_with_path(
        tnext.params))
    if jnext.ef_memory is not None:
        je = _leaves(jnext.ef_memory)
        for path, got in T.tree_flatten_with_path(tnext.ef_memory):
            want = je[path]
            dims = tuple(range(1, want.ndim))
            scale = g_eff[path].abs().amax(dim=dims, keepdim=True)
            bad = (got - want).abs() > ATOL + RTOL * scale
            if int8:
                bad &= ~_int8_ties(g_eff[path])
            assert not bool(bad.any()), f"EF memory {path}"
    for path, want in jp.items():
        bad = ~torch.isclose(tp[path], want, rtol=RTOL, atol=ATOL)
        if int8:
            # an element one int8 level apart moves the aggregate there
            bad &= ~(_int8_ties(g_eff[path]) & (tmet["agent_tx"].reshape(
                (-1,) + (1,) * want.ndim) > 0)).any(0)
        assert not bool(bad.any()), f"params {path}"
    return "checked"


@pytest.mark.parametrize("policy", POLICIES)
def test_triggered_steps_match_jax(policy):
    """3 triggered steps, m = 2 agents, against JAX's homogeneous
    ``make_triggered_train_step(model.loss_fn, ...)``."""
    jm, tm, jp = _models()
    jcfg = JTrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=policy)
    tcfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=policy)
    jo, to = jopt.from_config(jcfg), opt_lib.from_config(tcfg)
    jstep = jax.jit(jmake(jm.loss_fn, jo, jcfg,
                          options=JStepOptions(agent_metrics=True)))
    tstep = make_triggered_train_step(tm.loss_fn, to, tcfg, device="cpu",
                                      options=StepOptions(agent_metrics=True))
    jstate = jinit(jp, jo, jcfg)
    outcomes = []
    for k in range(3):
        batch = _batch(2, 2, 16, 100 + k)
        tstate = convert.state_from_jax(jax.device_get(jstate), device="cpu")
        tnext, tmet = tstep(tstate, convert.to_torch(batch, "cpu"))
        jnext, jmet = jax.device_get(jstep(jstate, batch))
        assert tnext.step == k + 1 and math.isfinite(float(tmet["loss"]))
        terms = functools.partial(_jax_agent_terms, jstate.params, batch,
                                  jstate.ef_memory)
        outcomes.append(_check_step(policy, tnext, tmet, jnext, jmet, terms))
        jstate = jnext
    assert outcomes.count("checked") >= 2, outcomes


def test_build_train_step_is_the_triggered_step():
    """``steps.build_train_step`` wires ``model.loss_fn`` into the
    triggered step at the plan's agent count and compute dtype."""
    jm, tm, jp = _models()
    shape = InputShape("test", 16, 4, "train")
    plan = S.plan_run(tm.cfg, shape, num_agents=2, comm="always", lr=LR)
    assert plan.train_cfg.num_agents == 2 and plan.train_cfg.comm == "always"
    step = S.build_train_step(plan, compute_dtype="float32", device="cpu")
    direct = make_triggered_train_step(tm.loss_fn,
                                       opt_lib.from_config(plan.train_cfg),
                                       plan.train_cfg, device="cpu")
    tstate = convert.state_from_jax(
        jax.device_get(jinit(jp, jopt.sgd(LR), JTrainConfig(num_agents=2))),
        device="cpu")
    batch = convert.to_torch(_batch(2, 2, 16, 9), "cpu")
    (a, ma), (b, mb) = step(tstate, batch), direct(tstate, batch)
    for x, y in zip(T.tree_leaves(a.params), T.tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert all(torch.equal(ma[k], mb[k]) for k in mb)
    # the dry-run's serve and prefill steps (ROADMAP queue 1 item 12)
    assert callable(S.build_serve_step) and callable(S.build_prefill_step)


# ----------------------------------------------------------------------
# optimizers and schedules
# ----------------------------------------------------------------------

def _toy(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}


OPTIMIZERS = {
    "sgd": (lambda: jopt.sgd(0.1), lambda: opt_lib.sgd(0.1)),
    "momentum": (lambda: jopt.momentum(0.1, beta=0.9),
                 lambda: opt_lib.momentum(0.1, beta=0.9)),
    "nesterov": (lambda: jopt.momentum(0.1, beta=0.8, nesterov=True),
                 lambda: opt_lib.momentum(0.1, beta=0.8, nesterov=True)),
    "adamw": (lambda: jopt.adamw(jsched.cosine(0.01, 5), weight_decay=0.1),
              lambda: opt_lib.adamw(schedules.cosine(0.01, 5),
                                    weight_decay=0.1)),
    "adamw_clipped": (
        lambda: jopt.with_grad_clip(jopt.adamw(0.01, b2=0.99), 0.5),
        lambda: opt_lib.with_grad_clip(opt_lib.adamw(0.01, b2=0.99), 0.5)),
    "sgd_clipped": (lambda: jopt.with_grad_clip(jopt.sgd(0.1), 1.0),
                    lambda: opt_lib.with_grad_clip(opt_lib.sgd(0.1), 1.0)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_jax(name):
    """5 steps on a toy tree, each from the same gradients: updates and
    optimizer state agree with ``repro.optim``."""
    jmake_opt, tmake_opt = OPTIMIZERS[name]
    jo, to = jmake_opt(), tmake_opt()
    params = _toy(0)
    jstate = jo.init(params)
    tparams = convert.to_torch(params, "cpu")
    tstate = to.init(tparams)
    for k in range(5):
        grads = jax.tree_util.tree_map(lambda g: 3.0 * g, _toy(k + 1))
        jupd, jstate = jo.update(grads, jstate, params, jnp.int32(k))
        tupd, tstate = to.update(convert.to_torch(grads, "cpu"), tstate,
                                 tparams, k)
        for want, got in ((jupd, tupd), (jstate, tstate)):
            wl = jax.tree_util.tree_leaves(jax.device_get(want))
            gl = T.tree_leaves(got)
            assert len(wl) == len(gl)
            for w, g in zip(wl, gl):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, jupd)
        tparams = convert.to_torch(params, "cpu")


def test_clip_by_global_norm_matches_jax():
    grads = jax.tree_util.tree_map(lambda g: 4.0 * g, _toy(3))
    for max_norm in (0.0, 1.0, 100.0):
        want = jopt.clip_by_global_norm(grads, max_norm)
        got = opt_lib.clip_by_global_norm(convert.to_torch(grads, "cpu"),
                                          max_norm)
        for w, g in zip(jax.tree_util.tree_leaves(want), T.tree_leaves(got)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


SCHEDULES = {
    "constant": (lambda: jsched.constant(0.3), lambda: schedules.constant(0.3)),
    "linear_warmup": (
        lambda: jsched.linear_warmup(jsched.constant(0.3), 4),
        lambda: schedules.linear_warmup(schedules.constant(0.3), 4)),
    "cosine": (lambda: jsched.cosine(0.3, 7), lambda: schedules.cosine(0.3, 7)),
    "linear_decay": (lambda: jsched.linear_decay(0.3, 7, 0.2),
                     lambda: schedules.linear_decay(0.3, 7, 0.2)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    jfn, tfn = (f() for f in SCHEDULES[name])
    for step in range(10):
        np.testing.assert_allclose(tfn(step), float(jfn(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer,schedule,warmup,clip", [
    ("sgd", "constant", 0, 0.0), ("momentum", "cosine", 2, 0.0),
    ("adamw", "linear", 3, 1.0)])
def test_from_config_matches_jax(optimizer, schedule, warmup, clip):
    kw = dict(lr=0.02, optimizer=optimizer, schedule=schedule,
              warmup_steps=warmup, grad_clip=clip, total_steps=6)
    jo = jopt.from_config(JTrainConfig(**kw))
    to = opt_lib.from_config(TrainConfig(**kw))
    params = _toy(0)
    jstate, tstate = jo.init(params), to.init(convert.to_torch(params, "cpu"))
    for k in range(5):
        grads = _toy(k + 7)
        jupd, jstate = jo.update(grads, jstate, params, jnp.int32(k))
        tupd, tstate = to.update(convert.to_torch(grads, "cpu"), tstate,
                                 convert.to_torch(params, "cpu"), k)
        for w, g in zip(jax.tree_util.tree_leaves(jupd), T.tree_leaves(tupd)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


# ----------------------------------------------------------------------
# data, legacy flags and the CLI
# ----------------------------------------------------------------------

def test_lm_batch_layout_and_one_table_per_stream():
    cfg = reduced(get_config(ARCH))
    shape = InputShape("test", 12, 6, "train")
    stream = TD.batch_iterator(cfg, shape, num_agents=3, seed=1,
                               device="cpu")
    first, second = next(stream), next(stream)
    assert first["tokens"].shape == first["labels"].shape == (3, 2, 12)
    assert first["tokens"].dtype == torch.int32
    assert torch.equal(first["tokens"][..., 1:], first["labels"][..., :-1])
    assert not torch.equal(first["tokens"], second["tokens"])
    table = TD.markov_logits(cfg.vocab_size, TD.table_generator("cpu"))
    again = TD.lm_batch(cfg, shape, TD.step_generator(1, 1, "cpu"),
                        num_agents=3, logits=table)
    assert torch.equal(again["tokens"], second["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        TD.lm_batch(cfg, shape, TD.step_generator(1, 0, "cpu"),
                    num_agents=4, logits=table)


@pytest.mark.parametrize("quantize,topk,ef,want", [
    (False, 0.0, False, "gain_lookahead(lam=0.2)"),
    (True, 0.1, True, "gain_lookahead(lam=0.2)|int8+ef"),
    (False, 0.1, False, "gain_lookahead(lam=0.2)|topk(frac=0.1)")])
def test_legacy_flags_become_the_jax_spec(quantize, topk, ef, want):
    from repro.comm import from_train_config as jax_from_train_config

    trig = TriggerConfig(kind="gain_lookahead", lam=0.2)
    legacy = dict(quantize_grads=quantize, topk_frac=topk, error_feedback=ef)
    got = str(from_train_config(SimpleNamespace(trigger=trig, **legacy)))
    from repro.configs.base import TriggerConfig as JTriggerConfig

    jcfg = JTrainConfig(trigger=JTriggerConfig(kind="gain_lookahead",
                                               lam=0.2), **legacy)
    assert got == str(jax_from_train_config(jcfg)) == want


def test_train_cli_on_the_cpu(capsys):
    train_cli.main(["--device", "cpu", "--reduced", "--steps", "3", "--seq",
                    "16", "--batch", "4", "--agents", "2", "--log-every",
                    "1"])
    out = capsys.readouterr().out
    assert re.search(r"^arch=smollm-135m params≈1\.\dM agents=2 "
                     r"comm='gain_lookahead' device=cpu$", out,
                     re.M), out
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\S+)", out,
                                           re.M)]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses), out
    assert re.search(r"^done: 3 steps, transmissions \d+/6 \(\d+\.\d% of "
                     r"dense\), effective wire \d+\.\d\d MB$", out, re.M), out


def test_train_cli_raises_for_what_is_not_ported(tmp_path, capsys):
    """``--ckpt-dir`` is ported (it writes the bare TrainState at the
    last step; resume is held in tests/test_torch_session.py), and so is
    ``--microbatches``: two slices of each agent's batch train."""
    train_cli.main(["--device", "cpu", "--reduced", "--steps", "1",
                    "--seq", "8", "--batch", "2", "--ckpt-dir",
                    str(tmp_path)])
    assert f"checkpoint -> {tmp_path}" in capsys.readouterr().out
    manifest = checkpointer.read_manifest(str(tmp_path))
    assert manifest["step"] == 1 and manifest["paths"][0] == ".step"
    train_cli.main(["--device", "cpu", "--reduced", "--steps", "1",
                    "--seq", "8", "--batch", "2", "--microbatches", "2"])
    assert re.search(r"done: 1 steps, transmissions \d/1",
                     capsys.readouterr().out)
