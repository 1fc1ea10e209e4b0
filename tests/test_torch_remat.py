"""Rematerialisation in the port (``repro_torch.utils.remat.checkpoint``,
``ModelConfig.remat``) against its own plain path and the JAX package's
``jax.checkpoint``, on the CPU.

* ``checkpoint`` alone: on a toy block that calls the ``swa_attention``
  and ``fused_ce`` wrappers (their plain versions here), the values,
  gradients under ``vmap(grad_and_value)`` and Hessian-vector products
  under ``jvp(grad)`` (and its ``vmap``) are bitwise the plain block's;
  only the block's inputs outlive its forward; each kernel runs once
  per call under ``vmap`` (twice with the recompute).
* Each family (dense, moe, hybrid, ssm, audio, vlm; reduced configs,
  JAX's weights and ``lm_batch``): one ``gain_lookahead(lam=0.01)|
  int8+ef`` step with m = 2 and ``remat=True`` is bitwise the port's
  ``remat=False`` step, and matches the JAX package's ``remat=True``
  step (its ``unroll`` path) under the parity contract at the family's
  own tolerance (the dense/moe/vlm checks of tests/test_torch_train.py,
  the hybrid's 2.5e-4, xlstm's 2.5e-5 and whisper's 2.5e-4 of a leaf's
  max; ROADMAP §3); whisper also with ``attn_q_block`` set, so that its
  encoder and cross-attention run checkpointed ``attend_blockwise``.
"""
import functools
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core.api import make_triggered_train_step
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models import build
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils import tree as T
from repro_torch.utils.remat import checkpoint
from test_torch_hvp import _counting
from test_torch_hybrid import _check_hybrid_step
from test_torch_moe import LR, lm_batches, step_parity
from test_torch_train import _check_step

torch.set_num_threads(1)

POLICY = "gain_lookahead(lam=0.01)|int8+ef"

# ----------------------------------------------------------------------
# the checkpoint primitive
# ----------------------------------------------------------------------

D, H, KV, HD, V = 32, 4, 2, 16, 40


def _toy_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"w1": (D, D), "wq": (D, H * HD), "wk": (D, KV * HD),
              "wv": (D, KV * HD), "wo": (H * HD, D), "table": (V, D)}
    return {k: torch.from_numpy((0.2 * rng.standard_normal(s)).astype(
        np.float32)) for k, s in shapes.items()}


def _toy_batch(seed: int, agents: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal(
                (agents, 2, 12, D)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, V, (agents, 2, 12)))}


def _toy_block(p, x, labels, note):
    """A tree in (a parameter dict, the carry, int labels, a ``None``
    leaf), a tree out (the carry, a tensor aux from ``fused_ce``, a
    float): attention through the ``swa_attention`` wrapper."""
    assert note is None
    h = torch.tanh(x @ p["w1"])
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, H, HD)
    k = (h @ p["wk"]).reshape(b, s, KV, HD)
    v = (h @ p["wv"]).reshape(b, s, KV, HD)
    o = swa_ops.swa_attention(q, k, v, window=5).reshape(b, s, H * HD)
    out = x + o @ p["wo"]
    nll = ce_ops.fused_ce_nll(out.reshape(-1, D), p["table"],
                              labels.reshape(-1))
    return out, (nll.mean(), 0.5)


def _toy_loss(block, layers: int = 3):
    def loss(params, batch):
        x, aux = batch["x"], 0.0
        for _ in range(layers):
            x, (a, c) = block(params, x, batch["y"], None)
            aux = aux + c * a
        nll = ce_ops.fused_ce_nll(x.reshape(-1, D), params["table"],
                                  batch["y"].reshape(-1))
        return nll.mean() + 0.1 * aux

    return loss


PLAIN, REMAT = _toy_loss(_toy_block), _toy_loss(checkpoint(_toy_block))


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(T.tree_leaves(a),
                                                  T.tree_leaves(b)))


def test_checkpoint_gradients_are_bitwise_the_plain_blocks():
    params, batch = _toy_params(0), _toy_batch(1)
    grads = {name: torch.func.vmap(torch.func.grad_and_value(loss),
                                   in_dims=(None, 0))(params, batch)
             for name, loss in (("plain", PLAIN), ("remat", REMAT))}
    (g_p, v_p), (g_r, v_r) = grads["plain"], grads["remat"]
    assert torch.equal(v_p, v_r) and _equal_trees(g_p, g_r)
    assert all(float(g.abs().max()) > 0 for g in g_r.values())
    # unbatched, and the forward alone
    one = {k: v[0] for k, v in batch.items()}
    assert _equal_trees(torch.func.grad(PLAIN)(params, one),
                        torch.func.grad(REMAT)(params, one))
    assert torch.equal(PLAIN(params, one), REMAT(params, one))


def test_checkpoint_hvp_is_bitwise_the_plain_blocks():
    """Forward over reverse, as ``gain_quadratic`` takes it: through the
    checkpoint's ``jvp`` rule and its first-order backward."""
    params, batch = _toy_params(2), _toy_batch(3)
    tangent = _toy_params(4)

    def hvp(loss):
        def one(b):
            return torch.func.jvp(lambda p: torch.func.grad(loss)(p, b),
                                  (params,), (tangent,))[1]
        return one

    one = {k: v[0] for k, v in batch.items()}
    h_p, h_r = hvp(PLAIN)(one), hvp(REMAT)(one)
    assert _equal_trees(h_p, h_r)
    assert all(float(h.abs().max()) > 0 for h in h_r.values())
    assert _equal_trees(torch.func.vmap(hvp(PLAIN))(batch),
                        torch.func.vmap(hvp(REMAT))(batch))


def test_checkpoint_keeps_only_the_inputs():
    """Between the forward and the backward, the plain blocks' hidden
    activations stay alive; the checkpointed ones' do not, not even
    those of the recompute."""
    refs, alive = [], []

    def block(p, x):
        alive.append(sum(r() is not None for r in refs))
        h = torch.tanh(x @ p["w1"])
        refs.append(weakref.ref(h))
        return x + h @ p["wo"][:D]

    def loss(blk):
        def f(p, x):
            for _ in range(4):
                x = blk(p, x)
            return x.square().mean()
        return f

    params, x = _toy_params(5), _toy_batch(6)["x"]
    counts = {}
    for name, blk in (("plain", block), ("remat", checkpoint(block))):
        refs.clear()
        alive.clear()
        torch.func.vmap(torch.func.grad(loss(blk)), in_dims=(None, 0))(
            params, x)
        counts[name] = list(alive)
    assert counts["plain"] == [0, 1, 2, 3]
    assert counts["remat"] == [0] * 8  # 4 forwards, 4 recomputes


def test_checkpoint_runs_each_kernel_once_per_call_under_vmap(monkeypatch):
    """Under ``vmap(grad_and_value)`` over 3 agents, each checkpointed
    block calls each kernel's wrapper once in its forward and once in
    its recompute: the generated vmap rule keeps the kernels' own."""
    params, batch = _toy_params(7), _toy_batch(8)
    calls = _counting(monkeypatch)
    torch.func.vmap(torch.func.grad_and_value(PLAIN), in_dims=(None, 0))(
        params, batch)
    assert calls == {"ce": 4, "swa": 3}
    calls.update(ce=0, swa=0)
    torch.func.vmap(torch.func.grad_and_value(REMAT), in_dims=(None, 0))(
        params, batch)
    assert calls == {"ce": 7, "swa": 6}


def test_no_path_calls_torch_utils_checkpoint(monkeypatch):
    """``torch.utils.checkpoint`` refuses the step's ``torch.func``
    transforms; a remat step and the blockwise attention never call
    it."""
    import torch.utils.checkpoint as tuc

    def refuse(*a, **kw):
        raise AssertionError("torch.utils.checkpoint was called")

    for name in ("checkpoint", "checkpoint_sequential"):
        monkeypatch.setattr(tuc, name, refuse)
    jm, tm, jp = _family("audio_qblock")
    batch = convert.to_torch(_batches("audio_qblock")[0], "cpu")
    _port_step(tm.cfg, remat=True)(_port_state(jp), batch)


# ----------------------------------------------------------------------
# the six families: remat against the plain step and against JAX
# ----------------------------------------------------------------------

STEP_TOLS = {"hybrid": 2.5e-4, "ssm": 2.5e-5, "audio": 2.5e-4,
             "audio_qblock": 2.5e-4}
FAMILIES = {
    "dense": ("smollm-135m", {}),
    "moe": ("mixtral-8x7b", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "ssm": ("xlstm-350m", {}),
    "audio": ("whisper-medium", {}),
    # 16 frames and 16 decoder tokens in blocks of 8 queries: the
    # encoder's self-attention and the cross-attention run blockwise
    "audio_qblock": ("whisper-medium", {"attn_q_block": 8}),
    "vlm": ("phi-3-vision-4.2b", {}),
}


@functools.lru_cache(maxsize=None)
def _family(name: str):
    """(JAX model with ``remat``, port model with ``remat``, JAX
    params): reduced configs."""
    arch, over = FAMILIES[name]
    jm = jax_build(jax_reduced(jax_get_config(arch)).replace(remat=True,
                                                            **over))
    tm = build(reduced(get_config(arch)).replace(remat=True, **over))
    jp, _ = jm.init(jax.random.key(0))
    return jm, tm, jp


@functools.lru_cache(maxsize=None)
def _batches(name: str):
    return lm_batches(_family(name)[0], 2, 2, 16, (600,))


def _port_step(cfg, *, remat: bool):
    tcfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=POLICY)
    model = build(cfg.replace(remat=remat))
    return make_triggered_train_step(model.loss_fn, opt_lib.from_config(tcfg),
                                     tcfg, device="cpu")


def _port_state(jp):
    from repro_torch.core.api import init_train_state

    tcfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=2, comm=POLICY)
    params = convert.params_from_jax(jax.device_get(jp), device="cpu")
    return init_train_state(params, opt_lib.from_config(tcfg), tcfg,
                            device="cpu")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_step_is_bitwise_the_plain_step(family):
    jm, tm, jp = _family(family)
    batch = convert.to_torch(_batches(family)[0], "cpu")
    state = _port_state(jp)
    (a, ma), (b, mb) = (_port_step(tm.cfg, remat=r)(state, batch)
                        for r in (False, True))
    assert tm.cfg.remat and a.step == b.step == 1
    for name in ("params", "ef_memory"):
        assert _equal_trees(getattr(a, name), getattr(b, name)), name
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_step_matches_jax_remat(family):
    jm, tm, jp = _family(family)
    tol = STEP_TOLS.get(family)
    check = (_check_step if tol is None
             else functools.partial(_check_hybrid_step, tol=tol))
    outcomes = step_parity(jm, tm, jp, POLICY, _batches(family), check=check)
    assert outcomes == ["checked"], outcomes


# the swa_attention calls of one m = 2 step per checkpointed attention
# site: the loss's forward and the lookahead probe, plus the recompute
# under remat; with gain_quadratic the HVP's forward, and under remat
# its jvp rule's and its backward's recomputes too
SWA_PER_SITE = {("gain_lookahead(lam=0.01)|int8+ef", False): 2,
                ("gain_lookahead(lam=0.01)|int8+ef", True): 3,
                ("gain_quadratic(lam=0.01)|int8+ef", False): 2,
                ("gain_quadratic(lam=0.01)|int8+ef", True): 5}


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_launches_per_step(family, monkeypatch):
    """The counts chip_smoke.py holds on the card: each causal
    self-attention in a checkpointed block runs once more per step
    (smollm-135m's 30 layers: 60 → 90 with the lookahead); the hybrid
    checkpoints its Mamba2 layers only, so its shared block's count
    does not move; ``fused_ce`` (outside every block) runs twice."""
    from repro_torch.models.transformer import group_bounds

    jm, tm, jp = _family(family)
    batch = convert.to_torch(_batches(family)[0], "cpu")
    sites = (len(group_bounds(tm.cfg.num_layers, tm.cfg.shared_attn_every))
             if family == "hybrid" else tm.cfg.num_layers)
    calls = _counting(monkeypatch)
    for (policy, remat), per_site in SWA_PER_SITE.items():
        tcfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=2,
                           comm=policy)
        model = build(tm.cfg.replace(remat=remat))
        step = make_triggered_train_step(
            model.loss_fn, opt_lib.from_config(tcfg), tcfg, device="cpu")
        calls.update(ce=0, swa=0)
        step(_port_state(jp), batch)
        if family == "hybrid":
            per_site = 2
        assert calls == {"ce": 2, "swa": per_site * sites}, (policy, remat)
