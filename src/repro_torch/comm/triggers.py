"""Trigger stage — the paper's transmit decision as a registry family.

The port of ``repro.comm.triggers``.  A trigger decides, from each
agent's *local* information only, whether its gradient is informative
enough to transmit (paper eq. 11), and returns ``(alpha, gain)``:
``alpha ∈ {0., 1.}`` is the decision and ``gain`` the estimated
performance gain ``J(w − ε g) − J(w)`` (negative = improvement).

Agent-batched protocol.  Where the JAX trigger maps ONE agent's
``(params, grad, batch, local_loss, step[, scale])`` and is vmapped
over agents, the port's trigger takes the whole block of agents at
once: ``grads`` leaves and ``batch`` leaves carry a leading agent axis
``A``, ``losses`` is ``(A,)``, and the outputs are ``(A,)`` vectors.
``params`` and ``step`` (a Python int) are shared.

Prologue/epilogue split (as in the JAX package):

* ``trig.prologue(params, grads, batch, losses) -> (A,) f32`` — the
  threshold-independent gain precursor (lookahead probe, HVP + fused
  ``gain_reduce`` reduction, ‖g‖²);
* ``trig.prologue_key`` — its identity within one stage bank, so one
  evaluation serves every branch that shares it;
* ``trig(..., pre=...)`` gates a precomputed precursor; without it the
  trigger recomputes the precursor with the same ops.

With ``kernel=true``, ``gain_quadratic`` and ``grad_norm`` reduce
``(gᵀg, gᵀHg)`` for ALL agents in ONE call of the batched
``gain_reduce`` kernel on the stacked ``(A, n)`` gradient rows.

Every trigger of the JAX registry is ported: ``always``, ``never``,
``periodic``, ``grad_norm``, ``gain_lookahead``, ``gain_quadratic``, the
linear-regression closed forms ``gain_estimated`` (eq. 30) and
``gain_exact`` (eq. 28, with the problem oracle), and the closed-loop
budget controllers ``budget_dual`` and ``budget_window``.

**Controller-state protocol.**  An adaptive trigger (registry entry with
``adaptive=True``) takes the block's ``(A, CTRL_WIDTH)`` controller rows
before the optional ``scale`` and also returns the updated rows::

    trig(params, grads, batch, losses, step, ctrl[, scale])
        -> (TriggerOutput, new_ctrl)

A row is ``[λ, signal EWMA, |gain| EWMA]``; :func:`ctrl_init_row` is
the initial row, which every built adaptive trigger also carries as
``trig.ctrl0`` (the open-loop fallback when the state holds no
controller slot).  For an adaptive trigger ``scale`` multiplies the
TARGET (rate or bytes), not λ.  ``delivered`` (a lossy channel's
``(A,)`` {0, 1} delivery draw, taken before the trigger) makes the
controller observe ``alpha × delivered``: it prices DELIVERED
transmissions, so under loss it re-gates toward the delivered target.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm.registry import Registry, StageSpec
from repro_torch.sharding import blocks
from repro_torch.sharding.constraint import constrain_params
from repro_torch.utils.tree import (
    tree_add_scaled,
    tree_flatten_agents,
    tree_map,
)


class TriggerOutput(NamedTuple):
    alpha: torch.Tensor  # (A,) f32 in {0., 1.}
    gain: torch.Tensor   # (A,) f32 estimated J(w - eps g) - J(w)


TriggerFn = Callable[..., TriggerOutput]

TRIGGERS = Registry("trigger")

# shared parameter tables (order = positional-arg order in specs)
_GAIN_PARAMS = (("lam", 0.0), ("decay", "const"), ("decay_rate", 0.95))
_KERNEL = (("kernel", False),)

# per-agent controller row: [lam, signal_ewma, gain_mag_ewma] — ONE
# width for every adaptive trigger, so heterogeneous banks keep one
# uniform (m, CTRL_WIDTH) slot
CTRL_WIDTH = 3


def _f32(x: float) -> float:
    """``x`` rounded to float32 (exact as a Python float), so host-side
    constants combine in fp32 the way the JAX package's strong-f32
    scalars do."""
    return float(np.float32(x))


def spec_is_adaptive(spec: StageSpec) -> bool:
    """Does this trigger spec name a closed-loop (controller) trigger?"""
    return TRIGGERS.get(spec.name).adaptive


def _ctrl_row(lam0: float) -> torch.Tensor:
    """THE controller-row layout ``[λ, signal EWMA, |gain| EWMA]`` — the
    one constructor behind ``ctrl_init_row`` and every adaptive
    trigger's ``ctrl0``."""
    return torch.tensor([float(lam0), 0.0, 0.0], dtype=torch.float32)


def ctrl_init_row(spec: StageSpec) -> torch.Tensor:
    """The initial ``(CTRL_WIDTH,)`` controller row (on the CPU) for one
    trigger spec: adaptive triggers start at their ``lam0``, plain
    triggers get a zero row (their stages pass it through untouched)."""
    entry = TRIGGERS.get(spec.name)
    lam0 = entry.full_args(spec).get("lam0", 0.0) if entry.adaptive else 0.0
    return _ctrl_row(lam0)


class TriggerContext(NamedTuple):
    """Build-time dependencies a trigger may need (all optional)."""

    loss_fn: Optional[Callable] = None   # local empirical loss(params, batch)
    probe_eps: float = 1e-2              # ε of the probe step w − ε g
    oracle: Optional[tuple] = None       # (Σ, w*) for gain_exact
    # the policy's wire-compression ratio as a function of the gradient
    # dtype's dense bits (CompressorChain.ratio_for) — prices one
    # transmission for budget_window; None = uncompressed (ratio 1)
    ratio_for: Optional[Callable] = None


def build_trigger(spec: StageSpec,
                  ctx: TriggerContext = TriggerContext()) -> TriggerFn:
    """Resolve a trigger StageSpec against the registry."""
    entry = TRIGGERS.get(spec.name)
    return entry.builder(entry.full_args(spec), ctx)


def _scaled(threshold: float, scale):
    """Threshold × operating-point scale (a plain float when None)."""
    if scale is None:
        return threshold
    return threshold * torch.as_tensor(scale, dtype=torch.float32)


def lam_schedule(lam: float, decay: str, decay_rate: float):
    """λ_k schedule (paper's diminishing-λ remark, eq. 23), as fp32."""
    lam = np.float32(lam)
    if decay == "const":
        return lambda step: float(lam)
    if decay == "inv_t":
        return lambda step: float(lam / (np.float32(1.0) + np.float32(step)))
    if decay == "geometric":
        rate = np.float32(decay_rate)
        return lambda step: float(lam * rate ** np.float32(step))
    raise ValueError(f"unknown lam decay {decay!r}")


def _lam_at(args):
    return lam_schedule(args["lam"], args["decay"], args["decay_rate"])


def _gate(gain: torch.Tensor, threshold) -> torch.Tensor:
    """alpha = [gain ≤ −threshold] as f32."""
    return (gain <= -threshold).float()


def _gated(gain_of, lam_at, key):
    """A fixed-λ trigger over the gain precursor ``gain_of`` (its
    ``prologue``, identified within a bank by ``key``)."""

    def trig(params, grads, batch, losses, step, scale=None, *, pre=None):
        gain = gain_of(params, grads, batch, losses) if pre is None else pre
        return TriggerOutput(_gate(gain, _scaled(lam_at(step), scale)),
                             gain.float())

    trig.prologue = gain_of
    trig.prologue_key = key
    return trig


@TRIGGERS.register("always", doc="dense baseline: every agent transmits")
def _always(args, ctx):
    def trig(params, grads, batch, losses, step, scale=None):
        return TriggerOutput(torch.ones_like(losses), 0.0 * losses)

    trig.uses_batch = False
    return trig


@TRIGGERS.register("never", doc="silent baseline: nothing transmits")
def _never(args, ctx):
    def trig(params, grads, batch, losses, step, scale=None):
        return TriggerOutput(torch.zeros_like(losses), 0.0 * losses)

    trig.uses_batch = False
    return trig


@TRIGGERS.register("periodic", params=(("period", 1),),
                   doc="transmit every `period` steps")
def _periodic(args, ctx):
    period = max(int(args["period"]), 1)

    def trig(params, grads, batch, losses, step, scale=None):
        alpha = torch.full_like(losses, float(step % period == 0),
                                dtype=torch.float32)
        return TriggerOutput(alpha, torch.zeros_like(alpha))

    trig.uses_batch = False
    return trig


def _norm_sq(grads, use_kernel: bool) -> torch.Tensor:
    if use_kernel:
        return _tree_gain_terms(grads, grads)[:, 0]
    return blocks.per_agent_vdot(grads, grads)


def _tree_gain_terms(g, h) -> torch.Tensor:
    """``(A, 2)`` rows ``[gᵀg, gᵀh]`` over two per-agent trees from the
    ``gain_reduce`` kernel: one launch over every leaf, or on a mesh
    rank's model blocks one over the blocks (its rows summed over
    "model") and one over the leaves every model rank holds whole."""
    axis = blocks.model_axis()
    (gs, gw), (hs, hw) = blocks.split_leaves(g), blocks.split_leaves(h)
    if axis is None or not gs:
        return _fused_gain_terms(tree_flatten_agents(g),
                                 tree_flatten_agents(h))
    from repro_torch.sharding.collectives import _AllReduce

    terms = _AllReduce.apply(_fused_gain_terms(tree_flatten_agents(gs),
                                               tree_flatten_agents(hs)),
                             axis.where("block_vdot"))
    if gw:
        terms = terms + _fused_gain_terms(tree_flatten_agents(gw),
                                          tree_flatten_agents(hw))
    return terms


def _fused_gain_terms(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``(A, 2)`` rows ``[gᵀg, gᵀh]`` from ONE batched kernel call."""
    from repro_torch.kernels.gain_reduce import ops as gr_ops

    return gr_ops.gain_reduce(g, h)


@TRIGGERS.register("grad_norm", params=(("mu", 0.0),) + _KERNEL,
                   doc="eq. (31): transmit iff ||g||^2 >= mu")
def _grad_norm(args, ctx):
    mu = _f32(args["mu"])
    use_kernel = bool(args["kernel"])
    eps = _f32(ctx.probe_eps)

    def prologue(params, grads, batch, losses):
        return _norm_sq(grads, use_kernel)

    def trig(params, grads, batch, losses, step, scale=None, *, pre=None):
        gsq = prologue(None, grads, None, None) if pre is None else pre
        # the small-ε proxy gain −ε‖g‖² for logging parity
        return TriggerOutput((gsq >= _scaled(mu, scale)).float(),
                             -eps * gsq)

    trig.prologue = prologue
    trig.prologue_key = ("gsq", use_kernel)
    return trig


# the shared prologue identity of every lookahead-probe trigger
_LOOKAHEAD_KEY = ("lookahead_gain",)


def _lookahead_gain_fn(ctx: TriggerContext, who: str):
    """The eq.-(11) lookahead gain ``loss(w − ε g, batch) − loss(w)``
    for every agent: the user loss vmapped over the agents' probe
    points and batches."""
    if ctx.loss_fn is None:
        raise ValueError(f"{who} trigger needs loss_fn")
    loss_fn = ctx.loss_fn
    eps = _f32(ctx.probe_eps)

    def gain_of(params, grads, batch, losses):
        shared = tree_map(lambda v: v.unsqueeze(0), params)
        # the probe points are per agent: the JAX package pins them to
        # the data-free layout, as the gradients; here they are formed
        # there, from the gradients' blocks (no-ops without a hook)
        probes = tree_add_scaled(shared, constrain_params(grads, ""), -eps)
        probed = torch.func.vmap(loss_fn)(probes, batch)
        return probed - losses

    return gain_of


@TRIGGERS.register("gain_lookahead", params=_GAIN_PARAMS + _KERNEL,
                   doc="eq. (11) with gain = loss(w - eps g) - loss(w)")
def _gain_lookahead(args, ctx):
    return _gated(_lookahead_gain_fn(ctx, "gain_lookahead"), _lam_at(args),
                  _LOOKAHEAD_KEY)


@TRIGGERS.register("gain_quadratic", params=_GAIN_PARAMS + _KERNEL,
                   doc="eq. (28) for any smooth loss via HVP")
def _gain_quadratic(args, ctx):
    if ctx.loss_fn is None:
        raise ValueError("gain_quadratic trigger needs loss_fn")
    loss_fn = ctx.loss_fn
    eps, half_eps_sq = _eps_terms(np.float32(ctx.probe_eps))
    use_kernel = bool(args["kernel"])

    def hvp(params, g, b):
        # H g via forward-over-reverse, for one agent
        grad_fn = lambda p: torch.func.grad(loss_fn)(p, b)
        return torch.func.jvp(grad_fn, (params,), (g,))[1]

    def prologue(params, grads, batch, losses):
        # the tangent in the parameters' layout, and H g in the
        # gradient's (a mesh rank's model blocks; no-ops without a hook)
        hg = torch.func.vmap(hvp, in_dims=(None, 0, 0))(
            params, constrain_params(grads, ""), batch)
        if use_kernel:
            terms = _tree_gain_terms(grads, hg)
            gsq, ghg = terms[:, 0], terms[:, 1]
        else:
            gsq = blocks.per_agent_vdot(grads, grads)
            ghg = blocks.per_agent_vdot(grads, hg)
        return -eps * gsq + half_eps_sq * ghg

    return _gated(prologue, _lam_at(args), ("quadratic_gain", use_kernel))


def _batch_xs(batch) -> torch.Tensor:
    return batch[0] if isinstance(batch, (tuple, list)) else batch["xs"]


@TRIGGERS.register("gain_estimated", params=_GAIN_PARAMS,
                   doc="eq. (30): data-estimated quadratic gain (linreg)")
def _gain_estimated(args, ctx):
    eps = np.float32(ctx.probe_eps)

    def prologue(params, grads, batch, losses):
        return linreg_gain_estimated(params, grads, eps, _batch_xs(batch))

    return _gated(prologue, _lam_at(args), ("estimated_gain",))


@TRIGGERS.register("gain_exact", params=_GAIN_PARAMS,
                   doc="eq. (28) with the true distribution (needs oracle)")
def _gain_exact(args, ctx):
    if ctx.oracle is None:
        raise ValueError(
            "gain_exact trigger needs the problem oracle: pass "
            "oracle=(sigma, w_star) when building the policy/trigger"
        )
    sigma, w_star = (
        x.float() if isinstance(x, torch.Tensor)
        else torch.tensor(np.asarray(x, np.float32)) for x in ctx.oracle)
    if sigma.ndim == 1:
        sigma = torch.diag(sigma)
    eps = np.float32(ctx.probe_eps)

    def prologue(params, grads, batch, losses):
        dev = grads.device
        return linreg_gain_exact(params, grads, eps, sigma.to(dev),
                                 w_star.to(dev))

    return _gated(prologue, _lam_at(args), ("exact_gain",))


# ----------------------------------------------------------------------
# Budget-adaptive (closed-loop) triggers
# ----------------------------------------------------------------------

# λ step scale: η·(ĝ + RELAX·λ).  The |gain| EWMA ĝ makes η problem-
# scale-free; the λ-proportional term bounds the unwind of a λ pumped up
# by the early transient to a geometric decay once the gains collapse.
_LAM_RELAX = 0.25


def _lam_step_scale(eta, gmag, lam):
    return eta * (gmag + _LAM_RELAX * lam)


def _budget_decision(gain_of, params, grads, batch, losses, lam, pre):
    """The shared gate: transmit iff the lookahead gain ≤ −λ (λ from the
    controller rows); ``pre`` is the bank's precomputed probe gain."""
    gain = gain_of(params, grads, batch, losses) if pre is None else pre
    return (gain <= -lam).float(), gain


@TRIGGERS.register(
    "budget_dual",
    params=(("rate", 0.5), ("eta", 0.5), ("lam0", 0.0), ("beta", 0.1)),
    doc="closed loop on tx RATE: dual ascent on lam toward `rate`",
    adaptive=True,
)
def _budget_dual(args, ctx):
    gain_of = _lookahead_gain_fn(ctx, "budget_dual")
    rate, eta, beta = (_f32(args[k]) for k in ("rate", "eta", "beta"))

    def trig(params, grads, batch, losses, step, ctrl, scale=None, *,
             pre=None, delivered=None):
        lam, sig, gmag = ctrl.unbind(-1)
        alpha, gain = _budget_decision(gain_of, params, grads, batch, losses,
                                       lam, pre)
        # under a channel the controller observes DELIVERED transmissions
        obs = alpha if delivered is None else alpha * delivered
        # |gain| EWMA first: the very first rounds move at the problem's
        # scale; then dual ascent on λ (scale multiplies the TARGET)
        gmag = (1.0 - beta) * gmag + beta * gain.abs()
        lam = torch.clamp(
            lam + _lam_step_scale(eta, gmag, lam)
            * (obs - _scaled(rate, scale)), min=0.0)
        sig = (1.0 - beta) * sig + beta * obs  # realized-rate estimate
        return (TriggerOutput(alpha, gain.float()),
                torch.stack([lam, sig, gmag], -1).float())

    trig.ctrl0 = _ctrl_row(args["lam0"])
    trig.prologue = gain_of
    trig.prologue_key = _LOOKAHEAD_KEY
    return trig


@TRIGGERS.register(
    "budget_window",
    params=(("bytes", 0.0), ("window", 16), ("eta", 0.5), ("lam0", 0.0),
            ("beta", 0.1)),
    doc="closed loop on wire BYTES/round over an EWMA window",
    adaptive=True,
)
def _budget_window(args, ctx):
    gain_of = _lookahead_gain_fn(ctx, "budget_window")
    if float(args["bytes"]) <= 0.0:
        raise ValueError(
            "budget_window needs a positive bytes/round target, e.g. "
            "budget_window(bytes=44.8) — a zero target can only ratchet "
            "lambda up until the agent is permanently silent"
        )
    target = _f32(args["bytes"])
    window = _f32(max(float(args["window"]), 1.0))
    eta, beta = _f32(args["eta"]), _f32(args["beta"])
    ratio_for = ctx.ratio_for

    def trig(params, grads, batch, losses, step, ctrl, scale=None, *,
             pre=None, delivered=None):
        from repro_torch.comm.stats import (
            dense_bits,
            dense_entries,
            structural_bytes,
        )

        # one transmission's wire bytes: ONE agent's dense payload × the
        # policy's compression ratio (shapes and dtypes only; the whole
        # leaves' where the gradient is a mesh rank's model blocks)
        sizes = blocks.global_like(grads)
        cost = _f32(structural_bytes(sizes, per_agent=True) * (
            ratio_for(dense_bits(sizes),
                      entries=dense_entries(sizes, per_agent=True))
            if ratio_for is not None else 1.0))
        lam, meas, gmag = ctrl.unbind(-1)
        alpha, gain = _budget_decision(gain_of, params, grads, batch, losses,
                                       lam, pre)
        # dropped transmissions cost the byte budget nothing
        obs = alpha if delivered is None else alpha * delivered
        gmag = (1.0 - beta) * gmag + beta * gain.abs()
        # windowed bytes/round, then budget_dual's step with the byte
        # error priced back into rate units by the per-transmission cost
        meas = meas + (obs * cost - meas) / window
        lam = torch.clamp(
            lam + _lam_step_scale(eta, gmag, lam)
            * (meas - _scaled(target, scale)) / cost, min=0.0)
        return (TriggerOutput(alpha, gain.float()),
                torch.stack([lam, meas, gmag], -1).float())

    trig.ctrl0 = _ctrl_row(args["lam0"])
    trig.prologue = gain_of
    trig.prologue_key = _LOOKAHEAD_KEY
    return trig


# ----------------------------------------------------------------------
# Linear-regression closed forms (the paper's exact expressions)
# ----------------------------------------------------------------------

def _eps_terms(eps):
    """``(ε, ½ε²)`` as fp32-exact Python floats.  A ``np.float32`` ε
    squares in fp32 (the triggers' strongly typed ε); a Python float
    squares in double and rounds once (the simulator's weakly typed ε),
    as the JAX package's expressions do."""
    if isinstance(eps, np.float32):
        return float(eps), float(np.float32(0.5) * eps * eps)
    return _f32(eps), _f32(0.5 * eps ** 2)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def linreg_gain_exact(w, g, eps, sigma, w_star):
    """Eq. (28) with the *true* distribution, Σ = 𝔼xxᵀ ``(n, n)`` and w*:
    ∇J(w) = Σ(w − w*), ∇²J = Σ.  ``g`` is ``(..., n)`` (any leading
    agent/trial axes); ``w`` broadcasts against it."""
    e, half_e2 = _eps_terms(eps)
    grad_true = (w - w_star) @ sigma.T
    return _dot(-e * g, grad_true) + _dot(half_e2 * g, g @ sigma.T)


def linreg_gain_estimated(w, g, eps, xs):
    """Eq. (30): −ε gᵀ[I − (ε/2)(1/N)Σ x xᵀ]g, data only, computed as
    −ε‖g‖² + (ε²/2)·mean((xᵀg)²) — O(Nn).  ``g`` ``(..., n)``, ``xs``
    ``(..., N, n)``."""
    e, half_e2 = _eps_terms(eps)
    xg = (xs @ g[..., None])[..., 0]
    ghg = (xg * xg).mean(-1)
    return _dot(-e * g, g) + half_e2 * ghg
