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

Ported: ``always``, ``never``, ``grad_norm``, ``gain_lookahead``,
``gain_quadratic``.  The other registry entries parse and render, and
raise ``NotImplementedError`` when built.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm.registry import Registry, StageSpec
from repro_torch.utils.todo import not_ported, todo
from repro_torch.utils.tree import (
    tree_add_scaled,
    tree_flatten_agents,
    tree_norm_sq,
    tree_vdot,
)


class TriggerOutput(NamedTuple):
    alpha: torch.Tensor  # (A,) f32 in {0., 1.}
    gain: torch.Tensor   # (A,) f32 estimated J(w - eps g) - J(w)


TriggerFn = Callable[..., TriggerOutput]

TRIGGERS = Registry("trigger")

# shared parameter tables (order = positional-arg order in specs)
_GAIN_PARAMS = (("lam", 0.0), ("decay", "const"), ("decay_rate", 0.95))
_KERNEL = (("kernel", False),)

# per-agent controller row width of the adaptive triggers
CTRL_WIDTH = 3

_ADAPTIVE_ITEM = "queue 1 item 4"


def _f32(x: float) -> float:
    """``x`` rounded to float32 (exact as a Python float), so host-side
    constants combine in fp32 the way the JAX package's strong-f32
    scalars do."""
    return float(np.float32(x))


def spec_is_adaptive(spec: StageSpec) -> bool:
    """Does this trigger spec name a closed-loop (controller) trigger?"""
    return TRIGGERS.get(spec.name).adaptive


class TriggerContext(NamedTuple):
    """Build-time dependencies a trigger may need (all optional)."""

    loss_fn: Optional[Callable] = None   # local empirical loss(params, batch)
    probe_eps: float = 1e-2              # ε of the probe step w − ε g
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
    raise todo("the 'periodic' trigger", _ADAPTIVE_ITEM)


def _norm_sq(grads, use_kernel: bool) -> torch.Tensor:
    if use_kernel:
        g = tree_flatten_agents(grads)
        return _fused_gain_terms(g, g)[:, 0]
    return tree_norm_sq(grads, per_agent=True)


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
        shared = {k: v.unsqueeze(0) for k, v in params.items()}
        probes = tree_add_scaled(shared, grads, -eps)
        probed = torch.func.vmap(loss_fn)(probes, batch)
        return probed - losses

    return gain_of


@TRIGGERS.register("gain_lookahead", params=_GAIN_PARAMS + _KERNEL,
                   doc="eq. (11) with gain = loss(w - eps g) - loss(w)")
def _gain_lookahead(args, ctx):
    gain_of = _lookahead_gain_fn(ctx, "gain_lookahead")
    lam_at = _lam_at(args)

    def trig(params, grads, batch, losses, step, scale=None, *, pre=None):
        gain = gain_of(params, grads, batch, losses) if pre is None else pre
        return TriggerOutput(_gate(gain, _scaled(lam_at(step), scale)),
                             gain.float())

    trig.prologue = gain_of
    trig.prologue_key = _LOOKAHEAD_KEY
    return trig


@TRIGGERS.register("gain_quadratic", params=_GAIN_PARAMS + _KERNEL,
                   doc="eq. (28) for any smooth loss via HVP")
def _gain_quadratic(args, ctx):
    if ctx.loss_fn is None:
        raise ValueError("gain_quadratic trigger needs loss_fn")
    loss_fn = ctx.loss_fn
    lam_at = _lam_at(args)
    eps32 = np.float32(ctx.probe_eps)
    eps = float(eps32)
    half_eps_sq = float(np.float32(0.5) * eps32 * eps32)
    use_kernel = bool(args["kernel"])

    def hvp(params, g, b):
        # H g via forward-over-reverse, for one agent
        grad_fn = lambda p: torch.func.grad(loss_fn)(p, b)
        return torch.func.jvp(grad_fn, (params,), (g,))[1]

    def prologue(params, grads, batch, losses):
        hg = torch.func.vmap(hvp, in_dims=(None, 0, 0))(params, grads, batch)
        if use_kernel:
            terms = _fused_gain_terms(tree_flatten_agents(grads),
                                      tree_flatten_agents(hg))
            gsq, ghg = terms[:, 0], terms[:, 1]
        else:
            gsq = tree_norm_sq(grads, per_agent=True)
            ghg = tree_vdot(grads, hg, per_agent=True)
        return -eps * gsq + half_eps_sq * ghg

    def trig(params, grads, batch, losses, step, scale=None, *, pre=None):
        gain = prologue(params, grads, batch, losses) if pre is None else pre
        return TriggerOutput(_gate(gain, _scaled(lam_at(step), scale)),
                             gain)

    trig.prologue = prologue
    trig.prologue_key = ("quadratic_gain", use_kernel)
    return trig


@TRIGGERS.register("gain_estimated", params=_GAIN_PARAMS,
                   doc="eq. (30): data-estimated quadratic gain (linreg)")
def _gain_estimated(args, ctx):
    raise todo("the 'gain_estimated' trigger", _ADAPTIVE_ITEM)


@TRIGGERS.register("gain_exact", params=_GAIN_PARAMS,
                   doc="eq. (28) with the true distribution (needs oracle)")
def _gain_exact(args, ctx):
    raise todo("the 'gain_exact' trigger", _ADAPTIVE_ITEM)


@TRIGGERS.register(
    "budget_dual",
    params=(("rate", 0.5), ("eta", 0.5), ("lam0", 0.0), ("beta", 0.1)),
    doc="closed loop on tx RATE: dual ascent on lam toward `rate`",
    adaptive=True,
)
def _budget_dual(args, ctx):
    raise todo("the adaptive 'budget_dual' trigger", _ADAPTIVE_ITEM)


@TRIGGERS.register(
    "budget_window",
    params=(("bytes", 0.0), ("window", 16), ("eta", 0.5), ("lam0", 0.0),
            ("beta", 0.1)),
    doc="closed loop on wire BYTES/round over an EWMA window",
    adaptive=True,
)
def _budget_window(args, ctx):
    raise todo("the adaptive 'budget_window' trigger", _ADAPTIVE_ITEM)


__getattr__ = not_ported(__name__, {
    "ctrl_init_row": _ADAPTIVE_ITEM,
    "linreg_gain_exact": "queue 1 item 3",
    "linreg_gain_estimated": "queue 1 item 3",
})
