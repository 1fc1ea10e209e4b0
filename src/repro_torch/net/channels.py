"""Channel models — the lossy wire under every transmit decision.

The port of ``repro.net.channels``.  A :class:`ChannelModel` decides,
per agent and round, whether an attempted transmission is DELIVERED.
Channels attach to a policy with the ``@`` spec suffix::

    gain_lookahead(lam=0.1)|topk(0.05)|int8+ef @ bernoulli(p=0.2)

Registered channels (the JAX registry, with the same parameter tables
and argument checks): ``ideal`` (lossless and TRIVIAL: a policy holding
it runs the channel-free program), ``bernoulli(p,boost,seed)``,
``gilbert_elliott(p_gb,p_bg,p_loss_good,p_loss_bad,boost,seed)``,
``rate(bytes_per_round,burst,boost)`` (a token bucket),
``delay(dist,lag,max_lag,discount,boost,seed)`` (a latency line) and
``retx(k,fresh,p,model,boost,seed)`` (retransmit over a loss model).

Agent-batched protocol.  Where the JAX functions map ONE agent's row
and are vmapped, the port's take a block of ``B`` agents at once: a
row block is ``(B, NET_WIDTH)``, a key block ``(B, 2)``, and every draw
and decision is a ``(B,)`` vector.

**State slot.**  ``net_state`` is an ``(A, NET_WIDTH)`` f32 tensor, one
row ``[staleness, aux, uid]`` per agent (rounds since the last
delivery, the channel's own scalar state, the agent's index).  When any
policy carries a payload-buffering channel (``delay``, ``retx``) the
slot is the ``(rows, line)`` pair, with ``line = {"meta": (A, L, 2),
"buf": params tree of (A, L, *leaf)}``; ``L`` is the deepest line.  The
line is written with index ops on the whole block, never agent by agent.

**Per-round randomness.**  Agent ``i``'s key at step ``k`` is
``fold_in(fold_in(PRNGKey(seed), k), uid_i)``, bit for bit as in JAX
(:mod:`repro_torch.random`).  ``seed`` and ``k`` are host ints, so the
first two folds are host arithmetic; the uid fold runs on the rows'
device for every agent in one call (:func:`round_keys`, which the train
step calls once per channel seed and round), and every draw for a block
of agents in one call.

**Severity.**  ``chan_scale`` (``None``, a float, or a 0-dim tensor)
multiplies the loss probability, DIVIDES the rate channel's capacity
and MULTIPLIES the delay's mean lag; ``0`` is lossless except for
``delay`` (minimum one round of latency).

**Staleness escalation.**  With ``boost > 0`` an agent starved for
``s`` rounds scales its trigger knob by ``f = 1 + boost·s``: threshold
÷ f for fixed triggers, target × f for adaptive ones.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.comm.registry import Registry, StageSpec
from repro_torch.utils.tree import tree_leaves, tree_map

CHANNELS = Registry("channel")

# per-agent net-state row: [staleness, aux, uid] — one width for every
# channel so heterogeneous banks keep a uniform (A, NET_WIDTH) slot
NET_WIDTH = 3

F32 = np.float32


class ChannelModel(NamedTuple):
    """One built channel: delivery draw + state update (agent-batched).

    ``draw(key, aux, chan_scale, cost) -> (d, aux_mid)`` decides the
    block's delivery ``d ∈ {0., 1.}`` BEFORE the trigger runs (``key``
    ``(B, 2)``, ``aux`` ``(B,)``); ``update(aux_mid, delivered, cost)``
    folds the realized ``delivered = alpha × d`` back into the state.
    ``cost`` is one transmission's wire bytes (a Python float).  Delay
    lines set ``depth`` (= ``max_lag``), ``discount`` and ``mature(key,
    age, chan_scale) -> {0., 1.}``; retransmit channels set ``depth = 1``,
    ``retx_k`` and ``fresh``.  ``keyed`` is False for the channels
    whose draw reads no randomness (``rate``, deterministic ``delay``).
    """

    spec: StageSpec
    trivial: bool = False
    init_aux: float = 0.0
    boost: float = 0.0
    seed: int = 0
    draw: Optional[Callable[..., Any]] = None
    update: Optional[Callable[..., Any]] = None
    depth: int = 0
    discount: float = 0.0
    mature: Optional[Callable[..., Any]] = None
    retx_k: int = 0
    fresh: bool = False
    # does the draw read its key?  (the token bucket and the
    # deterministic delay line do not: no key is derived for them)
    keyed: bool = True


def build_channel(spec: StageSpec) -> ChannelModel:
    """Resolve a channel StageSpec against the registry."""
    entry = CHANNELS.get(spec.name)
    return entry.builder(entry.full_args(spec), spec)


def spec_is_trivial(spec: StageSpec) -> bool:
    """Does this channel spec name a lossless (no-op) channel?"""
    return build_channel(spec).trivial


def _check_prob(name: str, value) -> F32:
    if not 0.0 <= float(value) <= 1.0:
        raise ValueError(f"{name} must be in [0, 1], got {value!r}")
    return F32(value)


def _times(c: F32, chan_scale):
    """An f32 constant × the severity (the constant itself when None)."""
    if chan_scale is None:
        return c
    if isinstance(chan_scale, torch.Tensor):
        return float(c) * chan_scale.float()
    return c * F32(chan_scale)


def _over(c: F32, chan_scale):
    """An f32 constant ÷ the severity (``inf`` at severity 0)."""
    if chan_scale is None:
        return c
    if isinstance(chan_scale, torch.Tensor):
        return float(c) / chan_scale.float()
    with np.errstate(divide="ignore"):
        return c / F32(chan_scale)


def _host(x):
    """An f32 host constant as a Python float (tensors pass through)."""
    return x if isinstance(x, torch.Tensor) else float(x)


@CHANNELS.register("ideal", doc="lossless wire (compiles channel-free)")
def _ideal(args, spec):
    return ChannelModel(spec, trivial=True)


def _keep_aux(aux_mid, delivered, cost):
    return aux_mid


@CHANNELS.register(
    "bernoulli",
    params=(("p", 0.1), ("boost", 0.0), ("seed", 0)),
    doc="i.i.d. packet loss: each attempt dropped with prob p",
)
def _bernoulli(args, spec):
    p = _check_prob("bernoulli p", args["p"])

    def draw(key, aux, chan_scale, cost):
        u = prng.uniform(key)
        return (u >= _host(_times(p, chan_scale))).float(), aux

    return ChannelModel(spec, boost=float(args["boost"]),
                        seed=int(args["seed"]), draw=draw, update=_keep_aux)


@CHANNELS.register(
    "gilbert_elliott",
    params=(("p_gb", 0.1), ("p_bg", 0.3), ("p_loss_good", 0.05),
            ("p_loss_bad", 0.7), ("boost", 0.0), ("seed", 0)),
    doc="two-state Markov burst loss (good/bad channel state per agent)",
)
def _gilbert_elliott(args, spec):
    p_gb = _check_prob("gilbert_elliott p_gb", args["p_gb"])
    p_bg = _check_prob("gilbert_elliott p_bg", args["p_bg"])
    p_lg = _check_prob("gilbert_elliott p_loss_good", args["p_loss_good"])
    p_lb = _check_prob("gilbert_elliott p_loss_bad", args["p_loss_bad"])
    stay_bad = float(F32(1.0) - p_bg)

    def draw(key, aux, chan_scale, cost):
        # both keys' uniforms in one call: [..., 0] the state transition
        # (from last round's state aux ∈ {0.=good, 1.=bad}), [..., 1]
        # the loss in the new state
        u = prng.uniform(prng.split(key))
        p_to_bad = torch.where(aux > 0.5, stay_bad, float(p_gb))
        bad = (u[..., 0] < p_to_bad).float()
        if chan_scale is None:
            p_loss = torch.where(bad > 0.5, float(p_lb), float(p_lg))
        else:
            p_loss = torch.where(bad > 0.5, _host(_times(p_lb, chan_scale)),
                                 _host(_times(p_lg, chan_scale)))
        return (u[..., 1] >= p_loss).float(), bad

    return ChannelModel(spec, boost=float(args["boost"]),
                        seed=int(args["seed"]), draw=draw, update=_keep_aux)


@CHANNELS.register(
    "rate",
    params=(("bytes_per_round", 128.0), ("burst", 4.0), ("boost", 0.0)),
    doc="deterministic token bucket: bytes/round capacity with burst cap",
)
def _rate(args, spec):
    bpr = float(args["bytes_per_round"])
    burst = float(args["burst"])
    if bpr <= 0.0:
        raise ValueError(f"rate bytes_per_round must be positive, got {bpr!r}")
    if burst < 1.0:
        raise ValueError(f"rate burst must be >= 1, got {burst!r}")

    def draw(key, aux, chan_scale, cost):
        # severity DIVIDES capacity; 0 → infinite capacity (lossless)
        cap = _over(F32(bpr), chan_scale)
        if isinstance(cap, torch.Tensor):
            credit = torch.minimum(aux + cap, float(F32(burst)) * cap)
        else:
            with np.errstate(over="ignore", invalid="ignore"):
                top = F32(burst) * cap
            credit = torch.clamp(aux + float(cap), max=float(top))
        return (credit >= float(F32(cost))).float(), credit

    def update(aux_mid, delivered, cost):
        return aux_mid - delivered * float(F32(cost))

    # the bucket starts full at nominal capacity
    return ChannelModel(spec, init_aux=burst * bpr,
                        boost=float(args["boost"]), draw=draw, update=update,
                        keyed=False)


@CHANNELS.register(
    "retx",
    params=(("k", 1), ("fresh", False), ("p", 0.1), ("model", "bernoulli"),
            ("boost", 0.0), ("seed", 0)),
    doc="retransmit wrapper: re-offer an undelivered payload up to k "
        "rounds before the EF fold (fresh=true re-gates each re-offer)",
)
def _retx(args, spec):
    k = int(args["k"])
    if k < 1:
        raise ValueError(f"retx k must be >= 1, got {args['k']!r}")
    inner_name = str(args["model"])
    if inner_name not in ("bernoulli", "gilbert_elliott"):
        raise ValueError(
            f"retx model must be a loss channel ('bernoulli' or "
            f"'gilbert_elliott'), got {inner_name!r}"
        )
    if inner_name != "bernoulli" and float(args["p"]) != 0.1:
        raise ValueError(
            "retx p only parameterizes the bernoulli inner model; "
            f"model={inner_name!r} takes its registry defaults"
        )
    inner_kw = {"seed": int(args["seed"])}
    if inner_name == "bernoulli":
        inner_kw["p"] = args["p"]
    inner = build_channel(CHANNELS.get(inner_name).resolve((), inner_kw))
    return ChannelModel(spec, init_aux=inner.init_aux,
                        boost=float(args["boost"]), seed=int(args["seed"]),
                        draw=inner.draw, update=inner.update,
                        depth=1, retx_k=k, fresh=bool(args["fresh"]))


@CHANNELS.register(
    "delay",
    params=(("dist", "geometric"), ("lag", 2.0), ("max_lag", 4),
            ("discount", 0.0), ("boost", 0.0), ("seed", 0)),
    doc="latency delay line: accepted payloads arrive ~lag rounds late",
)
def _delay(args, spec):
    dist = str(args["dist"])
    if dist not in ("geometric", "deterministic"):
        raise ValueError(
            f"delay dist must be 'geometric' or 'deterministic', "
            f"got {dist!r}"
        )
    lag = float(args["lag"])
    max_lag = int(args["max_lag"])
    if max_lag < 1:
        raise ValueError(f"delay max_lag must be >= 1, got {max_lag!r}")
    if not 1.0 <= lag <= max_lag:
        raise ValueError(
            f"delay lag must be in [1, max_lag={max_lag}], got {lag!r}"
        )
    discount = float(args["discount"])
    if discount < 0.0:
        raise ValueError(f"delay discount must be >= 0, got {discount!r}")

    if dist == "geometric":
        def mature(key, age, chan_scale):
            # arrival hazard 1/eff per in-flight round; forced maturity
            # at max_lag makes acceptance a delivery guarantee
            eff = _times(F32(lag), chan_scale)
            if isinstance(eff, torch.Tensor):
                hazard = 1.0 / torch.clamp(eff, min=1.0)
            else:
                hazard = float(F32(1.0) / max(eff, F32(1.0)))
            arrive = (prng.uniform(key) < hazard).float()
            return torch.where(age >= float(max_lag), 1.0, arrive)
    else:
        def mature(key, age, chan_scale):
            eff = _times(F32(lag), chan_scale)
            if isinstance(eff, torch.Tensor):
                eff = torch.clamp(eff, 1.0, float(max_lag))
            else:
                eff = float(min(max(eff, F32(1.0)), F32(max_lag)))
            return (age >= eff).float()

    return ChannelModel(spec, boost=float(args["boost"]),
                        seed=int(args["seed"]), depth=max_lag,
                        discount=discount, mature=mature,
                        keyed=dist == "geometric")


# ----------------------------------------------------------------------
# TrainState slot + per-round helpers (consumed by repro_torch.comm.bank
# and repro_torch.core.api)
# ----------------------------------------------------------------------

def net_init(policy, num_agents: int, params=None, *, device=None):
    """The initial net-state slot for a (normalized) policy, or ``None``
    when no agent's channel is non-trivial (channel-free and ``@ ideal``
    states stay exactly what they were).

    Loss-only networks get the ``(num_agents, NET_WIDTH)`` rows; with a
    payload-buffering channel the ``(rows, line)`` pair, its buffer
    sized from ``params`` (which must then be given).  ``device``
    defaults to the params' device (else the CPU)."""
    policies = policy if isinstance(policy, tuple) else (policy,)
    if not any(p.needs_net for p in policies):
        return None
    models = [p.channel_model() if p.needs_net else None for p in policies]

    def aux0(model) -> float:
        return model.init_aux if (model is not None and not model.trivial) \
            else 0.0

    if len(policies) == 1:
        auxes = [aux0(models[0])] * num_agents
    else:
        auxes = [aux0(m) for m in models]
    if device is None and params is not None:
        device = tree_leaves(params)[0].device
    rows = torch.tensor([[0.0, a, float(i)] for i, a in enumerate(auxes)],
                        dtype=torch.float32, device=device)
    depth = max(
        (m.depth for m in models if m is not None and not m.trivial),
        default=0,
    )
    if not depth:
        return rows
    if params is None:
        raise ValueError(
            "policy attaches a payload-buffering channel (@ delay / "
            "@ retx): net_init needs the params tree to size the "
            "payload buffer — call net_init(policy, num_agents, params)"
        )
    meta = torch.zeros((num_agents, depth, 2), dtype=torch.float32,
                       device=device)
    buf = tree_map(lambda p: torch.zeros((num_agents, depth) + tuple(p.shape),
                                         dtype=p.dtype, device=device),
                   params)
    return rows, {"meta": meta, "buf": buf}


def net_rows(net):
    """The ``(..., NET_WIDTH)`` rows of a net-state value: the bare
    tensor, or the first element of the ``(rows, line)`` pair."""
    return net[0] if isinstance(net, tuple) else net


def tx_cost(grads, chain) -> float:
    """One transmission's wire bytes: one agent's dense payload (the
    leaves carry a leading agent axis) × the chain's compression ratio;
    a Python float, from shapes and dtypes only (of the whole leaves,
    where ``grads`` holds a mesh rank's model blocks)."""
    from repro_torch.comm.stats import (
        dense_bits,
        dense_entries,
        structural_bytes,
    )
    from repro_torch.sharding.blocks import global_like

    grads = global_like(grads)
    cost = float(structural_bytes(grads, per_agent=True))
    if chain:
        cost *= chain.ratio_for(
            dense_bits(grads), entries=dense_entries(grads, per_agent=True))
    return cost


def round_keys(seed: int, step: int, uid: torch.Tensor) -> torch.Tensor:
    """Every row's key of the round, ``fold_in(fold_in(PRNGKey(seed),
    step), uid)``: the first two folds on the host, the uid fold on
    ``uid``'s device, for all rows in one call.  ``uid`` is the rows'
    float column (cast to int32, as in JAX)."""
    return prng.fold_in(prng.host_fold_in(seed, step), uid.to(torch.int32))


def _keys(model: ChannelModel, uid, step: int, keys):
    if not model.keyed:
        return None
    return round_keys(model.seed, step, uid) if keys is None else keys


def channel_round(model: ChannelModel, rows: torch.Tensor, step: int,
                  chan_scale, cost: float, keys=None):
    """The block's channel draw for this round.

    Returns ``(d, stale, finalize)``: the delivery indicator (drawn
    before the trigger, so independent of this round's alpha), the
    staleness column, and ``finalize(delivered) -> new rows`` which
    resets staleness on delivery (+1 otherwise) and advances the
    channel state.  ``keys`` are the block's rows of :func:`round_keys`,
    when the caller derived them for more rows at once."""
    stale, aux, uid = rows.unbind(-1)
    d, aux_mid = model.draw(_keys(model, uid, step, keys), aux, chan_scale,
                            cost)

    def finalize(delivered):
        new_stale = (stale + 1.0) * (1.0 - delivered)
        new_aux = model.update(aux_mid, delivered, cost)
        return torch.stack([new_stale, new_aux, uid], -1)

    return d, stale, finalize


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(B,)`` vector shaped to broadcast over ``x``'s trailing axes."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def delay_round(model: ChannelModel, net, step: int, chan_scale,
                keys=None):
    """The block's delay-line round.

    ``net`` is the block's ``(rows, line)`` pair.  Returns ``(d, stale,
    commit)``: ``d`` the ACCEPT indicator (a free slot after this
    round's head dequeue; forced maturity at ``depth`` makes acceptance
    a delivery guarantee), ``stale`` the staleness column, and
    ``commit(accepted, payload) -> (out_sent, weight, new_net)``, which
    enqueues ``payload`` where ``accepted``, dequeues the matured head
    and returns it with its application weight ``m / (1 +
    discount·(age−1))``.  Order within the round: in-flight payloads
    age, the head's maturity is drawn, acceptance follows from the
    occupancy after the dequeue."""
    rows, line = net
    stale, aux, uid = rows.unbind(-1)
    meta, buf = line["meta"], line["buf"]
    depth = meta.shape[1]
    valid = meta[..., 0]
    age = meta[..., 1] + valid
    m = valid[:, 0] * model.mature(_keys(model, uid, step, keys), age[:, 0],
                                   chan_scale)
    occ_after = valid.sum(1) - m
    d = (occ_after < float(depth)).float()

    def commit(accepted, payload):
        matured = m > 0.5
        out_sent = tree_map(
            lambda b: torch.where(_bcast(matured, b[:, 0]), b[:, 0],
                                  torch.zeros_like(b[:, 0])), buf)
        w = m / (1.0 + float(F32(model.discount))
                 * torch.clamp(age[:, 0] - 1.0, min=0.0))

        def shift(x):
            return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)

        meta1 = torch.stack([valid, age], -1)
        meta1 = torch.where(_bcast(matured, meta1), shift(meta1), meta1)
        buf1 = tree_map(
            lambda b: torch.where(_bcast(matured, b), shift(b), b), buf)
        # enqueue at the first free slot with [valid=1, age=0]: the age
        # grows at the start of each round, so the earliest arrival is
        # next round, at staleness 1
        free = meta1[..., 0].sum(1, keepdim=True)
        slot = (torch.arange(depth, device=meta.device)[None] == free) & (
            accepted > 0.5)[:, None]
        meta2 = torch.stack([torch.where(slot, 1.0, meta1[..., 0]),
                             torch.where(slot, 0.0, meta1[..., 1])], -1)
        buf2 = tree_map(
            lambda b, s: torch.where(
                slot.reshape(slot.shape + (1,) * (b.ndim - 2)),
                s.to(b.dtype)[:, None], b),
            buf1, payload)
        new_stale = (stale + 1.0) * (1.0 - m)
        new_rows = torch.stack([new_stale, aux, uid], -1)
        return out_sent, w, (new_rows, {"meta": meta2, "buf": buf2})

    return d, stale, commit


def retx_round(model: ChannelModel, net, step: int, chan_scale,
               cost: float, keys=None):
    """The block's retransmit round (``@ retx(k,...)``).

    ``net`` is the block's ``(rows, line)`` pair, the line's meta
    columns read as ``[valid, tries]`` of the one buffered payload in
    slot 0.  Returns ``(d, stale, pending, commit)``: the inner loss
    model's delivery draw, the staleness column, the buffered-payload
    indicator, and ``commit(alpha, payload) -> (attempt, out_sent,
    delivered, fold, new_net)``.  A pending payload is re-offered
    (unconditionally, or re-gated by this round's decision with
    ``fresh``) in place of new content; a lost first offer is buffered
    instead of folding into EF; ``fold`` is the buffered payload where
    it expires undelivered after ``k`` re-offers, else zeros."""
    rows, line = net
    stale, aux, uid = rows.unbind(-1)
    meta, buf = line["meta"], line["buf"]
    valid, tries = meta[:, 0, 0], meta[:, 0, 1]
    d, aux_mid = model.draw(_keys(model, uid, step, keys), aux, chan_scale,
                            cost)
    pending = valid

    def commit(alpha, payload):
        re_gate = alpha if model.fresh else 1.0
        attempt = pending * re_gate + (1.0 - pending) * alpha
        delivered = attempt * d
        pend = pending > 0.5
        out_sent = tree_map(
            lambda b, s: torch.where(_bcast(pend, s), b[:, 0], s.to(b.dtype)),
            buf, payload)
        tries1 = tries + pending
        resolved = pending * delivered
        expired = (pending * (1.0 - delivered)
                   * (tries1 >= float(model.retx_k)).float())
        fold = tree_map(
            lambda b: torch.where(_bcast(expired > 0.5, b[:, 0]), b[:, 0],
                                  torch.zeros_like(b[:, 0])), buf)
        enq = (1.0 - pending) * alpha * (1.0 - d)
        new_valid = pending * (1.0 - resolved - expired) + enq
        new_tries = tries1 * pending * (1.0 - resolved - expired)
        meta_new = meta.clone()
        meta_new[:, 0] = torch.stack([new_valid, new_tries], -1)

        def put(b, s):
            out = b.clone()
            out[:, 0] = torch.where(_bcast(enq > 0.5, s), s.to(b.dtype),
                                    b[:, 0])
            return out

        buf_new = tree_map(put, buf, payload)
        new_stale = (stale + 1.0) * (1.0 - delivered)
        new_aux = model.update(aux_mid, delivered, cost)
        new_rows = torch.stack([new_stale, new_aux, uid], -1)
        return (attempt, out_sent, delivered, fold,
                (new_rows, {"meta": meta_new, "buf": buf_new}))

    return d, stale, pending, commit


def stale_scale(scale, boost: float, stale, adaptive: bool):
    """The staleness-escalated trigger knob scale ``f = 1 + boost·s``:
    fixed triggers get threshold ÷ f, adaptive ones target × f.
    ``boost == 0`` returns ``scale`` itself (no op)."""
    if not boost:
        return scale
    f = 1.0 + float(F32(boost)) * stale
    base = None if scale is None else (
        scale.float() if isinstance(scale, torch.Tensor)
        else float(F32(scale)))
    if adaptive:
        return f if base is None else base * f
    inv = 1.0 / f
    return inv if base is None else base * inv
