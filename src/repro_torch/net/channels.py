"""Lossy-wire channel models — the spec grammar's ``@ channel`` stage.

This slice of the port serves an IDEAL wire only.  The registry below
carries every channel the JAX package registers (``repro.net.channels``)
with the same parameter tables and argument checks, so every policy
spec parses and renders identically in both packages.  Only ``ideal``
is trivial; any other channel builds to a bare non-trivial model, and
a bank or train step given such a policy raises with the ROADMAP
pointer.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.comm.registry import Registry, StageSpec
from repro_torch.utils.todo import not_ported

CHANNELS = Registry("channel")

_CHANNELS_ITEM = "queue 1 item 7"


class ChannelModel(NamedTuple):
    """A built channel: its spec, and whether it is lossless."""

    spec: StageSpec
    trivial: bool = False


def build_channel(spec: StageSpec) -> ChannelModel:
    """Resolve a channel StageSpec against the registry."""
    entry = CHANNELS.get(spec.name)
    return entry.builder(entry.full_args(spec), spec)


def spec_is_trivial(spec: StageSpec) -> bool:
    """Does this channel spec name a lossless (no-op) channel?"""
    return build_channel(spec).trivial


def _check_prob(name: str, value) -> None:
    if not 0.0 <= float(value) <= 1.0:
        raise ValueError(f"{name} must be in [0, 1], got {value!r}")


@CHANNELS.register("ideal", doc="lossless wire (compiles channel-free)")
def _ideal(args, spec):
    return ChannelModel(spec, trivial=True)


@CHANNELS.register(
    "bernoulli",
    params=(("p", 0.1), ("boost", 0.0), ("seed", 0)),
    doc="i.i.d. packet loss: each attempt dropped with prob p",
)
def _bernoulli(args, spec):
    _check_prob("bernoulli p", args["p"])
    return ChannelModel(spec)


@CHANNELS.register(
    "gilbert_elliott",
    params=(("p_gb", 0.1), ("p_bg", 0.3), ("p_loss_good", 0.05),
            ("p_loss_bad", 0.7), ("boost", 0.0), ("seed", 0)),
    doc="two-state Markov burst loss (good/bad channel state per agent)",
)
def _gilbert_elliott(args, spec):
    for key in ("p_gb", "p_bg", "p_loss_good", "p_loss_bad"):
        _check_prob(f"gilbert_elliott {key}", args[key])
    return ChannelModel(spec)


@CHANNELS.register(
    "rate",
    params=(("bytes_per_round", 128.0), ("burst", 4.0), ("boost", 0.0)),
    doc="deterministic token bucket: bytes/round capacity with burst cap",
)
def _rate(args, spec):
    if float(args["bytes_per_round"]) <= 0.0:
        raise ValueError(
            f"rate bytes_per_round must be positive, got "
            f"{float(args['bytes_per_round'])!r}"
        )
    if float(args["burst"]) < 1.0:
        raise ValueError(
            f"rate burst must be >= 1, got {float(args['burst'])!r}"
        )
    return ChannelModel(spec)


@CHANNELS.register(
    "retx",
    params=(("k", 1), ("fresh", False), ("p", 0.1), ("model", "bernoulli"),
            ("boost", 0.0), ("seed", 0)),
    doc="retransmit wrapper: re-offer an undelivered payload up to k "
        "rounds before the EF fold (fresh=true re-gates each re-offer)",
)
def _retx(args, spec):
    if int(args["k"]) < 1:
        raise ValueError(f"retx k must be >= 1, got {args['k']!r}")
    if str(args["model"]) not in ("bernoulli", "gilbert_elliott"):
        raise ValueError(
            f"retx model must be a loss channel ('bernoulli' or "
            f"'gilbert_elliott'), got {str(args['model'])!r}"
        )
    return ChannelModel(spec)


@CHANNELS.register(
    "delay",
    params=(("dist", "geometric"), ("lag", 2.0), ("max_lag", 4),
            ("discount", 0.0), ("boost", 0.0), ("seed", 0)),
    doc="latency delay line: accepted payloads arrive ~lag rounds late",
)
def _delay(args, spec):
    if str(args["dist"]) not in ("geometric", "deterministic"):
        raise ValueError(
            f"delay dist must be 'geometric' or 'deterministic', "
            f"got {str(args['dist'])!r}"
        )
    return ChannelModel(spec)


__getattr__ = not_ported(__name__, {
    name: _CHANNELS_ITEM
    for name in ("NET_WIDTH", "net_init", "net_rows", "tx_cost",
                 "channel_round", "delay_round", "retx_round",
                 "stale_scale")
})
