"""Spec-string syntax — one compact format for configs, CLIs, benchmarks.

A copy of ``repro.comm.spec`` over the port's registries, so every spec
parses and renders identically in both packages.

Grammar (whitespace-insensitive)::

    policies   := policy (";" policy)*          # ";" = per-agent list
    policy     := trigger ("|" compressor)* ["@" channel]
    trigger    := stage
    compressor := stage ["+ef"] | "ef"          # "+ef" enables error feedback
                                               # (requires ≥1 compressor —
                                               # EF of an uncompressed
                                               # gradient is a no-op)
    channel    := stage                         # lossy-wire model
                                               # (repro_torch.net.channels.CHANNELS)
    stage      := name ["(" arg ("," arg)* ")"]
    arg        := [key "="] value               # positional args resolve by
                                               # the registry's param order

Values are parsed as bool (``true``/``false``), int, float, or bare
string.  Examples::

    gain_lookahead(lam=0.1,decay=inv_t)|topk(0.05)|int8+ef
    grad_norm(mu=4.0,kernel=true)
    always|int8 ; never                        # heterogeneous, 2 agents
    budget_dual(rate=0.5)|int8+ef @ bernoulli(p=0.2)   # lossy wire

Rendering is canonical (named args only, registry declaration order,
defaults omitted), so ``parse → str → parse`` is the identity.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from repro_torch.comm.compressors import COMPRESSORS
from repro_torch.comm.registry import StageSpec
from repro_torch.comm.triggers import TRIGGERS

_STAGE_RE = re.compile(r"^([A-Za-z_]\w*)\s*(?:\((.*)\))?$", re.S)


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _parse_stage(text: str, registry) -> StageSpec:
    m = _STAGE_RE.match(text.strip())
    if not m:
        raise ValueError(f"malformed stage {text!r}")
    name, argstr = m.group(1), m.group(2)
    pos: List[Any] = []
    kw = {}
    if argstr and argstr.strip():
        for piece in argstr.split(","):
            piece = piece.strip()
            if not piece:
                raise ValueError(f"empty argument in stage {text!r}")
            if "=" in piece:
                k, v = piece.split("=", 1)
                if not v.strip():
                    raise ValueError(
                        f"empty value for {k.strip()!r} in stage {text!r}"
                    )
                kw[k.strip()] = _parse_value(v)
            else:
                if kw:
                    raise ValueError(
                        f"positional arg after keyword arg in {text!r}"
                    )
                pos.append(_parse_value(piece))
    return registry.get(name).resolve(tuple(pos), kw)


def parse_policy(text: str) -> Tuple[StageSpec, Tuple[StageSpec, ...], bool,
                                     Optional[StageSpec]]:
    """One policy string → (trigger, compressors, error_feedback, channel).

    ``channel`` is the optional ``@``-suffixed lossy-wire model
    (repro_torch.net.channels.CHANNELS), or ``None`` when the spec names no channel —
    the default that keeps channel-free policies compiling unchanged.
    """
    channel: Optional[StageSpec] = None
    if "@" in text:
        body, chan_text = text.split("@", 1)
        if "@" in chan_text:
            raise ValueError(
                f"at most one '@ channel' suffix per policy: {text!r}"
            )
        if not chan_text.strip():
            raise ValueError(f"empty channel after '@' in {text!r}")
        # lazy import: the channel registry depends on comm.registry,
        # so it must not load at comm import time
        from repro_torch.net.channels import CHANNELS

        channel = _parse_stage(chan_text, CHANNELS)
        text = body
    stages = [s.strip() for s in text.split("|")]
    if not stages or not stages[0]:
        raise ValueError(f"empty policy spec {text!r}")
    trigger = _parse_stage(stages[0], TRIGGERS)
    compressors: List[StageSpec] = []
    ef = False
    for comp in stages[1:]:
        if ef:
            raise ValueError(
                f"error feedback must be the final stage marker: {text!r}"
            )
        if comp == "ef":
            ef = True
            continue
        if comp.endswith("+ef"):
            comp, ef = comp[: -len("+ef")].strip(), True
        compressors.append(_parse_stage(comp, COMPRESSORS))
    if ef and not compressors:
        raise ValueError(
            f"error feedback without a compressor stage is a no-op "
            f"(the residual of an uncompressed gradient is zero): {text!r}"
        )
    return trigger, tuple(compressors), ef, channel


def render_policy(trigger: StageSpec, compressors: Tuple[StageSpec, ...],
                  error_feedback: bool,
                  channel: Optional[StageSpec] = None) -> str:
    parts = [TRIGGERS.render(trigger)]
    parts += [COMPRESSORS.render(c) for c in compressors]
    out = "|".join(parts)
    if error_feedback and compressors:
        # a compressor-less EF flag is a no-op (needs_ef is False) and
        # is rejected by the parser, so it is not rendered either
        out += "+ef"
    if channel is not None:
        from repro_torch.net.channels import CHANNELS

        out += f" @ {CHANNELS.render(channel)}"
    return out


def split_multi(text: str) -> List[str]:
    """Split a (possibly per-agent) spec on ";"."""
    return [p.strip() for p in text.split(";") if p.strip()]


def describe() -> str:
    """Human-readable catalogue of the spec-string surface.

    One line per registered stage — ``signature  — help`` — sourced from
    the registries, so a newly registered trigger/compressor shows up
    here (and in ``--help`` surfaces built on this) with no extra
    wiring.  Exposed as ``repro_torch.comm.describe()``.
    """
    from repro_torch.net.channels import CHANNELS

    lines = [
        "spec grammar:  trigger(args) [|compressor(args)]... [+ef] "
        "[@ channel(args)]",
        '               ";" separates per-agent policies '
        "(heterogeneous networks)",
        "",
        "triggers (repro_torch.comm.TRIGGERS):",
    ]
    for name in TRIGGERS.names():
        entry = TRIGGERS.get(name)
        mark = "  [adaptive: carries controller state]" if entry.adaptive \
            else ""
        lines.append(f"  {entry.signature():<44} {entry.help}{mark}")
    lines += ["", "compressors (repro_torch.comm.COMPRESSORS):"]
    for name in COMPRESSORS.names():
        entry = COMPRESSORS.get(name)
        lines.append(f"  {entry.signature():<44} {entry.help}")
    lines += ["", "channels (repro_torch.net.channels.CHANNELS):"]
    for name in CHANNELS.names():
        entry = CHANNELS.get(name)
        lines.append(f"  {entry.signature():<44} {entry.help}")
    lines += [
        "",
        "trailing '+ef' on the last compressor enables error feedback;",
        "'@ channel(args)' attaches a lossy-wire model",
        'example: "gain_lookahead(lam=0.1,decay=inv_t)|topk(0.05)|int8+ef'
        ' @ bernoulli(p=0.2)"',
    ]
    return "\n".join(lines)
