"""CommPolicy — the paper's communication decision as a first-class value.

The port of ``repro.comm.policy``.  A policy composes a trigger, a
compressor chain, optional error feedback and an optional ``@ channel``
wire model; policies are frozen, hashable values that round-trip
through the spec-string syntax (``repro_torch.comm.spec``)::

    CommPolicy.parse("gain_quadratic(lam=0.1,kernel=true)|int8+ef")

Per-agent *heterogeneous* networks are a tuple of policies.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

from repro_torch.comm import spec as spec_mod
from repro_torch.comm.compressors import (
    COMPRESSORS,
    CompressorChain,
    chain_from_specs,
)
from repro_torch.comm.registry import StageSpec
from repro_torch.comm.triggers import (
    TRIGGERS,
    TriggerContext,
    TriggerFn,
    build_trigger,
    spec_is_adaptive,
)
from repro_torch.utils.todo import todo

PolicyLike = Union["CommPolicy", str]
PoliciesLike = Union[PolicyLike, Sequence[PolicyLike]]


@dataclass(frozen=True)
class CommPolicy:
    trigger: StageSpec = field(
        default_factory=lambda: StageSpec("gain_lookahead")
    )
    compressors: Tuple[StageSpec, ...] = ()
    error_feedback: bool = False
    channel: Optional[StageSpec] = None

    @classmethod
    def parse_one(cls, text: Union[str, "CommPolicy"]) -> "CommPolicy":
        """Parse exactly one policy (rejects ";" heterogeneous specs)."""
        if isinstance(text, CommPolicy):
            return text
        parts = spec_mod.split_multi(text)
        if not parts:
            raise ValueError(f"empty policy spec {text!r}")
        if len(parts) != 1:
            raise ValueError(
                f"expected a single policy, got {len(parts)} in {text!r}"
            )
        trig, comps, ef, chan = spec_mod.parse_policy(parts[0])
        return cls(trigger=trig, compressors=comps, error_feedback=ef,
                   channel=chan)

    @classmethod
    def parse(cls, text: PoliciesLike
              ) -> Union["CommPolicy", Tuple["CommPolicy", ...]]:
        """Parse a spec. A ";"-separated string (or a sequence) yields a
        tuple of per-agent policies; otherwise a single CommPolicy."""
        if isinstance(text, CommPolicy):
            return text
        if isinstance(text, (list, tuple)):
            if not text:
                raise ValueError("empty policy list")
            return tuple(cls.parse_one(t) for t in text)
        parts = spec_mod.split_multi(text)
        if not parts:
            raise ValueError(f"empty policy spec {text!r}")
        if len(parts) > 1:
            return tuple(cls.parse_one(p) for p in parts)
        return cls.parse_one(parts[0])

    @classmethod
    def of(cls, trigger: str, *compressors: str, error_feedback: bool = False,
           **trigger_args) -> "CommPolicy":
        """Programmatic construction with registry validation."""
        return cls(
            trigger=TRIGGERS.spec(trigger, **trigger_args),
            compressors=tuple(
                spec_mod._parse_stage(c, COMPRESSORS) for c in compressors
            ),
            error_feedback=error_feedback,
        )

    def to_spec(self) -> str:
        return spec_mod.render_policy(
            self.trigger, self.compressors, self.error_feedback,
            self.channel,
        )

    def __str__(self) -> str:
        return self.to_spec()

    def build_trigger(self, *, loss_fn=None,
                      probe_eps: float = 1e-2) -> TriggerFn:
        return build_trigger(
            self.trigger,
            TriggerContext(
                loss_fn=loss_fn, probe_eps=probe_eps,
                ratio_for=self.chain().ratio_for if self.compressors else None,
            ),
        )

    def chain(self) -> CompressorChain:
        return chain_from_specs(self.compressors)

    @property
    def wire_ratio(self) -> float:
        """Wire bytes relative to dense fp32 (1.0 when uncompressed)."""
        return self.chain().ratio if self.compressors else 1.0

    @property
    def needs_ef(self) -> bool:
        return self.error_feedback and bool(self.compressors)

    @property
    def is_adaptive(self) -> bool:
        """Does the trigger carry closed-loop controller state?"""
        return spec_is_adaptive(self.trigger)

    def channel_model(self):
        """The built channel model, or ``None`` when none is named."""
        if self.channel is None:
            return None
        from repro_torch.net.channels import build_channel

        return build_channel(self.channel)

    @property
    def needs_net(self) -> bool:
        """Does this policy need per-agent channel state?  False for
        channel-free specs and ``@ ideal``; any other channel raises
        (lossy wires are not ported yet)."""
        if self.channel is None:
            return False
        from repro_torch.net.channels import spec_is_trivial

        return not spec_is_trivial(self.channel)


_KIND_TO_TRIGGER = {
    "gain_exact": "gain_exact",
    "gain_estimated": "gain_estimated",
    "gain_lookahead": "gain_lookahead",
    "gain_quadratic": "gain_quadratic",
    "grad_norm": "grad_norm",
    "periodic": "periodic",
    "always": "always",
    "never": "never",
}


def trigger_spec_from_config(trig_cfg) -> StageSpec:
    """TriggerConfig → registry StageSpec (the documented kinds all resolve)."""
    name = _KIND_TO_TRIGGER.get(trig_cfg.kind)
    if name is None:
        raise ValueError(
            f"unknown trigger kind {trig_cfg.kind!r} "
            f"(registered: {', '.join(TRIGGERS.names())})"
        )
    kw = {}
    if name in ("gain_exact", "gain_estimated", "gain_lookahead",
                "gain_quadratic"):
        kw = dict(lam=trig_cfg.lam, decay=trig_cfg.lam_decay,
                  decay_rate=trig_cfg.lam_decay_rate)
    elif name == "grad_norm":
        kw = dict(mu=trig_cfg.mu)
    elif name == "periodic":
        kw = dict(period=trig_cfg.period)
    return TRIGGERS.spec(name, **kw)


def with_kernel(policy: Union[CommPolicy, Tuple[CommPolicy, ...]]
                ) -> Union[CommPolicy, Tuple[CommPolicy, ...]]:
    """Enable the trigger-level ``kernel=true`` option wherever the
    policy's trigger supports it."""
    if isinstance(policy, tuple):
        return tuple(with_kernel(p) for p in policy)
    entry = TRIGGERS.get(policy.trigger.name)
    if not any(p == "kernel" for p, _ in entry.params):
        return policy
    trig = entry.resolve((), {**policy.trigger.as_dict(), "kernel": True})
    return dataclasses.replace(policy, trigger=trig)


def resolve_policy(cfg, policy: Optional[PoliciesLike] = None
                   ) -> Union[CommPolicy, Tuple[CommPolicy, ...]]:
    """The one resolution order everywhere: explicit policy arg >
    ``cfg.comm`` spec > ``cfg.trigger`` with no compression."""
    if policy is not None:
        return CommPolicy.parse(policy)
    comm = getattr(cfg, "comm", None)
    if comm is not None:
        return CommPolicy.parse(comm)
    return CommPolicy(trigger=trigger_spec_from_config(cfg.trigger))


def ctrl_init(policy: Union[CommPolicy, Tuple[CommPolicy, ...]],
              num_agents: int):
    """The controller slot: ``None`` when no trigger is adaptive (the
    adaptive triggers are not ported yet)."""
    policies = policy if isinstance(policy, tuple) else (policy,)
    if any(p.is_adaptive for p in policies):
        raise todo("adaptive budget triggers (controller state)",
                   "queue 1 item 4")
    return None


def normalize_policy(policy: Union[CommPolicy, Tuple[CommPolicy, ...]],
                     num_agents: int
                     ) -> Union[CommPolicy, Tuple[CommPolicy, ...]]:
    """Validate a per-agent list against the agent count, then collapse
    trivial tuples to the homogeneous path."""
    if isinstance(policy, CommPolicy):
        return policy
    if not policy:
        raise ValueError("empty policy list")
    if len(policy) > 1 and len(policy) != num_agents:
        raise ValueError(
            f"heterogeneous policy list has {len(policy)} entries "
            f"but num_agents={num_agents}"
        )
    if len(set(policy)) == 1:
        return policy[0]
    return tuple(policy)
