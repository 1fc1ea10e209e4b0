"""Named registries for the communication stack's pluggable stages.

A stage (trigger or compressor) is registered under a short name with an
ordered parameter table ``((param, default), ...)``.  The registry owns
argument resolution for the spec-string syntax (``topk(0.05)`` resolves
the positional ``0.05`` to the first declared parameter) and canonical
rendering (only non-default arguments are printed, in declaration
order), so ``parse → str → parse`` round-trips exactly.

New stages never require edits to the train step: register a builder
here and every spec string, CLI flag, and benchmark can name it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple


@dataclass(frozen=True)
class StageSpec:
    """One parsed stage: a registry name plus resolved (name, value) args.

    Hashable and order-canonical (args follow the registry's parameter
    declaration order), so policies can live inside frozen configs.
    """

    name: str
    args: Tuple[Tuple[str, Any], ...] = ()

    def arg(self, key: str, default: Any = None) -> Any:
        for k, v in self.args:
            if k == key:
                return v
        return default

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.args)


def _render_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    return str(v)


@dataclass(frozen=True)
class RegistryEntry:
    name: str
    params: Tuple[Tuple[str, Any], ...]  # ordered (param, default)
    builder: Callable[..., Any]
    doc: str = ""
    # adaptive stages carry closed-loop controller state: their builders
    # return functions taking (and returning) a per-agent ctrl row in
    # addition to the plain stage signature (repro_torch.comm.triggers)
    adaptive: bool = False

    @property
    def help(self) -> str:
        """The one-line description surfaced by ``repro_torch.comm.describe()``."""
        return self.doc

    def signature(self) -> str:
        """``name(param=default, ...)`` — the spec-string call shape."""
        if not self.params:
            return self.name
        inner = ", ".join(f"{p}={_render_value(d)}" for p, d in self.params)
        return f"{self.name}({inner})"

    def resolve(self, pos_args: Tuple[Any, ...] = (),
                kw_args: Dict[str, Any] | None = None) -> StageSpec:
        """Bind positional/keyword spec arguments to declared parameters."""
        kw_args = dict(kw_args or {})
        names = [p for p, _ in self.params]
        if len(pos_args) > len(names):
            raise ValueError(
                f"{self.name}: got {len(pos_args)} positional args, "
                f"takes at most {len(names)} ({', '.join(names)})"
            )
        bound = dict(zip(names, pos_args))
        for k, v in kw_args.items():
            if k not in names:
                raise ValueError(
                    f"{self.name}: unknown arg {k!r} (takes {', '.join(names) or 'none'})"
                )
            if k in bound:
                raise ValueError(f"{self.name}: duplicate arg {k!r}")
            bound[k] = v
        # canonical: declaration order, defaults dropped
        args = tuple(
            (p, bound[p]) for p, d in self.params if p in bound and bound[p] != d
        )
        return StageSpec(self.name, args)

    def full_args(self, spec: StageSpec) -> Dict[str, Any]:
        """Spec args merged over declared defaults."""
        out = dict(self.params)
        out.update(spec.as_dict())
        return out

    def render(self, spec: StageSpec) -> str:
        if not spec.args:
            return spec.name
        inner = ",".join(f"{k}={_render_value(v)}" for k, v in spec.args)
        return f"{spec.name}({inner})"


@dataclass
class Registry:
    """A flat name → entry table for one stage family."""

    kind: str
    _entries: Dict[str, RegistryEntry] = field(default_factory=dict)

    def register(self, name: str, params: Tuple[Tuple[str, Any], ...] = (),
                 doc: str = "", adaptive: bool = False):
        """Decorator: register ``builder`` under ``name``.

        ``doc`` is the one-line help string ``repro_torch.comm.describe()``
        prints; ``adaptive=True`` marks a stage whose builder speaks the
        controller-state protocol (repro_torch.comm.triggers)."""
        def deco(builder):
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} {name!r}")
            self._entries[name] = RegistryEntry(
                name, tuple(params), builder, doc, adaptive
            )
            return builder
        return deco

    def get(self, name: str) -> RegistryEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r} "
                f"(registered: {', '.join(sorted(self._entries)) or 'none'})"
            ) from None

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._entries))

    def spec(self, name: str, **kw) -> StageSpec:
        """Programmatic StageSpec construction with validation."""
        return self.get(name).resolve((), kw)

    def render(self, spec: StageSpec) -> str:
        return self.get(spec.name).render(spec)
