"""Names of the JAX package that this port has not reached yet.

Each mirrored module lists the public names of its ``repro``
counterpart that it does not implement, with the ROADMAP item that
will port them, and installs :func:`not_ported` as its module-level
``__getattr__``.  Touching such a name raises ``NotImplementedError``
with that pointer instead of an ``AttributeError`` (or, worse, a
silently different behaviour).
"""
from __future__ import annotations

from typing import Callable, Dict


def not_ported(module: str, table: Dict[str, str]) -> Callable[[str], object]:
    """A PEP 562 ``__getattr__`` for ``module`` over ``{name: item}``."""

    def __getattr__(name: str):
        if name in table:
            raise NotImplementedError(
                f"{module}.{name} is not ported to PyTorch yet "
                f"(ROADMAP {table[name]})"
            )
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__


def todo(what: str, item: str) -> NotImplementedError:
    """The error for an unported option or code path."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP {item})"
    )
