"""Parameter construction with logical axis names (port of
``repro.models.param``).

Models build parameters through a :class:`Scope`, which records for
every tensor a tuple of logical axis names beside the value, so the
port's trees have the same paths, shapes and axes as the JAX package's.
The axes name what the JAX package shards; on one card they are
documentation.

Draws come from one explicit ``torch.Generator``; parameters land on its
device.  The init distributions are the JAX package's (``normal`` scaled
by ``1/sqrt(fan_in)`` or ``scale``, ``ones``, ``zeros``, ``small_uniform``
on [−0.05, 0.05)), the draws are
not: weights that must equal the JAX package's are carried across with
``repro_torch.convert.params_from_jax``.

An abstract scope (``abstract=True``, no generator) builds every leaf
as an empty tensor on the ``meta`` device instead: the same tree,
names, shapes and dtypes, nothing allocated and nothing drawn (the JAX
package's ``jax.ShapeDtypeStruct`` leaves, for the dry-run).

``place(path, leaf) -> leaf`` (port-only) maps each leaf as soon as it
is drawn, in draw order: a rank of a mesh keeps its block of every leaf
and lets the whole one go, so the draws are the whole model's and the
rank never holds more than its blocks and one whole leaf.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch


class Scope:
    def __init__(self, gen: Optional[torch.Generator], dtype: torch.dtype,
                 lead: Tuple[int, ...] = (), abstract: bool = False,
                 place: Optional[Callable] = None, path: Tuple[str, ...] = ()):
        if gen is None and not abstract:
            raise ValueError("a concrete init needs a torch.Generator")
        self._gen = gen
        self.dtype = dtype
        self.abstract = abstract
        self._lead = lead  # leading stacked axes (the layer axis)
        self._place = place
        self._path = path
        self.params: dict = {}
        self.axes: dict = {}

    def sub(self, name: str) -> "Scope":
        child = Scope(self._gen, self.dtype, self._lead, self.abstract,
                      self._place, self._path + (name,))
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child

    def param(
        self,
        name: str,
        shape: Tuple[int, ...],
        axes: Tuple[Optional[str], ...],
        init: str = "normal",
        scale: Optional[float] = None,
    ) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} vs axes {axes}")
        full = self._lead + tuple(shape)
        dev = "meta" if self.abstract else self._gen.device
        if self.abstract:
            value = torch.empty(full, dtype=self.dtype, device=dev)
        elif init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
            s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            value = (torch.randn(full, generator=self._gen, device=dev,
                                 dtype=torch.float32) * s).to(self.dtype)
        elif init == "zeros":
            value = torch.zeros(full, dtype=self.dtype, device=dev)
        elif init == "ones":
            value = torch.ones(full, dtype=self.dtype, device=dev)
        elif init == "small_uniform":
            value = (torch.rand(full, generator=self._gen, device=dev,
                                dtype=torch.float32) * 0.1 - 0.05
                     ).to(self.dtype)
        else:
            raise ValueError(f"unknown init {init!r}")
        if self._place is not None and not self.abstract:
            value = self._place(self._path + (name,), value)
        self.params[name] = value
        self.axes[name] = ("layer",) * len(self._lead) + tuple(axes)
        return value

    def stacked(self, name: str, n: int, build_fn: Callable) -> dict:
        """``n`` structurally identical sub-trees stacked on axis 0.

        ``build_fn(scope)`` defines one instance; every leaf gains a
        leading ``(n, ...)`` axis with logical name ``"layer"``.  Each
        instance draws independently (``fan_in`` is the instance's)."""
        child = Scope(self._gen, self.dtype, self._lead + (n,),
                      self.abstract, self._place, self._path + (name,))
        build_fn(child)
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child.params


def init_pair(gen: Optional[torch.Generator], dtype: torch.dtype,
              build_fn: Callable, abstract: bool = False,
              place: Optional[Callable] = None):
    """Run ``build_fn(scope)`` and return ``(params, axes)`` trees."""
    sc = Scope(gen, dtype, abstract=abstract, place=place)
    build_fn(sc)
    return sc.params, sc.axes
