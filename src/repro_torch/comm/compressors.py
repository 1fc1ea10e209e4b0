"""Compressor stage — the wire format of a transmitted gradient.

The port of ``repro.comm.compressors``.  A compressor is a
*fake-compress* map ``x → x̂`` (the tensor the receiver reconstructs;
shapes are preserved) plus a wire-format transform used for byte
accounting; compressors CHAIN left to right.

Every ``compress`` here takes a tensor with a leading AGENT axis,
``(A, *shape)``, and compresses each agent's slice on its own — the
batched form of the JAX per-agent function under ``vmap``.

Wire-byte model (DESIGN.md §2): ``ratio = frac × (value_bits +
index_bits) / dense_bits``, against the gradients' native dtype width.
``int8`` sets value_bits to 8, ``topk(f)`` multiplies the kept fraction
by f and adds a 32-bit index per survivor, ``fp16`` narrows values to
16 bits.  ``bf16``, ``randk`` and ``sketch`` are registered (so their
specs parse and render) but not ported yet.

Rounding: ``torch.round`` and ``jnp.round`` both round half to even,
and ``topk`` keeps every entry whose ``|x|`` reaches the k-th largest
magnitude, so the kept set does not depend on how ``topk`` orders ties.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Sequence, Tuple

import torch

from repro_torch.comm.registry import Registry, StageSpec
from repro_torch.utils.todo import not_ported, todo

COMPRESSORS = Registry("compressor")


def _per_agent_amax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` over each agent's slice, shaped to broadcast."""
    amax = x.abs().reshape(x.shape[0], -1).amax(1)
    return amax.reshape((-1,) + (1,) * (x.ndim - 1))


def quantize_int8(x: torch.Tensor):
    """Symmetric per-agent int8: returns (q, scale). Zero-safe."""
    amax = _per_agent_amax(x)
    # divide by a device tensor, not a Python scalar: CUDA turns
    # ``t / scalar`` into ``t * (1/scalar)``, one ULP off the division
    # the CPU (and the JAX package) performs
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0),
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def fake_quantize(x: torch.Tensor) -> torch.Tensor:
    """Quantize→dequantize round trip (what the receiver reconstructs)."""
    q, s = quantize_int8(x)
    return dequantize_int8(q, s, x.dtype)


def topk_sparsify(x: torch.Tensor, frac: float):
    """Keep the top-``frac`` entries of |x| in each agent's slice, zero
    the rest.  Returns (sparse tensor, per-agent kept count)."""
    flat = x.reshape(x.shape[0], -1)
    k = max(1, int(frac * flat.shape[1]))
    thresh = torch.topk(flat.abs(), k, dim=1).values[:, -1:]
    mask = flat.abs() >= thresh
    return (flat * mask).reshape(x.shape).to(x.dtype), mask.sum(1)


@dataclass(frozen=True)
class WireFormat:
    """Per-entry cost of one transmitted gradient tensor.

    ``dense_bits`` is the native per-entry width of the uncompressed
    gradient (32 for fp32, 16 for bf16): the ratio baseline.
    ``abs_entries`` (set by sketching stages) replaces the fractional
    payload with a FIXED count of entries; the ratio then depends on the
    dense entry count and must be asked via :meth:`ratio_at`.
    """

    value_bits: float = 32.0
    index_bits: float = 0.0
    frac: float = 1.0  # fraction of entries actually sent
    dense_bits: float = 32.0
    abs_entries: float | None = None  # fixed payload size (sketches)

    @property
    def ratio(self) -> float:
        """Bytes relative to the dense tensor at its native dtype."""
        if self.abs_entries is not None:
            raise ValueError(
                "wire format carries a fixed-size payload (sketch): the "
                "ratio depends on the dense entry count — use "
                "ratio_at(entries) / CompressorChain.ratio_for(..., "
                "entries=...)"
            )
        return self.frac * (self.value_bits + self.index_bits) / self.dense_bits

    def ratio_at(self, entries: float) -> float:
        """Bytes relative to a dense payload of ``entries`` entries
        (capped at 1.0 for fixed-size formats)."""
        if entries <= 0:
            raise ValueError(f"entries must be positive, got {entries!r}")
        if self.abs_entries is None:
            return self.ratio
        kept = min(self.abs_entries * self.frac, float(entries))
        ratio = kept * (self.value_bits + self.index_bits) / (
            entries * self.dense_bits
        )
        return min(ratio, 1.0)


@dataclass(frozen=True)
class Compressor:
    """A built compressor stage: fake-compress fn + wire transform.

    ``cast_bits`` marks a pure value-narrowing stage (fp16): inside a
    chain its compress is SKIPPED when the running wire format is
    already at or below that width.
    """

    spec: StageSpec
    compress: Callable[[torch.Tensor], torch.Tensor]  # (A, *shape) tensor
    wire: Callable[[WireFormat], WireFormat]
    cast_bits: float | None = None


def build_compressor(spec: StageSpec) -> Compressor:
    entry = COMPRESSORS.get(spec.name)
    return entry.builder(entry.full_args(spec), spec)


@COMPRESSORS.register("identity", doc="dense fp32 wire (no-op)")
def _identity(args, spec):
    return Compressor(spec, compress=lambda x: x, wire=lambda w: w)


@COMPRESSORS.register("int8", doc="symmetric per-tensor int8 values")
def _int8(args, spec):
    return Compressor(
        spec,
        compress=fake_quantize,
        wire=lambda w: replace(w, value_bits=min(w.value_bits, 8.0)),
    )


@COMPRESSORS.register("topk", params=(("frac", 0.01),),
                      doc="keep the top-frac entries of |x| per tensor")
def _topk(args, spec):
    frac = float(args["frac"])
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"topk frac must be in (0, 1], got {frac}")
    return Compressor(
        spec,
        compress=lambda x: topk_sparsify(x, frac)[0],
        wire=lambda w: replace(w, frac=w.frac * frac, index_bits=32.0),
    )


@COMPRESSORS.register("fp16", doc="IEEE half-precision values on the wire")
def _fp16(args, spec):
    bits = 16.0

    def compress(x):
        # a gradient already ≤ 16 bits wide passes through untouched,
        # mirroring the byte model's no-op
        if x.element_size() * 8 <= bits:
            return x
        return x.to(torch.float16).to(x.dtype)

    return Compressor(
        spec,
        compress=compress,
        wire=lambda w: replace(w, value_bits=min(w.value_bits, bits)),
        cast_bits=bits,
    )


@COMPRESSORS.register("bf16", doc="bfloat16 values on the wire")
def _bf16(args, spec):
    raise todo("the 'bf16' compressor", "queue 1 item 4")


@COMPRESSORS.register("randk", params=(("frac", 0.01), ("seed", 0)),
                      doc="random-k sparsification (shared seed: no index bits)")
def _randk(args, spec):
    raise todo("the 'randk' compressor (needs the threefry port)",
               "queue 1 item 2")


@COMPRESSORS.register("sketch", params=(("rows", 5), ("cols", 64), ("seed", 0)),
                      doc="count-sketch: fixed rows*cols f32 counters per "
                          "tensor (shared hashes: no index bits)")
def _sketch(args, spec):
    raise todo("the 'sketch' compressor (needs the threefry port)",
               "queue 1 item 2")


class CompressorChain:
    """Ordered composition of compressor stages (left applied first)."""

    def __init__(self, compressors: Sequence[Compressor]):
        self.stages: Tuple[Compressor, ...] = tuple(compressors)

    def __bool__(self) -> bool:
        return bool(self.stages)

    def compress(self, x: torch.Tensor) -> torch.Tensor:
        """Fake-compress each agent's slice of ``x`` (leading agent axis).

        Tracks the running wire format so cast stages the byte model
        counts as no-ops are also value no-ops."""
        bits = 8.0 * x.element_size()
        fmt = WireFormat(value_bits=bits, dense_bits=bits)
        for c in self.stages:
            if c.cast_bits is None or fmt.value_bits > c.cast_bits:
                x = c.compress(x)
            fmt = c.wire(fmt)
        return x

    def compress_tree(self, tree):
        """Fake-compress a gradient dict with a leading agent axis."""
        return {k: self.compress(tree[k]) for k in sorted(tree)}

    def wire_format(self, dense_bits: float = 32.0) -> WireFormat:
        fmt = WireFormat(value_bits=dense_bits, dense_bits=dense_bits)
        for c in self.stages:
            fmt = c.wire(fmt)
        return fmt

    @property
    def ratio(self) -> float:
        """Ratio for fp32 gradients (the common case)."""
        return self.ratio_for(32.0)

    def ratio_for(self, dense_bits: float, entries: float | None = None
                  ) -> float:
        """Ratio against a dense tensor of ``dense_bits`` per entry
        (``entries`` prices fixed-size sketch stages)."""
        fmt = self.wire_format(dense_bits)
        if fmt.abs_entries is None:
            return fmt.ratio
        if entries is None:
            raise ValueError(
                "chain contains a fixed-size sketching stage: pass the "
                "dense entry count, e.g. "
                "ratio_for(dense_bits, entries=dense_entries(grads))"
            )
        return fmt.ratio_at(entries)


def chain_from_specs(specs: Sequence[StageSpec]) -> CompressorChain:
    return CompressorChain([build_compressor(s) for s in specs])


__getattr__ = not_ported(__name__, {
    "randk_sparsify": "queue 1 item 2",
    "sketch_encode": "queue 1 item 2",
    "sketch_decode": "queue 1 item 2",
    "count_sketch": "queue 1 item 2",
    "sketch_params": "queue 1 item 2",
})
