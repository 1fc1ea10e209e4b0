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
16 bits, ``bf16`` likewise, ``randk(f)`` keeps a shared-random
fraction f with no index bits, and ``sketch(rows,cols,seed)`` sends a
fixed ``rows × cols`` grid of f32 counters.

``randk`` draws its coordinates with the port's threefry
(:mod:`repro_torch.random`), bit for bit as ``jax.random`` draws them:
each agent's key is ``fold_in(key(seed), salt)`` with the salt the bit
pattern of the fp32 sum of that agent's tensor.  ``sketch`` draws its
hash and sign tables on the host with numpy, from the same
``SeedSequence`` as the JAX package, so both packages share the tables.

Rounding: ``torch.round`` and ``jnp.round`` both round half to even,
and ``topk`` keeps every entry whose ``|x|`` reaches the k-th largest
magnitude, so the kept set does not depend on how ``topk`` orders ties.
A stage that rounds values (``int8``, ``fp16``, ``bf16``) also states
its ``spacing``, the distance between the two wire values around each
entry; :meth:`CompressorChain.rounding_ties` uses it to find the entries
that two computations of one gradient, a last place apart, may round
one step apart.

On a (data, model) mesh each agent's gradient reaches the compressors as
this rank's model block of each leaf (:mod:`repro_torch.sharding.
blocks`), and each stage gives the whole leaf's result on the block:
int8's scale is the maximum over "model" of the blocks' ``max |x|``
(bitwise the whole leaf's); top-k gathers each block's k largest
``|x|`` over "model" and keeps what reaches the whole leaf's k-th (the
same set); randk's salt sums the blocks' fp32 sums over "model" (which
may round apart from the whole sum, and then salts another subset) and
each rank keeps its block's part of the whole leaf's subset; the sketch
encodes the block with its entries' hashes and sums the grids over
"model" (count-sketch is linear), and decodes the block's entries; the
casts are elementwise.  Two draws still span the whole leaf on every
rank: randk's permutation (int64 over the leaf's entries, on the
device) and the sketch's hash and sign tables (on the host; the device
holds the block's columns).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.comm.registry import Registry, StageSpec
from repro_torch.sharding import blocks

COMPRESSORS = Registry("compressor")


def _over_model(x: torch.Tensor, blk, tag: str, op: str = "sum"
                ) -> torch.Tensor:
    """``x`` reduced over the model axis of the block ``blk``."""
    from repro_torch.sharding.collectives import _AllReduce

    return _AllReduce.apply(x, blk.where(tag, op))


def _per_agent_amax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` over each agent's slice (its whole leaf's, from a
    model block), shaped to broadcast."""
    amax = x.abs().reshape(x.shape[0], -1).amax(1)
    blk = blocks.current()
    if blk is not None:
        amax = _over_model(amax, blk, "int8_scale", "max")
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


def _int8_spacing(x: torch.Tensor) -> torch.Tensor:
    """One int8 level of each agent's slice (its scale), per entry."""
    return quantize_int8(x)[1].expand(x.shape)


def _float_spacing(x: torch.Tensor, mantissa_bits: int,
                  min_exponent: int) -> torch.Tensor:
    """The ULP at each entry of a float format with ``mantissa_bits``
    stored bits and normal exponents from ``min_exponent`` (fp16: 10,
    -14; bf16: 7, -126), subnormals included."""
    _, exp = torch.frexp(x.float())
    # |x| in [2^(exp-1), 2^exp): the binade's ULP is 2^(exp-1-bits)
    e = torch.clamp(exp - 1, min=min_exponent) - mantissa_bits
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e)


def fake_quantize(x: torch.Tensor) -> torch.Tensor:
    """Quantize→dequantize round trip (what the receiver reconstructs)."""
    q, s = quantize_int8(x)
    return dequantize_int8(q, s, x.dtype)


def _topk_mask(flat: torch.Tensor, frac: float) -> torch.Tensor:
    """Each row's entries whose ``|x|`` reaches its k-th largest (of the
    whole leaf, from a model block: each block's k largest gathered over
    "model")."""
    mag = flat.abs()
    blk = blocks.current()
    if blk is None:
        k = max(1, int(frac * flat.shape[1]))
        return mag >= torch.topk(mag, k, dim=1).values[:, -1:]
    k = max(1, int(frac * blk.numel))
    kl = min(k, flat.shape[1])
    n, i = blk.axis.size, blk.axis.index
    cand = mag.new_zeros((flat.shape[0], n * kl))
    cand[:, i * kl:(i + 1) * kl] = torch.topk(mag, kl, dim=1).values
    cand = _over_model(cand, blk, "topk_candidates")
    return mag >= torch.topk(cand, k, dim=1).values[:, -1:]


def topk_sparsify(x: torch.Tensor, frac: float):
    """Keep the top-``frac`` entries of |x| in each agent's slice, zero
    the rest.  Returns (sparse tensor, per-agent kept count)."""
    flat = x.reshape(x.shape[0], -1)
    mask = _topk_mask(flat, frac)
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
    # per entry of an (A, *shape) tensor: the distance between the two
    # wire values around it (None: the stage rounds no value)
    spacing: Callable[[torch.Tensor], torch.Tensor] | None = None


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
        spacing=_int8_spacing,
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


def _cast_compressor(spec, dtype: torch.dtype, bits: float) -> Compressor:
    """Value cast through a narrower float dtype; the ratio is
    dtype-aware: ``value_bits = min(current, bits)``."""
    info = torch.finfo(dtype)
    mantissa = int(round(-np.log2(info.eps)))
    min_exponent = int(round(np.log2(info.tiny)))

    def compress(x):
        # a gradient already ≤ 16 bits wide passes through untouched,
        # mirroring the byte model's no-op
        if x.element_size() * 8 <= bits:
            return x
        return x.to(dtype).to(x.dtype)

    return Compressor(
        spec,
        compress=compress,
        wire=lambda w: replace(w, value_bits=min(w.value_bits, bits)),
        cast_bits=bits,
        spacing=lambda x: _float_spacing(x, mantissa, min_exponent),
    )


@COMPRESSORS.register("fp16", doc="IEEE half-precision values on the wire")
def _fp16(args, spec):
    return _cast_compressor(spec, torch.float16, 16.0)


@COMPRESSORS.register("bf16", doc="bfloat16 values on the wire")
def _bf16(args, spec):
    return _cast_compressor(spec, torch.bfloat16, 16.0)


def randk_sparsify(x: torch.Tensor, frac: float,
                   key: torch.Tensor) -> torch.Tensor:
    """Keep a uniformly random ``frac`` of the entries of each agent's
    slice of ``x`` (Stich et al. 2018's rand-k family): the first ``k``
    of ``permutation(key_i, n)``.  ``key`` is one ``(2,)`` key for every
    agent or ``(A, 2)``, one per agent.  On a model block, the block's
    part of the whole leaf's subset."""
    flat = x.reshape(x.shape[0], -1)
    a, size = flat.shape
    blk = blocks.current()
    n = size if blk is None else blk.numel
    k = max(1, int(frac * n))
    idx = prng.permutation(key, n)[..., :k].expand(a, k)
    if blk is not None:
        # the subset's entries in the block, at their place there; the
        # others to a column past its end, which is dropped
        local, inside = blk.local_of(idx)
        idx = torch.where(inside, local, size)
    mask = torch.zeros((a, size + 1), dtype=torch.bool,
                       device=x.device).scatter(1, idx, True)[:, :size]
    return (flat * mask).reshape(x.shape).to(x.dtype)


def _f32_bits(s: torch.Tensor) -> torch.Tensor:
    """The int32 bit pattern of finite float32 values, formed from
    ``frexp`` (``torch.func.vmap`` cannot batch a dtype view in some
    torch releases, 2.11 among them): sign, biased exponent and
    mantissa, the subnormals (and zeros) as their integer multiple of
    2^-149."""
    mant, exp = torch.frexp(s)
    biased = exp.to(torch.int64) + 126
    normal = (biased << 23) | ((mant.abs().double() * 2.0 ** 24).to(
        torch.int64) - (1 << 23))
    tiny = (s.abs().double() * 2.0 ** 149).to(torch.int64)
    bits = torch.where((biased > 0) & (s != 0), normal, tiny)
    bits = torch.where(torch.signbit(s), bits | (1 << 31), bits)
    # the low 32 bits as a signed int32
    return (bits - ((bits >> 31) & 1) * (1 << 32)).to(torch.int32)


def randk_salt(x: torch.Tensor) -> torch.Tensor:
    """Each agent's salt: the int32 bit pattern of the fp32 sum of its
    slice (ATen's summation order, which may round one ULP away from
    XLA's and then salts a different subset).  On a model block, the
    blocks' sums summed over "model", which may round apart from the
    whole leaf's sum."""
    s = x.reshape(x.shape[0], -1).float().sum(1)
    blk = blocks.current()
    if blk is not None:
        s = _over_model(s, blk, "randk_salt")
    return _f32_bits(s)


@COMPRESSORS.register("randk", params=(("frac", 0.01), ("seed", 0)),
                      doc="random-k sparsification (shared seed: no index bits)")
def _randk(args, spec):
    frac = float(args["frac"])
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"randk frac must be in (0, 1], got {frac}")
    seed = int(args["seed"])

    def compress(x):
        # sender and receiver draw the subset from shared randomness, so
        # survivors carry no index bits; the salt (the tensor's own
        # bits) stands in for a shared per-round counter
        key = prng.fold_in(prng.host_fold_in(seed), randk_salt(x))
        return randk_sparsify(x, frac, key)

    return Compressor(
        spec,
        compress=compress,
        wire=lambda w: replace(w, frac=w.frac * frac),
    )


@functools.lru_cache(maxsize=32)
def _sketch_tables(rows: int, cols: int, seed: int, size: int):
    """Shared hash/sign tables for one tensor size, drawn on the host as
    the JAX package draws them (numpy, ``SeedSequence((seed, rows, cols,
    size))``)."""
    rng = np.random.default_rng(
        np.random.SeedSequence((seed, rows, cols, size)))
    idx = rng.integers(0, cols, size=(rows, size), dtype=np.int32)
    sign = (rng.integers(0, 2, size=(rows, size)) * 2.0 - 1.0).astype(
        np.float32)
    return idx, sign


@functools.lru_cache(maxsize=32)
def _device_tables(rows: int, cols: int, seed: int, size: int,
                   device: torch.device):
    """The tables on ``device``, copied there once per size."""
    idx, sign = _sketch_tables(rows, cols, seed, size)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(sign).to(device))


def sketch_encode(x: torch.Tensor, rows: int, cols: int,
                  seed: int) -> torch.Tensor:
    """Count-sketch's linear half: each agent's slice of ``x`` scattered
    into a ``(rows, cols)`` f32 counter grid, ``s_r(i)·x_i`` into bucket
    ``h_r(i)``.  Returns ``(A, rows, cols)``: of the whole leaf from a
    model block (its entries' hashes, the grids summed over "model")."""
    flat = x.reshape(x.shape[0], -1).float()
    a, size = flat.shape
    idx, sign = _block_tables(rows, cols, seed, size, x.device)
    contrib = sign[None] * flat[:, None, :]
    grid = torch.zeros((a, rows, cols), dtype=torch.float32, device=x.device)
    grid = grid.scatter_add(2, idx.expand(a, rows, size), contrib)
    blk = blocks.current()
    return grid if blk is None else _over_model(grid, blk, "sketch_grid")


def _block_tables(rows: int, cols: int, seed: int, size: int,
                  device: torch.device):
    """The hash and sign tables of a leaf of ``size`` entries, or of a
    model block's entries in the whole leaf's tables."""
    blk = blocks.current()
    if blk is None:
        return _device_tables(rows, cols, seed, size, device)
    return _device_block_tables(rows, cols, seed, blk.whole, tuple(
        s.indices(n) for s, n in zip(blk.index, blk.whole)), device)


@functools.lru_cache(maxsize=32)
def _device_block_tables(rows: int, cols: int, seed: int, whole: tuple,
                         index: tuple, device: torch.device):
    """A model block's columns of its leaf's tables (the block of the
    leaf of shape ``whole`` at ``index``, each dim's ``slice`` args),
    cut on the host: the device holds the block's part only (the host
    draws the whole leaf's, as the JAX package's stream gives them)."""
    blk = blocks.LeafBlock(whole, tuple(slice(*i) for i in index), None)
    idx, sign = _sketch_tables(rows, cols, seed, blk.numel)
    at = blk.flat_index().numpy()
    return (torch.from_numpy(idx[:, at].astype(np.int64)).to(device),
            torch.from_numpy(sign[:, at]).to(device))


def sketch_decode(sketch: torch.Tensor, shape, dtype, rows: int, cols: int,
                  seed: int) -> torch.Tensor:
    """The median-of-rows estimator of each agent's grid ``(A, rows,
    cols)``: ``median_r(s_r(i)·S[r, h_r(i)])``, the midpoint of the two
    middle rows when ``rows`` is even (``jnp.median``).  Returns
    ``(A, *shape)`` in ``dtype``."""
    size = 1
    for d in shape:
        size *= int(d)
    a = sketch.shape[0]
    idx, sign = _block_tables(rows, cols, seed, size, sketch.device)
    est = sign[None] * torch.gather(sketch, 2, idx.expand(a, rows, size))
    srt = torch.sort(est, dim=1).values
    mid = 0.5 * (rows - 1)
    lo, hi = srt[:, int(np.floor(mid))], srt[:, int(np.ceil(mid))]
    return ((lo + hi) * 0.5).reshape((a,) + tuple(shape)).to(dtype)


def count_sketch(x: torch.Tensor, rows: int, cols: int,
                 seed: int) -> torch.Tensor:
    """Count-sketch round trip (encode, then decode) per agent: the
    tensor the receiver reconstructs, in ``x``'s shape and dtype."""
    return sketch_decode(sketch_encode(x, rows, cols, seed), x.shape[1:],
                         x.dtype, rows, cols, seed)


@COMPRESSORS.register("sketch", params=(("rows", 5), ("cols", 64), ("seed", 0)),
                      doc="count-sketch: fixed rows*cols f32 counters per "
                          "tensor (shared hashes: no index bits)")
def _sketch(args, spec):
    rows, cols, seed = int(args["rows"]), int(args["cols"]), int(args["seed"])
    if rows < 1 or cols < 1:
        raise ValueError(
            f"sketch needs rows >= 1 and cols >= 1, got rows={rows}, "
            f"cols={cols}"
        )
    return Compressor(
        spec,
        compress=lambda x: count_sketch(x, rows, cols, seed),
        # the payload is the counter grid itself: a FIXED rows × cols
        # f32 entries, no index bits, and the frac axis resets
        wire=lambda w: replace(w, abs_entries=float(rows * cols),
                               value_bits=32.0, index_bits=0.0, frac=1.0),
    )


class CompressorChain:
    """Ordered composition of compressor stages (left applied first)."""

    def __init__(self, compressors: Sequence[Compressor]):
        self.stages: Tuple[Compressor, ...] = tuple(compressors)

    def __bool__(self) -> bool:
        return bool(self.stages)

    def _run(self, x: torch.Tensor):
        """``([(stage, its input), ...], output)`` of the stages
        ``compress`` applies: it tracks the running wire format, so cast
        stages the byte model counts as no-ops are also value no-ops."""
        bits = 8.0 * x.element_size()
        fmt = WireFormat(value_bits=bits, dense_bits=bits)
        applied = []
        for c in self.stages:
            if c.cast_bits is None or fmt.value_bits > c.cast_bits:
                applied.append((c, x))
                x = c.compress(x)
            fmt = c.wire(fmt)
        return applied, x

    def compress(self, x: torch.Tensor) -> torch.Tensor:
        """Fake-compress each agent's slice of ``x`` (leading agent axis)."""
        return self._run(x)[1]

    def spacing(self, x: torch.Tensor) -> torch.Tensor:
        """Per entry of ``x`` (leading agent axis): the largest spacing
        of the wire values around it over the chain's rounding stages,
        each at its own input; 0 where no stage rounds."""
        out = torch.zeros_like(x, dtype=torch.float32)
        for c, y in self._run(x)[0]:
            if c.spacing is not None:
                out = torch.maximum(out, c.spacing(y))
        return out

    def rounding_ties(self, x: torch.Tensor, tol) -> torch.Tensor:
        """Per entry of ``x`` (leading agent axis): the spacing of a
        rounding stage whose input entry lies within ``tol`` (broadcast
        against ``x``) of the midpoint between two wire values, else 0.
        A computation of ``x`` that differs from this one by at most
        ``tol`` may send those entries, and only those, one spacing
        apart."""
        out = torch.zeros_like(x, dtype=torch.float32)
        for c, y in self._run(x)[0]:
            if c.spacing is None:
                continue
            step = c.spacing(y)
            levels = y.float().abs() / step
            off = (levels - torch.floor(levels) - 0.5).abs() * step
            tie = (off <= tol) & (y != 0)
            out = torch.where(tie, torch.maximum(out, step), out)
        return out

    def compress_tree(self, tree):
        """Fake-compress a gradient tree with a leading agent axis (each
        leaf under :func:`repro_torch.sharding.blocks.at_leaf`)."""
        return blocks.map_leaves(self.compress, tree)

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


def sketch_params(chain: CompressorChain | None):
    """``(rows, cols, seed)`` of a chain's TERMINAL sketch stage, else
    None (a chain ending in ``sketch`` sends the linear counter grid)."""
    if not chain or not chain.stages:
        return None
    last = chain.stages[-1]
    if last.spec.name != "sketch":
        return None
    args = COMPRESSORS.get("sketch").full_args(last.spec)
    return int(args["rows"]), int(args["cols"]), int(args["seed"])
