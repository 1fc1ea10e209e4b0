"""Threefry-2x32 counter-based random numbers, bit for bit as ``jax.random``.

The port of the parts of ``jax.random`` the JAX package draws through:
``PRNGKey``/``key``, ``fold_in``, ``split``, ``bits`` (32-bit
``random_bits``), ``uniform`` (float32) and ``permutation`` (the
sort-based shuffle), in the *partitionable* layout
(``jax_threefry_partitionable=True``, the default from JAX 0.5): the
counters of an output of shape ``S`` are the 64-bit row-major iota over
``S`` split into its high and low 32-bit words, so element ``i`` of
``split(key, n)`` is ``fold_in(key, i)`` and element ``i`` of
``bits(key, S)`` is the XOR of the two words threefry makes of counter
``(hi(i), lo(i))``.

Representation.  A key is a tensor of shape ``(..., 2)``: the two
uint32 words, held in ``int64`` and always in ``[0, 2**32)``; or, where
it depends on host values only, a *host key*: a tuple of two Python ints
(:func:`host_fold_in`), which ``fold_in`` takes in place of a tensor.  Every
function takes a leading batch of keys (``(B, 2)``, or any ``(..., 2)``)
and returns one result per key, so one call derives, say, all 64 agents'
keys of a round.  The arithmetic is uint32 arithmetic done in ``int64``
and masked with ``0xFFFFFFFF`` (``torch.uint32`` has partial operator
coverage); a rotation is ``((x << r) | (x >> (32 - r))) & mask``.  The
same code runs on Python ints, which is how a key that depends only on
host values (a seed and a step counter) is derived on the host, with no
device op and no copy.

Seeds follow JAX with 64-bit types disabled: ``PRNGKey(seed)`` is
``[0, seed mod 2**32]``.  ``normal`` draws its uniforms bit for bit as
JAX does and maps them through XLA's ``erf_inv`` polynomial; the
logarithm inside is ATen's, so a draw may differ from JAX's in the last
places (ROADMAP §3 records the measured gap).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 block cipher (20 rounds) on key words
    ``(k0, k1)`` and counter words ``(x0, x1)``, each a Python int or an
    ``int64`` tensor of uint32 values; tensors broadcast.  Returns the
    two output words.

    Only the low 32 bits of a sum matter, so the first word is masked
    once, at the end (it grows below 2**38 in int64); the second is
    masked after each XOR, before it is rotated again."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    v0 = x0 + ks[0]
    v1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            v0 = v0 + v1
            v1 = (((v1 << r) | (v1 >> (32 - r))) ^ v0) & MASK
        v0 = v0 + ks[(i + 1) % 3]
        v1 = (v1 + (ks[(i + 2) % 3] + (i + 1))) & MASK
    return v0 & MASK, v1


def _words(key) -> Tuple[Word, Word]:
    if isinstance(key, tuple):
        return key  # a host key: two Python ints
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 words in its last axis, got shape "
                         f"{tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def _as_uint32(data: Word) -> Word:
    """``jnp.uint32(data)``: an int32 (or any integer) as its low 32 bits."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.int64) & MASK
    return int(data) & MASK


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """The ``(2,)`` key of an integer seed: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


key = PRNGKey


def host_fold_in(seed: int, *data: int) -> Tuple[int, int]:
    """``fold_in(... fold_in(PRNGKey(seed), data[0]) ..., data[-1])`` on
    Python ints: the key words of a derivation from host values only."""
    k0, k1 = 0, int(seed) & MASK
    for d in data:
        k0, k1 = threefry2x32(k0, k1, 0, int(d) & MASK)
    return k0, k1


def fold_in(key, data: Word) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter ``(0, uint32(data))``
    under ``key``.  ``key`` is ``(..., 2)`` or a host key; ``data`` an
    int or an integer tensor (at least one of the two a tensor) that
    broadcasts against ``key[..., 0]``.  Negative int32 data is folded
    by its bit pattern, as ``jnp.uint32`` does."""
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, 0, _as_uint32(data))
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The high and low words of the row-major 64-bit iota over ``shape``."""
    n = math.prod(shape)
    if n > 1 << 62:
        raise ValueError(f"{n} counters exceed the int64 iota")
    iota = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    return iota >> 32, iota & MASK


def _hash(key: torch.Tensor, shape: Sequence[int]):
    """Both output words over the counters of ``shape``, per key:
    ``(..., *shape)`` each."""
    k0, k1 = _words(key)
    c_hi, c_lo = _counters(shape, key.device)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(k0[expand], k1[expand], c_hi, c_lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., num, 2)`` keys (``[i]`` equals
    ``fold_in(key, i)`` in the partitionable layout)."""
    y0, y1 = _hash(key, (num,))
    return torch.stack([y0, y1], -1)


def bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): ``(..., *shape)`` uint32 values in
    ``int64``."""
    shape = tuple(shape)
    if not shape:
        k0, k1 = _words(key)
        y0, y1 = threefry2x32(k0, k1, 0, 0)
        return y0 ^ y1
    y0, y1 = _hash(key, shape)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: Sequence[int] = (), *,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``: the
    top 23 bits as the mantissa of a float in ``[1, 2)``, minus 1, then
    ``max(minval, u · (maxval − minval) + minval)``.

    XLA contracts ``u · (maxval − minval) + minval`` into one fused
    multiply-add; here the product is exact in float64 and the sum is
    rounded to float64 and then to float32, which is the fused result
    but for a tie in the second rounding (about one draw in 2**29)."""
    b = bits(key, shape)
    # the float of bits (b >> 9) | 0x3F800000 is 1 + m·2^-23 for the top
    # 23 bits m; minus 1 it is m·2^-23, exact in float32 (formed without
    # a dtype view, which torch.func.vmap cannot batch in some torch
    # releases, 2.11 among them)
    f = (b >> 9).to(torch.float32) * 2.0 ** -23
    if minval == 0.0 and maxval == 1.0:
        return f  # u · 1 + 0 and the clamp at 0 leave u as it is
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = (f.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp(fused, min=float(lo))


# XLA's float32 erf_inv (Giles' polynomials in w = −log1p(−x²), split
# at w = 5), highest-degree coefficient first
_ERF_INV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Giles' single-precision polynomial,
    its Horner steps as fused multiply-adds (a float64 product-sum
    rounded once to float32), ``±inf`` at ``±1``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0

    def coef(i):
        return torch.where(lt, float(np.float32(_ERF_INV_W_LT_5[i])),
                           float(np.float32(_ERF_INV_W_GE_5[i])))

    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = coef(0)
    for i in range(1, len(_ERF_INV_W_LT_5)):
        p = (coef(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``uniform`` over
    ``[nextafter(−1, 0), 1)``, then ``sqrt(2) · erf_inv(u)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, minval=float(lo), maxval=1.0)
    return float(np.float32(np.sqrt(2.0))) * erf_inv(u)


def _shuffle_rounds(n: int) -> int:
    # JAX's static stop rule for the sort-based shuffle (exponent 3)
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``(..., n)`` int64 indices.

    Each round splits the key in two, draws 32-bit sort keys over ``n``
    from the second and sorts the running order by them, stably, as
    ``lax.sort_key_val`` does."""
    lead = tuple(key.shape[:-1])
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        *lead, n)
    for _ in range(_shuffle_rounds(n)):
        pair = split(key)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
