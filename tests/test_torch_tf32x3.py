"""The tensor-core arithmetic of the port's LM kernels, on the CPU.

``fused_ce`` and ``swa_attention`` run fp32 inputs on the TF32 tensor
cores in three passes ("3×TF32"): each operand a is split into
hi = tf32(a) and lo = tf32(a − hi), tf32 rounding to nearest (ties away)
at 10 mantissa bits, and a·b ≈ lo·hi + hi·lo + hi·hi.  bf16 inputs go to
bf16 MMAs; ``swa_attention`` splits its fp32 P into two bf16 parts for
P·V.  The CUDA kernels run only on the card, so here a model of their
arithmetic, in the order the kernels run it, is held to the exact
(fp64) result:

* an MMA's products are exact; the tensor cores add them to the
  accumulator a block at a time (4 TF32 or 8 bf16 products), each term
  aligned to the largest one's exponent with the bits below its 24
  significant bits dropped, and round the sum toward zero to fp32 —
  a pessimistic model of their truncating adders;
* each k-chunk (32 fp32 or 64 bf16 columns of D in ``fused_ce``; 32 of
  hd, or a tile's 32 keys, in ``swa_attention``) starts from a zero
  accumulator and is added to the running sum on the CUDA cores in
  round-to-nearest fp32;
* ``swa_attention``: one block of 64 query rows walks its 32-key tiles
  with the online softmax in fp32 and log2 units (exp2 taken exact
  before its fp32 rounding), rescales O by one fused multiply-add per
  tile and divides by l at the end.

The model is held within half of ``chip_smoke.py``'s tolerance
(``CE_TOL`` = 1e-5 + 1e-5·|exact| for logits and NLL, ``SWA_TOL`` = 2e-5
+ 2e-5·|exact| for fp32 attention) at the ``[ce]`` widths and edges and
at the ``[swa]`` shapes' worst blocks (the last query tile, which sees
the whole window); the JAX package's fp32 reference is held within the
other half where it runs at that size on the CPU, so kernel and plain
version can differ by at most the tolerance.  The vocabulary and the
rows are subsets: a logit's error depends on D alone, and the NLL's on
the largest logit errors.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.fused_ce import ref as jax_ce_ref
from repro.kernels.swa_attention import ref as jax_swa_ref
from repro_torch.kernels import build
from repro_torch.kernels.fused_ce import ops as ce_ops

CE_TOL = 1e-5
SWA_TOL = 2e-5
SMS = 132  # the H100 SXM's streaming multiprocessors
NEG = -1e30


# ---------------------------------------------------------------------------
# roundings
# ---------------------------------------------------------------------------

def tf32(a: np.ndarray) -> np.ndarray:
    """Round fp32 values to TF32 as the kernels do (``to_tf32`` in
    ``kernels/csrc/mma_sm90.cuh``): add half a unit in the last place of
    the 10-bit mantissa to the bit pattern, clear the 13 bits below."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def bf16(a: np.ndarray) -> np.ndarray:
    """Round fp32 values to bf16 (to nearest, ties to even), as fp32."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                       & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def rn32(x: np.ndarray) -> np.ndarray:
    """fp64 values rounded to nearest fp32 (as fp64)."""
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def rz32(x: np.ndarray) -> np.ndarray:
    """fp64 values rounded toward zero to fp32 (as fp64)."""
    x = np.asarray(x, np.float64)
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def split(a: np.ndarray):
    """(hi, lo) of the 3×TF32 split, as fp64 (exact)."""
    a = np.asarray(a, np.float32)
    hi = tf32(a)
    lo = tf32(a - hi)  # a − hi is exact in fp32
    return hi.astype(np.float64), lo.astype(np.float64)


def split_bf16(a: np.ndarray):
    """(hi, lo) of an fp32 value as two bf16 parts (``split_bf16x2``)."""
    a = np.asarray(a, np.float32)
    hi = bf16(a)
    return hi.astype(np.float64), bf16(a - hi).astype(np.float64)


# ---------------------------------------------------------------------------
# the tensor cores' sums
# ---------------------------------------------------------------------------

def tc_add(c: np.ndarray, prods: np.ndarray, block: int) -> np.ndarray:
    """c + Σ prods over the last axis as the model of the tensor cores
    takes it: ``block`` products at a time with c, every term cut to the
    largest one's 24-bit grid (truncation), summed exactly, the sum
    rounded toward zero to fp32."""
    for b0 in range(0, prods.shape[-1], block):
        terms = np.concatenate([c[..., None], prods[..., b0:b0 + block]], -1)
        _, e = np.frexp(np.abs(terms).max(-1, keepdims=True))
        unit = np.ldexp(1.0, e - 24)
        c = rz32((np.trunc(terms / unit) * unit).sum(-1))
    return c


def mma_chunk(passes, k0: int, k1: int, step: int, block: int):
    """One k-chunk [k0, k1) into a fresh accumulator: k-steps of ``step``
    columns, each running the ``passes`` ((A, B) pairs, A (M, K), B (N,
    K), in the order they run)."""
    a0, b0 = passes[0]
    c = np.zeros((a0.shape[0], b0.shape[0]))
    for ks in range(k0, k1, step):
        for a, b in passes:
            c = tc_add(c, a[:, None, ks:ks + step] * b[None, :, ks:ks + step],
                       block)
    return c


def _pad(a: np.ndarray, k: int) -> np.ndarray:
    return np.pad(a, ((0, 0), (0, -a.shape[1] % k)))


def _passes(a: np.ndarray, b: np.ndarray, fp32: bool):
    """(A, B) operand pairs of one product: 3×TF32 small terms first, or
    the bf16 values once."""
    if not fp32:
        return [(a.astype(np.float64), b.astype(np.float64))]
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]


def chunked_matmul(a: np.ndarray, b: np.ndarray, fp32: bool, chunk: int,
                   chunked: bool = True, ragged: bool = False) -> np.ndarray:
    """a (M, K) @ b (N, K)ᵀ: k-chunks of ``chunk`` columns, each in a fresh
    accumulator added in round-to-nearest fp32 (or, with ``chunked``
    False, the whole of K in one accumulator).  K is padded with zeros
    to whole chunks (``fused_ce``'s copies), or with ``ragged`` the last
    chunk is cut short at K (``swa_attention``'s loop over hd's
    k-steps)."""
    step, block = (8, 4) if fp32 else (16, 8)
    if ragged:
        assert a.shape[1] % step == 0, "hd is a whole number of k-steps"
        passes = _passes(a, b, fp32)
    else:
        passes = _passes(_pad(a, chunk), _pad(b, chunk), fp32)
    k = passes[0][0].shape[1]
    if not chunked:
        return mma_chunk(passes, 0, k, step, block)
    acc = np.zeros((a.shape[0], b.shape[0]))
    for k0 in range(0, k, chunk):
        acc = rn32(acc + mma_chunk(passes, k0, min(k0 + chunk, k), step,
                                   block))
    return acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_rounds_to_nearest_ties_away(seed):
    """The bit trick against an independent rounding: to the nearest
    multiple of the value's TF32 unit in the last place 2^(e − 10), ties
    away from zero — on normal values of many magnitudes and on exact
    ties."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096))
         ).astype(np.float32)
    # exact ties: a TF32 value plus half its last place
    base = tf32(rng.standard_normal(256).astype(np.float32))
    e = np.floor(np.log2(np.abs(base.astype(np.float64))))
    a = np.concatenate([a, (base + np.sign(base) * np.exp2(e - 11)).astype(
        np.float32)])
    x = a.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x))) - 10)
    want = np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp
    got = tf32(a).astype(np.float64)
    np.testing.assert_array_equal(got, want)
    assert not (tf32(a).view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_carries_22_bits(seed):
    """hi + lo recovers a to within 2^-21 of |a| (the TF32 rounding of
    lo), and hi carries a to within 2^-11; two bf16 parts carry it to
    within 2^-17."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(10000).astype(np.float32)
    hi, lo = split(a)
    x = a.astype(np.float64)
    assert np.all(np.abs(x - hi) <= 2.0 ** -11 * np.abs(x))
    assert np.all(np.abs(x - hi - lo) <= 2.0 ** -21 * np.abs(x))
    hi, lo = split_bf16(a)
    assert np.all(np.abs(x - hi - lo) <= 2.0 ** -17 * np.abs(x))


# ---------------------------------------------------------------------------
# fused_ce: logits and NLL
# ---------------------------------------------------------------------------

def _ce_inputs(t, d, v, seed, fp32):
    """The ``[ce]`` check's magnitudes: x ~ N(0, 1), table ~ 2·N(0, 1)/√D
    (logits of spread ~2 at every width), labels including 0 and V − 1;
    bf16 inputs are those values rounded to bf16."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    table = (rng.standard_normal((v, d)) * (2.0 / math.sqrt(d))).astype(
        np.float32)
    if not fp32:
        x, table = bf16(x), bf16(table)
    labels = rng.integers(0, v, t)
    labels[:2] = (0, v - 1)
    return x, table, labels


def _logsumexp(z: np.ndarray) -> np.ndarray:
    m = z.max(-1, keepdims=True)
    return (m + np.log(np.exp(z - m).sum(-1, keepdims=True)))[..., 0]


def _nll(logits, labels):
    return _logsumexp(logits) - logits[np.arange(len(labels)), labels]


@pytest.mark.parametrize("d", [64, 100, 200, 576, 3072])
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_fused_ce_arithmetic_within_half_ce_tol(fp32, d):
    """fused_ce.cu's logits (k-chunks of 128 bytes of D, four k-steps of
    TF32 m64n128k8 or bf16 m64n128k16 wgmmas) and the NLL from them,
    against the exact result, at the ``[ce]`` widths and edge widths (D
    not a multiple of a chunk: zeros past D)."""
    t, v = 32, 128
    x, table, labels = _ce_inputs(t, d, v, seed=d + fp32, fp32=fp32)
    exact = x.astype(np.float64) @ table.astype(np.float64).T
    logits = chunked_matmul(x, table, fp32, chunk=32 if fp32 else 64)
    half = CE_TOL / 2
    assert np.all(np.abs(logits - exact) <= half + half * np.abs(exact))
    nll_exact = _nll(exact, labels)
    err = np.abs(_nll(logits, labels) - nll_exact)
    assert np.all(err <= half + half * np.abs(nll_exact))
    # the plain fp32 version (the JAX oracle) within the other half
    jax_nll = np.asarray(jax_ce_ref.fused_ce_ref(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels, jnp.int32)),
        np.float64)
    assert np.all(np.abs(jax_nll - nll_exact)
                  <= half + half * np.abs(nll_exact))


@pytest.mark.parametrize("d", [576, 3072])
def test_dropping_the_small_terms_would_miss_ce_tol(d):
    """What the two small products buy: plain TF32 (hi·hi alone) errs far
    outside the tolerance at these widths, so 3×TF32 is needed for it."""
    x, table, _ = _ce_inputs(64, d, 512, seed=d + 1, fp32=True)
    exact = x.astype(np.float64) @ table.astype(np.float64).T
    x_hi, _ = split(x)
    t_hi, _ = split(table)
    err = np.abs(x_hi @ t_hi.T - exact)
    assert np.any(err > CE_TOL + CE_TOL * np.abs(exact))


@pytest.mark.parametrize("d", [3072, 5120])
def test_one_accumulator_over_d_would_drift(d):
    """What the chunks buy: the same 3×TF32 MMAs chained into one
    accumulator over all of D drift with the tensor cores' truncation
    beyond the tolerance that the chunked sums keep."""
    x, table, _ = _ce_inputs(32, d, 128, seed=d + 2, fp32=True)
    exact = x.astype(np.float64) @ table.astype(np.float64).T
    chained = chunked_matmul(x, table, True, chunk=32, chunked=False)
    assert np.any(np.abs(chained - exact) > CE_TOL + CE_TOL * np.abs(exact))


# ---------------------------------------------------------------------------
# swa_attention: one block of 64 query rows
# ---------------------------------------------------------------------------

KEY_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # a tf32 P·V k-step's keys


def swa_block(q, k, v, q0: int, window: int, fp32: bool,
              p_parts: int = 2, round_out: bool = True) -> np.ndarray:
    """Rows q0 … q0 + 63 of one head (q (S, hd), k and v (S, hd) of its kv
    head, values fp32 or bf16) as swa_attention.cu computes them: the
    block's key tiles, Q·Kᵀ in k-chunks of 32 (fp32) or 64 (bf16) of hd
    (the last one ragged where hd is not a multiple), the online softmax in log2 units, P·V per 32-key tile (tf32: 3×TF32
    in the kernel's key order; bf16: P in ``p_parts`` bf16 parts, small
    part first), O rescaled by one FMA per tile, O / max(l, 1e-30) at the
    end, rounded to the input's dtype unless ``round_out`` is False."""
    s_len, hd = q.shape
    rows = np.arange(q0, min(q0 + 64, s_len))
    q_last = rows[-1]
    scale = rn32(np.float32(1.4426950408889634) / np.sqrt(np.float32(hd)))
    m = np.full(len(rows), NEG)
    l = np.zeros(len(rows))
    o = np.zeros((len(rows), hd))
    qs = q[rows]
    for t in range(max(q0 - window + 1, 0) // 32, q_last // 32 + 1):
        keys = np.arange(t * 32, t * 32 + 32)
        kt = np.zeros((32, hd), np.float32)
        vt = np.zeros((32, hd), np.float32)
        kt[keys < s_len] = k[keys[keys < s_len]]
        vt[keys < s_len] = v[keys[keys < s_len]]
        s = chunked_matmul(qs, kt, fp32, chunk=32 if fp32 else 64,
                           ragged=True)
        keep = ((keys[None] <= rows[:, None])
                & (keys[None] > rows[:, None] - window)
                & (keys[None] < s_len))
        x = np.where(keep, rn32(s * scale), NEG)
        m_new = np.maximum(m, x.max(-1))
        alpha = rn32(np.exp2(rn32(m - m_new)))
        p = np.where(keep, rn32(np.exp2(rn32(x - m_new[:, None]))), 0.0)
        l = rn32(l * alpha + rn32(p.sum(-1)))
        p32 = p.astype(np.float32)
        if fp32:
            order = (np.arange(32).reshape(4, 8)[:, KEY_ORDER]).ravel()
            passes = _passes(p32[:, order], vt.T[:, order], True)
            c = mma_chunk(passes, 0, 32, 8, 4)
        else:
            p_hi, p_lo = split_bf16(p32)
            parts = [p_lo, p_hi] if p_parts == 2 else [bf16(p32)]
            vtt = vt.T.astype(np.float64)
            c = mma_chunk([(a, vtt) for a in parts], 0, 32, 16, 8)
        o = rn32(o * alpha[:, None] + c)
        m = m_new
    out = rn32(o * rn32(1.0 / np.maximum(l, 1e-30))[:, None])
    return out if fp32 or not round_out else bf16(out).astype(np.float64)


def _swa_exact(q, k, v, rows, window):
    """Rows of sliding-window causal attention in fp64."""
    hd = q.shape[1]
    s = q[rows].astype(np.float64) @ k.astype(np.float64).T / math.sqrt(hd)
    pos = np.arange(k.shape[0])
    keep = (pos[None] <= rows[:, None]) & (pos[None] > rows[:, None] - window)
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p @ v.astype(np.float64)) / p.sum(-1, keepdims=True)


def _swa_inputs(shape, seed, fp32):
    """Normal q, k, v in the model layout (the ``[swa]`` check's)."""
    b, s, h, kv, hd, _ = shape
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((b, s, n, hd)).astype(np.float32)
           for n in (h, kv, kv)]
    return out if fp32 else [bf16(x) for x in out]


# the [swa] check's shapes (B, S, H, KV, hd, W): the served two, the JAX
# tests' S = 384 row of its grid, one hd = 128 shape and the hd = 128 edge;
# then the head dims whose k-chunks are ragged in bf16 (2 k16-steps at hd
# 32, 4 + 2 at hd 96) and whose fp32 P·V takes n8 tiles in a ragged last
# group (4 at hd 32, 8 + 4 at hd 96): phi-3-vision's served shape, the
# reduced smollm's hd 32 at --d-model 128, and both head dims' edges
SWA_SHAPES = ((4, 1024, 9, 3, 64, 1024), (1, 6000, 9, 3, 64, 4096),
              (2, 384, 4, 2, 64, 32), (2, 384, 4, 2, 64, 128),
              (2, 384, 4, 2, 64, 1 << 30), (1, 2048, 24, 8, 128, 512),
              (1, 1000, 8, 2, 128, 300),
              (4, 512, 32, 32, 96, 512), (4, 1024, 4, 2, 32, 1024),
              (1, 1000, 8, 2, 96, 300), (1, 77, 6, 3, 32, 5))


def _swa_case(shape, fp32, **kw):
    """The model and the exact result for the last query tile (the one
    that sees the whole window) of the last batch entry and head (kv head
    H/(H/KV) − 1 by GQA)."""
    b, s, h, kv, hd, w = shape
    w = min(w, s)
    q, k, v = _swa_inputs(shape, seed=s + w + fp32, fp32=fp32)
    hq, hk = h - 1, (h - 1) // (h // kv)
    q0 = (s - 1) // 64 * 64
    rows = np.arange(q0, s)
    got = swa_block(q[-1, :, hq], k[-1, :, hk], v[-1, :, hk], q0, w, fp32,
                    **kw)
    exact = _swa_exact(q[-1, :, hq], k[-1, :, hk], v[-1, :, hk], rows, w)
    return got, exact, (q, k, v, rows, hq)


@pytest.mark.parametrize("shape", SWA_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])) + f"W{s[5]}")
def test_swa_fp32_arithmetic_within_half_swa_tol(shape):
    got, exact, (q, k, v, rows, hq) = _swa_case(shape, fp32=True)
    half = SWA_TOL / 2
    assert np.all(np.abs(got - exact) <= half + half * np.abs(exact))
    if shape[1] <= 384:  # the JAX oracle over the whole sequence
        w = shape[-1]
        plain = np.asarray(jax_swa_ref.swa_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=w),
            np.float64)[-1, rows, hq]
        assert np.all(np.abs(plain - exact) <= half + half * np.abs(exact))


@pytest.mark.parametrize("shape", SWA_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])) + f"W{s[5]}")
def test_swa_bf16_p_v_keeps_fp32_p(shape):
    """bf16 inputs: with P in two bf16 parts, O before its rounding to
    bf16 is within half the fp32 tolerance of the exact result on the
    same (bf16) inputs: P·V as precise as the TPU kernel's fp32 P·V."""
    got, exact, _ = _swa_case(shape, fp32=False, round_out=False)
    half = SWA_TOL / 2
    assert np.all(np.abs(got - exact) <= half + half * np.abs(exact))


@pytest.mark.parametrize("shape", [SWA_SHAPES[0], SWA_SHAPES[2]],
                         ids=["4x1024x9x3x64W1024", "2x384x4x2x64W32"])
def test_swa_bf16_p_in_one_part_would_not(shape):
    """What the second part buys: P rounded once to bf16 for P·V errs
    beyond the fp32 tolerance before the output's rounding."""
    got, exact, _ = _swa_case(shape, fp32=False, p_parts=1, round_out=False)
    assert np.any(np.abs(got - exact) > SWA_TOL + SWA_TOL * np.abs(exact))


# ---------------------------------------------------------------------------
# launch plan and build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups,tokens,vocab", [
    (1, 8192, 49152), (4, 2048, 49152), (1, 4096, 128256), (1, 64, 7),
    (1, 1000, 50257), (1, 129, 129), (1, 257, 49153), (64, 64, 151936)])
def test_vocab_split_plan_within_grid_limits(groups, tokens, vocab):
    """Every vocab tile in exactly one range, within the grid's limits,
    and enough blocks for the card unless the vocab has too few tiles."""
    nsplit, per = ce_ops.vocab_split(groups, tokens, vocab, sms=SMS)
    tiles = -(-vocab // ce_ops.BLOCK_V)
    assert 1 <= nsplit <= min(tiles, ce_ops.MAX_GRID)
    assert (nsplit - 1) * per < tiles <= nsplit * per
    blocks = groups * -(-tokens // ce_ops.BLOCK_T) * nsplit
    assert blocks >= min(SMS, groups * -(-tokens // ce_ops.BLOCK_T) * tiles)


def test_shared_headers_are_part_of_the_library_hash(tmp_path, monkeypatch):
    """An edited shared header (``kernels/csrc/*.cuh``) names a new
    library, so it is rebuilt."""
    src = tmp_path / "k" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// kernel\n")
    include = tmp_path / "include"
    include.mkdir()
    header = include / "common.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "INCLUDE", include)
    first = build.library_path(src)
    assert first == build.library_path(src)
    header.write_text("// two\n")
    assert build.library_path(src) != first
    assert build.library_path(src).parent == src.parent.parent / "build"
