// swa_attention.cu — sliding-window causal flash-attention forward, GQA,
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel in src/repro/kernels/swa_attention/kernel.py
// (swa_attention_kernel, body _kernel): softmax((q·kᵀ)/√hd) · v over the keys
// (t − W, t] of each query t, with an online softmax (running max m, sum l,
// accumulator acc) in fp32, so no (S, S) score matrix ever reaches memory,
// and only the key tiles that meet a query tile's window are visited:
// O(S·W) work, not O(S²).
//
// The TPU kernel walks a sequential grid whose innermost axis carries m, l
// and acc in VMEM from one key block to the next.  Hopper blocks run in
// parallel and carry nothing, so here ONE block owns one (batch, q-head,
// tile of 64 query rows) and loops over its key tiles itself, in the
// FlashAttention-2 layout:
//
//   - The grid is one axis with the query tile slowest, so the blocks of
//     the latest query tiles, which see the most keys, start first on every
//     (batch, head), and the short ones fill in behind them (the longest
//     block bounds the launch).
//   - 4 warps × 16 query rows.  The Q tile is staged once; K and V tiles of
//     32 keys are double-buffered in shared memory with cp.async (the next
//     tile's copy runs under this tile's products).  Rows are padded by 16
//     bytes, so the fragment loads fall in distinct banks.  Small tiles
//     keep a thread's registers and a block's shared memory low enough
//     (≤ 168 registers and 51 KB at hd = 64) for 3 blocks per SM, whose
//     12 warps hide each other's load and MMA latencies.
//   - S = Q·Kᵀ (16 × 32 per warp) on mma.sync: fp32 inputs in 3×TF32
//     (m16n8k8; each fragment split into hi = tf32(a) and lo = tf32(a − hi)
//     as it is loaded, tf32 rounding to nearest at 10 mantissa bits,
//     a·b ≈ lo·hi + hi·lo + hi·hi, the small terms first), bf16 inputs on
//     m16n8k16 bf16 MMAs.
//   - The online softmax runs on the accumulator fragments in registers,
//     in log2 units (exp2 on the special-function unit): a row lives in
//     the 4 lanes of a quad, so its max is two shuffles; each lane keeps
//     its own part of l (m is the same in the quad), summed by the quad
//     once at the end.
//   - O += P·V with P kept in registers as the A operand.  bf16: the S
//     accumulators of two neighbouring n8 tiles are exactly the m16n8k16 A
//     fragment, and V comes in with ldmatrix.trans; P is split into two
//     bf16 parts, hi = bf16(p) and lo = bf16(p − hi), and P·V runs as
//     lo·V + hi·V (exact products), so P keeps about 17 bits as the TPU
//     kernel's fp32 P·V does, where one bf16 P would keep 8.  fp32:
//     a lane holds the scores of keys 2c, 2c + 1 where the m16n8k8 A
//     fragment wants keys c, c + 4; rather than shuffle, the 8 keys of each
//     k-step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7) for P and V
//     alike (the sum over keys does not care), so P's fragment is its own
//     registers and V is read at rows 2c and 2c + 1.  P and V are split
//     hi/lo like the scores.
//   - The tensor cores round their sums toward zero, so each short k-chunk
//     (4 k-steps of hd for S: 32 columns in fp32, 64 in bf16, the last one
//     ragged where hd is not a multiple of that; a tile's 32 keys for P·V)
//     is summed into a fresh accumulator and added to S or O in
//     round-to-nearest on the CUDA cores (for O in one FMA with the online
//     softmax's rescale).
//   - The tile of queries is written once, O / max(l, 1e-30), in the
//     input's dtype.
//
// Masking follows the TPU kernel: a masked score is −1e30 (not −inf) and
// p = exp(s − m)·mask, so a tile masked entirely for a row leaves that
// row's m, l and acc unchanged instead of producing NaN.  Rows and keys
// past S (a ragged last tile) are masked by bounds here; the caller pads
// nothing.  The model layout (B, S, H, hd) / (B, S, KV, hd) is read through
// strides (the head dim must be contiguous), so no transposed copy is
// made; an input whose base or strides are not multiples of 16 bytes is
// staged by plain loads into the same layout.  GQA: query head h reads kv
// head h / (H / KV), as _expand_kv repeats heads.  No atomics: a repeated
// launch is bitwise equal.
//
// Bound: operations.  4·hd flops per (query, visible key) pair against
// (q, k, v, o) read or written once — hundreds of flops per byte at
// hd = 64.  fp32 runs three TF32 products per product, so its floor is
// 3 · 4·hd flops per pair at the dense TF32 rate (494.7 TFLOP/s); bf16
// runs Q·Kᵀ once and P·V twice, 6·hd at the bf16 rate (989 TFLOP/s).
// Fragments come from shared memory by 32-bit loads and are split on the
// CUDA cores, which with the softmax keeps mma.sync well short of either
// (the instructions per MMA, not the bytes, bound it); wgmma with TMA-fed
// tiles is the later step.
//
// C interface (loaded with ctypes by ops.py):
//   int swa_attention_launch(q, k, v, o, B, S, H, KV, hd, window,
//                            strides, dtype, stream)
//       enqueues the forward on `stream`; returns cudaGetLastError().
//       strides: 12 int64 element strides, (batch, seq, head) for each of
//       q, k, v, o.  hd ∈ {32, 64, 96, 128}; dtype: 0 = float32,
//       1 = bfloat16; any other hd or dtype returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block: 4 warps × 16
constexpr int kBK = 32;        // keys per tile
constexpr int kNT = kBK / 8;   // n8 tiles of scores per warp
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

struct Strides {
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// row stride of a staged tile in 32-bit words: hd elements plus 16 bytes
template <typename T, int HD>
__host__ __device__ constexpr int row_words() {
  return HD * (int)sizeof(T) / 4 + 4;
}

template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes() {
  // the Q tile, and two buffers each of the K and V tiles
  return (kBQ + 4 * kBK) * row_words<T, HD>() * 4;
}

// Stage `rows` rows of hd elements (row r at base + (r0 + r)·stride) into
// `dst`; rows at or past S are zeros.  16-byte cp.async when `vec`, plain
// loads otherwise, into the same layout.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage_tile(uint32_t* dst, const T* base,
                                           int64_t stride, int r0, int S,
                                           bool vec, int tid) {
  constexpr int kLd = row_words<T, HD>();
  constexpr int kEpv = 16 / sizeof(T);  // elements per 16-byte segment
  constexpr int kSegs = HD / kEpv;      // segments per row
  static_assert(ROWS * kSegs % kThreads == 0,
                "a tile's 16-byte segments split evenly over the threads");
#pragma unroll
  for (int i = 0; i < ROWS * kSegs / kThreads; ++i) {
    const int seg = tid + i * kThreads;
    const int r = seg / kSegs, c = seg % kSegs;
    const int row = r0 + r;
    tc::stage16(dst + r * kLd + c * 4,
                base + (int64_t)row * stride + c * kEpv, base,
                row < S ? kEpv : 0, vec);
  }
}

__device__ __forceinline__ void zero(float (&c)[kNT][4]) {
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// s = Q·Kᵀ for the warp's 16 rows (Qw) and the tile's kBK keys (Kb)
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[kNT][4], const uint32_t* Qw,
                                       const uint32_t* Kb, int gid, int tig) {
  constexpr int kLd = row_words<T, HD>();
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kSteps = kF32 ? HD / 8 : HD / 16;  // k8 or k16 steps
  static_assert(HD % 16 == 0, "hd is a whole number of k16 steps");
  zero(s);
#pragma unroll
  for (int c0 = 0; c0 < kSteps; c0 += 4) {  // chunks of 4 steps
    // the last chunk is ragged where kSteps is not a multiple of 4 (bf16
    // at hd 32: 2 steps; at hd 96: 4 + 2)
    constexpr int kChunk = 4;
    const int c1 = c0 + kChunk < kSteps ? c0 + kChunk : kSteps;
    float c[kNT][4];
    zero(c);
#pragma unroll
    for (int ks = c0; ks < c1; ++ks) {
      const int k = ks * 8 + tig;  // in words
      const uint32_t w[4] = {Qw[gid * kLd + k], Qw[(gid + 8) * kLd + k],
                             Qw[gid * kLd + k + 4],
                             Qw[(gid + 8) * kLd + k + 4]};
      if constexpr (kF32) {
        uint32_t a_hi[4], a_lo[4], b_hi[kNT][2], b_lo[kNT][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tc::split_tf32(__uint_as_float(w[j]), a_hi[j], a_lo[j]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t* kr = Kb + (nt * 8 + gid) * kLd;
          tc::split_tf32(__uint_as_float(kr[k]), b_hi[nt][0], b_lo[nt][0]);
          tc::split_tf32(__uint_as_float(kr[k + 4]), b_hi[nt][1],
                         b_lo[nt][1]);
        }
        // lo·hi, then hi·lo, then hi·hi, each over the tiles
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) tc::mma_tf32(c[nt], a_lo, b_hi[nt]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) tc::mma_tf32(c[nt], a_hi, b_lo[nt]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) tc::mma_tf32(c[nt], a_hi, b_hi[nt]);
      } else {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t* kr = Kb + (nt * 8 + gid) * kLd;
          const uint32_t b[2] = {kr[k], kr[k + 4]};
          tc::mma_bf16(c[nt], w, b);
        }
      }
    }
    tc::add_chunk(s, c);
  }
}

// o = o·alpha + P·V for the warp's 16 rows (alpha per row: the online
// softmax's rescale); p holds P in the S accumulator layout.  The tile's
// 32 keys are one k-chunk: every n8 tile of hd gets a fresh accumulator
// (so the MMAs of a k-step are independent), added to o in round-to-
// nearest by one FMA with the rescale.
template <typename T, int HD>
__device__ __forceinline__ void add_pv(float (&o)[HD / 8][4],
                                       const float (&p)[kNT][4],
                                       const float (&alpha)[2],
                                       const uint32_t* Vb, int lane, int gid,
                                       int tig) {
  constexpr int kLd = row_words<T, HD>();
  constexpr int kN = HD / 8;  // n8 tiles of hd
  static_assert(kBK == 32, "one k-chunk of 32 keys per tile");
  float c[kN][4];
#pragma unroll
  for (int nn = 0; nn < kN; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nn][e] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    // k-step j covers keys 8j … 8j + 7 in the order 2c, 2c + 1 ↔ c, c + 4:
    // a0 = p(row gid, key 8j + 2·tig), a2 = p(row gid, key 8j + 2·tig + 1)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t a_hi[4], a_lo[4];
      const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::split_tf32(a[e], a_hi[e], a_lo[e]);
      const uint32_t* vr = Vb + (j * 8 + 2 * tig) * kLd + gid;
#pragma unroll
      for (int n0 = 0; n0 < kN; n0 += 8) {  // 8 tiles at a time
        // the last group is ragged where kN is not a multiple of 8 (hd 32:
        // 4 tiles; hd 96: 8 + 4)
        constexpr int kGroup = 8;
        const int g = n0 + kGroup < kN ? kGroup : kN - n0;
        uint32_t b_hi[kGroup][2], b_lo[kGroup][2];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < g) {
            const int nn = n0 + i;
            tc::split_tf32(__uint_as_float(vr[nn * 8]), b_hi[i][0],
                           b_lo[i][0]);
            tc::split_tf32(__uint_as_float(vr[kLd + nn * 8]), b_hi[i][1],
                           b_lo[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (i < g) tc::mma_tf32(c[n0 + i], a_lo, b_hi[i]);
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (i < g) tc::mma_tf32(c[n0 + i], a_hi, b_lo[i]);
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (i < g) tc::mma_tf32(c[n0 + i], a_hi, b_hi[i]);
      }
    }
  } else {
    // k16 step jj: keys 16jj … 16jj + 15 are the S tiles 2jj and 2jj + 1;
    // ldmatrix.trans: lane l points at key row (l & 7) + 8·((l >> 3) & 1)
    // of the step, hd column 8·(l >> 4) of a pair of n8 tiles
    const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col_words = (lane >> 4) * 4;
#pragma unroll
    for (int jj = 0; jj < kNT / 2; ++jj) {
      // P in two bf16 parts, so that P·V keeps fp32 P as the TPU kernel
      // does (hi + lo carries p to about 2^-17)
      uint32_t a_hi[4], a_lo[4];
      tc::split_bf16x2(p[2 * jj][0], p[2 * jj][1], a_hi[0], a_lo[0]);
      tc::split_bf16x2(p[2 * jj][2], p[2 * jj][3], a_hi[1], a_lo[1]);
      tc::split_bf16x2(p[2 * jj + 1][0], p[2 * jj + 1][1], a_hi[2], a_lo[2]);
      tc::split_bf16x2(p[2 * jj + 1][2], p[2 * jj + 1][3], a_hi[3], a_lo[3]);
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r,
                              Vb + (jj * 16 + key) * kLd + np * 8 + col_words);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        tc::mma_bf16(c[2 * np], a_lo, b0);  // the small terms first
        tc::mma_bf16(c[2 * np + 1], a_lo, b1);
        tc::mma_bf16(c[2 * np], a_hi, b0);
        tc::mma_bf16(c[2 * np + 1], a_hi, b1);
      }
    }
  }
#pragma unroll
  for (int nn = 0; nn < kN; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[nn][e] = fmaf(o[nn][e], alpha[e >> 1], c[nn][e]);
}

// hd ≤ 64: 3 blocks of 4 warps per SM (registers ≤ 168 a thread) hide the
// latencies of the fragment loads and the MMAs; hd 96 and 128 keep more
// accumulators (48 and 64 a thread) and their tiles more shared memory
// (fp32: 75 and 99 KB a block, so 3 would not fit the SM's 228 KB): 2
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 2)
swa_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S,
                  int H, int B, int rep, int window, float scale_log2,
                  Strides st, int vec) {
  constexpr int kLd = row_words<T, HD>();
  constexpr int kTile = kBK * kLd;  // words of one K or V tile
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* Qs = smem;             // [kBQ][kLd]
  uint32_t* Ks = Qs + kBQ * kLd;   // [2][kBK][kLd]
  uint32_t* Vs = Ks + 2 * kTile;   // [2][kBK][kLd]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // one linear grid, the query tile slowest: blocks start in index order,
  // so every (batch, head)'s latest query tiles — those that see the most
  // keys — start first, and the short ones fill in behind them
  const int hb = blockIdx.x % (H * B);
  const int n_qtiles = gridDim.x / (H * B);
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x / (H * B))) * kBQ;
  const int h = hb % H;
  const int b = hb / H;
  const int kvh = h / rep;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  // the tile's queries q0 … q_last see keys (q0 − W, q_last]
  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_first = max(q0 - window + 1, 0) / kBK;
  const int t_last = q_last / kBK;

  stage_tile<T, HD, kBQ>(Qs, qp, st.qs, q0, S, vec, tid);
  stage_tile<T, HD, kBK>(Ks, kp, st.ks, t_first * kBK, S, vec, tid);
  stage_tile<T, HD, kBK>(Vs, vp, st.vs, t_first * kBK, S, vec, tid);
  tc::cp_async_commit();

  // this lane's rows: qi[0] = q0 + 16·warp + gid and qi[1] = qi[0] + 8
  const int qi[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  for (int t = t_first; t <= t_last; ++t) {
    const int buf = (t - t_first) & 1;
    if (t < t_last) {  // the next tile's copy runs under this tile's work
      const int nb = buf ^ 1;
      stage_tile<T, HD, kBK>(Ks + nb * kTile, kp, st.ks, (t + 1) * kBK, S,
                             vec, tid);
      stage_tile<T, HD, kBK>(Vs + nb * kTile, vp, st.vs, (t + 1) * kBK, S,
                             vec, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    float s[kNT][4];
    scores<T, HD>(s, Qs + warp * 16 * kLd, Ks + buf * kTile, gid, tig);

    // mask, scale and the online softmax, row by row (r = 0: qi[0], 1: qi[1]),
    // m in log2 units
    const int k0 = t * kBK + 2 * tig;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNeg;
      bool keep[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kj = k0 + nt * 8 + j;
          keep[nt][j] = kj <= qi[r] && kj > qi[r] - window && kj < S;
          float& x = s[nt][2 * r + j];
          x = keep[nt][j] ? x * scale_log2 : kNeg;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = tc::exp2_approx(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * r + j];
          x = keep[nt][j] ? tc::exp2_approx(x - m_new) : 0.f;
          rs += x;
        }
      l[r] = l[r] * alpha[r] + rs;
      m[r] = m_new;
    }

    add_pv<T, HD>(acc, s, alpha, Vs + buf * kTile, lane, gid, tig);
    __syncthreads();  // this tile's K and V are no longer read
  }

  // a row's l is spread over its quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = op + (int64_t)qi[r] * st.os + 2 * tig;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      orow[nn * 8] = narrow<T>(acc[nn][2 * r] * inv);
      orow[nn * 8 + 1] = narrow<T>(acc[nn][2 * r + 1] * inv);
    }
  }
}

template <typename T>
bool vec_ok(const void* p, int64_t b, int64_t s, int64_t h) {
  constexpr int kEpv = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && b % kEpv == 0 &&
         s % kEpv == 0 && h % kEpv == 0;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int window,
                   const Strides& st, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, HD>();
  static_assert(smem <= 232448, "more than a block's shared memory");
  // the blocks per SM that __launch_bounds__ promises must fit the SM's
  // 228 KB of shared memory (1 KB of it reserved per block)
  static_assert((HD <= 64 ? 3 : 2) * (smem + 1024) <= 233472,
                "the blocks per SM do not fit the SM's shared memory");
  // above 48 KB of dynamic shared memory needs the opt-in, which is a
  // property of the kernel on the current device: set it every launch
  const cudaError_t err = cudaFuncSetAttribute(
      swa_attention_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int vec = vec_ok<T>(q, st.qb, st.qs, st.qh) &&
                  vec_ok<T>(k, st.kb, st.ks, st.kh) &&
                  vec_ok<T>(v, st.vb, st.vs, st.vh);
  const dim3 grid(((S + kBQ - 1) / kBQ) * H * B);
  // scores in log2 units: exp(s/√hd − m) = 2^(s·log2(e)/√hd − m')
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  swa_attention_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, B, H / KV,
      window, scale_log2, st, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int swa_attention_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KV, int hd, int window,
                                    const int64_t* strides, int dtype,
                                    void* stream) {
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (dtype * 1000 + hd) {
    case 32: return launch<float, 32>(q, k, v, o, B, S, H, KV, window, st, s);
    case 64: return launch<float, 64>(q, k, v, o, B, S, H, KV, window, st, s);
    case 96: return launch<float, 96>(q, k, v, o, B, S, H, KV, window, st, s);
    case 128:
      return launch<float, 128>(q, k, v, o, B, S, H, KV, window, st, s);
    case 1032:
      return launch<bf16, 32>(q, k, v, o, B, S, H, KV, window, st, s);
    case 1064:
      return launch<bf16, 64>(q, k, v, o, B, S, H, KV, window, st, s);
    case 1096:
      return launch<bf16, 96>(q, k, v, o, B, S, H, KV, window, st, s);
    case 1128:
      return launch<bf16, 128>(q, k, v, o, B, S, H, KV, window, st, s);
  }
  return (int)cudaErrorInvalidValue;
}
