// fused_ce.cu — fused vocab-tiled cross-entropy forward for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/fused_ce/kernel.py
// (fused_ce_kernel, body _kernel): per token t,
//
//     nll_t = logsumexp_v(x_t · table_v) − x_t · table_{label_t}
//
// with an online logsumexp over vocab tiles, so the (T, V) logits never
// reach memory, and the gold logit picked out of the tile it falls in by
// an in-tile one-hot match.  It also writes lse_t (the logsumexp), which
// the plain backward uses to form the softmax again chunk by chunk.
//
// The TPU kernel walks a sequential grid whose innermost (vocab) axis
// carries the running max m, sum l and gold logit in VMEM from one vocab
// tile to the next.  Hopper blocks run in parallel and carry nothing, so
// ONE block owns a tile of 64 token rows and loops over the vocab tiles of
// its range itself:
//
//   - 256 threads as 16 row groups × 16 column lanes (the lanes of a
//     half-warp); a thread owns a 4 × 4 block of the 64 × 64 logits tile.
//   - The logits tile is an fp32 FMA product over D on the CUDA cores,
//     staged through shared memory 32 columns of D at a time: the x tile
//     (64 × 32) and the table tile (64 × 32), both stored k-major with a
//     row stride of 68 floats, so a thread reads its 4 rows and its 4
//     vocab entries at one k as two 16-byte loads (2 loads per 16 FMAs).
//     A whole-D x tile does not fit at large D (64 × 576 fp32 is 147 KB).
//   - After each vocab tile, every row's (m, l) is updated the way the TPU
//     kernel does it, with half-warp butterflies for the row max and sum
//     (a butterfly leaves every lane the same value, so no atomics).
//
// At T = 8192 there are only 128 token tiles for 132 SMs, so the vocab is
// cut into `nsplit` ranges of whole tiles (chosen by the wrapper from the
// SM count) and each (token tile, range) block writes a partial (m, l,
// gold) per row; a second kernel combines the ranges in a fixed order.
// No float atomics anywhere: a repeated launch is bitwise equal.
//
// Masking follows the TPU kernel: a vocab position ≥ V is −1e30 and adds
// nothing to l; the gold logit starts at −1e30 and is the max over the
// tiles' one-hot matches; nll = log(max(l, 1e-30)) + m − gold.  Ragged T
// and V are masked here by bounds: the wrapper pads nothing and makes no
// padded copy of the table (the JAX wrapper concatenates zeros to it).
// x and the table are read through strides (the D axis contiguous), with
// a third, "group" stride so that several token matrices, each with its
// own table or all sharing one (group stride 0), run in one launch: the
// vmap rule of the wrapper maps agents onto groups.
//
// Bound: operations.  2·T·V·D flops against (T·D + V·D) inputs read once:
// at T = 8192, D = 576 that is ~8000 flops per byte, far above the card's
// ~20 fp32 flops per byte, so its floor is the fp32 CUDA-core rate (67
// TFLOP/s; no TF32, which would lose the fp32 parity).  This simple design
// keeps the products on the CUDA cores; wgmma tiles fed by TMA (and the
// bf16 tensor cores) are the later steps.
//
// C interface (loaded with ctypes by ops.py):
//   int fused_ce_launch(x, table, labels, part, nll, lse, G, T, V, D,
//                       nsplit, tiles_per_split, strides, dtype,
//                       label_dtype, stream)
//       enqueues both kernels on `stream`; returns cudaGetLastError().
//       strides: 6 int64 element strides (group, row) of x, table and
//       labels.  part: G·nsplit·T·3 floats of scratch; nll, lse: (G, T)
//       fp32, contiguous.  dtype: 0 = float32, 1 = bfloat16;
//       label_dtype: 0 = int32, 1 = int64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBT = 64;        // token rows per block
constexpr int kBV = 64;        // vocab entries per tile
constexpr int kBD = 32;        // columns of D per shared-memory stage
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLd = kBT + 4;   // k-major row stride: 16-byte aligned rows
constexpr float kNeg = -1e30f;

struct Args {
  int T, V, D, nsplit, tiles_per_split;
  int64_t xg, xt, wg, wv, lg, lt;  // (group, row) strides of x, table, labels
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
fused_ce_partial(const T* __restrict__ x, const T* __restrict__ w,
                 const L* __restrict__ labels, float* __restrict__ part,
                 Args a) {
  __shared__ __align__(16) float Xs[kBD * kLd];  // [k][token row]
  __shared__ __align__(16) float Ws[kBD * kLd];  // [k][vocab entry]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // vocab entries 4·tx … 4·tx + 3 of a tile
  const int ty = tid >> 4;  // token rows 4·ty … 4·ty + 3 of the block
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  const int g = blockIdx.z;
  const T* xp = x + g * a.xg;
  const T* wp = w + g * a.wg;
  const L* lp = labels + g * a.lg;

  // loading role: row lr of both tiles, columns ld … ld + 7 of a stage
  // (a warp stores 32 consecutive rows of one column: no bank conflicts)
  const int lr = tid & (kBT - 1);
  const int ld = (tid >> 6) * 8;
  const bool x_in = t0 + lr < a.T;
  const T* x_row = xp + (int64_t)(x_in ? t0 + lr : 0) * a.xt;

  int lab[4];
  float m[4], l[4], gold[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + 4 * ty + i;
    lab[i] = row < a.T ? (int)lp[(int64_t)row * a.lt] : -1;
    m[i] = kNeg;
    l[i] = 0.f;
    gold[i] = kNeg;
  }

  const int n_tiles = (a.V + kBV - 1) / kBV;
  const int tv_first = split * a.tiles_per_split;
  const int tv_end = min(tv_first + a.tiles_per_split, n_tiles);
  for (int tv = tv_first; tv < tv_end; ++tv) {
    const int v0 = tv * kBV;
    const bool w_in = v0 + lr < a.V;
    const T* w_row = wp + (int64_t)(w_in ? v0 + lr : 0) * a.wv;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < a.D; d0 += kBD) {
      __syncthreads();  // the last stage is no longer read
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + ld + j;
        Xs[(ld + j) * kLd + lr] = x_in && d < a.D ? widen(x_row[d]) : 0.f;
        Ws[(ld + j) * kLd + lr] = w_in && d < a.D ? widen(w_row[d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBD; ++k) {
        const float4 xa = *reinterpret_cast<const float4*>(&Xs[k * kLd + 4 * ty]);
        const float4 wb = *reinterpret_cast<const float4*>(&Ws[k * kLd + 4 * tx]);
        const float xr[4] = {xa.x, xa.y, xa.z, xa.w};
        const float wc[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
      }
    }

    // online logsumexp over this tile, and the in-tile one-hot gold
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = v0 + 4 * tx + j;
        s[j] = c < a.V ? acc[i][j] : kNeg;
        mx = fmaxf(mx, s[j]);
        if (c == lab[i]) gold[i] = s[j];
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rs += v0 + 4 * tx + j < a.V ? expf(s[j] - m_new) : 0.f;
      rs = half_warp_sum(rs);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float gd = half_warp_max(gold[i]);
    const int row = t0 + 4 * ty + i;
    if (tx == 0 && row < a.T) {
      float* p = part + (((int64_t)g * a.nsplit + split) * a.T + row) * 3;
      p[0] = m[i];
      p[1] = l[i];
      p[2] = gd;
    }
  }
}

// One thread per (group, token): the ranges' partials in split order.
__global__ void fused_ce_combine(const float* __restrict__ part,
                                 float* __restrict__ nll,
                                 float* __restrict__ lse, int G, int T,
                                 int nsplit) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)G * T) return;
  const int64_t g = idx / T, t = idx % T;
  const float* p = part + (g * nsplit * T + t) * 3;
  const int64_t step = (int64_t)T * 3;
  float m = kNeg, gold = kNeg;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, p[s * step]);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    l += p[s * step + 1] * expf(p[s * step] - m);
    gold = fmaxf(gold, p[s * step + 2]);
  }
  const float z = logf(fmaxf(l, 1e-30f)) + m;
  lse[idx] = z;
  nll[idx] = z - gold;
}

template <typename T, typename L>
cudaError_t launch(const void* x, const void* w, const void* labels,
                   float* part, float* nll, float* lse, int G,
                   const Args& a, cudaStream_t stream) {
  const dim3 grid((a.T + kBT - 1) / kBT, a.nsplit, G);
  fused_ce_partial<T, L><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const L*>(labels), part, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)G * a.T;
  fused_ce_combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, nll, lse, G, a.T, a.nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_ce_launch(const void* x, const void* table,
                               const void* labels, void* part, void* nll,
                               void* lse, int G, int T, int V, int D,
                               int nsplit, int tiles_per_split,
                               const int64_t* strides, int dtype,
                               int label_dtype, void* stream) {
  const Args a = {T,          V,          D,          nsplit,
                  tiles_per_split,        strides[0], strides[1],
                  strides[2], strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* n = static_cast<float*>(nll);
  float* z = static_cast<float*>(lse);
  if (dtype == 0 && label_dtype == 0)
    return launch<float, int32_t>(x, table, labels, p, n, z, G, a, s);
  if (dtype == 0 && label_dtype == 1)
    return launch<float, int64_t>(x, table, labels, p, n, z, G, a, s);
  if (dtype == 1 && label_dtype == 0)
    return launch<__nv_bfloat16, int32_t>(x, table, labels, p, n, z, G, a,
                                          s);
  if (dtype == 1 && label_dtype == 1)
    return launch<__nv_bfloat16, int64_t>(x, table, labels, p, n, z, G, a,
                                          s);
  return (int)cudaErrorInvalidValue;
}
