// swa_attention.cu — sliding-window causal flash-attention forward, GQA,
// for Hopper (sm_90a).
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
// tile of 64 query rows) and loops over its key tiles itself:
//
//   - 256 threads as 16 row groups × 16 column lanes (the lanes of a
//     half-warp); a thread owns 4 query rows.
//   - Per key tile of 64 rows: K and V are staged in shared memory as fp32
//     (bf16 widens on the way in), the thread computes a 4 × 4 block of
//     scores S = Q·Kᵀ by fp32 FMA on the CUDA cores, scales by 1/√hd, masks
//     (k ≤ q, k > q − W, k < S), and updates its rows' m and l with
//     half-warp shuffles.  P goes through shared memory, and the thread
//     adds P·V into its 4 × hd/16 accumulators.
//   - The tile of queries is written once, acc / max(l, 1e-30), in the
//     input's dtype.
//
// Masking follows the TPU kernel: a masked score is −1e30 (not −inf) and
// p = exp(s − m)·mask, so a tile masked entirely for a row leaves that
// row's m, l and acc unchanged instead of producing NaN.  Rows and keys
// past S (a ragged last tile) are masked by bounds here; the caller pads
// nothing.  The model layout (B, S, H, hd) / (B, S, KV, hd) is read through
// strides (the head dim must be contiguous), so no transposed copy is
// made.  GQA: query head h reads kv head h / (H / KV), as _expand_kv
// repeats heads.  No atomics: a repeated launch is bitwise equal.
//
// Bound: operations.  4·hd flops per (query, visible key) pair against
// (q, k, v, o) read or written once — hundreds of flops per byte at
// hd = 64, far above the card's ~20 fp32 flops per byte, so its floor is
// the fp32 CUDA-core rate (67 TFLOP/s; no TF32 here, which would lose the
// fp32 parity).  Each FMA pair here costs shared-memory loads (8 loads per
// 16 FMAs in both products), so the simple design reaches a fraction of
// that floor; wgmma tiles, TMA staging and warp specialisation are the
// later steps.
//
// C interface (loaded with ctypes by ops.py):
//   int swa_attention_launch(q, k, v, o, B, S, H, KV, hd, window,
//                            strides, dtype, stream)
//       enqueues the forward on `stream`; returns cudaGetLastError().
//       strides: 12 int64 element strides, (batch, seq, head) for each of
//       q, k, v, o.  hd ∈ {64, 128}; dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kPLd = kBK + 4;  // P row stride: the two half-warps' rows
                               // (4 apart) land 16 banks apart
constexpr float kNeg = -1e30f;

struct Strides {
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q, K and V tiles with a padded row stride (HD + 1: column reads of
  // neighbouring rows fall in distinct banks), and the P tile
  return sizeof(float) * (size_t)((kBQ + 2 * kBK) * (HD + 1) + kBQ * kPLd);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
swa_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S,
                  int rep, int window, float scale, Strides st) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBQ][kLd]
  float* Ks = Qs + kBQ * kLd;     // [kBK][kLd]
  float* Vs = Ks + kBK * kLd;     // [kBK][kLd]
  float* Ps = Vs + kBK * kLd;     // [kBQ][kPLd]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column lane within the half-warp
  const int ty = tid >> 4;  // row group: rows 4·ty … 4·ty + 3
  // the latest query tiles see the most keys: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / rep;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int t = q0 + r;
    Qs[r * kLd + d] = t < S ? widen(qp[t * st.qs + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // the tile's queries q0 … q_last see keys (q0 − W, q_last]
  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_first = max(q0 - window + 1, 0) / kBK;
  const int t_last = q_last / kBK;

  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's K, V and P are no longer read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int key = k0 + r;
      const bool in = key < S;
      Ks[r * kLd + d] = in ? widen(kp[key * st.ks + d]) : 0.f;
      Vs[r * kLd + d] = in ? widen(vp[key * st.vs + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(4 * ty + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float keep[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj <= qi && kj > qi - window && kj < S;
        keep[j] = ok ? 1.f : 0.f;
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new) * keep[j];
        Ps[(4 * ty + i) * kPLd + tx + 16 * j] = p;
        rs += p;
      }
      // butterfly sum: every lane of the half-warp ends with the same value
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = Vs[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        op[qi * st.os + tx + 16 * j] = narrow<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int window,
                   const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB of dynamic shared memory needs the opt-in, which is a
  // property of the kernel on the current device: set it every launch
  const cudaError_t err = cudaFuncSetAttribute(
      swa_attention_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  swa_attention_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV, window,
      scale, st);
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
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, S, H, KV, window, st, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, S, H, KV, window, st, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, KV, window, st, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, KV, window, st,
                                      s);
  return (int)cudaErrorInvalidValue;
}
