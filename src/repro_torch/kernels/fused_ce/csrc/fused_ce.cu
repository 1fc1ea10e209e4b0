// fused_ce.cu — fused vocab-tiled cross-entropy forward for Hopper (sm_90a),
// on the tensor cores.
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
// ONE block owns a tile of 128 token rows and loops over the 128-entry
// vocab tiles of its range itself:
//
//   - 2 warpgroups (8 warps); warpgroup g computes rows 64g … 64g + 63 of
//     the 128 × 128 logits tile with wgmma (m64n128, both operands read
//     from shared memory, the accumulators in registers: 64 a thread).
//   - D is staged in k-chunks of 128 bytes per row (32 fp32 or 64 bf16
//     columns) through a 3-stage cp.async ring in dynamic shared memory,
//     written straight into the wgmma's 128-byte swizzle (x cannot stay
//     resident: 128 × 576 fp32 is 295 KB, so the x tile is streamed again
//     for each vocab tile, from L2).  The ring runs on across vocab tiles,
//     and while one stage's MMAs run the next is waited for and prepared
//     and the one after is requested.
//   - fp32 inputs run in 3×TF32: a = hi + lo with hi = tf32(a) and
//     lo = tf32(a − hi), and a·b ≈ lo·hi + hi·lo + hi·hi, the small terms
//     first, on TF32 wgmmas: about fp32 accuracy at the TF32 tensor-core
//     rate.  Each thread splits the values it copied, x's and the table's,
//     in place, the lo parts into a second plane of the stage.  bf16 inputs
//     go straight to bf16 wgmmas (exact products).  Each k-chunk
//     accumulates into a fresh accumulator (the first wgmma does not read
//     it) that is added to the tile's logits in round-to-nearest on the
//     CUDA cores: the tensor cores round their sums toward zero, which
//     would drift over D.  (Feeding x to the TF32 wgmmas from registers,
//     split there, and a fourth stage was no faster on the card.)
//   - After a vocab tile's last chunk each lane updates its own running
//     (m, l, gold) for its 2 rows over its 32 columns of the tile (no
//     shuffles in the loop); at the end of the range the 4 lanes of a
//     quad, which hold all of a row, combine by a butterfly of shuffles
//     and one of them writes the row's partial.
//
// At T = 8192 there are only 64 token tiles for 132 SMs, so the vocab is
// cut into `nsplit` ranges of whole tiles (chosen by the wrapper from the
// SM count) and each (token tile, range) block writes a partial (m, l,
// gold) per row; a second kernel combines the ranges in a fixed order.
// No float atomics anywhere: a repeated launch is bitwise equal.
//
// Masking follows the TPU kernel: a vocab position ≥ V is −1e30 and adds
// nothing to l; the gold logit starts at −1e30 and is the max over the
// tiles' one-hot matches; nll = log(max(l, 1e-30)) + m − gold.  Ragged T,
// V and D are masked by bounds here (rows and columns past the edge are
// staged as zeros): the wrapper pads nothing and makes no padded copy of
// the table (the JAX wrapper concatenates zeros to it).  x and the table
// are read through strides (the D axis contiguous), with a third, "group"
// stride so that several token matrices, each with its own table or all
// sharing one (group stride 0), run in one launch: the vmap rule of the
// wrapper maps agents onto groups, and a group is found by its base
// pointer, so a stride-0 table needs nothing special (a TMA descriptor
// could not take it).  An operand whose base, strides or D are not
// multiples of 16 bytes (a row of a wider buffer, one element in) is
// staged by plain loads instead of cp.async, into the same shared-memory
// layout, so the MMAs see the same operands and the result is bitwise that
// of an aligned copy.
//
// Bound: operations.  2·T·V·D flops against (T·D + V·D) inputs read once:
// at T = 8192, D = 576 that is ~8000 flops per byte.  fp32 runs three TF32
// products per product, so its floor is 3 · 2·T·V·D at the dense TF32 rate
// (494.7 TFLOP/s); bf16's is 2·T·V·D at the bf16 rate (989 TFLOP/s).  What
// holds it back from them: re-staging x for every vocab tile costs L2
// bandwidth (bf16 moves 2 bytes per 16 flops of a chunk through L2), the
// 3×TF32 wgmmas read both operands three times from shared memory, and
// one block of 2 warpgroups per SM waits on each chunk's MMAs before
// adding them up.

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

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kBT = 128;       // token rows per block: 2 warpgroups × 64
constexpr int kBV = 128;       // vocab entries per tile
constexpr int kThreads = 256;  // 2 warpgroups of 4 warps
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kRowBytes = 128;  // bytes of D per row per stage: one swizzle row
constexpr int kPlaneBytes = (kBT + kBV) * kRowBytes;  // x rows, then table rows
constexpr float kNeg = -1e30f;

// A stage holds the x and table rows of one k-chunk, in the wgmma's 128-byte
// swizzle: fp32 in two planes, hi (where the copy lands, split in place)
// and lo; bf16 in one.  The ring is 1024-byte aligned inside the dynamic
// shared memory, which has 1 KB more for that.
template <typename T>
struct Stage {
  static constexpr int kPlanes = std::is_same<T, float>::value ? 2 : 1;
  static constexpr int kBytes = kPlanes * kPlaneBytes;
  static constexpr int kSmemBytes = kStages * kBytes + 1024;
  static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
};

struct Args {
  int T, V, D, nsplit, tiles_per_split;
  int64_t xg, xt, wg, wv, lg, lt;  // (group, row) strides of x, table, labels
  int x_vec, w_vec;                // 16-byte cp.async staging possible
};

// byte offset of 16-byte group c of row r in a swizzled plane
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// Stage rows [r_begin, r_begin + 128) of one operand, k-chunk `d0`, into
// `dst` (128 swizzled rows): thread `tid` copies 16-byte segments tid,
// tid + 256, … (4 per thread); rows ≥ n_rows and columns ≥ D are zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(char* dst, const T* base,
                                           int64_t row_stride, int r_begin,
                                           int n_rows, int d0, int D,
                                           bool vec, int tid) {
  constexpr int kEpv = 16 / sizeof(T);  // elements per 16-byte segment
#pragma unroll
  for (int i = 0; i < kBT * 8 / kThreads; ++i) {
    const int seg = tid + i * kThreads;
    const int r = seg >> 3, c = seg & 7;
    const int row = r_begin + r;
    const int d = d0 + c * kEpv;
    const int n_valid = row < n_rows ? min(max(D - d, 0), kEpv) : 0;
    tc::stage16(dst + swizzled(r, c), base + (int64_t)row * row_stride + d,
                base, n_valid, vec);  // vec: D % kEpv == 0, whole or empty
  }
}

// Split the fp32 values this thread staged (the segments of stage_rows, x's
// and the table's) in place: hi = tf32(a) where a was, lo = tf32(a − hi) at
// the same offset of the lo plane.  A thread splits its own copies right
// after waiting for them, so the block's one barrier per stage suffices.
__device__ __forceinline__ void split_own(char* hi, int tid) {
#pragma unroll
  for (int i = 0; i < 2 * kBT * 8 / kThreads; ++i) {
    const int seg = tid + i * kThreads;  // rows ≥ kBT: the table's
    uint4* ph = reinterpret_cast<uint4*>(hi + swizzled(seg >> 3, seg & 7));
    uint4* pl = reinterpret_cast<uint4*>(reinterpret_cast<char*>(ph) +
                                         kPlaneBytes);
    uint4 h = *ph, l;
    tc::split_tf32(__uint_as_float(h.x), h.x, l.x);
    tc::split_tf32(__uint_as_float(h.y), h.y, l.y);
    tc::split_tf32(__uint_as_float(h.z), h.z, l.z);
    tc::split_tf32(__uint_as_float(h.w), h.w, l.w);
    *ph = h;
    *pl = l;
  }
}

// c = this chunk's 64 × 128 slab of the warpgroup: x rows at xs, the
// table's 128 rows at ws (hi planes; fp32's lo planes lie kPlaneBytes
// beyond); four k-steps of 32 bytes.  fp32: 3×TF32, the small terms first,
// lo·hi and hi·lo before hi·hi; bf16: one product.  The first MMA starts
// c from zero.
template <typename T>
__device__ __forceinline__ void chunk_mma(float (&c)[64], const char* xs,
                                          const char* ws) {
  const uint64_t xd = tc::wgmma_desc(xs), wd = tc::wgmma_desc(ws);
  constexpr uint64_t kLo = kPlaneBytes >> 4;  // descriptor units
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t k = 2 * ks;  // 32 bytes
    if constexpr (std::is_same<T, float>::value) {
      tc::wgmma_tf32(c, xd + kLo + k, wd + k, ks > 0);
      tc::wgmma_tf32(c, xd + k, wd + kLo + k, 1);
      tc::wgmma_tf32(c, xd + k, wd + k, 1);
    } else {
      tc::wgmma_bf16(c, xd + k, wd + k, ks > 0);
    }
  }
  tc::wgmma_commit();
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_partial(const T* __restrict__ x, const T* __restrict__ w,
                 const L* __restrict__ labels, float* __restrict__ part,
                 Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int kBK = kRowBytes / sizeof(T);  // D columns per stage
  constexpr int kStageBytes = Stage<T>::kBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;  // rows 64·wg … 64·wg + 63 of the block
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  const int g = blockIdx.z;
  const T* xp = x + g * a.xg;
  const T* wp = w + g * a.wg;
  const L* lp = labels + g * a.lg;

  // this lane's rows: 64·wg + 16·(warp % 4) + gid + 8·half
  const int r0 = wg * 64 + (warp & 3) * 16 + gid;
  int lab[2];
  float m[2], l[2], gold[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + r0 + 8 * half;
    lab[half] = row < a.T ? (int)lp[(int64_t)row * a.lt] : -1;
    m[half] = kNeg;
    l[half] = 0.f;
    gold[half] = kNeg;
  }

  const int n_tiles = (a.V + kBV - 1) / kBV;
  const int tv_first = split * a.tiles_per_split;
  const int tv_end = min(tv_first + a.tiles_per_split, n_tiles);
  const int n_kc = (a.D + kBK - 1) / kBK;
  const int n_it = max(tv_end - tv_first, 0) * n_kc;

  auto load = [&](int it) {
    char* st = smem + (it % kStages) * kStageBytes;
    const int v0 = (tv_first + it / n_kc) * kBV;
    const int d0 = (it % n_kc) * kBK;
    stage_rows<T>(st, xp, a.xt, t0, a.T, d0, a.D, a.x_vec, tid);
    stage_rows<T>(st + kBT * kRowBytes, wp, a.wv, v0, a.V, d0, a.D, a.w_vec,
                  tid);
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // stage `it` is split (fp32) and visible to the wgmma when iteration
  // `it` starts; while its MMAs run, the next stage is waited for and
  // split, and the one after is requested
  static_assert(kStages == 3, "the loop keeps two stages in flight");
  auto prepare = [&](int it) {  // this thread's part of stage `it`
    if constexpr (std::is_same<T, float>::value)
      split_own(smem + (it % kStages) * kStageBytes, tid);
    tc::fence_proxy_async();  // the copies and splits, for the wgmma
  };
  if (n_it > 0) load(0);
  tc::cp_async_commit();
  if (n_it > 1) load(1);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  prepare(0);
  __syncthreads();
  for (int it = 0; it < n_it; ++it) {
    const char* st = smem + (it % kStages) * kStageBytes;
    float c[64];
    tc::fence_regs(c);
    chunk_mma<T>(c, st + wg * 64 * kRowBytes, st + kBT * kRowBytes);
    // stage it + 2 reuses the buffer of it − 1, whose MMAs all finished
    // before the last barrier
    if (it + 2 < n_it) load(it + 2);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this thread's copies of stage it + 1
    if (it + 1 < n_it) prepare(it + 1);
    tc::wgmma_wait_all();
    tc::fence_regs(c);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += c[i];
    __syncthreads();  // stage it + 1 is ready, stage it free

    if (it % n_kc != n_kc - 1) continue;
    // the vocab tile is complete: online logsumexp over this lane's 32
    // columns of it (8j + 2·tig + e % 2), and the in-tile one-hot gold
    const int v0 = (tv_first + it / n_kc) * kBV + 2 * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + 8 * j + e;
          float& s = acc[4 * j + 2 * half + e];
          s = col < a.V ? s : kNeg;
          mx = fmaxf(mx, s);
          if (col == lab[half]) gold[half] = s;
        }
      const float m_new = fmaxf(m[half], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rs += v0 + 8 * j + e < a.V
                    ? expf(acc[4 * j + 2 * half + e] - m_new)
                    : 0.f;
      l[half] = l[half] * expf(m[half] - m_new) + rs;
      m[half] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }

  // the quad's four lanes hold one row's columns: butterfly combine, and
  // the row is the quad's alone
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[half], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[half], off);
      const float go = __shfl_xor_sync(0xffffffffu, gold[half], off);
      const float mn = fmaxf(m[half], mo);
      l[half] = l[half] * expf(m[half] - mn) + lo * expf(mo - mn);
      m[half] = mn;
      gold[half] = fmaxf(gold[half], go);
    }
    const int row = t0 + r0 + 8 * half;
    if (tig == 0 && row < a.T) {
      float* out = part + (((int64_t)g * a.nsplit + split) * a.T + row) * 3;
      out[0] = m[half];
      out[1] = l[half];
      out[2] = gold[half];
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the block
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

// cp.async needs 16-byte aligned sources: the base, every stride and D a
// multiple of 16 bytes
template <typename T>
bool vec_ok(const void* p, int64_t g_stride, int64_t row_stride, int D) {
  constexpr int kEpv = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && g_stride % kEpv == 0 &&
         row_stride % kEpv == 0 && D % kEpv == 0;
}

template <typename T, typename L>
cudaError_t launch(const void* x, const void* w, const void* labels,
                   float* part, float* nll, float* lse, int G, Args a,
                   cudaStream_t stream) {
  a.x_vec = vec_ok<T>(x, a.xg, a.xt, a.D);
  a.w_vec = vec_ok<T>(w, a.wg, a.wv, a.D);
  // above 48 KB of dynamic shared memory needs the opt-in, a property of
  // the kernel on the current device: set it every launch
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_partial<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Stage<T>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kBT - 1) / kBT, a.nsplit, G);
  fused_ce_partial<T, L><<<grid, kThreads, Stage<T>::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const L*>(labels), part, a);
  err = cudaGetLastError();
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
                  strides[2], strides[3], strides[4], strides[5],
                  0,          0};
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
