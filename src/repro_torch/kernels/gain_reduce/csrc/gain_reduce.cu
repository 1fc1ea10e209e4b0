// gain_reduce.cu — fused per-row (gᵀg, gᵀh) reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/gain_reduce/kernel.py
// (gain_reduce_kernel, body _kernel): the two dot products eq. (28) needs,
// −ε gᵀg + ½ε² gᵀ(Hg), read in ONE pass over g and h.  The TPU kernel walks
// (8, 128) tiles on a sequential grid and carries two (1, 1) accumulators
// from step to step; Hopper blocks run in parallel and carry nothing, so
// this kernel is a two-stage reduction instead:
//
//   stage 1  grid (rows, splits): each block reduces one chunk of one row.
//            Each thread loads groups of 16 bytes (4 fp32 or 8 bf16) when
//            the row is aligned, accumulates in fp32 registers, and the
//            block sums its threads by warp shuffles, then shared memory.
//   stage 2  only when a row spans several blocks: one block per row sums
//            that row's per-block partials in a fixed order.
//
// No float atomics anywhere: every sum has a fixed association, so a
// repeated launch on the same inputs gives bitwise-equal results.  The
// ragged tail of a row is masked here; the caller pads nothing.
//
// Bound: memory.  It reads 2·A·N elements (4 or 2 bytes each) and does
// 2 fused multiply-adds per element pair, far below the card's ~20 FLOP
// per byte balance point, so its floor is the bytes over HBM bandwidth.
// At the fleet's (64, 32) shape it moves 16 KB: launch latency, not
// bandwidth, sets its time there.
//
// C interface (loaded with ctypes by ops.py):
//   int64_t gain_reduce_splits(int64_t n, int dtype)
//       blocks per row; the caller allocates rows × splits × 2 fp32 of
//       scratch when this is > 1.
//   int gain_reduce_launch(g, h, out, scratch, rows, n, dtype, stream)
//       enqueues the reduction of the contiguous (rows, n) inputs into the
//       (rows, 2) fp32 output on `stream`; returns cudaGetLastError().
//   dtype: 0 = float32, 1 = bfloat16.
//   int gain_reduce_empty_launch(stream)
//       enqueues one launch of a kernel that does nothing (one block of
//       one thread): the card's launch floor, the yardstick of this
//       kernel's time at the fleet's shape; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGroupsPerThread = 8;   // 16-byte groups per thread per chunk
constexpr int64_t kMaxSplits = 65535; // gridDim.y limit

// bf16 is carried as its raw 16 bits; widening to fp32 is a 16-bit shift.
typedef uint16_t bf16_bits;

template <typename T> struct Group;
template <> struct Group<float> { static constexpr int kWidth = 4; };
template <> struct Group<bf16_bits> { static constexpr int kWidth = 8; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_bits x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  // little-endian: element 2k is the low half of word k
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// The group of kWidth elements at p as fp32; entries at or past `valid`
// read as zero.  A whole, aligned group is one 16-byte load; otherwise the
// elements load one by one.  Both give the same values in the same order,
// so the sums do not depend on the alignment.
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ p,
                                           int64_t valid, bool vector_ok,
                                           float (&out)[Group<T>::kWidth]) {
  constexpr int W = Group<T>::kWidth;
  if (vector_ok && valid >= W) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), out);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) out[j] = j < valid ? widen(p[j]) : 0.0f;
  }
}

// Sum (a, b) over the block into thread 0: shuffles within each warp,
// then warp 0 sums the warps' results.  blockDim.x is a multiple of 32.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[32];
  __shared__ float sb[32];
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(full, a, off);
    b += __shfl_down_sync(full, b, off);
  }
  const int nwarps = blockDim.x >> 5;
  if (nwarps == 1) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < nwarps ? sa[lane] : 0.0f;
    b = lane < nwarps ? sb[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(full, a, off);
      b += __shfl_down_sync(full, b, off);
    }
  }
}

// Stage 1: block (row, split) reduces elements [split·chunk, (split+1)·chunk)
// of its row into dst[row, split, :] (dst is the (rows, 2) output itself
// when there is one split per row).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gain_reduce_rows(const T* __restrict__ g, const T* __restrict__ h, int64_t n,
                 int64_t chunk, int vector_ok, float* __restrict__ dst) {
  constexpr int W = Group<T>::kWidth;
  const int64_t row = blockIdx.x;
  const int64_t split = blockIdx.y;
  const T* gr = g + row * n;
  const T* hr = h + row * n;
  const int64_t stop = (split + 1) * chunk;
  const int64_t end = stop < n ? stop : n;
  float gg = 0.0f, gh = 0.0f;
  for (int64_t i = split * chunk + static_cast<int64_t>(threadIdx.x) * W;
       i < end; i += static_cast<int64_t>(blockDim.x) * W) {
    float a[W], b[W];
    load_group(gr + i, end - i, vector_ok != 0, a);
    load_group(hr + i, end - i, vector_ok != 0, b);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      gg = fmaf(a[j], a[j], gg);
      gh = fmaf(a[j], b[j], gh);
    }
  }
  block_sum2(gg, gh);
  if (threadIdx.x == 0) {
    float* o = dst + (row * gridDim.y + split) * 2;
    o[0] = gg;
    o[1] = gh;
  }
}

// Stage 2: block `row` sums its nsplit partials (strided per thread, then
// the block tree) into out[row, :].
__global__ void __launch_bounds__(kMaxThreads)
gain_reduce_splits_sum(const float* __restrict__ partial, int64_t nsplit,
                       float* __restrict__ out) {
  const int64_t row = blockIdx.x;
  const float* p = partial + row * nsplit * 2;
  float gg = 0.0f, gh = 0.0f;
  for (int64_t s = threadIdx.x; s < nsplit; s += blockDim.x) {
    gg += p[2 * s];
    gh += p[2 * s + 1];
  }
  block_sum2(gg, gh);
  if (threadIdx.x == 0) {
    out[row * 2] = gg;
    out[row * 2 + 1] = gh;
  }
}

struct Plan {
  int threads;     // stage-1 block size: a power of two in [32, 256]
  int64_t chunk;   // elements per stage-1 block, a multiple of the group
  int64_t nsplit;  // stage-1 blocks per row
};

int threads_for(int64_t items) {
  int t = 32;
  while (t < kMaxThreads && t < items) t <<= 1;
  return t;
}

Plan make_plan(int64_t n, int width) {
  Plan p;
  p.threads = threads_for((n + width - 1) / width);
  const int64_t per_pass = static_cast<int64_t>(p.threads) * width;
  p.chunk = per_pass * kGroupsPerThread;
  p.nsplit = (n + p.chunk - 1) / p.chunk;
  if (p.nsplit > kMaxSplits) {
    // widen the chunks so the splits fit the grid's y dimension
    const int64_t want = (n + kMaxSplits - 1) / kMaxSplits;
    p.chunk = (want + per_pass - 1) / per_pass * per_pass;
    p.nsplit = (n + p.chunk - 1) / p.chunk;
  }
  if (p.nsplit < 1) p.nsplit = 1;
  return p;
}

int width_of(int dtype) { return dtype == 0 ? Group<float>::kWidth
                                            : Group<bf16_bits>::kWidth; }

template <typename T>
void launch_rows(const void* g, const void* h, int64_t rows, int64_t n,
                 const Plan& plan, int vector_ok, float* dst,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>(plan.nsplit));
  gain_reduce_rows<T><<<grid, plan.threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(h), n, plan.chunk,
      vector_ok, dst);
}

}  // namespace

extern "C" int64_t gain_reduce_splits(int64_t n, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  return make_plan(n, width_of(dtype)).nsplit;
}

extern "C" int gain_reduce_launch(const void* g, const void* h, void* out,
                                  void* scratch, int64_t rows, int64_t n,
                                  int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows < 1 || rows > 0x7fffffff || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = width_of(dtype);
  const Plan plan = make_plan(n, width);
  if (plan.nsplit > 1 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(h);
  const int vector_ok = (n % width == 0) && (align % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = plan.nsplit > 1 ? static_cast<float*>(scratch)
                               : static_cast<float*>(out);
  if (dtype == 0) {
    launch_rows<float>(g, h, rows, n, plan, vector_ok, dst, s);
  } else {
    launch_rows<bf16_bits>(g, h, rows, n, plan, vector_ok, dst, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || plan.nsplit == 1) return static_cast<int>(err);
  gain_reduce_splits_sum<<<static_cast<unsigned>(rows),
                           threads_for(plan.nsplit), 0, s>>>(
      static_cast<const float*>(scratch), plan.nsplit,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

__global__ void gain_reduce_empty() {}

extern "C" int gain_reduce_empty_launch(void* stream) {
  gain_reduce_empty<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
