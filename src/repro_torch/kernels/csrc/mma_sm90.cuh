// mma_sm90.cuh — tensor-core and copy building blocks shared by the port's
// CUDA kernels (sm_90a), as inline PTX.
//
//   - cp_async16 / cp_async_commit / cp_async_wait: 16-byte global→shared
//     copies that bypass the registers, zero-filling a copy whose source
//     lies outside the tensor (src_bytes = 0), and stage16, which stages a
//     segment by them or, off the 16-byte alignment, by plain loads;
//   - split_tf32 and mma_tf32, for fp32 products a·b on the TF32 tensor
//     cores in three passes ("3×TF32"), a·b ≈ a_lo·b_hi + a_hi·b_lo +
//     a_hi·b_hi, where hi = rna_tf32(a) and lo = rna_tf32(a − hi):
//     hi carries the top 11 significant bits of a, lo the next 11, so only
//     a_lo·b_lo (≈ 2^-22 relative) and the rounding of lo are dropped.  The
//     kernels run the small terms first;
//   - mma_bf16: bf16 × bf16 with fp32 accumulation (each product is exact
//     in fp32), and split_bf16x2, an fp32 operand as two bf16 parts;
//   - ldmatrix_x4_trans: four transposed 8×8 b16 tiles from shared memory;
//   - exp2_approx: 2^x on the special-function unit.
//
// The tensor cores round their fp32 sums toward zero, not to nearest, so
// a long chain of MMAs into one accumulator drifts.  The kernels therefore
// accumulate each short k-chunk (32 fp32 or 32–64 bf16 elements) into a
// fresh zero accumulator and add it to the running sum on the CUDA cores,
// in round-to-nearest (`add_chunk`).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros (src must still
// be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// Stage one 16-byte segment whose first n_valid elements (0 … 16 /
// sizeof(T)) are src's: by cp.async when `vec` (the segment is then whole
// or empty, and an empty one reads nothing at `base`), else by plain loads
// and one 16-byte store, zeros past n_valid.  Both give the same bytes.
template <typename T>
__device__ __forceinline__ void stage16(void* dst, const T* src,
                                        const T* base, int n_valid,
                                        bool vec) {
  constexpr int kEpv = 16 / sizeof(T);
  if (vec) {
    cp_async16(dst, n_valid > 0 ? src : base, n_valid > 0 ? 16 : 0);
  } else {
    alignas(16) T v[kEpv];
#pragma unroll
    for (int e = 0; e < kEpv; ++e) v[e] = e < n_valid ? src[e] : T(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 by integer arithmetic on the fp32 pattern: add half a
// unit of the 10-bit mantissa's last place, clear the 13 bits below it
// (round to nearest, ties away from zero).  The same bits as the PTX
// instruction for finite values, in 2 instructions where ptxas makes 4 of
// the instruction (it also checks for inf and NaN).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi/lo TF32 parts of an fp32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a·b, m16n8k8, TF32 inputs (row A, col B), fp32 accumulators.  The
// MMAs touch registers only and are not volatile, so the compiler may
// interleave independent ones: a chain of MMAs into one accumulator issues
// one per MMA latency, so the kernels order their loops to give it
// independent tiles.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b, m16n8k16, bf16 inputs (row A, col B), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8×8 b16 tiles, transposed: lane l gives the address of row (l & 7)
// of tile (l >> 3); r[j] holds tile j's elements (2·(l & 3), l >> 2) and
// (2·(l & 3) + 1, l >> 2)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 2^x by the SFU (ex2.approx: relative error about 2^-22, and 2^-1e30 = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x − hi) (x − hi is
// exact in fp32), x0 in the low halves: the A operand of a bf16 MMA that
// keeps about 17 significant bits of x
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- warpgroup MMA (wgmma): a warpgroup of 4 warps computes a 64 × 128
// fp32 tile from operands in shared memory, both K-major, each row of a
// tile 128 bytes wide in the 128-byte swizzle (16-byte group g of row r
// stored at group g ^ (r % 8)), 8-row blocks 1024 bytes apart, the tile
// 1024-byte aligned.  Accumulator d[4j + e] of thread t (warp w = t / 32
// of the warpgroup) is row 16w + (t % 32) / 4 + 8·(e / 2), column
// 8j + 2·(t % 4) + e % 2.

// descriptor of a swizzled K-major tile starting at p (advance the start
// by 32 bytes, +2, for each next 32-byte k-step inside the 128-byte rows)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4)  // start address, 16-byte units
         | (1ull << 16)           // leading byte offset (unused here)
         | (64ull << 32)          // stride byte offset: 1024 B per 8 rows
         | (1ull << 62);          // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes by ordinary stores (and cp.async) become visible to
// the wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A·B (+ d when accumulate), m64n128k8, TF32 operands
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A·B (+ d when accumulate), m64n128k16, bf16 operands, both K-major
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// acc += chunk, element by element, in round-to-nearest on the CUDA cores
template <int N>
__device__ __forceinline__ void add_chunk(float (&acc)[N][4],
                                          const float (&chunk)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += chunk[i][j];
}

}  // namespace tc
