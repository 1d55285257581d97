// Tensor-core and async-copy building blocks for Hopper (sm_90a) shared by
// the attention kernels: cp.async 16-byte copies with zero-fill, a tile
// loader built on them, ldmatrix (plain and transposed) and
// mma.sync.m16n8k16 on bf16 with fp32 sums.  Fragment layouts are PTX's: for lane l, g = l / 4 and t = l % 4,
// an A fragment holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8,
// 2t + 9; a B fragment columns g, rows 2t, 2t + 1 and 2t + 8, 2t + 9; a C
// fragment rows g and g + 8, columns 2t, 2t + 1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !ok (nothing is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// c[4] += a[4] (16 x 16, row) * b[2] (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ROWS x W bf16 from global rows of `stride` elements into shared rows of
// WP + 8, by 16-byte cp.async from a block of THREADS threads; rows at or
// past `n` and the columns from W to WP zero-filled
template <int W, int WP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int n) {
  static_assert(W % 8 == 0 && WP % 8 == 0 && WP >= W, "row width");
  constexpr int CPR = WP / 8;          // 16-byte chunks a shared row
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r < n && col < W;
    cp_async16(smem_addr(dst + r * (WP + 8) + col),
               src + (ok ? r * stride + col : 0), ok);
  }
}

}  // namespace
