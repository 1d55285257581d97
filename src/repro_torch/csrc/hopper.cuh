// Hopper (sm_90a) building blocks for the wgmma kernels: mbarriers, 4-D TMA
// tensor loads into the 128-byte swizzle, warpgroup products
// (wgmma.m64n64k16, bf16 in, fp32 sums) with their shared-memory
// descriptors, named barriers, and the host's tensor-map encoder, reached
// through the runtime's driver entry point so that no library links
// libcuda.
//
// Layouts.  A TMA box is 64 rows x 64 bf16 (128 bytes a row, 8 KB), written
// with CU_TENSOR_MAP_SWIZZLE_128B at a 1024-byte aligned address: element
// (r, c) lies at byte r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2.  A
// row tile wider than 64 is a run of such boxes, 8 KB apart.  wgmma reads
// the same layout through a descriptor with layout type 1 (128-byte
// swizzle): K-major (the k-dimension along the 128-byte rows; the k-step of
// 16 moves the start by 32 bytes; 8-row groups SBO = 1024 bytes apart) or
// MN-major (the k-dimension down the rows; the k-step of 16 rows moves the
// start by 2048 bytes; SBO = 1024 between 8-row groups, LBO = 8 KB between
// 64-column boxes).  The accumulator of m64nNk16 holds, for thread i of
// the warpgroup (warp w = i / 32, g = i % 32 / 4, t = i % 4), value
// v = 4 j + 2 h + c at row 16 w + g + 8 h and column 8 j + 2 t + c; an A
// fragment in registers (k-step of 16 columns) is that layout's columns
// 16 kk .. 16 kk + 15 packed in pairs: {v 8kk, 8kk+1}, {8kk+2, 8kk+3},
// {8kk+4, 8kk+5}, {8kk+6, 8kk+7}.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA traffic before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ----------------------------------------------------------------- TMA
// the box at coordinates (c0 innermost .. c3) of `map` into `dst`, counted
// on `bar`; rows past the tensor's end arrive as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// a shared-memory descriptor, 128-byte swizzle; lbo, sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32)
         | (1ull << 62);
}
// K-major: LBO unused (1), SBO 8 rows of 128 bytes
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return sw128_desc(p, 16, 1024);
}
// MN-major: LBO the 8 KB between 64-column boxes, SBO 8 rows of 128 bytes
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  return sw128_desc(p, 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous product
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WGMMA_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WGMMA_OUT32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

// d (64 x 64) (+)= A B^T: A 64 x 16 and B 64 x 16, both K-major in shared
// memory; accumulate != 0 adds to d, else overwrites it
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) (+)= a B: a a 64 x 16 A fragment in registers, B 16 x 64
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef WGMMA_D32
#undef WGMMA_OUT32

// the A fragments of the 64 x 64 accumulator `x` (k-steps of 16 columns) as
// bf16 pairs
__device__ __forceinline__ void acc_to_a(const float (&x)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// move registers between warpgroups: a producer gives up what it does not
// need (dec), the consumers take it (inc); every warp of a warpgroup runs it
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 2^x by the MUFU alone, subnormal results flushed to zero: exp2f's range
// handling around it costs the elementwise pass between products more than
// the products themselves at d 128
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -------------------------------------------------------- named barriers
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return (EncodeTiled)p;
  }();
  return fn;
}

// a map of the bf16 tensor [n3, n2, n1, n0] (contiguous) in boxes of 64
// (dim 0) x 1 x 64 (dim 2) x 1, 128-byte swizzle; returns a CUDA error code
inline int bf16_box_map(CUtensorMap* map, const void* base, int n3, int n2,
                        int n1, int n0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2,
                              (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)n0 * 2, (cuuint64_t)n1 * n0 * 2,
                                 (cuuint64_t)n2 * n1 * n0 * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
