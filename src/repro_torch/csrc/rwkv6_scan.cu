// RWKV6 (Finch) recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/rwkv6_scan/rwkv6_scan.py: rwkv6_scan_kernel,
// the Pallas kernel whose grid walks (head, chunk) with the chunks in order
// and keeps the [N, N] state in VMEM scratch.  This kernel also takes the
// initial state (or zeros) and writes the final state, which the prefill
// cache needs (models/ssm.py: rwkv6_time_mix).
//
// Computes, for every batch row b and head h, sequentially over t:
//   y_t = r_t (S + (u * k_t) v_t^T)
//   S   = diag(w_t) S + k_t v_t^T
// with S [N, N] in fp32.  y is written in the inputs' type.
//
// Layout: r, k, v, w and y [B, S, H, N] in one type, u [B * H, N] fp32,
// init (or null: zeros) and state [B, H, N, N] fp32, all contiguous.  The
// Pallas layout [BH, S, N] is the case H = 1.
//
// Bound: at rwkv6-3b's prefill (4 x 40 heads, S 2048, N 64, fp32) bytes:
// 425 MB in 0.127 ms at 3.35 TB/s, against 5.4 GFLOP in 0.080 ms on the
// CUDA cores (fp32 at 2e-5 rules out TF32 and bf16).  What bounds it on
// this card is the sequence and the issue rate of the warps that carry
// it: every step of a head depends on the last, so the steps of one head
// must be cut into parallel pieces, and each piece's warp issues its
// step's loads and FMAs one after another.
//
// Design: the recurrence never mixes state columns, S[:, j] <- w * S[:, j]
// + k v_j and y_j = sum_i r_i S[i][j] + (sum_i r_i u_i k_i) v_j, so a block
// takes (b, h, a tile of `cols` state columns) and nothing passes between
// blocks; plan_columns in the wrapper takes the widest tile that still
// gives every SM a block (the whole head at rwkv6's prefill, 160 blocks;
// 16 columns for one request).  Within a block each column's N rows are
// cut into L slices of R = min(N, 16) rows, and a thread keeps an R x 4
// piece of S (4 columns of one slice) in registers: a step costs it
// 3 R / 4 + 1 16-byte loads from shared memory against 12 R FMAs.  A warp's
// 16-byte load costs four wavefronts whether its lanes share the address
// or not, so one column a thread would spend a wavefront on every 3 FMAs;
// and fewer, wider blocks leave each warp a scheduler of its own.  Staged
// rows leave 16 bytes after every slice, so the slices a quarter warp
// reads lie in different banks.  Each column's part of y sums into its
// own accumulator; the slices' parts meet in shared memory and are added
// once per kStep steps, and each slice's bonus sum sum_i r_i u_i k_i is
// formed once a step for the block.  r, k, w and the tile's v of the next
// kStep steps are copied by 16-byte cp.async into the second of two
// buffers while the first is computed, so the step loop never waits on a
// global load.  N in {8, 16, 32, 64}; S = 1 (decode) is one step.
//
// For training the kernel also writes the state before every kSave-th
// step (states [B, ceil(S / kSave), H, N, N] fp32), from which the
// backward (csrc/rwkv6_scan_bwd.cu) recomputes the states within each
// stretch of kSave steps.  The saving is a template parameter: without
// a states pointer the kernel runs the instance built without it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kStep = 32;             // time steps a buffer holds
constexpr int kCols = 4;              // state columns a thread
constexpr int kSave = 16;             // steps between saved states
static_assert(kStep % kSave == 0, "a saved state starts a buffer's slice");

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// kCols consecutive values as fp32
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float* out) {
  if constexpr (kCols == 4) {
    const float4 q = load4(p);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = (float)p[c];
  }
}
// kCols consecutive fp32 values
__device__ __forceinline__ void store_cols(float* p, const float* v) {
  if constexpr (kCols == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kCols == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) p[c] = v[c];
  }
}

__host__ __device__ constexpr int rows_per_lane(int N) {
  return N < 16 ? N : 16;
}
// a staged row of N: each slice of rows_per_lane(N) values is followed by
// 16 bytes of padding, so the four slices a quarter warp reads at once lie
// in different banks
template <typename T>
__host__ __device__ constexpr int row_pad() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int row_len(int N) {
  return N + (N / rows_per_lane(N)) * row_pad<T>();
}

template <typename T>
__host__ __device__ constexpr int smem_bytes(int N, int cols) {
  // r, k, w [2][kStep][row_len] and v [2][kStep][cols] in T; the slices'
  // parts of y [L][kStep][cols] and bonus sums [L][kStep], u [N] in fp32
  return (int)sizeof(T) * 2 * kStep * (3 * row_len<T>(N) + cols)
         + 4 * ((N / rows_per_lane(N)) * kStep * (cols + 1) + N);
}

// n_rows rows of COLS values (row stride ld) into shared memory rows of
// DLD, value i of a row at i + (i / SLICE) * PAD, by NT threads: 16-byte
// cp.async where the rows allow it, else element copies
template <typename T, int COLS, int DLD, int SLICE, int PAD, int NT>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t ld,
                                      int n_rows) {
  constexpr int E = 16 / sizeof(T);
  if (COLS % E == 0 && SLICE % E == 0 && ld % E == 0
      && ((uintptr_t)src & 15) == 0) {
    constexpr int CPR = COLS / E;
    for (int c = threadIdx.x; c < n_rows * CPR; c += NT) {
      const int r = c / CPR, i = (c % CPR) * E;
      cp_async16(smem_addr(dst + r * DLD + i + (i / SLICE) * PAD),
                 src + r * ld + i, true);
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * COLS; e += NT) {
      const int r = e / COLS, i = e % COLS;
      dst[r * DLD + i + (i / SLICE) * PAD] = src[r * ld + i];
    }
  }
}

template <int N, int COLS>
__host__ __device__ constexpr int block_threads() {
  return COLS / kCols * (N / rows_per_lane(N));
}

template <typename T, int N, int COLS, bool SAVE>
__global__ void __launch_bounds__(block_threads<N, COLS>())
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ final_state,
           float* __restrict__ states, int S, int H) {
  constexpr int R = rows_per_lane(N), L = N / R;
  constexpr int PAD = row_pad<T>(), NS = row_len<T>(N);
  constexpr int NT = block_threads<N, COLS>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* r_s = reinterpret_cast<T*>(smem_raw);     // [2][kStep][NS]
  T* k_s = r_s + 2 * kStep * NS;
  T* w_s = k_s + 2 * kStep * NS;
  T* v_s = w_s + 2 * kStep * NS;               // [2][kStep][COLS]
  float* part_s = reinterpret_cast<float*>(v_s + 2 * kStep * COLS);
  float* ruk_s = part_s + L * kStep * COLS;    // [L][kStep]
  float* u_s = ruk_s + L * kStep;              // [N]

  const int bh = blockIdx.x / (N / COLS);
  const int j0 = (blockIdx.x % (N / COLS)) * COLS;
  const int b = bh / H, h = bh % H;
  const int cg = threadIdx.x % (COLS / kCols);
  const int sl = threadIdx.x / (COLS / kCols);
  const int i0 = sl * R, jc = cg * kCols;      // first row, column in tile
  const int64_t row = (int64_t)H * N;          // between time steps
  const int64_t base = ((int64_t)b * S * H + h) * N;

  float st[R][kCols];                          // S[i0 + q][j0 + jc + c]
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (init) {
      load_cols(init + ((int64_t)bh * N + i0 + q) * N + j0 + jc, st[q]);
    } else {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) st[q][cc] = 0.f;
    }
  }
  for (int e = threadIdx.x; e < N; e += NT) u_s[e] = u[(int64_t)bh * N + e];

  const int n_chunks = (S + kStep - 1) / kStep;
  auto issue = [&](int buf, int t0) {
    const int n = min(kStep, S - t0);
    const int64_t off = base + t0 * row;
    stage<T, N, NS, R, PAD, NT>(r_s + buf * kStep * NS, r + off, row, n);
    stage<T, N, NS, R, PAD, NT>(k_s + buf * kStep * NS, k + off, row, n);
    stage<T, N, NS, R, PAD, NT>(w_s + buf * kStep * NS, w + off, row, n);
    stage<T, COLS, COLS, COLS, 0, NT>(v_s + buf * kStep * COLS,
                                      v + off + j0, row, n);
    cp_async_commit();
  };
  if (n_chunks > 0) issue(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * kStep, n = min(kStep, S - t0);
    if (c + 1 < n_chunks) {
      issue(buf ^ 1, t0 + kStep);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // this buffer landed; u_s written
    const T* rt = r_s + buf * kStep * NS;
    const T* kt = k_s + buf * kStep * NS;
    const T* wt = w_s + buf * kStep * NS;
    const T* vt = v_s + buf * kStep * COLS + jc;
    // each slice's bonus sum, sum_{i in slice} r_i u_i k_i, once a step
    for (int e = threadIdx.x; e < L * n; e += NT) {
      const int t = e / L, s = e % L;
      const int at = t * NS + s * (R + PAD);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < R; q += 4) {
        const float4 r4 = load4(rt + at + q), k4 = load4(kt + at + q);
        const float* uq = u_s + s * R + q;
        acc = fmaf(r4.x * uq[0], k4.x, acc);
        acc = fmaf(r4.y * uq[1], k4.y, acc);
        acc = fmaf(r4.z * uq[2], k4.z, acc);
        acc = fmaf(r4.w * uq[3], k4.w, acc);
      }
      ruk_s[s * kStep + t] = acc;
    }
    __syncthreads();
    const int at = sl * (R + PAD);
    for (int t = 0; t < n; ++t) {
      if constexpr (SAVE) {
        if (t % kSave == 0) {            // the state before step t0 + t
          float* sv = states + ((((int64_t)b * ((S + kSave - 1) / kSave)
                                  + (t0 + t) / kSave) * H + h) * N + i0) * N
                      + j0 + jc;
#pragma unroll
          for (int q = 0; q < R; ++q) store_cols(sv + q * N, st[q]);
        }
      }
      float vj[kCols], acc[kCols];
      load_cols(vt + t * COLS, vj);
      const float bonus = ruk_s[sl * kStep + t];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[cc] = bonus * vj[cc];
#pragma unroll
      for (int q = 0; q < R; q += 4) {
        const float4 r4 = load4(rt + t * NS + at + q);
        const float4 w4 = load4(wt + t * NS + at + q);
        const float4 k4 = load4(kt + t * NS + at + q);
        const float re[4] = {r4.x, r4.y, r4.z, r4.w};
        const float we[4] = {w4.x, w4.y, w4.z, w4.w};
        const float ke[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            acc[cc] = fmaf(re[e], st[q + e][cc], acc[cc]);
            st[q + e][cc] = fmaf(we[e], st[q + e][cc], ke[e] * vj[cc]);
          }
      }
      store_cols(part_s + (sl * kStep + t) * COLS + jc, acc);
    }
    __syncthreads();                   // every slice's part of y is in
    for (int e = threadIdx.x; e < n * COLS; e += NT) {
      const int t = e / COLS, jj = e % COLS;
      float sum = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) sum += part_s[(l * kStep + t) * COLS + jj];
      store(y + base + (t0 + t) * row + j0 + jj, sum);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    store_cols(final_state + ((int64_t)bh * N + i0 + q) * N + j0 + jc, st[q]);
}

template <typename K>
int configure(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int N, int COLS, bool SAVE>
int launch_save(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* init, void* y, void* state,
                void* states, int B, int S, int H, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>(N, COLS);
  static const int configured =
      configure(wkv_kernel<T, N, COLS, SAVE>, bytes);
  if (configured != 0) return configured;
  wkv_kernel<T, N, COLS, SAVE>
      <<<B * H * (N / COLS), block_threads<N, COLS>(), bytes, stream>>>((const T*)r, (const T*)k, (const T*)v, (const T*)w,
                   (const float*)u, (const float*)init, (T*)y, (float*)state,
                   (float*)states, S, H);
  return (int)cudaGetLastError();
}

// Without `states` the instance built without the store runs, so that
// serving's step loop carries no branch for it; only float32 saves (the
// backward's one type).
template <typename T, int N, int COLS>
int launch_cols(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* init, void* y, void* state,
                void* states, int B, int S, int H, cudaStream_t stream) {
  if (states == nullptr)
    return launch_save<T, N, COLS, false>(r, k, v, w, u, init, y, state,
                                          states, B, S, H, stream);
  if constexpr (std::is_same<T, float>::value)
    return launch_save<T, N, COLS, true>(r, k, v, w, u, init, y, state,
                                         states, B, S, H, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* init, void* y, void* state,
           void* states, int B, int S, int H, int cols, cudaStream_t st) {
  switch (cols) {
    case 8:
      return launch_cols<T, N, 8>(r, k, v, w, u, init, y, state, states,
                                  B, S, H, st);
    case 16:
      if constexpr (N >= 16)
        return launch_cols<T, N, 16>(r, k, v, w, u, init, y, state, states,
                                     B, S, H, st);
      break;
    case 32:
      if constexpr (N >= 32)
        return launch_cols<T, N, 32>(r, k, v, w, u, init, y, state, states,
                                     B, S, H, st);
      break;
    case 64:
      if constexpr (N >= 64)
        return launch_cols<T, N, 64>(r, k, v, w, u, init, y, state, states,
                                     B, S, H, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dim(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* init, void* y, void* state,
               void* states, int B, int S, int H, int N, int cols,
               cudaStream_t st) {
  switch (N) {
    case 8: return launch<T, 8>(r, k, v, w, u, init, y, state, states,
                                B, S, H, cols, st);
    case 16: return launch<T, 16>(r, k, v, w, u, init, y, state, states,
                                  B, S, H, cols, st);
    case 32: return launch<T, 32>(r, k, v, w, u, init, y, state, states,
                                  B, S, H, cols, st);
    case 64: return launch<T, 64>(r, k, v, w, u, init, y, state, states,
                                  B, S, H, cols, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v, w and y [B, S, H, N] of one type (bf16 != 0: bfloat16, else
// float32); u [B * H, N], init (or null: zeros) and state [B, H, N, N]
// float32; states (or null: not written) [B, ceil(S / 16), H, N, N]
// float32, the state before steps 0, 16, 32, ...; all contiguous; a
// block takes `cols` state columns (8 <= cols <= N, dividing N).  Returns
// a CUDA error code; cudaErrorInvalidValue for N outside {8, 16, 32, 64}
// or such cols, and for states with bfloat16 inputs.
int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* init, void* y, void* state,
               void* states, int B, int S, int H, int N, int cols, int bf16,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_dim<__nv_bfloat16>(r, k, v, w, u, init, y, state, states,
                                     B, S, H, N, cols, st);
  return launch_dim<float>(r, k, v, w, u, init, y, state, states, B, S, H,
                           N, cols, st);
}

// The dynamic shared memory a block takes at these sizes.
int rwkv6_scan_smem_bytes(int N, int cols, int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>(N, cols) : smem_bytes<float>(N, cols);
}

}  // extern "C"
