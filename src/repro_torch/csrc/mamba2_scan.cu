// Chunked Mamba2 SSD scan for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/mamba2_scan/mamba2_scan.py:
// mamba2_scan_kernel, the Pallas kernel whose grid walks (head, chunk) with
// the chunks in order and keeps the [N, P] state in VMEM scratch.  This
// kernel also takes an initial state (or zeros) and writes the final state,
// which the prefill cache needs (models/ssm.py: ssd_chunked).
//
// Computes, for every batch row b and head h (group g = h / (H / G)), over
// chunks of Q positions in order, with dA = dt * A[b, h], cum its inclusive
// cumulative sum within the chunk and dtx = dt * x:
//   y[i]  = sum_{j <= i} (C[i] . B[j]) exp(cum[i] - cum[j]) dtx[j]
//         + exp(cum[i]) C[i] . state
//   state = state exp(cum[Q-1]) + sum_j exp(cum[Q-1] - cum[j]) B[j] dtx[j]^T
// y is written in x's type, the state in fp32.  A last chunk shorter than
// Q is padded with dt = x = B = C = 0, which adds nothing and leaves cum
// where it was.
//
// Layout: x and y [B, S, H, P], dt [B, S, H] fp32, A [B * H] fp32, Bm and
// Cm [B, S, G, N] in x's type, state [B, H, N, P] fp32, all contiguous.
// The Pallas layout [BH, S, P] is the case H = G = 1.
//
// Bound: bytes.  At zamba2-2.7b's prefill (4 x 80 heads, S 2048, Q 128,
// N = P = 64, bf16) the function moves 178 MB (x in, y out, B, C, dt, the
// state) in 0.053 ms at 3.35 TB/s; its 21.6 GFLOP, with C B^T once per
// group, take 0.022 ms on the bf16 tensor cores.
//
// Design, bfloat16 (the models' prefill type): three passes over blocks
// that are independent of one another, as the SSD algorithm decomposes,
// so that the chunks of one head run in parallel instead of in order (the
// TPU's grid walks them in order; here one block per (b, h) walking 16
// chunks left 320 blocks of one wave each and ran at 1.3% of the bound).
//   (a) ssd_state_kernel, a block of 4 warps per (b, chunk, tile of heads
//       in one group): each head's cum by a warp scan (four positions a
//       lane), then the chunk's own state S_loc = (B * exp(cum_last - cum)
//       * dt)^T @ x  [N, P] on mma.sync.m16n8k16 (bf16 in, fp32 sums; B^T
//       by ldmatrix.trans, scaled in registers) and the chunk's decay
//       exp(cum_last).
//   (b) ssd_pass_kernel, a thread per state element of each (b, h): walks
//       the chunks in order in fp32, s_prev[c] = s, s = s * dec[c] +
//       S_loc[c]; the initial state enters here and the final state
//       leaves here.
//   (c) ssd_output_kernel, a block of 4 warps per (b, chunk, tile of heads
//       in one group).  Warp w owns the row tiles w and RT - 1 - w, so
//       every warp has the same share of the triangle; it computes its
//       16 x 16 tiles of C B^T on and below the diagonal once for the
//       block's group, on the tensor cores, and keeps them in registers
//       for all the block's heads.  For each head, y = M @ x + exp(cum)
//       (C @ s_prev) with M = C B^T exp(cum[i] - cum[j]) dt[j] built in
//       registers, on the lower triangle only.
// What bounds it on this card is latency, not bytes or the tensor cores:
// each warp's products wait on shared memory and on each other.  mma.sync
// is volatile asm, issued in program order, so the n-tiles of one operand
// run back to back and no product waits on the one before it.  Every
// operand that is not an input (M, the scaled B^T of pass (a), s_prev) is
// split into a bf16 hi and a bf16 remainder lo and multiplied twice: one
// bf16 rounding of them left errors of about 0.3% of y's RMS, and over
// the 42 million outputs of a prefill some element exceeded the 2e-2 gate.
// Heads a block: plan_heads in the wrapper, from the blocks of pass (c) an
// SM holds (mamba2_scan_blocks_per_sm), so that the last wave is full (10
// heads, 512 blocks at zamba2's prefill).  x and s_prev of the next head
// are copied by cp.async while the current one is computed.  Q, N and P
// are padded to multiples of 16 with zeros in shared memory, so every
// Q <= 128, N <= 128 and P <= 64 runs.  At N 128 (mamba2-2.7b's d_state)
// pass (c) takes 161,792 bytes at Q 128 and 16 heads, so an SM holds one
// block of it (two at N 64); pass (a) still fits two.  A chunk above 128
// never reaches the kernel: the wrapper runs it as chunks of 128, which
// changes only the order of the sums.  Nor does a wider state: the state
// is separable on both axes (column p of h and y depends only on x[.., p];
// row n of h only on B[n], and y sums over the rows), so the wrapper runs
// P past 64 as groups of columns (y and the state concatenated) and N past
// 128 as groups of rows, whose y it sums in fp32: pass (c) then writes y
// in fp32 (ssd_output_kernel<float>) and the wrapper rounds the sum once
// (see mamba2_scan.py).  Scratch from the wrapper: S_loc
// [B, chunks, H, N, P] fp32, s_prev [B, chunks, H, 2 (hi, lo), N, P] bf16
// and dec [B, chunks, H] fp32; at zamba2's prefill 83,886,080, 83,886,080
// and 20,480 bytes.
//
// Design, float32 (the models' agreement checks; the tolerance of 2e-5
// rules out TF32): one block of 256 threads per (b, h), looping over the
// chunks in order with the state in shared memory, all on the CUDA cores.
// Per chunk the block stages B, C, dtx and cum in shared memory, builds
// the [Q, Q] decayed C B^T matrix, then each thread computes an
// interleaved register tile of y and, after a barrier, of the state
// update (in tiles of 64 state rows, so N 128 takes two).  Its shared
// memory bounds Q at 64 when N is above 64 (kF32Floats).  For training it
// also writes the state entering each
// chunk, s_prev [B, chunks, H, N, P] fp32 (the bf16 passes leave theirs
// in the scratch), which the backward (csrc/mamba2_scan_bwd.cu) reads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;             // state rows (d_state) a launch
constexpr int kMaxP = 64;              // state columns (head dim) a launch

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// ------------------------------------------- fp32 on the CUDA cores, in order
__host__ __device__ constexpr int smem_floats(int Q, int N, int P) {
  // B, C [Q][N + 1]; dtx [Q][P]; M [Q][Q + 1]; state [N][P]; cum, dt [Q]
  return 2 * Q * (N + 1) + Q * P + Q * (Q + 1) + N * P + 2 * Q;
}
// the most the fp32 kernel is configured for: Q 128 at N 64, or Q 64 at
// N 128 (the wrapper's chunk there; Q 128 would take 264,704 bytes)
constexpr int kF32Floats =
    smem_floats(kMaxQ, 64, kMaxP) > smem_floats(64, kMaxN, kMaxP)
        ? smem_floats(kMaxQ, 64, kMaxP)
        : smem_floats(64, kMaxN, kMaxP);

template <typename T, bool SAVE>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ final_state,
           float* __restrict__ s_prev, int S, int H, int G, int N, int P,
           int Q) {
  extern __shared__ float smem[];
  const int NP1 = N + 1;
  float* B_s = smem;                     // [Q][N + 1]
  float* C_s = B_s + Q * NP1;            // [Q][N + 1]
  float* x_s = C_s + Q * NP1;            // [Q][P]   dt * x
  float* M_s = x_s + Q * P;              // [Q][Q + 1]
  float* st_s = M_s + Q * (Q + 1);       // [N][P]
  float* cum_s = st_s + N * P;           // [Q]
  float* dt_s = cum_s + Q;               // [Q]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a = A[bh];
  const int tid = threadIdx.x;
  const int t16 = tid / 16, l16 = tid % 16;

  for (int i = tid; i < N * P; i += kThreads)
    st_s[i] = init ? init[(int64_t)bh * N * P + i] : 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * Q;
    __syncthreads();                     // last chunk's readers are done
    if constexpr (SAVE) {                // the state entering this chunk
      float* out = s_prev + (((int64_t)b * n_chunks + ch) * H + h) * N * P;
      for (int i = tid; i < N * P; i += kThreads) out[i] = st_s[i];
    }
    for (int i = tid; i < Q; i += kThreads) {
      const int s = s0 + i;
      dt_s[i] = s < S ? dt[((int64_t)b * S + s) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                      // inclusive cumsum of dt * A
      float c = 0.f;
      for (int i = 0; i < Q; ++i) {
        c += dt_s[i] * a;
        cum_s[i] = c;
      }
    }
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P, p = i % P, s = s0 + r;
      x_s[i] = s < S ? dt_s[r] * to_f32(x[(((int64_t)b * S + s) * H + h) * P + p])
                     : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, n = i % N, s = s0 + r;
      const int64_t off = (((int64_t)b * S + s) * G + g) * N + n;
      B_s[r * NP1 + n] = s < S ? to_f32(Bm[off]) : 0.f;
      C_s[r * NP1 + n] = s < S ? to_f32(Cm[off]) : 0.f;
    }
    __syncthreads();
    // M[i][j] = (C[i] . B[j]) exp(cum[i] - cum[j]) for j <= i, else 0;
    // thread tile rows t16 + 16 u, columns l16 + 16 w
    {
      float acc[8][8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) acc[u][w] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = t16 + 16 * u, j = l16 + 16 * u;
          cv[u] = i < Q ? C_s[i * NP1 + n] : 0.f;
          bv[u] = j < Q ? B_s[j * NP1 + n] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 8; ++w) acc[u][w] = fmaf(cv[u], bv[w], acc[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = t16 + 16 * u;
        if (i >= Q) continue;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int j = l16 + 16 * w;
          if (j >= Q) continue;
          M_s[i * (Q + 1) + j] =
              j <= i ? acc[u][w] * expf(cum_s[i] - cum_s[j]) : 0.f;
        }
      }
    }
    __syncthreads();
    // y[i][p] = sum_j M[i][j] dtx[j][p] + exp(cum[i]) sum_n C[i][n] st[n][p]
    // thread tile rows t16 + 16 u (u < 8), columns l16 + 16 w (w < 4)
    {
      float acc[8][4], inter[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = inter[u][w] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float mv[8], xv[4];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = t16 + 16 * u;
          mv[u] = i < Q ? M_s[i * (Q + 1) + j] : 0.f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          xv[w] = p < P ? x_s[j * P + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(mv[u], xv[w], acc[u][w]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[8], sv[4];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = t16 + 16 * u;
          cv[u] = i < Q ? C_s[i * NP1 + n] : 0.f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          sv[w] = p < P ? st_s[n * P + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            inter[u][w] = fmaf(cv[u], sv[w], inter[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = t16 + 16 * u;
        const int s = s0 + i;
        if (i >= Q || s >= S) continue;
        const float e = expf(cum_s[i]);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          if (p < P)
            store(y + (((int64_t)b * S + s) * H + h) * P + p,
                  acc[u][w] + inter[u][w] * e);
        }
      }
    }
    __syncthreads();                     // y read the state: update it now
    // st[n][p] = st[n][p] exp(cum[Q-1])
    //          + sum_j exp(cum[Q-1] - cum[j]) B[j][n] dtx[j][p]
    // thread tile rows n0 + t16 + 16 u (u < 4) for each 64 rows n0,
    // columns l16 + 16 w (w < 4); each element is read and written by
    // its own thread only, so the update is in place
    for (int n0 = 0; n0 < N; n0 += 64) {
      const float last = cum_s[Q - 1];
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float dec = expf(last - cum_s[j]);
        float bv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = n0 + t16 + 16 * u;
          bv[u] = n < N ? B_s[j * NP1 + n] * dec : 0.f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          xv[w] = p < P ? x_s[j * P + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(bv[u], xv[w], acc[u][w]);
      }
      const float chunk_dec = expf(last);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + t16 + 16 * u;
        if (n >= N) continue;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          if (p < P) st_s[n * P + p] = st_s[n * P + p] * chunk_dec + acc[u][w];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads)
    final_state[(int64_t)bh * N * P + i] = st_s[i];
}


// ------------------------------------- bf16: three passes on the tensor cores
constexpr int kMaxHeads = 16;          // heads a block of passes (a) and (c)
constexpr int kPassThreads = 256;

// pass (c): C [Qp][Np + 8]; two buffers of x [Qp][Pp + 8] and s_prev hi
// and lo [2][Np][Pp + 8], B [Qp][Np + 8] over the second until C B^T is
// in registers; all bf16; dt, cum [heads][Qp] fp32
__host__ __device__ constexpr int output_buffer(int Q, int N, int P) {
  return pad16(Q) * (pad16(P) + 8) + 2 * pad16(N) * (pad16(P) + 8);
}
__host__ __device__ constexpr int output_smem_bytes(int Q, int N, int P,
                                                    int heads) {
  return 2 * (pad16(Q) * (pad16(N) + 8) + output_buffer(Q, N, P)
              + (output_buffer(Q, N, P) > pad16(Q) * (pad16(N) + 8)
                     ? output_buffer(Q, N, P)
                     : pad16(Q) * (pad16(N) + 8)))
         + 4 * 2 * heads * pad16(Q);
}

// (b): the chunks of each (b, h) in order, a thread per state element
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ s_loc, const float* __restrict__ dec,
                const float* __restrict__ init, bf16* __restrict__ s_prev,
                float* __restrict__ final_state, int nc, int H, int NP) {
  const int per = (NP + kPassThreads - 1) / kPassThreads;
  const int bh = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kPassThreads + threadIdx.x;
  if (e >= NP) return;
  const int b = bh / H, h = bh % H;
  float s = init ? init[(int64_t)bh * NP + e] : 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const int64_t u = ((int64_t)b * nc + c) * H + h;
    const bf16 hi = __float2bfloat16(s);
    s_prev[2 * u * NP + e] = hi;
    s_prev[(2 * u + 1) * NP + e] = __float2bfloat16(s - __bfloat162float(hi));
    s = fmaf(s, dec[u], s_loc[u * NP + e]);
  }
  final_state[(int64_t)bh * NP + e] = s;
}

// (c): y = M @ x + exp(cum) (C @ s_prev), M = C B^T exp(cum[i] - cum[j])
// dt[j] for j <= i.  Warp w owns the row tiles w and RT - 1 - w and so
// the tiles (r, kt <= r) of C B^T on them: w + 1 and RT - w of them, the
// same count for every warp (nf), walked as one flat list f so that each
// tile's fragments sit in registers at a fixed index
// y of type YT: bf16, or fp32 when the wrapper sums groups of state rows
// (each group's y a part of the whole, rounded once after the sum)
template <typename YT>
__global__ void __launch_bounds__(kTcThreads)
ssd_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const bf16* __restrict__ s_prev,
                  YT* __restrict__ y, int S, int H, int G, int N, int P,
                  int Q, int heads) {
  constexpr int kMaxTiles = kMaxQ / 16 + 1;      // tiles a warp, at most
  const int Qp = pad16(Q), Np = pad16(N), Pp = pad16(P);
  const int NL = Np + 8, PL = Pp + 8;
  const int nc = (S + Q - 1) / Q;
  const Tile tl = tile_of(blockIdx.x, nc, G, H / G, heads);
  const int s0 = tl.c * Q, n_valid = min(Q, S - s0);
  const int buf = output_buffer(Q, N, P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);   // [Qp][NL]
  bf16* buf0 = c_s + Qp * NL;                       // x, s_prev hi, lo
  bf16* buf1 = buf0 + buf;
  bf16* b_s = buf1;                                 // [Qp][NL], then buf1
  float* dt_s = reinterpret_cast<float*>(buf1 + max(buf, Qp * NL));
  float* cum_s = dt_s + heads * Qp;                 // [heads][Qp]

  const int64_t xld = (int64_t)H * P;
  const int64_t bcld = (int64_t)G * N;
  const int64_t bc0 = (((int64_t)tl.b * S + s0) * G + tl.g) * N;
  const bf16* xb = x + ((int64_t)tl.b * S + s0) * xld;
  const int64_t unit = ((int64_t)tl.b * nc + tl.c) * H + tl.h0;
  auto stage_head = [&](int hi, bf16* dst) {
    stage(dst, PL, xb + (int64_t)(tl.h0 + hi) * P, xld, n_valid, Qp, P, Pp);
    stage_state(dst + Qp * PL, s_prev + 2 * (unit + hi) * N * P, N, P);
    cp_async_commit();
  };
  stage(c_s, NL, Cm + bc0, bcld, n_valid, Qp, N, Np);
  stage(b_s, NL, Bm + bc0, bcld, n_valid, Qp, N, Np);
  cp_async_commit();
  stage_head(0, buf0);
  chunk_cumsum(dt_s, cum_s, dt, A, tl, s0, n_valid, S, H, Qp);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int RT = Qp / 16, PT = Pp / 8, NK = Np / 16;
  const int mirror = RT - 1 - warp;
  const int nf = warp < mirror ? RT + 1 : warp == mirror ? warp + 1 : 0;
  const int a_off = a_lane(lane, NL);
  const int x_off = bt_lane(lane, PL);

  // this warp's tiles of C B^T, once for all the block's heads
  cp_async_wait<1>();                  // C and B (the first group)
  __syncthreads();
  float cb[kMaxTiles][8];
#pragma unroll
  for (int f = 0; f < kMaxTiles; ++f) {
    if (f >= nf) continue;
    const int r = f <= warp ? warp : mirror, kt = f <= warp ? f : f - warp - 1;
#pragma unroll
    for (int e = 0; e < 8; ++e) cb[f][e] = 0.f;
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, smem_addr(c_s + r * 16 * NL + a_off + ks * 16));
      ldsm_x4(bk, smem_addr(b_s + kt * 16 * NL + b_lane(lane, NL) + ks * 16));
      mma_bf16(cb[f], a, bk[0], bk[1]);
      mma_bf16(cb[f] + 4, a, bk[2], bk[3]);
    }
  }
  __syncthreads();                     // B is overwritten by head 1 next

  for (int hi = 0; hi < tl.nh; ++hi) {
    const int st = hi & 1;
    if (hi + 1 < tl.nh) {
      stage_head(hi + 1, st ? buf0 : buf1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // x and s_prev of head hi
    const float* cum = cum_s + hi * Qp;
    const float* dth = dt_s + hi * Qp;
    const bf16* xt = st ? buf1 : buf0;
    const bf16* spt = xt + Qp * PL;    // hi [Np][PL], then lo
    YT* yh = y + ((int64_t)tl.b * S + s0) * xld + (int64_t)(tl.h0 + hi) * P;
    float acc[8][4];
#pragma unroll
    for (int f = 0; f < kMaxTiles; ++f) {
      if (f >= nf) continue;
      const int r = f <= warp ? warp : mirror;
      const int kt = f <= warp ? f : f - warp - 1;
      const int i0 = r * 16 + g, i1 = i0 + 8;
      const float c0 = cum[i0], c1 = cum[i1];
      if (kt == 0) {                   // a new row tile: exp(cum) C s_prev
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        for (int ks = 0; ks < NK; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, smem_addr(c_s + r * 16 * NL + a_off + ks * 16));
          mma_row(acc, a, smem_addr(spt + ks * 16 * PL + x_off), PT);
          mma_row(acc, a, smem_addr(spt + (Np + ks * 16) * PL + x_off), PT);
        }
        const float e0 = __expf(c0), e1 = __expf(c1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }
      // M on tile (r, kt), from its C B^T fragments: rows i0 (cb 0, 1, 4,
      // 5) and i1 (2, 3, 6, 7), columns k0 (+ 1) and k0 + 8 (+ 1)
      const int k0 = kt * 16 + 2 * t4;
      float m[8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = k0 + 8 * half;
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const float2 dj = *reinterpret_cast<const float2*>(dth + j);
        const float* q = cb[f] + 4 * half;
        m[4 * half] = j <= i0 ? q[0] * __expf(c0 - cj.x) * dj.x : 0.f;
        m[4 * half + 1] = j + 1 <= i0 ? q[1] * __expf(c0 - cj.y) * dj.y : 0.f;
        m[4 * half + 2] = j <= i1 ? q[2] * __expf(c1 - cj.x) * dj.x : 0.f;
        m[4 * half + 3] = j + 1 <= i1 ? q[3] * __expf(c1 - cj.y) * dj.y : 0.f;
      }
      uint32_t ah[4], al[4];
      split2(m[0], m[1], ah[0], al[0]);
      split2(m[2], m[3], ah[1], al[1]);
      split2(m[4], m[5], ah[2], al[2]);
      split2(m[6], m[7], ah[3], al[3]);
      mma_split(acc, ah, al, smem_addr(xt + kt * 16 * PL + x_off), PT);
      if (kt != r) continue;
      // the row tile is done: y rows i0 and i1, columns j * 8 + 2 t4 (+ 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? i1 : i0;
        if (i >= n_valid) continue;
        YT* yr = yh + i * xld;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = j * 8 + 2 * t4;
          if (j >= PT || p >= P) continue;
          if constexpr (sizeof(YT) == 4) {
            yr[p] = acc[j][2 * half];
            if (p + 1 < P) yr[p + 1] = acc[j][2 * half + 1];
          } else if (p + 1 < P && (P & 1) == 0)
            *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
                acc[j][2 * half], acc[j][2 * half + 1]);
          else {
            yr[p] = __float2bfloat16(acc[j][2 * half]);
            if (p + 1 < P) yr[p + 1] = __float2bfloat16(acc[j][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();                   // this buffer is refilled next
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
int configure(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool SAVE>
int launch_f32_save(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* init, void* y,
                    void* state, void* s_prev, int B, int S, int H, int G,
                    int N, int P, int Q, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(Q, N, P);
  static const int configured = configure(
      ssd_kernel<float, SAVE>, (int)(sizeof(float) * kF32Floats));
  if (configured != 0) return configured;
  ssd_kernel<float, SAVE><<<B * H, kThreads, bytes, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)init, (float*)y, (float*)state,
      (float*)s_prev, S, H, G, N, P, Q);
  return (int)cudaGetLastError();
}

// Without s_prev the instance built without the store runs, so that
// inference's chunk loop carries no branch for it.
int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* init, void* y, void* state,
               void* s_prev, int B, int S, int H, int G, int N, int P, int Q,
               cudaStream_t stream) {
  if (s_prev == nullptr)
    return launch_f32_save<false>(x, dt, A, Bm, Cm, init, y, state, s_prev,
                                  B, S, H, G, N, P, Q, stream);
  return launch_f32_save<true>(x, dt, A, Bm, Cm, init, y, state, s_prev, B,
                               S, H, G, N, P, Q, stream);
}

int configure_bf16() {
  static const int configured =
      configure(ssd_state_kernel<false>,
                state_smem_bytes(kMaxQ, kMaxN, kMaxP, kMaxHeads))
      | configure(ssd_output_kernel<bf16>,
                  output_smem_bytes(kMaxQ, kMaxN, kMaxP, kMaxHeads))
      | configure(ssd_output_kernel<float>,
                  output_smem_bytes(kMaxQ, kMaxN, kMaxP, kMaxHeads));
  return configured;
}

int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* init, void* y, void* state,
                void* s_loc, void* s_prev, void* dec, int B, int S, int H,
                int G, int N, int P, int Q, int heads, int y_f32,
                cudaStream_t stream) {
  const int configured = configure_bf16();
  if (configured != 0) return configured;
  const int nc = (S + Q - 1) / Q, rep = H / G;
  const int blocks = B * nc * G * ((rep + heads - 1) / heads);
  const int NP = N * P;
  if (blocks > 0) {
    ssd_state_kernel<false><<<blocks, kTcThreads,
                       state_smem_bytes(Q, N, P, heads), stream>>>(
        (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
        (float*)s_loc, (float*)dec, S, H, G, N, P, Q, heads);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ssd_pass_kernel<<<B * H * ((NP + kPassThreads - 1) / kPassThreads),
                    kPassThreads, 0, stream>>>(
      (const float*)s_loc, (const float*)dec, (const float*)init,
      (bf16*)s_prev, (float*)state, nc, H, NP);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 0) return (int)err;
  const int bytes = output_smem_bytes(Q, N, P, heads);
  if (y_f32)
    ssd_output_kernel<float><<<blocks, kTcThreads, bytes, stream>>>(
        (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
        (const bf16*)Cm, (const bf16*)s_prev, (float*)y, S, H, G, N, P, Q,
        heads);
  else
    ssd_output_kernel<bf16><<<blocks, kTcThreads, bytes, stream>>>(
        (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
        (const bf16*)Cm, (const bf16*)s_prev, (bf16*)y, S, H, G, N, P, Q,
        heads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y [B, S, H, P] and Bm/Cm [B, S, G, N] of one type (bf16 != 0:
// bfloat16, else float32); dt [B, S, H], A [B * H], init (or null: zeros)
// and state [B, H, N, P] float32; all contiguous, H a multiple of G.
// bfloat16 also takes the scratch s_loc [B, chunks, H, N, P] float32,
// s_prev [B, chunks, H, 2, N, P] in bfloat16 (hi and lo halves of the
// state entering each chunk) and dec [B, chunks, H] float32, and the
// heads a block of passes (a) and (c) takes; float32 ignores all but
// s_prev, which it fills in float32 [B, chunks, H, N, P] unless it is
// null.
// With y_f32 != 0 a bfloat16 launch writes y in float32 (the wrapper's
// part of a sum over groups of state rows).
// Returns a CUDA error code; cudaErrorInvalidValue outside 1 <= Q <= 128,
// 1 <= N <= 128, 1 <= P <= 64 (a launch's group: the wrapper cuts a wider
// state into groups), for float32 a Q, N whose shared memory
// passes kF32Floats (Q <= 64 at N above 64) and, for bfloat16, 1 <= heads
// <= 16.
int mamba2_scan(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* init, void* y, void* state,
                void* s_loc, void* s_prev, void* dec, int B, int S, int H,
                int G, int N, int P, int Q, int heads, int bf16, int y_f32,
                void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP
      || (bf16 && (heads < 1 || heads > kMaxHeads))
      || (!bf16 && smem_floats(Q, N, P) > kF32Floats))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_bf16(x, dt, A, Bm, Cm, init, y, state, s_loc, s_prev, dec,
                       B, S, H, G, N, P, Q, heads, y_f32, st);
  return launch_f32(x, dt, A, Bm, Cm, init, y, state, s_prev, B, S, H, G, N,
                    P, Q, st);
}

// How many blocks of the bfloat16 pass (c), the longest, an SM holds at
// once at these sizes and kMaxHeads heads a block, as the occupancy
// calculator reports it (what the wrapper's head planner reads).
// Returns a CUDA error code.
int mamba2_scan_blocks_per_sm(int Q, int N, int P, int* blocks) {
  const int configured = configure_bf16();
  if (configured != 0) return configured;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_output_kernel<bf16>, kTcThreads,
      output_smem_bytes(Q, N, P, kMaxHeads));
}

// The dynamic shared memory of pass (a) (which 0) or (c) (which 1) of the
// bfloat16 kernel at these sizes.
int mamba2_scan_smem_bytes(int Q, int N, int P, int heads, int which) {
  return which ? output_smem_bytes(Q, N, P, heads)
               : state_smem_bytes(Q, N, P, heads);
}

}  // extern "C"
