// Backward of the RWKV6 (Finch) recurrence for Hopper (sm_90a), plain C
// interface.
//
// Differentiates: src/repro/kernels/rwkv6_scan/rwkv6_scan.py:
// rwkv6_scan_kernel, whose forward csrc/rwkv6_scan.cu computes.  The
// Pallas kernel has no backward of its own: the reference differentiates
// its pure-jnp recurrence (models/ssm.py: _rwkv6_chunked), as the port's
// plain backward differentiates rwkv6_scan_plain.
//
// Forward, per batch row b and head h, with P_t the [N, N] state before
// step t (P_0 the initial state, P_S the final one):
//   y_t     = r_t (P_t + (u * k_t) v_t^T)
//   P_{t+1} = diag(w_t) P_t + k_t v_t^T
// Backward, t from S - 1 down to 0, G_{t+1} the gradient of P_{t+1}
// (G_S that of the final state) and (v.dy)_t = v_t . dy_t:
//   dr_t[i] = sum_j P_t[i][j] dy_t[j] + u_i k_t[i] (v.dy)_t
//   dk_t[i] = sum_j G_{t+1}[i][j] v_t[j] + u_i r_t[i] (v.dy)_t
//   dv_t[j] = sum_i G_{t+1}[i][j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_{t+1}[i][j] P_t[i][j]
//   du[i]  += r_t[i] k_t[i] (v.dy)_t
//   G_t     = diag(w_t) G_{t+1} + r_t dy_t^T,   dinit = G_0.
// fp32 only: every model path casts r, k, v and w to fp32.
//
// Layout: r, k, v, w, dy and the gradients dr, dk, dv, dw [B, S, H, N]
// fp32; u and du [B * H, N]; dstate (or null: zeros) and dinit
// [B, H, N, N]; states [B, ceil(S / kSave), H, N, N], P_t at t = 0,
// kSave, 2 kSave, ... as the forward wrote it; all contiguous.
//
// Bound: bytes.  At rwkv6-3b's training shape (4 x 40 heads, S 2048,
// N 64) the gradient's own bytes (r, k, v, w, u, init, dy and dstate
// read, their gradients written) are 0.76 GB, 0.23 ms at 3.35 TB/s (the
// saved states this design reads add 0.34 GB).  The chunked form that
// the reference differentiates, in chunks of kSave steps from the saved
// states, does 8 N^2 + 15 (kSave - 1) N / 2 flops a step (four products
// with an N x N matrix and the pairs within a chunk): 13.3 GFLOP, 0.20
// ms at the fp32 peak.  This design steps the recurrence instead (14
// flops a state element a step: the state recomputed, dr, dk, dv, dw and
// the state gradient), whose work is elementwise and in registers.
//
// Design: the state gradient's recurrence is linear, like the state's, so
// the time axis splits into the stretches of kSave steps between the
// forward's saved states, and four kernels of independent blocks walk
// them (no atomics: two runs are bit-equal; w, which reaches ~0, is never
// divided by):
//   (1) wkv_bwd_local, a block per (b, h, stretch): the stretch's own
//       contribution to the gradient of the state entering it, G_loc =
//       sum_t diag(prod_{t0 <= tau < t} w_tau) r_t dy_t^T, the running
//       products formed forward step by step, and its decay D = prod_t w_t;
//   (2) wkv_bwd_pass, a thread per state element of each (b, h): from
//       the last stretch, G at each stretch's end replaces its G_loc
//       (G_start = D G_end + G_loc), and dinit is the first stretch's start;
//   (3) wkv_bwd_stretch, a block per (b, h, stretch), all stretches at
//       once: from the saved state at its start and (2)'s G at its end,
//       the state is recomputed forward through the stretch (dr, the
//       stretch's part of du, and a checkpoint every kSub steps in shared
//       memory), then each group of kSub steps is recomputed from its
//       checkpoint into registers and walked back with G (dw, dk, dv);
//   (4) wkv_bwd_du: du as the stretches' parts summed in order.
// A block of (3) holds whole state rows: a thread an RA x CA piece of P
// and G (4 x 4 of 64 x 64 with 256 threads), so dr, dk and dw finish in
// the block, by shuffles that scatter the rows' sums over the lanes of a
// row (each exchange halves the values a lane carries), and dv by a column
// sum over the row groups in shared memory.  At N 64 it takes 114,816
// bytes of shared memory and at most 128 registers a thread: two blocks an
// SM.  So the chains are kSave steps long, not S, and no partial sums
// leave a block but du's N floats a stretch (a block a tile of state
// columns, each thread a row walking all S steps, left partial row sums
// of 2.01 GB at rwkv6-3b's training shape and ran 4.43 ms there, against
// 1.90 ms, NVIDIA H100 80GB HBM3 at 700 W).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kSave = 16;             // steps between saved states: a stretch
constexpr int kSub = 4;               // steps between checkpoints in (3)
constexpr int kPassThreads = 256;

// a thread's piece of the [N, N] state: RA rows x CA columns, so that a
// block has at least a warp
template <int N> struct Piece;
template <> struct Piece<8> { static constexpr int RA = 1, CA = 2; };
template <> struct Piece<16> { static constexpr int RA = 2, CA = 4; };
template <> struct Piece<32> { static constexpr int RA = 4, CA = 4; };
template <> struct Piece<64> { static constexpr int RA = 4, CA = 4; };
template <int N>
__host__ __device__ constexpr int block_threads() {
  return (N / Piece<N>::RA) * (N / Piece<N>::CA);
}

// shared memory, fp32: (1) r, w, dy [3][kSave][N]; (3) r, k, v, w, dy
// [5][kSave][N], v . dy and the bonus sum a step [2][kSave], the
// checkpoints [kSave / kSub][N][N], the column sums' parts
// [kSub][N / RA][N] and dr, dk, dw [3][kSave][N]
__host__ __device__ constexpr int local_smem_bytes(int N) {
  return 4 * 3 * kSave * N;
}
__host__ __device__ constexpr int stretch_smem_bytes(int N, int RA) {
  return 4 * (5 * kSave * N + 2 * kSave + kSave / kSub * N * N
              + kSub * (N / RA) * N + 3 * kSave * N);
}

// v[0 .. V) summed over the W lanes of this lane's aligned group (V <= W,
// powers of two): each exchange halves the values a lane carries, so
// afterwards v[0] holds the group's sum of value (lane % W) / (W / V)
template <int V, int W>
struct Scatter {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (W > 1) {
      constexpr int off = W / 2;
      if constexpr (V > 1) {
        constexpr int half = V / 2;
        const bool up = (lane & off) != 0;
#pragma unroll
        for (int q = 0; q < half; ++q) {
          const float send = up ? v[q] : v[q + half];
          const float keep = up ? v[q + half] : v[q];
          v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
        Scatter<half, off>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
        Scatter<1, off>::run(v, lane);
      }
    }
  }
};

// M consecutive floats of shared memory into registers
template <int M>
__device__ __forceinline__ void load_vec(float (&out)[M], const float* p) {
  if constexpr (M == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  } else if constexpr (M == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x; out[1] = f.y;
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) out[m] = p[m];
  }
}

// M consecutive floats of registers into shared memory
template <int M>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[M]) {
  if constexpr (M == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (M == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) p[m] = in[m];
  }
}

// one [B, S, H, N] input's kSave steps of the stretch into dst [kSave][N]
// (zero past its n steps) by 16-byte cp.async, so that the loads of all
// the inputs are in flight at once; the caller commits and waits
template <int N>
__device__ __forceinline__ void stage_input(float* dst,
                                            const float* __restrict__ src,
                                            int64_t base, int64_t row,
                                            int t0, int n) {
  constexpr int NT = block_threads<N>(), V = N / 4;
  for (int e = threadIdx.x; e < kSave * V; e += NT) {
    const int t = e / V, j = (e % V) * 4;
    const bool ok = t < n;
    cp_async16(smem_addr(dst + t * N + j),
               src + base + (int64_t)(t0 + (ok ? t : 0)) * row + j, ok);
  }
}

// (1): per (b, h, stretch sv): gs = G_loc [N][N] and dec = D [N]
template <int N>
__global__ void __launch_bounds__(block_threads<N>())
wkv_bwd_local(const float* __restrict__ r, const float* __restrict__ w,
              const float* __restrict__ dy, float* __restrict__ gs,
              float* __restrict__ dec, int S, int H) {
  constexpr int RA = Piece<N>::RA, CA = Piece<N>::CA, TX = N / CA;
  extern __shared__ float smem[];
  float* r_s = smem;                           // [kSave][N]
  float* w_s = r_s + kSave * N;
  float* dy_s = w_s + kSave * N;
  const int n_save = (S + kSave - 1) / kSave;
  const int sv = blockIdx.x % n_save;
  const int64_t bh = blockIdx.x / n_save;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const int t0 = sv * kSave, n = min(kSave, S - t0);
  const int64_t row = (int64_t)H * N;
  const int64_t base = ((int64_t)b * S * H + h) * N;
  stage_input<N>(r_s, r, base, row, t0, n);
  stage_input<N>(w_s, w, base, row, t0, n);
  stage_input<N>(dy_s, dy, base, row, t0, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int i0 = ty * RA, j0 = tx * CA;
  float gl[RA][CA], cw[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    cw[a] = 1.f;
#pragma unroll
    for (int c = 0; c < CA; ++c) gl[a][c] = 0.f;
  }
  for (int t = 0; t < n; ++t) {
    float rr[RA], ww[RA], dd[CA];
    load_vec(rr, r_s + t * N + i0);
    load_vec(ww, w_s + t * N + i0);
    load_vec(dd, dy_s + t * N + j0);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float coef = rr[a] * cw[a];
#pragma unroll
      for (int c = 0; c < CA; ++c) gl[a][c] = fmaf(coef, dd[c], gl[a][c]);
      cw[a] *= ww[a];
    }
  }
  const int64_t unit = ((int64_t)b * n_save + sv) * H + h;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    store_vec(gs + (unit * N + i0 + a) * N + j0, gl[a]);
    if (tx == 0) dec[unit * N + i0 + a] = cw[a];
  }
}

// (2): from the last stretch, gs[sv] <- the gradient of the state leaving
// stretch sv; dinit.  A thread per (b, h, state element); the loads of a
// batch of stretches go out before their chain
__global__ void __launch_bounds__(kPassThreads)
wkv_bwd_pass(float* __restrict__ gs, const float* __restrict__ dec,
             const float* __restrict__ dstate, float* __restrict__ dinit,
             int n_save, int H, int N) {
  constexpr int kBatch = 8;
  const int NN = N * N;
  const int per = (NN + kPassThreads - 1) / kPassThreads;
  const int64_t bh = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kPassThreads + threadIdx.x;
  if (e >= NN) return;
  const int64_t b = bh / H, h = bh % H;
  float cur = dstate ? dstate[bh * NN + e] : 0.f;
  for (int hi = n_save - 1; hi >= 0; hi -= kBatch) {
    float loc[kBatch], d[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int sv = hi - q;
      const int64_t unit = (b * n_save + (sv >= 0 ? sv : 0)) * H + h;
      loc[q] = sv >= 0 ? gs[unit * NN + e] : 0.f;
      d[q] = sv >= 0 ? dec[unit * N + e / N] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int sv = hi - q;
      if (sv < 0) continue;
      gs[((b * n_save + sv) * H + h) * NN + e] = cur;
      cur = fmaf(d[q], cur, loc[q]);
    }
  }
  dinit[bh * NN + e] = cur;
}

// (4): du [B * H, N] = the stretches' parts du_part [B, n_save, H, N] in
// order
__global__ void __launch_bounds__(kPassThreads)
wkv_bwd_du(const float* __restrict__ du_part, float* __restrict__ du,
           int64_t n_u, int n_save, int H, int N) {
  const int64_t e = (int64_t)blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= n_u) return;
  const int64_t bh = e / N, b = bh / H, h = bh % H;
  float s = 0.f;
  for (int sv = 0; sv < n_save; ++sv)
    s += du_part[((b * n_save + sv) * H + h) * N + e % N];
  du[e] = s;
}

// (3): per (b, h, stretch sv): dr, dk, dw, dv of its steps and its part
// of du
template <int N>
__global__ void __launch_bounds__(block_threads<N>(), N == 64 ? 2 : 1)
wkv_bwd_stretch(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ states,
                const float* __restrict__ gs, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part, int S,
                int H) {
  constexpr int RA = Piece<N>::RA, CA = Piece<N>::CA;
  constexpr int TX = N / CA, TY = N / RA, NT = block_threads<N>();
  extern __shared__ float smem[];
  float* in_s = smem;                          // r, k, v, w, dy [kSave][N]
  float* vd_s = in_s + 5 * kSave * N;          // [kSave]
  float* bon_s = vd_s + kSave;                 // [kSave]
  float* ck_s = in_s + 5 * kSave * N + 2 * kSave;   // [kSave / kSub][N][N]
  float* cp_s = ck_s + kSave / kSub * N * N;   // [kSub][TY][N]
  float* out_s = cp_s + kSub * TY * N;         // dr, dk, dw [3][kSave][N]

  const int n_save = (S + kSave - 1) / kSave;
  const int sv = blockIdx.x % n_save;
  const int64_t bh = blockIdx.x / n_save;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const int t0 = sv * kSave, n = min(kSave, S - t0);
  const int64_t row = (int64_t)H * N;
  const int64_t base = ((int64_t)b * S * H + h) * N;
  const int64_t unit = ((int64_t)b * n_save + sv) * H + h;
  const int lane = threadIdx.x % 32;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int i0 = ty * RA, j0 = tx * CA;

  stage_input<N>(in_s, r, base, row, t0, n);
  stage_input<N>(in_s + kSave * N, k, base, row, t0, n);
  stage_input<N>(in_s + 2 * kSave * N, v, base, row, t0, n);
  stage_input<N>(in_s + 3 * kSave * N, w, base, row, t0, n);
  stage_input<N>(in_s + 4 * kSave * N, dy, base, row, t0, n);
  cp_async_commit();
  float P[RA][CA], G[RA][CA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    float tmp[CA];
    load_vec(tmp, states + (unit * N + i0 + a) * N + j0);
#pragma unroll
    for (int c = 0; c < CA; ++c) P[a][c] = tmp[c];
    load_vec(tmp, gs + (unit * N + i0 + a) * N + j0);
#pragma unroll
    for (int c = 0; c < CA; ++c) G[a][c] = tmp[c];
  }
  cp_async_wait<0>();
  __syncthreads();
  {  // v . dy and sum_i r u k a step: NT / kSave threads a step
    constexpr int TPS = NT / kSave, EPT = N / TPS;
    const int t = threadIdx.x / TPS, part = threadIdx.x % TPS;
    float vd = 0.f, bon = 0.f;
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
      const int j = part * EPT + m;
      vd = fmaf(in_s[(2 * kSave + t) * N + j], in_s[(4 * kSave + t) * N + j],
                vd);
      bon = fmaf(in_s[t * N + j] * u[bh * N + j], in_s[(kSave + t) * N + j],
                 bon);
    }
#pragma unroll
    for (int off = TPS / 2; off > 0; off >>= 1) {
      vd += __shfl_xor_sync(0xffffffffu, vd, off);
      bon += __shfl_xor_sync(0xffffffffu, bon, off);
    }
    if (part == 0) {
      vd_s[t] = vd;
      bon_s[t] = bon;
    }
  }
  __syncthreads();
  // the lanes that hold a total after Scatter: its value index, and
  // whether this lane writes it
  constexpr int V1 = RA, V2 = 2 * RA;
  const int idx1 = (lane % TX) / (TX / V1), idx2 = (lane % TX) / (TX / V2);
  const bool w1 = lane % (TX / V1) == 0, w2 = lane % (TX / V2) == 0;
  const float u1 = u[bh * N + i0 + idx1 % RA];
  const float u2 = u[bh * N + i0 + idx2 % RA];

  // forward through the stretch: checkpoints, dr and du's part
  float du[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) du[a] = 0.f;
#pragma unroll
  for (int t = 0; t < kSave; ++t) {
    if (t >= n) break;
    if (t % kSub == 0) {
#pragma unroll
      for (int a = 0; a < RA; ++a)
        store_vec(ck_s + ((t / kSub) * N + i0 + a) * N + j0, P[a]);
    }
    float rr[RA], kk[RA], ww[RA], vv[CA], dd[CA];
    load_vec(rr, in_s + t * N + i0);
    load_vec(kk, in_s + (kSave + t) * N + i0);
    load_vec(ww, in_s + (3 * kSave + t) * N + i0);
    load_vec(vv, in_s + (2 * kSave + t) * N + j0);
    load_vec(dd, in_s + (4 * kSave + t) * N + j0);
    float part[V1];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CA; ++c) {
        s = fmaf(P[a][c], dd[c], s);
        P[a][c] = fmaf(ww[a], P[a][c], kk[a] * vv[c]);
      }
      part[a] = s;
      du[a] = fmaf(rr[a] * kk[a], vd_s[t], du[a]);
    }
    Scatter<V1, TX>::run(part, lane);
    if (w1) {
      const int i = i0 + idx1;
      out_s[t * N + i] =
          fmaf(u1 * in_s[(kSave + t) * N + i], vd_s[t], part[0]);
    }
  }

  // back through the stretch, kSub steps at a time from their checkpoint
  for (int sb = (n - 1) / kSub; sb >= 0; --sb) {
    float hist[kSub][RA][CA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float tmp[CA];
      load_vec(tmp, ck_s + ((sb * N) + i0 + a) * N + j0);
#pragma unroll
      for (int c = 0; c < CA; ++c) hist[0][a][c] = tmp[c];
    }
#pragma unroll
    for (int s = 1; s < kSub; ++s) {
      const int t = sb * kSub + s - 1;
      float kk[RA], ww[RA], vv[CA];
      load_vec(kk, in_s + (kSave + t) * N + i0);
      load_vec(ww, in_s + (3 * kSave + t) * N + i0);
      load_vec(vv, in_s + (2 * kSave + t) * N + j0);
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CA; ++c)
          hist[s][a][c] = fmaf(ww[a], hist[s - 1][a][c], kk[a] * vv[c]);
    }
#pragma unroll
    for (int s = kSub - 1; s >= 0; --s) {
      const int t = sb * kSub + s;
      if (t >= n) continue;
      float rr[RA], kk[RA], ww[RA], vv[CA], dd[CA];
      load_vec(rr, in_s + t * N + i0);
      load_vec(kk, in_s + (kSave + t) * N + i0);
      load_vec(ww, in_s + (3 * kSave + t) * N + i0);
      load_vec(vv, in_s + (2 * kSave + t) * N + j0);
      load_vec(dd, in_s + (4 * kSave + t) * N + j0);
      float part[V2], col[CA];
#pragma unroll
      for (int c = 0; c < CA; ++c) col[c] = 0.f;
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        float sk = 0.f, sw = 0.f;
#pragma unroll
        for (int c = 0; c < CA; ++c) {
          sk = fmaf(G[a][c], vv[c], sk);
          sw = fmaf(G[a][c], hist[s][a][c], sw);
          col[c] = fmaf(G[a][c], kk[a], col[c]);
          G[a][c] = fmaf(ww[a], G[a][c], rr[a] * dd[c]);
        }
        part[a] = sk;
        part[RA + a] = sw;
      }
      Scatter<V2, TX>::run(part, lane);
      if (w2) {
        const int i = i0 + idx2 % RA;
        if (idx2 < RA)
          out_s[(kSave + t) * N + i] =
              fmaf(u2 * in_s[t * N + i], vd_s[t], part[0]);
        else
          out_s[(2 * kSave + t) * N + i] = part[0];
      }
      store_vec(cp_s + (s * TY + ty) * N + j0, col);
    }
    __syncthreads();                   // the column sums' parts are in
    for (int e = threadIdx.x; e < kSub * N; e += NT) {
      const int s = e / N, j = e % N, t = sb * kSub + s;
      if (t >= n) continue;
      float acc = 0.f;
#pragma unroll 8
      for (int y = 0; y < TY; ++y) acc += cp_s[(s * TY + y) * N + j];
      dv[base + (int64_t)(t0 + t) * row + j] =
          fmaf(bon_s[t], in_s[(4 * kSave + t) * N + j], acc);
    }
    __syncthreads();                   // cp_s is refilled next
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < RA; ++a) du_part[unit * N + i0 + a] = du[a];
  }
  for (int e = threadIdx.x; e < 3 * n * N; e += NT) {
    const int q = e / (n * N), t = (e / N) % n, j = e % N;
    float* dst = q == 0 ? dr : q == 1 ? dk : dw;
    dst[base + (int64_t)(t0 + t) * row + j] = out_s[(q * kSave + t) * N + j];
  }
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* dy, const float* dstate,
           const float* states, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dinit, float* gs, float* dec, float* du_part,
           int B, int S, int H, cudaStream_t stream) {
  constexpr int NT = block_threads<N>();
  constexpr int stretch = stretch_smem_bytes(N, Piece<N>::RA);
  static const int configured = (int)cudaFuncSetAttribute(
      wkv_bwd_stretch<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      stretch);
  if (configured != 0) return configured;
  const int n_save = (S + kSave - 1) / kSave;
  const int blocks = B * H * n_save;
  wkv_bwd_local<N><<<blocks, NT, local_smem_bytes(N), stream>>>(
      r, w, dy, gs, dec, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = (N * N + kPassThreads - 1) / kPassThreads;
  wkv_bwd_pass<<<B * H * per, kPassThreads, 0, stream>>>(gs, dec, dstate,
                                                         dinit, n_save, H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_stretch<N><<<blocks, NT, stretch, stream>>>(
      r, k, v, w, u, dy, states, gs, dr, dk, dv, dw, du_part, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_u = (int64_t)B * H * N;
  wkv_bwd_du<<<(int)((n_u + kPassThreads - 1) / kPassThreads), kPassThreads,
               0, stream>>>(du_part, du, n_u, n_save, H, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w, dy [B, S, H, N], u [B * H, N], dstate (or null: zeros)
// [B, H, N, N] and states [B, ceil(S / 16), H, N, N] (the forward's),
// all float32 and contiguous.  Writes dr, dk, dv, dw [B, S, H, N], du
// [B * H, N] and dinit [B, H, N, N], float32; gs [B, ceil(S / 16), H, N,
// N], dec and du_part [B, ceil(S / 16), H, N] float32 are scratch.  Four
// launches, on `stream`.  Returns a CUDA error code;
// cudaErrorInvalidValue for N outside {8, 16, 32, 64}, S < 1 or B H < 1.
int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* dy,
                   const void* dstate, const void* states, void* dr,
                   void* dk, void* dv, void* dw, void* du, void* dinit,
                   void* gs, void* dec, void* du_part, int B, int S, int H,
                   int N, void* stream) {
  if (S < 1 || B * H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define RWKV6_BWD_ARGS                                                      \
  (const float*)r, (const float*)k, (const float*)v, (const float*)w,       \
      (const float*)u, (const float*)dy, (const float*)dstate,              \
      (const float*)states, (float*)dr, (float*)dk, (float*)dv, (float*)dw, \
      (float*)du, (float*)dinit, (float*)gs, (float*)dec, (float*)du_part,  \
      B, S, H, st
  switch (N) {
    case 8: return launch<8>(RWKV6_BWD_ARGS);
    case 16: return launch<16>(RWKV6_BWD_ARGS);
    case 32: return launch<32>(RWKV6_BWD_ARGS);
    case 64: return launch<64>(RWKV6_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RWKV6_BWD_ARGS
}

// The dynamic shared memory of a block of kernel (3), the stretch walk,
// at state size N (0 for N outside {8, 16, 32, 64}).
int rwkv6_scan_bwd_smem_bytes(int N) {
  switch (N) {
    case 8: return stretch_smem_bytes(8, Piece<8>::RA);
    case 16: return stretch_smem_bytes(16, Piece<16>::RA);
    case 32: return stretch_smem_bytes(32, Piece<32>::RA);
    case 64: return stretch_smem_bytes(64, Piece<64>::RA);
    default: return 0;
  }
}

}  // extern "C"
