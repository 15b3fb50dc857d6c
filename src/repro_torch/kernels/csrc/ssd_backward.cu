// The gradient of the Mamba2 SSD chunked scan (ssd_scan.cu) for Hopper
// (sm_90a).  The reference has no Pallas backward: it trains through the
// jnp ssd_ref of src/repro/models/ssm.py, which XLA differentiates; this is
// the gradient of the function the TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_chunked) computes, from a zero initial state.
//
// Per batch row, head h and chunk of c positions, with a = dt A, cum its
// inclusive cumsum within the chunk, X = dt x, B and C of h's group, L_ij =
// exp(cum_i - cum_j) for j <= i, S = C B^T, w_j = exp(cum_last - cum_j),
// h0 the state entering the chunk (the forward's optional output) and dh1
// the cotangent of the state leaving it, three kernels:
//   (K2) the reverse state pass: one CTA per (P-slice, head, batch row)
//        walks the chunks from last to first, carrying dh in f32 registers:
//        it writes each chunk's dh1, then dh <- exp(cum_last) dh +
//        sum_i exp(cum_i) dy_i C_i^T.  The last chunk's dh1 is the final
//        state's cotangent (zero when the caller drops the state).
//   (K3) the chunk-parallel pass: one CTA per (chunk, head, batch row), all
//        of P.  M = L o (dy X^T) goes to shared memory; then, per 32-column
//        tile of N: S += C B^T (in registers), dC = M B + exp(cum) (dy h0),
//        dB = M^T C + w (X dh1), written as per-head partials, and dh1 B
//        (for dX) and <dh1, h0> accumulate.  R = S o M gives dcum =
//        rowsum(R) - colsum(R) + o - r (o_i = exp(cum_i) dy_i . h0 C_i, r_j =
//        w_j X_j^T dh1 B_j), the last position also taking exp(cum_last)
//        <dh1, h0> + sum r; M's buffer then takes S o L, and dX = (S o L)^T
//        dy + w (dh1 B).  One thread takes da, dcum's reverse cumsum, into
//        ddt = x . dX + A da and the chunk's partial of dA = sum dt da.
//   (K4) a fixed-order sum of the per-head partials of dB and dC over each
//        group's heads (B's type) and of the dA partials.
// Every sum runs in a fixed order (serial loops, shuffles of fixed
// pattern): no atomics, so the gradient is the same from run to run.
//
// Every product runs on the CUDA cores in f32 (bf16 inputs are widened as
// they are staged): a simple kernel first; the tensor cores, as the
// forward's mma.sync, are later work.  The c x c products run on whole
// 128 x 128 squares, not the triangle.  The chunk's cumsum of dt A and the
// differences cum_i - cum_j that go into exp are f64 (chunk_decays).
//
// Bound on the H100: operations.  A (head, chunk) needs c(c+1)/2 (2P + 3N)
// multiply-adds for the within-chunk products (dy X^T, S, dC, dB, dX) and
// 4 c P N for the state ones (K2's dy C^T, dy h0, X dh1, dh1 B): mamba2's
// 80 heads of 64, N 128, c 128 at 4 x 1024 tokens are 43 GFLOP, 0.64 ms at
// the CUDA cores' f32 peak (67 TFLOP/s) and 0.044 ms at the bf16 tensor
// cores'; the bytes (x, B, C, dt, A, dy, the chunk states read; dx, ddt,
// dA, dB, dC written: 347 MB in f32) take 0.10 ms at 3.35 TB/s.
//
// Shared memory of K3 (f32, fixed at the limits c <= 128, P <= 64): x and
// dy [128][65], M / R / S o L [128][129], the B, C, h0 and dh1 tiles
// [..][33], cum in f64 and seven f32 vectors of 128: 189 KB, one CTA an
// SM.  Rows 1 float
// longer than a power of two: 16 threads reading 16 rows hit 16 banks.
// Threads form a 16 x 16 grid (ty, tx); a thread owns rows ty + 16 a and
// columns tx + 16 b of an output, so a row's columns lie in one half-warp
// and its sums over them are shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kSbThreads = 256;
constexpr int kSbMaxC = 128;       // chunk
constexpr int kSbMaxP = 64;        // head dim (all of it in one K3 CTA)
constexpr int kSbMaxN = 128;       // state width
constexpr int kSbNT = 32;          // state columns a K3 tile
constexpr int kLP = kSbMaxP + 1;   // row strides (floats): x, dy
constexpr int kLC = kSbMaxC + 1;   // the c x c matrix
constexpr int kLT = kSbNT + 1;     // the N tiles
constexpr int kLN = kSbMaxN;       // K2's C rows (read along the row)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// sum over the 16 lanes of a half-warp (tx), in a fixed pattern
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Warp 0: the chunk's cum (inclusive cumsum of dts * a, 4 positions a
// lane) in f64, exp(cum) and w = exp(cum_last - cum), zero at and past c.
// The sum and the differences that go into exp are f64: |cum| reaches
// hundreds over a chunk, and exp turns an f32 rounding of it into a
// relative error of the gradient of that size times 2^-24.
__device__ __forceinline__ void chunk_decays(const float* dts, float a, int c,
                                             double* cum, float* ecum,
                                             float* wdec, int lane) {
  double v[4], run = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    run += 4 * lane + u < c ? (double)(dts[4 * lane + u] * a) : 0.0;
    v[u] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const double cl = __shfl_sync(0xffffffffu, incl, 31);  // cum[c - 1]
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = 4 * lane + u;
    const double cj = incl - run + v[u];
    cum[j] = cj;
    ecum[j] = j < c ? expf((float)cj) : 0.f;
    wdec[j] = j < c ? expf((float)(cl - cj)) : 0.f;
  }
}

// L_ij = exp(cum_i - cum_j), the difference taken in f64
__device__ __forceinline__ float decay(const double* cum, int i, int j) {
  return expf((float)(cum[i] - cum[j]));
}

// (K2) the reverse state pass.  dy (b, s, H, P) f32; dstate (b, H, P, N)
// f32 or null; dh1 (b, nc, H, P, N) f32.
template <typename T>
__global__ void __launch_bounds__(kSbThreads)
    ssd_bwd_state_kernel(const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ dstate,
                         float* __restrict__ dh1, int s, int H, int G, int P,
                         int N, int c, int ps) {
  extern __shared__ __align__(16) float sm2[];
  double* cum = reinterpret_cast<double*>(sm2);   // [128]
  float* dys = sm2 + 2 * kSbMaxC;            // exp(cum_i) dy [128][kLP]
  float* Cs = dys + kSbMaxC * kLP;           // [128][kLN]
  float* dts = Cs + kSbMaxC * kLN;           // [128] each
  float* ecum = dts + kSbMaxC;
  float* wdec = ecum + kSbMaxC;

  const int p0 = blockIdx.x * ps, h = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (H / G), nc = s / c;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a = A[h];
  // rows p = ty + 16 i (of the slice), columns n = tx + 16 j
  float dh[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = ty + 16 * i, n = tx + 16 * j;
      dh[i][j] = dstate != nullptr && p < ps && n < N
                     ? dstate[(((long)bi * H + h) * P + p0 + p) * N + n]
                     : 0.f;
    }
  for (int k = nc - 1;; --k) {
    const long base = (((long)bi * nc + k) * H + h) * P + p0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        if (p < ps && n < N) dh1[(base + p) * N + n] = dh[i][j];
      }
    if (k == 0) break;
    const long row0 = (long)bi * s + (long)k * c;
    __syncthreads();                         // the last chunk's readers
    for (int i = tid; i < kSbMaxC; i += kSbThreads)
      dts[i] = i < c ? dt[(row0 + i) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_decays(dts, a, c, cum, ecum, wdec, tid);
    __syncthreads();
    for (int e = tid; e < c * ps; e += kSbThreads) {
      const int i = e / ps, p = e - i * ps;
      dys[i * kLP + p] = ecum[i] * dy[((row0 + i) * H + h) * P + p0 + p];
    }
    const T* Cg = Cm + row0 * G * N + grp * N;
    for (int e = tid; e < c * N; e += kSbThreads) {
      const int i = e / N, n = e - i * N;
      Cs[i * kLN + n] = widen(Cg[(long)i * G * N + n]);
    }
    __syncthreads();
    const float ec = ecum[c - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dh[i][j] *= ec;
    for (int t = 0; t < c; ++t) {
      float u[4], v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        u[i] = p < ps ? dys[t * kLP + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        v[j] = n < N ? Cs[t * kLN + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dh[i][j] = fmaf(u[i], v[j], dh[i][j]);
    }
  }
}

__host__ __device__ constexpr int chunk_smem_floats() {
  return 2 * kSbMaxC + 2 * kSbMaxC * kLP + kSbMaxC * kLC +
         2 * kSbMaxC * kLT + 2 * kSbMaxP * kLT + 7 * kSbMaxC + kSbThreads;
}

// (K3) the chunk-parallel pass.  states, dh1 (b, nc, H, P, N) f32; dy (b,
// s, H, P) f32; dx (b, s, H, P) in x's type; ddt (b, s, H) f32; dA_part
// (b, nc, H) f32; dB_part, dC_part (b, s, H, N) f32.
template <typename T>
__global__ void __launch_bounds__(kSbThreads, 1)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm,
                         const float* __restrict__ states,
                         const float* __restrict__ dy,
                         const float* __restrict__ dh1, T* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ dA_part,
                         float* __restrict__ dB_part,
                         float* __restrict__ dC_part, int s, int H, int G,
                         int P, int N, int c) {
  extern __shared__ __align__(16) float sm3[];
  double* cum = reinterpret_cast<double*>(sm3);   // [128]
  float* xs = sm3 + 2 * kSbMaxC;             // x [128][kLP]
  float* dys = xs + kSbMaxC * kLP;           // dy [128][kLP]
  float* Mb = dys + kSbMaxC * kLP;           // M, then R, then S o L [128][kLC]
  float* Bt = Mb + kSbMaxC * kLC;            // [128][kLT]
  float* Ct = Bt + kSbMaxC * kLT;            // [128][kLT]
  float* h0t = Ct + kSbMaxC * kLT;           // [64][kLT]
  float* dh1t = h0t + kSbMaxP * kLT;         // [64][kLT]
  float* dts = dh1t + kSbMaxP * kLT;         // [128] each
  float* ecum = dts + kSbMaxC;
  float* wdec = ecum + kSbMaxC;
  float* o = wdec + kSbMaxC;
  float* r = o + kSbMaxC;
  float* dcum = r + kSbMaxC;
  float* sxd = dcum + kSbMaxC;               // x . dX a row
  float* red = sxd + kSbMaxC;                // [kSbThreads]

  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.x, grp = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a = A[h];
  const long row0 = (long)bi * s + (long)k * c;   // the chunk's first token
  const long sbase = (((long)bi * nc + k) * H + h) * P * N;
  const long tok_bc = (long)G * N;

  for (int i = tid; i < kSbMaxC; i += kSbThreads) {
    dts[i] = i < c ? dt[(row0 + i) * H + h] : 0.f;
    o[i] = 0.f;
    r[i] = 0.f;
  }
  for (int e = tid; e < kSbMaxC * P; e += kSbThreads) {
    const int i = e / P, p = e - i * P;
    const long g = ((row0 + i) * H + h) * P + p;
    xs[i * kLP + p] = i < c ? widen(x[g]) : 0.f;
    dys[i * kLP + p] = i < c ? dy[g] : 0.f;
  }
  __syncthreads();
  if (tid < 32) chunk_decays(dts, a, c, cum, ecum, wdec, tid);
  __syncthreads();

  // M_ij = L_ij dt_j (dy_i . x_j): rows i = ty + 16 u, columns j = tx + 16 v
  {
    float acc[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
    for (int p = 0; p < P; ++p) {
      float dv[8], xv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) dv[u] = dys[(ty + 16 * u) * kLP + p];
#pragma unroll
      for (int v = 0; v < 8; ++v) xv[v] = xs[(tx + 16 * v) * kLP + p];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(dv[u], xv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int i = ty + 16 * u, j = tx + 16 * v;
        Mb[i * kLC + j] =
            i < c && j <= i ? decay(cum, i, j) * dts[j] * acc[u][v] : 0.f;
      }
  }

  float S[8][8];        // S_ij, rows i = ty + 16 u, columns j = tx + 16 v
  float hB[8][4];       // (dh1 B)_jp, rows j = ty + 16 u, columns p = tx + 16 v
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int v = 0; v < 8; ++v) S[u][v] = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) hB[u][v] = 0.f;
  }
  float hh = 0.f;       // the thread's share of <dh1, h0>
  for (int n0 = 0; n0 < N; n0 += kSbNT) {
    __syncthreads();                         // M written; last tile's readers
    for (int e = tid; e < kSbMaxC * kSbNT; e += kSbThreads) {
      const int i = e / kSbNT, n = e - i * kSbNT;
      const bool ok = i < c && n0 + n < N;
      const long g = (row0 + i) * tok_bc + grp * N + n0 + n;
      Bt[i * kLT + n] = ok ? widen(Bm[g]) : 0.f;
      Ct[i * kLT + n] = ok ? widen(Cm[g]) : 0.f;
    }
    for (int e = tid; e < kSbMaxP * kSbNT; e += kSbThreads) {
      const int p = e / kSbNT, n = e - p * kSbNT;
      const bool ok = p < P && n0 + n < N;
      const long g = sbase + (long)p * N + n0 + n;
      h0t[p * kLT + n] = ok ? states[g] : 0.f;
      dh1t[p * kLT + n] = ok ? dh1[g] : 0.f;
    }
    __syncthreads();

    // S += C B^T; dh1 B; <dh1, h0>
    for (int n = 0; n < kSbNT; ++n) {
      float cv[8], bv[8], bj[8], hv[4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        cv[u] = Ct[(ty + 16 * u) * kLT + n];
        bj[u] = Bt[(ty + 16 * u) * kLT + n];
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) bv[v] = Bt[(tx + 16 * v) * kLT + n];
#pragma unroll
      for (int v = 0; v < 4; ++v) hv[v] = dh1t[(tx + 16 * v) * kLT + n];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int v = 0; v < 8; ++v) S[u][v] = fmaf(cv[u], bv[v], S[u][v]);
#pragma unroll
        for (int v = 0; v < 4; ++v) hB[u][v] = fmaf(bj[u], hv[v], hB[u][v]);
      }
    }
    for (int e = tid; e < kSbMaxP * kSbNT; e += kSbThreads) {
      const int p = e / kSbNT, n = e - p * kSbNT;
      hh = fmaf(h0t[p * kLT + n], dh1t[p * kLT + n], hh);
    }

    // dC = M B + exp(cum) (dy h0) and o: rows i = ty + 16 u, columns n =
    // tx + 16 v of the tile
    {
      float mb[8][2], yh[8][2];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) mb[u][v] = yh[u][v] = 0.f;
      for (int j = 0; j < c; ++j) {
        float mv[8], bv[2];
#pragma unroll
        for (int u = 0; u < 8; ++u) mv[u] = Mb[(ty + 16 * u) * kLC + j];
#pragma unroll
        for (int v = 0; v < 2; ++v) bv[v] = Bt[j * kLT + tx + 16 * v];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) mb[u][v] = fmaf(mv[u], bv[v], mb[u][v]);
      }
      for (int p = 0; p < P; ++p) {
        float dv[8], hv[2];
#pragma unroll
        for (int u = 0; u < 8; ++u) dv[u] = dys[(ty + 16 * u) * kLP + p];
#pragma unroll
        for (int v = 0; v < 2; ++v) hv[v] = h0t[p * kLT + tx + 16 * v];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) yh[u][v] = fmaf(dv[u], hv[v], yh[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = ty + 16 * u;
        const float ei = ecum[i];
        float oi = 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int n = tx + 16 * v;
          const float off = ei * yh[u][v];
          if (i < c && n0 + n < N)
            dC_part[((row0 + i) * H + h) * N + n0 + n] = mb[u][v] + off;
          oi = fmaf(off, Ct[i * kLT + n], oi);
        }
        oi = half_warp_sum(oi);
        if (tx == 0 && i < c) o[i] += oi;
      }
    }

    // dB = M^T C + w dt (x dh1) and r: rows j = ty + 16 u, columns n
    {
      float mc[8][2], xh[8][2];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) mc[u][v] = xh[u][v] = 0.f;
      for (int i = 0; i < c; ++i) {
        float mv[8], cv[2];
#pragma unroll
        for (int u = 0; u < 8; ++u) mv[u] = Mb[i * kLC + ty + 16 * u];
#pragma unroll
        for (int v = 0; v < 2; ++v) cv[v] = Ct[i * kLT + tx + 16 * v];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) mc[u][v] = fmaf(mv[u], cv[v], mc[u][v]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[8], hv[2];
#pragma unroll
        for (int u = 0; u < 8; ++u) xv[u] = xs[(ty + 16 * u) * kLP + p];
#pragma unroll
        for (int v = 0; v < 2; ++v) hv[v] = dh1t[p * kLT + tx + 16 * v];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) xh[u][v] = fmaf(xv[u], hv[v], xh[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = ty + 16 * u;
        const float wj = wdec[j] * dts[j];
        float rj = 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int n = tx + 16 * v;
          const float off = wj * xh[u][v];
          if (j < c && n0 + n < N)
            dB_part[((row0 + j) * H + h) * N + n0 + n] = mc[u][v] + off;
          rj = fmaf(off, Bt[j * kLT + n], rj);
        }
        rj = half_warp_sum(rj);
        if (tx == 0 && j < c) r[j] += rj;
      }
    }
  }
  __syncthreads();                           // every reader of M; o and r

  // R = S o M in place; dcum from its row and column sums
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int i = ty + 16 * u, j = tx + 16 * v;
      Mb[i * kLC + j] *= S[u][v];
    }
  red[tid] = hh;
  __syncthreads();
  if (tid < c) {
    float rs = 0.f, cs = 0.f;
    for (int j = 0; j < c; ++j) rs += Mb[tid * kLC + j];
    for (int i = 0; i < c; ++i) cs += Mb[i * kLC + tid];
    dcum[tid] = rs - cs + o[tid] - r[tid];
  }
  __syncthreads();                           // every reader of R
  // S o L in M's place
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int i = ty + 16 * u, j = tx + 16 * v;
      Mb[i * kLC + j] = i < c && j <= i ? S[u][v] * decay(cum, i, j) : 0.f;
    }
  if (tid == 0) {
    float t = 0.f, rsum = 0.f;
    for (int e = 0; e < kSbThreads; ++e) t += red[e];
    for (int j = 0; j < c; ++j) rsum += r[j];
    dcum[c - 1] += ecum[c - 1] * t + rsum;
  }
  __syncthreads();

  // dX = (S o L)^T dy + w (dh1 B): rows j = ty + 16 u, columns p = tx + 16 v;
  // dx = dt dX, and x . dX a row
  {
    float acc[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int i = 0; i < c; ++i) {
      float qv[8], dv[4];
#pragma unroll
      for (int u = 0; u < 8; ++u) qv[u] = Mb[i * kLC + ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) dv[v] = dys[i * kLP + tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(qv[u], dv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = ty + 16 * u;
      float sx = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p = tx + 16 * v;
        const float dX = acc[u][v] + wdec[j] * hB[u][v];
        if (j < c && p < P) {
          put(dx + ((row0 + j) * H + h) * P + p, dts[j] * dX);
          sx = fmaf(xs[j * kLP + p], dX, sx);
        }
      }
      sx = half_warp_sum(sx);
      if (tx == 0 && j < c) sxd[j] = sx;
    }
  }
  __syncthreads();

  // da = the reverse cumsum of dcum; ddt = x . dX + A da; dA's partial
  if (tid == 0) {
    float run = 0.f, da_dt = 0.f;
    for (int i = c - 1; i >= 0; --i) {
      run += dcum[i];
      ddt[(row0 + i) * H + h] = sxd[i] + a * run;
      da_dt = fmaf(dts[i], run, da_dt);
    }
    dA_part[((long)bi * nc + k) * H + h] = da_dt;
  }
}

// (K4) dB, dC (b, s, G, N) in B's type: the per-head partials summed over
// each group's heads in order; dA (H,): the (b, nc) partials in order.
template <typename T>
__global__ void __launch_bounds__(kSbThreads)
    ssd_bwd_sum_kernel(const float* __restrict__ dB_part,
                       const float* __restrict__ dC_part,
                       const float* __restrict__ dA_part, T* __restrict__ dB,
                       T* __restrict__ dC, float* __restrict__ dA, long n_bc,
                       int H, int G, int N, int n_part_rows) {
  const long e = (long)blockIdx.x * kSbThreads + threadIdx.x;
  if (e < n_bc) {
    const int n = (int)(e % N), g = (int)((e / N) % G);
    const long tok = e / ((long)N * G);
    const int hpg = H / G;
    float sb = 0.f, sc = 0.f;
    for (int u = 0; u < hpg; ++u) {
      const long off = (tok * H + g * hpg + u) * N + n;
      sb += dB_part[off];
      sc += dC_part[off];
    }
    put(dB + e, sb);
    put(dC + e, sc);
  } else if (e < n_bc + H) {
    const int h = (int)(e - n_bc);
    float t = 0.f;
    for (int q = 0; q < n_part_rows; ++q) t += dA_part[(long)q * H + h];
    dA[h] = t;
  }
}

template <typename T>
cudaError_t launch_ssd_bwd_t(const void* x, const float* dt, const float* A,
                             const void* B, const void* C,
                             const float* states, const float* dy,
                             const float* dstate, float* dh1, void* dx,
                             float* ddt, float* dA_part, float* dB_part,
                             float* dC_part, float* dA, void* dB, void* dC,
                             int b, int s, int H, int P, int G, int N,
                             int chunk, int ps, cudaStream_t stream) {
  const int nc = s / chunk;
  const int smem2 = (2 * kSbMaxC + kSbMaxC * kLP + kSbMaxC * kLN +
                     3 * kSbMaxC) * 4;
  const int smem3 = chunk_smem_floats() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem2);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3);
  if (err != cudaSuccess) return err;
  const T* Ct = static_cast<const T*>(C);
  ssd_bwd_state_kernel<T><<<dim3(P / ps, H, b), kSbThreads, smem2, stream>>>(
      dt, A, Ct, dy, dstate, dh1, s, H, G, P, N, chunk, ps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T><<<dim3(nc, H, b), kSbThreads, smem3, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), Ct, states,
      dy, dh1, static_cast<T*>(dx), ddt, dA_part, dB_part, dC_part, s, H, G,
      P, N, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n_bc = (long)b * s * G * N;
  const long blocks = (n_bc + H + kSbThreads - 1) / kSbThreads;
  ssd_bwd_sum_kernel<T><<<(unsigned)blocks, kSbThreads, 0, stream>>>(
      dB_part, dC_part, dA_part, static_cast<T*>(dB), static_cast<T*>(dC),
      dA, n_bc, H, G, N, b * nc);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_ssd_bwd(bool bf16, const void* x, const float* dt,
                           const float* A, const void* B, const void* C,
                           const float* states, const float* dy,
                           const float* dstate, float* dh1, void* dx,
                           float* ddt, float* dA_part, float* dB_part,
                           float* dC_part, float* dA, void* dB, void* dC,
                           int b, int s, int H, int P, int G, int N,
                           int chunk, int ps, cudaStream_t stream) {
  if (chunk > kSbMaxC || P > kSbMaxP || N > kSbMaxN || ps > kSbMaxP)
    return cudaErrorInvalidValue;
  if (bf16)
    return launch_ssd_bwd_t<__nv_bfloat16>(
        x, dt, A, B, C, states, dy, dstate, dh1, dx, ddt, dA_part, dB_part,
        dC_part, dA, dB, dC, b, s, H, P, G, N, chunk, ps, stream);
  return launch_ssd_bwd_t<float>(x, dt, A, B, C, states, dy, dstate, dh1, dx,
                                 ddt, dA_part, dB_part, dC_part, dA, dB, dC, b,
                                 s, H, P, G, N, chunk, ps, stream);
}

}  // namespace repro_torch
