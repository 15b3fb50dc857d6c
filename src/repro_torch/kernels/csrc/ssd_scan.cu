// Mamba2 SSD chunked scan for Hopper (sm_90a): the within-chunk quadratic
// dual form and the across-chunk linear recurrence of arXiv:2405.21060 §6 in
// one kernel, with the P x N state kept in shared memory across chunks.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_chunked, body
// _ssd_kernel).  That kernel runs a grid (batch, head, chunk) with the chunk
// axis sequential, carries the state in VMEM scratch from one grid step to
// the next, and is fed head-major copies of x, dt, B and C with B and C
// repeated to every head (its wrapper's transpose and jnp.repeat).  Here:
//   * one CTA per (P-slice, head, batch row) loops over the chunks itself —
//     the loop takes the place of the sequential grid axis, since CTAs run
//     in no order.  y[:, p] and state[p, :] depend only on column p of x, so
//     P is cut into slices of at most 64 columns (the wrapper's Ps), with
//     no merge;
//   * x, dt, B and C are read in place in their (b, s, ...) layouts and
//     types (B and C by group, g = h / (H / G)) and widened to f32 when
//     staged: the wrapper copies nothing;
//   * exp(cum_i - cum_j) is computed only where j <= i — the Pallas kernel
//     evaluates it everywhere and masks afterwards, which overflows above
//     the diagonal.
// Per chunk of c positions (c <= 128), with cum the inclusive cumsum of
// dt * A over the chunk, the CTA stages B (c x N) and x * dt (c x Ps) in
// shared memory, then for each block of kSsdRows output rows i:
//   C rows of the block -> shared memory;
//   scores[i, j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, and
//   Y_off[i, p] = exp(cum_i) (C_i . state[p, :]) in one pass over N
//   (16 x 16 threads: a thread owns 4 rows x 8 keys of the scores and
//   4 rows x 4 columns of y, read as float4 from rows padded by 4 floats);
//   the scores replace the C rows in shared memory; y = Y_off + scores .
//   (x dt) is written to global memory as f32;
// then state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) (x dt)_j
// B_j^T.  The final state is written after the last chunk.
//
// Bound on the H100: f32 operations.  Per (row, head, chunk) the work is
// c (c + 1) (N + P) + 4 c N P flops (the two within-chunk products need
// only the c (c + 1) / 2 pairs j <= i) against reading x, dt, B, C and
// writing y (f32): at mamba2's shapes (c = 128, N = 128, P = 64, 80 heads)
// about 7.4 MFLOP against 48-65 KB of x, dt and y per (head, chunk) (B and
// C are shared by the heads of a group) — some 110-150 flops per byte, far
// above the CUDA cores' 20 (67 TFLOP/s over 3.35 TB/s).  At the SSM
// forward's 4 x 4096 tokens: 75.4 GFLOP, 1.13 ms at the f32 peak, against
// 527 MB (bf16 x, B, C; f32 y), 0.157 ms at the HBM rate.  So the
// design keeps every operand of the four products in shared memory (the
// state never leaves the CTA) and computes in f32 on CUDA cores with 4 x 8
// and 4 x 4 register tiles.  The c^2 terms run only up to the diagonal
// block.  One CTA per SM (168 KiB of shared memory at mamba2's
// shapes); at batch 1 the b * H = 80 CTAs leave SMs idle.  Tensor cores,
// asynchronous staging and one C.B^T per group rather than per head are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kSsdThreads = 256;  // 16 x 16: ty owns rows, tx keys / columns
constexpr int kSsdRows = 64;      // output rows of a block of the chunk
constexpr int kSsdMaxKeys = 128;  // largest chunk: 16 tx x 8 keys
constexpr int kSsdMaxState = 128; // largest N: 16 ty x 8 state rows

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ void fma4(float* acc, float s, const float4& v) {
  acc[0] += s * v.x;
  acc[1] += s * v.y;
  acc[2] += s * v.z;
  acc[3] += s * v.w;
}

// Floats of dynamic shared memory: B [c][N+4]; the block's C rows, then its
// scores [kSsdRows][max(N, c)+4]; x dt [c][Ps+4]; the state transposed
// [N][Ps+4]; cum [c]; the decay to the chunk's end [c].
__host__ __device__ inline int ssd_smem_floats(int c, int N, int ps) {
  const int wide = (N > c ? N : c) + 4;
  return c * (N + 4) + kSsdRows * wide + (c + N) * (ps + 4) + 2 * c;
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ state_out, int s, int H, int G, int P,
               int N, int c, int ps) {
  extern __shared__ __align__(16) float sm[];
  const int p0 = blockIdx.x * ps, h = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (H / G);
  const int nsd = N + 4, psd = ps + 4, wide = (N > c ? N : c) + 4;
  float* Bs = sm;                         // [c][nsd]
  float* CS = Bs + c * nsd;               // C rows [kSsdRows][nsd], then scores [kSsdRows][wide]
  float* xs = CS + kSsdRows * wide;       // x dt [c][psd]
  float* st = xs + c * psd;               // state^T [N][psd]
  float* cum = st + N * psd;              // [c]
  float* wdec = cum + c;                  // exp(cum_last - cum_j) [c]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool col = 4 * tx < ps;           // owns columns 4 tx .. 4 tx + 3
  const float a = A[h];
  const int n4 = N >> 2, p4 = ps >> 2;

  for (int e = tid; e < N * psd; e += kSsdThreads) st[e] = 0.f;

  for (int t0 = 0; t0 < s; t0 += c) {
    const long row0 = (long)bi * s + t0;  // token row of the chunk's start
    __syncthreads();                      // the last chunk's readers are done
    if (tid < 32) {                       // cum: one warp, 4 positions a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * tid + u;
        run += j < c ? dt[(row0 + j) * H + h] * a : 0.f;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * tid + u < c) cum[4 * tid + u] = incl - run + v[u];
    }
    for (int e = tid; e < c * n4; e += kSsdThreads) {
      const int j = e / n4, n = (e % n4) * 4;
      *reinterpret_cast<float4*>(Bs + j * nsd + n) =
          ld4(Bm + ((row0 + j) * G + grp) * N + n);
    }
    for (int e = tid; e < c * p4; e += kSsdThreads) {
      const int j = e / p4, p = (e % p4) * 4;
      const float d = dt[(row0 + j) * H + h];
      float4 v = ld4(x + ((row0 + j) * H + h) * P + p0 + p);
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      *reinterpret_cast<float4*>(xs + j * psd + p) = v;
    }
    __syncthreads();
    const float cl = cum[c - 1];
    for (int j = tid; j < c; j += kSsdThreads) wdec[j] = expf(cl - cum[j]);

    for (int i0 = 0; i0 < c; i0 += kSsdRows) {
      const int jend = min(c, i0 + kSsdRows);  // keys visible to the block
      __syncthreads();                         // the last block's scores are consumed
      for (int e = tid; e < kSsdRows * n4; e += kSsdThreads) {
        const int r = e / n4, n = (e % n4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i0 + r < c) v = ld4(Cm + ((row0 + i0 + r) * G + grp) * N + n);
        *reinterpret_cast<float4*>(CS + r * nsd + n) = v;
      }
      __syncthreads();

      // one pass over N: scores (rows ty + 16 a, keys tx + 16 k) and Y_off
      // (rows ty + 16 a, columns 4 tx ..)
      float sc[4][8], yo[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int k = 0; k < 8; ++k) sc[r][k] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) yo[r][q] = 0.f;
      }
      for (int n = 0; n < N; n += 4) {
        float4 cr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = ld4(CS + (ty + 16 * r) * nsd + n);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = tx + 16 * k;
          if (j < jend) {
            const float4 bv = ld4(Bs + j * nsd + n);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              sc[r][k] += cr[r].x * bv.x + cr[r].y * bv.y + cr[r].z * bv.z +
                          cr[r].w * bv.w;
            }
          }
        }
        if (col) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 sv = ld4(st + (n + u) * psd + 4 * tx);
#pragma unroll
            for (int r = 0; r < 4; ++r) fma4(yo[r], comp(cr[r], u), sv);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float ci = i < c ? cum[i] : 0.f;
        const float eo = i < c ? expf(ci) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) yo[r][q] *= eo;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = tx + 16 * k;
          float v = 0.f;
          if (i < c && j <= i) v = sc[r][k] * expf(ci - cum[j]);
          sc[r][k] = v;
        }
      }
      __syncthreads();                         // every C row is read
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = tx + 16 * k;
          if (j < jend) CS[(ty + 16 * r) * wide + j] = sc[r][k];
        }
      __syncthreads();

      if (col) {                               // y = Y_off + scores . (x dt)
        for (int j = 0; j < jend; j += 4) {
          float4 sr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sr[r] = ld4(CS + (ty + 16 * r) * wide + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 xv = ld4(xs + (j + u) * psd + 4 * tx);
#pragma unroll
            for (int r = 0; r < 4; ++r) fma4(yo[r], comp(sr[r], u), xv);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i < c)
            *reinterpret_cast<float4*>(y + ((row0 + i) * H + h) * P + p0 +
                                       4 * tx) =
                make_float4(yo[r][0], yo[r][1], yo[r][2], yo[r][3]);
        }
      }
    }

    // state <- exp(cum_last) state + sum_j wdec_j (x dt)_j B_j^T: a thread
    // owns state rows n = ty + 16 a and columns 4 tx ..; it reads and
    // writes only its own entries, and every reader of the old state (the
    // Y_off pass) finished before the last block's barriers
    if (col) {
      float acc[kSsdMaxState / 16][4];
#pragma unroll
      for (int r = 0; r < kSsdMaxState / 16; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int j = 0; j < c; ++j) {
        float4 xv = ld4(xs + j * psd + 4 * tx);
        const float w = wdec[j];
        xv.x *= w;
        xv.y *= w;
        xv.z *= w;
        xv.w *= w;
#pragma unroll
        for (int r = 0; r < kSsdMaxState / 16; ++r) {
          const int n = ty + 16 * r;
          if (n < N) fma4(acc[r], Bs[j * nsd + n], xv);
        }
      }
      const float dl = expf(cl);
#pragma unroll
      for (int r = 0; r < kSsdMaxState / 16; ++r) {
        const int n = ty + 16 * r;
        if (n < N) {
          float* sp = st + n * psd + 4 * tx;
          const float4 o = ld4(sp);
          *reinterpret_cast<float4*>(sp) =
              make_float4(o.x * dl + acc[r][0], o.y * dl + acc[r][1],
                          o.z * dl + acc[r][2], o.w * dl + acc[r][3]);
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < ps * N; e += kSsdThreads) {
    const int p = e / N, n = e % N;
    state_out[(((long)bi * H + h) * P + p0 + p) * N + n] = st[n * psd + p];
  }
}

template <typename T>
cudaError_t launch_ssd_t(const void* x, const float* dt, const float* A,
                         const void* B, const void* C, float* y, float* state,
                         int b, int s, int H, int P, int G, int N, int chunk,
                         int ps, cudaStream_t stream) {
  const int smem = 4 * ssd_smem_floats(chunk, N, ps);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / ps, H, b);
  ssd_kernel<T><<<grid, kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), y, state, s, H, G, P, N, chunk, ps);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_ssd(bool bf16, const void* x, const float* dt,
                       const float* A, const void* B, const void* C, float* y,
                       float* state, int b, int s, int H, int P, int G, int N,
                       int chunk, int ps, cudaStream_t stream) {
  static_assert(kSsdMaxKeys == 16 * 8 && kSsdMaxState == 16 * 8,
                "a thread holds 8 keys of the scores and 8 state rows");
  if (bf16)
    return launch_ssd_t<__nv_bfloat16>(x, dt, A, B, C, y, state, b, s, H, P,
                                       G, N, chunk, ps, stream);
  return launch_ssd_t<float>(x, dt, A, B, C, y, state, b, s, H, P, G, N, chunk,
                             ps, stream);
}

}  // namespace repro_torch
