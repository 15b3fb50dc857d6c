// The gradient of the contiguous flash attention (flash_attention.cu) for
// Hopper (sm_90a).  The reference has no Pallas backward: it trains through
// the jnp blocked_attention of src/repro/models/layers.py under
// jax.checkpoint, which XLA differentiates; this is the gradient of the
// function the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention) computes, in its contiguous form: q (b, sq, H, dh)
// against k, v (b, skv, K, dh), causal on positions from 0 or full, with the
// sliding window when window > 0, sq != skv allowed (cross-attention).
//
// Given the forward's output o and its per-row log-sum-exp lse (b, H, sq)
// f32 (natural units of the scaled scores; +inf for a row that sees no
// key), and the output's gradient dO:
//   (i)   delta = rowsum(dO o o) per (b, query, head), f32;
//   (ii)  dK / dV: one CTA per (64-key block, KV head, batch row); it walks
//         the g query heads of its KV head and the query blocks of 32 that
//         can see its keys (with causal from the block's first key on;
//         with a window up to the last key + window), recomputes P = exp(S
//         scale - lse), and takes dV += P^T dO, dP = dO V^T, dS = P o (dP -
//         delta), dK += dS^T q scale, summed over the group in registers in
//         f32 and written once: no atomics, so the gradient is the same from
//         run to run;
//   (iii) dQ: the forward's tiling — one CTA per (tile of 64 / g queries x
//         the g heads, KV head, batch row) over the same visible key
//         blocks — dQ = dS K scale.
// Every product runs on the CUDA cores in f32 (bf16 inputs are widened as
// they are staged): a simple kernel first; the tensor cores (mma.sync /
// wgmma, as the forward) are later work.
//
// Bound on the H100: operations.  The backward does 10 dh flops per visible
// (query head, key) pair (S, dP, dV, dK, dQ; this design recomputes S and
// dP a second time in the dQ kernel, 14 dh).  qwen3-1.7b's 16 heads of 128
// at 4 x 1024 tokens, causal: 33.6 M pairs, 43 GFLOP: 0.64 ms at the CUDA
// cores' f32 peak (67 TFLOP/s), 0.043 ms at the bf16 tensor-core peak;
// its bytes (q, k, v, o, dO read; dq, dk, dv written; 84 MB in f32) take
// 0.025 ms at 3.35 TB/s.
//
// Layout: K, V, q and dO tiles are staged in shared memory as f32, rows DP +
// 4 floats apart (DP the head dim padded to a multiple of 16 with zeros):
// a float4 read of 8 consecutive rows hits 8 distinct 4-bank groups.  Score
// work (S, dP) maps a thread to one key and a strided set of rows — its row
// reads are broadcasts within a warp; accumulation (dK, dV or dQ) maps four
// threads to a row of the accumulator, each holding DP / 4 of its columns.
#include <math.h>
#include <stdint.h>

#include "kernels.h"
#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kBwKeys = 64;       // keys a dK/dV CTA owns; keys a dQ block
constexpr int kBwQ = 32;          // queries a dK/dV step takes
constexpr int kBwRows = 64;       // rows (queries x group heads) a dQ CTA
constexpr int kBwThreads = 256;
constexpr int kLP = kBwKeys + 4;  // P / dS rows, floats
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// n rows of dh elements into f32 shared rows LD apart, zero-padded to DP:
// row r from src + src_row(r), or zeros where src_row(r) is -1
template <typename T, int DP, int LD, typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int n,
                                           int dh, RowFn src_row) {
  for (int e = threadIdx.x; e < n * DP; e += kBwThreads) {
    const int r = e / DP, c = e - r * DP;
    const long off = src_row(r);
    dst[r * LD + c] = off >= 0 && c < dh ? widen(src[off + c]) : 0.f;
  }
}

// (i) delta[b, h, i] = sum_d dO[b, i, h, d] o[b, i, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(kBwThreads)
    flash_bwd_delta_kernel(const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int sq, int H,
                           int dh) {
  const int row = blockIdx.x * (kBwThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long base = (long)row * dh;             // row = (bi * sq + i) * H + h
  float s = 0.f;
  for (int d = lane; d < dh; d += 32)
    s += widen(out[base + d]) * widen(dout[base + d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const int h = row % H, bi_i = row / H;
    const int bi = bi_i / sq, i = bi_i - bi * sq;
    delta[((long)bi * H + h) * sq + i] = s;
  }
}

// visible: key kp to query qi
__device__ __forceinline__ bool visible(int qi, int kp, int skv, int causal,
                                        int window) {
  return kp < skv && (!causal || kp <= qi) && (window <= 0 || qi - kp < window);
}

// (ii) dK, dV of 64 keys of one KV head
template <typename T, int DP>
__global__ void __launch_bounds__(kBwThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int sq, int skv, int H, int K,
                          int dh, int causal, int window, float sm_scale) {
  constexpr int LD = DP + 4, NI = DP / 16;
  extern __shared__ __align__(16) float bsm[];
  float* Ks = bsm;                          // [kBwKeys][LD]
  float* Vs = Ks + kBwKeys * LD;            // [kBwKeys][LD]
  float* Qs = Vs + kBwKeys * LD;            // [kBwQ][LD]
  float* Os = Qs + kBwQ * LD;               // dO [kBwQ][LD]
  float* Ps = Os + kBwQ * LD;               // [kBwQ][kLP]
  float* Ss = Ps + kBwQ * kLP;              // dS [kBwQ][kLP]
  float* Ls = Ss + kBwQ * kLP;              // lse, log2 units [kBwQ]
  float* Dl = Ls + kBwQ;                    // delta [kBwQ]
  const int kb0 = blockIdx.x * kBwKeys, kvh = blockIdx.y, bi = blockIdx.z;
  const int g = H / K, tid = threadIdx.x;
  stage_rows<T, DP, LD>(Ks, k, kBwKeys, dh, [&](int j) -> long {
    return kb0 + j < skv ? (((long)bi * skv + kb0 + j) * K + kvh) * dh : -1;
  });
  stage_rows<T, DP, LD>(Vs, v, kBwKeys, dh, [&](int j) -> long {
    return kb0 + j < skv ? (((long)bi * skv + kb0 + j) * K + kvh) * dh : -1;
  });
  // accumulation: key ja, columns ca + 16 i (4 each); scores: key jb, rows
  // rb0 + 4 i
  const int ja = tid >> 2, ca = (tid & 3) * 4;
  const int jb = tid & (kBwKeys - 1), rb0 = tid / kBwKeys;
  constexpr int NR = kBwQ * kBwKeys / kBwThreads;   // score rows a thread
  float dKa[NI][4], dVa[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) dKa[i][u] = dVa[i][u] = 0.f;
  // queries that see some key of the block
  const int kmax = min(kb0 + kBwKeys, skv) - 1;
  const int q_lo = causal ? kb0 : 0;
  const int q_hi = window > 0 ? min(sq, kmax + window) : sq;
  const float sl2 = sm_scale * kLog2e;
  const int kp = kb0 + jb;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int qb = q_lo; qb < q_hi; qb += kBwQ) {
      __syncthreads();                      // the last step's tiles are read
      auto qrow = [&](int r) -> long {
        return qb + r < q_hi ? (((long)bi * sq + qb + r) * H + h) * dh : -1;
      };
      stage_rows<T, DP, LD>(Qs, q, kBwQ, dh, qrow);
      stage_rows<T, DP, LD>(Os, dout, kBwQ, dh, qrow);
      if (tid < kBwQ) {
        const bool ok = qb + tid < q_hi;
        const long li = ((long)bi * H + h) * sq + qb + tid;
        Ls[tid] = ok ? lse[li] * kLog2e : INFINITY;
        Dl[tid] = ok ? delta[li] : 0.f;
      }
      __syncthreads();
      float s[NR], dp[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(Ks + jb * LD + d);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + jb * LD + d);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int r = rb0 + 4 * i;
          s[i] += dot4(*reinterpret_cast<const float4*>(Qs + r * LD + d), kk);
          dp[i] += dot4(*reinterpret_cast<const float4*>(Os + r * LD + d), vv);
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = rb0 + 4 * i, qi = qb + r;
        const bool ok = qi < q_hi && visible(qi, kp, skv, causal, window);
        const float p = ok ? exp2f(s[i] * sl2 - Ls[r]) : 0.f;
        Ps[r * kLP + jb] = p;
        Ss[r * kLP + jb] = p * (dp[i] - Dl[r]);
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kBwQ; ++r) {
        const float p = Ps[r * kLP + ja], ds = Ss[r * kLP + ja];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float4 oo =
              *reinterpret_cast<const float4*>(Os + r * LD + ca + 16 * i);
          const float4 qq =
              *reinterpret_cast<const float4*>(Qs + r * LD + ca + 16 * i);
          dVa[i][0] += p * oo.x;
          dVa[i][1] += p * oo.y;
          dVa[i][2] += p * oo.z;
          dVa[i][3] += p * oo.w;
          dKa[i][0] += ds * qq.x;
          dKa[i][1] += ds * qq.y;
          dKa[i][2] += ds * qq.z;
          dKa[i][3] += ds * qq.w;
        }
      }
    }
  }
  const int pos = kb0 + ja;
  if (pos >= skv) return;
  const long off = (((long)bi * skv + pos) * K + kvh) * dh;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = ca + 16 * i + u;
      if (d < dh) {
        dk[off + d] = from_float<T>(dKa[i][u] * sm_scale);
        dv[off + d] = from_float<T>(dVa[i][u]);
      }
    }
}

// (iii) dQ of one tile of 64 rows (tq queries x g heads of a KV head)
template <typename T, int DP>
__global__ void __launch_bounds__(kBwThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int skv, int H, int K, int dh, int tq,
                        int causal, int window, float sm_scale) {
  constexpr int LD = DP + 4, NI = DP / 16;
  extern __shared__ __align__(16) float bsm[];
  float* Qs = bsm;                          // [kBwRows][LD]
  float* Os = Qs + kBwRows * LD;            // dO [kBwRows][LD]
  float* Ks = Os + kBwRows * LD;            // [kBwKeys][LD]
  float* Vs = Ks + kBwKeys * LD;            // [kBwKeys][LD]
  float* Ss = Vs + kBwKeys * LD;            // dS [kBwRows][kLP]
  float* Ls = Ss + kBwRows * kLP;           // [kBwRows]
  float* Dl = Ls + kBwRows;                 // [kBwRows]
  const int g = H / K, rows = tq * g, tid = threadIdx.x;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * tq, kvh = blockIdx.y, bi = blockIdx.z;
  const int nq = min(tq, sq - q0);
  // row r: query q0 + r / g, head kvh * g + r % g
  auto qrow = [&](int r) -> long {
    return r < rows && r / g < nq
               ? (((long)bi * sq + q0 + r / g) * H + kvh * g + r % g) * dh
               : -1;
  };
  stage_rows<T, DP, LD>(Qs, q, kBwRows, dh, qrow);
  stage_rows<T, DP, LD>(Os, dout, kBwRows, dh, qrow);
  if (tid < kBwRows) {
    const bool ok = qrow(tid) >= 0;
    const long li = ((long)bi * H + kvh * g + tid % g) * sq + q0 + tid / g;
    Ls[tid] = ok ? lse[li] * kLog2e : INFINITY;
    Dl[tid] = ok ? delta[li] : 0.f;
  }
  const int ra = tid >> 2, ca = (tid & 3) * 4;
  const int jb = tid & (kBwKeys - 1), rb0 = tid / kBwKeys;
  constexpr int NR = kBwRows * kBwKeys / kBwThreads;
  int qp[NR];                               // query of each score row, -1 past
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rb0 + 4 * i;
    qp[i] = r < rows && r / g < nq ? q0 + r / g : -1;
  }
  float dQa[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) dQa[i][u] = 0.f;
  // visible key range of the tile, as the forward's
  const int kv_hi = causal ? min(skv, q0 + nq) : skv;
  const int kv_lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int kb_first = kv_lo / kBwKeys * kBwKeys;
  const float sl2 = sm_scale * kLog2e;

  for (int kb = kb_first; kb < kv_hi; kb += kBwKeys) {
    __syncthreads();                        // the last block's K is read
    auto krow = [&](int j) -> long {
      return kb + j < skv ? (((long)bi * skv + kb + j) * K + kvh) * dh : -1;
    };
    stage_rows<T, DP, LD>(Ks, k, kBwKeys, dh, krow);
    stage_rows<T, DP, LD>(Vs, v, kBwKeys, dh, krow);
    __syncthreads();
    float s[NR], dp[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + jb * LD + d);
      const float4 vv = *reinterpret_cast<const float4*>(Vs + jb * LD + d);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = rb0 + 4 * i;
        s[i] += dot4(*reinterpret_cast<const float4*>(Qs + r * LD + d), kk);
        dp[i] += dot4(*reinterpret_cast<const float4*>(Os + r * LD + d), vv);
      }
    }
    const int kp = kb + jb;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rb0 + 4 * i;
      const bool ok = qp[i] >= 0 && visible(qp[i], kp, skv, causal, window);
      const float p = ok ? exp2f(s[i] * sl2 - Ls[r]) : 0.f;
      Ss[r * kLP + jb] = p * (dp[i] - Dl[r]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBwKeys; ++j) {
      const float ds = Ss[ra * kLP + j];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float4 kk =
            *reinterpret_cast<const float4*>(Ks + j * LD + ca + 16 * i);
        dQa[i][0] += ds * kk.x;
        dQa[i][1] += ds * kk.y;
        dQa[i][2] += ds * kk.z;
        dQa[i][3] += ds * kk.w;
      }
    }
  }
  const long off = qrow(ra);
  if (off < 0) return;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = ca + 16 * i + u;
      if (d < dh) dq[off + d] = from_float<T>(dQa[i][u] * sm_scale);
    }
}

template <typename T, int DP>
cudaError_t launch_flash_bwd_typed(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int b, int sq, int skv, int H, int K,
                                   int dh, int tq, bool causal, int window,
                                   float sm_scale, cudaStream_t stream) {
  constexpr int LD = DP + 4;
  constexpr int smem_kv =
      ((2 * kBwKeys + 2 * kBwQ) * LD + 2 * kBwQ * kLP + 2 * kBwQ) * 4;
  constexpr int smem_q =
      ((2 * kBwRows + 2 * kBwKeys) * LD + kBwRows * kLP + 2 * kBwRows) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int rows = b * sq * H;
  flash_bwd_delta_kernel<T><<<(rows + kBwThreads / 32 - 1) / (kBwThreads / 32),
                              kBwThreads, 0, stream>>>(
      static_cast<const T*>(out), dop, delta, rows, sq, H, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int c = causal ? 1 : 0;
  flash_bwd_dkdv_kernel<T, DP>
      <<<dim3((skv + kBwKeys - 1) / kBwKeys, K, b), kBwThreads, smem_kv,
         stream>>>(qt, kt, vt, dop, lse, delta, static_cast<T*>(dk),
                   static_cast<T*>(dv), sq, skv, H, K, dh, c, window,
                   sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DP>
      <<<dim3((sq + tq - 1) / tq, K, b), kBwThreads, smem_q, stream>>>(
          qt, kt, vt, dop, lse, delta, static_cast<T*>(dq), sq, skv, H, K, dh,
          tq, c, window, sm_scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_flash_bwd_dp(const void* q, const void* k, const void* v,
                                const void* out, const void* dout,
                                const float* lse, float* delta, void* dq,
                                void* dk, void* dv, int b, int sq, int skv,
                                int H, int K, int dh, int tq, bool causal,
                                int window, float sm_scale,
                                cudaStream_t stream) {
  // the head dim padded to a multiple of 16
#define REPRO_FLASH_BWD(DP)                                                  \
  case DP / 16:                                                              \
    return launch_flash_bwd_typed<T, DP>(q, k, v, out, dout, lse, delta, dq, \
                                         dk, dv, b, sq, skv, H, K, dh, tq,   \
                                         causal, window, sm_scale, stream);
  switch ((dh + 15) / 16) {
    REPRO_FLASH_BWD(16)
    REPRO_FLASH_BWD(32)
    REPRO_FLASH_BWD(48)
    REPRO_FLASH_BWD(64)
    REPRO_FLASH_BWD(80)
    REPRO_FLASH_BWD(96)
    REPRO_FLASH_BWD(112)
    REPRO_FLASH_BWD(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD
}

cudaError_t launch_flash_bwd(bool bf16, const void* q, const void* k,
                             const void* v, const void* out, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int b, int sq, int skv, int H,
                             int K, int dh, int tq, bool causal, int window,
                             float sm_scale, cudaStream_t stream) {
  if (bf16)
    return launch_flash_bwd_dp<__nv_bfloat16>(q, k, v, out, dout, lse, delta,
                                              dq, dk, dv, b, sq, skv, H, K,
                                              dh, tq, causal, window,
                                              sm_scale, stream);
  return launch_flash_bwd_dp<float>(q, k, v, out, dout, lse, delta, dq, dk,
                                    dv, b, sq, skv, H, K, dh, tq, causal,
                                    window, sm_scale, stream);
}

}  // namespace repro_torch
