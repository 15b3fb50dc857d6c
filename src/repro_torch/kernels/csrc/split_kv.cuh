// Split-KV attention (flash-decoding): the partial states of the CTAs that
// share one group of query rows, and their merge — shared by the split-KV
// decode body (decode_split.cuh: the paged decode of paged_attention.cu
// and the contiguous decode of decode_attention.cu) and the paged
// chunked-prefill kernel (paged_prefill.cu).
//
// A group is the query rows one CTA holds for one KV head: the g heads of a
// decode row, or a 64-row tile of a prefill chunk.  Each group gets n_split
// CTAs (from the host, from shapes alone) and cuts its own visible pages —
// read from its lengths or positions on the device — into n_split runs of
// at least min_pages pages.  A split that holds no visible key for the
// group is "empty": its CTA returns at once, and the group's live splits
// are 0 .. n_live - 1, which every CTA of the group computes alike.  A
// group with one live split writes its output directly.  Otherwise each
// live CTA stores its partial — acc[rows][dh] unnormalised, then m[rows]
// (the row max, in log2 units, -inf for a row that saw no key) and l[rows]
// — in f32 scratch, and the partials are merged:
//   O = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M),  M = max_s m_s,
// with weight exactly 0 for a partial whose m is -inf (a row that saw no
// key in that split), so a partial never reads as NaN.  Empty splits write
// nothing and are not read.
//   * Decode merges in the CTA that arrives last at its (row, KV head),
//     counted by an arrival counter that this CTA sets back to 0, so the
//     next launch needs no memset.  A decode partial is g x dh floats; the
//     prefill's merge kernel, launched as a programmatic dependent, made
//     every decode launch 1-3 us slower on the H100 (b = 8 f32 0.0470
//     against 0.0457 ms, b = 1 bf16 0.0168 against 0.0141: the dependent
//     grid waits for the whole main grid to finish).  Launches that may
//     overlap must not share counters: the wrapper keeps one buffer per
//     stream (kernels/_build.py counters), and a CUDA graph keeps the
//     buffer of the stream it was captured on, so two replays of one
//     graph must not overlap.
//   * Prefill merges in a second, small kernel launched by the same host
//     call (paged_prefill.cu): a tile's partial is 64 x dh floats (33 KB at
//     dh 128), and one CTA reading 16 of them serially took ~20 us on the
//     H100, a grid of 8-row CTAs a few.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "mma_tile.cuh"

namespace repro_torch {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A row's natural log-sum-exp of its scaled scores from its (m in log2
// units, l): m ln 2 + log l, -inf for a row that saw no key
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == -INFINITY ? -INFINITY : (m + log2f(l)) * kLn2;
}
constexpr int kMaxSplits = 32;   // splits per group (kernels/paged_attention.py)

// floats of one partial: acc[rows][dh], m[rows], l[rows] — a multiple of 4
// (every partial 16-byte aligned, as the merge's float4 reads need) when
// rows is even and dh % 4 == 0: the decode lays a group of odd g out as g +
// 1 rows (decode_split.cuh)
__host__ __device__ inline long partial_floats(int rows, int dh) {
  return (long)rows * (dh + 2);
}

// Every thread of the CTA calls this after storing its share of the
// partial.  True (in every thread) for the CTA that arrives last of the
// group's n_live; that CTA resets the counter.
__device__ __forceinline__ bool arrive_last(int* counter, int n_live,
                                            int* flag) {
  __threadfence();                 // the partial is visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == n_live - 1;
    if (last) atomicExch(counter, 0);
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();       // order the reads of the others' partials
  return last;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device.
template <auto kKernel>
inline cudaError_t ensure_smem(int bytes) {
  static unsigned done = 0;                // devices already raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

constexpr int kMergeBatch = 16;  // partials whose loads are issued together

// Merge rows [r0, r1) of the n_live partials at part + s *
// partial_floats(rows, dh), s < n_live (read past L1, which other SMs'
// stores do not update), into out: element (row r, dim d) at
// out[(r / g) * q_stride + (r % g) * dh + d], for rows r / g < nq.  smem:
// (3 n_live + 1) * (r1 - r0) floats.  dh % 4 == 0.  Every (split, row)'s m
// and l are loaded at once, and the acc loads of kMergeBatch partials are
// issued before any is used: the merge waits about 1 + n_live /
// kMergeBatch L2 round trips.  lse, when not null, takes row r's
// log-sum-exp (row_lse of the merged m and l) at lse[r - r0].
template <typename T>
__device__ void merge_partials(const float* part, int n_live, int rows,
                               int r0, int r1, int dh, T* out, long q_stride,
                               int g, int nq, float* smem,
                               float* lse = nullptr) {
  const long ps = partial_floats(rows, dh);
  const int nr = r1 - r0;
  float* sm_m = smem;                    // [n_live][nr]
  float* sm_l = sm_m + n_live * nr;      // [n_live][nr]
  float* w = sm_l + n_live * nr;         // [n_live][nr] weights 2^(m_s - M)
  float* linv = w + n_live * nr;         // [nr] 1 / sum_s l_s w_s
  for (int i = threadIdx.x; i < n_live * nr; i += blockDim.x) {
    const float* ml = part + (i / nr) * ps + (long)rows * dh + r0 + i % nr;
    sm_m[i] = __ldcg(ml);
    sm_l[i] = __ldcg(ml + rows);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float M = -INFINITY;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, sm_m[s * nr + r]);
    float L = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float m = sm_m[s * nr + r];
      const float c = m == -INFINITY ? 0.f : exp2f(m - M);
      w[s * nr + r] = c;
      L += c * sm_l[s * nr + r];
    }
    linv[r] = 1.f / fmaxf(L, 1e-30f);
    if (lse != nullptr) lse[r] = row_lse(M, L);
  }
  __syncthreads();
  const int d4 = dh / 4;
  for (int e = threadIdx.x; e < nr * d4; e += blockDim.x) {
    const int rr = e / d4, r = r0 + rr, d = (e % d4) * 4;
    if (r / g >= nq) continue;
    const float* src = part + (long)r * dh + d;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += kMergeBatch) {
      float c[kMergeBatch];
      float4 a[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        c[u] = s0 + u < n_live ? w[(s0 + u) * nr + rr] : 0.f;
        a[u] = c[u] != 0.f ? __ldcg(reinterpret_cast<const float4*>(
                                 src + (s0 + u) * ps))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        o.x += c[u] * a[u].x;
        o.y += c[u] * a[u].y;
        o.z += c[u] * a[u].z;
        o.w += c[u] * a[u].w;
      }
    }
    const float li = linv[rr];
    T* dst = out + (long)(r / g) * q_stride + (r % g) * dh + d;
    dst[0] = from_float<T>(o.x * li);
    dst[1] = from_float<T>(o.y * li);
    dst[2] = from_float<T>(o.z * li);
    dst[3] = from_float<T>(o.w * li);
  }
}

}  // namespace repro_torch
