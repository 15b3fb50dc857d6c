// Online-softmax attention of the g query heads of one new token against
// the K/V of one KV head in a contiguous per-row cache — the device
// routine of the contiguous decode kernel (decode_attention.cu), with the
// small helpers the split-KV kernels share (split_kv.cuh).
//
// The row's (S, K, dh) cache is read as pages of bs positions at
// row_base + page * bs * K * dh; the last page may be ragged.  The CTA's
// warps split the pages between them — warp w takes pages w, w + kWarps,
// ... up to the page that holds the query's position, so pages past the
// valid prefix are never loaded — and run without a barrier:
//   * a lane holds dims lane, lane + 32, ... of each head's q and of its
//     f32 accumulator, so every K or V row is one coalesced warp load;
//   * positions go four at a time: the warp loads their K and V rows (none
//     at or past n_pos), each head's four scores q·k * sm_scale are summed
//     across the warp with shuffles, masked to -inf past the query's
//     position, and folded into that head's online softmax state (m, l,
//     acc) with one rescale per group;
// then the warps' states meet in shared memory and are merged as
// flash-decode partials: O = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int kWarps = 8;              // warps per CTA, splitting the pages
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 8;            // query heads of a KV group
constexpr int kMaxDimsPerLane = 4;     // dh <= 128
constexpr int kGroup = 4;              // positions per online-softmax update

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Bytes of dynamic shared memory of a CTA: the warps' partial states
// (acc, m, l per head) plus the query's int position.
__host__ __device__ inline int tile_smem_bytes(int g, int dh) {
  return 4 * kWarps * g * (dh + 2) + 4;
}

// q / out: head h's row at [h * dh + d] (q_stride: the distance between
// two tokens' rows, H * dh).  qpos: shared int, the query's absolute
// position (-1: nothing visible, the output is zero), visible to every
// thread (the caller synchronised after writing it).  k_cache / v_cache:
// the cache; row_base: the element offset of this row's (S, K, dh);
// n_pos = S positions, none at or past it is loaded.
template <typename T>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            long q_stride, int g, int dh, const int* qpos,
                            const T* __restrict__ k_cache,
                            const T* __restrict__ v_cache, int bs, int K,
                            int kvh, long row_base, int n_pos,
                            float sm_scale, float* smem) {
  // The rows are indexed as a tile of tq = 1 query x g heads (row r: query
  // r / g, head r % g, live while the query is < nq).  Folded by hand to
  // one query (q[r * dh], every r < g live) the kernel ran 1.3x (f32) to
  // 1.9x (bf16) slower on the H100: nvcc schedules the position loop
  // differently.
  constexpr int tq = 1, nq = 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = tq * g;

  float qr[kMaxRows][kMaxDimsPerLane], acc[kMaxRows][kMaxDimsPerLane];
  float m[kMaxRows], l[kMaxRows];
  int rpos[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const int i = r / g, h = r % g;
    const bool live = r < rows && i < nq;
    rpos[r] = live ? qpos[i] : -1;        // -1: every position masked
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDimsPerLane; ++j) {
      const int d = lane + 32 * j;
      qr[r][j] = live && d < dh ? to_float(q[(long)i * q_stride + h * dh + d])
                                : 0.f;
      acc[r][j] = 0.f;
    }
  }

  // pages up to the one that holds the query's position (the page-skip)
  const int hi = qpos[0];
  const int last = hi < 0 ? -1 : min(hi, n_pos - 1) / bs;
  const long pos_stride = (long)K * dh;    // between positions of a page

  for (int p = warp; p <= last; p += kWarps) {
    const long base = row_base + ((long)p * bs * K + kvh) * dh;
    for (int t0 = 0; t0 < bs; t0 += kGroup) {
      float kx[kGroup][kMaxDimsPerLane], vx[kGroup][kMaxDimsPerLane];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool held = p * bs + t0 + u < n_pos;
#pragma unroll
        for (int j = 0; j < kMaxDimsPerLane; ++j) {
          const int d = lane + 32 * j;
          const long off = base + (t0 + u) * pos_stride + d;
          kx[u][j] = held && d < dh ? to_float(k_cache[off]) : 0.f;
          vx[u][j] = held && d < dh ? to_float(v_cache[off]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r >= rows) break;
        float s[kGroup];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxDimsPerLane; ++j) part += qr[r][j] * kx[u][j];
          part = warp_sum(part);
          const int kpos = p * bs + t0 + u;
          const bool ok = kpos <= rpos[r] && kpos < n_pos;
          s[u] = ok ? part * sm_scale : -INFINITY;
          mx = fmaxf(mx, s[u]);
        }
        const float m_new = fmaxf(m[r], mx);
        if (m_new == -INFINITY) continue;  // nothing visible yet (warp-uniform)
        const float alpha = expf(m[r] - m_new);
        float pu[kGroup], psum = 0.f;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          pu[u] = expf(s[u] - m_new);
          psum += pu[u];
        }
        l[r] = l[r] * alpha + psum;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < kMaxDimsPerLane; ++j) {
          float a = acc[r][j] * alpha;
#pragma unroll
          for (int u = 0; u < kGroup; ++u) a += pu[u] * vx[u][j];
          acc[r][j] = a;
        }
      }
    }
  }

  // merge the warps' partial states
  float* s_acc = smem;                           // [kWarps][rows][dh]
  float* s_m = s_acc + kWarps * rows * dh;       // [kWarps][rows]
  float* s_l = s_m + kWarps * rows;              // [kWarps][rows]
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < kMaxDimsPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) s_acc[(warp * rows + r) * dh + d] = acc[r][j];
    }
    if (lane == 0) {
      s_m[warp * rows + r] = m[r];
      s_l[warp * rows + r] = l[r];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * dh; e += kThreads) {
    const int r = e / dh, d = e % dh;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * rows + r]);
    float o = 0.f;
    if (M != -INFINITY) {
      float L = 0.f, O = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(s_m[w * rows + r] - M);
        L += s_l[w * rows + r] * c;
        O += s_acc[(w * rows + r) * dh + d] * c;
      }
      o = O / fmaxf(L, 1e-30f);
    }
    out[r * dh + d] = from_float<T>(o);
  }
}

}  // namespace repro_torch
