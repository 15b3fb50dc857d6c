// Online-softmax attention of a few query rows against the K/V of one KV
// head — the device routine the paged kernels and the contiguous decode
// kernel share.
//
// K/V are read as a sequence of "pages" of bs positions; a page's address
// comes from the kernel's addressing policy (`KV`): a block-table lookup
// for the paged arena (PagedKV), or row_base + page * bs positions for a
// contiguous per-row cache (ContigKV), whose last page may be ragged.
//
// A CTA holds `tq` queries; with GQA each query carries the g = H / K heads
// of its KV group, so the CTA has rows = tq * g <= kMaxRows query rows (row
// r is query r / g, group head r % g).  The CTA's warps split the pages
// between them — warp w takes pages first + w, first + w + kWarps, ... up
// to the page that holds the tile's largest position, so pages past the
// valid prefix are never loaded — and run without a barrier:
//   * a lane holds dims lane, lane + 32, ... of each row's q and of its
//     f32 accumulator, so every K or V row is one coalesced warp load;
//   * positions go four at a time: the warp loads their K and V rows (none
//     at or past n_pos), each row's four scores q·k * sm_scale are summed
//     across the warp with shuffles, masked to -inf unless kv_pos <=
//     qpos[query] (and kv_pos > qpos - window when window > 0), and folded
//     into that row's online softmax state (m, l, acc) with one rescale per
//     group;
// then the warps' states meet in shared memory and are merged as
// flash-decode partials: O = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int kWarps = 8;              // warps per CTA, splitting the pages
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 8;            // query rows (queries x group heads)
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
// (acc, m, l per row) plus the tile's int query positions.  The Python
// wrappers size the launch with the same formula (kernels/_build.py).
__host__ __device__ inline int tile_smem_bytes(int rows, int dh, int tq) {
  return 4 * kWarps * rows * (dh + 2) + 4 * tq;
}

// Addressing policies: the element offset of (page p, position 0, KV head
// kvh, dim 0).  Positions inside a page are K * dh elements apart.
// kRagged: whether a page may run past n_pos (checked per position only
// then, so the paged kernels carry no per-load bound check).
struct PagedKV {          // arena (n_blocks, bs, K, dh) through a block table
  static constexpr bool kRagged = false;
  const int* __restrict__ table;
  __device__ __forceinline__ long page(int p, int bs, int K, int kvh,
                                       int dh) const {
    return ((long)table[p] * bs * K + kvh) * dh;
  }
};
struct ContigKV {         // one row (S, K, dh) of a contiguous cache
  static constexpr bool kRagged = true;
  long row;               // element offset of the row
  __device__ __forceinline__ long page(int p, int bs, int K, int kvh,
                                       int dh) const {
    return row + ((long)p * bs * K + kvh) * dh;
  }
};

// q / out: element (query i, group head h, dim d) at [i * q_stride + h * dh + d].
// qpos: shared int[tq] absolute positions of the tile's queries, visible to
// every thread (the caller synchronised after writing them).  Queries
// i >= nq are the tile's ragged edge: masked and never written.  n_pos is
// the number of positions the K/V hold (pages * bs for an arena, S for a
// contiguous row): none at or past it is loaded.
template <typename T, typename KV>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            long q_stride, int tq, int nq, int g, int dh,
                            const int* qpos, const T* __restrict__ k_arena,
                            const T* __restrict__ v_arena, int bs, int K,
                            int kvh, KV kv, int n_pos, float sm_scale,
                            int window, float* smem) {
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

  // page range: up to the page of the largest position (the loop bound is
  // the page-skip), and from the first page inside the window
  int lo = 0x7fffffff, hi = -1;
  for (int i = 0; i < nq; ++i) {
    lo = min(lo, qpos[i]);
    hi = max(hi, qpos[i]);
  }
  const int first = window > 0 ? max(lo - window + 1, 0) / bs : 0;
  const int last = hi < 0 ? -1 : min(hi, n_pos - 1) / bs;
  const long pos_stride = (long)K * dh;    // between positions of a block

  for (int p = first + warp; p <= last; p += kWarps) {
    const long base = kv.page(p, bs, K, kvh, dh);
    for (int t0 = 0; t0 < bs; t0 += kGroup) {
      float kx[kGroup][kMaxDimsPerLane], vx[kGroup][kMaxDimsPerLane];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool held = !KV::kRagged || p * bs + t0 + u < n_pos;
#pragma unroll
        for (int j = 0; j < kMaxDimsPerLane; ++j) {
          const int d = lane + 32 * j;
          const long off = base + (t0 + u) * pos_stride + d;
          kx[u][j] = held && d < dh ? to_float(k_arena[off]) : 0.f;
          vx[u][j] = held && d < dh ? to_float(v_arena[off]) : 0.f;
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
          const bool ok = kpos <= rpos[r] &&
                          (!KV::kRagged || kpos < n_pos) &&
                          (window <= 0 || rpos[r] - kpos < window);
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
    const int r = e / dh, d = e % dh, i = r / g, h = r % g;
    if (i >= nq) continue;
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
    out[(long)i * q_stride + h * dh + d] = from_float<T>(o);
  }
}

}  // namespace repro_torch
