// Split-KV flash-decode for Hopper (sm_90a): one new token per batch row
// attends over the first lengths[row] positions of its K/V — the last
// `window` of them when window > 0 (a sliding-window layer).  One templated
// body serves both decode kernels; they differ only in where a position
// lies, a compile-time address policy:
//   * PagedKV (paged_attention.cu): the row's positions lie in fixed-size
//     arena blocks named by its block table;
//   * ContigKV (decode_attention.cu): the row's own (S, K, dh) slice of a
//     contiguous cache, read as pages of kContigPage positions; position p
//     of row r starts at element (r * S + p) * K * dh, the arena's own
//     position stride, so only the table lookup is replaced.
//
// Bound on the H100: HBM bytes — every valid K/V position is read once
// (2 * length * dh * bytes per row and KV head) against 4 * g * dh flops per
// position, far below the card's flop:byte ratio.  To read at the card's
// rate, every SM needs work and tens of KB of loads in flight; one CTA per
// (row, KV head) gives a batch of 8 rows 64 CTAs for 132 SMs, and the
// longest row's CTAs, each on one SM's share of HBM, set the time.
//
// Design (split-KV, flash-decoding):
//   * Grid (n_split, K * chunks, b).  A group of g query heads is cut into
//     chunks = cdiv(g, kDecMaxRows) row-chunks of decode_rows(g) rows (the
//     last may hold fewer), one CTA each, so that a lane's registers hold
//     at most 8 rows (glm4's g = 16 runs as two chunks of 8; every chunk
//     reads the KV head's positions itself).  n_split and the least pages
//     a split takes (min_pages, 64 positions) come from the host, from
//     shapes alone
//     (kernels/paged_attention.py split_plan: the table's width, or
//     cdiv(S, kContigPage)) — never from the lengths, so the decode loops
//     need no host sync.  On the device each row cuts the pages that its
//     visible range [lo, min(length, n_pos)) touches — lo = max(length -
//     window, 0) with a window, 0 without — into runs of pps pages, split
//     s taking pages [pf + s * pps, pf + (s + 1) * pps) from the range's
//     first page pf = lo / bs, split 0 staging from lo itself: a local
//     layer reads its window's positions, whatever the row's length (the
//     staging loop has no lower bound to test, so a window costs the
//     inner loop nothing).
//     pps is at least min_pages, at most n_split runs cover the
//     row, and a run is no shorter than an even share of the whole batch's
//     pages over `ctas` CTAs (the CTAs the card holds at once, from the
//     host).  So a short row spreads over several CTAs when the batch is
//     short, and the CTAs stay long enough to stream when it is long.
//   * Lengths: one per row, or one shared by every row (ContigKV<0>); a
//     length above the row's n_pos positions sees them all, a row whose
//     visible range is empty (a length of 0) gives a zero output.  A split
//     at or past the row's
//     valid pages is empty: its CTA returns before loading anything
//     (split_kv.cuh).  No position at or past the length is loaded, so a
//     ragged last page (S not a multiple of kContigPage) is never overread.
//   * Staging: a paged CTA reads its split's block ids into shared memory
//     once; then each CTA copies its positions' K and V rows there with
//     cp.async, 16 bytes a thread, in a ring of kDecStages = 2 tiles of
//     kDecTile = 16 positions: one tile (16 KB in f32 at dh 128) loads
//     while the other is consumed, and the three CTAs an SM holds (~170
//     registers a thread) keep ~48 KB in flight.  Positions past the row's
//     length are zero-filled and masked.  (On the H100 two stages read as
//     fast as three or four, or faster, and 32-position tiles slower:
//     scripts/paged_decode_variants.py builds the paged kernel with other
//     REPRO_DEC_* settings below.)
//   * Compute: warp w takes positions w, w + 4, ... of each staged tile; a
//     lane holds 4 dims of each of the CTA's query rows (registers for G
//     rows, G a power of two >= the rows: 8-row arrays cost 40 more
//     registers a thread and a CTA per SM) and of their f32 online softmax
//     (m, l, acc,
//     scores in log2 units), so one score is a 5-step warp sum.  The 4
//     warps' states are merged in shared memory at the end.
//   * Merge: a row with one live split writes its output; otherwise each
//     CTA stores its partial and the last to arrive merges them
//     (split_kv.cuh), in the same launch.
//   * Window end and lse (the contiguous decode only; the append-buffer
//     decode's two segments, models/layers.py): an optional window end
//     `wend` per row or shared moves the window's left edge to wend -
//     window (the prefix segment's edge comes from the query's position,
//     not from its length), and an optional f32 `lse` (b, H) takes each
//     row's natural log-sum-exp of its scaled scores, m + log(l), from the
//     same (m, l) that normalise the output (-inf for a row that sees
//     nothing, whose output is 0), written by the CTA that writes the
//     output; with an lse the output is f32, so that the two segments'
//     combine rounds once.  Both are a compile-time form of the body
//     (kExt), instantiated for the contiguous decode with one shared
//     length only: the paged decode and the other contiguous forms
//     compile as without them (a runtime test of the two pointers made
//     the f32 contiguous decode at 8-row groups 12-17% slower on the
//     H100).
#pragma once

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_tile.cuh"
#include "split_kv.cuh"

namespace repro_torch {

// Compile-time settings, overridden with -D only by
// scripts/paged_decode_variants.py: positions per stage, stages of the
// ring, and whether the scores, softmax and P.V run at all (0: only the
// staging, the partials and the merge — wrong results by design)
#ifndef REPRO_DEC_TILE
#define REPRO_DEC_TILE 16
#endif
#ifndef REPRO_DEC_STAGES
#define REPRO_DEC_STAGES 2
#endif
#ifndef REPRO_DEC_COMPUTE
#define REPRO_DEC_COMPUTE 1
#endif

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecTile = REPRO_DEC_TILE;         // positions per stage
constexpr int kDecStages = REPRO_DEC_STAGES;
constexpr int kDecPerWarp = kDecTile / kDecWarps;
constexpr int kDecMaxSmem = 96 * 1024;           // the limit the launch sets
constexpr int kContigPage = 16;   // positions per page of a contiguous row
constexpr int kDecMaxRows = 8;    // query rows a CTA holds in registers

// A group of g query heads runs as decode_chunks(g) CTAs of decode_rows(g)
// rows each, the last holding the rest (kernels/paged_attention.py
// decode_chunks)
__host__ __device__ inline int decode_chunks(int g) {
  return (g + kDecMaxRows - 1) / kDecMaxRows;
}
__host__ __device__ inline int decode_rows(int g) {
  const int c = decode_chunks(g);
  return (g + c - 1) / c;
}

// The pages a row's visible range [lo, min(length, n_pos)) touches, lo =
// max(end - window, 0) when window > 0, else 0 (end: the window's end,
// the length unless the caller gives one): returns their number (0 for an
// empty range) and sets lo and the first page, lo / bs
__device__ __forceinline__ int visible_pages(int length, int end, int n_pos,
                                             int bs, int window, int* lo,
                                             int* pf) {
  *lo = window > 0 ? max(end - window, 0) : 0;
  *pf = *lo > 0 ? *lo / bs : 0;
  return max((min(length, n_pos) + bs - 1) / bs - *pf, 0);
}

// Address policies (tags of the body's template): where position `of` of
// page `pg` of the CTA's split lies, in positions of the K / V tensor (K *
// dh elements apart), and the stride of the lengths (1: one per row, 0:
// one shared by every row).  Both are compile-time: a runtime stride (a
// kernel argument) made the bf16 paged decode slower on the H100.
struct PagedKV {     // blk[pg] * bs + of: the split's block ids, in shared
  static constexpr int kLenStride = 1;                       // memory
};
template <int LS>
struct ContigKV {    // row * S + p0 + pg * bs + of: the row's own S
  static constexpr int kLenStride = LS;                      // positions
};

__device__ __forceinline__ void load4f(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4f(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}

// Shared memory of a CTA of `rows` query rows: the ring, reused after the
// loop for the warps' states and the merge's weights; then the block ids
// of up to max_pages pages of the split (paged only).
__host__ inline size_t decode_smem_bytes(int rows, int dh, int elt,
                                         int n_split, int max_pages) {
  size_t bytes = (size_t)kDecStages * 2 * kDecTile * dh * elt;     // ring
  const size_t states = 4 * (size_t)kDecWarps * rows * (dh + 2);
  const size_t merge = 4 * (size_t)(3 * n_split + 1) * rows;
  if (states > bytes) bytes = states;
  if (merge > bytes) bytes = merge;
  return bytes + 4 * (size_t)max_pages;
}

// G: the query rows of a CTA held in registers (rows <= G; one
// instantiation per power of two up to kDecMaxRows); rows = decode_rows(g),
// the grid's y = K * decode_chunks(g).  rows is an argument: deriving it
// and the chunks from H / K in the kernel made the bf16 decodes 1.08-1.14x
// slower on the H100.  Addr: PagedKV (tables: (b, n_pos / bs) block ids)
// or ContigKV<LS> (tables unused, K/V (b, n_pos, K, dh)).
// window: the layer's sliding window, 0 for none.  kExt: the form that
// takes wend (null for none: the window's end, per row (we_stride 1) or
// shared (0)) and lse (null for none: (b, H) f32, and out is then f32);
// without it both are ignored.
template <typename T, int G, typename Addr, bool kExt>
__global__ void __launch_bounds__(kDecThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        const int* __restrict__ wend, int we_stride,
                        void* __restrict__ out_, float* __restrict__ lse,
                        float* __restrict__ part,
                        int* __restrict__ counters, int H, int K, int dh,
                        int bs, int n_pos, int min_pages, int n_split,
                        int ctas, int ring_bytes, int rows, int window,
                        float sl2) {
  constexpr bool kPaged = std::is_same<Addr, PagedKV>::value;
  // without kExt neither a window end nor an lse: the code is the same as
  // without them
  if constexpr (!kExt) wend = nullptr, lse = nullptr;
  const bool f32_out = lse != nullptr;
  extern __shared__ __align__(16) unsigned char dsm[];
  T* ring = reinterpret_cast<T*>(dsm);          // [stage][K, V][tile][dh]
  float* fsm = reinterpret_cast<float*>(dsm);
  __shared__ int flag;
  const int split = blockIdx.x, row = blockIdx.z;
  const int n_chunks = gridDim.y == K ? 1 : gridDim.y / K;
  const int kvh = blockIdx.y / n_chunks, r0 = blockIdx.y % n_chunks * rows;
  const int g = H / K, gc = min(rows, g - r0);  // the CTA's query rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int ls = Addr::kLenStride;
  int lo, pf;
  // the batch's visible pages (each row's splits are balanced against
  // them)
  __shared__ int warp_pages[kDecWarps];
  int pages = 0;
  for (int i = threadIdx.x; i < gridDim.z; i += kDecThreads)
    pages += visible_pages(lengths[i * ls],
                           wend ? wend[i * we_stride] : lengths[i * ls],
                           n_pos, bs, window, &lo, &pf);
  pages = __reduce_add_sync(0xffffffffu, pages);
  if (lane == 0) warp_pages[warp] = pages;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) total += warp_pages[w];
  const int length = min(lengths[row * ls], n_pos);
  // the pages of the row's visible range [lo, length) in runs of pps
  // pages from its first page pf: at least min_pages, at most n_split
  // runs, and no shorter than an even share of the batch's pages over
  // `ctas` CTAs.  Live splits are those holding a visible position, split
  // 0 always (a row that sees nothing comes back zero)
  const int valid = visible_pages(
      lengths[row * ls], wend ? wend[row * we_stride] : lengths[row * ls],
      n_pos, bs, window, &lo, &pf);
  const int pps = max(max(min_pages, (valid + n_split - 1) / n_split),
                      (total * (int)gridDim.y + ctas - 1) / ctas);
  const int span = pps * bs;
  const int n_live = max((valid + pps - 1) / pps, 1);
  if (split >= n_live) return;
  // the split's pages start at page0; its positions at p0: lo for split 0
  // (inside its first page: the positions before it are never staged),
  // page0 for the others
  const int page0 = pf * bs + split * span;
  const int p0 = max(page0, lo), p1 = min(page0 + span, length);
  const int n_tiles = p1 > p0 ? (p1 - p0 + kDecTile - 1) / kDecTile : 0;
  int* blk = reinterpret_cast<int*>(dsm + ring_bytes);
  const long first = (long)row * n_pos + page0;  // contiguous: page0's
                                                 // position
  if constexpr (kPaged) {
    // the split's block ids, read once: the copies then wait on no table
    // load
    const int* table = tables + (long)row * (n_pos / bs) + pf + split * pps;
    for (int i = threadIdx.x; i < (max(p1 - page0, 0) + bs - 1) / bs;
         i += kDecThreads)
      blk[i] = table[i];
    __syncthreads();
  }
  const long pos_stride = (long)K * dh;
  constexpr int kVec = 16 / sizeof(T);          // elements per copy
  // copies a thread makes per tile, at most (dh <= 128)
  constexpr int kSlots = kDecTile * (128 / kVec) / kDecThreads;
  const int chunks = dh / kVec;
  // the thread's copies of a tile — position cj, column cc, the same in
  // every tile — and where cj of the next tile to stage lies: page pg of
  // the split (from page0), offset of in it, advanced kDecTile positions a
  // tile, so a copy costs no division
  int cj[kSlots], cc[kSlots], pg[kSlots], of[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = threadIdx.x + s * kDecThreads;
    cj[s] = e < kDecTile * chunks ? e / chunks : -1;
    cc[s] = (e - max(cj[s], 0) * chunks) * kVec;
    pg[s] = (p0 - page0 + max(cj[s], 0)) / bs;
    of[s] = (p0 - page0 + max(cj[s], 0)) % bs;
  }

  // stage tile t into ring slot st; tiles are staged in order
  auto stage = [&](int st, int t) {
    T* Ks = ring + (long)st * 2 * kDecTile * dh;
    T* Vs = Ks + kDecTile * dh;
    const int base = p0 + t * kDecTile;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (cj[s] < 0) break;
      const bool ok = base + cj[s] < p1;
      // the position, read only for a copy that is made: computed outside
      // the select, the paged block id's shared-memory load made the bf16
      // paged decode slower on the H100
      const long off =
          ok ? (kPaged ? (long)blk[pg[s]] * bs + of[s]
                       : first + (long)pg[s] * bs + of[s]) * pos_stride +
                   (long)kvh * dh + cc[s]
             : 0;
      cp_async16(Ks + cj[s] * dh + cc[s], k + off, ok);
      cp_async16(Vs + cj[s] * dh + cc[s], v + off, ok);
      for (of[s] += kDecTile; of[s] >= bs; of[s] -= bs) ++pg[s];
    }
  };

  // the CTA's q rows of the group (pre-scaled by the caller unless
  // sm_scale says otherwise): lane owns dims 4 lane .. 4 lane + 3
  const bool dims = 4 * lane < dh;
  float qr[G][4], acc[G][4], m[G], l[G];
  const T* qg = q + (long)row * H * dh + (long)(kvh * g + r0) * dh;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) qr[r][j] = acc[r][j] = 0.f;
    if (r < gc && dims) load4f(qg + r * dh + 4 * lane, qr[r]);
  }

#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < n_tiles) stage(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int nt = t + kDecStages - 1;
    if (nt < n_tiles) stage(nt % kDecStages, nt);
    cp_async_commit();
    cp_async_wait<kDecStages - 1>();
    __syncthreads();
    const T* Ks = ring + (long)(t % kDecStages) * 2 * kDecTile * dh;
    const T* Vs = Ks + kDecTile * dh;
    float kx[kDecPerWarp][4], vx[kDecPerWarp][4];
#pragma unroll
    for (int u = 0; u < kDecPerWarp; ++u) {
      const int j = warp + kDecWarps * u;
#pragma unroll
      for (int i = 0; i < 4; ++i) kx[u][i] = vx[u][i] = 0.f;
      if (dims) {
        load4f(Ks + j * dh + 4 * lane, kx[u]);
        load4f(Vs + j * dh + 4 * lane, vx[u]);
      }
    }
    const int base = p0 + t * kDecTile;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= gc || !REPRO_DEC_COMPUTE) break;
      float s[kDecPerWarp], mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kDecPerWarp; ++u) {
        float part_dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) part_dot += qr[r][i] * kx[u][i];
        part_dot = warp_sum(part_dot);
        s[u] = base + warp + kDecWarps * u < p1 ? part_dot * sl2 : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[r], mx);
      if (m_new == -INFINITY) continue;        // warp-uniform
      const float alpha = exp2f(m[r] - m_new);
      float pu[kDecPerWarp], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kDecPerWarp; ++u) {
        pu[u] = exp2f(s[u] - m_new);
        psum += pu[u];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = acc[r][i] * alpha;
#pragma unroll
        for (int u = 0; u < kDecPerWarp; ++u) a += pu[u] * vx[u][i];
        acc[r][i] = a;
      }
    }
    __syncthreads();                            // the stage may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states -> the CTA's (acc, m, l) per row
  float* s_acc = fsm;                           // [warp][gc][dh]
  float* s_m = s_acc + kDecWarps * gc * dh;     // [warp][gc]
  float* s_l = s_m + kDecWarps * gc;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= gc) break;
    if (dims)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s_acc[(warp * gc + r) * dh + 4 * lane + i] = acc[r][i];
    if (lane == 0) {
      s_m[warp * gc + r] = m[r];
      s_l[warp * gc + r] = l[r];
    }
  }
  __syncthreads();
  // rows of every chunk's partial layout: even (16-byte aligned partials)
  const int rp = rows + (rows & 1);
  const long ps = partial_floats(rp, dh);
  const int group = row * gridDim.y + blockIdx.y;   // (row, KV head, chunk)
  float* mine = part + ((long)group * n_split + split) * ps;
  const long o_off = (long)row * H * dh + (long)(kvh * g + r0) * dh;
  T* o = static_cast<T*>(out_) + o_off;
  float* of32 = static_cast<float*>(out_) + o_off;
  float* lse_row = f32_out ? lse + (long)row * H + kvh * g + r0 : nullptr;
  for (int e = threadIdx.x; e < gc * dh; e += kDecThreads) {
    const int r = e / dh;
    float M = -INFINITY;
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, s_m[w * gc + r]);
    float A = 0.f, L = 0.f;
    if (M != -INFINITY)
      for (int w = 0; w < kDecWarps; ++w) {
        const float c = exp2f(s_m[w * gc + r] - M);
        A += s_acc[(w * gc + r) * dh + e - r * dh] * c;
        L += s_l[w * gc + r] * c;
      }
    if (n_live == 1) {
      if (f32_out) {
        of32[e] = A / fmaxf(L, 1e-30f);
        if (e - r * dh == 0) lse_row[r] = row_lse(M, L);
      } else {
        o[e] = from_float<T>(A / fmaxf(L, 1e-30f));
      }
    } else {
      mine[e] = A;
      if (e - r * dh == 0) {
        mine[rp * dh + r] = M;
        mine[rp * dh + rp + r] = L;
      }
    }
  }
  if (n_live == 1) return;
  if (!arrive_last(counters + group, n_live, &flag)) return;
  if (f32_out)
    merge_partials<float>(part + (long)group * n_split * ps, n_live, rp, 0,
                          gc, dh, of32, (long)H * dh, gc, 1, fsm, lse_row);
  else
    merge_partials<T>(part + (long)group * n_split * ps, n_live, rp, 0, gc,
                      dh, o, (long)H * dh, gc, 1, fsm);
}

template <typename T, int G, typename Addr, bool kExt>
cudaError_t launch_decode_split(const void* q, const void* k, const void* v,
                                const int* tables, const int* lengths,
                                const int* wend, int we_stride, void* out,
                                float* lse, float* part,
                                int* counters, int b, int H, int K, int dh,
                                int bs, int n_pos, int min_pages, int n_split,
                                int ctas, float sm_scale, int window,
                                cudaStream_t stream) {
  const int g = H / K, rows = decode_rows(g), chunks = decode_chunks(g);
  // block ids of the longest split (paged): an even share of a batch of
  // full tables
  const int n_pages = (n_pos + bs - 1) / bs;
  const int max_pages =
      std::is_same<Addr, PagedKV>::value
          ? std::max(std::max(min_pages, (n_pages + n_split - 1) / n_split),
                     (int)(((long)n_pages * b * K * chunks + ctas - 1) /
                           ctas))
          : 0;
  const size_t smem = decode_smem_bytes(rows, dh, sizeof(T), n_split,
                                        max_pages);
  const int ring_bytes = (int)(smem - 4 * (size_t)max_pages);
  if (smem > kDecMaxSmem || n_split > kMaxSplits) return cudaErrorInvalidValue;
  const cudaError_t err =
      ensure_smem<decode_split_kernel<T, G, Addr, kExt>>(kDecMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, K * chunks, b);
  decode_split_kernel<T, G, Addr, kExt><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, wend, we_stride, out, lse,
      part, counters, H, K, dh, bs, n_pos, min_pages, n_split, ctas,
      ring_bytes, rows, window, sm_scale * kLog2e);
  return cudaSuccess;
}

// The body for q's type (bf16 or f32) and the decode_rows(H / K) <= 8
// query rows of a CTA; kExt: the form with a window end and an lse
template <typename Addr, bool kExt = false>
cudaError_t launch_decode_body(bool bf16, const void* q, const void* k,
                               const void* v, const int* tables,
                               const int* lengths, const int* wend,
                               int we_stride, void* out, float* lse,
                               float* part,
                               int* counters, int b, int H, int K, int dh,
                               int bs, int n_pos, int min_pages, int n_split,
                               int ctas, float sm_scale, int window,
                               cudaStream_t stream) {
  const int rows = decode_rows(H / K);
#define REPRO_DECODE_SPLIT(T, G)                                              \
  if (rows <= G)                                                              \
    return launch_decode_split<T, G, Addr, kExt>(                             \
        q, k, v, tables, lengths, wend, we_stride, out, lse, part, counters,  \
        b, H, K, dh, bs, n_pos, min_pages, n_split, ctas, sm_scale, window,   \
        stream);
#define REPRO_DECODE_TYPED(T)                                                 \
  REPRO_DECODE_SPLIT(T, 1)                                                    \
  REPRO_DECODE_SPLIT(T, 2)                                                    \
  REPRO_DECODE_SPLIT(T, 4)                                                    \
  REPRO_DECODE_SPLIT(T, 8)                                                    \
  return cudaErrorInvalidValue;
  if (bf16) {
    REPRO_DECODE_TYPED(__nv_bfloat16)
  }
  REPRO_DECODE_TYPED(float)
#undef REPRO_DECODE_TYPED
#undef REPRO_DECODE_SPLIT
}

}  // namespace repro_torch
