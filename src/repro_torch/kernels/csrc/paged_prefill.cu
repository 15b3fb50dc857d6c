// Paged chunked-prefill attention for Hopper (sm_90a): the C queries of one
// prompt chunk, at absolute positions n_past.., attend causally over the
// sequence's K/V read through its block table (src/repro/models/layers.py,
// attention_prefill_paged_apply).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel), which tiles a contiguous K/V over a
// (batch, kv-head, q-block, kv-block) grid with the kv-block axis
// sequential, and runs fully masked blocks.
//
// Bound on the H100: for a 32-token chunk the work is 4 * C * H * dh flops
// per visible position against 2 * K * dh * bytes of K/V per position —
// C * H / (2 * K) = 32 flops per byte in f32, so on the CUDA cores (67
// TFLOP/s over 3.35 TB/s: 20) the operations bound it, and on the tensor
// cores the bytes.  What held the previous design back: 8 query rows a CTA,
// so each KV head's pages were read once per q-tile, every score a
// warp-shuffle sum, and 64 CTAs for 132 SMs.
//
// Design (split-KV, tensor cores):
//   * Tiles.  A CTA owns one tile of kPfRows = 64 query rows — 64 / g
//     queries x the g heads of its KV head, as flash_bf16_kernel folds them
//     (a 32-token chunk at g = 2 is one tile) — and one split of the
//     table's span pages: grid (n_tiles, K, n_split), the split sized on
//     the host from span alone (kernels/paged_attention.py split_plan),
//     never from the positions.
//   * Skipped and masked splits.  The tile's visible keys are [lo, hi): hi
//     past its largest position (and at most span * bs), lo at its smallest
//     position's window edge (0 without a window).  Splits outside are
//     empty and return at once (split_kv.cuh); inside a split, keys go in
//     blocks of kPfKeys = 64, and the causal and window masks are evaluated
//     only on a block that crosses the diagonal, the window's edge or the
//     visible range's end.
//   * Loads.  The CTA reads the table's block ids into shared memory
//     itself, alongside the positions; q and each K/V block are staged by
//     cp.async (16 bytes a thread) — bf16 in a ring of two, so the next
//     block loads while this one's products run; f32 through one f32 stage
//     that is split into bf16 hi / lo tiles (split_rows of mma_tile.cuh,
//     which the contiguous flash body shares), then refilled with the next
//     block while this one's products run.
//   * Products.  S = q.K^T and P.V run as mma.sync.m16n8k16 with f32
//     accumulators, each of 4 warps owning 16 rows; the online softmax
//     (scores in log2 units) stays in f32 registers, reduced over the 4
//     lanes that share a row, and P goes from the score fragments (their C
//     layout is the A layout of P.V) straight into registers.
//       - bf16 inputs: one product each, fragments by ldmatrix, P rounded
//         to bf16 as the reference's model path rounds it.
//       - f32 inputs (the paged engine's arena): every operand — q, K, V
//         and P — is split into a bf16 pair (split_bf16) at the fragment
//         load and each product is hi.hi + hi.lo + lo.hi, keeping ~16 bits
//         of each f32 operand: a single bf16 rounding would not hold f32's
//         1e-4.  The f32 tiles are read as float2 (q, K: rows dh + 8 floats
//         apart) or single floats (V: dh + 4 apart), both free of bank
//         conflicts.
//     The head dim is padded to a multiple of 16 with zeros in shared
//     memory (one instantiation per padded width).
//   * Merge.  A tile with one live split writes its output; otherwise each
//     live CTA stores its partial (64 rows x dh floats) and a second, small
//     kernel merges them, 8 rows a CTA (split_kv.cuh says why not the last
//     CTA to arrive).  It is launched in the same host call as a
//     programmatic dependent (griddepcontrol): its CTAs start while the
//     main kernel runs, read the positions, and wait for the main grid only
//     before reading the partials, so the second launch adds no gap.
//   Queries of a padded chunk tail are computed like the others; their rows
//   are never read.
#include <stdint.h>

#include "kernels.h"
#include "mma_tile.cuh"
#include "split_kv.cuh"

namespace repro_torch {

constexpr int kPfRows = 64;          // query rows per tile (queries x heads)
constexpr int kPfKeys = 64;          // key positions per staged block
constexpr int kPfWarps = 4;          // a warp owns 16 of the 64 rows
constexpr int kPfThreads = 32 * kPfWarps;
constexpr int kMrgRows = 8;          // rows per CTA of the merge kernel
constexpr int kMrgThreads = 256;
constexpr int kMaxSpan = 4096;       // pages of a table (64K positions at 16)

// Shared memory of the main kernel at padded head dim DP (mma_tile.cuh):
// bf16 q and a ring of two K/V stages, or f32 q, one f32 K/V stage and its
// split bf16 hi / lo tiles.
template <typename T, int DP>
using PfSmem = TileSmem<T, DP, kPfRows, kPfKeys>;

// The tile's keys: visible positions [lo, hi) — up to its largest query
// position (and at most n_pos), from its smallest's window edge — cut into
// runs of pps pages from the page of lo; split s takes keys
// [k0 + s * pps * bs, ...) clipped to [lo, hi), for s < n_live.
struct TileSplits {
  int qmin, qmax, lo, hi, k0, pps, n_live;
};

__device__ __forceinline__ TileSplits tile_splits(const int* qpos, int nq,
                                                  int n_pos, int bs,
                                                  int min_pages, int n_split,
                                                  int window) {
  int qmin = 0x7fffffff, qmax = -1;
  for (int i = 0; i < nq; ++i) {
    qmin = min(qmin, qpos[i]);
    qmax = max(qmax, qpos[i]);
  }
  TileSplits t;
  t.qmin = qmin;
  t.qmax = qmax;
  t.hi = min(qmax + 1, n_pos);
  t.lo = min(window > 0 ? max(qmin - window + 1, 0) : 0, t.hi);
  const int first = t.lo / bs;
  const int pages = t.hi > t.lo ? (t.hi - 1) / bs - first + 1 : 0;
  t.k0 = first * bs;
  t.pps = max(min_pages, (pages + n_split - 1) / n_split);
  t.n_live = max((pages + t.pps - 1) / t.pps, 1);
  return t;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kPfThreads)
    paged_prefill_split_kernel(const T* __restrict__ q,
                               const T* __restrict__ k_arena,
                               const T* __restrict__ v_arena,
                               const int* __restrict__ table,
                               const int* __restrict__ positions,
                               T* __restrict__ out, float* __restrict__ part,
                               int C, int H, int K, int dh, int bs, int span,
                               int tq, int min_pages, int n_split, float sl2,
                               int window) {
  using S = PfSmem<T, DP>;
  using bf16 = __nv_bfloat16;
  constexpr bool kF32 = S::kF32;
  constexpr int LB = S::LB, LS = S::LS;
  constexpr int NT = DP / 8;                // 8-wide tiles of the output
  constexpr int KS = DP / 16;               // 16-deep slices of q . k
  extern __shared__ __align__(16) unsigned char psm[];
  T* Qs = reinterpret_cast<T*>(psm);                   // [kPfRows][LB]
  unsigned char* stage0 = psm + S::kQ;                 // staged K, V
  // bf16 K and V the products read: the staged ones (bf16), or the split
  // hi / lo of the f32 stage (f32)
  bf16* KVsplit = reinterpret_cast<bf16*>(stage0 + S::kStage);
  __shared__ int qpos[kPfRows];
  const int g = H / K, rows = tq * g;
  const int tile = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int q0 = tile * tq, nq = min(tq, C - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;

  // the positions and the table's block ids (after the tiles, in shared
  // memory), read together: the copies then wait on no table load
  int* sblk = reinterpret_cast<int*>(psm + S::kBytes);
  for (int i = tid; i < nq; i += kPfThreads) qpos[i] = positions[q0 + i];
  for (int i = tid; i < span; i += kPfThreads) sblk[i] = table[i];
  __syncthreads();
  const TileSplits ts = tile_splits(qpos, nq, span * bs, bs, min_pages,
                                    n_split, window);
  // the merge kernel may launch now and run up to its wait for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  if (split >= ts.n_live) return;
  const int kv_lo = max(ts.lo, ts.k0 + split * ts.pps * bs);
  const int kv_hi = min(ts.hi, ts.k0 + (split + 1) * ts.pps * bs);
  const int nblk = kv_hi > kv_lo ? (kv_hi - kv_lo + kPfKeys - 1) / kPfKeys
                                 : 0;

  // zero the padded columns dh .. DP - 1 once: nothing below writes them
  if (dh < DP) {
    const int pad = DP - dh;
    for (int e = tid; e < kPfRows * pad; e += kPfThreads)
      Qs[(e / pad) * LB + dh + e % pad] = from_float<T>(0.f);
    bf16* kv = kF32 ? KVsplit : reinterpret_cast<bf16*>(stage0);
    // bf16: K, V of two stages; f32: K hi, K lo, V hi, V lo
    for (int e = tid; e < 4 * kPfKeys * pad; e += kPfThreads)
      kv[(e / pad) * LB + dh + e % pad] = __float2bfloat16(0.f);
  }
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = dh / kVec;
  // the tile's q rows: row r is query q0 + r / g, head kvh * g + r % g
  for (int e = tid; e < kPfRows * chunks; e += kPfThreads) {
    const int r = e / chunks, c = (e - r * chunks) * kVec, i = r / g;
    const bool ok = r < rows && i < nq;
    const T* src = q + ((long)(ok ? q0 + i : 0) * H + kvh * g + r % g) * dh + c;
    cp_async16(Qs + r * LB + c, src, ok);
  }
  const long pos_stride = (long)K * dh;
  // K and V rows kb .. kb + 63 into stage st (f32: the one stage); rows at
  // or past kv_hi zero
  auto stage_kv = [&](int st, int kb) {
    constexpr int L = kF32 ? LS : LB;
    T* Ks = reinterpret_cast<T*>(stage0 + st * S::kStage);
    T* Vs = Ks + kPfKeys * L;
    for (int e = tid; e < kPfKeys * chunks; e += kPfThreads) {
      const int j = e / chunks, c = (e - j * chunks) * kVec, pos = kb + j;
      const bool ok = pos < kv_hi;
      const long off = ok ? ((long)sblk[pos / bs] * bs + pos % bs) *
                                    pos_stride + (long)kvh * dh + c
                          : 0;
      cp_async16(Ks + j * L + c, k_arena + off, ok);
      cp_async16(Vs + j * L + c, v_arena + off, ok);
    }
  };

  // query position of the thread's two rows, -1 past the tile
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gr + 8 * h, i = r / g;
    qp[h] = r < rows && i < nq ? qpos[i] : -1;
  }
  const int qmin = ts.qmin, qmax = ts.qmax;

  if (nblk > 0) stage_kv(0, kv_lo);
  cp_async_commit();                        // group 0: q and the first block

  float acc[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;

  for (int it = 0; it < nblk; ++it) {
    const int kb = kv_lo + it * kPfKeys;
    const bf16 *Kh, *Kl, *Vh, *Vl;
    if constexpr (kF32) {
      // stage -> hi / lo, then refill the stage with the next block while
      // this one's products run
      cp_async_wait<0>();
      __syncthreads();
      split_rows<kPfKeys, LS, LB>(reinterpret_cast<const float*>(stage0),
                                  KVsplit, 2 * kPfKeys, dh, kPfThreads);
      __syncthreads();
      if (it + 1 < nblk) stage_kv(0, kb + kPfKeys);
      cp_async_commit();
      Kh = KVsplit;
      Kl = Kh + kPfKeys * LB;
      Vh = Kl + kPfKeys * LB;
      Vl = Vh + kPfKeys * LB;
    } else {
      if (it + 1 < nblk) stage_kv((it + 1) & 1, kb + kPfKeys);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      Kh = reinterpret_cast<const bf16*>(stage0 + (it & 1) * S::kStage);
      Vh = Kh + kPfKeys * LB;
      Kl = Vl = nullptr;
    }

    // S = q k^T: 16 rows x 64 keys per warp, 8 tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[n][u] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t qh[4], ql[4];
      if constexpr (kF32)
        split_frag_a(reinterpret_cast<const float*>(Qs), LB, warp * 16,
                     16 * s, qh, ql);
      else
        ldmatrix_x4(qh, Qs + (warp * 16 + (lane & 15)) * LB + 16 * s +
                            (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        // matrices: keys 8n.. / 8n+8.. x dims 16s.. / 16s+8..
        const int mi = lane >> 3;
        const int off = (8 * n + (mi >> 1) * 8 + (lane & 7)) * LB + 16 * s +
                        (mi & 1) * 8;
        uint32_t kf[4];
        ldmatrix_x4(kf, Kh + off);
        const uint32_t b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
        if constexpr (kF32) {
          uint32_t kfl[4];
          ldmatrix_x4(kfl, Kl + off);
          const uint32_t c0[2] = {kfl[0], kfl[1]}, c1[2] = {kfl[2], kfl[3]};
          mma_bf16(sc[n], qh, c0);
          mma_bf16(sc[n + 1], qh, c1);
          mma_bf16(sc[n], ql, b0);
          mma_bf16(sc[n + 1], ql, b1);
        }
        mma_bf16(sc[n], qh, b0);
        mma_bf16(sc[n + 1], qh, b1);
      }
    }

    // mask only a block that crosses the diagonal, the window's edge or
    // the end of the visible keys
    const bool edge = kb + kPfKeys > kv_hi || kb + kPfKeys - 1 > qmin ||
                      (window > 0 && qmax - kb >= window);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float x = sc[n][2 * h + u] * sl2;
          if (edge) {
            const int kp = kb + 8 * n + 2 * t4 + u;
            const bool ok = kp < kv_hi && kp <= qp[h] &&
                            (window <= 0 || qp[h] - kp < window);
            x = ok ? x : -INFINITY;
          }
          sc[n][2 * h + u] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[h] - base);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float p = exp2f(sc[n][2 * h + u] - base);
          sc[n][2 * h + u] = p;
          ps += p;
        }
      l[h] = l[h] * alpha + ps;             // the thread's share of the row
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V, P from the score fragments (the C layout of two 8-key
    // tiles is the A layout of one 16-key slice)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = sc[2 * s + (i >> 1)] + 2 * (i & 1);
        if constexpr (kF32)
          split_bf16(p[0], p[1], ph[i], pl[i]);
        else
          ph[i] = pack_bf16(p[0], p[1]);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        // matrices: keys 16s.. / 16s+8.. x dims 8n.. / 8n+8.., transposed
        const int mi = lane >> 3;
        const int off = (16 * s + (mi & 1) * 8 + (lane & 7)) * LB + 8 * n +
                        (mi >> 1) * 8;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vh + off);
        const uint32_t b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
        if constexpr (kF32) {
          uint32_t vfl[4];
          ldmatrix_x4_trans(vfl, Vl + off);
          const uint32_t c0[2] = {vfl[0], vfl[1]}, c1[2] = {vfl[2], vfl[3]};
          mma_bf16(acc[n], ph, c0);
          mma_bf16(acc[n + 1], ph, c1);
          mma_bf16(acc[n], pl, b0);
          mma_bf16(acc[n + 1], pl, b1);
        }
        mma_bf16(acc[n], ph, b0);
        mma_bf16(acc[n + 1], ph, b1);
      }
    }
    __syncthreads();                        // this stage is free to refill
  }
  cp_async_wait<0>();

  // the row sums over the 4 lanes of a row; then the output, or the partial
  // (acc unnormalised, m, l) that the merge kernel reads
  const long ps = partial_floats(kPfRows, dh);
  float* mine = part + (((long)tile * K + kvh) * n_split + split) * ps;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = warp * 16 + gr + 8 * h;
    if (ts.n_live == 1) {
      if (qp[h] < 0) continue;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      T* o = out + ((long)(q0 + r / g) * H + kvh * g + r % g) * dh;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = 8 * n + 2 * t4;
        if (d >= dh) continue;
        if constexpr (kF32)
          *reinterpret_cast<float2*>(o + d) =
              make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
        else
          *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
              acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = 8 * n + 2 * t4;
        if (d < dh)
          *reinterpret_cast<float2*>(mine + (long)r * dh + d) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
      if (t4 == 0) {
        mine[(long)kPfRows * dh + r] = m[h];
        mine[(long)kPfRows * dh + kPfRows + r] = lt;
      }
    }
  }
}

// The merge of a tile's live partials, kMrgRows rows a CTA: grid (n_tiles *
// K, kPfRows / kMrgRows).  Tiles with one live split were written by the
// main kernel and are skipped.
template <typename T>
__global__ void __launch_bounds__(kMrgThreads)
    paged_prefill_merge_kernel(const float* __restrict__ part,
                               const int* __restrict__ positions,
                               T* __restrict__ out, int C, int H, int K,
                               int dh, int bs, int span, int tq, int min_pages,
                               int n_split, int window) {
  __shared__ int qpos[kPfRows];
  __shared__ float wsm[(3 * kMaxSplits + 1) * kMrgRows];
  const int group = blockIdx.x, tile = group / K, kvh = group % K;
  const int g = H / K, q0 = tile * tq, nq = min(tq, C - q0);
  const int r0 = blockIdx.y * kMrgRows;
  if (r0 / g >= nq) return;
  for (int i = threadIdx.x; i < nq; i += kMrgThreads)
    qpos[i] = positions[q0 + i];
  __syncthreads();
  const TileSplits ts = tile_splits(qpos, nq, span * bs, bs, min_pages,
                                    n_split, window);
  if (ts.n_live == 1) return;
  // the partials: visible once the main kernel has completed
  asm volatile("griddepcontrol.wait;" ::: "memory");
  merge_partials<T>(part + (long)group * n_split *
                               partial_floats(kPfRows, dh),
                    ts.n_live, kPfRows, r0, r0 + kMrgRows, dh,
                    out + ((long)q0 * H + kvh * g) * dh, (long)H * dh, g, nq,
                    wsm);
}

template <typename T, int DP>
cudaError_t launch_prefill_split(const void* q, const void* k_arena,
                                 const void* v_arena, const int* table,
                                 const int* positions, void* out, float* part,
                                 int C, int H, int K, int dh, int bs,
                                 int span, int tq, int min_pages, int n_split,
                                 float sm_scale, int window,
                                 cudaStream_t stream) {
  constexpr int smem = PfSmem<T, DP>::kBytes;
  const cudaError_t err = ensure_smem<paged_prefill_split_kernel<T, DP>>(
      smem + 4 * kMaxSpan);
  if (err != cudaSuccess) return err;
  if (n_split > kMaxSplits || span > kMaxSpan) return cudaErrorInvalidValue;
  const int n_tiles = (C + tq - 1) / tq;
  paged_prefill_split_kernel<T, DP>
      <<<dim3(n_tiles, K, n_split), kPfThreads, smem + 4 * span, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_arena),
          static_cast<const T*>(v_arena), table, positions,
          static_cast<T*>(out), part, C, H, K, dh, bs, span, tq, min_pages,
          n_split, sm_scale * kLog2e, window);
  if (n_split == 1) return cudaSuccess;
  // the merge, launched as a programmatic dependent of the main kernel:
  // its CTAs start while the main kernel runs and wait for its completion
  // (griddepcontrol.wait) only before reading the partials
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * K, kPfRows / kMrgRows);
  cfg.blockDim = dim3(kMrgThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_prefill_merge_kernel<T>,
                            static_cast<const float*>(part), positions,
                            static_cast<T*>(out), C, H, K, dh, bs, span, tq,
                            min_pages, n_split, window);
}

template <typename T>
cudaError_t launch_prefill_typed(const void* q, const void* k_arena,
                                 const void* v_arena, const int* table,
                                 const int* positions, void* out, float* part,
                                 int C, int H, int K, int dh, int bs, int span,
                                 int tq, int min_pages, int n_split,
                                 float sm_scale, int window,
                                 cudaStream_t stream) {
  // the head dim padded to the tensor cores' depth of 16
#define REPRO_PAGED_PREFILL(DP)                                               \
  case DP / 16:                                                               \
    return launch_prefill_split<T, DP>(q, k_arena, v_arena, table, positions, \
                                       out, part, C, H, K, dh, bs, span, tq,  \
                                       min_pages, n_split, sm_scale, window,  \
                                       stream);
  switch ((dh + 15) / 16) {
    REPRO_PAGED_PREFILL(16)
    REPRO_PAGED_PREFILL(32)
    REPRO_PAGED_PREFILL(48)
    REPRO_PAGED_PREFILL(64)
    REPRO_PAGED_PREFILL(80)
    REPRO_PAGED_PREFILL(96)
    REPRO_PAGED_PREFILL(112)
    REPRO_PAGED_PREFILL(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_PREFILL
}

cudaError_t launch_paged_prefill(bool bf16, const void* q, const void* k_arena,
                                 const void* v_arena, const int* table,
                                 const int* positions, void* out, float* part,
                                 int C, int H, int K, int dh, int bs, int span,
                                 int tq, int min_pages, int n_split,
                                 float sm_scale, int window,
                                 cudaStream_t stream) {
  if (bf16)
    return launch_prefill_typed<__nv_bfloat16>(
        q, k_arena, v_arena, table, positions, out, part, C, H, K, dh, bs,
        span, tq, min_pages, n_split, sm_scale, window, stream);
  return launch_prefill_typed<float>(q, k_arena, v_arena, table, positions,
                                     out, part, C, H, K, dh, bs, span, tq,
                                     min_pages, n_split, sm_scale, window,
                                     stream);
}

}  // namespace repro_torch
