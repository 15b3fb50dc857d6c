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
//   (ii)  dK / dV: a CTA owns 64 keys of one KV head (one batch row) and
//         walks (query head of the group, block of 64 queries) items —
//         with causal from the block's first key on, with a window up to
//         the last key + window — recomputing S^T = K q^T and dP^T = V
//         dO^T, P^T = exp2(S^T scale log2e - lse) and dS^T = P^T o (dP^T -
//         delta) (lse and delta per column: the query), then dV += P^T dO
//         and dK += dS^T q;
//   (iii) dQ: the forward's tiling — a CTA per (tile of 64 / g queries x
//         the g heads, KV head, batch row), causal tiles heaviest first —
//         walks the visible key blocks, recomputes S = q K^T and dP = dO
//         V^T, and takes dQ += dS K.  The recompute (14 dh flops a visible
//         (query head, key) pair in all, not 10) keeps dQ free of atomics.
// Both walks are one body, flash_bwd_kernel<T, DP, kDQ>: 64 "own" rows (K
// and V for dK/dV; q and dO for dQ) staged once, 64-row "walk" blocks (q
// and dO; K and V) staged by cp.async in a ring while the last block's
// products run.  Every product runs on the tensor cores, mma.sync.m16n8k16
// with f32 accumulators (mma_tile.cuh): S^T / S and dP^T / dP read the
// walk rows by ldmatrix as the forward reads K, P and dS go from their C
// fragments straight into A fragments, as the forward's P does, and the
// walk rows are read again by ldmatrix.trans for dV, dK and dQ.  The mask
// is evaluated only on blocks that cross the diagonal, the window's edge
// or the end of the keys.  Nothing is summed across CTAs by atomics, so
// the gradient is the same bits from run to run.
//   * bf16 inputs: one product each; P and dS are rounded to bf16 before
//     their products, as the reference model path rounds P before P.V.
//   * f32 inputs: every operand — q, K, V, dO, P and dS — is split into a
//     bf16 hi / lo pair (split_bf16) and each product is hi.hi + hi.lo +
//     lo.hi, as the forward's f32 body.  q, K, V and dO are split once, by
//     flash_bwd_split_kernel into scratch (the same bytes as f32), not by
//     every CTA that stages them: the CTAs then stage hi and lo tiles as
//     bf16 inputs stage theirs, in the same two-stage ring.
//   * Warps.  bf16: four a CTA, one per 16 own rows, each taking whole
//     walk blocks; two CTAs fit an SM (103 KiB of shared memory at dh 128).
//     f32: eight, two per 16 own rows, each taking half of every walk block
//     (32 rows) — half the chain of dependent mma.sync a block — and the
//     pair's accumulators summed in shared memory at the end, the lower
//     warp's first (a fixed order).  At dh 128 a warp holds dK and dV of
//     its 16 keys (128 f32 a lane) and 64 (bf16) or 32 (f32) score
//     columns; the own rows' fragments are read from shared memory, not
//     kept in registers.
//   * A filled grid.  When b K cdiv(skv, 64) dK/dV CTAs fall short of
//     what the card holds (glm4's g = 16 over 2 KV heads: 44), the host
//     (kernels/paged_attention.py bwd_split_plan, from shapes only) gives
//     each key block n_split CTAs, for two waves: a CTA takes a contiguous
//     share of its group's (head, query block) items, heads first, and
//     writes f32 partials of dK and dV; flash_bwd_sum_kernel, in the same
//     call, sums them split by split (a fixed order) and rounds once.
// wgmma with TMA staging is later work: it waits for the forward's wgmma
// (ROADMAP B1), so that both share one set of descriptors.
//
// Bound on the H100: operations.  The gradient needs 10 dh flops per
// visible (query head, key) pair (S, dP, dV, dK, dQ).  qwen3-1.7b's 16
// heads of 128 at 4 x 1024 tokens, causal: 33.6 M pairs, 43 GFLOP: 0.043
// ms at the bf16 tensor-core peak (989 TFLOP/s), 0.130 ms for f32 inputs
// as split bf16 (989/3); its bytes (q, k, v, o, dO, lse read; dq, dk,
// dv written; 202 MB in f32, 101 MB in bf16) take 0.060 ms (0.030) at
// 3.35 TB/s.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kernels.h"
#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kBwRows = 64;       // own rows of a CTA: keys, or query rows
constexpr int kBwWalk = 64;       // rows of a walk block: queries, or keys
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory of a backward CTA at padded head dim DP: bf16 tiles of 64
// rows LB = DP + 8 elements apart (no bank read twice by ldmatrix); kParts
// tiles a row set, its hi and (f32) lo.
//   own rows [O1 hi, (O1 lo,) O2 hi, (O2 lo)]; two stages of walk rows
//   [W1 hi, (W1 lo,) W2 hi, (W2 lo)]; then lse and delta of a walk block's
//   64 queries, in two slots (dK/dV).
// After the walk the stages hold the f32 warp pairs' sum: 2 x [64][LS]
// f32, LS = DP + 4.  kBytes with BwdWarps sets how many CTAs an SM holds
// at dh 128 (f32 one, bf16 two), which the host's split planner takes
// from kernels/paged_attention.py BWD_CTAS_PER_SM; chip_smoke.py checks
// the two against flash_bwd_ctas_per_sm.
template <typename T, int DP>
struct BwdSmem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kParts = kF32 ? 2 : 1;
  static constexpr int LB = DP + 8;
  static constexpr int LS = DP + 4;
  static constexpr int kTile = kBwRows * LB * 2;            // [64][LB] bf16
  static constexpr int kOwn = 2 * kParts * kTile;
  static constexpr int kStage = 2 * kParts * kTile;
  static constexpr int kLd = 2 * 2 * kBwWalk * 4;
  static constexpr int kBytes = kOwn + 2 * kStage + kLd;
  static_assert(!kF32 || 2 * kBwRows * LS * 4 <= 2 * kStage,
                "the pairs' sum fits the stages");
};

// Warps of a backward CTA: 4 own 16 rows each and take whole walk blocks
// (bf16: two CTAs an SM); f32 doubles them, each pair of warps of a
// 16-row slice taking half of every walk block.  A change here or in
// BwdSmem changes BWD_CTAS_PER_SM (kernels/paged_attention.py).
template <typename T>
struct BwdWarps {
  static constexpr int value = std::is_same<T, float>::value ? 8 : 4;
};

// q, k, v, dO as the kernels stage them, bf16: the inputs (bf16), or
// their hi parts, with the lo parts in ql .. dol (f32)
struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout, *ql, *kl, *vl, *dol;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* part;              // dK / dV partials of the splits (n_split > 1)
  int b, sq, skv, H, K, dh, tq, n_split, causal, window, vec;
  float sm_scale;
};

// (i) delta[b, h, i] = sum_d dO[b, i, h, d] o[b, i, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int sq, int H,
                           int dh) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
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

// f32 q, k, v and dO as bf16 hi / lo pairs (split_bf16), once for all the
// CTAs that stage them; tensor blockIdx.y of four, n4 float4s each
struct BwdSplitArgs {
  const float* x[4];
  __nv_bfloat16 *hi[4], *lo[4];
  long n4[4];
};

__global__ void __launch_bounds__(256)
    flash_bwd_split_kernel(const BwdSplitArgs a) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {             // constant indices: no local copy
    if (t != (int)blockIdx.y) continue;
    const float4* x = reinterpret_cast<const float4*>(a.x[t]);
    uint2* hi = reinterpret_cast<uint2*>(a.hi[t]);
    uint2* lo = reinterpret_cast<uint2*>(a.lo[t]);
    const long n = a.n4[t], step = (long)gridDim.x * 256;
    // four loads in flight a thread
    for (long e0 = blockIdx.x * 256L + threadIdx.x; e0 < n; e0 += 4 * step) {
      float4 f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + u * step < n) f[u] = x[e0 + u * step];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e0 + u * step >= n) break;
        uint2 h, l;
        split_bf16(f[u].x, f[u].y, h.x, l.x);
        split_bf16(f[u].z, f[u].w, h.y, l.y);
        hi[e0 + u * step] = h;
        lo[e0 + u * step] = l;
      }
    }
  }
}

// visible: key kp to query qi
__device__ __forceinline__ bool visible(int qi, int kp, int skv, int causal,
                                        int window) {
  return kp < skv && (!causal || kp <= qi) && (window <= 0 || qi - kp < window);
}

// (ii) kDQ false: dK, dV of 64 keys of one KV head (a share of its walk
// when n_split > 1); (iii) kDQ true: dQ of one 64-row tile
template <typename T, int DP, bool kDQ>
__global__ void __launch_bounds__(32 * BwdWarps<T>::value,
                                  8 / BwdWarps<T>::value)
    flash_bwd_kernel(const BwdArgs a) {
  using S = BwdSmem<T, DP>;
  using bf16 = __nv_bfloat16;
  constexpr bool kF32 = S::kF32;
  constexpr int kParts = S::kParts;
  constexpr int LB = S::LB, LS = S::LS;
  constexpr int kThreads = 32 * BwdWarps<T>::value;
  constexpr int kHalves = BwdWarps<T>::value / 4;  // parts of a walk block
  constexpr int NW = kBwWalk / kHalves / 8;  // 8-wide walk tiles a warp
  constexpr int NT = DP / 8;                // 8-wide tiles of dh
  constexpr int KS = DP / 16;               // 16-deep slices of dh
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* own = reinterpret_cast<bf16*>(bsm);
  unsigned char* stage0 = bsm + S::kOwn;
  float* lds = reinterpret_cast<float*>(stage0 + 2 * S::kStage);
  const int g = a.H / a.K, dh = a.dh, sq = a.sq, skv = a.skv;
  const int causal = a.causal, window = a.window;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp & 3;                  // the warp's 16 own rows
  // its first walk row (compile-time 0 with one warp a row slice)
  const int wbase = kHalves == 2 ? (warp >> 2) * (kBwWalk / 2) : 0;
  const int gr = lane >> 2, t4 = lane & 3;  // fragment row and column pair

  // the CTA's own rows: dK/dV keys own0.., dQ queries own0.. x g heads
  int own0, kvh, bi, split = 0, nq = 0;
  if constexpr (kDQ) {
    const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    own0 = tile * a.tq;
    kvh = blockIdx.y;
    bi = blockIdx.z;
    nq = min(a.tq, sq - own0);
  } else {
    // key blocks slowest: causal blocks with the most queries start first
    int x = blockIdx.x;
    split = x % a.n_split;
    x /= a.n_split;
    kvh = x % a.K;
    x /= a.K;
    bi = x % a.b;
    own0 = (x / a.b) * kBwRows;
  }
  const int rows = kDQ ? a.tq * g : kBwRows;

  // zero the padded columns dh .. DP - 1 of the tiles (own, then both
  // stages: contiguous) once: the copies below never write them
  if (dh < DP) {
    const int pad = DP - dh;
    for (int e = tid; e < 6 * kParts * kBwRows * pad; e += kThreads)
      own[(e / pad) * LB + dh + e % pad] = __float2bfloat16(0.f);
  }

  // vec bf16 a copy: 8 (16 bytes), or 4 for rows that are not 16-byte
  // aligned
  const int vec = a.vec, nch = dh / vec;
  auto copy = [&](bf16* dst, const bf16* src, bool ok) {
    if (vec == 8)
      cp_async16(dst, src, ok);
    else
      cp_async8(dst, src, ok);
  };
  // 64 rows of two row sets, hi (and, f32, lo) each, into the tiles at
  // dst in that order; row j from offset row(j), or zeros where it is -1.
  // The sources are the kernel's parameters, read where they are used.
  auto stage_tiles = [&](bf16* dst, const bf16* h1, const bf16* l1,
                         const bf16* h2, const bf16* l2, auto row) {
    for (int e = tid; e < kBwRows * nch; e += kThreads) {
      const int j = e / nch, c = (e - j * nch) * vec;
      const long off = row(j);
      const long o = (off >= 0 ? off : 0) + c;
      bf16* d = dst + j * LB + c;
      copy(d, h1 + o, off >= 0);
      copy(d + kParts * kBwRows * LB, h2 + o, off >= 0);
      if constexpr (kF32) {
        copy(d + kBwRows * LB, l1 + o, off >= 0);
        copy(d + 3 * kBwRows * LB, l2 + o, off >= 0);
      }
    }
  };

  // own rows: dK/dV K and V of keys own0..; dQ q and dO of row r = query
  // own0 + r / g, head kvh * g + r % g
  auto own_row = [&](int j) -> long {
    if constexpr (kDQ) {
      return j < rows && j / g < nq
                 ? (((long)bi * sq + own0 + j / g) * a.H + kvh * g + j % g) *
                       dh
                 : -1;
    } else {
      return own0 + j < skv ? (((long)bi * skv + own0 + j) * a.K + kvh) * dh
                            : -1;
    }
  };
  // committed with the first walk block
  if constexpr (kDQ)
    stage_tiles(own, a.q, a.ql, a.dout, a.dol, own_row);
  else
    stage_tiles(own, a.k, a.kl, a.v, a.vl, own_row);

  // the walk.  dK/dV: items (head hh of the group, query block from qlo +
  // 64 i), head-major, this split's share [item0, item0 + n_items); dQ:
  // the visible key blocks from kb0
  int n_items, item0 = 0, nqb = 1, qlo = 0, qhi = 0, kb0 = 0;
  if constexpr (kDQ) {
    const int kv_hi = causal ? min(skv, own0 + nq) : skv;
    const int kv_lo = window > 0 ? max(own0 - window + 1, 0) : 0;
    kb0 = kv_lo / kBwWalk * kBwWalk;
    n_items = kv_hi > kb0 ? (kv_hi - kb0 + kBwWalk - 1) / kBwWalk : 0;
  } else {
    const int kmax = min(own0 + kBwRows, skv) - 1;
    qlo = causal ? own0 : 0;
    qhi = window > 0 ? min(sq, kmax + window) : sq;
    nqb = qhi > qlo ? (qhi - qlo + kBwWalk - 1) / kBwWalk : 0;
    const long total = (long)g * nqb;
    item0 = (int)(total * split / a.n_split);
    n_items = (int)(total * (split + 1) / a.n_split) - item0;
  }
  // item it: its first walk row wb and (dK/dV) its query head h
  auto item = [&](int it, int& wb, int& h) {
    if constexpr (kDQ) {
      wb = kb0 + it * kBwWalk;
      h = 0;
    } else {
      const int i = item0 + it;
      h = kvh * g + i / nqb;
      wb = qlo + (i % nqb) * kBwWalk;
    }
  };
  // walk rows of item it into stage it & 1; dK/dV: its queries' lse and
  // delta into slot it & 1 (rows past the range: zero, which with zero q
  // and dO rows adds nothing)
  auto stage_walk = [&](int it) {
    int wb, h;
    item(it, wb, h);
    bf16* dst = reinterpret_cast<bf16*>(stage0 + (it & 1) * S::kStage);
    if constexpr (kDQ) {
      stage_tiles(dst, a.k, a.kl, a.v, a.vl, [&](int j) -> long {
        return wb + j < skv ? (((long)bi * skv + wb + j) * a.K + kvh) * dh
                            : -1;
      });
    } else {
      stage_tiles(dst, a.q, a.ql, a.dout, a.dol, [&](int j) -> long {
        return wb + j < qhi ? (((long)bi * sq + wb + j) * a.H + h) * dh : -1;
      });
      if (tid < 2 * kBwWalk) {
        const int j = tid & (kBwWalk - 1);
        const bool ok = wb + j < qhi;
        const long li = ((long)bi * a.H + h) * sq + (ok ? wb + j : 0);
        cp_async4(lds + (it & 1) * 2 * kBwWalk + tid,
                  (tid < kBwWalk ? a.lse : a.delta) + li, ok);
      }
    }
  };

  // dQ: the lse (log2 units) and delta of the thread's two rows (gr, gr +
  // 8 of its warp's 16), and their queries (-1 past the tile)
  int qp[2] = {-1, -1};
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  if constexpr (kDQ) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rw * 16 + gr + 8 * hh, i = r / g;
      const bool ok = r < rows && i < nq;
      const long li = ((long)bi * a.H + kvh * g + r % g) * sq + own0 + i;
      qp[hh] = ok ? own0 + i : -1;
      lse2[hh] = ok ? a.lse[li] * kLog2e : INFINITY;
      dlt[hh] = ok ? a.delta[li] : 0.f;
    }
  }

  if (n_items > 0) stage_walk(0);
  cp_async_commit();                        // with the own rows

  // dK/dV: acc1 dV, acc2 dK; dQ: acc2 dQ — 16 own rows x DP a warp
  float acc1[kDQ ? 1 : NT][4], acc2[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc2[n][u] = 0.f;
      if constexpr (!kDQ) acc1[n][u] = 0.f;
    }
  const float sl2 = a.sm_scale * kLog2e;     // scores in log2 units
  const bf16* O1h = own;
  const bf16* O1l = own + kBwRows * LB;     // f32 only
  const bf16* O2h = own + kParts * kBwRows * LB;
  const bf16* O2l = own + 3 * kBwRows * LB; // f32 only
  const int mi = lane >> 3;                 // ldmatrix: this lane's matrix

  for (int it = 0; it < n_items; ++it) {
    int wb, h;
    item(it, wb, h);
    // this block has landed, and every warp is done with the last one:
    // its stage and lse slot may be refilled with the next block, which
    // loads while this one's products run
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_items) stage_walk(it + 1);
    cp_async_commit();
    const bf16* W1h =
        reinterpret_cast<const bf16*>(stage0 + (it & 1) * S::kStage);
    const bf16* W1l = W1h + kBwWalk * LB;   // f32 only
    const bf16* W2h = W1h + kParts * kBwWalk * LB;
    const bf16* W2l = W1h + 3 * kBwWalk * LB;   // f32 only

    // X = O1 W1^T (S^T or S) and Y = O2 W2^T (dP^T or dP): the warp's 16
    // own rows x its 32 walk rows, NW tiles of 8
    float x[NW][4], y[NW][4];
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) x[n][u] = y[n][u] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int aoff = (rw * 16 + (lane & 15)) * LB + 16 * s + (lane >> 4) * 8;
      uint32_t a1h[4], a2h[4], a1l[4], a2l[4];
      ldmatrix_x4(a1h, O1h + aoff);
      ldmatrix_x4(a2h, O2h + aoff);
      if constexpr (kF32) {
        ldmatrix_x4(a1l, O1l + aoff);
        ldmatrix_x4(a2l, O2l + aoff);
      }
#pragma unroll
      for (int n = 0; n < NW; n += 2) {
        // matrices: walk rows 8n.. / 8n+8.. x dims 16s.. / 16s+8..
        const int off = (wbase + 8 * n + (mi >> 1) * 8 + (lane & 7)) * LB +
                        16 * s + (mi & 1) * 8;
        uint32_t b1[4], b2[4];
        ldmatrix_x4(b1, W1h + off);
        ldmatrix_x4(b2, W2h + off);
        const uint32_t b10[2] = {b1[0], b1[1]}, b11[2] = {b1[2], b1[3]};
        const uint32_t b20[2] = {b2[0], b2[1]}, b21[2] = {b2[2], b2[3]};
        if constexpr (kF32) {
          uint32_t c1[4], c2[4];
          ldmatrix_x4(c1, W1l + off);
          ldmatrix_x4(c2, W2l + off);
          const uint32_t c10[2] = {c1[0], c1[1]}, c11[2] = {c1[2], c1[3]};
          const uint32_t c20[2] = {c2[0], c2[1]}, c21[2] = {c2[2], c2[3]};
          mma_bf16(x[n], a1h, c10);
          mma_bf16(x[n + 1], a1h, c11);
          mma_bf16(y[n], a2h, c20);
          mma_bf16(y[n + 1], a2h, c21);
          mma_bf16(x[n], a1l, b10);
          mma_bf16(x[n + 1], a1l, b11);
          mma_bf16(y[n], a2l, b20);
          mma_bf16(y[n + 1], a2l, b21);
        }
        mma_bf16(x[n], a1h, b10);
        mma_bf16(x[n + 1], a1h, b11);
        mma_bf16(y[n], a2h, b20);
        mma_bf16(y[n + 1], a2h, b21);
      }
    }

    // P = exp2(X scale log2e - lse), dS = P o (Y - delta); the mask only on
    // a block that crosses the diagonal, the window's edge or the end of
    // the keys.  dK/dV: lse and delta per column (query), from the slot;
    // dQ: per row, in registers
    const bool edge =
        kDQ ? (wb + kBwWalk > skv || (causal && wb + kBwWalk - 1 > own0) ||
               (window > 0 && own0 + nq - 1 - wb >= window))
            : (own0 + kBwRows > skv || (causal && own0 + kBwRows - 1 > wb) ||
               (window > 0 && wb + kBwWalk - 1 - own0 >= window));
    const float* ls = lds + (it & 1) * 2 * kBwWalk;
    // one copy of the loop with the mask and one without, chosen once a
    // block
    auto probs = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int wr = wbase + 8 * n + 2 * t4 + (e & 1);   // walk row
          float l2, dl;
          if constexpr (kDQ) {
            l2 = lse2[hh];
            dl = dlt[hh];
          } else {
            l2 = ls[wr] * kLog2e;
            dl = ls[kBwWalk + wr];
          }
          float p = exp2f(x[n][e] * sl2 - l2);
          if constexpr (decltype(masked)::value) {
            bool ok;
            if constexpr (kDQ) {
              ok = qp[hh] >= 0 &&
                   visible(qp[hh], wb + wr, skv, causal, window);
            } else {
              ok = visible(wb + wr, own0 + rw * 16 + gr + 8 * hh, skv,
                           causal, window);
            }
            p = ok ? p : 0.f;
          }
          x[n][e] = p;
          y[n][e] = p * (y[n][e] - dl);
        }
    };
    if (edge)
      probs(std::true_type{});
    else
      probs(std::false_type{});

    // dK/dV: acc1 += P W2 (dV += P^T dO), acc2 += dS W1 (dK += dS^T q);
    // dQ: acc2 += dS W1 (dQ += dS K).  P and dS from their C fragments
    // (two 8-wide tiles are the A layout of one 16-deep slice), rounded to
    // bf16 for bf16 inputs, split into hi / lo for f32; W read transposed
#pragma unroll
    for (int s = 0; s < NW / 2; ++s) {
      uint32_t ph[4], pl[4], dsh[4], dsl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = x[2 * s + (i >> 1)] + 2 * (i & 1);
        const float* d = y[2 * s + (i >> 1)] + 2 * (i & 1);
        if constexpr (kF32) {
          split_bf16(d[0], d[1], dsh[i], dsl[i]);
          if constexpr (!kDQ) split_bf16(p[0], p[1], ph[i], pl[i]);
        } else {
          dsh[i] = pack_bf16(d[0], d[1]);
          if constexpr (!kDQ) ph[i] = pack_bf16(p[0], p[1]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        // matrices: walk rows 16s.. / 16s+8.. x dims 8n.. / 8n+8..
        const int off = (wbase + 16 * s + (mi & 1) * 8 + (lane & 7)) * LB +
                        8 * n + (mi >> 1) * 8;
        if constexpr (!kDQ) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, W2h + off);
          const uint32_t f0[2] = {f[0], f[1]}, f1[2] = {f[2], f[3]};
          if constexpr (kF32) {
            uint32_t fl[4];
            ldmatrix_x4_trans(fl, W2l + off);
            const uint32_t l0[2] = {fl[0], fl[1]}, l1[2] = {fl[2], fl[3]};
            mma_bf16(acc1[n], ph, l0);
            mma_bf16(acc1[n + 1], ph, l1);
            mma_bf16(acc1[n], pl, f0);
            mma_bf16(acc1[n + 1], pl, f1);
          }
          mma_bf16(acc1[n], ph, f0);
          mma_bf16(acc1[n + 1], ph, f1);
        }
        uint32_t f[4];
        ldmatrix_x4_trans(f, W1h + off);
        const uint32_t f0[2] = {f[0], f[1]}, f1[2] = {f[2], f[3]};
        if constexpr (kF32) {
          uint32_t fl[4];
          ldmatrix_x4_trans(fl, W1l + off);
          const uint32_t l0[2] = {fl[0], fl[1]}, l1[2] = {fl[2], fl[3]};
          mma_bf16(acc2[n], dsh, l0);
          mma_bf16(acc2[n + 1], dsh, l1);
          mma_bf16(acc2[n], dsl, f0);
          mma_bf16(acc2[n + 1], dsl, f1);
        }
        mma_bf16(acc2[n], dsh, f0);
        mma_bf16(acc2[n + 1], dsh, f1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // f32: the pair's sum — the upper warp's accumulators meet the lower's
  // in the stages (read no more), lower + upper
  float* xacc = reinterpret_cast<float*>(stage0);   // [2][64][LS]
  if (kHalves == 2 && wbase > 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rw * 16 + gr + 8 * hh;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(xacc + r * LS + 8 * n + 2 * t4) =
            make_float2(acc2[n][2 * hh], acc2[n][2 * hh + 1]);
        if constexpr (!kDQ)
          *reinterpret_cast<float2*>(xacc + (kBwRows + r) * LS + 8 * n +
                                     2 * t4) =
              make_float2(acc1[n][2 * hh], acc1[n][2 * hh + 1]);
      }
    }
  }
  if constexpr (kHalves == 2) {
    __syncthreads();
    if (wbase > 0) return;
  }

  const long numel_k = (long)a.b * skv * a.K * dh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rw * 16 + gr + 8 * hh;
    long off;                               // the row's first element
    if constexpr (kDQ) {
      if (qp[hh] < 0) continue;
      off = (((long)bi * sq + qp[hh]) * a.H + kvh * g + r % g) * dh;
    } else {
      if (own0 + r >= skv) continue;
      off = (((long)bi * skv + own0 + r) * a.K + kvh) * dh;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d >= dh) continue;
      float g0 = acc2[n][2 * hh], g1 = acc2[n][2 * hh + 1];
      float v0 = 0.f, v1 = 0.f;
      if constexpr (!kDQ) {
        v0 = acc1[n][2 * hh];
        v1 = acc1[n][2 * hh + 1];
      }
      if constexpr (kHalves == 2) {
        const float2 x2 =
            *reinterpret_cast<const float2*>(xacc + r * LS + d);
        g0 += x2.x;
        g1 += x2.y;
        if constexpr (!kDQ) {
          const float2 y2 = *reinterpret_cast<const float2*>(
              xacc + (kBwRows + r) * LS + d);
          v0 += y2.x;
          v1 += y2.y;
        }
      }
      g0 *= a.sm_scale;
      g1 *= a.sm_scale;
      if (!kDQ && a.n_split > 1) {
        // f32 partials, split s's dK then dV, each laid out as dk
        float* pk = a.part + 2 * split * numel_k + off + d;
        *reinterpret_cast<float2*>(pk) = make_float2(g0, g1);
        *reinterpret_cast<float2*>(pk + numel_k) = make_float2(v0, v1);
        continue;
      }
      T* dst = static_cast<T*>(kDQ ? a.dq : a.dk) + off + d;
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(dst) = make_float2(g0, g1);
        if constexpr (!kDQ)
          *reinterpret_cast<float2*>(static_cast<T*>(a.dv) + off + d) =
              make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(g0, g1);
        if constexpr (!kDQ)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(a.dv) + off +
                                             d) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// the splits' dK / dV partials summed split by split (a fixed order, so
// the same bits whichever CTA finished first) and rounded once; four
// elements a thread (dh % 4 == 0)
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dk,
                         T* __restrict__ dv, long n4, int n_split) {
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (long e = blockIdx.x * 256L + threadIdx.x; e < n4;
       e += (long)gridDim.x * 256) {
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int s = 0; s < n_split; ++s) {
      const float4 a = p4[2 * s * n4 + e], b = p4[(2 * s + 1) * n4 + e];
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += b.x; sv.y += b.y; sv.z += b.z; sv.w += b.w;
    }
    if constexpr (std::is_same<T, float>::value) {
      reinterpret_cast<float4*>(dk)[e] = sk;
      reinterpret_cast<float4*>(dv)[e] = sv;
    } else {
      __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * e;
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * e;
      k2[0] = __floats2bfloat162_rn(sk.x, sk.y);
      k2[1] = __floats2bfloat162_rn(sk.z, sk.w);
      v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
      v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
    }
  }
}

template <typename T, int DP>
cudaError_t launch_flash_bwd_typed(const BwdArgs& a, const void* out,
                                   const void* dout, float* delta,
                                   cudaStream_t stream) {
  constexpr int smem = BwdSmem<T, DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, DP, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_kernel<T, DP, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int rows = a.b * a.sq * a.H;
  flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows,
      a.sq, a.H, a.dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nkb = (a.skv + kBwRows - 1) / kBwRows;
  flash_bwd_kernel<T, DP, false>
      <<<nkb * a.K * a.b * a.n_split, 32 * BwdWarps<T>::value, smem,
         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.n_split > 1) {
    const long n4 = (long)a.b * a.skv * a.K * a.dh / 4;
    const long want = (n4 + 255) / 256;
    flash_bwd_sum_kernel<T><<<(int)(want < 2048 ? want : 2048), 256, 0,
                               stream>>>(
        a.part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n4,
        a.n_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_kernel<T, DP, true>
      <<<dim3((a.sq + a.tq - 1) / a.tq, a.K, a.b), 32 * BwdWarps<T>::value,
         smem, stream>>>(a);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_flash_bwd_dp(const BwdArgs& a, const void* out,
                                const void* dout, float* delta,
                                cudaStream_t stream) {
  // the head dim padded to the tensor cores' depth of 16
#define REPRO_FLASH_BWD(DP) \
  case DP / 16:             \
    return launch_flash_bwd_typed<T, DP>(a, out, dout, delta, stream);
  switch ((a.dh + 15) / 16) {
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

// CTAs of the dK/dV walk that an SM holds at padded head dim DP
template <typename T, int DP>
cudaError_t flash_bwd_ctas_per_sm_typed(int* n) {
  constexpr int smem = BwdSmem<T, DP>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, DP, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, flash_bwd_kernel<T, DP, false>, 32 * BwdWarps<T>::value, smem);
}

template <typename T>
cudaError_t flash_bwd_ctas_per_sm_dp(int dh, int* n) {
#define REPRO_FLASH_BWD(DP) \
  case DP / 16:             \
    return flash_bwd_ctas_per_sm_typed<T, DP>(n);
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

cudaError_t flash_bwd_ctas_per_sm(bool bf16, int dh, int* n) {
  if (bf16) return flash_bwd_ctas_per_sm_dp<__nv_bfloat16>(dh, n);
  return flash_bwd_ctas_per_sm_dp<float>(dh, n);
}

cudaError_t launch_flash_bwd(bool bf16, const void* q, const void* k,
                             const void* v, const void* out, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, float* scratch, int b,
                             int sq, int skv, int H, int K, int dh, int tq,
                             int n_split, bool causal, int window,
                             float sm_scale, cudaStream_t stream) {
  using bfp = const __nv_bfloat16*;
  if (n_split < 1 || ((n_split > 1 || !bf16) && scratch == nullptr))
    return cudaErrorInvalidValue;
  const long nq = (long)b * sq * H * dh, nk = (long)b * skv * K * dh;
  BwdArgs a;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  // the splits' partials first, then (f32) q, k, v and dO as hi / lo
  a.part = scratch;
  if (bf16) {
    a.q = static_cast<bfp>(q);
    a.k = static_cast<bfp>(k);
    a.v = static_cast<bfp>(v);
    a.dout = static_cast<bfp>(dout);
    a.ql = a.kl = a.vl = a.dol = nullptr;
  } else {
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(
        scratch + (n_split > 1 ? 2 * n_split * nk : 0));
    BwdSplitArgs sp;
    const void* x[4] = {q, k, v, dout};
    const long n[4] = {nq, nk, nk, nq};
    long most = 0;
    for (int t = 0; t < 4; ++t) {
      sp.x[t] = static_cast<const float*>(x[t]);
      sp.hi[t] = p;
      sp.lo[t] = p + n[t];
      sp.n4[t] = n[t] / 4;
      p += 2 * n[t];
      most = n[t] / 4 > most ? n[t] / 4 : most;
    }
    const long want = (most + 255) / 256;
    flash_bwd_split_kernel<<<dim3((int)(want < 1024 ? want : 1024), 4), 256,
                             0, stream>>>(sp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.q = sp.hi[0];
    a.k = sp.hi[1];
    a.v = sp.hi[2];
    a.dout = sp.hi[3];
    a.ql = sp.lo[0];
    a.kl = sp.lo[1];
    a.vl = sp.lo[2];
    a.dol = sp.lo[3];
  }
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.H = H;
  a.K = K;
  a.dh = dh;
  a.tq = tq;
  a.n_split = n_split;
  a.causal = causal ? 1 : 0;
  a.window = window;
  a.sm_scale = sm_scale;
  // 16-byte copies where every staged row start is 16-byte aligned, else
  // 8-byte copies of 4 bf16 (the wrapper takes dh % 4 == 0)
  const bfp staged[8] = {a.q, a.k, a.v, a.dout, a.ql, a.kl, a.vl, a.dol};
  uintptr_t bits = 0;
  for (bfp t : staged) bits |= reinterpret_cast<uintptr_t>(t);
  a.vec = dh % 8 == 0 && (bits & 15) == 0 ? 8 : 4;
  if (bf16)
    return launch_flash_bwd_dp<__nv_bfloat16>(a, out, dout, delta, stream);
  return launch_flash_bwd_dp<float>(a, out, dout, delta, stream);
}

}  // namespace repro_torch
