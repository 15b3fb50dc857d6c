// Contiguous flash attention for Hopper (sm_90a).  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention, body
// _flash_kernel), which tiles a contiguous K/V over a (batch, kv-head,
// q-block, kv-block) grid with the kv-block axis sequential, and runs fully
// masked blocks.  (Its paged chunked-prefill form is paged_prefill.cu.)
//
// Contiguous prefill: a whole prompt, q (b, sq, H, dh) against k, v
// (b, skv, K, dh), causal on positions from 0 (q_pos >= kv_pos,
// src/repro/models/layers.py blocked_attention with q_offset 0) or full,
// with the sliding window when window > 0 — the slotted engine's prefill
// (f32) and the hybrid forward (bf16, and f32 in its f32 replay).
//
// Bound on the H100: operations — 4 dh flops per visible (query head, key)
// pair.  At the hybrid forward's 4 x 4096 tokens, 32 heads of 80, causal:
// 344 GFLOP, 0.348 ms at the bf16 tensor-core peak (989 TFLOP/s), against
// 335 MB of q, k, v and out (0.100 ms at 3.35 TB/s).  f32 inputs are
// multiplied as split bf16 pairs (three bf16 products for each f32 one),
// so their bound is the work at 989/3 TFLOP/s: qwen3's 1024-token slotted
// prefill, 16 heads of 128, 4.3 GFLOP, 13 us (64 us at the CUDA cores' 67
// TFLOP/s, the rate the previous f32 body was held to).
//
// Design: one body (flash_tc_kernel<T, DP>) for both input types.
//   * Tiles.  One CTA per (tile of kFaRows = 64 query rows — 64 / g
//     queries x g heads —, KV head, batch row); 4 warps own 16 rows each.
//     Causal tiles are taken heaviest first (the last queries see the most
//     keys), so the card's last wave is of short tiles.  The CTA walks K/V
//     blocks of kFaKeys = 64 positions; blocks past the tile's last query
//     (causal) or before its window are skipped — the Pallas kernel runs
//     them — and the mask is evaluated only on the blocks that cross the
//     diagonal, the window's edge or the end of the keys.
//   * Products on the tensor cores: S = q k^T and P . V as
//     mma.sync.m16n8k16 with f32 accumulators; the online softmax (max,
//     rescale, row sums; scores in log2 units) stays f32 in registers,
//     reduced over the 4 lanes that share a row, and P goes from the score
//     fragments (their C layout is the A layout of P . V) straight into
//     registers.
//       - bf16 inputs: q's fragments stay in registers; K and V blocks are
//         staged by cp.async into a ring of two stages, so the next block
//         loads while this one's products run; one product each, P rounded
//         to bf16 — the reference model path's own rounding (layers.py
//         blocked_attention, p.astype(v.dtype)) — and V read with
//         ldmatrix.trans.
//       - f32 inputs: every operand — q, K, V and P — is split into a bf16
//         pair (split_bf16) and each product is hi.hi + hi.lo + lo.hi,
//         keeping ~16 bits of each f32 operand (a single bf16 rounding
//         would not hold f32's 1e-4).  The layout and the helpers are the
//         paged prefill's (mma_tile.cuh TileSmem, split_rows,
//         split_frag_a): one f32 stage of K and V, filled by cp.async, is
//         split once per block into bf16 hi / lo tiles read by ldmatrix,
//         then refilled with the next block while this one's products run;
//         q is split at the fragment.  Three products make a block's chain
//         of dependent mma.sync three times the bf16 one, and a causal
//         prompt's time is that of its last tile's blocks in a row (the
//         grid of a 1024-token prompt fits the card at once).  So the f32
//         CTA has 8 warps: two per 16 rows, each scoring half of every
//         block's keys with its own online softmax, the two halves' states
//         merged in shared memory at the end — half the chain per block,
//         and the split shared by 256 threads.
//   * The head dim is padded to a multiple of 16 with zeros in shared
//     memory (one instantiation per padded width, 16 .. 128).  mma.sync
//     rather than wgmma: a warp's 16 rows and its softmax state stay in one
//     warp's registers without warpgroup-wide shared-memory descriptors;
//     wgmma is later work.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kernels.h"
#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kFaRows = 64;       // query rows per CTA (queries x group heads)
constexpr int kFaKeys = 64;       // key positions per staged K/V block

// Warps of a CTA: 4 own 16 rows each (bf16); f32 doubles them, each pair of
// warps of a 16-row slice splitting a block's keys in halves
template <typename T>
struct FaWarps {
  static constexpr int value = std::is_same<T, float>::value ? 8 : 4;
};

template <typename T, int DP>
__global__ void __launch_bounds__(32 * FaWarps<T>::value)
    flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int sq,
                    int skv, int H, int K, int dh, int tq, int causal,
                    int window, float sm_scale, int vec) {
  using S = TileSmem<T, DP, kFaRows, kFaKeys>;
  using bf16 = __nv_bfloat16;
  constexpr bool kF32 = S::kF32;
  constexpr int LB = S::LB, LS = S::LS;
  constexpr int kThreads = 32 * FaWarps<T>::value;
  constexpr int kHalves = FaWarps<T>::value / 4;   // parts of a block's keys
  constexpr int NK = 8 / kHalves;           // 8-key tiles a warp scores
  constexpr int NT = DP / 8;                // 8-wide tiles of the output
  constexpr int KS = DP / 16;               // 16-deep slices of q . k
  extern __shared__ __align__(16) unsigned char fsm[];
  T* Qs = reinterpret_cast<T*>(fsm);                    // [kFaRows][LB]
  unsigned char* stage0 = fsm + S::kQ;                  // staged K, V
  // f32: the split hi / lo of the staged K and V, which the products read
  bf16* KVsplit = reinterpret_cast<bf16*>(stage0 + S::kStage);
  const int g = H / K, rows = tq * g;
  // causal tiles heaviest first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * tq, kvh = blockIdx.y, bi = blockIdx.z;
  const int nq = min(tq, sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warp's 16 rows, and its first key of each block (compile-time 0
  // with one warp a row slice: a runtime offset in the ldmatrix addresses
  // made the bf16 body slower on the H100)
  const int rw = kHalves == 2 ? warp & 3 : warp;
  const int key0 = kHalves == 2 ? (warp >> 2) * 8 * NK : 0;
  const int gr = lane >> 2, t4 = lane & 3;  // fragment row and column pair

  // zero the padded columns dh .. DP - 1 once: the copies below never
  // write them
  if (dh < DP) {
    const int pad = DP - dh;
    for (int e = tid; e < kFaRows * pad; e += kThreads)
      Qs[(e / pad) * LB + dh + e % pad] = from_float<T>(0.f);
    // bf16: K, V of two stages; f32: K hi, K lo, V hi, V lo
    bf16* kv = kF32 ? KVsplit : reinterpret_cast<bf16*>(stage0);
    for (int e = tid; e < 4 * kFaKeys * pad; e += kThreads)
      kv[(e / pad) * LB + dh + e % pad] = __float2bfloat16(0.f);
  }
  // vec elements a copy: 16 bytes, or 8 for bf16 rows that are not
  // 16-byte aligned
  auto copy = [&](T* dst, const T* src, bool ok) {
    if (vec * (int)sizeof(T) == 16)
      cp_async16(dst, src, ok);
    else
      cp_async8(dst, src, ok);
  };
  const int nch = dh / vec;                 // copies per row
  // the tile's q rows: row r is query q0 + r / g, head kvh * g + r % g
  for (int e = tid; e < kFaRows * nch; e += kThreads) {
    const int r = e / nch, c = (e % nch) * vec, i = r / g;
    const bool ok = r < rows && i < nq;
    copy(Qs + r * LB + c,
         q + (((long)bi * sq + (ok ? q0 + i : 0)) * H + kvh * g + r % g) * dh +
             c,
         ok);
  }
  // K and V rows kb .. kb + 63 into stage st (f32: the one stage); rows at
  // or past skv are zero
  auto stage_kv = [&](int st, int kb) {
    constexpr int L = kF32 ? LS : LB;
    T* Ks = reinterpret_cast<T*>(stage0 + st * S::kStage);
    T* Vs = Ks + kFaKeys * L;
    for (int e = tid; e < kFaKeys * nch; e += kThreads) {
      const int j = e / nch, c = (e % nch) * vec, pos = kb + j;
      const bool ok = pos < skv;
      const long off = (((long)bi * skv + (ok ? pos : 0)) * K + kvh) * dh + c;
      copy(Ks + j * L + c, k + off, ok);
      copy(Vs + j * L + c, v + off, ok);
    }
  };

  // query position of the thread's two rows (gr and gr + 8 of its warp's
  // 16), -1 for a row past the tile
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + gr + 8 * h, i = r / g;
    qp[h] = r < rows && i < nq ? q0 + i : -1;
  }
  const int qmin = q0, qmax = q0 + nq - 1;
  // visible key range of the tile: [kv_lo, kv_hi), in blocks of kFaKeys
  const int kv_hi = causal ? min(skv, q0 + nq) : skv;
  const int kv_lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int kb0 = kv_lo / kFaKeys * kFaKeys;
  const int nblk = kv_hi > kb0 ? (kv_hi - kb0 + kFaKeys - 1) / kFaKeys : 0;
  const float sl2 = sm_scale * 1.4426950408889634f;   // scores in log2 units

  if (nblk > 0) stage_kv(0, kb0);
  cp_async_commit();                        // group 0: q and the first block

  uint32_t qf[kF32 ? 1 : KS][4];            // bf16: q's fragments
  float acc[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;

  for (int it = 0; it < nblk; ++it) {
    const int kb = kb0 + it * kFaKeys;
    const bf16 *Kh, *Kl, *Vh, *Vl;
    if constexpr (kF32) {
      // stage -> hi / lo, then refill the stage with the next block while
      // this one's products run
      cp_async_wait<0>();
      __syncthreads();
      split_rows<kFaKeys, LS, LB>(reinterpret_cast<const float*>(stage0),
                                  KVsplit, 2 * kFaKeys, dh, kThreads);
      __syncthreads();
      if (it + 1 < nblk) stage_kv(0, kb + kFaKeys);
      cp_async_commit();
      Kh = KVsplit;
      Kl = Kh + kFaKeys * LB;
      Vh = Kl + kFaKeys * LB;
      Vl = Vh + kFaKeys * LB;
    } else {
      if (it + 1 < nblk) stage_kv((it + 1) & 1, kb + kFaKeys);
      cp_async_commit();                    // the next block loads meanwhile
      cp_async_wait<1>();
      __syncthreads();
      if (it == 0) {                        // q fragments, kept in registers
#pragma unroll
        for (int s = 0; s < KS; ++s)
          ldmatrix_x4(qf[s], Qs + (rw * 16 + (lane & 15)) * LB + 16 * s +
                                 (lane >> 4) * 8);
      }
      Kh = reinterpret_cast<const bf16*>(stage0 + (it & 1) * S::kStage);
      Vh = Kh + kFaKeys * LB;
      Kl = Vl = nullptr;
    }

    // S = q k^T: 16 rows x 8 NK keys per warp, NK tiles of 8 keys
    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[n][u] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t qh[4], ql[4];
      if constexpr (kF32) {
        split_frag_a(reinterpret_cast<const float*>(Qs), LB, rw * 16, 16 * s,
                     qh, ql);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qh[i] = qf[s][i];
      }
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        // matrices: keys 8n.. / 8n+8.. x dims 16s.. / 16s+8..
        const int mi = lane >> 3;
        const int off = (key0 + 8 * n + (mi >> 1) * 8 + (lane & 7)) * LB +
                        16 * s + (mi & 1) * 8;
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
    // the end of the keys
    const bool edge = kb + kFaKeys > skv || (causal && kb + kFaKeys - 1 > qmin) ||
                      (window > 0 && qmax - kb >= window);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float x = sc[n][2 * h + u] * sl2;
          if (edge) {
            const int kp = kb + key0 + 8 * n + 2 * t4 + u;
            const bool ok = qp[h] >= 0 && kp < skv &&
                            (!causal || kp <= qp[h]) &&
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
      for (int n = 0; n < NK; ++n)
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
    // tiles is the A layout of one 16-key slice): rounded to bf16 for bf16
    // inputs, split into hi / lo for f32
#pragma unroll
    for (int s = 0; s < NK / 2; ++s) {
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
        const int off = (key0 + 16 * s + (mi & 1) * 8 + (lane & 7)) * LB +
                        8 * n + (mi >> 1) * 8;
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

  // the row sums over the 4 lanes of a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (kHalves == 2) {
    // the second half's (acc, m, l) meet the first's through shared memory
    // (the staged K / V are read no more): M = max(m0, m1), each weighted
    // 2^(m - M), exactly 0 where m is -inf
    float* xacc = reinterpret_cast<float*>(stage0);       // [kFaRows][LB]
    float* xm = xacc + kFaRows * LB;                      // [kFaRows]
    float* xl = xm + kFaRows;                             // [kFaRows]
    __syncthreads();
    if (key0 > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw * 16 + gr + 8 * h;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(xacc + r * LB + 8 * n + 2 * t4) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        if (t4 == 0) {
          xm[r] = m[h];
          xl[r] = l[h];
        }
      }
    }
    __syncthreads();
    if (key0 > 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw * 16 + gr + 8 * h;
      const float m1 = xm[r], M = fmaxf(m[h], m1);
      const float base = M == -INFINITY ? 0.f : M;
      const float c0 = exp2f(m[h] - base), c1 = exp2f(m1 - base);
      l[h] = l[h] * c0 + xl[r] * c1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 a =
            *reinterpret_cast<const float2*>(xacc + r * LB + 8 * n + 2 * t4);
        acc[n][2 * h] = acc[n][2 * h] * c0 + a.x * c1;
        acc[n][2 * h + 1] = acc[n][2 * h + 1] * c0 + a.y * c1;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qp[h] < 0) continue;
    const int r = rw * 16 + gr + 8 * h;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    T* o = out + (((long)bi * sq + qp[h]) * H + kvh * g + r % g) * dh;
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
  }
}

template <typename T, int DP>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v,
                            void* out, int b, int sq, int skv, int H, int K,
                            int dh, int tq, bool causal, int window,
                            float sm_scale, cudaStream_t stream) {
  constexpr int smem = TileSmem<T, DP, kFaRows, kFaKeys>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies where every row start is 16-byte aligned (always for
  // f32: the wrapper takes dh % 4 == 0 and 16-byte aligned tensors), else
  // 8-byte copies of 4 bf16
  const bool wide = dh * (int)sizeof(T) % 16 == 0 &&
                    ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((sq + tq - 1) / tq, K, b);
  flash_tc_kernel<T, DP><<<grid, 32 * FaWarps<T>::value, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, H, K, dh, tq,
      causal ? 1 : 0, window, sm_scale, (wide ? 16 : 8) / (int)sizeof(T));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_flash_typed(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv, int H,
                               int K, int dh, int tq, bool causal, int window,
                               float sm_scale, cudaStream_t stream) {
  // the head dim padded to the tensor cores' depth of 16
#define REPRO_FLASH(DP)                                                       \
  case DP / 16:                                                               \
    return launch_flash_tc<T, DP>(q, k, v, out, b, sq, skv, H, K, dh, tq,     \
                                  causal, window, sm_scale, stream);
  switch ((dh + 15) / 16) {
    REPRO_FLASH(16)
    REPRO_FLASH(32)
    REPRO_FLASH(48)
    REPRO_FLASH(64)
    REPRO_FLASH(80)
    REPRO_FLASH(96)
    REPRO_FLASH(112)
    REPRO_FLASH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH
}

cudaError_t launch_flash(bool bf16, const void* q, const void* k,
                         const void* v, void* out, int b, int sq, int skv,
                         int H, int K, int dh, int tq, bool causal, int window,
                         float sm_scale, cudaStream_t stream) {
  if (bf16)
    return launch_flash_typed<__nv_bfloat16>(q, k, v, out, b, sq, skv, H, K,
                                             dh, tq, causal, window, sm_scale,
                                             stream);
  return launch_flash_typed<float>(q, k, v, out, b, sq, skv, H, K, dh, tq,
                                   causal, window, sm_scale, stream);
}

}  // namespace repro_torch
