// Contiguous flash attention for Hopper (sm_90a).  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention, body
// _flash_kernel), which tiles a contiguous K/V over a (batch, kv-head,
// q-block, kv-block) grid with the kv-block axis sequential, and runs fully
// masked blocks.  (Its paged chunked-prefill form is paged_prefill.cu.)
//
// Contiguous prefill: a whole prompt, q (b, sq, H, dh) against k, v
//    (b, skv, K, dh), causal on positions from 0 (q_pos >= kv_pos,
//    src/repro/models/layers.py blocked_attention with q_offset 0) or
//    full, with the sliding window when window > 0.  One CTA per (tile of
//    kFaRows = 64 query rows — 64 / g queries x g heads —, KV head, batch
//    row) walks K/V blocks of kFaKeys = 64 positions; blocks past the
//    tile's last query (causal) or before its window are skipped — the
//    Pallas kernel runs them — and the mask is evaluated only on the
//    blocks that cross the diagonal, the window's edge or the end of the
//    keys.  Two bodies, chosen by the dtype alone:
//    * bf16 (flash_bf16_kernel): tensor cores, mma.sync.m16n8k16 with
//      bf16 operands and f32 accumulators; each of 4 warps owns 16 rows.
//      q's fragments stay in registers; K and V blocks are staged by
//      cp.async into a ring of two stages, so the next block loads while
//      this one's products run.  S = q k^T for 64 keys is 8 accumulator
//      tiles; the online softmax (max, rescale, row sums) stays f32 in
//      registers, reduced over the 4 lanes that share a row; P is rounded
//      to bf16 straight from the accumulator fragments (their C layout is
//      the A layout of P . V) — the reference model path's own rounding
//      (layers.py blocked_attention, p.astype(v.dtype)) — and P . V reads
//      V with ldmatrix.trans.  The head dim is padded to a multiple of 16
//      with zeros in shared memory (one instantiation per padded width,
//      16 .. 128); rows are dh + 8 elements apart, an odd number of
//      16-byte units, so ldmatrix reads no bank twice.  mma.sync rather
//      than wgmma: a warp's 16 rows and its softmax state stay in one
//      warp's registers without warpgroup-wide shared-memory descriptors;
//      wgmma is later work.
//    * f32 (flash_f32_kernel): CUDA cores, the reference's precision for
//      the slotted engine.  Each of 256 threads owns a 4 x 4 tile of
//      scores and 4 rows x 8 dims of the output; K/V blocks are staged
//      synchronously (widened once) and reused by all 64 rows.
//    Bound on the H100: operations — 4 dh flops per visible (query head,
//    key) pair.  At the hybrid forward's 4 x 4096 tokens, 32 heads of 80,
//    causal: 344 GFLOP, 0.348 ms at the bf16 tensor-core peak (989
//    TFLOP/s), against 335 MB of q, k, v and out (0.100 ms at 3.35 TB/s);
//    in f32 the CUDA cores' 67 TFLOP/s bound it (qwen3's 1024 tokens, 16
//    heads of 128: 4.3 GFLOP, 64 us).
#include <math.h>
#include <stdint.h>

#include "kernels.h"
#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kFaRows = 64;       // query rows per CTA (queries x group heads)
constexpr int kFaKeys = 64;       // key positions per staged K/V block
constexpr int kFaThreads = 256;   // 16 x 16 threads: ty owns rows, tx keys/dims

// Shared memory of a CTA: q rows and V rows padded to dh + 4 floats, and
// the K block, whose space then holds the probabilities [kFaRows][kFaKeys+4].
__host__ __device__ inline int flash_smem_bytes(int dh) {
  const int ds = dh + 4;
  const int kp = kFaKeys * ds > kFaRows * (kFaKeys + 4) ? kFaKeys * ds
                                                        : kFaRows * (kFaKeys + 4);
  return 4 * (kFaRows * ds + kp + kFaKeys * ds);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kFaThreads, 2)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int sq, int skv, int H, int K, int dh, int tq,
                     int causal, int window, float sm_scale) {
  extern __shared__ __align__(16) float fsm[];
  const int g = H / K, rows = tq * g;
  const int q0 = blockIdx.x * tq, kvh = blockIdx.y, bi = blockIdx.z;
  const int nq = min(tq, sq - q0);
  const int ds = dh + 4, d4 = dh >> 2, ps = kFaKeys + 4;
  float* Qs = fsm;                                   // [kFaRows][ds]
  float* Ks = Qs + kFaRows * ds;                     // [kFaKeys][ds]
  float* Ps = Ks;                                    // [kFaRows][ps], later
  float* Vs = Ks + max(kFaKeys * ds, kFaRows * ps);  // [kFaKeys][ds]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // the tile's q rows: row r is query q0 + r / g, head kvh * g + r % g
  for (int e = tid; e < kFaRows * d4; e += kFaThreads) {
    const int r = e / d4, d = (e % d4) * 4, i = r / g;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && i < nq)
      x = load4(q + (((long)bi * sq + q0 + i) * H + kvh * g + r % g) * dh + d);
    *reinterpret_cast<float4*>(Qs + r * ds + d) = x;
  }

  int rq[4];                     // query position of each owned row, -1 dead
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = r / g;
    rq[a] = r < rows && i < nq ? q0 + i : -1;
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  }

  // visible key range of the tile: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(skv, q0 + nq) : skv;
  const int kv_lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  for (int kb = kv_lo / kFaKeys * kFaKeys; kb < kv_hi; kb += kFaKeys) {
    __syncthreads();             // the last block's P and V are consumed
    for (int e = tid; e < kFaKeys * d4; e += kFaThreads) {
      const int j = e / d4, d = (e % d4) * 4, pos = kb + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (pos < skv) {
        const long off = (((long)bi * skv + pos) * K + kvh) * dh + d;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      *reinterpret_cast<float4*>(Ks + j * ds + d) = kx;
      *reinterpret_cast<float4*>(Vs + j * ds + d) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int d = 0; d < dh; d += 4) {
      float4 qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * ds + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kc[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * ds + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += dot4(qa[a], kc[c]);
    }

    // mask, then fold the block into each row's online softmax
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = kb + tx + 16 * c;
        const bool ok = rq[a] >= 0 && kpos < skv &&
                        (!causal || kpos <= rq[a]) &&
                        (window <= 0 || rq[a] - kpos < window);
        s[a][c] = ok ? s[a][c] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], group16_max(mx));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = m_new == -INFINITY ? 0.f : expf(s[a][c] - m_new);
        psum += s[a][c];
      }
      l[a] = l[a] * alpha + group16_sum(psum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();             // every thread is done reading the K block
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty + 16 * a) * ps + tx + 16 * c] = s[a][c];
    __syncthreads();

    // acc += P V: dims 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3
    const bool lo = 4 * tx < dh, hi = 64 + 4 * tx < dh;
    for (int j = 0; j < kFaKeys; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * a) * ps + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vs + (j + u) * ds;
        const float4 v0 = lo ? *reinterpret_cast<const float4*>(vr + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v1 = hi ? *reinterpret_cast<const float4*>(vr + 64 + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = u == 0 ? pa[a].x : u == 1 ? pa[a].y
                        : u == 2 ? pa[a].z : pa[a].w;
          acc[a][0] += p * v0.x;
          acc[a][1] += p * v0.y;
          acc[a][2] += p * v0.z;
          acc[a][3] += p * v0.w;
          acc[a][4] += p * v1.x;
          acc[a][5] += p * v1.y;
          acc[a][6] += p * v1.z;
          acc[a][7] += p * v1.w;
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (rq[a] < 0) continue;
    const int r = ty + 16 * a;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
    float* o = out + (((long)bi * sq + rq[a]) * H + kvh * g + r % g) * dh;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = (c < 4 ? 4 * tx : 64 + 4 * tx) + (c & 3);
      if (d < dh) o[d] = acc[a][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body (tensor cores, mma.sync.m16n8k16)
// ---------------------------------------------------------------------------
constexpr int kFbWarps = 4;                 // a warp owns 16 of the 64 rows
constexpr int kFbThreads = 32 * kFbWarps;

// Shared memory (bf16) of the tensor-core body at padded head dim DP: the
// tile's q rows and two stages of the K and V blocks, each row DP + 8
// elements long (an odd number of 16-byte units: ldmatrix reads of 8 rows
// hit 8 distinct bank groups).
__host__ __device__ constexpr int flash_bf16_smem_bytes(int DP) {
  return 2 * (DP + 8) * (kFaRows + 2 * 2 * kFaKeys);
}

template <int DP>
__global__ void __launch_bounds__(kFbThreads)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int sq, int skv, int H,
                      int K, int dh, int tq, int causal, int window,
                      float sm_scale, int vec) {
  constexpr int LD = DP + 8;                // row stride in elements
  constexpr int NT = DP / 8;                // 8-wide tiles of the output
  constexpr int KS = DP / 16;               // 16-deep slices of q . k
  extern __shared__ __align__(16) __nv_bfloat16 fbs[];
  __nv_bfloat16* Qs = fbs;                                // [kFaRows][LD]
  __nv_bfloat16* KVs = Qs + kFaRows * LD;                 // [2][K, V][kFaKeys][LD]
  const int g = H / K, rows = tq * g;
  const int q0 = blockIdx.x * tq, kvh = blockIdx.y, bi = blockIdx.z;
  const int nq = min(tq, sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;  // fragment row and column pair

  // zero the padded columns dh .. DP - 1 of every row once: the copies
  // below never write them
  if (dh < DP) {
    const int pad = DP - dh;
    for (int e = tid; e < (kFaRows + 4 * kFaKeys) * pad; e += kFbThreads)
      Qs[(e / pad) * LD + dh + e % pad] = __float2bfloat16(0.f);
  }
  const int nch = dh / vec;                 // copies per row
  // the tile's q rows: row r is query q0 + r / g, head kvh * g + r % g
  for (int e = tid; e < kFaRows * nch; e += kFbThreads) {
    const int r = e / nch, c = (e % nch) * vec, i = r / g;
    const bool ok = r < rows && i < nq;
    const __nv_bfloat16* src =
        q + (((long)bi * sq + (ok ? q0 + i : 0)) * H + kvh * g + r % g) * dh + c;
    if (vec == 8)
      cp_async16(Qs + r * LD + c, src, ok);
    else
      cp_async8(Qs + r * LD + c, src, ok);
  }
  // K and V rows kb .. kb + 63 into stage st; rows at or past skv are zero
  auto stage_kv = [&](int st, int kb) {
    __nv_bfloat16* Ks = KVs + st * 2 * kFaKeys * LD;
    __nv_bfloat16* Vs = Ks + kFaKeys * LD;
    for (int e = tid; e < kFaKeys * nch; e += kFbThreads) {
      const int j = e / nch, c = (e % nch) * vec, pos = kb + j;
      const bool ok = pos < skv;
      const long off = (((long)bi * skv + (ok ? pos : 0)) * K + kvh) * dh + c;
      if (vec == 8) {
        cp_async16(Ks + j * LD + c, k + off, ok);
        cp_async16(Vs + j * LD + c, v + off, ok);
      } else {
        cp_async8(Ks + j * LD + c, k + off, ok);
        cp_async8(Vs + j * LD + c, v + off, ok);
      }
    }
  };

  // query position of the thread's two rows (gr and gr + 8 of its warp's
  // 16), -1 for a row past the tile
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gr + 8 * h, i = r / g;
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

  uint32_t qf[KS][4];
  float acc[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;

  for (int it = 0; it < nblk; ++it) {
    const int kb = kb0 + it * kFaKeys;
    if (it + 1 < nblk) stage_kv((it + 1) & 1, kb + kFaKeys);
    cp_async_commit();                      // the next block loads meanwhile
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {                          // q fragments, kept in registers
#pragma unroll
      for (int s = 0; s < KS; ++s)
        ldmatrix_x4(qf[s], Qs + (warp * 16 + (lane & 15)) * LD + 16 * s +
                               (lane >> 4) * 8);
    }
    const __nv_bfloat16* Ks = KVs + (it & 1) * 2 * kFaKeys * LD;
    const __nv_bfloat16* Vs = Ks + kFaKeys * LD;

    // S = q k^T: 16 rows x 64 keys per warp, 8 tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[n][u] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        // matrices: keys 8n.. / 8n+8.. x dims 16s.. / 16s+8..
        uint32_t kf[4];
        const int mi = lane >> 3;
        ldmatrix_x4(kf, Ks + (8 * n + (mi >> 1) * 8 + (lane & 7)) * LD +
                            16 * s + (mi & 1) * 8);
        const uint32_t b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
        mma_bf16(sc[n], qf[s], b0);
        mma_bf16(sc[n + 1], qf[s], b1);
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
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float x = sc[n][2 * h + u] * sl2;
          if (edge) {
            const int kp = kb + 8 * n + 2 * t4 + u;
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

    // O += P V: P rounded to bf16 from the score fragments (the C layout
    // of two 8-key tiles is the A layout of one 16-key slice)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t pf[4] = {pack_bf16(sc[2 * s][0], sc[2 * s][1]),
                              pack_bf16(sc[2 * s][2], sc[2 * s][3]),
                              pack_bf16(sc[2 * s + 1][0], sc[2 * s + 1][1]),
                              pack_bf16(sc[2 * s + 1][2], sc[2 * s + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        // matrices: keys 16s.. / 16s+8.. x dims 8n.. / 8n+8.., transposed
        uint32_t vf[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(vf, Vs + (16 * s + (mi & 1) * 8 + (lane & 7)) * LD +
                                  8 * n + (mi >> 1) * 8);
        const uint32_t b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
        mma_bf16(acc[n], pf, b0);
        mma_bf16(acc[n + 1], pf, b1);
      }
    }
    __syncthreads();                        // this stage is free to refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (qp[h] < 0) continue;
    const int r = warp * 16 + gr + 8 * h;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* o = out + (((long)bi * sq + qp[h]) * H + kvh * g + r % g) * dh;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d < dh)
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
            acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
  }
}

template <int DP>
cudaError_t launch_flash_bf16(const void* q, const void* k, const void* v,
                              void* out, int b, int sq, int skv, int H, int K,
                              int dh, int tq, bool causal, int window,
                              float sm_scale, cudaStream_t stream) {
  constexpr int smem = flash_bf16_smem_bytes(DP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies where every row start is 16-byte aligned, else 8-byte
  const bool wide = dh % 8 == 0 &&
                    ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((sq + tq - 1) / tq, K, b);
  using T = __nv_bfloat16;
  flash_bf16_kernel<DP><<<grid, kFbThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, H, K, dh, tq,
      causal ? 1 : 0, window, sm_scale, wide ? 8 : 4);
  return cudaSuccess;
}

cudaError_t launch_flash(bool bf16, const void* q, const void* k,
                         const void* v, void* out, int b, int sq, int skv,
                         int H, int K, int dh, int tq, bool causal, int window,
                         float sm_scale, cudaStream_t stream) {
  if (bf16) {
    // the head dim padded to the tensor cores' depth of 16
#define REPRO_FLASH_BF16(DP)                                                  \
  case DP / 16:                                                               \
    return launch_flash_bf16<DP>(q, k, v, out, b, sq, skv, H, K, dh, tq,      \
                                 causal, window, sm_scale, stream);
    switch ((dh + 15) / 16) {
      REPRO_FLASH_BF16(16)
      REPRO_FLASH_BF16(32)
      REPRO_FLASH_BF16(48)
      REPRO_FLASH_BF16(64)
      REPRO_FLASH_BF16(80)
      REPRO_FLASH_BF16(96)
      REPRO_FLASH_BF16(112)
      REPRO_FLASH_BF16(128)
      default:
        return cudaErrorInvalidValue;
    }
#undef REPRO_FLASH_BF16
  }
  const int smem = flash_smem_bytes(dh);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + tq - 1) / tq, K, b);
  flash_f32_kernel<<<grid, kFaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, H, K,
      dh, tq, causal ? 1 : 0, window, sm_scale);
  return cudaSuccess;
}

}  // namespace repro_torch
