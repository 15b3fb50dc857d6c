// Flash attention for Hopper (sm_90a), in the two forms the serving engines
// compute.  Both replace the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel), which tiles a contiguous K/V over a
// (batch, kv-head, q-block, kv-block) grid with the kv-block axis
// sequential, and runs fully masked blocks.
//
// 1. Paged chunked prefill (paged_prefill_kernel): the C queries of one
//    prompt chunk, at absolute positions n_past.., attend causally over the
//    sequence's K/V read through its block table (src/repro/models/
//    layers.py, attention_prefill_paged_apply).  One CTA per (q-tile of the
//    chunk, KV head) walks the table's pages only up to the page that holds
//    the tile's largest position (and from the first page inside the
//    window), so masked pages are skipped.  The tile's tq queries x g heads
//    (at most 8 rows) keep an f32 online softmax per warp; the CTA's 8 warps
//    split the pages and merge at the end (attention_tile.cuh).  The mask is
//    kv_pos <= positions[q] on absolute positions, and positions[q] - kv_pos
//    < window when window > 0.  Queries of the padded chunk tail are
//    computed like the others; their rows are never read.
//    Bound on the H100: for a 32-token chunk the work is 4 * C * H * dh
//    flops per visible position against 2 * K * dh * bytes of K/V per
//    position — C * H / (2 * K) = 32 flops per byte in f32, above the 20 of
//    the CUDA cores (67 TFLOP/s over 3.35 TB/s), so the f32 operations
//    bound it.  Each q-tile CTA of a KV head re-reads the same pages
//    (through L2).
//
// 2. Contiguous prefill (flash_kernel): a whole prompt, q (b, sq, H, dh)
//    against k, v (b, skv, K, dh), causal on positions from 0 (q_pos >=
//    kv_pos, src/repro/models/layers.py blocked_attention with q_offset 0)
//    or full, with the sliding window when window > 0.  An 8-row tile would
//    re-read the K/V prefix once per 4 queries (g = 2), so this form takes a
//    tile of kFaRows = 64 query rows (64 / g queries x g heads) per CTA, one
//    CTA per (q-tile, KV head, batch row).  It stages K/V blocks of kFaKeys
//    = 64 positions in shared memory once per tile and reuses them across
//    all 64 rows; blocks past the tile's last query (causal) or before its
//    window are skipped — the Pallas kernel runs them.  Each of the 256
//    threads owns a 4 x 4 tile of scores (rows ty + 16a, keys tx + 16c:
//    conflict-free float4 reads of the padded q and K rows) and 4 rows x 8
//    dims of the f32 output; a row's online softmax state is reduced over
//    the 16 threads that share it with shuffles, and the probabilities go
//    through shared memory (over the K block, which is spent by then) to the
//    P·V product.  Scores, softmax and P·V run in f32 on CUDA cores; bf16
//    inputs are widened when staged.
//    Bound on the H100: f32 operations — 4 * dh flops per visible (query
//    head, key) pair, e.g. about 4.3 GFLOP at sq = skv = 1024, 16 heads,
//    dh = 128, causal: 64 us at 67 TFLOP/s, against 12.6 MB of q, k, v and
//    out (4 us at 3.35 TB/s).  Two CTAs fit an SM (99 KB of shared memory
//    each at dh = 128), so one stages its block while the other computes.
//    Tensor-core tiles (mma/wgmma) and asynchronous staging are later work.
#include "attention_tile.cuh"
#include "kernels.h"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_arena,
                         const T* __restrict__ v_arena,
                         const int* __restrict__ table,
                         const int* __restrict__ positions, T* __restrict__ out,
                         int C, int H, int K, int dh, int bs, int span, int tq,
                         float sm_scale, int window) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.y, g = H / K;
  const int q0 = blockIdx.x * tq;
  const int nq = min(tq, C - q0);
  int* qpos = reinterpret_cast<int*>(smem) + kWarps * tq * g * (dh + 2);
  for (int i = threadIdx.x; i < nq; i += kThreads) qpos[i] = positions[q0 + i];
  __syncthreads();
  const long off = (long)q0 * H * dh + (long)kvh * g * dh;
  attend_rows<T>(q + off, out + off, (long)H * dh, tq, nq, g, dh, qpos,
                 k_arena, v_arena, bs, K, kvh, PagedKV{table}, span * bs,
                 sm_scale, window, smem);
}

void launch_paged_prefill(bool bf16, const void* q, const void* k_arena,
                          const void* v_arena, const int* table,
                          const int* positions, void* out, int C, int H, int K,
                          int dh, int bs, int span, int tq, float sm_scale,
                          int window, cudaStream_t stream) {
  const dim3 grid((C + tq - 1) / tq, K);
  const size_t smem = tile_smem_bytes(tq * (H / K), dh, tq);
  if (bf16) {
    using T = __nv_bfloat16;
    paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_arena),
        static_cast<const T*>(v_arena), table, positions, static_cast<T*>(out),
        C, H, K, dh, bs, span, tq, sm_scale, window);
  } else {
    paged_prefill_kernel<float><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_arena),
        static_cast<const float*>(v_arena), table, positions,
        static_cast<float*>(out), C, H, K, dh, bs, span, tq, sm_scale, window);
  }
}

// ============================================================================
// contiguous form
// ============================================================================
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
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
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

template <typename T>
__global__ void __launch_bounds__(kFaThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int H, int K, int dh, int tq, int causal,
                 int window, float sm_scale) {
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
    T* o = out + (((long)bi * sq + rq[a]) * H + kvh * g + r % g) * dh;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = (c < 4 ? 4 * tx : 64 + 4 * tx) + (c & 3);
      if (d < dh) o[d] = from_float<T>(acc[a][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch_flash_t(const void* q, const void* k, const void* v,
                           void* out, int b, int sq, int skv, int H, int K,
                           int dh, int tq, bool causal, int window,
                           float sm_scale, cudaStream_t stream) {
  const int smem = flash_smem_bytes(dh);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + tq - 1) / tq, K, b);
  flash_kernel<T><<<grid, kFaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, H, K, dh, tq,
      causal ? 1 : 0, window, sm_scale);
  return cudaSuccess;
}

cudaError_t launch_flash(bool bf16, const void* q, const void* k,
                         const void* v, void* out, int b, int sq, int skv,
                         int H, int K, int dh, int tq, bool causal, int window,
                         float sm_scale, cudaStream_t stream) {
  if (bf16)
    return launch_flash_t<__nv_bfloat16>(q, k, v, out, b, sq, skv, H, K, dh,
                                         tq, causal, window, sm_scale, stream);
  return launch_flash_t<float>(q, k, v, out, b, sq, skv, H, K, dh, tq, causal,
                               window, sm_scale, stream);
}

}  // namespace repro_torch
