// Paged chunked-prefill flash attention for Hopper (sm_90a): the C queries
// of one prompt chunk, at absolute positions n_past.., attend causally over
// the sequence's K/V read through its block table.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) in the paged form the serving
// engine's chunked prefill computes (src/repro/models/layers.py,
// attention_prefill_paged_apply).  The Pallas kernel tiles a contiguous
// K/V over a (batch, kv-head, q-block, kv-block) grid and runs fully
// masked blocks; here one CTA per (q-tile of the chunk, KV head) walks the
// table's pages only up to the page that holds the tile's largest position
// (and from the first page inside the window), so masked pages are skipped.
// The tile's tq queries x g heads (at most 8 rows) keep an f32 online
// softmax per warp; the CTA's 8 warps split the pages and merge at the end.
// The mask is kv_pos <= positions[q] on absolute positions, and
// positions[q] - kv_pos < window when window > 0.  Queries of the padded
// chunk tail are computed like the others; their rows are never read.
//
// Bound on the H100: for a 32-token chunk the work is 4 * C * H * dh flops
// per visible position against 2 * K * dh * bytes of K/V per position —
// C * H / (2 * K) = 32 flops per byte in f32, above the 20 of the CUDA
// cores (67 TFLOP/s over 3.35 TB/s), so the f32 operations bound it.  The
// design computes on CUDA cores in f32 with warp-shuffle dot products; each
// q-tile CTA of a KV head re-reads the same pages (through L2).  Tensor-core
// tiles (mma/wgmma over the whole chunk) are later work.
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
                 k_arena, v_arena, bs, K, kvh, table, span, sm_scale, window,
                 smem);
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

}  // namespace repro_torch
