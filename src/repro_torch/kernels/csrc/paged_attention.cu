// Paged flash-decode for Hopper (sm_90a): one new token per batch row
// attends over K/V scattered across fixed-size arena blocks.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, body _paged_kernel).  That kernel runs a grid
// (row, kv-head, page) with the page axis sequential and the block table
// scalar-prefetched; here one CTA per (row, KV head) reads its row's block
// ids itself, and its 8 warps split the pages p < cdiv(length, bs) between
// them, so the loop bound is the page-skip and the junk-padded table tail is
// never loaded.  Positions >= length inside the last page are masked.  Each
// warp keeps the f32 online softmax of the g query heads of the group over
// its pages; the warps' partial states are merged at the end.  Query head h
// maps to KV head h / g.
//
// Bound on the H100: HBM bytes — every valid K/V position is read once
// (2 * length * dh * bytes per row and KV head) against 4 * g * dh flops per
// position, far below the card's flop:byte ratio.  The design reads each
// K/V row with one coalesced warp load and keeps kWarps * 4 positions of
// loads in flight per CTA with no barrier in the page loop.  A batch of b
// rows still runs only b * K CTAs; splitting a row over CTAs and TMA are
// later work.
#include "attention_tile.cuh"
#include "kernels.h"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_arena,
                        const T* __restrict__ v_arena,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int K, int dh, int bs, int n_pages,
                        float sm_scale) {
  extern __shared__ float smem[];
  const int row = blockIdx.x, kvh = blockIdx.y, g = H / K;
  int* qpos = reinterpret_cast<int*>(smem) + kWarps * g * (dh + 2);
  if (threadIdx.x == 0) qpos[0] = lengths[row] - 1;   // the new token
  __syncthreads();
  const long off = (long)row * H * dh + (long)kvh * g * dh;
  attend_rows<T>(q + off, out + off, (long)H * dh, /*tq=*/1, /*nq=*/1, g, dh,
                 qpos, k_arena, v_arena, bs, K, kvh,
                 PagedKV{tables + (long)row * n_pages}, n_pages * bs,
                 sm_scale, /*window=*/0, smem);
}

void launch_paged_decode(bool bf16, const void* q, const void* k_arena,
                         const void* v_arena, const int* tables,
                         const int* lengths, void* out, int b, int H, int K,
                         int dh, int bs, int n_pages, float sm_scale,
                         cudaStream_t stream) {
  const dim3 grid(b, K);
  const size_t smem = tile_smem_bytes(H / K, dh, 1);
  if (bf16) {
    using T = __nv_bfloat16;
    paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_arena),
        static_cast<const T*>(v_arena), tables, lengths, static_cast<T*>(out),
        H, K, dh, bs, n_pages, sm_scale);
  } else {
    paged_decode_kernel<float><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_arena),
        static_cast<const float*>(v_arena), tables, lengths,
        static_cast<float*>(out), H, K, dh, bs, n_pages, sm_scale);
  }
}

}  // namespace repro_torch
