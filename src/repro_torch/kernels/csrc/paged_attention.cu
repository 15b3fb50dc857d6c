// Paged flash-decode for Hopper (sm_90a): one new token per batch row
// attends over K/V scattered across fixed-size arena blocks.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, body _paged_kernel).  That kernel runs a grid
// (row, kv-head, page) with the page axis sequential and the block table
// scalar-prefetched.
//
// The kernel is the split-KV decode body of decode_split.cuh with the
// PagedKV address policy: each CTA reads its split's block ids into shared
// memory once, and a position's K/V row lies at (block id * bs + offset)
// * K * dh.  decode_split.cuh says what bounds it and how the design
// answers; the contiguous decode (decode_attention.cu) runs the same body.
#include "decode_split.cuh"
#include "kernels.h"

namespace repro_torch {

cudaError_t launch_paged_decode(bool bf16, const void* q, const void* k_arena,
                                const void* v_arena, const int* tables,
                                const int* lengths, void* out, float* part,
                                int* counters, int b, int H, int K, int dh,
                                int bs, int n_pages, int min_pages,
                                int n_split, int ctas, float sm_scale,
                                int window, cudaStream_t stream) {
  return launch_decode_body<PagedKV>(bf16, q, k_arena, v_arena, tables,
                                     lengths, nullptr, 0, out, nullptr, part,
                                     counters, b, H, K, dh, bs, n_pages * bs,
                                     min_pages, n_split, ctas, sm_scale,
                                     window, stream);
}

}  // namespace repro_torch
