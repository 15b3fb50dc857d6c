// Flash-decode over a contiguous per-row KV cache for Hopper (sm_90a): one
// new token per batch row attends over the first lengths[row] positions of
// its own (S, K, dh) cache row — the slotted serving engine's decode, and
// the hybrid (zamba2) decode step's.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel).  That kernel runs a grid
// (row, kv-head, kv-block) with the kv-block axis sequential, walks EVERY
// block_k = 256 block of the cache (masking the tail past the row's length)
// and needs S % block_k == 0.
//
// The kernel is the split-KV decode body of decode_split.cuh with the
// ContigKV address policy: the row is read as pages of kContigPage = 16
// positions, position p of row r at element (r * S + p) * K * dh — the
// paged arena's position stride with the block table replaced by the
// identity.  Each row cuts its own valid pages below min(length, S) into
// the splits the host planned from S alone (kernels/paged_attention.py
// split_plan over cdiv(S, 16) pages), so the cache tail is never read, any
// S is taken (the last page may be ragged) and the slotted step stays free
// of host syncs.  lengths may be one value shared by every row (len_stride
// 0, ContigKV<0>) or one per row (len_stride 1, ContigKV<1>); a row whose
// length exceeds S sees the whole cache, as in the plain version.  Two
// optional arguments serve the append-buffer decode's two segments
// (models/layers.py attention_decode_split_apply): a window end (per row
// or shared) from which the window's left edge is taken in place of the
// length, and an f32 log-sum-exp output (the output is then f32 too), so
// that the segments are merged by their lse (that form is compiled in
// decode_window_end.cu).  decode_split.cuh says what
// bounds it (HBM bytes) and how the design answers; the paged decode
// (paged_attention.cu) runs the same body.
#include "decode_split.cuh"
#include "kernels.h"

namespace repro_torch {

cudaError_t launch_decode(bool bf16, const void* q, const void* k_cache,
                          const void* v_cache, const int* lengths,
                          int len_stride, const int* window_end,
                          int we_stride, void* out, float* lse, float* part,
                          int* counters, int b, int H, int K, int dh, int S,
                          int min_pages, int n_split, int ctas,
                          float sm_scale, int window, cudaStream_t stream) {
  // one instantiation per form of the lengths: per row, or shared; the
  // form with a window end and an lse takes the shared one only
  if (window_end != nullptr || lse != nullptr) {
    if (len_stride) return cudaErrorInvalidValue;
    return launch_decode_window_end(bf16, q, k_cache, v_cache, lengths,
                                    window_end, we_stride, out, lse, part,
                                    counters, b, H, K, dh, S, min_pages,
                                    n_split, ctas, sm_scale, window, stream);
  }
  if (len_stride)
    return launch_decode_body<ContigKV<1>>(
        bf16, q, k_cache, v_cache, nullptr, lengths, window_end, we_stride,
        out, lse, part, counters, b, H, K, dh, kContigPage, S, min_pages,
        n_split, ctas, sm_scale, window, stream);
  return launch_decode_body<ContigKV<0>>(
      bf16, q, k_cache, v_cache, nullptr, lengths, window_end, we_stride, out,
      lse, part, counters, b, H, K, dh, kContigPage, S, min_pages, n_split,
      ctas, sm_scale, window, stream);
}

}  // namespace repro_torch
