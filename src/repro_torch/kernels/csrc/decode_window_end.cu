// The contiguous decode's form with a window end and a log-sum-exp output
// (decode_split.cuh, kExt) — the append-buffer decode's two segments
// (models/layers.py attention_decode_split_apply): the prefix, whose
// window ends at the query's position, and the suffix ring, merged by
// their lse.  Kept apart from decode_attention.cu so that the two compile
// in parallel (with these eight instantiations, bf16 and f32 up to 8 query
// rows, in decode_attention.cu the build took 59.0 s against the parent's
// 51.1 s on one H100 host).  It takes one length shared by every row
// (ContigKV<0>).
#include "decode_split.cuh"
#include "kernels.h"

namespace repro_torch {

cudaError_t launch_decode_window_end(bool bf16, const void* q,
                                     const void* k_cache, const void* v_cache,
                                     const int* lengths, const int* window_end,
                                     int we_stride, void* out, float* lse,
                                     float* part, int* counters, int b, int H,
                                     int K, int dh, int S, int min_pages,
                                     int n_split, int ctas, float sm_scale,
                                     int window, cudaStream_t stream) {
  return launch_decode_body<ContigKV<0>, true>(
      bf16, q, k_cache, v_cache, nullptr, lengths, window_end, we_stride, out,
      lse, part, counters, b, H, K, dh, kContigPage, S, min_pages, n_split,
      ctas, sm_scale, window, stream);
}

}  // namespace repro_torch
