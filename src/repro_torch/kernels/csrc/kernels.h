// Plain C++ launchers of the attention kernels and the SSD scan.  They take raw
// pointers and the stream, so no CUDA source includes PyTorch's headers;
// binding.cpp alone does, and checks the launch right after each call.
#pragma once

#include <cuda_runtime_api.h>

namespace repro_torch {

// q (b, H, dh); arenas (n_blocks, bs, K, dh); tables (b, n_pages) i32;
// lengths (b,) i32; out (b, H, dh).  All of q's type (f32 or bf16).
void launch_paged_decode(bool bf16, const void* q, const void* k_arena,
                         const void* v_arena, const int* tables,
                         const int* lengths, void* out, int b, int H, int K,
                         int dh, int bs, int n_pages, float sm_scale,
                         cudaStream_t stream);

// q (C, H, dh); arenas (n_blocks, bs, K, dh); table (span,) i32;
// positions (C,) i32; out (C, H, dh); tq queries per CTA.
void launch_paged_prefill(bool bf16, const void* q, const void* k_arena,
                          const void* v_arena, const int* table,
                          const int* positions, void* out, int C, int H, int K,
                          int dh, int bs, int span, int tq, float sm_scale,
                          int window, cudaStream_t stream);

// q (b, H, dh); caches (b, S, K, dh); lengths (b,) i32 (len_stride 1) or
// one value for every row (len_stride 0); out (b, H, dh).
void launch_decode(bool bf16, const void* q, const void* k_cache,
                   const void* v_cache, const int* lengths, int len_stride,
                   void* out, int b, int H, int K, int dh, int S,
                   float sm_scale, cudaStream_t stream);

// q (b, sq, H, dh); k, v (b, skv, K, dh); out (b, sq, H, dh); tq queries
// per CTA.  Returns the error of raising the kernel's shared-memory limit.
cudaError_t launch_flash(bool bf16, const void* q, const void* k,
                         const void* v, void* out, int b, int sq, int skv,
                         int H, int K, int dh, int tq, bool causal, int window,
                         float sm_scale, cudaStream_t stream);

// x (b, s, H, P), B and C (b, s, G, N), all of one type (f32 or bf16);
// dt (b, s, H) and A (H,) f32; y (b, s, H, P) and state (b, H, P, N) f32.
// s a multiple of chunk; ps the P columns per CTA.  Returns the error of
// raising the kernel's shared-memory limit.
cudaError_t launch_ssd(bool bf16, const void* x, const float* dt,
                       const float* A, const void* B, const void* C, float* y,
                       float* state, int b, int s, int H, int P, int G, int N,
                       int chunk, int ps, cudaStream_t stream);

}  // namespace repro_torch
