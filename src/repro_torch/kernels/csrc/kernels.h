// Plain C++ launchers of the attention kernels and the SSD scan.  They take raw
// pointers and the stream, so no CUDA source includes PyTorch's headers;
// binding.cpp alone does, and checks the launch right after each call.
#pragma once

#include <cuda_runtime_api.h>

namespace repro_torch {

// Split-KV attention (split_kv.cuh): n_split CTAs per group of
// query rows, each split at least min_pages pages; part: f32 scratch of
// groups * n_split partials of rows * (dh + 2) floats (unused when
// n_split == 1).  All of q's type (f32 or bf16), dh a multiple of 8,
// tensors 16-byte aligned.  Both return the error of raising the kernel's
// shared-memory limit, or of n_split above kMaxSplits.
//
// Decode: q (b, H, dh); arenas (n_blocks, bs, K, dh); tables (b, n_pages)
// i32; lengths (b,) i32; out (b, H, dh); window > 0 keeps the positions >=
// length - window.  Groups: b * K * decode_chunks(g), of decode_rows(g) <=
// 8 of the g = H / K rows (decode_split.cuh); splits balanced over `ctas`
// CTAs in all.  counters: one int a group, 0 before the launch and after
// it, used by no launch that may overlap this one.
cudaError_t launch_paged_decode(bool bf16, const void* q, const void* k_arena,
                                const void* v_arena, const int* tables,
                                const int* lengths, void* out, float* part,
                                int* counters, int b, int H, int K, int dh,
                                int bs, int n_pages, int min_pages,
                                int n_split, int ctas, float sm_scale,
                                int window, cudaStream_t stream);

// Chunked prefill: q (C, H, dh); arenas (n_blocks, bs, K, dh); table
// (span,) i32; positions (C,) i32; out (C, H, dh); tq queries per 64-row
// tile.  Groups: cdiv(C, tq) * K, of 64 rows; a second, merging kernel
// follows when n_split > 1.
cudaError_t launch_paged_prefill(bool bf16, const void* q, const void* k_arena,
                                 const void* v_arena, const int* table,
                                 const int* positions, void* out, float* part,
                                 int C, int H, int K, int dh, int bs, int span,
                                 int tq, int min_pages, int n_split,
                                 float sm_scale, int window,
                                 cudaStream_t stream);

// Contiguous decode, the same split-KV body as the paged decode: q (b, H,
// dh); caches (b, S, K, dh), read as pages of 16 positions; lengths (b,)
// i32 (len_stride 1) or one value for every row (len_stride 0); out (b, H,
// dh); window as for the paged decode.  Splits, scratch and counters as
// for the paged decode, planned over cdiv(S, 16) pages.
cudaError_t launch_decode(bool bf16, const void* q, const void* k_cache,
                          const void* v_cache, const int* lengths,
                          int len_stride, void* out, float* part,
                          int* counters, int b, int H, int K, int dh, int S,
                          int min_pages, int n_split, int ctas,
                          float sm_scale, int window, cudaStream_t stream);

// Contiguous flash attention, one tensor-core body for both types: q (b,
// sq, H, dh); k, v (b, skv, K, dh); out (b, sq, H, dh); tq queries per CTA;
// dh a multiple of 4, f32 tensors 16-byte aligned and bf16 8-byte aligned.
// Returns the error of raising the kernel's shared-memory limit.
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
