// Plain C++ launchers of the attention kernels and the SSD scan (and their
// gradients).  They take raw
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
// for the paged decode, planned over cdiv(S, 16) pages.  window_end (null
// for none): i32 (b,) (we_stride 1) or one value (0); the window keeps the
// positions >= window_end - window in place of length - window.  lse (null
// for none): (b, H) f32, each row's log-sum-exp of its scaled scores
// (-inf where it sees nothing); out is then f32 whatever q's type.  Either
// takes one shared length (len_stride 0; cudaErrorInvalidValue else).
cudaError_t launch_decode(bool bf16, const void* q, const void* k_cache,
                          const void* v_cache, const int* lengths,
                          int len_stride, const int* window_end,
                          int we_stride, void* out, float* lse, float* part,
                          int* counters, int b, int H, int K, int dh, int S,
                          int min_pages, int n_split, int ctas,
                          float sm_scale, int window, cudaStream_t stream);

// The form of launch_decode with a window end or an lse
// (decode_window_end.cu; one shared length), which launch_decode calls.
cudaError_t launch_decode_window_end(bool bf16, const void* q,
                                     const void* k_cache, const void* v_cache,
                                     const int* lengths, const int* window_end,
                                     int we_stride, void* out, float* lse,
                                     float* part, int* counters, int b, int H,
                                     int K, int dh, int S, int min_pages,
                                     int n_split, int ctas, float sm_scale,
                                     int window, cudaStream_t stream);

// Contiguous flash attention, one tensor-core body for both types: q (b,
// sq, H, dh); k, v (b, skv, K, dh); out (b, sq, H, dh); tq queries per CTA;
// dh a multiple of 4, f32 tensors 16-byte aligned and bf16 8-byte aligned.
// lse (b, H, sq) f32, written when not null: each row's log-sum-exp of its
// scaled scores (+inf for a row that sees no key), for the backward.
// Returns the error of raising the kernel's shared-memory limit.
cudaError_t launch_flash(bool bf16, const void* q, const void* k,
                         const void* v, void* out, float* lse, int b, int sq,
                         int skv, int H, int K, int dh, int tq, bool causal,
                         int window, float sm_scale, cudaStream_t stream);

// Its gradient (flash_backward.cu), on the tensor cores: q, out, dout, dq
// (b, sq, H, dh); k, v, dk, dv (b, skv, K, dh), all of one type; lse (b,
// H, sq) f32 from launch_flash; delta (b, H, sq) f32 scratch; tq queries
// per dQ CTA (64 / g); dh at most 128.  n_split CTAs share each 64-key
// block's dK / dV walk.  scratch, f32 (null when empty): with n_split > 1,
// 2 * n_split * b * skv * K * dh floats first (each split's dK, then its
// dV), summed in a fixed order by a kernel of the same call; then, for f32
// inputs, q, k, v and dO split into bf16 hi / lo pairs (2 * (b sq H dh + b
// skv K dh) floats).  Returns the error of raising a kernel's
// shared-memory limit or of a launch.
cudaError_t launch_flash_bwd(bool bf16, const void* q, const void* k,
                             const void* v, const void* out, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, float* scratch, int b,
                             int sq, int skv, int H, int K, int dh, int tq,
                             int n_split, bool causal, int window,
                             float sm_scale, cudaStream_t stream);

// *n: the dK/dV CTAs of launch_flash_bwd that one SM of the current
// device holds at head dim dh (the occupancy calculator's count).
cudaError_t flash_bwd_ctas_per_sm(bool bf16, int dh, int* n);

// x (b, s, H, P), B and C (b, s, G, N), all of one type (f32 or bf16);
// dt (b, s, H) and A (H,) f32; y (b, s, H, P) and state (b, H, P, N) f32;
// states (b, s / chunk, H, P, N) f32, the state entering each chunk,
// written when not null (for the backward).  s a multiple of chunk; ps the
// P columns per CTA.  Returns the error of raising the kernel's
// shared-memory limit.
cudaError_t launch_ssd(bool bf16, const void* x, const float* dt,
                       const float* A, const void* B, const void* C, float* y,
                       float* state, float* states, int b, int s, int H, int P,
                       int G, int N, int chunk, int ps, cudaStream_t stream);

// Its gradient (ssd_backward.cu), three kernels on the CUDA cores in f32:
// x, dx (b, s, H, P) and B, C, dB, dC (b, s, G, N), all of one type; dt,
// ddt (b, s, H), A, dA (H,), dy (b, s, H, P) f32; states from launch_ssd;
// dstate (b, H, P, N) f32, the final state's gradient, or null for zero.
// Scratch, f32: dh1 (b, nc, H, P, N); dA_part (b, nc, H); dB_part, dC_part
// (b, s, H, N).  chunk and N at most 128, P at most 64, ps the P columns
// of a reverse-pass CTA.  Returns the error of raising a kernel's
// shared-memory limit or of a launch.
cudaError_t launch_ssd_bwd(bool bf16, const void* x, const float* dt,
                           const float* A, const void* B, const void* C,
                           const float* states, const float* dy,
                           const float* dstate, float* dh1, void* dx,
                           float* ddt, float* dA_part, float* dB_part,
                           float* dC_part, float* dA, void* dB, void* dC,
                           int b, int s, int H, int P, int G, int N,
                           int chunk, int ps, cudaStream_t stream);

}  // namespace repro_torch
