// Flash-decode over a contiguous per-row KV cache for Hopper (sm_90a): one
// new token per batch row attends over the first lengths[row] positions of
// its own (S, K, dh) cache row — the slotted serving engine's decode.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel).  That kernel runs a grid
// (row, kv-head, kv-block) with the kv-block axis sequential, walks EVERY
// block_k = 256 block of the cache (masking the tail past the row's length)
// and needs S % block_k == 0.  Here one CTA per (row, KV head) runs the
// shared routine of attention_tile.cuh over the row read as pages of
// kContigPage positions at row_base + pos * K * dh: its 8 warps split the
// pages below min(length, S), so the cache tail is never read and any S is
// taken (the last page may be ragged).  Each warp keeps the f32 online
// softmax of the g query heads of the group; the warps' states are merged
// at the end.  Query head h reads KV head h / g.  lengths may be one value
// shared by every row (len_stride 0) or one per row (len_stride 1); a row
// whose length exceeds S sees the whole cache, as in the plain version.
//
// Bound on the H100: HBM bytes — every visible K/V position is read once
// (2 * length * dh * bytes per row and KV head) against 4 * g * dh flops per
// position, far below the card's flop:byte ratio.  The design reads each
// K/V row with one coalesced warp load and keeps kWarps * 4 positions of
// loads in flight per CTA with no barrier in the position loop.  A batch of
// b rows runs b * K CTAs; splitting a long row over several CTAs is later
// work.
#include "attention_tile.cuh"
#include "kernels.h"

namespace repro_torch {

constexpr int kContigPage = 16;   // positions per page of a contiguous row

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                  const T* __restrict__ v_cache,
                  const int* __restrict__ lengths, int len_stride,
                  T* __restrict__ out, int H, int K, int dh, int S,
                  float sm_scale) {
  extern __shared__ float smem[];
  const int row = blockIdx.x, kvh = blockIdx.y, g = H / K;
  int* qpos = reinterpret_cast<int*>(smem) + kWarps * g * (dh + 2);
  if (threadIdx.x == 0) qpos[0] = lengths[row * len_stride] - 1;
  __syncthreads();
  const long off = (long)row * H * dh + (long)kvh * g * dh;
  attend_rows<T>(q + off, out + off, (long)H * dh, g, dh, qpos, k_cache,
                 v_cache, kContigPage, K, kvh, (long)row * S * K * dh, S,
                 sm_scale, smem);
}

void launch_decode(bool bf16, const void* q, const void* k_cache,
                   const void* v_cache, const int* lengths, int len_stride,
                   void* out, int b, int H, int K, int dh, int S,
                   float sm_scale, cudaStream_t stream) {
  const dim3 grid(b, K);
  const size_t smem = tile_smem_bytes(H / K, dh);
  if (bf16) {
    using T = __nv_bfloat16;
    decode_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_cache),
        static_cast<const T*>(v_cache), lengths, len_stride,
        static_cast<T*>(out), H, K, dh, S, sm_scale);
  } else {
    decode_kernel<float><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_cache),
        static_cast<const float*>(v_cache), lengths, len_stride,
        static_cast<float*>(out), H, K, dh, S, sm_scale);
  }
}

}  // namespace repro_torch
