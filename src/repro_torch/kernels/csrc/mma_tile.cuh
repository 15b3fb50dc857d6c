// Warp-level tensor-core helpers shared by the contiguous flash-attention
// body, the paged prefill and the SSD scan: asynchronous global -> shared
// copies (cp.async), ldmatrix fragment loads, mma.sync.m16n8k16 with bf16
// operands and f32 accumulators, and the split of f32 operands into bf16
// hi / lo pairs — at the fragment (split_frag_a) or a staged tile at a
// time (split_rows) — by which the attention bodies multiply f32 inputs.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major) a[0]: (g, 2t..2t+1)  a[1]: (g+8, 2t..)
//                          a[2]: (g, 2t+8..)    a[3]: (g+8, 2t+8..)
//   B (16 x 8, k x n)      b[0]: (k 2t..2t+1, n g)  b[1]: (k 2t+8.., n g)
//   C (16 x 8, f32)        c[0..1]: (g, 2t..2t+1)  c[2..3]: (g+8, 2t..)
// Each register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the destination is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 8 bytes, for rows whose width is not a multiple of 16 bytes
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}
// 4 bytes (one f32)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a . b
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two floats -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// a ~ hi + lo, both bf16: hi = bf16(a), lo = bf16(a - hi); the pair keeps
// ~16 bits of a's 24-bit significand
__device__ __forceinline__ void split_bf16(float a0, float a1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a0 - hf.x, a1 - hf.y);
}

// A fragment of m16n8k16's A (rows r0, r0 + 8; columns c0 + 2t, c0 + 2t +
// 8) of an f32 tile in shared memory, ld floats a row, split into bf16 hi
// and lo pairs
__device__ __forceinline__ void split_frag_a(const float* tile, int ld,
                                             int r0, int c0, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = *reinterpret_cast<const float2*>(
        tile + (r0 + gr + 8 * (i & 1)) * ld + c0 + 2 * t + 8 * (i >> 1));
    split_bf16(x.x, x.y, hi[i], lo[i]);
  }
}

// n f32 rows of dh floats, LS apart, split into bf16 hi and lo tiles of
// LB elements a row: row j goes to group j / R at dst + (j / R) * 2 * R *
// LB, its hi tile then its lo tile (R rows each) — so K and V rows staged
// together land as [K hi, K lo, V hi, V lo].  Each of the CTA's nthreads
// threads takes a share.  dh % 4 == 0.
template <int R, int LS, int LB>
__device__ __forceinline__ void split_rows(const float* src,
                                           __nv_bfloat16* dst, int n, int dh,
                                           int nthreads) {
  const int d4 = dh / 4;
  for (int e = threadIdx.x; e < n * d4; e += nthreads) {
    const int j = e / d4, c = (e - j * d4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + j * LS + c);
    uint2 h, l;
    split_bf16(x.x, x.y, h.x, l.x);
    split_bf16(x.z, x.w, h.y, l.y);
    __nv_bfloat16* d = dst + (j / R) * 2 * R * LB + (j % R) * LB + c;
    *reinterpret_cast<uint2*>(d) = h;
    *reinterpret_cast<uint2*>(d + R * LB) = l;
  }
}

// Shared memory of an attention tile of ROWS query rows on the tensor
// cores, K/V staged in blocks of KEYS keys, at padded head dim DP.  Rows of
// bf16 tiles read by ldmatrix are DP + 8 elements apart (an odd number of
// 16-byte units: no bank read twice).
//   bf16: q [ROWS][DP + 8], then two stages of K and V [KEYS][DP + 8].
//   f32:  q [ROWS][DP + 8] f32 (float2 fragment reads, conflict-free at
//         that stride), one f32 stage of K and V [KEYS][DP + 4] filled by
//         cp.async, and their split bf16 hi and lo [KEYS][DP + 8]
//         (split_rows), which the products read.
template <typename T, int DP, int ROWS, int KEYS>
struct TileSmem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int LB = DP + 8;                // bf16 rows, and f32 q
  static constexpr int LS = DP + 4;                // f32 staging rows
  static constexpr int kQ = ROWS * LB * (int)sizeof(T);
  static constexpr int kStage = kF32 ? 2 * KEYS * LS * 4 : 2 * KEYS * LB * 2;
  static constexpr int kSplit = kF32 ? 4 * KEYS * LB * 2 : 0;
  static constexpr int kBytes = kQ + (kF32 ? 1 : 2) * kStage + kSplit;
};

}  // namespace repro_torch
