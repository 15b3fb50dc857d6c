// The gradient of the Mamba2 SSD chunked scan (ssd_scan.cu) for Hopper
// (sm_90a).  The reference has no Pallas backward: it trains through the
// jnp ssd_ref of src/repro/models/ssm.py, which XLA differentiates; this is
// the gradient of the function the TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_chunked) computes, from a zero initial state.
//
// Per batch row, head h and chunk of c positions, with a = dt A, cum its
// inclusive cumsum within the chunk, X = dt x, B and C of h's group, L_ij =
// exp(cum_i - cum_j) for j <= i, S = C B^T, w_j = exp(cum_last - cum_j),
// h0 the state entering the chunk (the forward's optional output) and dh1
// the cotangent of the state leaving it, four kernels:
//   (K1) S = C B^T once per (batch row, group, chunk), the 16 x 16 tiles
//        on or below the diagonal, into f32 scratch that stays in L2 (a
//        CTA per (i-tile, chunk, group and row)); each K3 CTA copies its
//        (row, group, chunk)'s tiles to shared memory once.
//   (K2) the reverse state pass: one CTA per (32 rows of P, 64 columns of
//        N, head, batch row) walks the chunks from last to first, dh in the
//        warps' f32 accumulators: it writes each chunk's dh1 and its part
//        of <dh1, h0>, then dh <- exp(cum_last) dh + (exp(cum) o dy)^T C,
//        one tensor-core product a chunk, as the forward's state update.
//        The last chunk's dh1 is the final state's cotangent.
//   (K3) the chunk pass: one CTA per (block of hb heads of one group,
//        chunk, batch row), hb from the host (kernels/ssd_scan.py
//        ssd_bwd_plan).  B and C are shared by the block's heads, so
//        dC = (sum_h M_h) B + sum_h (exp(cum_h) o dy_h) h0_h and dB =
//        (sum_h M_h)^T C + sum_h (w_h dt_h o x_h) dh1_h, with M_h =
//        L_h o (dy_h X_h^T): the M of the block's heads are summed in
//        shared memory and multiplied by B and C once, and the other two
//        products accumulate over the heads in the warps' registers, so one
//        f32 partial of dB and of dC per head block reaches memory.  In two
//        walks over the block's heads, a warp owning 16 rows:
//        phase A (rows i): M's tiles j <= i, the row sums of R = S o M and
//          the column sums' parts, dC's sum; o_i = exp(cum_i) dy_i . h0 C_i
//          is the head's change of sum_n dC_in C_in (the accumulator's
//          rows before and after the head's product);
//        phase B (rows j): dX = (S o L)^T dy + w (B dh1^T), r_j = w_j X_j .
//          (B dh1^T)_j, dx = dt dX, x . dX, dB's sum; then one warp takes
//          dcum = rowsum(R) - colsum(R) + o - r (the last position also
//          exp(cum_last) <dh1, h0> + sum r), its reverse cumsum da by a
//          warp scan, ddt = x . dX + A da and the chunk's part of dA.
//   (K4) a fixed-order sum of the head blocks' partials of dB and dC (B's
//        type) and of the dA partials.
// Every sum runs in a fixed order (shuffles of fixed pattern, loops in
// order): no atomics, so two launches give the same bits.
//
// Every product runs on the tensor cores, mma.sync.m16n8k16 with f32
// accumulators (mma_tile.cuh), and the c x c ones only on the 16 x 16
// tiles on or below the diagonal, L's mask applied on the fragments; c, N
// and P are padded to multiples of 16 with zeros in shared memory.  An
// f32 operand (dy, h0, dh1, M, S o L, the scaled rows; x, B and C when they
// arrive in f32) is split into bf16 hi + lo, as the forward does: against a
// bf16 operand hi.b + lo.b, f32 on both sides hi.hi + hi.lo + lo.hi.  A
// staged f32 tile is split once, in place, by the threads that copied it.
// S of f32 inputs takes three bf16 parts a side and the six products of
// order <= 2 (near f32): dA and ddt come through dcum's cancelling row and
// column sums of S o M.  The chunk's cumsum and the differences that go
// into exp are f64 (chunk_decays).
//
// Bound on the H100: a (head, chunk) needs c (c + 1) / 2 2 P multiply-adds
// within the chunk (M, dX) and 4 c P N for the states' products, a (group,
// chunk) c (c + 1) / 2 3 N (S, (sum M) B, (sum M)^T C): mamba2's 80 heads of
// 64 in one group, N 128, c 128 at 4 x 1024 tokens are 27 GFLOP, 0.082 ms
// for f32 inputs as split bf16 (989/3 TFLOP/s; 0.40 ms at the CUDA cores'
// 67); the bytes (x, B, C, dt, A, dy, the chunk states read; dx, ddt, dA,
// dB, dC written) take 0.103 ms in f32, 0.077 in bf16, at 3.35 TB/s, and
// bound both.
//
// Shared memory of K3 at mamba2's shape: dy's pair and x (f32: a pair)
// [c][P + 8], which B and C take over at a phase's end; h0's or dh1's pair
// [P][N + 8]; sum M, f32 in fragment order (36 tiles of 1 KB); S's 36 tiles
// (1.25 KB each); vectors: 203 KB (f32), 185 KB (bf16), one CTA of 8 warps
// an SM (ssd_bwd_ctas_per_sm).  The head loops stage each head's tiles and
// wait for them: prefetching the next head's tiles behind the products
// (two of the three tiles hidden, two more barriers a head) measured
// slower on the H100, as did two tiles a step in the c x c loops (255
// registers, spills).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kernels.h"
#include "mma_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kSbWarps = 8;
constexpr int kSbThreads = 32 * kSbWarps;
constexpr int kSbMaxC = 128;       // chunk
constexpr int kSbMaxHeads = 16;    // heads a K3 CTA walks
constexpr int kStRows = 32;        // K2: rows of P a CTA
constexpr int kStCols = 64;        // K2: columns of N a CTA

__host__ __device__ constexpr int r16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ float2 unpack2(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}
// the value of a split pair register (hi + lo), two floats
__device__ __forceinline__ float2 join2(uint32_t h, uint32_t l) {
  const float2 a = unpack2(h), b = unpack2(l);
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return unpack2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a ~ h + m + l, three bf16 parts (~24 bits of a's significand)
__device__ __forceinline__ void split3(float a0, float a1, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(hv);
  const float r0 = a0 - hf.x, r1 = a1 - hf.y;
  const __nv_bfloat162 mv = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mv);
  h = *reinterpret_cast<const uint32_t*>(&hv);
  m = *reinterpret_cast<const uint32_t*>(&mv);
  l = pack_bf16(r0 - mf.x, r1 - mf.y);
}

// sums over lanes in a fixed pattern: the 4 lanes of a quad (one row of a
// fragment), the 8 rows of a fragment (lanes of one t), the warp
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Warp 0: the chunk's cum (inclusive cumsum of dts * a, 4 positions a
// lane) in f64, exp(cum) and w = exp(cum_last - cum), zero at and past c.
// The sum and the differences that go into exp are f64: |cum| reaches
// hundreds over a chunk, and exp turns an f32 rounding of it into a
// relative error of the gradient of that size times 2^-24.
__device__ __forceinline__ void chunk_decays(const float* dts, float a, int c,
                                             double* cum, float* ecum,
                                             float* wdec, int lane) {
  double v[4], run = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    run += 4 * lane + u < c ? (double)(dts[4 * lane + u] * a) : 0.0;
    v[u] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const double cl = __shfl_sync(0xffffffffu, incl, 31);  // cum[c - 1]
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = 4 * lane + u;
    const double cj = incl - run + v[u];
    cum[j] = cj;
    ecum[j] = j < c ? expf((float)cj) : 0.f;
    wdec[j] = j < c ? expf((float)(cl - cj)) : 0.f;
  }
}

// Rows [0, R) x columns [0, W) (W % 4 == 0) of a row-major global matrix
// (row r at src + r * stride; rows at or past nrow and columns at or past
// ncol read as zero) into shared memory, ld elements a row, by cp.async: a
// bf16 matrix as it is into hi; an f32 one raw, each quad's first two
// floats into its four hi slots and the last two into its lo slots, for
// split_quads to split in place.  The caller commits.
template <typename T>
__device__ __forceinline__ void stage_quads(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int ld,
                                            const T* src, long stride,
                                            int nrow, int ncol, int R, int W) {
  const int q = W / 4;
  for (int e = threadIdx.x; e < R * q; e += kSbThreads) {
    const int r = e / q, c4 = (e - r * q) * 4;
    const bool ok = r < nrow && c4 < ncol;
    const T* g = src + (ok ? r * stride + c4 : 0);
    if constexpr (std::is_same<T, float>::value) {
      cp_async8(hi + r * ld + c4, g, ok);
      cp_async8(lo + r * ld + c4, g + 2, ok);
    } else {
      cp_async8(hi + r * ld + c4, g, ok);
    }
  }
}
// After cp_async_wait: the quads this thread staged by stage_quads<float>,
// times scale[r] (or 1), split into bf16 hi and lo in place
__device__ __forceinline__ void split_quads(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int ld, int R,
                                            int W, const float* scale) {
  const int q = W / 4;
  for (int e = threadIdx.x; e < R * q; e += kSbThreads) {
    const int r = e / q, c4 = (e - r * q) * 4;
    const float2 a = *reinterpret_cast<const float2*>(hi + r * ld + c4);
    const float2 b = *reinterpret_cast<const float2*>(lo + r * ld + c4);
    const float f = scale != nullptr ? scale[r] : 1.f;
    uint2 h, l;
    split_bf16(a.x * f, a.y * f, h.x, l.x);
    split_bf16(b.x * f, b.y * f, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * ld + c4) = h;
    *reinterpret_cast<uint2*>(lo + r * ld + c4) = l;
  }
}

// The A fragment (rows row0 .. row0 + 15, depth col0 .. col0 + 15) of a
// row-major global matrix, rows at or past nrow and columns at or past ncol
// zero: bf16 as it is (hi; lo zero), f32 split into hi and lo
template <typename T>
__device__ __forceinline__ void load_a_frag(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4], const T* base,
                                            long stride, int row0, int nrow,
                                            int col0, int ncol, int lane) {
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + gr + 8 * (r & 1), col = col0 + 2 * t4 + 8 * (r >> 1);
    const bool ok = row < nrow && col < ncol;
    if constexpr (sizeof(T) == 2) {
      hi[r] = ok ? *reinterpret_cast<const uint32_t*>(base + row * stride + col)
                 : 0u;
      lo[r] = 0u;
    } else {
      const float2 v = ok ? ld2(base + row * stride + col)
                          : make_float2(0.f, 0.f);
      split_bf16(v.x, v.y, hi[r], lo[r]);
    }
  }
}
// the same in three bf16 parts for f32 (p[0] only for bf16)
template <typename T>
__device__ __forceinline__ void load_a_frag3(uint32_t (&p)[3][4],
                                             const T* base, long stride,
                                             int row0, int nrow, int col0,
                                             int ncol, int lane) {
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + gr + 8 * (r & 1), col = col0 + 2 * t4 + 8 * (r >> 1);
    const bool ok = row < nrow && col < ncol;
    if constexpr (sizeof(T) == 2) {
      p[0][r] = ok
                    ? *reinterpret_cast<const uint32_t*>(base + row * stride + col)
                    : 0u;
    } else {
      const float2 v = ok ? ld2(base + row * stride + col)
                          : make_float2(0.f, 0.f);
      split3(v.x, v.y, p[0][r], p[1][r], p[2][r]);
    }
  }
}

// c += a . b, a an f32 operand split (ah + al); b split (bh + bl) when
// kSplitB, else bf16 (bh)
template <bool kSplitB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_bf16(c, al, bh);
  if constexpr (kSplitB) mma_bf16(c, ah, bl);
  mma_bf16(c, ah, bh);
}

// S's layout, in K1's scratch and K3's shared memory: the tiles (it, jt <=
// it) in order, tile it (it + 1) / 2 + jt, each [16][kSLd] f32 (rows 4
// floats apart from a power of two: K3's transposed reads hit 32 banks)
constexpr int kSLd = 20;
constexpr int kSTile = 16 * kSLd;
__host__ __device__ constexpr int s_floats(int c) {
  return (r16(c) / 16) * (r16(c) / 16 + 1) / 2 * kSTile;
}

// (K1) S = C B^T of (b, nc, G), the tiles jt <= it (rows and columns past
// c zero): a CTA per (i-tile, chunk, group and batch row), warp w takes
// j-tile w <= it.
template <typename T>
__global__ void __launch_bounds__(kSbThreads)
    ssd_bwd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                      float* __restrict__ S, int s, int G, int N, int c) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int it = blockIdx.x, k = blockIdx.y, nc = gridDim.y;
  const int g = blockIdx.z % G, bi = blockIdx.z / G;
  const int jt = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int NS = r16(N) / 16;
  if (jt > it) return;
  const long tok = (long)G * N;
  const long off = ((long)bi * s + (long)k * c) * tok + (long)g * N;
  float acc[2][4] = {};
  for (int ks = 0; ks < NS; ++ks) {
    uint32_t a[3][4], bb[3][4];
    load_a_frag3<T>(a, Cm + off, tok, 16 * it, c, 16 * ks, N, lane);
    load_a_frag3<T>(bb, Bm + off, tok, 16 * jt, c, 16 * ks, N, lane);
    // B's 16 rows as the B fragments of two 8-column blocks
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if constexpr (kF32) {
        // the products of order <= 2, smallest first
        const int pa[6] = {2, 1, 0, 1, 0, 0}, pb[6] = {0, 1, 2, 0, 1, 0};
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          const uint32_t b2[2] = {bb[pb[e]][u], bb[pb[e]][u + 2]};
          mma_bf16(acc[u], a[pa[e]], b2);
        }
      } else {
        const uint32_t b2[2] = {bb[0][u], bb[0][u + 2]};
        mma_bf16(acc[u], a[0], b2);
      }
    }
  }
  float* St = S + (((long)bi * nc + k) * G + g) * s_floats(c) +
              ((it * (it + 1)) / 2 + jt) * kSTile;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    st2(St + gr * kSLd + 8 * u + 2 * t4, acc[u][0], acc[u][1]);
    st2(St + (gr + 8) * kSLd + 8 * u + 2 * t4, acc[u][2], acc[u][3]);
  }
}

// K2's shared memory (bytes): exp(cum) dy's pair [128][kStRows + 8], C
// (bf16, or the f32 pair) [128][kStCols + 8], cum f64, dt, exp(cum), w and
// the warps' parts of <dh1, h0>
template <typename T>
__host__ __device__ constexpr int state_smem_bytes() {
  return 2 * (2 * kSbMaxC * (kStRows + 8) +
              (sizeof(T) == 2 ? 1 : 2) * kSbMaxC * (kStCols + 8)) +
         8 * kSbMaxC + 4 * (3 * kSbMaxC + kSbWarps);
}

// (K2) the reverse state pass.  dy (b, s, H, P) f32; states, dh1 (b, nc,
// H, P, N) f32; dstate (b, H, P, N) f32 or null; hh (b, nc, H, gridDim.x)
// f32, each CTA's part of <dh1, h0> a chunk.  Warp w owns rows 16 (w & 1)
// and columns 16 (w >> 1) of the CTA's 32 x 64 tile.
template <typename T>
__global__ void __launch_bounds__(kSbThreads, 3)
    ssd_bwd_state_kernel(const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ states,
                         const float* __restrict__ dstate,
                         float* __restrict__ dh1, float* __restrict__ hh,
                         int s, int H, int G, int P, int N, int c) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LY = kStRows + 8, LC = kStCols + 8;
  extern __shared__ __align__(16) unsigned char sm2[];
  __nv_bfloat16* Yh = reinterpret_cast<__nv_bfloat16*>(sm2);  // [128][LY]
  __nv_bfloat16* Yl = Yh + kSbMaxC * LY;
  __nv_bfloat16* Ch = Yl + kSbMaxC * LY;                      // [128][LC]
  __nv_bfloat16* Cl = Ch + kSbMaxC * LC;                      // f32 only
  double* cum = reinterpret_cast<double*>(Ch + (kF32 ? 2 : 1) * kSbMaxC * LC);
  float* dts = reinterpret_cast<float*>(cum + kSbMaxC);
  float* ecum = dts + kSbMaxC;
  float* wdec = ecum + kSbMaxC;
  float* red = wdec + kSbMaxC;                                 // [kSbWarps]

  const int np = (P + kStRows - 1) / kStRows;
  const int p0 = (blockIdx.x % np) * kStRows, n0 = (blockIdx.x / np) * kStCols;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int nc = s / c, grp = h / (H / G), C16 = r16(c), NI = C16 / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const int pm = warp & 1, nq = warp >> 1;
  const float a = A[h];
  float acc[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + 16 * pm + gr + 8 * (r >> 1);
      const int n = n0 + 16 * nq + 8 * u + 2 * t4 + (r & 1);
      acc[u][r] = dstate != nullptr && p < P && n < N
                      ? dstate[(((long)bi * H + h) * P + p) * N + n]
                      : 0.f;
    }
  for (int k = nc - 1;; --k) {
    // dh1 of chunk k, and its part of <dh1, h0>
    const long sbase = (((long)bi * nc + k) * H + h) * P * N;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int hh2 = 0; hh2 < 2; ++hh2) {
        const int p = p0 + 16 * pm + gr + 8 * hh2;
        const int n = n0 + 16 * nq + 8 * u + 2 * t4;
        if (p < P && n < N) {
          const float v0 = acc[u][2 * hh2], v1 = acc[u][2 * hh2 + 1];
          st2(dh1 + sbase + (long)p * N + n, v0, v1);
          const float2 st = ld2(states + sbase + (long)p * N + n);
          part = fmaf(v0, st.x, fmaf(v1, st.y, part));
        }
      }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();              // red; every reader of the last chunk
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < kSbWarps; ++w) t += red[w];
      hh[(((long)bi * nc + k) * H + h) * gridDim.x + blockIdx.x] = t;
    }
    if (k == 0) break;
    // stage chunk k: dy's rows p0.., C's columns n0.., dt (warp 0's own)
    const long row0 = (long)bi * s + (long)k * c;
    stage_quads<float>(Yh, Yl, LY, dy + (row0 * H + h) * P + p0, (long)H * P,
                       c, P - p0, C16, kStRows);
    stage_quads<T>(Ch, Cl, LC, Cm + row0 * G * N + (long)grp * N + n0,
                   (long)G * N, c, N - n0, C16, kStCols);
    if (warp == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * lane + u;
        cp_async4(dts + j, dt + (row0 + (j < c ? j : 0)) * H + h, j < c);
      }
    cp_async_commit();
    cp_async_wait<0>();
    if (warp == 0) chunk_decays(dts, a, c, cum, ecum, wdec, lane);
    __syncthreads();              // ecum
    split_quads(Yh, Yl, LY, C16, kStRows, ecum);
    if constexpr (kF32) split_quads(Ch, Cl, LC, C16, kStCols, nullptr);
    __syncthreads();
    const float ec = ecum[c - 1];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[u][r] *= ec;
    for (int kt = 0; kt < NI; ++kt) {
      uint32_t ah[4], al[4], bh[4], bl[4] = {};
      const int aoff = (16 * kt + (mi >> 1) * 8 + (lane & 7)) * LY + 16 * pm +
                       (mi & 1) * 8;
      ldmatrix_x4_trans(ah, Yh + aoff);
      ldmatrix_x4_trans(al, Yl + aoff);
      const int boff = (16 * kt + (mi & 1) * 8 + (lane & 7)) * LC + 16 * nq +
                       (mi >> 1) * 8;
      ldmatrix_x4_trans(bh, Ch + boff);
      if constexpr (kF32) ldmatrix_x4_trans(bl, Cl + boff);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t b0[2] = {bh[2 * u], bh[2 * u + 1]};
        const uint32_t b1[2] = {bl[2 * u], bl[2 * u + 1]};
        mma3<kF32>(acc[u], ah, al, b0, b1);
      }
    }
  }
}

// K3's shared memory: element counts and bytes at the padded widths.
//   region: dy's pair and x (f32: a pair) [C16][P16 + 8], bf16; at a
//     phase's end B (phase A) or C (phase B) [parts][C16][N16 + 8]
//   hpair: h0's (phase A) or dh1's (phase B) pair [P16][N16 + 8]
//   sm: sum M of the head block, f32, the triangle's tiles in fragment
//     order [tile][8 registers][32 lanes]
//   st: S's tiles as K1 lays them out, f32
//   then cum f64 [128]; dt, exp(cum), w, the column sums' parts [8][128],
//   rowsum + o, r, x . dX [128] each, dcum's phase-A part [16][128], and
//   <dh1, h0>, all f32
struct ChunkLayout {
  int C16, N16, P16, region, hpair, sm, st, bytes;
  __host__ __device__ ChunkLayout(bool f32, int c, int N, int P) {
    C16 = r16(c);
    N16 = r16(N);
    P16 = r16(P);
    const int parts = f32 ? 2 : 1;
    const int dx = (2 + parts) * C16 * (P16 + 8);
    const int bc = parts * C16 * (N16 + 8);
    region = dx > bc ? dx : bc;
    hpair = 2 * P16 * (N16 + 8);
    const int NI = C16 / 16;
    sm = NI * (NI + 1) / 2 * 256;
    st = s_floats(c);
    bytes = 2 * (region + hpair) + 4 * (sm + st) + 8 * kSbMaxC +
            4 * ((3 + 8 + 3 + kSbMaxHeads) * kSbMaxC + 4);
  }
};

// (K3) the chunk pass.  S from K1; states, dh1 (b, nc, H, P, N) f32; hh
// (b, nc, H, nsl) from K2; dy (b, s, H, P) f32; dx (b, s, H, P) in x's
// type; ddt (b, s, H) f32; dA_part (b, nc, H) f32; dB_part, dC_part (b, s,
// H / hb, N) f32.  KNS, KNQ > 0 fix N16 / 16 and P16 / 16 (the models'
// shapes); 0 reads them from N and P.
template <typename T, int KNS, int KNQ>
__global__ void __launch_bounds__(kSbThreads, 1)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const float* __restrict__ S,
                         const float* __restrict__ states,
                         const float* __restrict__ dy,
                         const float* __restrict__ dh1,
                         const float* __restrict__ hh, int nsl,
                         T* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ dA_part,
                         float* __restrict__ dB_part,
                         float* __restrict__ dC_part, int s, int H, int G,
                         int P, int N, int c, int hb) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char sm3[];
  const ChunkLayout ly(kF32, c, N, P);
  const int NS = KNS > 0 ? KNS : ly.N16 / 16;
  const int NQ = KNQ > 0 ? KNQ : ly.P16 / 16;
  const int C16 = ly.C16, NI = C16 / 16;
  const int LX = 16 * NQ + 8, LN = 16 * NS + 8;
  __nv_bfloat16* Dh = reinterpret_cast<__nv_bfloat16*>(sm3);  // [C16][LX]
  __nv_bfloat16* Dl = Dh + C16 * LX;
  __nv_bfloat16* Xh = Dl + C16 * LX;     // x (bf16), or x's pair (f32)
  __nv_bfloat16* Xl = Xh + C16 * LX;
  __nv_bfloat16* Ob = Dh;                // B or C [parts][C16][LN]
  __nv_bfloat16* Obl = Ob + C16 * LN;
  __nv_bfloat16* Hh = Dh + ly.region;    // [16 NQ][LN]
  __nv_bfloat16* Hl = Hh + 16 * NQ * LN;
  float* Msum = reinterpret_cast<float*>(Dh + ly.region + ly.hpair);
  float* Ss = Msum + ly.sm;              // S's tiles
  double* cum = reinterpret_cast<double*>(Ss + ly.st);
  float* dts = reinterpret_cast<float*>(cum + kSbMaxC);
  float* ecum = dts + kSbMaxC;
  float* wdec = ecum + kSbMaxC;
  float* colpart = wdec + kSbMaxC;       // [8][128]
  float* rso = colpart + 8 * kSbMaxC;
  float* rv = rso + kSbMaxC;
  float* sxd = rv + kSbMaxC;
  float* pre = sxd + kSbMaxC;            // [kSbMaxHeads][128]
  float* hhs = pre + kSbMaxHeads * kSbMaxC;

  const int blk = blockIdx.x, k = blockIdx.y, bi = blockIdx.z;
  const int nblk = gridDim.x, nc = gridDim.y;
  const int hf = blk * hb, grp = hf / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  // the warp's 16 rows: i (phase A) and j (phase B); the two warps of a
  // sub-partition share the triangle's work evenly, as in the forward
  const int wt = warp < 4 ? warp : 11 - warp;
  const bool act = wt < NI;
  const int i_lo = 16 * wt + gr, i_hi = i_lo + 8;
  const long row0 = (long)bi * s + (long)k * c;
  const long tok = (long)G * N;
  const T* Bc = Bm + row0 * tok + (long)grp * N;
  const T* Cc = Cm + row0 * tok + (long)grp * N;
  const float* Sk = S + (((long)bi * nc + k) * G + grp) * ly.st;
  const long hstride = (long)P * N;

  // dy, x and hsrc (h0 or dh1) of head h, and dt (warp 0's own copies),
  // raw into the tiles' hi and lo slots by cp.async, then warp 0's decays
  // and every thread's split of its own quads in place
  auto stage_head = [&](int h, const float* hsrc) {
    const long xo = (row0 * H + h) * P;
    stage_quads<float>(Dh, Dl, LX, dy + xo, (long)H * P, c, P, C16, 16 * NQ);
    stage_quads<T>(Xh, Xl, LX, x + xo, (long)H * P, c, P, C16, 16 * NQ);
    stage_quads<float>(Hh, Hl, LN, hsrc, N, P, N, 16 * NQ, 16 * NS);
    if (warp == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * lane + u;
        cp_async4(dts + j, dt + (row0 + (j < c ? j : 0)) * H + h, j < c);
      }
    cp_async_commit();
    cp_async_wait<0>();
    if (warp == 0) chunk_decays(dts, A[h], c, cum, ecum, wdec, lane);
    split_quads(Dh, Dl, LX, C16, 16 * NQ, nullptr);
    if constexpr (kF32) split_quads(Xh, Xl, LX, C16, 16 * NQ, nullptr);
    split_quads(Hh, Hl, LN, 16 * NQ, 16 * NS, nullptr);
  };
  const long hbase = ((long)bi * nc + k) * H;   // (row, chunk)'s first head
  // B or C into the region (after every reader of dy and x), split
  auto stage_bc = [&](const T* src) {
    stage_quads<T>(Ob, Obl, LN, src, tok, c, N, C16, 16 * NS);
    cp_async_commit();
    cp_async_wait<0>();
    if constexpr (kF32) split_quads(Ob, Obl, LN, C16, 16 * NS, nullptr);
    __syncthreads();
  };
  // x[j][p], x[j][p + 1] from the staged x (f32: hi + lo)
  auto x_at = [&](int j, int p) {
    if constexpr (kF32) {
      return join2(*reinterpret_cast<const uint32_t*>(Xh + j * LX + p),
                   *reinterpret_cast<const uint32_t*>(Xl + j * LX + p));
    } else {
      return unpack2(*reinterpret_cast<const uint32_t*>(Xh + j * LX + p));
    }
  };

  // ---- phase A: rows i; dC's sum over the block's heads ------------------
  float acc[16][4];                       // dC, then dB (8 columns a block)
#pragma unroll
  for (int u = 0; u < 16; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[u][r] = 0.f;
  float q_lo = 0.f, q_hi = 0.f;           // the lane's share of sum_n dC C
  for (int e = tid; e < ly.st / 4; e += kSbThreads)
    cp_async16(Ss + 4 * e, Sk + 4 * e, true);
  for (int hl = 0; hl < hb; ++hl) {
    const int h = hf + hl;
    stage_head(h, states + (hbase + h) * hstride);
    __syncthreads();
    if (act) {
      uint32_t yh[4][4], yl[4][4];        // dy's A fragments of the rows
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        if (kq >= NQ) continue;
        const int off = (16 * wt + (mi & 1) * 8 + (lane & 7)) * LX + 16 * kq +
                        (mi >> 1) * 8;
        ldmatrix_x4(yh[kq], Dh + off);
        ldmatrix_x4(yl[kq], Dl + off);
      }
      const double ci_lo = cum[i_lo], ci_hi = cum[i_hi];
      float rs_lo = 0.f, rs_hi = 0.f;
      for (int jt = 0; jt <= wt; ++jt) {
        float2 sv[2][2];                  // S at the tile's fragment positions
        const float* st = Ss + ((wt * (wt + 1)) / 2 + jt) * kSTile;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sv[u][e] = ld2(st + (gr + 8 * e) * kSLd + 8 * u + 2 * t4);
        float mt[2][4] = {};
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          if (kq >= NQ) continue;
          const int off = (16 * jt + (mi >> 1) * 8 + (lane & 7)) * LX +
                          16 * kq + (mi & 1) * 8;
          uint32_t xb[4], xl[4] = {};
          ldmatrix_x4(xb, Xh + off);
          if constexpr (kF32) ldmatrix_x4(xl, Xl + off);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t b0[2] = {xb[2 * u], xb[2 * u + 1]};
            const uint32_t b1[2] = {xl[2 * u], xl[2 * u + 1]};
            mma3<kF32>(mt[u], yh[kq], yl[kq], b0, b1);
          }
        }
        // M = L dt_j (dy x^T) on j <= i < c; R = S o M
        float* tp = Msum + ((wt * (wt + 1)) / 2 + jt) * 256 + lane;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float cs[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = r < 2 ? i_lo : i_hi;
            const int j = 16 * jt + 8 * u + 2 * t4 + (r & 1);
            const double ci = r < 2 ? ci_lo : ci_hi;
            const float m = i < c && j <= i
                                ? mt[u][r] * dts[j] * expf((float)(ci - cum[j]))
                                : 0.f;
            const float2 sp = sv[u][r >> 1];
            const float R = m * ((r & 1) ? sp.y : sp.x);
            if (r < 2)
              rs_lo += R;
            else
              rs_hi += R;
            cs[r & 1] += R;
            float* q = tp + (4 * u + r) * 32;
            *q = hl ? *q + m : m;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = col_sum(cs[e]);
            if (gr == 0) colpart[wt * kSbMaxC + 16 * jt + 8 * u + 2 * t4 + e] = v;
          }
        }
      }
      rs_lo = quad_sum(rs_lo);
      rs_hi = quad_sum(rs_hi);
      // dC += (exp(cum) o dy) h0; o from the change of the lane's sum_n dC C
      const float e_lo = ecum[i_lo], e_hi = ecum[i_hi];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        if (kq >= NQ) continue;
        uint32_t eh[4], el[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = join2(yh[kq][r], yl[kq][r]);
          const float e = (r & 1) ? e_hi : e_lo;
          split_bf16(v.x * e, v.y * e, eh[r], el[r]);
        }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          if (nb >= NS) continue;
          const int off = (16 * kq + (mi & 1) * 8 + (lane & 7)) * LN + 16 * nb +
                          (mi >> 1) * 8;
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, Hh + off);
          ldmatrix_x4_trans(bl, Hl + off);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t b0[2] = {bh[2 * u], bh[2 * u + 1]};
            const uint32_t b1[2] = {bl[2 * u], bl[2 * u + 1]};
            mma3<true>(acc[2 * nb + u], eh, el, b0, b1);
          }
        }
      }
      float qn_lo = 0.f, qn_hi = 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int n = 8 * u + 2 * t4;
        if (u >= 2 * NS || n >= N) continue;
        const float2 c_lo = i_lo < c ? ld2(Cc + i_lo * tok + n)
                                     : make_float2(0.f, 0.f);
        const float2 c_hi = i_hi < c ? ld2(Cc + i_hi * tok + n)
                                     : make_float2(0.f, 0.f);
        qn_lo = fmaf(acc[u][0], c_lo.x, fmaf(acc[u][1], c_lo.y, qn_lo));
        qn_hi = fmaf(acc[u][2], c_hi.x, fmaf(acc[u][3], c_hi.y, qn_hi));
      }
      const float o_lo = quad_sum(qn_lo - q_lo), o_hi = quad_sum(qn_hi - q_hi);
      q_lo = qn_lo;
      q_hi = qn_hi;
      if (t4 == 0) {
        rso[i_lo] = rs_lo + o_lo;
        rso[i_hi] = rs_hi + o_hi;
      }
    }
    __syncthreads();                      // colpart, rso; every reader of the tiles
    // dcum's part known now: rowsum(R) + o - colsum(R), the column sums
    // over the i-tiles in order
    for (int i = tid; i < C16; i += kSbThreads) {
      float cs = 0.f;
      for (int it = i / 16; it < NI; ++it) cs += colpart[it * kSbMaxC + i];
      pre[hl * kSbMaxC + i] = rso[i] - cs;
    }
  }
  // dC += (sum M) B
  stage_bc(Bc);
  if (act) {
    for (int jt = 0; jt <= wt; ++jt) {
      const float* tp = Msum + ((wt * (wt + 1)) / 2 + jt) * 256 + lane;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_bf16(tp[2 * q * 32], tp[(2 * q + 1) * 32], ah[q], al[q]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (nb >= NS) continue;
        const int off = (16 * jt + (mi & 1) * 8 + (lane & 7)) * LN + 16 * nb +
                        (mi >> 1) * 8;
        uint32_t bh[4], bl[4] = {};
        ldmatrix_x4_trans(bh, Ob + off);
        if constexpr (kF32) ldmatrix_x4_trans(bl, Obl + off);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t b0[2] = {bh[2 * u], bh[2 * u + 1]};
          const uint32_t b1[2] = {bl[2 * u], bl[2 * u + 1]};
          mma3<kF32>(acc[2 * nb + u], ah, al, b0, b1);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int n = 8 * u + 2 * t4;
      if (u >= 2 * NS || n >= N) continue;
      if (i_lo < c)
        st2(dC_part + ((row0 + i_lo) * nblk + blk) * N + n, acc[u][0], acc[u][1]);
      if (i_hi < c)
        st2(dC_part + ((row0 + i_hi) * nblk + blk) * N + n, acc[u][2], acc[u][3]);
      acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
    }
  }
  __syncthreads();                        // every reader of B

  // ---- phase B: rows j; dX, ddt, dA; dB's sum -----------------------------
  for (int hl = 0; hl < hb; ++hl) {
    const int h = hf + hl;
    stage_head(h, dh1 + (hbase + h) * hstride);
    if (tid == 0) {                       // <dh1, h0>: K2's parts in order
      float t = 0.f;
      for (int q = 0; q < nsl; ++q) t += hh[(hbase + h) * nsl + q];
      hhs[0] = t;
    }
    __syncthreads();
    if (act) {
      const int j_lo = i_lo, j_hi = i_hi;
      const float wj_lo = wdec[j_lo], wj_hi = wdec[j_hi];
      const float dj_lo = dts[j_lo], dj_hi = dts[j_hi];
      float xa[8][4];                     // dX (8 columns of P a block)
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) xa[u][r] = 0.f;
      // B dh1^T
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (ks >= NS) continue;
        uint32_t bh[4], bl[4];
        load_a_frag<T>(bh, bl, Bc, tok, 16 * wt, c, 16 * ks, N, lane);
#pragma unroll
        for (int nq = 0; nq < 4; ++nq) {
          if (nq >= NQ) continue;
          const int off = (16 * nq + (mi >> 1) * 8 + (lane & 7)) * LN +
                          16 * ks + (mi & 1) * 8;
          uint32_t dh[4], dl[4];
          ldmatrix_x4(dh, Hh + off);
          ldmatrix_x4(dl, Hl + off);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t b0[2] = {dh[2 * u], dh[2 * u + 1]};
            const uint32_t b1[2] = {dl[2 * u], dl[2 * u + 1]};
            // B (bf16) . dh1's pair; f32 B adds its lo . dh1's hi
            if constexpr (kF32) mma_bf16(xa[2 * nq + u], bl, b0);
            mma_bf16(xa[2 * nq + u], bh, b1);
            mma_bf16(xa[2 * nq + u], bh, b0);
          }
        }
      }
      // r_j = w_j X_j . (B dh1^T)_j; then dX = w (B dh1^T)
      float r_lo = 0.f, r_hi = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (u >= 2 * NQ) continue;
        const int p = 8 * u + 2 * t4;
        const float2 x_lo = x_at(j_lo, p), x_hi = x_at(j_hi, p);
        r_lo = fmaf(x_lo.x, xa[u][0], fmaf(x_lo.y, xa[u][1], r_lo));
        r_hi = fmaf(x_hi.x, xa[u][2], fmaf(x_hi.y, xa[u][3], r_hi));
        xa[u][0] *= wj_lo;
        xa[u][1] *= wj_lo;
        xa[u][2] *= wj_hi;
        xa[u][3] *= wj_hi;
      }
      r_lo = quad_sum(r_lo) * wj_lo * dj_lo;
      r_hi = quad_sum(r_hi) * wj_hi * dj_hi;
      if (t4 == 0) {
        rv[j_lo] = r_lo;
        rv[j_hi] = r_hi;
      }
      // dX += (S o L)^T dy over the i-tiles at and below the diagonal
      const double cj_lo = cum[j_lo], cj_hi = cum[j_hi];
      for (int it = wt; it < NI; ++it) {
        const float* st = Ss + ((it * (it + 1)) / 2 + wt) * kSTile;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = (q & 1) ? j_hi : j_lo;
          const double cj = (q & 1) ? cj_hi : cj_lo;
          const int il = 2 * t4 + 8 * (q >> 1);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 16 * it + il + e;
            v[e] = i < c && i >= j ? st[(il + e) * kSLd + gr + 8 * (q & 1)] *
                                         expf((float)(cum[i] - cj))
                                   : 0.f;
          }
          split_bf16(v[0], v[1], ah[q], al[q]);
        }
#pragma unroll
        for (int nq = 0; nq < 4; ++nq) {
          if (nq >= NQ) continue;
          const int off = (16 * it + (mi & 1) * 8 + (lane & 7)) * LX + 16 * nq +
                          (mi >> 1) * 8;
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, Dh + off);
          ldmatrix_x4_trans(bl, Dl + off);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t b0[2] = {bh[2 * u], bh[2 * u + 1]};
            const uint32_t b1[2] = {bl[2 * u], bl[2 * u + 1]};
            mma3<true>(xa[2 * nq + u], ah, al, b0, b1);
          }
        }
      }
      // dx = dt dX; x . dX a row
      float sx_lo = 0.f, sx_hi = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int p = 8 * u + 2 * t4;
        if (u >= 2 * NQ || p >= P) continue;
        const float2 x_lo = x_at(j_lo, p), x_hi = x_at(j_hi, p);
        sx_lo = fmaf(x_lo.x, xa[u][0], fmaf(x_lo.y, xa[u][1], sx_lo));
        sx_hi = fmaf(x_hi.x, xa[u][2], fmaf(x_hi.y, xa[u][3], sx_hi));
        if (j_lo < c)
          st2(dx + ((row0 + j_lo) * H + h) * P + p, dj_lo * xa[u][0],
              dj_lo * xa[u][1]);
        if (j_hi < c)
          st2(dx + ((row0 + j_hi) * H + h) * P + p, dj_hi * xa[u][2],
              dj_hi * xa[u][3]);
      }
      sx_lo = quad_sum(sx_lo);
      sx_hi = quad_sum(sx_hi);
      if (t4 == 0) {
        sxd[j_lo] = sx_lo;
        sxd[j_hi] = sx_hi;
      }
      // dB += (w dt o x) dh1
      const float sc_lo = wj_lo * dj_lo, sc_hi = wj_hi * dj_hi;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        if (kq >= NQ) continue;
        const int off = (16 * wt + (mi & 1) * 8 + (lane & 7)) * LX + 16 * kq +
                        (mi >> 1) * 8;
        uint32_t xh[4], xl[4] = {}, ah[4], al[4];
        ldmatrix_x4(xh, Xh + off);
        if constexpr (kF32) ldmatrix_x4(xl, Xl + off);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = kF32 ? join2(xh[r], xl[r]) : unpack2(xh[r]);
          const float f = (r & 1) ? sc_hi : sc_lo;
          split_bf16(v.x * f, v.y * f, ah[r], al[r]);
        }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          if (nb >= NS) continue;
          const int boff = (16 * kq + (mi & 1) * 8 + (lane & 7)) * LN + 16 * nb +
                           (mi >> 1) * 8;
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, Hh + boff);
          ldmatrix_x4_trans(bl, Hl + boff);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t b0[2] = {bh[2 * u], bh[2 * u + 1]};
            const uint32_t b1[2] = {bl[2 * u], bl[2 * u + 1]};
            mma3<true>(acc[2 * nb + u], ah, al, b0, b1);
          }
        }
      }
    }
    __syncthreads();                      // rv, sxd, hhs
    if (warp == 0) {
      // dcum (4 positions a lane), its reverse cumsum da by a warp scan,
      // ddt = x . dX + A da and the chunk's part of dA
      float v[4], rsum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * lane + u;
        v[u] = i < c ? pre[hl * kSbMaxC + i] - rv[i] : 0.f;
        rsum += i < c ? rv[i] : 0.f;
      }
      rsum = warp_sum(rsum);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * lane + u == c - 1) v[u] += ecum[c - 1] * hhs[0] + rsum;
      const float tot = (v[0] + v[1]) + (v[2] + v[3]);
      float incl = tot;                   // sum over this lane and above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float a = A[h];
      float run = incl - tot, da_dt = 0.f;
#pragma unroll
      for (int u = 3; u >= 0; --u) {
        const int i = 4 * lane + u;
        run += v[u];
        if (i < c) {
          ddt[(row0 + i) * H + h] = sxd[i] + a * run;
          da_dt = fmaf(dts[i], run, da_dt);
        }
      }
      da_dt = warp_sum(da_dt);
      if (lane == 0) dA_part[hbase + h] = da_dt;
    }
  }
  // dB += (sum M)^T C: A fragments of (sum M)^T gathered from the tiles
  // (it, wt) in fragment order
  stage_bc(Cc);
  if (act) {
    for (int it = wt; it < NI; ++it) {
      const float* tp = Msum + ((it * (it + 1)) / 2 + wt) * 256;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int reg = 4 * (q & 1) + 2 * (q >> 1) + (gr & 1);
        const int src = 8 * t4 + (gr >> 1);
        split_bf16(tp[reg * 32 + src], tp[reg * 32 + src + 4], ah[q], al[q]);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (nb >= NS) continue;
        const int off = (16 * it + (mi & 1) * 8 + (lane & 7)) * LN + 16 * nb +
                        (mi >> 1) * 8;
        uint32_t bh[4], bl[4] = {};
        ldmatrix_x4_trans(bh, Ob + off);
        if constexpr (kF32) ldmatrix_x4_trans(bl, Obl + off);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t b0[2] = {bh[2 * u], bh[2 * u + 1]};
          const uint32_t b1[2] = {bl[2 * u], bl[2 * u + 1]};
          mma3<kF32>(acc[2 * nb + u], ah, al, b0, b1);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int n = 8 * u + 2 * t4;
      if (u >= 2 * NS || n >= N) continue;
      if (i_lo < c)
        st2(dB_part + ((row0 + i_lo) * nblk + blk) * N + n, acc[u][0], acc[u][1]);
      if (i_hi < c)
        st2(dB_part + ((row0 + i_hi) * nblk + blk) * N + n, acc[u][2], acc[u][3]);
    }
  }
}

// (K4) dB, dC (b, s, G, N) in B's type: each group's head-block partials
// (b, s, H / hb, N) summed in order; dA (H,): the (b, nc) partials in
// order.
template <typename T>
__global__ void __launch_bounds__(kSbThreads)
    ssd_bwd_sum_kernel(const float* __restrict__ dB_part,
                       const float* __restrict__ dC_part,
                       const float* __restrict__ dA_part, T* __restrict__ dB,
                       T* __restrict__ dC, float* __restrict__ dA, long n_bc,
                       int H, int G, int N, int nbg, int n_part_rows) {
  const long e = (long)blockIdx.x * kSbThreads + threadIdx.x;
  if (e < n_bc) {
    const int n = (int)(e % N), g = (int)((e / N) % G);
    const long tok = e / ((long)N * G);
    float sb = 0.f, sc = 0.f;
    for (int u = 0; u < nbg; ++u) {
      const long off = (tok * G * nbg + (long)g * nbg + u) * N + n;
      sb += dB_part[off];
      sc += dC_part[off];
    }
    put(dB + e, sb);
    put(dC + e, sc);
  } else if (e < n_bc + H) {
    const int h = (int)(e - n_bc);
    float t = 0.f;
    for (int q = 0; q < n_part_rows; ++q) t += dA_part[(long)q * H + h];
    dA[h] = t;
  }
}

template <typename T, int KNS, int KNQ>
cudaError_t chunk_attr(int smem) {
  return cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, KNS, KNQ>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int KNS, int KNQ>
cudaError_t launch_ssd_bwd_t(const void* x, const float* dt, const float* A,
                             const void* B, const void* C,
                             const float* states, const float* dy,
                             const float* dstate, float* S, float* dh1,
                             float* hh, int nsl, void* dx, float* ddt,
                             float* dA_part, float* dB_part, float* dC_part,
                             float* dA, void* dB, void* dC, int b, int s,
                             int H, int P, int G, int N, int chunk, int hb,
                             cudaStream_t stream) {
  const int nc = s / chunk;
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  ssd_bwd_cb_kernel<T>
      <<<dim3(r16(chunk) / 16, nc, G * b), kSbThreads, 0, stream>>>(
          Bt, Ct, S, s, G, N, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem2 = state_smem_bytes<T>();
  err = cudaFuncSetAttribute(ssd_bwd_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<T><<<dim3(nsl, H, b), kSbThreads, smem2, stream>>>(
      dt, A, Ct, dy, states, dstate, dh1, hh, s, H, G, P, N, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem3 = ChunkLayout(sizeof(T) == 4, chunk, N, P).bytes;
  err = chunk_attr<T, KNS, KNQ>(smem3);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T, KNS, KNQ>
      <<<dim3(H / hb, nc, b), kSbThreads, smem3, stream>>>(
          static_cast<const T*>(x), dt, A, Bt, Ct, S, states, dy, dh1, hh,
          nsl, static_cast<T*>(dx), ddt, dA_part, dB_part, dC_part, s, H, G,
          P, N, chunk, hb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n_bc = (long)b * s * G * N;
  const long blocks = (n_bc + H + kSbThreads - 1) / kSbThreads;
  ssd_bwd_sum_kernel<T><<<(unsigned)blocks, kSbThreads, 0, stream>>>(
      dB_part, dC_part, dA_part, static_cast<T*>(dB), static_cast<T*>(dC),
      dA, n_bc, H, G, N, H / G / hb, b * nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ssd_bwd_shape(const void* x, const float* dt,
                                 const float* A, const void* B, const void* C,
                                 const float* states, const float* dy,
                                 const float* dstate, float* S, float* dh1,
                                 float* hh, int nsl, void* dx, float* ddt,
                                 float* dA_part, float* dB_part,
                                 float* dC_part, float* dA, void* dB, void* dC,
                                 int b, int s, int H, int P, int G, int N,
                                 int chunk, int hb, cudaStream_t stream) {
  // the models' shapes (N 128 or 64, P 64) unroll their tile loops
  const int ns = (N + 15) / 16, nq = (P + 15) / 16;
#define REPRO_SSD_BWD_SHAPE(NS_, NQ_)                                         \
  if (ns == NS_ && nq == NQ_)                                                 \
    return launch_ssd_bwd_t<T, NS_, NQ_>(                                     \
        x, dt, A, B, C, states, dy, dstate, S, dh1, hh, nsl, dx, ddt,         \
        dA_part, dB_part, dC_part, dA, dB, dC, b, s, H, P, G, N, chunk, hb,   \
        stream);
  REPRO_SSD_BWD_SHAPE(8, 4)
  REPRO_SSD_BWD_SHAPE(4, 4)
#undef REPRO_SSD_BWD_SHAPE
  return launch_ssd_bwd_t<T, 0, 0>(x, dt, A, B, C, states, dy, dstate, S, dh1,
                                   hh, nsl, dx, ddt, dA_part, dB_part,
                                   dC_part, dA, dB, dC, b, s, H, P, G, N,
                                   chunk, hb, stream);
}

template <typename T, int KNS, int KNQ>
cudaError_t chunk_occupancy(int smem, int* n) {
  cudaError_t err = chunk_attr<T, KNS, KNQ>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, ssd_bwd_chunk_kernel<T, KNS, KNQ>, kSbThreads, smem);
}

}  // namespace

void ssd_bwd_scratch(int chunk, int P, int N, int* s_len, int* nsl) {
  *s_len = s_floats(chunk);
  *nsl = ((P + kStRows - 1) / kStRows) * ((N + kStCols - 1) / kStCols);
}

cudaError_t launch_ssd_bwd(bool bf16, const void* x, const float* dt,
                           const float* A, const void* B, const void* C,
                           const float* states, const float* dy,
                           const float* dstate, float* S, float* dh1,
                           float* hh, void* dx, float* ddt, float* dA_part,
                           float* dB_part, float* dC_part, float* dA, void* dB,
                           void* dC, int b, int s, int H, int P, int G, int N,
                           int chunk, int hb, cudaStream_t stream) {
  if (chunk > kSbMaxC || P > 64 || N > 128 || hb < 1 || hb > kSbMaxHeads ||
      (H / G) % hb)
    return cudaErrorInvalidValue;
  int s_len, nsl;
  ssd_bwd_scratch(chunk, P, N, &s_len, &nsl);
  if (bf16)
    return launch_ssd_bwd_shape<__nv_bfloat16>(
        x, dt, A, B, C, states, dy, dstate, S, dh1, hh, nsl, dx, ddt, dA_part,
        dB_part, dC_part, dA, dB, dC, b, s, H, P, G, N, chunk, hb, stream);
  return launch_ssd_bwd_shape<float>(
      x, dt, A, B, C, states, dy, dstate, S, dh1, hh, nsl, dx, ddt, dA_part,
      dB_part, dC_part, dA, dB, dC, b, s, H, P, G, N, chunk, hb, stream);
}

cudaError_t ssd_bwd_ctas_per_sm(bool bf16, int chunk, int N, int P, int* n) {
  const int smem = ChunkLayout(!bf16, chunk, N, P).bytes;
  const int ns = (N + 15) / 16, nq = (P + 15) / 16;
  if (bf16) {
    using bf = __nv_bfloat16;
    if (ns == 8 && nq == 4) return chunk_occupancy<bf, 8, 4>(smem, n);
    if (ns == 4 && nq == 4) return chunk_occupancy<bf, 4, 4>(smem, n);
    return chunk_occupancy<bf, 0, 0>(smem, n);
  }
  if (ns == 8 && nq == 4) return chunk_occupancy<float, 8, 4>(smem, n);
  if (ns == 4 && nq == 4) return chunk_occupancy<float, 4, 4>(smem, n);
  return chunk_occupancy<float, 0, 0>(smem, n);
}

}  // namespace repro_torch
