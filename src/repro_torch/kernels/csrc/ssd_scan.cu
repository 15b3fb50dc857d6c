// Mamba2 SSD chunked scan for Hopper (sm_90a): the within-chunk quadratic
// dual form and the across-chunk linear recurrence of arXiv:2405.21060 §6 in
// one kernel, the four products of a chunk on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_chunked, body
// _ssd_kernel).  That kernel runs a grid (batch, head, chunk) with the chunk
// axis sequential, carries the state in VMEM scratch from one grid step to
// the next, and is fed head-major copies of x, dt, B and C with B and C
// repeated to every head.  Here one CTA per (P-slice, head, batch row) loops
// over the chunks itself (CTAs run in no order), x, dt, B and C are read in
// place in their (b, s, ...) layouts and types (B and C by group), and
// y[:, p] and state[p, :] depend only on column p of x, so P is cut into
// slices with no merge (the wrapper picks 64 columns, or 32 when b * H
// CTAs would leave SMs idle).
//
// Per chunk of c <= 128 positions, with cum the inclusive cumsum of dt * A
// and X = x * dt, the 8 warps compute with mma.sync.m16n8k16 (bf16
// operands, f32 accumulators), padding c, N and the slice to multiples of
// 16 with zeros in shared memory:
//   P4  Y   = exp(cum_i) (C . state^T)          c x P, depth N
//   P1  S   = C . B^T                            c x c, depth N
//   P3  Y  += (S * exp(cum_i - cum_j), j <= i) . X   c x P, depth c
//   P5  state = exp(cum_last) state + (X * exp(cum_last - cum_j))^T . B
// Warp w owns the 16 output rows of i-tile w (w < 4) or 11 - w, so the two
// warps of a sub-partition share the triangle's work evenly; P1 and P3 run
// only the 16 x 16 tiles on or below the diagonal, one tile of S at a time
// in registers, whose accumulator (after * L) is the A operand of P3.  The
// state is f32 in the P5 warps' accumulators while it is updated, and sits
// between chunks in shared memory as a bf16 pair (below).
//
// Precision.  The limit is 2e-4 of max |y| against the f32 plain version,
// and y rounded to bf16 once already reads 1.3e-3 to 3e-3, so no f32
// operand is rounded to bf16 once.  An f32 operand a is split into hi =
// bf16(a) and lo = bf16(a - hi) (a = hi + lo to ~2^-17): a product with a
// bf16 operand b on the other side is hi.b + lo.b (two MMAs: P4 with C, P5
// with B), f32 on both sides is hi.hi + hi.lo + lo.hi (three: P3, and all
// four products when x, B and C arrive in f32).  P1 in the bf16 forward is
// one exact MMA.  The state's bf16 pair is re-split from the f32
// accumulator every chunk, so its error does not grow with the chunks.
//
// Staging.  C's fragments of a warp's 16 rows go from global memory straight
// to registers (both products that read C take it as the A operand of the
// same rows).  Everything else is a cp.async issued at once after the
// chunk's last reader is done: B to shared memory, and each thread's x
// quads raw into the very slots of X's pair its split will fill, so a
// thread splits its own quads in place once its own copies land, with no
// barrier and no registers held across the wait.  Shared memory at
// mamba2's shapes (c = N = 128, 64 columns): B 34 KB, X's pair 36 KB, the
// state's pair 34 KB — 106 KB, so two CTAs share an SM (bf16, 128
// registers a thread) and one CTA's staging overlaps the other's MMAs; a
// ring of staged chunks would not fit beside the second CTA, and every
// register a deeper prefetch held spilled.  f32 inputs need B's pair too
// and take one CTA per SM.  The models' tile counts (N 128 or 64, slices
// of 64 or 32 columns) are template arguments, so the tile loops unroll
// and the shared-memory offsets fold; other shapes read them at run time.
//
// For training the kernel also writes, when given the buffer, the state
// entering each chunk (b, nc, H, P, N) f32: zero for the first chunk, the
// P5 warps' f32 accumulators for the others.  ssd_backward.cu reads it;
// inference passes none and its launch is unchanged.
//
// Bound on the H100 at the SSM forward's 4 x 4096 tokens (mamba2, bf16):
// 527 MB of x, B, C and the f32 y, 0.157 ms at the HBM rate, against ~146
// GFLOP of bf16 MMAs with the splits and the 16-tile triangle counted,
// 0.148 ms at 989 TFLOP/s: bytes.  The work per (head, chunk) is fixed by
// the tile shapes, not the data.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernels.h"
#include "mma_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kSsdWarps = 8;
constexpr int kSsdThreads = 32 * kSsdWarps;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Bytes of dynamic shared memory: B (one bf16 copy, or hi and lo for f32
// inputs) [c16][N16 + 8]; X's pair [2][c16][ps16 + 8]; the state's pair
// [2][ps16][N16 + 8] (bf16); cum, the decay to the chunk's end and dt, f32
// [128] each.  Rows of 16-byte units in odd number: ldmatrix is conflict-free.
__host__ __device__ inline int ssd_smem_bytes(bool bf16, int c, int N,
                                              int ps) {
  const int C16 = round16(c), N16 = round16(N), P16 = round16(ps);
  return 2 * ((bf16 ? 1 : 2) * C16 * (N16 + 8) + 2 * C16 * (P16 + 8) +
              2 * P16 * (N16 + 8)) +
         4 * 3 * 128;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}
// four floats -> hi and lo bf16 quads at 8-byte aligned shared addresses
__device__ __forceinline__ void store_split4(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float4 v) {
  uint2 h, l;
  split_bf16(v.x, v.y, h.x, l.x);
  split_bf16(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// A fragment (rows row0 .. row0 + 15, depth 16s .. 16s + 15) of a row-major
// global matrix whose row r starts at base + r * stride; rows at or past
// nrow and columns at or past ncol read as zero.  f32 inputs give hi and lo.
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
      float2 v = make_float2(0.f, 0.f);
      if (ok) v = *reinterpret_cast<const float2*>(base + row * stride + col);
      split_bf16(v.x, v.y, hi[r], lo[r]);
    }
  }
}

// the 16 rows row0 .. of C as A fragments of its NS 16-deep slices
template <typename T>
__device__ __forceinline__ void load_c_frags(uint32_t (&hi)[8][4],
                                             uint32_t (&lo)[8][4],
                                             const T* base, long stride,
                                             int row0, int nrow, int ncol,
                                             int NS, int lane) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < NS)
      load_a_frag<T>(hi[k], lo[k], base, stride, row0, nrow, 16 * k, ncol,
                     lane);
}

// KNS, KNQ > 0 fix N16 / 16 and ps16 / 16 at compile time (the models'
// shapes: the tile loops unroll and shared-memory offsets fold); 0 reads
// them from N and ps
template <typename T, int KNS, int KNQ>
__global__ void __launch_bounds__(kSsdThreads, sizeof(T) == 2 ? 2 : 1)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ state_out, float* __restrict__ states_out,
               int s, int H, int G, int P, int N, int c, int ps, int bw) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int NB = kBf16 ? 1 : 2;          // B copies in shared memory
  extern __shared__ __align__(16) __nv_bfloat16 ssm[];
  const int NS = KNS > 0 ? KNS : round16(N) / 16;
  const int NQ = KNQ > 0 ? KNQ : round16(ps) / 16;
  const int C16 = round16(c), N16 = 16 * NS, P16 = 16 * NQ;
  const int LB = N16 + 8, LX = P16 + 8;       // row strides (elements)
  __nv_bfloat16* Bs = ssm;                    // [NB][C16][LB]
  __nv_bfloat16* Xh = Bs + NB * C16 * LB;     // [C16][LX]
  __nv_bfloat16* Xl = Xh + C16 * LX;
  __nv_bfloat16* Sh = Xl + C16 * LX;          // state pair [P16][LB]
  __nv_bfloat16* Sl = Sh + P16 * LB;
  float* cum = reinterpret_cast<float*>(Sl + P16 * LB);   // [128]
  float* wdec = cum + 128;                    // exp(cum_last - cum_j) [128]
  float* dts = wdec + 128;                    // the chunk's dt [128]

  const int p0 = blockIdx.x * ps, h = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const float a = A[h];
  const int NI = C16 / 16;
  // P1, P3, P4: the warp's i-tile
  const int it = warp < 4 ? warp : 11 - warp;
  // P5: the warp's m-tile of the state's rows and its 16-column pairs
  const int WS = kSsdWarps / NQ, pm = warp % NQ, pw = warp / NQ;

  // zero B (its padding is never copied) and the state
  for (int e = tid; e < NB * C16 * LB; e += kSsdThreads)
    Bs[e] = __float2bfloat16(0.f);
  for (int e = tid; e < 2 * P16 * LB; e += kSsdThreads)
    Sh[e] = __float2bfloat16(0.f);
  // the state entering each chunk (the backward's input), when asked for:
  // zero for the first, the f32 accumulators below for the others
  const long st_row = (long)H * P * N;        // one chunk's states
  float* st_slice = states_out == nullptr
                        ? nullptr
                        : states_out + (long)bi * (s / c) * st_row +
                              ((long)h * P + p0) * N;
  if (st_slice != nullptr)
    for (int e = tid; e < ps * N; e += kSsdThreads) st_slice[e] = 0.f;
  __syncthreads();

  const long tok_stride = (long)G * N;        // B and C: one token's row
  // B, X, cum and wdec of the chunk at t0 into shared memory.  Every load is
  // an asynchronous copy, all in flight at once: B to its place (f32 B is
  // split on the way), a thread's x quads raw into the very slots of X's
  // pair that its split will take (bf16: the hi slot; f32: both), and the
  // dt of their rows; after its own copies land, a thread splits its quads
  // in place, and warp 0 scans the chunk's dt A into cum and the decay.
  auto stage = [&](int t0) {
    const long row0 = (long)bi * s + t0;
    const int p4 = P16 >> 2, nx = C16 * p4;
    for (int e = tid; e < nx; e += kSsdThreads) {
      const int j = e / p4, p = (e % p4) * 4;
      const bool ok = j < c && p < ps;
      const T* src = x + ((row0 + (ok ? j : 0)) * H + h) * P + p0 + (ok ? p : 0);
      if constexpr (kBf16) {
        cp_async8(Xh + j * LX + p, src, ok);
      } else {
        cp_async8(Xh + j * LX + p, src, ok);
        cp_async8(Xl + j * LX + p, src + 2, ok);
      }
      cp_async4(dts + j, dt + (row0 + (j < c ? j : 0)) * H + h, j < c);
    }
    if (warp == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * lane + u;
        cp_async4(dts + j, dt + (row0 + (j < c ? j : 0)) * H + h, j < c);
      }
    const T* Bg = Bm + row0 * tok_stride + grp * N;
    const int nq = N / bw;
    for (int e = tid; e < c * nq; e += kSsdThreads) {
      const int j = e / nq, n = (e % nq) * bw;
      if constexpr (kBf16) {
        if (bw == 8)
          cp_async16(Bs + j * LB + n, Bg + j * tok_stride + n, true);
        else
          cp_async8(Bs + j * LB + n, Bg + j * tok_stride + n, true);
      } else {
        store_split4(Bs + j * LB + n, Bs + (C16 + j) * LB + n,
                     ld4(Bg + j * tok_stride + n));
      }
    }
    cp_async_commit();
    cp_async_wait<0>();                       // this thread's copies
    for (int e = tid; e < nx; e += kSsdThreads) {
      const int j = e / p4, p = (e % p4) * 4;
      float4 v;
      if constexpr (kBf16) {
        v = ld4(Xh + j * LX + p);
      } else {
        const float2 a0 = *reinterpret_cast<const float2*>(Xh + j * LX + p);
        const float2 a1 = *reinterpret_cast<const float2*>(Xl + j * LX + p);
        v = make_float4(a0.x, a0.y, a1.x, a1.y);
      }
      const float d = dts[j];
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      store_split4(Xh + j * LX + p, Xl + j * LX + p, v);
    }
    if (warp == 0) {                          // cum: 4 positions a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        run += 4 * lane + u < c ? dts[4 * lane + u] * a : 0.f;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float cl = __shfl_sync(0xffffffffu, incl, 31);  // cum[c - 1]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * lane + u;
        cum[j] = incl - run + v[u];
        wdec[j] = j < c ? exp2f((cl - (incl - run + v[u])) * kLog2e) : 0.f;
      }
    }
  };

  uint32_t cf[8][4], cfl[8][4];               // C fragments (hi, lo)
  stage(0);
  if (it < NI)
    load_c_frags<T>(cf, cfl, Cm + (long)bi * s * tok_stride + grp * N,
                    tok_stride, 16 * it, c, N, NS, lane);
  for (int t0 = 0; t0 < s; t0 += c) {
    __syncthreads();
    const float cl = cum[c - 1];

    if (it < NI) {
      const int i_lo = 16 * it + gr, i_hi = i_lo + 8;
      const float ci_lo = i_lo < c ? cum[i_lo] : 0.f;
      const float ci_hi = i_hi < c ? cum[i_hi] : 0.f;
      float yv[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[q][r] = 0.f;

      // P4: Y = exp(cum_i) C . state^T (the state entering the chunk)
      if (t0 > 0) {
        const float e_lo = i_lo < c ? exp2f(ci_lo * kLog2e) : 0.f;
        const float e_hi = i_hi < c ? exp2f(ci_hi * kLog2e) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= NQ) continue;
          float tv[2][4] = {};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (k >= NS) continue;
            const int off = (16 * q + (mi >> 1) * 8 + (lane & 7)) * LB + 16 * k +
                            (mi & 1) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, Sh + off);
            ldmatrix_x4(bl, Sl + off);
            const uint32_t h0[2] = {bh[0], bh[1]}, h1[2] = {bh[2], bh[3]};
            const uint32_t l0[2] = {bl[0], bl[1]}, l1[2] = {bl[2], bl[3]};
            mma_bf16(tv[0], cf[k], h0);
            mma_bf16(tv[0], cf[k], l0);
            mma_bf16(tv[1], cf[k], h1);
            mma_bf16(tv[1], cf[k], l1);
            if constexpr (!kBf16) {
              mma_bf16(tv[0], cfl[k], h0);
              mma_bf16(tv[1], cfl[k], h1);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            yv[2 * q + u][0] = e_lo * tv[u][0];
            yv[2 * q + u][1] = e_lo * tv[u][1];
            yv[2 * q + u][2] = e_hi * tv[u][2];
            yv[2 * q + u][3] = e_hi * tv[u][3];
          }
        }
      }

      // P1 and P3, one 16 x 16 tile of S at a time, j-tiles up to the
      // diagonal
      for (int jt = 0; jt <= it; ++jt) {
        float sc[2][4] = {};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k >= NS) continue;
          const int off = (16 * jt + (mi >> 1) * 8 + (lane & 7)) * LB + 16 * k +
                          (mi & 1) * 8;
          uint32_t bh[4];
          ldmatrix_x4(bh, Bs + off);
          const uint32_t h0[2] = {bh[0], bh[1]}, h1[2] = {bh[2], bh[3]};
          mma_bf16(sc[0], cf[k], h0);
          mma_bf16(sc[1], cf[k], h1);
          if constexpr (!kBf16) {
            uint32_t bl[4];
            ldmatrix_x4(bl, Bs + C16 * LB + off);
            const uint32_t l0[2] = {bl[0], bl[1]}, l1[2] = {bl[2], bl[3]};
            mma_bf16(sc[0], cf[k], l0);
            mma_bf16(sc[1], cf[k], l1);
            mma_bf16(sc[0], cfl[k], h0);
            mma_bf16(sc[1], cfl[k], h1);
          }
        }
        // * L: exp(cum_i - cum_j) where j <= i < c, else 0
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = r < 2 ? i_lo : i_hi;
            const int j = 16 * jt + 8 * u + 2 * t4 + (r & 1);
            const float ci = r < 2 ? ci_lo : ci_hi;
            sc[u][r] = i < c && j <= i ? sc[u][r] * exp2f((ci - cum[j]) * kLog2e)
                                        : 0.f;
          }
        uint32_t ah[4], al[4];
        split_bf16(sc[0][0], sc[0][1], ah[0], al[0]);
        split_bf16(sc[0][2], sc[0][3], ah[1], al[1]);
        split_bf16(sc[1][0], sc[1][1], ah[2], al[2]);
        split_bf16(sc[1][2], sc[1][3], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= NQ) continue;
          const int off = (16 * jt + (mi & 1) * 8 + (lane & 7)) * LX + 16 * q +
                          (mi >> 1) * 8;
          uint32_t xh[4], xl[4];
          ldmatrix_x4_trans(xh, Xh + off);
          ldmatrix_x4_trans(xl, Xl + off);
          const uint32_t h0[2] = {xh[0], xh[1]}, h1[2] = {xh[2], xh[3]};
          const uint32_t l0[2] = {xl[0], xl[1]}, l1[2] = {xl[2], xl[3]};
          mma_bf16(yv[2 * q], ah, h0);
          mma_bf16(yv[2 * q], ah, l0);
          mma_bf16(yv[2 * q], al, h0);
          mma_bf16(yv[2 * q + 1], ah, h1);
          mma_bf16(yv[2 * q + 1], ah, l1);
          mma_bf16(yv[2 * q + 1], al, h1);
        }
      }

      const long row0 = (long)bi * s + t0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = 8 * q + 2 * t4;
        if (q >= 2 * NQ || p >= ps) continue;
        if (i_lo < c)
          *reinterpret_cast<float2*>(y + ((row0 + i_lo) * H + h) * P + p0 + p) =
              make_float2(yv[q][0], yv[q][1]);
        if (i_hi < c)
          *reinterpret_cast<float2*>(y + ((row0 + i_hi) * H + h) * P + p0 + p) =
              make_float2(yv[q][2], yv[q][3]);
      }
    }

    // P5: state <- exp(cum_last) state + (X wdec)^T . B, a warp owning rows
    // 16 pm .. of the state and its column pairs pw, pw + WS, ...
    float st[4][2][4];
    const bool p5 = pw < WS;
    if (p5) {
      const float dl = exp2f(cl * kLog2e);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = pw + WS * k;
        if (q >= NS) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int off = (16 * pm + gr + 8 * hh) * LB + 16 * q + 8 * u + 2 * t4;
            const float2 vh = unpack_bf16(*reinterpret_cast<const uint32_t*>(Sh + off));
            const float2 vl = unpack_bf16(*reinterpret_cast<const uint32_t*>(Sl + off));
            st[k][u][2 * hh] = dl * (vh.x + vl.x);
            st[k][u][2 * hh + 1] = dl * (vh.y + vl.y);
          }
      }
      for (int kt = 0; kt < NI; ++kt) {
        const int off = (16 * kt + (mi >> 1) * 8 + (lane & 7)) * LX + 16 * pm +
                        (mi & 1) * 8;
        uint32_t xh[4], xl[4], ah[4], al[4];
        ldmatrix_x4_trans(xh, Xh + off);
        ldmatrix_x4_trans(xl, Xl + off);
        // a[0], a[1]: positions 16 kt + 2 t4 (+1); a[2], a[3]: + 8
        const float w0 = wdec[16 * kt + 2 * t4], w1 = wdec[16 * kt + 2 * t4 + 1];
        const float w2 = wdec[16 * kt + 2 * t4 + 8];
        const float w3 = wdec[16 * kt + 2 * t4 + 9];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 vh = unpack_bf16(xh[r]), vl = unpack_bf16(xl[r]);
          split_bf16((vh.x + vl.x) * (r < 2 ? w0 : w2),
                     (vh.y + vl.y) * (r < 2 ? w1 : w3), ah[r], al[r]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = pw + WS * k;
          if (q >= NS) continue;
          const int boff = (16 * kt + (mi & 1) * 8 + (lane & 7)) * LB + 16 * q +
                           (mi >> 1) * 8;
          uint32_t bh[4];
          ldmatrix_x4_trans(bh, Bs + boff);
          const uint32_t h0[2] = {bh[0], bh[1]}, h1[2] = {bh[2], bh[3]};
          mma_bf16(st[k][0], ah, h0);
          mma_bf16(st[k][0], al, h0);
          mma_bf16(st[k][1], ah, h1);
          mma_bf16(st[k][1], al, h1);
          if constexpr (!kBf16) {
            uint32_t bl[4];
            ldmatrix_x4_trans(bl, Bs + C16 * LB + boff);
            const uint32_t l0[2] = {bl[0], bl[1]}, l1[2] = {bl[2], bl[3]};
            mma_bf16(st[k][0], ah, l0);
            mma_bf16(st[k][1], ah, l1);
          }
        }
      }
    }
    __syncthreads();                          // every reader of this chunk is done

    const bool last = t0 + c >= s;
    if (p5) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = pw + WS * k;
        if (q >= NS) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = 16 * pm + gr + 8 * hh, n = 16 * q + 8 * u + 2 * t4;
            const float v0 = st[k][u][2 * hh], v1 = st[k][u][2 * hh + 1];
            if (last) {
              if (p < ps && n < N)
                *reinterpret_cast<float2*>(
                    state_out + (((long)bi * H + h) * P + p0 + p) * N + n) =
                    make_float2(v0, v1);
            } else {
              if (st_slice != nullptr && p < ps && n < N)
                *reinterpret_cast<float2*>(
                    st_slice + (t0 / c + 1) * st_row + (long)p * N + n) =
                    make_float2(v0, v1);
              uint32_t vh, vl;
              split_bf16(v0, v1, vh, vl);
              *reinterpret_cast<uint32_t*>(Sh + p * LB + n) = vh;
              *reinterpret_cast<uint32_t*>(Sl + p * LB + n) = vl;
            }
          }
      }
    }
    if (!last) {
      stage(t0 + c);
      if (it < NI)
        load_c_frags<T>(cf, cfl,
                        Cm + ((long)bi * s + t0 + c) * tok_stride + grp * N,
                        tok_stride, 16 * it, c, N, NS, lane);
    }
  }
}

template <typename T, int KNS, int KNQ>
cudaError_t launch_ssd_t(const void* x, const float* dt, const float* A,
                         const void* B, const void* C, float* y, float* state,
                         float* states, int b, int s, int H, int P, int G,
                         int N, int chunk, int ps, cudaStream_t stream) {
  const int smem = ssd_smem_bytes(sizeof(T) == 2, chunk, N, ps);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, KNS, KNQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // bf16 B rows by 16-byte copies where N and B's address allow, else 8
  const int bw = sizeof(T) == 2 && N % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(B) % 16 == 0
                     ? 8
                     : 4;
  const dim3 grid(P / ps, H, b);
  ssd_kernel<T, KNS, KNQ><<<grid, kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), y, state, states, s, H, G, P, N, chunk, ps,
      bw);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_ssd(bool bf16, const void* x, const float* dt,
                       const float* A, const void* B, const void* C, float* y,
                       float* state, float* states, int b, int s, int H, int P,
                       int G, int N, int chunk, int ps, cudaStream_t stream) {
  if (!bf16)
    return launch_ssd_t<float, 0, 0>(x, dt, A, B, C, y, state, states, b, s,
                                     H, P, G, N, chunk, ps, stream);
  // the bf16 forwards' shapes: N 128 (mamba2) or 64 (zamba2), slices of 64
  // or 32 columns
  using bf = __nv_bfloat16;
  const int ns = (N + 15) / 16, nq = (ps + 15) / 16;
#define REPRO_SSD_SHAPE(NS_, NQ_)                                             \
  if (ns == NS_ && nq == NQ_)                                                 \
    return launch_ssd_t<bf, NS_, NQ_>(x, dt, A, B, C, y, state, states, b, s, \
                                      H, P, G, N, chunk, ps, stream);
  REPRO_SSD_SHAPE(8, 4)
  REPRO_SSD_SHAPE(8, 2)
  REPRO_SSD_SHAPE(4, 4)
  REPRO_SSD_SHAPE(4, 2)
#undef REPRO_SSD_SHAPE
  return launch_ssd_t<bf, 0, 0>(x, dt, A, B, C, y, state, states, b, s, H, P,
                                G, N, chunk, ps, stream);
}

}  // namespace repro_torch
