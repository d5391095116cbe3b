// Warp-level TF32 tensor-core helpers of the f32 flash backward on Hopper
// (sm_90a): flash_bwd_tf32.cu.
//
// Every product is mma.sync m16n8k8 (TF32 in, f32 accumulate), issued
// three times for error-compensated 3xTF32: each f32 operand element x is
// split where its fragment is loaded into big = tf32(x) and small =
// tf32(x - big), both rounded to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds (an operand handed to the instruction unrounded
// would be truncated by the hardware), and
//     a . b ~ a_small . b_big + a_big . b_small + a_big . b_big
// goes into one f32 accumulator, the small terms first so that the big
// product is added last.  big + small is x to within 2^-22 |x|; the
// dropped a_small . b_small is below 2^-22 |a b|.  So the products keep
// f32 accuracy at a third of the dense TF32 rate.  The rounding is two
// integer instructions (to_tf32): cvt.rna.tf32.f32 compiles to four on
// sm_90a (its NaN and Inf guards), and the split runs on every operand
// element a warp loads, so it made the kernels issue-bound.
//
// The tensor cores' f32 accumulation truncates.  A long sum of truncated
// additions into one large accumulator drifts: the gradient products sum
// over the whole sequence (4096 rows at full width) and drifted 1.4e-3
// from plain, 126 times what the same sums on the CUDA cores give.  So
// each product sums a short run of its terms into a zeroed partial on the
// tensor cores and adds the partial to its accumulator with a rounding
// f32 add: strip_pm a streamed tile's rows, strip_abt 32 columns of D.
//
// A warp owns a strip of 16 rows.  The fragment layouts, per lane l with
// g = l / 4 and t = l % 4:
// - A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//   a3 (g + 8, t + 4);
// - B (8 x 8, column major): b0 (k = t, n = g), b1 (k = t + 4, n = g);
// - C (16 x 8 f32): c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t),
//   c3 (g + 8, 2 t + 1).
// A 16 x 8 C tile is not an A fragment (A's columns are t and t + 4, C's
// 2 t and 2 t + 1), but the sum over k is free of order: a product whose
// A is a C tile of the score strip permutes k inside each 8-wide slice,
// A's slot t taking C's column 2 t and slot t + 4 column 2 t + 1
// (c_to_a), and its B reads row 2 t of the slice for slot t and 2 t + 1
// for slot t + 4 (strip_pm).  So p and ds stay in registers.
//
// Shared f32 tiles have a row stride LD = the row plus 4 elements, LD = 4
// (mod 32) words: ldmatrix's 8 row addresses of a phase fall in 8 distinct
// 16-byte bank groups, and the permuted B reads of strip_pm, word
// 2 t LD + g = 8 t + g (mod 32), in 32 distinct banks.  The non-transposed
// operands come by ldmatrix (b16): a 16-byte row of an 8 x 8 b16 tile is
// four f32 elements, so lane l receives element (l / 4, l % 4) of an 8 x 4
// f32 tile.  ldmatrix.trans moves 16-bit halves and cannot serve 32-bit
// data, so the transposed B of strip_pm comes by plain shared loads.
// cp.async and ldmatrix are mma_bf16.cuh's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mma_tf32 {

using mma_bf16::cp_async16;

// an A fragment, split: x = big + small, each tf32
struct Frag4 {
  uint32_t big[4], small[4];
};

// one B fragment, split
struct Frag2 {
  uint32_t big[2], small[2];
};

// x rounded to nearest (ties away from zero) to tf32, what
// cvt.rna.tf32.f32 gives: half of the 13 dropped bits added to the
// pattern (a carry rounds the magnitude up, into the exponent if need be),
// then cleared; 10 stored mantissa bits remain.  Inf stays Inf, NaN NaN.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ Frag4 split4(float x0, float x1, float x2, float x3) {
  Frag4 f;
  split(x0, f.big[0], f.small[0]);
  split(x1, f.big[1], f.small[1]);
  split(x2, f.big[2], f.small[2]);
  split(x3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ Frag4 split4(const uint32_t (&r)[4]) {
  return split4(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                __uint_as_float(r[3]));
}

__device__ __forceinline__ Frag2 split2(float x0, float x1) {
  Frag2 f;
  split(x0, f.big[0], f.small[0]);
  split(x1, f.big[1], f.small[1]);
  return f;
}

// c (16 x 8 f32) += a (16 x 8 tf32, row) . b (8 x 8 tf32, col)
__device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: the small terms first, the big product last
__device__ __forceinline__ void mma3(float (&c)[4], const Frag4& a, const Frag2& b) {
  mma1(c, a.small, b.big[0], b.big[1]);
  mma1(c, a.big, b.small[0], b.small[1]);
  mma1(c, a.big, b.big[0], b.big[1]);
}

// four 8 x 4 f32 tiles by one ldmatrix: lanes 8 i .. 8 i + 7 give the row
// addresses of tile i, lane l receives element (l / 4, l % 4) of tile i in
// r[i]
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  mma_bf16::ldsm4(r, reinterpret_cast<const mma_bf16::bf16*>(p));
}

// rows [row0, row0 + ROWS) of one (batch, head) slice (row stride st) into
// dst (row stride LD) by 16-byte cp.async over the block's NT threads;
// rows at or past n land as zeros
template <int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long st,
                                          int row0, int n) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * LD + c, ok ? base + (long long)(row0 + r) * st + c : base, ok);
  }
}

// acc[j] (8-column tile j) += A (16 rows at a) . B (NB rows at b)^T over D:
// a score strip of the warp, row r of A against row 8 j + c of B; each 32
// columns of D summed into a zeroed partial, added by a rounding f32 add
template <int D, int NB, int LD>
__device__ __forceinline__ void strip_abt(float (&acc)[NB / 8][4], const float* a,
                                          const float* b, int lane) {
  // A: lanes 0-7 rows 0-7 at column 0 (a0), 8-15 rows 8-15 at 0 (a1),
  // 16-23 rows 0-7 at 4 (a2), 24-31 rows 8-15 at 4 (a3)
  const float* pa = a + (lane & 15) * LD + (lane >> 4) * 4;
  // B: lanes 0-7 rows 0-7 at column 0 (b0 of tile j), 8-15 the same at 4
  // (b1), 16-23 rows 8-15 at 0 (b0 of tile j + 1), 24-31 at 4 (b1)
  const float* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 4;
  constexpr int KC = D < 32 ? D : 32;  // the columns of D a partial sums
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += KC) {
    float part[NB / 8][4] = {};
#pragma unroll
    for (int kd = k0; kd < k0 + KC; kd += 8) {
      uint32_t ar[4];
      ldsm4(ar, pa + kd);
      const Frag4 af = split4(ar);
#pragma unroll
      for (int j = 0; j < NB / 8; j += 2) {
        uint32_t br[4];
        ldsm4(br, pb + j * 8 * LD + kd);
        mma3(part[j], af, split2(__uint_as_float(br[0]), __uint_as_float(br[1])));
        mma3(part[j + 1], af, split2(__uint_as_float(br[2]), __uint_as_float(br[3])));
      }
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// C tile x (c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8,
// 2 t + 1)) as the split A fragment of its 8-wide slice with k permuted:
// a0 (g, slot t) = c0, a1 (g + 8, t) = c2, a2 (g, t + 4) = c1,
// a3 (g + 8, t + 4) = c3
__device__ __forceinline__ Frag4 c_to_a(const float (&x)[4]) {
  return split4(x[0], x[2], x[1], x[3]);
}

// acc[n] (8-column tile n of D) += P . M: P the warp's 16 x NB strip in C
// tiles (p[kk] holds columns 8 kk .. 8 kk + 7), M the NB rows at m, each of
// D columns; k permuted as c_to_a: B's slot t (b0) is row 8 kk + 2 t,
// slot t + 4 (b1) row 8 kk + 2 t + 1, both at column 8 n + g.  Each tile's
// NB-row sum goes into a zeroed partial, added to acc[n] by a rounding
// f32 add (see the note at the top)
template <int D, int NB, int LD>
__device__ __forceinline__ void strip_pm(float (&acc)[D / 8][4], const float (&p)[NB / 8][4],
                                         const float* m, int lane) {
  Frag4 af[NB / 8];
#pragma unroll
  for (int kk = 0; kk < NB / 8; ++kk) af[kk] = c_to_a(p[kk]);
  const float* pm = m + 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NB / 8; ++kk) {
      const float* e = pm + kk * 8 * LD + n * 8;
      mma3(part, af[kk], split2(e[0], e[LD]));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// the warp's 16 rows [row0, row0 + 16) of a (B, n, H, D) f32 output from
// its accumulators; rows at or past n are not written
template <int D>
__device__ __forceinline__ void store_strip(float* out, const float (&acc)[D / 8][4], int b,
                                            int h, int H, int row0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = row0 + g + 8 * half;
    if (pos >= n) continue;
    float* row = out + (((long long)b * n + pos) * H + h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(row + nd * 8) =
          make_float2(acc[nd][2 * half], acc[nd][2 * half + 1]);
  }
}

}  // namespace mma_tf32
