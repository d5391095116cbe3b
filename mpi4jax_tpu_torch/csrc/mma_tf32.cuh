// Warp-level TF32 tensor-core helpers of the f32 flash kernels on Hopper
// (sm_90a): the forward (flash_fwd_tf32.cu) and the backward
// (flash_bwd_tf32.cu).
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
//
// The split costs more instructions than the products it feeds.  A tile
// that every warp of a block reads can be split once, as it lands, into a
// big and a small tile in shared memory (split_rows); the products then
// take it as a SplitTile and read both halves' fragments with no
// arithmetic (the forward does so for K and V).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mma_tf32 {

using mma_bf16::cp_async16;
using mma_bf16::cp_async4;

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

// a shared f32 tile split once into its TF32 halves (split_rows): big and
// small, each with the raw tile's row stride.  strip_abt and strip_pm take
// their B tile either raw (a const float*, each fragment split where it is
// loaded) or split (a SplitTile, its fragments read as they stand): they
// are written once, and reach B only through the overloads of at, b_pair
// and b_rows below, which inline to what either kind needs.
struct SplitTile {
  const float* big;
  const float* small;
};

// tile t advanced by off elements
__device__ __forceinline__ const float* at(const float* t, int off) { return t + off; }

__device__ __forceinline__ SplitTile at(SplitTile t, int off) {
  return SplitTile{t.big + off, t.small + off};
}

// the B fragments of two neighbouring 8-column tiles of strip_abt, from
// one ldmatrix of four 8 x 4 tiles at p: frag(i) is tile i's, split where
// it is taken
struct RawPair {
  uint32_t r[4];
  __device__ __forceinline__ Frag2 frag(int i) const {
    return split2(__uint_as_float(r[2 * i]), __uint_as_float(r[2 * i + 1]));
  }
};

__device__ __forceinline__ RawPair b_pair(const float* p) {
  RawPair x;
  ldsm4(x.r, p);
  return x;
}

// the same from a split tile: one ldmatrix of each half
struct SplitPair {
  uint32_t big[4], small[4];
  __device__ __forceinline__ Frag2 frag(int i) const {
    return Frag2{{big[2 * i], big[2 * i + 1]}, {small[2 * i], small[2 * i + 1]}};
  }
};

__device__ __forceinline__ SplitPair b_pair(SplitTile p) {
  SplitPair x;
  ldsm4(x.big, p.big);
  ldsm4(x.small, p.small);
  return x;
}

// one B fragment of strip_pm, the elements at e and e + ld: split where
// they are loaded, or read from a split tile
__device__ __forceinline__ Frag2 b_rows(const float* e, int ld) { return split2(e[0], e[ld]); }

__device__ __forceinline__ Frag2 b_rows(SplitTile e, int ld) {
  return Frag2{{__float_as_uint(e.big[0]), __float_as_uint(e.big[ld])},
               {__float_as_uint(e.small[0]), __float_as_uint(e.small[ld])}};
}

// rows [0, ROWS) of the raw tile src (row stride LD, D columns) split into
// the tiles big and small (the same stride) over the block's NT threads,
// four elements a thread at a time
template <int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void split_rows(float* big, float* small, const float* src) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int off = (idx / CH) * LD + (idx % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + off);
    const Frag4 f = split4(x.x, x.y, x.z, x.w);
    float4 b, s;
    b.x = __uint_as_float(f.big[0]);
    b.y = __uint_as_float(f.big[1]);
    b.z = __uint_as_float(f.big[2]);
    b.w = __uint_as_float(f.big[3]);
    s.x = __uint_as_float(f.small[0]);
    s.y = __uint_as_float(f.small[1]);
    s.z = __uint_as_float(f.small[2]);
    s.w = __uint_as_float(f.small[3]);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(small + off) = s;
  }
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
// a score strip of the warp, row r of A against row 8 j + c of B (b raw or
// split); each 32 columns of D summed into a zeroed partial, added by a
// rounding f32 add
template <int D, int NB, int LD, typename TB>
__device__ __forceinline__ void strip_abt(float (&acc)[NB / 8][4], const float* a, TB b,
                                          int lane) {
  // A: lanes 0-7 rows 0-7 at column 0 (a0), 8-15 rows 8-15 at 0 (a1),
  // 16-23 rows 0-7 at 4 (a2), 24-31 rows 8-15 at 4 (a3)
  const float* pa = a + (lane & 15) * LD + (lane >> 4) * 4;
  // B: lanes 0-7 rows 0-7 at column 0 (b0 of tile j), 8-15 the same at 4
  // (b1), 16-23 rows 8-15 at 0 (b0 of tile j + 1), 24-31 at 4 (b1)
  const TB pb = at(b, ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 4);
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
        const auto bp = b_pair(at(pb, j * 8 * LD + kd));
        mma3(part[j], af, bp.frag(0));
        mma3(part[j + 1], af, bp.frag(1));
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
// tiles (p[kk] holds columns 8 kk .. 8 kk + 7), M the NB rows at m (raw or
// split), each of D columns; k permuted as c_to_a: B's slot t (b0) is row
// 8 kk + 2 t, slot t + 4 (b1) row 8 kk + 2 t + 1, both at column 8 n + g.
// Each tile's NB-row sum goes into a zeroed partial, added to acc[n] by a
// rounding f32 add (see the note at the top)
template <int D, int NB, int LD, typename TM>
__device__ __forceinline__ void strip_pm(float (&acc)[D / 8][4], const float (&p)[NB / 8][4],
                                         TM m, int lane) {
  Frag4 af[NB / 8];
#pragma unroll
  for (int kk = 0; kk < NB / 8; ++kk) af[kk] = c_to_a(p[kk]);
  const TM pm = at(m, 2 * (lane & 3) * LD + (lane >> 2));
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NB / 8; ++kk)
      mma3(part, af[kk], b_rows(at(pm, kk * 8 * LD + n * 8), LD));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// the (Tq, Tk) mask of a.mask at query rows [q0, q0 + ROWS), key columns
// [k0, k0 + COLS) into dst (row stride MLD) over the block's NT threads:
// by 4-byte cp.async when by4 (Tk and the pointer multiples of 4), else
// byte by byte; entries past a.Tq or a.Tk land as 0 (not valid)
template <int ROWS, int COLS, int MLD, int NT, typename Args>
__device__ __forceinline__ void load_mask(uint8_t* dst, const Args& a, int q0, int k0,
                                          bool by4) {
  if (by4) {
    constexpr int CH = COLS / 4;  // 4-byte chunks a row
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
      const int r = idx / CH, c = (idx % CH) * 4;
      const bool ok = q0 + r < a.Tq && k0 + c < a.Tk;
      cp_async4(dst + r * MLD + c,
                ok ? a.mask + (long long)(q0 + r) * a.Tk + k0 + c : a.mask, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += NT) {
      const int r = idx / COLS, c = idx % COLS;
      const bool ok = q0 + r < a.Tq && k0 + c < a.Tk;
      dst[r * MLD + c] = ok ? a.mask[(long long)(q0 + r) * a.Tk + k0 + c] : 0;
    }
  }
}

template <typename Args>
__device__ __forceinline__ bool mask_by4(const Args& a) {
  return a.Tk % 4 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 4 == 0;
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
