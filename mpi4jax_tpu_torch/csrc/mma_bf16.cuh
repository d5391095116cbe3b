// Warp-level bf16 tensor-core helpers of the flash kernels on Hopper
// (sm_90a): the backward (flash_bwd_mma.cu) and the forward
// (flash_fwd_mma.cu).
//
// Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), with
// operands from shared memory by ldmatrix; tiles reach shared memory by
// cp.async, whose zero-fill form (source size 0) stands for rows past the
// end of a sequence.  A warp owns a strip of 16 rows.  The fragment
// layouts, per lane l with g = l / 4 and t = l % 4:
// - A (16 x 16, row major): a0 row g, a1 row g + 8, each at columns 2 t
//   and 2 t + 1; a2, a3 the same 8 columns on;
// - B (16 x 8, column major): b0 rows 2 t, 2 t + 1 of column g; b1 the
//   same 8 rows on;
// - C (16 x 8 f32): c0, c1 row g, c2, c3 row g + 8, at columns 2 t and
//   2 t + 1.
// So the f32 accumulators of two neighbouring 8-column tiles are, element
// for element, the A fragment of one 16 x 16 tile (to_a_fragments).
//
// Shared tiles have a row stride LD (elements) that the kernel picks: the
// row plus 16 bytes of padding, so that the 8 row addresses of an
// ldmatrix phase fall in 8 distinct 4-bank groups.  NT is the block's
// thread count, which load_rows spreads its copies over.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros (nothing read) unless ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes from global to shared memory; zeros (nothing read) unless ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of the
// i-th, lane l receives its row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, transposed: lane l receives rows 2 (l % 4) and 2 (l % 4) + 1
// of column l / 4
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of one (batch, head) slice (row stride st) into
// dst (row stride LD) by 16-byte cp.async over the block's NT threads;
// rows at or past n land as zeros
template <int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long st,
                                          int row0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * LD + c, ok ? base + (long long)(row0 + r) * st + c : base, ok);
  }
}

// acc[j] (8-column tile j) += A (16 rows at a) . B (NB rows at b)^T over D:
// a score strip of the warp, row r of A against row 8 j + c of B
template <int D, int NB, int LD>
__device__ __forceinline__ void strip_abt(float (&acc)[NB / 8][4], const bf16* a,
                                          const bf16* b, int lane) {
  // A: lanes 0-15 rows 0-15 at column 0, lanes 16-31 the same at column 8
  const bf16* pa = a + (lane & 15) * LD + (lane >> 4) * 8;
  // B: lanes 0-7 rows 0-7 at column 0 (b0 of tile j), 8-15 the same at 8
  // (b1), 16-23 rows 8-15 at 0 (b0 of tile j + 1), 24-31 at 8 (b1)
  const bf16* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t af[4];
    ldsm4(af, pa + kd);
#pragma unroll
    for (int j = 0; j < NB / 8; j += 2) {
      uint32_t bf[4];
      ldsm4(bf, pb + j * 8 * LD + kd);
      mma(acc[j], af, bf[0], bf[1]);
      mma(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[n] (8-column tile n of D) += P . M: P the warp's 16 x NB strip as bf16
// A fragments (pf[kk] holds columns 16 kk .. 16 kk + 15), M the NB rows at
// m, each of D columns
template <int D, int NB, int LD>
__device__ __forceinline__ void strip_pm(float (&acc)[D / 8][4], const uint32_t (&pf)[NB / 16][4],
                                         const bf16* m, int lane) {
  // transposed B: lanes 0-7 rows 0-7 at column 0 (b0 of tile n), 8-15 rows
  // 8-15 at 0 (b1), 16-23 rows 0-7 at 8 (b0 of tile n + 1), 24-31 rows
  // 8-15 at 8 (b1)
  const bf16* pm = m + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NB / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bf[4];
      ldsm4t(bf, pm + kk * 16 * LD + n * 8);
      mma(acc[n], pf[kk], bf[0], bf[1]);
      mma(acc[n + 1], pf[kk], bf[2], bf[3]);
    }
  }
}

// the f32 accumulators of 8-column tiles 2 kk and 2 kk + 1 (C layout: row
// g holds c0, c1, row g + 8 c2, c3, at columns 2 t, 2 t + 1) as the bf16 A
// fragment of the 16 x 16 tile kk (a0 row g, a1 row g + 8, columns 2 t and
// 2 t + 1; a2, a3 the same 8 columns on)
template <int NB>
__device__ __forceinline__ void to_a_fragments(uint32_t (&f)[NB / 16][4],
                                               const float (&x)[NB / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 16; ++kk) {
    f[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    f[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    f[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D][4]) {
#pragma unroll
  for (int n = 0; n < D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// the warp's 16 rows [row0, row0 + 16) of a (B, n, H, D) bf16 output from
// its accumulators; rows at or past n are not written
template <int D>
__device__ __forceinline__ void store_strip(bf16* out, const float (&acc)[D / 8][4], int b,
                                            int h, int H, int row0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = row0 + g + 8 * half;
    if (pos >= n) continue;
    bf16* row = out + (((long long)b * n + pos) * H + h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(row + nd * 8) =
          pack_bf16(acc[nd][2 * half], acc[nd][2 * half + 1]);
  }
}

}  // namespace mma_bf16
