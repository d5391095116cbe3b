// Flash-attention backward of the block partials in bf16 for Hopper
// (sm_90a), on the tensor cores: two kernels.
//
// Replace the TPU kernels of mpi4jax_tpu/kernels/flash_attention.py for
// bf16 inputs (f32 inputs take flash_bwd.cu):
// - flash_bwd_dq_mma_kernel replaces _bwd_dq_kernel (dq, one block per
//   64-query tile, walking key tiles);
// - flash_bwd_dkv_mma_kernel replaces _bwd_dkv_kernel (dk and dv, one block
//   per 64-key tile, walking query tiles).
// What they compute is what flash_bwd.cu computes (see its note): for every
// (batch, head), query row i and key j,
//     s  = (q_i . k_j) * scale,   p = exp(s - m_safe_i) where (i, j) is
//          valid, else 0 (m_safe = 0 where m = -inf),
//     dp = g_o_i . v_j + g_l_i,   ds = p * dp * scale,
//     dq_i = sum_j ds k_j,   dk_j = sum_i ds q_i,   dv_j = sum_i p g_o_i,
// with validity decided on global positions (j < Tk, i < Tq, the mask,
// i >= j on the causal diagonal block), so a row that sees no key gets
// zero gradients, never NaN.  q and g_o (B, Tq, H, D), k and v (B, Tk, H,
// D) are read in place through their batch, time and head strides (the
// last dimension contiguous, the other strides multiples of 8 elements,
// the data 16-byte aligned: the wrapper hands over a contiguous copy of a
// tensor that is not); m and g_l are (B, H, Tq) f32, contiguous; dq, dk
// and dv are written contiguous (B, T, H, D) in bf16.
//
// Precision: the products of the bf16 inputs are exact and accumulate in
// f32 (s, dp, and the three gradient products); p and ds are rounded to
// bf16 before they enter p^T g_o, ds^T q and ds k, as in FlashAttention-2,
// where the plain version keeps them in f32.  The parity band is that of
// the bf16 gradients, 4 * 2^-8 of max|ref|.
//
// Bound on an H100: operations at the bf16 tensor-core rate.  dq does 3
// products of length D per score pair (s, dp, ds k), dk/dv 4 (s, dp,
// ds q, p g_o): 6 and 8 B H Tq Tk D operations, 0.417 and 0.556 ms at
// B=4, T=4096, H=8, D=128 on the 989 TFLOP/s dense rate, against 0.05 ms
// for the bytes; causal calls about half.
//
// Design (a first correct one on the warp-level instructions): blocks of
// 4 warps own 64 rows of their output, 16 rows a warp.  Every product is
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the operands come from
// shared memory by ldmatrix (x4: two 8-column tiles of B, or one 16 x 16
// A tile), B of the score products non-transposed from the streamed rows,
// B of the gradient products transposed (ldmatrix.trans).  The score
// strips (16 rows x the streamed tile) stay in registers: the f32
// accumulators of two neighbouring 8-column tiles are, element for
// element, the A fragment of one 16 x 16 tile, so p and ds are packed to
// bf16 A fragments in place and never pass through shared memory.
// - dq keeps its Q and g_O tiles in shared memory for the whole block and
//   streams 64-key tiles of K and V through a two-stage cp.async double
//   buffer (102 KiB at D = 128, two blocks an SM): S = Q K^T and
//   dP = g_O V^T per warp, ds in registers, dq += ds K.
// - dk/dv keeps K and V and streams 32-query tiles of Q and g_O, with that
//   tile's m and g_l, through the double buffer (68.5 KiB at D = 128):
//   S^T = K Q^T and dP^T = V g_O^T, so p^T and ds^T land in A layout with
//   key rows, m_safe and g_l indexed by the fragment's column; then
//   dv += p^T g_O and dk += ds^T Q.  32-query tiles keep the two 16 x D
//   f32 accumulators (128 registers a thread at D = 128) and the two score
//   strips (16 each) clear of spill.
// Shared rows are padded by 16 bytes, so the 8 row addresses of an
// ldmatrix phase fall in 8 distinct 4-bank groups.  Rows past Tq or Tk
// are loaded as zeros by the zero-fill form of cp.async (source size 0),
// never padded in device memory.  The split into two kernels needs no
// atomics: each block owns its output rows, and both outputs are
// deterministic.  No wgmma, TMA or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NWARP = 4;
constexpr int NT = 32 * NWARP;    // 128 threads
constexpr int BOWN = 16 * NWARP;  // 64: the rows of output a block owns
constexpr int BK_DQ = 64;         // the key tile the dq kernel streams
constexpr int BQ_DKV = 32;        // the query tile the dk/dv kernel streams
constexpr int PAD = 8;            // bf16 elements of padding a shared row

template <int D>
struct Geom {
  static constexpr int LD = D + PAD;  // row stride of every shared tile
  // dq: Q and g_O, two stages of K and V
  static constexpr size_t SMEM_DQ = sizeof(bf16) * (size_t)(2 * BOWN + 4 * BK_DQ) * LD;
  // dk/dv: K and V, two stages of Q and g_O, two stages of m and g_l
  static constexpr size_t SMEM_DKV =
      sizeof(bf16) * (size_t)(2 * BOWN + 4 * BQ_DKV) * LD + sizeof(float) * 4 * BQ_DKV;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* go;
  const uint8_t* mask;  // (Tq, Tk), or null
  const float* m;
  const float* gl;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, Tq, Tk;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh;
  float scale;
};

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
// dst (row stride D + PAD) by 16-byte cp.async; rows at or past n land as
// zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long st,
                                          int row0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * Geom<D>::LD + c, ok ? base + (long long)(row0 + r) * st + c : base,
               ok);
  }
}

// acc[j] (8-column tile j) += A (16 rows at a) . B (NB rows at b)^T over D:
// a score strip of the warp, row r of A against row 8 j + c of B
template <int D, int NB>
__device__ __forceinline__ void strip_abt(float (&acc)[NB / 8][4], const bf16* a,
                                          const bf16* b, int lane) {
  constexpr int LD = Geom<D>::LD;
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
template <int D, int NB>
__device__ __forceinline__ void strip_pm(float (&acc)[D / 8][4], const uint32_t (&pf)[NB / 16][4],
                                         const bf16* m, int lane) {
  constexpr int LD = Geom<D>::LD;
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

// dq of one (batch x head, 64-query tile): walks 64-key tiles [0, kt_end).
template <int D, bool MASK, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dq_mma_kernel(Args a) {
  using G = Geom<D>;
  constexpr int LD = G::LD, BK = BK_DQ;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Gs = Qs + BOWN * LD;
  bf16* Ks = Gs + BOWN * LD;   // two stages
  bf16* Vs = Ks + 2 * BK * LD;  // two stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // causal: the tiles with the most keys first, so the short ones fill the tail
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BOWN, qw = q0 + 16 * warp;  // the block's and the warp's first query
  const bf16* qb = a.q + b * a.sqb + h * a.sqh;
  const bf16* gb = a.go + b * a.sgb + h * a.sgh;
  const bf16* kb = a.k + b * a.skb + h * a.skh;
  const bf16* vb = a.v + b * a.svb + h * a.svh;

  int kt_end = (a.Tk + BK - 1) / BK;
  if (CAUSAL) {
    // the last query of this tile sees keys up to its own position
    const int q_last = min(q0 + BOWN, a.Tq) - 1;
    kt_end = min(kt_end, q_last / BK + 1);
  }

  load_rows<D, BOWN>(Qs, qb, a.sqt, q0, a.Tq);
  load_rows<D, BOWN>(Gs, gb, a.sgt, q0, a.Tq);
  load_rows<D, BK>(Ks, kb, a.skt, 0, a.Tk);
  load_rows<D, BK>(Vs, vb, a.svt, 0, a.Tk);
  cp_commit();

  // this thread's two rows of the warp's strip: g and g + 8
  float msafe[2], gl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    float mv = 0.f, gv = 0.f;
    if (qpos < a.Tq) {
      mv = a.m[(long long)bh * a.Tq + qpos];
      gv = a.gl[(long long)bh * a.Tq + qpos];
    }
    msafe[r] = isinf(mv) ? 0.f : mv;
    gl[r] = gv;
  }
  float acc[D / 8][4];
  zero<D / 8>(acc);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_end) {  // the next tile into the other stage
      load_rows<D, BK>(Ks + (st ^ 1) * BK * LD, kb, a.skt, (kt + 1) * BK, a.Tk);
      load_rows<D, BK>(Vs + (st ^ 1) * BK * LD, vb, a.svt, (kt + 1) * BK, a.Tk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;

    float s[BK / 8][4], dp[BK / 8][4];
    zero<BK / 8>(s);
    zero<BK / 8>(dp);
    strip_abt<D, BK>(s, Qs + 16 * warp * LD, Kt, lane);
    strip_abt<D, BK>(dp, Gs + 16 * warp * LD, Vt, lane);

    const int k0 = kt * BK;
    const bool guard = MASK || (k0 + BK > a.Tk) || (CAUSAL && k0 + BK - 1 > qw);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qpos = qw + g + 8 * r;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        bool ok = true;
        if (guard) {
          ok = kpos < a.Tk;
          if (MASK) ok = ok && qpos < a.Tq && a.mask[(long long)qpos * a.Tk + kpos] != 0;
          if (CAUSAL) ok = ok && qpos >= kpos;
        }
        const float p = ok ? expf(s[j][e] * a.scale - msafe[r]) : 0.f;
        s[j][e] = p * (dp[j][e] + gl[r]) * a.scale;  // ds from here on
      }
    uint32_t df[BK / 16][4];
    to_a_fragments<BK>(df, s);
    strip_pm<D, BK>(acc, df, Kt, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_strip<D>(a.dq, acc, b, h, a.H, qw, a.Tq, lane);
}

// m_safe and g_l of query rows [q0, q0 + BQ) into Ms, Ls by 4-byte
// cp.async; rows at or past Tq land as zeros
__device__ __forceinline__ void load_row_stats(float* Ms, float* Ls, const Args& a, int bh,
                                               int q0) {
  for (int r = threadIdx.x; r < BQ_DKV; r += NT) {
    const bool ok = q0 + r < a.Tq;
    const long long at = (long long)bh * a.Tq + (ok ? q0 + r : 0);
    cp_async4(Ms + r, a.m + at, ok);
    cp_async4(Ls + r, a.gl + at, ok);
  }
}

// dk and dv of one (batch x head, 64-key tile): walks 32-query tiles
// [qt_begin, n_qt).
template <int D, bool MASK, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_mma_kernel(Args a) {
  using G = Geom<D>;
  constexpr int LD = G::LD, BQ = BQ_DKV;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + BOWN * LD;
  bf16* Qs = Vs + BOWN * LD;    // two stages
  bf16* Gs = Qs + 2 * BQ * LD;  // two stages
  float* Ms = reinterpret_cast<float*>(Gs + 2 * BQ * LD);  // two stages of m
  float* Ls = Ms + 2 * BQ;                                  // two stages of g_l

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // causal: the first tiles see the most queries and start first
  const int k0 = blockIdx.x * BOWN, kw = k0 + 16 * warp;  // the block's and the warp's first key
  const bf16* qb = a.q + b * a.sqb + h * a.sqh;
  const bf16* gb = a.go + b * a.sgb + h * a.sgh;
  const bf16* kb = a.k + b * a.skb + h * a.skh;
  const bf16* vb = a.v + b * a.svb + h * a.svh;

  // causal: the queries before this tile's first key see none of its keys
  const int qt_begin = CAUSAL ? k0 / BQ : 0;
  const int n_qt = (a.Tq + BQ - 1) / BQ;

  load_rows<D, BOWN>(Ks, kb, a.skt, k0, a.Tk);
  load_rows<D, BOWN>(Vs, vb, a.svt, k0, a.Tk);
  load_rows<D, BQ>(Qs, qb, a.sqt, qt_begin * BQ, a.Tq);
  load_rows<D, BQ>(Gs, gb, a.sgt, qt_begin * BQ, a.Tq);
  load_row_stats(Ms, Ls, a, bh, qt_begin * BQ);
  cp_commit();

  float dk[D / 8][4], dv[D / 8][4];
  zero<D / 8>(dk);
  zero<D / 8>(dv);

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int st = (qt - qt_begin) & 1;
    if (qt + 1 < n_qt) {  // the next tile into the other stage
      const int nst = st ^ 1, q1 = (qt + 1) * BQ;
      load_rows<D, BQ>(Qs + nst * BQ * LD, qb, a.sqt, q1, a.Tq);
      load_rows<D, BQ>(Gs + nst * BQ * LD, gb, a.sgt, q1, a.Tq);
      load_row_stats(Ms + nst * BQ, Ls + nst * BQ, a, bh, q1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* Gt = Gs + st * BQ * LD;
    const float* Mt = Ms + st * BQ;
    const float* Lt = Ls + st * BQ;

    // the transposed strips: rows are this warp's keys, columns queries
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero<BQ / 8>(s);
    zero<BQ / 8>(dp);
    strip_abt<D, BQ>(s, Ks + 16 * warp * LD, Qt, lane);
    strip_abt<D, BQ>(dp, Vs + 16 * warp * LD, Gt, lane);

    const int q0 = qt * BQ;
    const bool guard = MASK || (q0 + BQ > a.Tq) || (kw + 16 > a.Tk) ||
                       (CAUSAL && q0 < kw + 15);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kw + g + 8 * (e >> 1);
        const int c = 8 * j + 2 * t + (e & 1), qpos = q0 + c;
        bool ok = true;
        if (guard) {
          ok = kpos < a.Tk && qpos < a.Tq;
          if (MASK) ok = ok && a.mask[(long long)qpos * a.Tk + kpos] != 0;
          if (CAUSAL) ok = ok && qpos >= kpos;
        }
        const float mv = Mt[c];
        const float p = ok ? expf(s[j][e] * a.scale - (isinf(mv) ? 0.f : mv)) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] + Lt[c]) * a.scale;  // ds from here on
      }
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];
    to_a_fragments<BQ>(pf, s);
    to_a_fragments<BQ>(df, dp);
    strip_pm<D, BQ>(dv, pf, Gt, lane);
    strip_pm<D, BQ>(dk, df, Qt, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_strip<D>(a.dk, dk, b, h, a.H, kw, a.Tk, lane);
  store_strip<D>(a.dv, dv, b, h, a.H, kw, a.Tk, lane);
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool MASK, bool CAUSAL>
cudaError_t launch_kind(const Args& a, int B, bool dkv, cudaStream_t stream) {
  if (dkv)
    return launch(flash_bwd_dkv_mma_kernel<D, MASK, CAUSAL>, Geom<D>::SMEM_DKV,
                  dim3((a.Tk + BOWN - 1) / BOWN, B * a.H), a, stream);
  return launch(flash_bwd_dq_mma_kernel<D, MASK, CAUSAL>, Geom<D>::SMEM_DQ,
                dim3((a.Tq + BOWN - 1) / BOWN, B * a.H), a, stream);
}

template <int D>
cudaError_t dispatch_mode(const Args& a, int B, int causal, bool dkv, cudaStream_t stream) {
  if (causal) return launch_kind<D, false, true>(a, B, dkv, stream);
  if (a.mask != nullptr) return launch_kind<D, true, false>(a, B, dkv, stream);
  return launch_kind<D, false, false>(a, B, dkv, stream);
}

int run(const Args& a, int B, int D, int causal, bool dkv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_mode<32>(a, B, causal, dkv, s); break;
    case 64: err = dispatch_mode<64>(a, B, causal, dkv, s); break;
    case 128: err = dispatch_mode<128>(a, B, causal, dkv, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Args make_args(const void* q, const void* k, const void* v, const void* go,
               const void* mask, const void* m, const void* gl, void* dq, void* dk,
               void* dv, int H, int Tq, int Tk, long long sqb, long long sqt,
               long long sqh, long long skb, long long skt, long long skh,
               long long svb, long long svt, long long svh, long long sgb,
               long long sgt, long long sgh, float scale) {
  return Args{static_cast<const bf16*>(q),   static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),   static_cast<const bf16*>(go),
              static_cast<const uint8_t*>(mask), static_cast<const float*>(m),
              static_cast<const float*>(gl), static_cast<bf16*>(dq),
              static_cast<bf16*>(dk),        static_cast<bf16*>(dv),
              H, Tq, Tk, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh,
              scale};
}

}  // namespace

// dq (B, Tq, H, D) bf16 of the partials; mask is a contiguous (Tq, Tk)
// uint8 array, or null; causal needs Tq == Tk and no mask.  Returns the
// launch's cudaError_t.
extern "C" int flash_bwd_dq_mma_launch(
    const void* q, const void* k, const void* v, const void* go, const void* mask,
    const void* m, const void* gl, void* dq, int B, int H, int Tq, int Tk, int D,
    int causal, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    long long sgb, long long sgt, long long sgh, float scale, void* stream) {
  const Args a = make_args(q, k, v, go, mask, m, gl, dq, nullptr, nullptr, H, Tq, Tk,
                           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh,
                           scale);
  return run(a, B, D, causal, false, stream);
}

// dk and dv (B, Tk, H, D) bf16 of the partials; arguments as for dq.
// Returns the launch's cudaError_t.
extern "C" int flash_bwd_dkv_mma_launch(
    const void* q, const void* k, const void* v, const void* go, const void* mask,
    const void* m, const void* gl, void* dk, void* dv, int B, int H, int Tq, int Tk,
    int D, int causal, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    long long sgb, long long sgt, long long sgh, float scale, void* stream) {
  const Args a = make_args(q, k, v, go, mask, m, gl, nullptr, dk, dv, H, Tq, Tk, sqb,
                           sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh, scale);
  return run(a, B, D, causal, true, stream);
}
