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
// deterministic.  No wgmma, TMA or warp specialisation yet.  The
// warp-level helpers (cp.async, ldmatrix, mma.sync and the fragment
// layouts) live in mma_bf16.cuh, shared with the forward kernels of
// flash_fwd_mma.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

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

  load_rows<D, BOWN, LD, NT>(Qs, qb, a.sqt, q0, a.Tq);
  load_rows<D, BOWN, LD, NT>(Gs, gb, a.sgt, q0, a.Tq);
  load_rows<D, BK, LD, NT>(Ks, kb, a.skt, 0, a.Tk);
  load_rows<D, BK, LD, NT>(Vs, vb, a.svt, 0, a.Tk);
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
      load_rows<D, BK, LD, NT>(Ks + (st ^ 1) * BK * LD, kb, a.skt, (kt + 1) * BK, a.Tk);
      load_rows<D, BK, LD, NT>(Vs + (st ^ 1) * BK * LD, vb, a.svt, (kt + 1) * BK, a.Tk);
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
    strip_abt<D, BK, LD>(s, Qs + 16 * warp * LD, Kt, lane);
    strip_abt<D, BK, LD>(dp, Gs + 16 * warp * LD, Vt, lane);

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
    strip_pm<D, BK, LD>(acc, df, Kt, lane);
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

  load_rows<D, BOWN, LD, NT>(Ks, kb, a.skt, k0, a.Tk);
  load_rows<D, BOWN, LD, NT>(Vs, vb, a.svt, k0, a.Tk);
  load_rows<D, BQ, LD, NT>(Qs, qb, a.sqt, qt_begin * BQ, a.Tq);
  load_rows<D, BQ, LD, NT>(Gs, gb, a.sgt, qt_begin * BQ, a.Tq);
  load_row_stats(Ms, Ls, a, bh, qt_begin * BQ);
  cp_commit();

  float dk[D / 8][4], dv[D / 8][4];
  zero<D / 8>(dk);
  zero<D / 8>(dv);

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int st = (qt - qt_begin) & 1;
    if (qt + 1 < n_qt) {  // the next tile into the other stage
      const int nst = st ^ 1, q1 = (qt + 1) * BQ;
      load_rows<D, BQ, LD, NT>(Qs + nst * BQ * LD, qb, a.sqt, q1, a.Tq);
      load_rows<D, BQ, LD, NT>(Gs + nst * BQ * LD, gb, a.sgt, q1, a.Tq);
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
    strip_abt<D, BQ, LD>(s, Ks + 16 * warp * LD, Qt, lane);
    strip_abt<D, BQ, LD>(dp, Vs + 16 * warp * LD, Gt, lane);

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
    strip_pm<D, BQ, LD>(dv, pf, Gt, lane);
    strip_pm<D, BQ, LD>(dk, df, Qt, lane);
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
