// Flash-attention backward of the block partials in f32 for Hopper
// (sm_90a), on the tensor cores by error-compensated 3xTF32: two kernels.
// bf16 inputs take flash_bwd_mma.cu.
//
// Replace the TPU kernels of mpi4jax_tpu/kernels/flash_attention.py for
// f32 inputs:
// - flash_bwd_dq_tf32_kernel replaces _bwd_dq_kernel (dq, one block per
//   64-query tile, walking key tiles);
// - flash_bwd_dkv_tf32_kernel replaces _bwd_dkv_kernel (dk and dv, one
//   block per 64-key tile, walking query tiles).
// The partials map (q, k, v) -> (o, m, l) of flash_fwd_tf32.cu gets this
// backward with the stabilizer m held constant (its cotangent is dropped,
// exact for every consumer that merges and normalises the partials; see
// _partials_bwd in the JAX package).  From the saved (q, k, v, m) and the
// cotangents (g_o, g_l), for every (batch, head), query row i and key j:
//     s  = (q_i . k_j) * scale,   p = exp(s - m_safe_i) where (i, j) is
//          valid, else 0 (m_safe = 0 where m = -inf),
//     dp = g_o_i . v_j + g_l_i,   ds = p * dp * scale,
//     dq_i = sum_j ds k_j,   dk_j = sum_i ds q_i,   dv_j = sum_i p g_o_i.
// (i, j) is valid when j < Tk, i < Tq, the mask (if any) is set at (i, j)
// and, for the causal diagonal block, i >= j: decided on global positions,
// so the loop bounds below hold for any tile size.  A row that sees no key
// has p = 0 everywhere and gets zero gradients, never NaN.
//
// Layout: q and g_o (B, Tq, H, D), k and v (B, Tk, H, D), read in place
// through their batch, time and head strides (the last dimension
// contiguous, the other strides multiples of 4 elements, the data 16-byte
// aligned: 16-byte cp.async); m and g_l (B, H, Tq) f32, contiguous; dq is
// written (B, Tq, H, D), dk and dv (B, Tk, H, D).  Rows past Tq or Tk are
// loaded as zeros by the zero-fill form of cp.async (source size 0), never
// padded in device memory.
//
// Precision: every product (s, dp, ds k, ds q, p g_o) is 3xTF32 on the
// tensor cores (mma_tf32.cuh): each f32 operand is split at its fragment
// load into two TF32 halves rounded to nearest, three mma.sync m16n8k8
// accumulate a_small b_big + a_big b_small + a_big b_big in f32, so each
// product keeps f32 accuracy.  Each product sums short runs of its terms
// (the score products 32 columns of D, the gradient products a streamed
// tile) into a zeroed partial and adds it to its accumulator with a
// rounding f32 add, since the tensor cores' accumulation truncates.  p, dp
// and ds are f32, exp is the accurate expf, and the library is built with
// FMA contraction on and without fast math.  The band against the plain
// version (block_partials_bwd_plain, full f32 products) is 1e-3 max|ref| +
// 1e-4 per gradient.
//
// Bound on an H100: operations.  dq does 3 products of length D per score
// pair (s, dp, ds k), dk/dv 4 (s, dp, ds q, p g_o): 6 and 8 B H Tq Tk D
// f32 operations, 412.3 and 549.8 GFLOP at B=4, T=4096, H=8, D=128.  In
// 3xTF32 each is issued three times at the 494.7 TFLOP/s dense TF32 rate,
// 2.500 and 3.334 ms, against 6.154 and 8.205 ms on the CUDA cores' 67
// TFLOP/s and 0.2 ms for the bytes; causal calls about half.
//
// Design (a first correct one, on the bf16 scheme of flash_bwd_mma.cu):
// a block owns 64 rows of its output (queries for dq, keys for dk/dv) in
// four 16-row strips and walks 64-row tiles of the other side through a
// two-stage cp.async double buffer.  Each strip has two warps, one for
// each 32-row half of the streamed tile, so a block is 8 warps; their two
// partial sums meet in shared memory at the end (add_halves).  The f32
// tiles are twice bf16's bytes: at D = 128 a block takes 208 (dq) and 209
// (dk/dv) KiB with the mask, one block an SM, and with 4 warps a block
// (flash_bwd_mma.cu's shape) each SM sub-partition had one warp to issue
// from, which left the kernels latency-bound.  The operands of the score products come
// from shared memory by ldmatrix; the score strips (16 rows x 32) stay in
// f32 registers, and their C tiles feed the gradient products as A
// fragments with k permuted inside each 8-wide slice (c_to_a, strip_pm), so
// p and ds never pass through shared memory.  Shared f32 rows are padded
// by 4 elements (16 bytes): LD = 4 (mod 32) words keeps ldmatrix's row
// phases in distinct 16-byte bank groups and the permuted B reads (word
// 8 t + g) in 32 distinct banks.
// - dq keeps its Q and g_O tiles in shared memory for the whole block and
//   streams 64-key tiles of K and V (and the mask's 64 x 64 bytes):
//   S = Q K^T and dP = g_O V^T per warp, ds in registers, dq += ds K.
// - dk/dv keeps K and V and streams 64-query tiles of Q and g_O, with that
//   tile's m, g_l and mask bytes: S^T = K Q^T and dP^T = V g_O^T, so p^T
//   and ds^T land in C layout with key rows; then dv += p^T g_O and
//   dk += ds^T Q.  The two 16 x D f32 accumulators take 128 registers a
//   thread at D = 128.
// The mask rides with the streamed stage, as in flash_fwd_mma.cu: its
// bytes for the tile are staged in shared memory (4-byte cp.async where Tk
// and the pointer allow, byte copies otherwise) and read there, never from
// device memory in the inner loop.  Causal blocks stop at (dq) or start
// from (dk/dv) the tile of their diagonal, heaviest first.  Each block owns
// its output rows: no atomics, both outputs deterministic.  No wgmma, TMA
// or warp specialisation yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;
using mma_bf16::cp_commit;
using mma_bf16::cp_wait;
using mma_bf16::zero;

constexpr int NSTRIP = 4;          // 16-row strips of output a block owns
constexpr int NWARP = 2 * NSTRIP;  // two warps a strip, one a half of each streamed tile
constexpr int NT = 32 * NWARP;     // 256 threads
constexpr int BOWN = 16 * NSTRIP;  // 64: the rows of output a block owns
constexpr int BK_DQ = 64;          // the key tile the dq kernel streams
constexpr int BQ_DKV = 64;         // the query tile the dk/dv kernel streams
constexpr int PAD = 4;            // f32 elements of padding a shared row
constexpr int MLD_DQ = BK_DQ + 16;  // row stride (bytes) of dq's mask tile
constexpr int MLD_DKV = BOWN + 16;  // row stride (bytes) of dk/dv's mask tile

template <int D>
struct Geom {
  static constexpr int LD = D + PAD;  // row stride of every shared f32 tile
  // dq: Q and g_O, two stages of K and V; and two stages of the mask tile
  static constexpr size_t SMEM_DQ = sizeof(float) * (size_t)(2 * BOWN + 4 * BK_DQ) * LD;
  static constexpr size_t SMEM_DQ_MASK = SMEM_DQ + 2 * BOWN * MLD_DQ;
  // dk/dv: K and V, two stages of Q and g_O, two stages of m and g_l; and
  // two stages of the mask tile
  static constexpr size_t SMEM_DKV =
      sizeof(float) * ((size_t)(2 * BOWN + 4 * BQ_DKV) * LD + 4 * BQ_DKV);
  static constexpr size_t SMEM_DKV_MASK = SMEM_DKV + 2 * BQ_DKV * MLD_DKV;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* go;
  const uint8_t* mask;  // (Tq, Tk), or null
  const float* m;
  const float* gl;
  float* dq;
  float* dk;
  float* dv;
  int H, Tq, Tk;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh;
  float scale;
};

// the accumulators of the second half's warps (half = 1) added into those
// of the first half's warps on the same strip, through red (16 x D floats a
// strip, lane-interleaved so that a warp's stores and loads hit 32 banks);
// every thread of the block calls it, after the main loop's last barrier
template <int D>
__device__ __forceinline__ void add_halves(float (&acc)[D / 8][4], float* red, int strip,
                                           int half, int lane) {
  float* r = red + strip * 16 * D + lane;
  if (half)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[(4 * n + e) * 32] = acc[n][e];
  __syncthreads();
  if (!half)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += r[(4 * n + e) * 32];
}

// dq of one (batch x head, 64-query tile): walks 64-key tiles [0, kt_end).
// Warp w takes query strip w % 4 against key half w / 4 of each tile.
template <int D, bool MASK, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dq_tf32_kernel(Args a) {
  using G = Geom<D>;
  constexpr int LD = G::LD, BK = BK_DQ, HK = BK / 2;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + BOWN * LD;
  float* Ks = Gs + BOWN * LD;   // two stages
  float* Vs = Ks + 2 * BK * LD;  // two stages
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + 2 * BK * LD);  // two stages (MASK)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp % NSTRIP, half = warp / NSTRIP;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // causal: the tiles with the most keys first, so the short ones fill the tail
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BOWN, qw = q0 + 16 * strip;  // the block's and the warp's first query
  const float* qb = a.q + b * a.sqb + h * a.sqh;
  const float* gb = a.go + b * a.sgb + h * a.sgh;
  const float* kb = a.k + b * a.skb + h * a.skh;
  const float* vb = a.v + b * a.svb + h * a.svh;
  const bool by4 = MASK && mask_by4(a);

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
  if (MASK) load_mask<BOWN, BK, MLD_DQ, NT>(Ms, a, q0, 0, by4);
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
      const int k1 = (kt + 1) * BK;
      load_rows<D, BK, LD, NT>(Ks + (st ^ 1) * BK * LD, kb, a.skt, k1, a.Tk);
      load_rows<D, BK, LD, NT>(Vs + (st ^ 1) * BK * LD, vb, a.svt, k1, a.Tk);
      if (MASK) load_mask<BOWN, BK, MLD_DQ, NT>(Ms + (st ^ 1) * BOWN * MLD_DQ, a, q0, k1, by4);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // this warp's key half of the stage, and its rows and columns of the mask
    const float* Kt = Ks + (st * BK + half * HK) * LD;
    const float* Vt = Vs + (st * BK + half * HK) * LD;
    const uint8_t* Mw = Ms + (st * BOWN + 16 * strip) * MLD_DQ + half * HK;

    float s[HK / 8][4], dp[HK / 8][4];
    zero<HK / 8>(s);
    zero<HK / 8>(dp);
    strip_abt<D, HK, LD>(s, Qs + 16 * strip * LD, Kt, lane);
    strip_abt<D, HK, LD>(dp, Gs + 16 * strip * LD, Vt, lane);

    const int kw = kt * BK + half * HK;  // the warp's first key
    const bool guard = MASK || (kw + HK > a.Tk) || (CAUSAL && kw + HK - 1 > qw);
#pragma unroll
    for (int j = 0; j < HK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * j + 2 * t + (e & 1);
        bool ok = true;
        if (guard) {
          ok = kw + c < a.Tk;
          if (MASK) ok = ok && Mw[(g + 8 * r) * MLD_DQ + c] != 0;
          if (CAUSAL) ok = ok && qw + g + 8 * r >= kw + c;
        }
        const float p = ok ? expf(s[j][e] * a.scale - msafe[r]) : 0.f;
        s[j][e] = p * (dp[j][e] + gl[r]) * a.scale;  // ds from here on
      }
    strip_pm<D, HK, LD>(acc, s, Kt, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  add_halves<D>(acc, Ks, strip, half, lane);  // the stages are free now
  if (!half) store_strip<D>(a.dq, acc, b, h, a.H, qw, a.Tq, lane);
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

// dk and dv of one (batch x head, 64-key tile): walks 64-query tiles
// [qt_begin, n_qt).  Warp w takes key strip w % 4 against query half w / 4
// of each tile.
template <int D, bool MASK, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_tf32_kernel(Args a) {
  using G = Geom<D>;
  constexpr int LD = G::LD, BQ = BQ_DKV, HQ = BQ / 2;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BOWN * LD;
  float* Qs = Vs + BOWN * LD;    // two stages
  float* Gs = Qs + 2 * BQ * LD;  // two stages
  float* Ms = Gs + 2 * BQ * LD;  // two stages of m
  float* Ls = Ms + 2 * BQ;       // two stages of g_l
  uint8_t* Xs = reinterpret_cast<uint8_t*>(Ls + 2 * BQ);  // two stages of the mask (MASK)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp % NSTRIP, half = warp / NSTRIP;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // causal: the first tiles see the most queries and start first
  const int k0 = blockIdx.x * BOWN, kw = k0 + 16 * strip;  // the block's and the warp's first key
  const float* qb = a.q + b * a.sqb + h * a.sqh;
  const float* gb = a.go + b * a.sgb + h * a.sgh;
  const float* kb = a.k + b * a.skb + h * a.skh;
  const float* vb = a.v + b * a.svb + h * a.svh;
  const bool by4 = MASK && mask_by4(a);

  // causal: the queries before this tile's first key see none of its keys
  const int qt_begin = CAUSAL ? k0 / BQ : 0;
  const int n_qt = (a.Tq + BQ - 1) / BQ;

  load_rows<D, BOWN, LD, NT>(Ks, kb, a.skt, k0, a.Tk);
  load_rows<D, BOWN, LD, NT>(Vs, vb, a.svt, k0, a.Tk);
  load_rows<D, BQ, LD, NT>(Qs, qb, a.sqt, qt_begin * BQ, a.Tq);
  load_rows<D, BQ, LD, NT>(Gs, gb, a.sgt, qt_begin * BQ, a.Tq);
  load_row_stats(Ms, Ls, a, bh, qt_begin * BQ);
  if (MASK) load_mask<BQ, BOWN, MLD_DKV, NT>(Xs, a, qt_begin * BQ, k0, by4);
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
      if (MASK) load_mask<BQ, BOWN, MLD_DKV, NT>(Xs + nst * BQ * MLD_DKV, a, q1, k0, by4);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // this warp's query half of the stage, its m, g_l and mask rows
    const int hq = st * BQ + half * HQ;
    const float* Qt = Qs + hq * LD;
    const float* Gt = Gs + hq * LD;
    const float* Mt = Ms + hq;
    const float* Lt = Ls + hq;
    const uint8_t* Xw = Xs + hq * MLD_DKV + 16 * strip;

    // the transposed strips: rows are this warp's keys, columns queries
    float s[HQ / 8][4], dp[HQ / 8][4];
    zero<HQ / 8>(s);
    zero<HQ / 8>(dp);
    strip_abt<D, HQ, LD>(s, Ks + 16 * strip * LD, Qt, lane);
    strip_abt<D, HQ, LD>(dp, Vs + 16 * strip * LD, Gt, lane);

    const int qw = qt * BQ + half * HQ;  // the warp's first query
    const bool guard = MASK || (qw + HQ > a.Tq) || (kw + 16 > a.Tk) ||
                       (CAUSAL && qw < kw + 15);
#pragma unroll
    for (int j = 0; j < HQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), kpos = kw + r;
        const int c = 8 * j + 2 * t + (e & 1), qpos = qw + c;
        bool ok = true;
        if (guard) {
          ok = kpos < a.Tk && qpos < a.Tq;
          if (MASK) ok = ok && Xw[c * MLD_DKV + r] != 0;
          if (CAUSAL) ok = ok && qpos >= kpos;
        }
        const float mv = Mt[c];
        const float p = ok ? expf(s[j][e] * a.scale - (isinf(mv) ? 0.f : mv)) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] + Lt[c]) * a.scale;  // ds from here on
      }
    strip_pm<D, HQ, LD>(dv, s, Gt, lane);
    strip_pm<D, HQ, LD>(dk, dp, Qt, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  // the stages are free now: dk's halves through the first, dv's the second
  add_halves<D>(dk, Qs, strip, half, lane);
  add_halves<D>(dv, Qs + BQ * LD, strip, half, lane);
  if (!half) {
    store_strip<D>(a.dk, dk, b, h, a.H, kw, a.Tk, lane);
    store_strip<D>(a.dv, dv, b, h, a.H, kw, a.Tk, lane);
  }
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
  using G = Geom<D>;
  if (dkv)
    return launch(flash_bwd_dkv_tf32_kernel<D, MASK, CAUSAL>,
                  MASK ? G::SMEM_DKV_MASK : G::SMEM_DKV,
                  dim3((a.Tk + BOWN - 1) / BOWN, B * a.H), a, stream);
  return launch(flash_bwd_dq_tf32_kernel<D, MASK, CAUSAL>, MASK ? G::SMEM_DQ_MASK : G::SMEM_DQ,
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
  return Args{static_cast<const float*>(q),  static_cast<const float*>(k),
              static_cast<const float*>(v),  static_cast<const float*>(go),
              static_cast<const uint8_t*>(mask), static_cast<const float*>(m),
              static_cast<const float*>(gl), static_cast<float*>(dq),
              static_cast<float*>(dk),       static_cast<float*>(dv),
              H, Tq, Tk, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh,
              scale};
}

}  // namespace

// dq (B, Tq, H, D) f32 of the partials; mask is a contiguous (Tq, Tk)
// uint8 array, or null; causal needs Tq == Tk and no mask.  Returns the
// launch's cudaError_t.
extern "C" int flash_bwd_dq_tf32_launch(
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

// dk and dv (B, Tk, H, D) f32 of the partials; arguments as for dq.
// Returns the launch's cudaError_t.
extern "C" int flash_bwd_dkv_tf32_launch(
    const void* q, const void* k, const void* v, const void* go, const void* mask,
    const void* m, const void* gl, void* dk, void* dv, int B, int H, int Tq, int Tk,
    int D, int causal, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    long long sgb, long long sgt, long long sgh, float scale, void* stream) {
  const Args a = make_args(q, k, v, go, mask, m, gl, nullptr, dk, dv, H, Tq, Tk, sqb,
                           sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh, scale);
  return run(a, B, D, causal, true, stream);
}
