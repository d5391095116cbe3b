// Flash-attention forward partials in f32 for Hopper (sm_90a), on the
// tensor cores by error-compensated 3xTF32: two kernels.  bf16 inputs take
// flash_fwd_mma.cu.
//
// Replace the TPU kernels of mpi4jax_tpu/kernels/flash_attention.py for
// f32 inputs:
// - flash_fwd_tf32_kernel replaces _kernel (the non-causal streaming
//   partials, with an optional (Tq, Tk) bool mask shared across batch and
//   heads);
// - flash_fwd_causal_tf32_kernel replaces _kernel_causal (the diagonal
//   block of a causal ring, Tq == Tk: key tiles that lie wholly after a
//   query tile's last query are never visited).
// Both compute, for every (batch, head) and query row,
//     m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) @ V,
// with s = (q . k) * scale in f32 and entries that are not valid at -inf,
// through the online-softmax merge of _merge_tile (flash_attention.py:
// 88-103).  Validity is decided on global positions (key j < Tk, the mask,
// i >= j on the causal diagonal), so a row that sees no key gives exactly
// (o, m, l) = (0, -inf, 0), never NaN.  The arithmetic follows the plain
// version (block_partials_plain in mpi4jax_tpu_torch/kernels/
// flash_attention.py): products of the f32 inputs, the scale applied to
// the f32 score, f32 accumulation; l sums the unrounded p.  expf is the
// accurate one; the library is built with FMA contraction on and without
// fast math.
//
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), read in place through
// their batch, time and head strides (the last dimension contiguous, the
// other strides multiples of 4 elements, the data 16-byte aligned:
// 16-byte cp.async); o is written (B, Tq, H, D), m and l (B, H, Tq).  Rows
// past Tq or Tk are loaded as zeros by the zero-fill form of cp.async
// (source size 0), never padded in device memory.
//
// Precision: both products (s = q k^T and o += p v) are 3xTF32 on the
// tensor cores (mma_tf32.cuh): each f32 operand is split into two TF32
// halves rounded to nearest (q and p where a warp loads its fragment, k
// and v once a tile for the whole block), and three mma.sync m16n8k8
// accumulate a_small b_big + a_big b_small + a_big b_big in f32, so each
// product keeps f32 accuracy.  The tensor cores' accumulation truncates,
// so each product sums a short run of its terms into a zeroed partial and
// adds it to its accumulator with a rounding f32 add: the score 32 columns
// of D, p v a key tile.  The bands against the plain version: m 1e-6
// (+ 1e-6 max|m|), l and o 1e-5, the causal kernel's o 1e-4.
//
// Bound on an H100: operations.  A non-causal call does two products of
// length D per score pair, 4 B H Tq Tk D f32 operations (2.749e11 at B=4,
// T=4096, H=8, D=128).  In 3xTF32 each is issued three times at the
// 494.7 TFLOP/s dense TF32 rate: 1.667 ms, against 4.10 ms on the CUDA
// cores' 67 TFLOP/s and 0.080 ms for its 269 MB of inputs and outputs;
// the causal call does T (T + 1) / 2 of the T^2 pairs.
//
// Design (on the scheme of flash_fwd_mma.cu and the helpers of
// flash_bwd_tf32.cu): a block of 8 warps owns 128 query rows, each warp
// its own 16-row strip; the grid is (Tq / 128, B H).  Q goes into shared
// memory once by cp.async; the block walks 32-key tiles of K and V through
// a two-stage cp.async double buffer, and splits each tile once, as it
// lands, into big and small TF32 tiles (split_rows), from which every warp
// reads its B fragments with no arithmetic.  A first design split every
// fragment where a warp loaded it, with 64-key tiles: each of the 8 warps
// split the same K and V elements again, and the splits, not the
// products, set its time (6.39 ms at B=4, T=4096, H=8, D=128 on an H100,
// against 1.667 ms for the products).  At D = 128 Q, the two raw stages
// and the split tiles take 198 KiB (210 KiB with the mask), one block and
// 8 warps an SM: two warps an SM sub-partition, which the f32 backward
// needed to hide its latency (64-query blocks with two warps a strip,
// each on half of every key tile, would give the same occupancy but split
// each strip's Q fragments twice a tile and merge (m, l, o) at the end).
// Per key tile each warp computes its 16 x 32 score strip S = Q K^T in f32
// registers (strip_abt, Q's fragments split as they load), scales and
// masks it, takes each row's maximum across the lane quad that holds the
// row, rescales l and the 16 x D f32 output accumulator by alpha =
// exp(m_old - m_new), and adds P V with P's C tiles taken as A fragments,
// k permuted inside each 8-wide slice (strip_pm).  So neither the scores
// nor p pass through shared memory.  Shared f32 rows are padded by 4
// elements (the bank analysis of mma_tf32.cuh).  The mask rides with the
// K/V stage: its 128 x 32 bytes for the tile are staged in shared memory
// (load_mask) and read there, never from device memory in the inner loop.
// The warps read a tile's raw K and V only to split them, before the
// tile's second barrier, but its mask after that: so the next tile's K
// and V are copied at the top of each tile, a tile ahead, and its mask
// only after the first barrier, once every warp is done with the stage it
// refills.  Two barriers a tile suffice.
// Causal blocks stop at the tile of their last query and start heaviest
// first.  Each block owns its rows: no atomics, the output is
// deterministic.  No wgmma, TMA or warp specialisation yet.

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

constexpr int NWARP = 8;
constexpr int NT = 32 * NWARP;  // 256 threads
constexpr int BQ = 16 * NWARP;  // 128: the query rows a block owns
constexpr int BK = 32;          // the key tile the block streams
constexpr int PAD = 4;          // f32 elements of padding a shared row
constexpr int MLD = BK + 16;    // row stride (bytes) of a shared mask tile

template <int D>
struct Geom {
  static constexpr int LD = D + PAD;  // row stride of every shared f32 tile
  // Q, two raw stages of K and V, and K and V split
  static constexpr size_t SMEM = sizeof(float) * (size_t)(BQ + 8 * BK) * LD;
  // and two stages of the mask tile
  static constexpr size_t SMEM_MASK = SMEM + 2 * BQ * MLD;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;  // (Tq, Tk), or null
  float* o;
  float* m;
  float* l;
  int H, Tq, Tk;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  float scale;
};

// The partials of one (batch x head, 128-query tile): walks 32-key tiles
// [0, kt_end).
template <int D, bool MASK, bool CAUSAL>
__device__ __forceinline__ void fwd_block(const Args& a, int qt) {
  constexpr int LD = Geom<D>::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;      // two raw stages
  float* Vs = Ks + 2 * BK * LD;  // two raw stages
  float* Kb = Vs + 2 * BK * LD;  // the current tile split: K's big half,
  float* Kl = Kb + BK * LD;      // K's small half,
  float* Vb = Kl + BK * LD;      // V's big half
  float* Vl = Vb + BK * LD;      // and V's small half
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vl + BK * LD);  // two stages (MASK)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * BQ, qw = q0 + 16 * warp;  // the block's and the warp's first query
  const float* qb = a.q + b * a.sqb + h * a.sqh;
  const float* kb = a.k + b * a.skb + h * a.skh;
  const float* vb = a.v + b * a.svb + h * a.svh;
  const bool by4 = MASK && mask_by4(a);

  int kt_end = (a.Tk + BK - 1) / BK;
  if (CAUSAL) {
    // the last query of this tile sees keys up to its own position
    const int q_last = min(q0 + BQ, a.Tq) - 1;
    kt_end = min(kt_end, q_last / BK + 1);
  }

  load_rows<D, BQ, LD, NT>(Qs, qb, a.sqt, q0, a.Tq);
  load_rows<D, BK, LD, NT>(Ks, kb, a.skt, 0, a.Tk);
  load_rows<D, BK, LD, NT>(Vs, vb, a.svt, 0, a.Tk);
  if (MASK) load_mask<BQ, BK, MLD, NT>(Ms, a, q0, 0, by4);
  cp_commit();

  // this thread's two rows of the warp's strip: g and g + 8
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero<D / 8>(acc);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    // the next tile's K and V into the other stage, whose raw rows every
    // warp split before the last tile's second barrier
    if (kt + 1 < kt_end) {
      const int k1 = (kt + 1) * BK;
      load_rows<D, BK, LD, NT>(Ks + (st ^ 1) * BK * LD, kb, a.skt, k1, a.Tk);
      load_rows<D, BK, LD, NT>(Vs + (st ^ 1) * BK * LD, vb, a.svt, k1, a.Tk);
      cp_commit();
      cp_wait<1>();  // all but the copy just issued: this tile and its mask
    } else {
      cp_wait<0>();
    }
    // the tile has landed for every thread, and every warp is done with
    // the last tile's split halves and mask stage
    __syncthreads();
    if (MASK && kt + 1 < kt_end) {  // only now the next tile's mask
      load_mask<BQ, BK, MLD, NT>(Ms + (st ^ 1) * BQ * MLD, a, q0, (kt + 1) * BK, by4);
      cp_commit();
    }
    split_rows<D, BK, LD, NT>(Kb, Kl, Ks + st * BK * LD);
    split_rows<D, BK, LD, NT>(Vb, Vl, Vs + st * BK * LD);
    __syncthreads();
    const uint8_t* Mw = Ms + (st * BQ + 16 * warp) * MLD;  // the warp's mask rows

    float s[BK / 8][4];
    zero<BK / 8>(s);
    strip_abt<D, BK, LD>(s, Qs + 16 * warp * LD, SplitTile{Kb, Kl}, lane);

    // scale, and -inf where a key is masked, causal-hidden or past Tk
    const int k0 = kt * BK;
    const bool guard = MASK || (k0 + BK > a.Tk) || (CAUSAL && k0 + BK - 1 > qw);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * a.scale;
        if (guard) {
          bool ok = k0 + c < a.Tk;
          if (MASK) ok = ok && Mw[(g + 8 * r) * MLD + c] != 0;
          if (CAUSAL) ok = ok && qw + g + 8 * r >= k0 + c;
          if (!ok) x = -INFINITY;
        }
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }

    // online softmax (_merge_tile): a row lives in the 4 lanes of a quad
    float alpha[2], msafe[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      msafe[r] = isinf(m_new) ? 0.f : m_new;
      alpha[r] = isinf(m_r[r]) ? 0.f : expf(m_r[r] - msafe[r]);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = isinf(s[j][e]) ? 0.f : expf(s[j][e] - msafe[r]);
        s[j][e] = p;
        rs[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_r[r] = l_r[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    strip_pm<D, BK, LD>(acc, s, SplitTile{Vb, Vl}, lane);
  }

  store_strip<D>(a.o, acc, b, h, a.H, qw, a.Tq, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qw + g + 8 * r;
      if (qpos >= a.Tq) continue;
      const long long at = (long long)bh * a.Tq + qpos;
      a.m[at] = m_r[r];
      a.l[at] = l_r[r];
    }
  }
}

template <int D, bool MASK>
__global__ void __launch_bounds__(NT) flash_fwd_tf32_kernel(Args a) {
  fwd_block<D, MASK, false>(a, blockIdx.x);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_causal_tf32_kernel(Args a) {
  // the tiles with the most keys first, so the short ones fill the tail
  fwd_block<D, false, true>(a, gridDim.x - 1 - blockIdx.x);
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, const Args& a, int B, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, B * a.H);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mode(const Args& a, int B, int causal, cudaStream_t stream) {
  if (causal) return launch(flash_fwd_causal_tf32_kernel<D>, Geom<D>::SMEM, a, B, stream);
  if (a.mask != nullptr)
    return launch(flash_fwd_tf32_kernel<D, true>, Geom<D>::SMEM_MASK, a, B, stream);
  return launch(flash_fwd_tf32_kernel<D, false>, Geom<D>::SMEM, a, B, stream);
}

int run(const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
        void* l, int B, int H, int Tq, int Tk, int D, long long sqb, long long sqt,
        long long sqh, long long skb, long long skt, long long skh, long long svb,
        long long svt, long long svh, float scale, int causal, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
               static_cast<float*>(o),       static_cast<float*>(m),
               static_cast<float*>(l),       H,   Tq,  Tk,  sqb, sqt, sqh,
               skb, skt, skh, svb, svt, svh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_mode<32>(a, B, causal, s); break;
    case 64: err = dispatch_mode<64>(a, B, causal, s); break;
    case 128: err = dispatch_mode<128>(a, B, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// The non-causal f32 partials; mask is a contiguous (Tq, Tk) uint8 array,
// or null for none.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_tf32_launch(
    const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
    void* l, int B, int H, int Tq, int Tk, int D, long long sqb, long long sqt,
    long long sqh, long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, float scale, void* stream) {
  return run(q, k, v, mask, o, m, l, B, H, Tq, Tk, D, sqb, sqt, sqh, skb, skt, skh, svb,
             svt, svh, scale, 0, stream);
}

// The causal diagonal-block f32 partials (Tq == Tk).  Returns the launch's
// cudaError_t.
extern "C" int flash_fwd_causal_tf32_launch(
    const void* q, const void* k, const void* v, void* o, void* m, void* l, int B, int H,
    int T, int D, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    float scale, void* stream) {
  return run(q, k, v, nullptr, o, m, l, B, H, T, T, D, sqb, sqt, sqh, skb, skt, skh, svb,
             svt, svh, scale, 1, stream);
}
