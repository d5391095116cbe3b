// Flash-attention forward partials in bf16 for Hopper (sm_90a), on the
// tensor cores: two kernels.
//
// Replace the TPU kernels of mpi4jax_tpu/kernels/flash_attention.py for
// bf16 inputs (f32 inputs take flash_fwd_tf32.cu):
// - flash_fwd_mma_kernel replaces _kernel (the non-causal streaming
//   partials, with an optional (Tq, Tk) bool mask shared across batch and
//   heads);
// - flash_fwd_causal_mma_kernel replaces _kernel_causal (the diagonal
//   block of a causal ring, Tq == Tk: key tiles that lie wholly after a
//   query tile's last query are never visited).
// What they compute is what flash_fwd_tf32.cu computes (see its note): for
// every (batch, head) and query row,
//     m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) @ V,
// with s = (q . k) * scale in f32 and entries that are not valid at -inf;
// validity is decided on global positions (j < Tk, the mask, i >= j on
// the causal diagonal), so a row that sees no key gives exactly
// (o, m, l) = (0, -inf, 0), never NaN.  q (B, Tq, H, D), k and v (B, Tk,
// H, D) are read in place through their batch, time and head strides (the
// last dimension contiguous, the other strides multiples of 8 elements,
// the data 16-byte aligned: the wrapper hands over a contiguous copy of a
// tensor that is not); o is written contiguous (B, Tq, H, D) in bf16, m
// and l (B, H, Tq) in f32.
//
// Precision: the products of the bf16 inputs are exact and accumulate in
// f32; p is rounded to bf16 before the PV product and l sums the
// unrounded p, as the plain version does; o is rounded once at the end.
// The one difference from the plain version, shared with flash_fwd_tf32.cu:
// p is taken against the running maximum and the f32 accumulator is
// rescaled as the maximum grows (the online softmax of _merge_tile,
// flash_attention.py:88-103).  expf is the accurate one.
//
// Bound on an H100: operations at the bf16 tensor-core rate.  A
// non-causal call does two products of length D per score pair, 4 B H Tq
// Tk D operations: 2.749e11 at B=4, T=4096, H=8, D=128, 0.278 ms at the
// 989 TFLOP/s dense rate, against 0.040 ms for its 135 MB of inputs and
// outputs; the causal call does T (T + 1) / 2 of the T^2 pairs.
//
// Design (a first correct one on the warp-level instructions of
// mma_bf16.cuh, the scheme of flash_bwd_mma.cu's dq kernel): a block of 4
// warps owns 64 query rows, 16 a warp; the grid is (Tq / 64, B H).  Q
// goes into shared memory once by cp.async; the block walks 64-key tiles
// of K and V through a two-stage cp.async double buffer (85 KiB at D =
// 128 with 16-byte row padding, two blocks an SM).  Per key tile each warp
// computes its 16 x 64 score strip S = Q K^T in f32 registers by mma.sync
// m16n8k16, masks and scales it, takes each row's maximum across the lane
// quad that holds the row, rescales l and the 16 x D f32 output
// accumulator by alpha = exp(m_old - m_new), packs p to bf16 A fragments
// in registers and adds P V (V's B fragments by ldmatrix.trans).  So
// neither the scores nor p ever pass through shared memory, and the two
// products run on the tensor cores.  The mask rides with the K/V stage:
// its 64 x 64 bytes for the tile are staged in shared memory (4-byte
// cp.async where Tk and the pointer allow, byte copies otherwise), and
// each fragment element reads its byte there, not from device memory.
// Causal blocks stop at the tile of their last query and start heaviest
// first.  Rows past Tq or Tk load as zeros (the zero-fill form of
// cp.async), never padded in device memory.  Each block owns its rows: no
// atomics, the output is deterministic.  No wgmma, TMA or warp
// specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int NWARP = 4;
constexpr int NT = 32 * NWARP;  // 128 threads
constexpr int BQ = 16 * NWARP;  // 64: the query rows a block owns
constexpr int BK = 64;          // the key tile the block streams
constexpr int PAD = 8;          // bf16 elements of padding a shared row
constexpr int MLD = BK + 16;    // row stride (bytes) of a shared mask tile

template <int D>
struct Geom {
  static constexpr int LD = D + PAD;  // row stride of every shared bf16 tile
  // Q, two stages of K and V
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)(BQ + 4 * BK) * LD;
  // and two stages of the mask tile
  static constexpr size_t SMEM_MASK = SMEM + 2 * BQ * MLD;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;  // (Tq, Tk), or null
  bf16* o;
  float* m;
  float* l;
  int H, Tq, Tk;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  float scale;
};

// the mask at rows [q0, q0 + BQ), columns [k0, k0 + BK) into dst (row
// stride MLD): by 4-byte cp.async when by4 (Tk and the pointer multiples
// of 4), else byte by byte; entries past Tq or Tk land as 0 (not valid)
__device__ __forceinline__ void load_mask(uint8_t* dst, const Args& a, int q0, int k0,
                                          bool by4) {
  if (by4) {
    constexpr int CH = BK / 4;  // 4-byte chunks a row
    for (int idx = threadIdx.x; idx < BQ * CH; idx += NT) {
      const int r = idx / CH, c = (idx % CH) * 4;
      const bool ok = q0 + r < a.Tq && k0 + c < a.Tk;
      cp_async4(dst + r * MLD + c,
                ok ? a.mask + (long long)(q0 + r) * a.Tk + k0 + c : a.mask, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK;
      const bool ok = q0 + r < a.Tq && k0 + c < a.Tk;
      dst[r * MLD + c] = ok ? a.mask[(long long)(q0 + r) * a.Tk + k0 + c] : 0;
    }
  }
}

// The partials of one (batch x head, 64-query tile): walks 64-key tiles
// [0, kt_end).
template <int D, bool MASK, bool CAUSAL>
__device__ __forceinline__ void fwd_block(const Args& a, int qt) {
  constexpr int LD = Geom<D>::LD;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + BQ * LD;      // two stages
  bf16* Vs = Ks + 2 * BK * LD;  // two stages
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + 2 * BK * LD);  // two stages (MASK)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * BQ, qw = q0 + 16 * warp;  // the block's and the warp's first query
  const bf16* qb = a.q + b * a.sqb + h * a.sqh;
  const bf16* kb = a.k + b * a.skb + h * a.skh;
  const bf16* vb = a.v + b * a.svb + h * a.svh;
  const bool by4 = MASK && a.Tk % 4 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 4 == 0;

  int kt_end = (a.Tk + BK - 1) / BK;
  if (CAUSAL) {
    // the last query of this tile sees keys up to its own position
    const int q_last = min(q0 + BQ, a.Tq) - 1;
    kt_end = min(kt_end, q_last / BK + 1);
  }

  load_rows<D, BQ, LD, NT>(Qs, qb, a.sqt, q0, a.Tq);
  load_rows<D, BK, LD, NT>(Ks, kb, a.skt, 0, a.Tk);
  load_rows<D, BK, LD, NT>(Vs, vb, a.svt, 0, a.Tk);
  if (MASK) load_mask(Ms, a, q0, 0, by4);
  cp_commit();

  // this thread's two rows of the warp's strip: g and g + 8
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero<D / 8>(acc);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_end) {  // the next tile into the other stage
      const int k1 = (kt + 1) * BK;
      load_rows<D, BK, LD, NT>(Ks + (st ^ 1) * BK * LD, kb, a.skt, k1, a.Tk);
      load_rows<D, BK, LD, NT>(Vs + (st ^ 1) * BK * LD, vb, a.svt, k1, a.Tk);
      if (MASK) load_mask(Ms + (st ^ 1) * BQ * MLD, a, q0, k1, by4);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;
    const uint8_t* Mw = Ms + st * BQ * MLD + 16 * warp * MLD;  // the warp's mask rows

    float s[BK / 8][4];
    zero<BK / 8>(s);
    strip_abt<D, BK, LD>(s, Qs + 16 * warp * LD, Kt, lane);

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

    uint32_t pf[BK / 16][4];
    to_a_fragments<BK>(pf, s);
    strip_pm<D, BK, LD>(acc, pf, Vt, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
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
__global__ void __launch_bounds__(NT) flash_fwd_mma_kernel(Args a) {
  fwd_block<D, MASK, false>(a, blockIdx.x);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_causal_mma_kernel(Args a) {
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
  if (causal) return launch(flash_fwd_causal_mma_kernel<D>, Geom<D>::SMEM, a, B, stream);
  if (a.mask != nullptr)
    return launch(flash_fwd_mma_kernel<D, true>, Geom<D>::SMEM_MASK, a, B, stream);
  return launch(flash_fwd_mma_kernel<D, false>, Geom<D>::SMEM, a, B, stream);
}

int run(const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
        void* l, int B, int H, int Tq, int Tk, int D, long long sqb, long long sqt,
        long long sqh, long long skb, long long skt, long long skh, long long svb,
        long long svt, long long svh, float scale, int causal, void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
               static_cast<bf16*>(o),       static_cast<float*>(m),
               static_cast<float*>(l),      H,   Tq,  Tk,  sqb, sqt, sqh,
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

// The non-causal bf16 partials; mask is a contiguous (Tq, Tk) uint8
// array, or null for none.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_mma_launch(
    const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
    void* l, int B, int H, int Tq, int Tk, int D, long long sqb, long long sqt,
    long long sqh, long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, float scale, void* stream) {
  return run(q, k, v, mask, o, m, l, B, H, Tq, Tk, D, sqb, sqt, sqh, skb, skt, skh, svb,
             svt, svh, scale, 0, stream);
}

// The causal diagonal-block bf16 partials (Tq == Tk).  Returns the
// launch's cudaError_t.
extern "C" int flash_fwd_causal_mma_launch(
    const void* q, const void* k, const void* v, void* o, void* m, void* l, int B, int H,
    int T, int D, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    float scale, void* stream) {
  return run(q, k, v, nullptr, o, m, l, B, H, T, T, D, sqb, sqt, sqh, skb, skt, skh, svb,
             svt, svh, scale, 1, stream);
}
