// Flash-attention forward partials in f32 for Hopper (sm_90a): two
// kernels.
//
// Replace the TPU kernels of mpi4jax_tpu/kernels/flash_attention.py for
// f32 inputs (bf16 inputs take the tensor-core kernels of
// flash_fwd_mma.cu):
// - flash_fwd_kernel replaces _kernel (the non-causal streaming partials,
//   with an optional (Tq, Tk) bool mask shared across batch and heads);
// - flash_fwd_causal_kernel replaces _kernel_causal (the diagonal block of
//   a causal ring, Tq == Tk: key tiles that lie wholly after a query
//   tile's last query are never visited).
// Both compute, for every (batch, head) and query row,
//     m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) @ V,
// with s = (q . k) * scale in f32 and masked entries at -inf, through the
// online-softmax merge of _merge_tile (flash_attention.py:88-103): a row
// that has seen no attendable key keeps m = -inf, l = 0, o = 0, never NaN.
// The arithmetic follows the plain version (block_partials_plain in
// mpi4jax_tpu_torch/kernels/flash_attention.py): f32 products of the
// inputs, scale applied to the f32 score, f32 accumulation.  expf is the
// accurate one; the library is built with FMA contraction on and without
// fast math.
//
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), read in place through
// their batch, time and head strides (the last dimension is contiguous);
// o is written (B, Tq, H, D), m and l (B, H, Tq).  Keys at or past Tk and
// queries at or past Tq are guarded, never padded in device memory.
//
// Bound on an H100: operations.  A non-causal call does 4 B H Tq Tk D
// f32 operations (2.749e11 at B=4, T=4096, H=8, D=128: 4.10 ms at
// 67 TFLOP/s on the CUDA cores) against 269 MB of inputs and outputs
// (0.080 ms at 3.35 TB/s); the causal call does about half.
//
// Design (simple first, not yet fast): one block of 256 threads per
// (batch x head, 64-query tile), walking 64-key tiles.  Q, K and V tiles
// are staged in shared memory as f32; each thread owns 4 query rows
// (ty + 16 i) and, for the scores, 4 keys (tx + 16 j), so a row's 16
// partial maxima and sums meet by shuffles inside a half warp.  The
// online-softmax carries (m, l and the thread's 4 x D/16 slice of the
// output accumulator) live in registers.  The probabilities go to shared
// memory over the K tile, which the scores no longer need, and the PV
// product reads them with V.  No tensor cores (wgmma), TMA or pipelining
// of the next tile's loads yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // queries per block
constexpr int BK = 64;            // keys per tile
constexpr int TX = 16;            // threads along keys / output columns
constexpr int TY = 16;            // threads along queries
constexpr int NT = TX * TY;       // 256 threads
constexpr int RPT = BQ / TY;      // query rows per thread
constexpr int KPT = BK / TX;      // keys per thread in the score tile
constexpr int LDP = BK + 4;       // row stride of the probability tile

template <int D>
struct Geom {
  static constexpr int LDQ = D + 4;  // row stride of the Q and K tiles
  static constexpr int LDV = D;      // row stride of the V tile
  static constexpr int KP = (BK * LDQ > BQ * LDP) ? BK * LDQ : BQ * LDP;
  static constexpr int VEC = (D / TX >= 4) ? 4 : D / TX;  // output columns per chunk
  static constexpr int NCH = D / TX / VEC;                 // chunks per thread
  static constexpr int NC = D / TX;                        // output columns per thread
  static constexpr size_t SMEM = sizeof(float) * (size_t)(BQ * LDQ + KP + BK * LDV);
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // (Tq, Tk), or null
  void* o;
  float* m;
  float* l;
  int H, Tq, Tk;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  float scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

// rows [row0, row0 + rows) of one (batch, head) slice into dst (row stride
// ld), as f32; rows at or past n are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long st, int row0, int rows, int n) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < rows * C; idx += NT) {
    const int r = idx / C, c = (idx % C) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = Elem<T>::load4(base + (long long)(row0 + r) * st + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float* out, const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

// The partials of one (batch x head, query tile): walks key tiles
// [0, kt_end), masking on the mask (MASK), on causality where a tile
// reaches past the tile's first query (CAUSAL) and on the ragged tail.
template <int D, typename T, bool MASK, bool CAUSAL>
__device__ __forceinline__ void flash_block(const Args& a, int qt) {
  using G = Geom<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * G::LDQ;  // the K tile, then the probability tile
  float* Vs = Ks + G::KP;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * BQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + b * a.skb + h * a.skh;
  const T* vb = static_cast<const T*>(a.v) + b * a.svb + h * a.svh;

  load_tile<D, T>(Qs, G::LDQ, qb, a.sqt, q0, BQ, a.Tq);

  float m_r[RPT], l_r[RPT], acc[RPT][G::NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) acc[i][c] = 0.f;
  }

  int kt_end = (a.Tk + BK - 1) / BK;
  if (CAUSAL) {
    // the last query of this tile sees keys up to its own position
    const int q_last = min(q0 + BQ, a.Tq) - 1;
    kt_end = min(kt_end, q_last / BK + 1);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P and V are consumed
    load_tile<D, T>(Ks, G::LDQ, kb, a.skt, k0, BK, a.Tk);
    load_tile<D, T>(Vs, G::LDV, vb, a.svt, k0, BK, a.Tk);
    __syncthreads();

    // scores: s[i][j] = q[ty + 16 i] . k[tx + 16 j]
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * G::LDQ + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + TX * j) * G::LDQ + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
    }

    // scale, and -inf where a key is masked, causal-hidden or past Tk
    const bool guard = MASK || (k0 + BK > a.Tk) || (CAUSAL && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = s[i][j] * a.scale;
        if (guard) {
          bool ok = kpos < a.Tk;
          if (MASK)
            ok = ok && qpos < a.Tq && a.mask[(long long)qpos * a.Tk + kpos] != 0;
          if (CAUSAL) ok = ok && qpos >= kpos;
          if (!ok) x = -INFINITY;
        }
        s[i][j] = x;
      }
    }
    __syncthreads();  // every thread is done reading the K tile

    // online softmax (_merge_tile), one row at a time
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mt = fmaxf(m_r[i], mx);
      const float mt_safe = isinf(mt) ? 0.f : mt;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = isinf(s[i][j]) ? 0.f : expf(s[i][j] - mt_safe);
        rs += p;
        Ps[(ty + TY * i) * LDP + tx + TX * j] = Elem<T>::round(p);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float cf = isinf(m_r[i]) ? 0.f : expf(m_r[i] - mt_safe);
      l_r[i] = l_r[i] * cf + rs;
      m_r[i] = mt;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) acc[i][c] *= cf;
    }
    __syncthreads();

    // acc[i][cols] += P[ty + 16 i][:] @ V[:, cols]; this thread's columns
    // are chunks of VEC at ch * 16 * VEC + tx * VEC
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + TY * i) * LDP + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[G::NC];
#pragma unroll
        for (int ch = 0; ch < G::NCH; ++ch)
          load_vec<G::VEC>(vv + ch * G::VEC,
                           Vs + (c + e) * G::LDV + (ch * TX + tx) * G::VEC);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float p = e == 0 ? pv[i].x
                        : e == 1 ? pv[i].y
                        : e == 2 ? pv[i].z
                                 : pv[i].w;
#pragma unroll
          for (int cc = 0; cc < G::NC; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
        }
      }
    }
  }

  T* ob = static_cast<T*>(a.o);
  const long long H = a.H;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= a.Tq) continue;
    T* orow = ob + (((long long)b * a.Tq + qpos) * H + h) * D;
#pragma unroll
    for (int ch = 0; ch < G::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < G::VEC; ++e)
        Elem<T>::store(orow + (ch * TX + tx) * G::VEC + e, acc[i][ch * G::VEC + e]);
    if (tx == 0) {
      const long long at = (long long)bh * a.Tq + qpos;
      a.m[at] = m_r[i];
      a.l[at] = l_r[i];
    }
  }
}

template <int D, typename T, bool MASK>
__global__ void __launch_bounds__(NT, 2) flash_fwd_kernel(Args a) {
  flash_block<D, T, MASK, false>(a, blockIdx.x);
}

template <int D, typename T>
__global__ void __launch_bounds__(NT, 2) flash_fwd_causal_kernel(Args a) {
  // the tiles with the most keys first, so the short ones fill the tail
  flash_block<D, T, false, true>(a, gridDim.x - 1 - blockIdx.x);
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, const Args& a, int B, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, B * a.H);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dispatch_mode(const Args& a, int B, int causal, cudaStream_t stream) {
  const size_t smem = Geom<D>::SMEM;
  if (causal) return launch(flash_fwd_causal_kernel<D, T>, smem, a, B, stream);
  if (a.mask != nullptr)
    return launch(flash_fwd_kernel<D, T, true>, smem, a, B, stream);
  return launch(flash_fwd_kernel<D, T, false>, smem, a, B, stream);
}

cudaError_t dispatch_d(const Args& a, int B, int D, int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_mode<32, float>(a, B, causal, stream);
    case 64: return dispatch_mode<64, float>(a, B, causal, stream);
    case 128: return dispatch_mode<128, float>(a, B, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* mask, void* o,
        void* m, void* l, int B, int H, int Tq, int Tk, int D, long long sqb,
        long long sqt, long long sqh, long long skb, long long skt,
        long long skh, long long svb, long long svt, long long svh,
        float scale, int causal, void* stream) {
  Args a{q,   k,   v,   static_cast<const uint8_t*>(mask),
         o,   static_cast<float*>(m), static_cast<float*>(l),
         H,   Tq,  Tk,  sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_d(a, B, D, causal, s));
}

}  // namespace

// The non-causal partials; mask is a contiguous (Tq, Tk) uint8 array, or
// null for none.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_launch(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* m, void* l, int B, int H, int Tq, int Tk, int D, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, float scale, void* stream) {
  return run(q, k, v, mask, o, m, l, B, H, Tq, Tk, D, sqb, sqt, sqh,
             skb, skt, skh, svb, svt, svh, scale, 0, stream);
}

// The causal diagonal-block partials (Tq == Tk).  Returns the launch's
// cudaError_t.
extern "C" int flash_fwd_causal_launch(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int H, int T, int D, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, float scale, void* stream) {
  return run(q, k, v, nullptr, o, m, l, B, H, T, T, D, sqb, sqt, sqh,
             skb, skt, skh, svb, svt, svh, scale, 1, stream);
}
