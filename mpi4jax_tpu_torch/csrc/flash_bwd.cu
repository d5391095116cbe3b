// Flash-attention backward of the block partials in f32 for Hopper
// (sm_90a): two kernels.  bf16 inputs take the tensor-core kernels of
// flash_bwd_mma.cu.
//
// Replace the TPU kernels of mpi4jax_tpu/kernels/flash_attention.py:
// - flash_bwd_dq_kernel replaces _bwd_dq_kernel (dq, one block per query
//   tile, walking key tiles);
// - flash_bwd_dkv_kernel replaces _bwd_dkv_kernel (dk and dv, one block per
//   key tile, walking query tiles).
// The partials map (q, k, v) -> (o, m, l) of flash_fwd.cu gets this
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
// has p = 0 everywhere and gets zero gradients, never NaN.  The arithmetic
// is that of the plain version (block_partials_bwd_plain in
// mpi4jax_tpu_torch/kernels/flash_attention.py): f32 products, f32
// accumulation; expf is the accurate one, and the library is built with
// FMA contraction on and without fast math.
//
// Layout: q and g_o (B, Tq, H, D), k and v (B, Tk, H, D), read in place
// through their batch, time and head strides (the last dimension is
// contiguous); m and g_l (B, H, Tq) f32, contiguous; dq is written
// (B, Tq, H, D), dk and dv (B, Tk, H, D).  Rows past Tq or Tk are guarded,
// never padded in device memory.
//
// Bound on an H100: operations.  dq does 3 products of length D per score
// pair (s, dp, ds k), dk/dv 4 (s, dp, ds q, p g_o): 6 and 8 B H Tq Tk D f32
// operations, 6.15 and 8.21 ms at B=4, T=4096, H=8, D=128 on the CUDA
// cores' 67 TFLOP/s, against 0.2 ms for the bytes; causal calls about half.
//
// Design (simple first, not yet fast): f32 FMA on the CUDA cores, as the
// forward.  Both kernels use blocks of 256 threads (16 x 16) that own a
// 64-row tile of their output (queries for dq, keys for dk/dv) and walk
// 32-row tiles of the other side.  Every thread holds 4 output rows
// (ty + 16 i) x D/16 columns of its accumulators in registers (two of them
// in the dk/dv kernel) and, for the score tile, 4 rows x 2 streamed rows
// (tx + 16 j).  All tiles sit in shared memory as f32 (108 KiB a block at
// D = 128, so two blocks an SM): the dq kernel keeps Q and g_O and streams
// K and V, then puts ds in a (64, 36) tile for the ds K product; the dk/dv
// kernel keeps K and V and streams Q and g_O, then puts p in the tile for
// the p g_O product and ds after it for the ds Q product.  The split into
// two kernels needs no atomics: both outputs are deterministic.  No tensor
// cores (wgmma), TMA or pipelining of the next tile's loads yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;              // threads along the streamed rows and columns
constexpr int TY = 16;              // threads along the block's own rows
constexpr int NT = TX * TY;         // 256 threads
constexpr int RPT = 4;              // own rows per thread (ty + 16 i)
constexpr int BOWN = TY * RPT;      // 64: the block's own tile
constexpr int SPT = 2;              // streamed rows per thread (tx + 16 j)
constexpr int BSTR = TX * SPT;      // 32: the streamed tile
constexpr int LDS = BSTR + 4;       // row stride of the score-shaped tile

template <int D>
struct Geom {
  static constexpr int LD = D + 4;  // row stride of the operand tiles
  static constexpr int VEC = (D / TX >= 4) ? 4 : D / TX;  // columns per chunk
  static constexpr int NCH = D / TX / VEC;                 // chunks per thread
  static constexpr int NC = D / TX;                        // columns per thread
  // two own tiles, two streamed tiles, the score tile, two row vectors
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(2 * BOWN + 2 * BSTR) * LD + BOWN * LDS + 2 * BSTR);
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* go;
  const uint8_t* mask;  // (Tq, Tk), or null
  const float* m;
  const float* gl;
  void* dq;
  void* dk;
  void* dv;
  int H, Tq, Tk;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt, sgh;
  float scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
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

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][j] += A[ty + 16 i] . B[tx + 16 j] over D (row stride LD for both)
template <int D>
__device__ __forceinline__ void dots(float (&acc)[RPT][SPT], const float* A,
                                     const float* B, int ty, int tx) {
  constexpr int LD = Geom<D>::LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RPT], bv[SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty + TY * i) * LD + d);
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + TX * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        float x = acc[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        acc[i][j] = x;
      }
  }
}

// acc[i][cols] += S[ty + 16 i][:] @ M[:, cols] over the BSTR streamed rows;
// S has row stride LDS, M row stride LD; this thread's columns are chunks
// of VEC at ch * 16 * VEC + tx * VEC
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[RPT][Geom<D>::NC],
                                           const float* S, const float* M,
                                           int ty, int tx) {
  using G = Geom<D>;
#pragma unroll 2
  for (int c = 0; c < BSTR; c += 4) {
    float4 sv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      sv[i] = *reinterpret_cast<const float4*>(S + (ty + TY * i) * LDS + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float mv[G::NC];
#pragma unroll
      for (int ch = 0; ch < G::NCH; ++ch)
        load_vec<G::VEC>(mv + ch * G::VEC, M + (c + e) * G::LD + (ch * TX + tx) * G::VEC);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float s = lane(sv[i], e);
#pragma unroll
        for (int cc = 0; cc < G::NC; ++cc) acc[i][cc] = fmaf(s, mv[cc], acc[i][cc]);
      }
    }
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_rows(void* out, const float (&acc)[RPT][Geom<D>::NC],
                                           int b, int h, int H, int row0, int n,
                                           int ty, int tx) {
  using G = Geom<D>;
  T* ob = static_cast<T*>(out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int pos = row0 + ty + TY * i;
    if (pos >= n) continue;
    T* row = ob + (((long long)b * n + pos) * H + h) * D;
#pragma unroll
    for (int ch = 0; ch < G::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < G::VEC; ++e)
        Elem<T>::store(row + (ch * TX + tx) * G::VEC + e, acc[i][ch * G::VEC + e]);
  }
}

// dq of one (batch x head, 64-query tile): walks 32-key tiles [0, kt_end).
template <int D, typename T, bool MASK, bool CAUSAL>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dq_kernel(Args a) {
  using G = Geom<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + BOWN * G::LD;
  float* Ks = Gs + BOWN * G::LD;
  float* Vs = Ks + BSTR * G::LD;
  float* Ss = Vs + BSTR * G::LD;  // ds

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // causal: the tiles with the most keys first, so the short ones fill the tail
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BOWN;
  const T* qb = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* gb = static_cast<const T*>(a.go) + b * a.sgb + h * a.sgh;
  const T* kb = static_cast<const T*>(a.k) + b * a.skb + h * a.skh;
  const T* vb = static_cast<const T*>(a.v) + b * a.svb + h * a.svh;

  load_tile<D, T>(Qs, G::LD, qb, a.sqt, q0, BOWN, a.Tq);
  load_tile<D, T>(Gs, G::LD, gb, a.sgt, q0, BOWN, a.Tq);

  float msafe[RPT], gl[RPT], acc[RPT][G::NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + TY * i;
    float mv = 0.f, g = 0.f;
    if (qpos < a.Tq) {
      mv = a.m[(long long)bh * a.Tq + qpos];
      g = a.gl[(long long)bh * a.Tq + qpos];
    }
    msafe[i] = isinf(mv) ? 0.f : mv;
    gl[i] = g;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) acc[i][c] = 0.f;
  }

  int kt_end = (a.Tk + BSTR - 1) / BSTR;
  if (CAUSAL) {
    // the last query of this tile sees keys up to its own position
    const int q_last = min(q0 + BOWN, a.Tq) - 1;
    kt_end = min(kt_end, q_last / BSTR + 1);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BSTR;
    __syncthreads();  // the previous tile's ds and K are consumed
    load_tile<D, T>(Ks, G::LD, kb, a.skt, k0, BSTR, a.Tk);
    load_tile<D, T>(Vs, G::LD, vb, a.svt, k0, BSTR, a.Tk);
    __syncthreads();

    float s[RPT][SPT], dp[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[i][j] = dp[i][j] = 0.f;
    dots<D>(s, Qs, Ks, ty, tx);
    dots<D>(dp, Gs, Vs, ty, tx);

    const bool guard = MASK || (k0 + BSTR > a.Tk) || (CAUSAL && k0 + BSTR - 1 > q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        bool ok = true;
        if (guard) {
          ok = kpos < a.Tk;
          if (MASK)
            ok = ok && qpos < a.Tq && a.mask[(long long)qpos * a.Tk + kpos] != 0;
          if (CAUSAL) ok = ok && qpos >= kpos;
        }
        const float p = ok ? expf(s[i][j] * a.scale - msafe[i]) : 0.f;
        Ss[(ty + TY * i) * LDS + tx + TX * j] = p * (dp[i][j] + gl[i]) * a.scale;
      }
    }
    __syncthreads();
    accumulate<D>(acc, Ss, Ks, ty, tx);
  }
  store_rows<D, T>(a.dq, acc, b, h, a.H, q0, a.Tq, ty, tx);
}

// dk and dv of one (batch x head, 64-key tile): walks 32-query tiles
// [qt_begin, n_qt).
template <int D, typename T, bool MASK, bool CAUSAL>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dkv_kernel(Args a) {
  using G = Geom<D>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BOWN * G::LD;
  float* Qs = Vs + BOWN * G::LD;
  float* Gs = Qs + BSTR * G::LD;
  float* Ps = Gs + BSTR * G::LD;  // p, then ds
  float* Ms = Ps + BOWN * LDS;    // m_safe of the query tile
  float* Ls = Ms + BSTR;          // g_l of the query tile

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BOWN;  // causal: the first tiles see the most queries
  const T* qb = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* gb = static_cast<const T*>(a.go) + b * a.sgb + h * a.sgh;
  const T* kb = static_cast<const T*>(a.k) + b * a.skb + h * a.skh;
  const T* vb = static_cast<const T*>(a.v) + b * a.svb + h * a.svh;

  load_tile<D, T>(Ks, G::LD, kb, a.skt, k0, BOWN, a.Tk);
  load_tile<D, T>(Vs, G::LD, vb, a.svt, k0, BOWN, a.Tk);

  float dk[RPT][G::NC], dv[RPT][G::NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < G::NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: the queries before this tile's first key see none of its keys
  const int qt_begin = CAUSAL ? k0 / BSTR : 0;
  const int n_qt = (a.Tq + BSTR - 1) / BSTR;

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * BSTR;
    __syncthreads();  // the previous tile's ds, Q and g_O are consumed
    load_tile<D, T>(Qs, G::LD, qb, a.sqt, q0, BSTR, a.Tq);
    load_tile<D, T>(Gs, G::LD, gb, a.sgt, q0, BSTR, a.Tq);
    for (int r = threadIdx.x; r < BSTR; r += NT) {
      const int qpos = q0 + r;
      float mv = 0.f, g = 0.f;
      if (qpos < a.Tq) {
        mv = a.m[(long long)bh * a.Tq + qpos];
        g = a.gl[(long long)bh * a.Tq + qpos];
      }
      Ms[r] = isinf(mv) ? 0.f : mv;
      Ls[r] = g;
    }
    __syncthreads();

    float s[RPT][SPT], dp[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[i][j] = dp[i][j] = 0.f;
    dots<D>(s, Ks, Qs, ty, tx);
    dots<D>(dp, Vs, Gs, ty, tx);

    const bool guard = MASK || (q0 + BSTR > a.Tq) || (k0 + BOWN > a.Tk) ||
                       (CAUSAL && q0 < k0 + BOWN - 1);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int kpos = k0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int r = tx + TX * j, qpos = q0 + r;
        bool ok = true;
        if (guard) {
          ok = kpos < a.Tk && qpos < a.Tq;
          if (MASK) ok = ok && a.mask[(long long)qpos * a.Tk + kpos] != 0;
          if (CAUSAL) ok = ok && qpos >= kpos;
        }
        const float p = ok ? expf(s[i][j] * a.scale - Ms[r]) : 0.f;
        dp[i][j] = p * (dp[i][j] + Ls[r]) * a.scale;  // ds from here on
        Ps[(ty + TY * i) * LDS + r] = p;
      }
    }
    __syncthreads();
    accumulate<D>(dv, Ps, Gs, ty, tx);
    __syncthreads();  // every thread is done reading p
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) Ps[(ty + TY * i) * LDS + tx + TX * j] = dp[i][j];
    __syncthreads();
    accumulate<D>(dk, Ps, Qs, ty, tx);
  }
  store_rows<D, T>(a.dk, dk, b, h, a.H, k0, a.Tk, ty, tx);
  store_rows<D, T>(a.dv, dv, b, h, a.H, k0, a.Tk, ty, tx);
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, dim3 grid, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, typename T, bool MASK, bool CAUSAL>
cudaError_t launch_kind(const Args& a, int B, bool dkv, cudaStream_t stream) {
  const size_t smem = Geom<D>::SMEM;
  if (dkv)
    return launch(flash_bwd_dkv_kernel<D, T, MASK, CAUSAL>, smem,
                  dim3((a.Tk + BOWN - 1) / BOWN, B * a.H), a, stream);
  return launch(flash_bwd_dq_kernel<D, T, MASK, CAUSAL>, smem,
                dim3((a.Tq + BOWN - 1) / BOWN, B * a.H), a, stream);
}

template <int D, typename T>
cudaError_t dispatch_mode(const Args& a, int B, int causal, bool dkv,
                          cudaStream_t stream) {
  if (causal) return launch_kind<D, T, false, true>(a, B, dkv, stream);
  if (a.mask != nullptr) return launch_kind<D, T, true, false>(a, B, dkv, stream);
  return launch_kind<D, T, false, false>(a, B, dkv, stream);
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int B, int D, int causal, bool dkv,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_mode<32, T>(a, B, causal, dkv, stream);
    case 64: return dispatch_mode<64, T>(a, B, causal, dkv, stream);
    case 128: return dispatch_mode<128, T>(a, B, causal, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Args& a, int B, int D, int causal, bool dkv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_d<float>(a, B, D, causal, dkv, s));
}

Args make_args(const void* q, const void* k, const void* v, const void* go,
               const void* mask, const void* m, const void* gl, void* dq,
               void* dk, void* dv, int H, int Tq, int Tk, long long sqb,
               long long sqt, long long sqh, long long skb, long long skt,
               long long skh, long long svb, long long svt, long long svh,
               long long sgb, long long sgt, long long sgh, float scale) {
  return Args{q,   k,   v,   go,  static_cast<const uint8_t*>(mask),
              static_cast<const float*>(m), static_cast<const float*>(gl),
              dq,  dk,  dv,  H,   Tq,  Tk,  sqb, sqt, sqh, skb, skt, skh,
              svb, svt, svh, sgb, sgt, sgh, scale};
}

}  // namespace

// dq (B, Tq, H, D) f32 of the partials; mask is a contiguous (Tq, Tk) uint8
// array, or null; causal needs Tq == Tk and no mask.  Returns the launch's
// cudaError_t.
extern "C" int flash_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* go,
    const void* mask, const void* m, const void* gl, void* dq, int B, int H,
    int Tq, int Tk, int D, int causal, long long sqb, long long sqt,
    long long sqh, long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, long long sgb, long long sgt, long long sgh,
    float scale, void* stream) {
  const Args a = make_args(q, k, v, go, mask, m, gl, dq, nullptr, nullptr, H,
                           Tq, Tk, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
                           sgb, sgt, sgh, scale);
  return run(a, B, D, causal, false, stream);
}

// dk and dv (B, Tk, H, D) f32 of the partials; arguments as for dq.  Returns
// the launch's cudaError_t.
extern "C" int flash_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* go,
    const void* mask, const void* m, const void* gl, void* dk, void* dv,
    int B, int H, int Tq, int Tk, int D, int causal, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sgb, long long sgt,
    long long sgh, float scale, void* stream) {
  const Args a = make_args(q, k, v, go, mask, m, gl, nullptr, dk, dv, H, Tq,
                           Tk, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
                           sgb, sgt, sgh, scale);
  return run(a, B, D, causal, true, stream);
}
