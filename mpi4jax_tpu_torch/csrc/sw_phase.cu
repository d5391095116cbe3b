// Split-phase shallow-water kernels for Hopper (sm_90a).
//
// Replace the TPU kernel examples/shallow_water.py:_sw_phase_kernel, which
// model_step_pallas_halo launches twice per step with real halo exchanges
// between the launches:
// - phase 1 (_phase1_window): depth pad hc, fluxes, potential vorticity,
//   kinetic energy, tendencies and the AB-2 or Euler update; six f32
//   (ny, nx) fields in (h u v dh du dv), six out;
// - phase 2 (_phase2_window): lateral viscosity; u and v in and out.
// Both work on one rank's local array in the default mask frame.  The
// rank's domain-global offsets come in as two ints, so one build serves
// every rank.  Every output cell, the halo ring included, equals what the
// plain version (mpi4jax_tpu_torch/kernels/sw_phase.py: the window over
// the whole array with torch.roll) gives: the tile is gathered with
// periodic addressing in both dimensions, which is what torch.roll reads.
//
// Bound: bytes.  The output's halo ring is overwritten or feeds only ring
// cells, so AB-2 phase 1 must read h, u, v whole, the tendencies on the
// interior and write six fields on the interior (311.2 MB at 3602 x 1802,
// 0.0929 ms at 3.35 TB/s); phase 2 reads u, v whole and writes their
// interior (0.0310 ms).  Their ~81 and ~26 f32 operations per cell need a
// fraction of that.
//
// Design (simple first, not yet fast): each block owns a TY x TX output
// tile and loads the fields that are read at neighbours (h, u, v; or u, v)
// for the tile plus a margin of the phase's dependency radius (P1_RY,
// P1_RX or P2_RY, P2_RX, passed as -D flags by the Python module, which
// measures them) into shared memory.  The intermediates (fe, fn, q, ke; or
// the viscous fluxes) stay in shared memory; the old tendencies are read
// at the output cell only.

#include "sw_window.cuh"

namespace {

#if !defined(SW_TY) || !defined(SW_TX) || !defined(P1_RY) || !defined(P1_RX) || \
    !defined(P2_RY) || !defined(P2_RX)
#error "build through mpi4jax_tpu_torch/kernels/sw_phase.py (tile flags)"
#endif

constexpr int TY = SW_TY;
constexpr int TX = SW_TX;
constexpr int NTHREADS = 256;

template <int RY, int RX, int NARR>
struct Geom {
  static constexpr int EY = TY + 2 * RY;
  static constexpr int EX = TX + 2 * RX;
  static constexpr int N = EY * EX;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)NARR * N + sizeof(int) * (size_t)(EY + EX);
};

using G1 = Geom<P1_RY, P1_RX, 7>;  // h u v fe fn q ke
using G2 = Geom<P2_RY, P2_RX, 6>;  // u v, gx gy of each

// The tile's array rows and columns, periodic in both dimensions.
template <class G, int RY, int RX>
__device__ sw::Tile load_index(int* ly, int* lx, const sw::Frame& f) {
  const int y0 = blockIdx.y * TY - RY, x0 = blockIdx.x * TX - RX;
  for (int i = threadIdx.x; i < G::EY; i += NTHREADS) ly[i] = sw::pmod(y0 + i, f.ny);
  for (int i = threadIdx.x; i < G::EX; i += NTHREADS) lx[i] = sw::pmod(x0 + i, f.nx);
  __syncthreads();
  return sw::Tile{G::EY, G::EX, ly, lx};
}

__global__ void __launch_bounds__(NTHREADS)
sw_phase1_kernel(const float* __restrict__ h_in, const float* __restrict__ u_in,
                 const float* __restrict__ v_in, const float* __restrict__ dh_in,
                 const float* __restrict__ du_in, const float* __restrict__ dv_in,
                 float* __restrict__ h_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, float* __restrict__ dh_out,
                 float* __restrict__ du_out, float* __restrict__ dv_out,
                 sw::Frame f, sw::Consts k, int first) {
  constexpr int N = G1::N;
  extern __shared__ float smem[];
  float* h = smem;
  float* u = smem + N;
  float* v = smem + 2 * N;
  float* fe = smem + 3 * N;
  float* fn = smem + 4 * N;
  float* q = smem + 5 * N;
  float* ke = smem + 6 * N;
  int* ly = reinterpret_cast<int*>(smem + 7 * N);
  int* lx = ly + G1::EY;
  const sw::Tile t = load_index<G1, P1_RY, P1_RX>(ly, lx, f);

  for (int c = threadIdx.x; c < N; c += NTHREADS) {
    const size_t g = (size_t)ly[c / G1::EX] * f.nx + lx[c % G1::EX];
    h[c] = h_in[g];
    u[c] = u_in[g];
    v[c] = v_in[g];
  }
  __syncthreads();
  sw::phase1_fluxes<false>(t, f, k, h, u, v, fe, fn, q, ke);
  __syncthreads();

  for (int c = threadIdx.x; c < TY * TX; c += NTHREADS) {
    const int ty = c / TX, tx = c % TX;
    const int oy = blockIdx.y * TY + ty, ox = blockIdx.x * TX + tx;
    if (oy >= f.ny || ox >= f.nx) continue;
    const size_t g = (size_t)oy * f.nx + ox;
    float out[6];
    sw::phase1_update<false>(t, f, k, first != 0, h, u, v, fe, fn, q, ke,
                             ty + P1_RY, tx + P1_RX, dh_in[g], du_in[g],
                             dv_in[g], out);
    h_out[g] = out[0];
    u_out[g] = out[1];
    v_out[g] = out[2];
    dh_out[g] = out[3];
    du_out[g] = out[4];
    dv_out[g] = out[5];
  }
}

__global__ void __launch_bounds__(NTHREADS)
sw_phase2_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 sw::Frame f, sw::Consts k) {
  constexpr int N = G2::N;
  extern __shared__ float smem[];
  float* u = smem;
  float* v = smem + N;
  float* gxu = smem + 2 * N;
  float* gyu = smem + 3 * N;
  float* gxv = smem + 4 * N;
  float* gyv = smem + 5 * N;
  int* ly = reinterpret_cast<int*>(smem + 6 * N);
  int* lx = ly + G2::EY;
  const sw::Tile t = load_index<G2, P2_RY, P2_RX>(ly, lx, f);

  for (int c = threadIdx.x; c < N; c += NTHREADS) {
    const size_t g = (size_t)ly[c / G2::EX] * f.nx + lx[c % G2::EX];
    u[c] = u_in[g];
    v[c] = v_in[g];
  }
  __syncthreads();
  sw::phase2_fluxes<false>(t, f, k, u, gxu, gyu);
  sw::phase2_fluxes<false>(t, f, k, v, gxv, gyv);
  __syncthreads();

  for (int c = threadIdx.x; c < TY * TX; c += NTHREADS) {
    const int ty = c / TX, tx = c % TX;
    const int oy = blockIdx.y * TY + ty, ox = blockIdx.x * TX + tx;
    if (oy >= f.ny || ox >= f.nx) continue;
    const size_t g = (size_t)oy * f.nx + ox;
    u_out[g] = sw::phase2_update<false>(t, f, k, u, gxu, gyu, ty + P2_RY, tx + P2_RX);
    v_out[g] = sw::phase2_update<false>(t, f, k, v, gxv, gyv, ty + P2_RY, tx + P2_RX);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *done = true;
  return e;
}

sw::Consts consts(float dx, float dy, float g, float dt, float ab_a,
                  float ab_b, float f0, float beta, float visc) {
  return sw::Consts{dx, dy, g, dt, ab_a, ab_b, f0, beta, visc};
}

}  // namespace

// Phase 1 on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int sw_phase1_launch(
    const float* h, const float* u, const float* v, const float* dh,
    const float* du, const float* dv, float* oh, float* ou, float* ov,
    float* odh, float* odu, float* odv, int ny, int nx, int oy, int ox,
    int GY, int GX, int walls, int first, float dx, float dy, float g,
    float dt, float ab_a, float ab_b, float f0, float beta, float visc,
    void* stream) {
  static bool attr = false;
  cudaError_t e = allow_smem(sw_phase1_kernel, G1::SMEM, &attr);
  if (e != cudaSuccess) return (int)e;
  const sw::Frame f{ny, nx, oy, ox, GY, GX, walls};
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
  sw_phase1_kernel<<<grid, NTHREADS, G1::SMEM, static_cast<cudaStream_t>(stream)>>>(
      h, u, v, dh, du, dv, oh, ou, ov, odh, odu, odv, f,
      consts(dx, dy, g, dt, ab_a, ab_b, f0, beta, visc), first);
  return (int)cudaGetLastError();
}

// Phase 2 on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int sw_phase2_launch(
    const float* u, const float* v, float* ou, float* ov, int ny, int nx,
    int oy, int ox, int GY, int GX, int walls, float dx, float dy, float g,
    float dt, float ab_a, float ab_b, float f0, float beta, float visc,
    void* stream) {
  static bool attr = false;
  cudaError_t e = allow_smem(sw_phase2_kernel, G2::SMEM, &attr);
  if (e != cudaSuccess) return (int)e;
  const sw::Frame f{ny, nx, oy, ox, GY, GX, walls};
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
  sw_phase2_kernel<<<grid, NTHREADS, G2::SMEM, static_cast<cudaStream_t>(stream)>>>(
      u, v, ou, ov, f, consts(dx, dy, g, dt, ab_a, ab_b, f0, beta, visc));
  return (int)cudaGetLastError();
}
