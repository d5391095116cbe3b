// Wide-halo multi-step shallow-water kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel examples/shallow_water.py:_sw_wide_kernel:
// NSTEPS in {1, 2} whole Sadourny/AB-2 steps (the first one Euler when
// asked) on a rank's widened frame, the local array grown by m - 1 cells
// of neighbour data on every side (ny + 2(m-1), nx + 2(m-1); m = 8 or 16),
// six f32 fields in and six out.  One step is _wide_step_window of
// mpi4jax_tpu_torch/kernels/sw_wide.py: phase 1 in the wide mask frame,
// the wall rows of u and v set to zero, phase 2 in the wide frame.  There
// are no exchanges and no periodic column fixes: the x wrap data is real
// far-side data in the frame's margins.  The frame's domain-global offsets
// (the rank's offsets minus m - 1, negative on the first rank) come in as
// two ints, so one build serves every rank.  The frame is addressed
// periodically, as torch.roll over the whole frame does; on the crop
// region [m-1, m-1+ny) x [m-1, m-1+nx) every cell equals the plain
// version's.  Outside it lies recompute garbage (inf and NaN beyond the
// walls, where the frame holds zero depths) that the caller overwrites
// before any further use; every mask is a select, so none of it leaks in.
//
// Bound: bytes.  Only the crop is meaningful, so an AB-2 call must read
// h, u, v on the crop grown by NSTEPS x the step radius, the tendencies on
// the crop grown by (NSTEPS - 1) x it, and write six fields on the crop
// (312.3 MB for a pair on the 1802 x 3602 crop of 3600 x 1800, 0.0932 ms
// at 3.35 TB/s); ~107 f32 operations per cell and step need far less.
//
// Design (simple first, as csrc/sw_steps.cu): each block owns a TY x TX
// output tile and loads the six fields with a margin of NSTEPS times the
// per-step dependency radius (SW_RY, SW_RX, passed as -D flags by the
// Python module, which measures it) into shared memory; every
// intermediate and, for NSTEPS = 2, the intermediate state stay there.

#include "sw_window.cuh"

namespace {

#if !defined(SW_TY) || !defined(SW_TX) || !defined(SW_RY) || !defined(SW_RX)
#error "build through mpi4jax_tpu_torch/kernels/sw_wide.py (tile flags)"
#endif

constexpr int TY = SW_TY;
constexpr int TX = SW_TX;
constexpr int NTHREADS = 256;
constexpr int NARR = 11;  // h u v dh du dv, fe fn q ke, and one spare

template <int NSTEPS>
struct Geom {
  static constexpr int MY = SW_RY * NSTEPS;
  static constexpr int MX = SW_RX * NSTEPS;
  static constexpr int EY = TY + 2 * MY;
  static constexpr int EX = TX + 2 * MX;
  static constexpr int N = EY * EX;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)NARR * N + sizeof(int) * (size_t)(EY + EX);
};

template <int NSTEPS>
__global__ void __launch_bounds__(NTHREADS)
sw_wide_kernel(const float* __restrict__ h_in, const float* __restrict__ u_in,
               const float* __restrict__ v_in, const float* __restrict__ dh_in,
               const float* __restrict__ du_in, const float* __restrict__ dv_in,
               float* __restrict__ h_out, float* __restrict__ u_out,
               float* __restrict__ v_out, float* __restrict__ dh_out,
               float* __restrict__ du_out, float* __restrict__ dv_out,
               sw::Frame f, sw::Consts k, int first_step, int has_visc) {
  using G = Geom<NSTEPS>;
  constexpr int N = G::N;
  extern __shared__ float smem[];
  float* h = smem;
  float* u = smem + 1 * N;
  float* v = smem + 2 * N;
  float* dh = smem + 3 * N;
  float* du = smem + 4 * N;
  float* dv = smem + 5 * N;
  float* fe = smem + 6 * N;
  float* fn = smem + 7 * N;
  float* q = smem + 8 * N;
  float* ke = smem + 9 * N;
  float* spare = smem + 10 * N;
  int* ly = reinterpret_cast<int*>(smem + NARR * N);
  int* lx = ly + G::EY;

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TY - G::MY;
  const int x0 = blockIdx.x * TX - G::MX;
  for (int i = tid; i < G::EY; i += NTHREADS) ly[i] = sw::pmod(y0 + i, f.ny);
  for (int i = tid; i < G::EX; i += NTHREADS) lx[i] = sw::pmod(x0 + i, f.nx);
  __syncthreads();
  const sw::Tile t{G::EY, G::EX, ly, lx};

  for (int c = tid; c < N; c += NTHREADS) {
    const size_t g = (size_t)ly[c / G::EX] * f.nx + lx[c % G::EX];
    h[c] = h_in[g];
    u[c] = u_in[g];
    v[c] = v_in[g];
    dh[c] = dh_in[g];
    du[c] = du_in[g];
    dv[c] = dv_in[g];
  }
  __syncthreads();

  bool first = first_step != 0;
  for (int step = 0; step < NSTEPS; ++step) {
    // -- phase 1: fluxes, then tendencies and the time step -------------
    sw::phase1_fluxes<true>(t, f, k, h, u, v, fe, fn, q, ke);
    __syncthreads();
    // u, v, dh, du, dv are read only at the cell itself here, so they are
    // updated in place; h is read at neighbours, so h1 goes to the spare
    // array, which then becomes h.
    for (int c = tid; c < N; c += NTHREADS) {
      const int y = c / G::EX, x = c % G::EX;
      float out[6];
      sw::phase1_update<true>(t, f, k, first, h, u, v, fe, fn, q, ke, y, x,
                              dh[c], du[c], dv[c], out);
      spare[c] = out[0];
      u[c] = out[1];
      v[c] = out[2];
      dh[c] = out[3];
      du[c] = out[4];
      dv[c] = out[5];
    }
    __syncthreads();
    {
      float* s = h;
      h = spare;
      spare = s;
    }

    // -- the wall conditions of the mid-step exchange -------------------
    for (int c = tid; c < N; c += NTHREADS) {
      const int gy = ly[c / G::EX] + f.oy, gx = lx[c % G::EX] + f.ox;
      if (f.walls && gx == f.GX - 2) u[c] = 0.0f;
      if (gy == f.GY - 2) v[c] = 0.0f;
    }
    __syncthreads();

    // -- phase 2: lateral viscosity on u and v --------------------------
    if (has_visc) {
      sw::phase2_fluxes<true>(t, f, k, u, fe, fn);
      sw::phase2_fluxes<true>(t, f, k, v, q, ke);
      __syncthreads();
      for (int c = tid; c < N; c += NTHREADS) {
        const int y = c / G::EX, x = c % G::EX;
        const float u1 = sw::phase2_update<true>(t, f, k, u, fe, fn, y, x);
        const float v1 = sw::phase2_update<true>(t, f, k, v, q, ke, y, x);
        u[c] = u1;  // each cell writes only itself, and the fluxes are
        v[c] = v1;  // read from fe fn q ke: safe in place
      }
      __syncthreads();
    }
    first = false;
  }

  for (int c = tid; c < TY * TX; c += NTHREADS) {
    const int ty = c / TX, tx = c % TX;
    const int oy = blockIdx.y * TY + ty, ox = blockIdx.x * TX + tx;
    if (oy >= f.ny || ox >= f.nx) continue;
    const int l = (ty + G::MY) * G::EX + tx + G::MX;
    const size_t g = (size_t)oy * f.nx + ox;
    h_out[g] = h[l];
    u_out[g] = u[l];
    v_out[g] = v[l];
    dh_out[g] = dh[l];
    du_out[g] = du[l];
    dv_out[g] = dv[l];
  }
}

template <int NSTEPS>
cudaError_t launch(const float* const* in, float* const* out,
                   const sw::Frame& f, const sw::Consts& k, int first,
                   int has_visc, cudaStream_t stream) {
  constexpr size_t smem = Geom<NSTEPS>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_wide_kernel<NSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((f.nx + TX - 1) / TX, (f.ny + TY - 1) / TY);
  sw_wide_kernel<NSTEPS><<<grid, NTHREADS, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5],
      out[0], out[1], out[2], out[3], out[4], out[5], f, k, first, has_visc);
  return cudaGetLastError();
}

}  // namespace

// NSTEPS wide-frame steps on `stream`; returns the launch's cudaError_t
// (0 on success).
extern "C" int sw_wide_launch(
    const float* h, const float* u, const float* v, const float* dh,
    const float* du, const float* dv, float* oh, float* ou, float* ov,
    float* odh, float* odu, float* odv, int ny, int nx, int oy, int ox,
    int GY, int GX, int walls, int first, int nsteps, int has_visc, float dx,
    float dy, float g, float dt, float ab_a, float ab_b, float f0, float beta,
    float visc, void* stream) {
  const float* in[6] = {h, u, v, dh, du, dv};
  float* out[6] = {oh, ou, ov, odh, odu, odv};
  const sw::Frame f{ny, nx, oy, ox, GY, GX, walls};
  const sw::Consts k{dx, dy, g, dt, ab_a, ab_b, f0, beta, visc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nsteps) {
    case 1: return (int)launch<1>(in, out, f, k, first, has_visc, s);
    case 2: return (int)launch<2>(in, out, f, k, first, has_visc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
