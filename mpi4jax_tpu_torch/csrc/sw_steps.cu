// Fused whole-step shallow-water kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel examples/shallow_water.py:_sw_steps_kernel: NSTEPS
// in {1, 2, 3} whole Sadourny/AB-2 model steps (the first one Euler when
// asked) on the single-rank periodic-x local state, six f32 (ny, nx) fields
// in and six out.  Every output cell equals what the plain version in
// mpi4jax_tpu_torch/kernels/sw_steps.py gives: NSTEPS applications of
// _step_window to the whole array with torch.roll.
//
// Bound: bytes.  A call must read the six fields once and write them once,
// 12 fields x 4 bytes per cell (311.6 MB at 3600x1800, 0.093 ms at
// 3.35 TB/s); the ~107 f32 operations per cell and step need far less.
//
// Design (simple first, not yet fast):
// - Each block owns a TY x TX output tile.  It loads the six fields for the
//   tile plus a margin of MY = SW_RY*NSTEPS rows and MX = SW_RX*NSTEPS
//   columns on every side into shared memory, with periodic addressing in both
//   dimensions (index mod ny, mod nx): exactly what torch.roll over the
//   whole array reads.  Under it the periodic column fix (col 0 <- col
//   nx-2, col nx-1 <- col 1) is a local read two columns away.
// - The per-step dependency radius is SW_RY = 3 rows and SW_RX = 6 columns
//   (STEP_RADIUS in the Python module, which passes it and the tile shape
//   as -D flags), so after NSTEPS steps the centre tile is exact and the
//   margins hold garbage that no centre cell reads.  Neighbour
//   reads clamp to the tile, so the garbage stays in bounds.
// - Every mask tests the wrapped (global) index of the cell it computes, as
//   the plain version does; on one rank global and local indices coincide.
// - All intermediates (hc, fe, fn, q, ke, tendencies, viscous fluxes) and,
//   for NSTEPS > 1, the intermediate state stay in shared memory: device
//   memory sees one read of the tile with its margins and one write.
// - Each expression keeps the plain version's operand order, and the build
//   uses -fmad=false, so the kernel rounds as PyTorch's elementwise ops do.

#include <cuda_runtime.h>

namespace {

#if !defined(SW_TY) || !defined(SW_TX) || !defined(SW_RY) || !defined(SW_RX)
#error "build through mpi4jax_tpu_torch/kernels/sw_steps.py:build (tile flags)"
#endif

constexpr int TY = SW_TY;
constexpr int TX = SW_TX;
constexpr int NTHREADS = 256;
constexpr int NARR = 11;  // h u v dh du dv, fe fn q ke, and one spare

struct Params {
  int ny, nx, first, has_visc;
  float dx, dy, g, dt, ab_a, ab_b, f0, beta, visc;
};

template <int NSTEPS>
struct Tile {
  static constexpr int MY = SW_RY * NSTEPS;
  static constexpr int MX = SW_RX * NSTEPS;
  static constexpr int EY = TY + 2 * MY;
  static constexpr int EX = TX + 2 * MX;
  static constexpr int N = EY * EX;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)NARR * N + sizeof(int) * (size_t)(EY + EX);
};

__device__ __forceinline__ int pmod(int a, int n) { return ((a % n) + n) % n; }

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <int NSTEPS>
__global__ void __launch_bounds__(NTHREADS)
sw_steps_kernel(const float* __restrict__ h_in, const float* __restrict__ u_in,
                const float* __restrict__ v_in, const float* __restrict__ dh_in,
                const float* __restrict__ du_in, const float* __restrict__ dv_in,
                float* __restrict__ h_out, float* __restrict__ u_out,
                float* __restrict__ v_out, float* __restrict__ dh_out,
                float* __restrict__ du_out, float* __restrict__ dv_out,
                Params p) {
  using T = Tile<NSTEPS>;
  constexpr int EY = T::EY, EX = T::EX, N = T::N;
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
  int* gyi = reinterpret_cast<int*>(smem + NARR * N);
  int* gxi = gyi + EY;

  const int ny = p.ny, nx = p.nx;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TY - T::MY;
  const int x0 = blockIdx.x * TX - T::MX;

  for (int i = tid; i < EY; i += NTHREADS) gyi[i] = pmod(y0 + i, ny);
  for (int i = tid; i < EX; i += NTHREADS) gxi[i] = pmod(x0 + i, nx);
  __syncthreads();

  for (int c = tid; c < N; c += NTHREADS) {
    const size_t g = (size_t)gyi[c / EX] * nx + gxi[c % EX];
    h[c] = h_in[g];
    u[c] = u_in[g];
    v[c] = v_in[g];
    dh[c] = dh_in[g];
    du[c] = du_in[g];
    dv[c] = dv_in[g];
  }
  __syncthreads();

  // a[y, x] with the coordinates clamped to the tile
#define AT(a, y, x) (a)[clampi((y), EY - 1) * EX + clampi((x), EX - 1)]

  const float dx = p.dx, dy = p.dy, dt = p.dt;
  const float neg_g = -p.g;
  bool first = p.first != 0;

  for (int step = 0; step < NSTEPS; ++step) {
    // hc: edge-replicated pad rows at the walls, else h
    auto HC = [&](int y, int x) -> float {
      y = clampi(y, EY - 1);
      x = clampi(x, EX - 1);
      const int gy = gyi[y];
      if (gy == 0) return AT(h, y + 1, x);
      if (gy == ny - 1) return AT(h, y - 1, x);
      return h[y * EX + x];
    };

    // -- phase 1a: fluxes, potential vorticity, kinetic energy ------------
    for (int c = tid; c < N; c += NTHREADS) {
      const int y = c / EX, x = c % EX;
      const int gy = gyi[y];
      const bool kept = (gy == 0) || (gy == ny - 1);
      const float hc0 = HC(y, x), hcE = HC(y, x + 1);
      const float hcN = HC(y + 1, x), hcNE = HC(y + 1, x + 1);
      fe[c] = kept ? 0.0f : 0.5f * (hc0 + hcE) * u[c];
      fn[c] = (kept || gy == ny - 2) ? 0.0f : 0.5f * (hc0 + hcN) * v[c];
      const float cor = p.f0 + (float)(gy - 1) * dy * p.beta;
      const float rel_vort =
          (AT(v, y, x + 1) - v[c]) / dx - (AT(u, y + 1, x) - u[c]) / dy;
      const float depth_q = 0.25f * (hc0 + hcE + hcN + hcNE);
      q[c] = kept ? 0.0f : (cor + rel_vort) / depth_q;
      const float uc = u[c], uw = AT(u, y, x - 1);
      const float vc = v[c], vs = AT(v, y - 1, x);
      const float u_sq = uc * uc, uw_sq = uw * uw;
      const float v_sq = vc * vc, vs_sq = vs * vs;
      ke[c] = kept ? 0.0f
                   : 0.5f * (0.5f * (u_sq + uw_sq) + 0.5f * (v_sq + vs_sq));
    }
    __syncthreads();

    // -- phase 1b: tendencies and the time step ---------------------------
    // u, v, dh, du, dv are read only at the cell itself here, so they are
    // updated in place; h is read at neighbours, so h1 goes to the spare
    // array, which then becomes h.
    for (int c = tid; c < N; c += NTHREADS) {
      const int y = c / EX, x = c % EX;
      const int gy = gyi[y], gx = gxi[x];
      const bool interior = gy > 0 && gy < ny - 1 && gx > 0 && gx < nx - 1;
      float dh_new = 0.0f, du_new = 0.0f, dv_new = 0.0f;
      if (interior) {
        dh_new = -(fe[c] - AT(fe, y, x - 1)) / dx - (fn[c] - AT(fn, y - 1, x)) / dy;
        const float fn_e = 0.5f * (fn[c] + AT(fn, y, x + 1));
        const float fn_e_s = 0.5f * (AT(fn, y - 1, x) + AT(fn, y - 1, x + 1));
        du_new = neg_g * (AT(h, y, x + 1) - h[c]) / dx +
                 0.5f * (q[c] * fn_e + AT(q, y - 1, x) * fn_e_s) -
                 (AT(ke, y, x + 1) - ke[c]) / dx;
        const float fe_n = 0.5f * (fe[c] + AT(fe, y + 1, x));
        const float fe_n_w = 0.5f * (AT(fe, y, x - 1) + AT(fe, y + 1, x - 1));
        dv_new = neg_g * (AT(h, y + 1, x) - h[c]) / dy -
                 0.5f * (q[c] * fe_n + AT(q, y, x - 1) * fe_n_w) -
                 (AT(ke, y + 1, x) - ke[c]) / dy;
      }
      if (first) {
        spare[c] = h[c] + dt * dh_new;
        u[c] = u[c] + dt * du_new;
        v[c] = v[c] + dt * dv_new;
      } else {
        spare[c] = h[c] + dt * (p.ab_a * dh_new + p.ab_b * dh[c]);
        u[c] = u[c] + dt * (p.ab_a * du_new + p.ab_b * du[c]);
        v[c] = v[c] + dt * (p.ab_a * dv_new + p.ab_b * dv[c]);
      }
      dh[c] = dh_new;
      du[c] = du_new;
      dv[c] = dv_new;
    }
    __syncthreads();
    {
      float* t = h;
      h = spare;
      spare = t;
    }

    // -- mid-step refresh: periodic column fix on u, v; v's wall row ------
    // A fixed cell (col 0 or nx-1) reads col nx-2 or 1, which no fix
    // writes; the wall row is zero whatever it reads.
    for (int c = tid; c < N; c += NTHREADS) {
      const int y = c / EX, x = c % EX;
      const int gx = gxi[x];
      if (gx == 0) {
        u[c] = AT(u, y, x - 2);
        v[c] = AT(v, y, x - 2);
      } else if (gx == nx - 1) {
        u[c] = AT(u, y, x + 2);
        v[c] = AT(v, y, x + 2);
      }
      if (gyi[y] == ny - 2) v[c] = 0.0f;
    }
    __syncthreads();

    // -- phase 2: lateral viscosity on u and v ----------------------------
    if (p.has_visc) {
      float* gxu = fe;
      float* gyu = fn;
      float* gxv = q;
      float* gyv = ke;
      for (int c = tid; c < N; c += NTHREADS) {
        const int y = c / EX, x = c % EX;
        const int gy = gyi[y];
        const bool kept = (gy == 0) || (gy == ny - 1);
        const bool kept_v = kept || gy == ny - 2;
        gxu[c] = kept ? 0.0f : p.visc * (AT(u, y, x + 1) - u[c]) / dx;
        gyu[c] = kept_v ? 0.0f : p.visc * (AT(u, y + 1, x) - u[c]) / dy;
        gxv[c] = kept ? 0.0f : p.visc * (AT(v, y, x + 1) - v[c]) / dx;
        gyv[c] = kept_v ? 0.0f : p.visc * (AT(v, y + 1, x) - v[c]) / dy;
      }
      __syncthreads();
      for (int c = tid; c < N; c += NTHREADS) {
        const int y = c / EX, x = c % EX;
        const int gy = gyi[y], gx = gxi[x];
        const bool interior = gy > 0 && gy < ny - 1 && gx > 0 && gx < nx - 1;
        const float au = interior
            ? dt * ((gxu[c] - AT(gxu, y, x - 1)) / dx +
                    (gyu[c] - AT(gyu, y - 1, x)) / dy)
            : 0.0f;
        const float av = interior
            ? dt * ((gxv[c] - AT(gxv, y, x - 1)) / dx +
                    (gyv[c] - AT(gyv, y - 1, x)) / dy)
            : 0.0f;
        u[c] = u[c] + au;
        v[c] = v[c] + av;
      }
      __syncthreads();
    }

    // -- end-of-step refresh: periodic column fix on h, u, v --------------
    for (int c = tid; c < N; c += NTHREADS) {
      const int y = c / EX, x = c % EX;
      const int gx = gxi[x];
      if (gx == 0) {
        h[c] = AT(h, y, x - 2);
        u[c] = AT(u, y, x - 2);
        v[c] = AT(v, y, x - 2);
      } else if (gx == nx - 1) {
        h[c] = AT(h, y, x + 2);
        u[c] = AT(u, y, x + 2);
        v[c] = AT(v, y, x + 2);
      }
    }
    __syncthreads();
    first = false;
  }
#undef AT

  for (int c = tid; c < TY * TX; c += NTHREADS) {
    const int ty = c / TX, tx = c % TX;
    const int oy = blockIdx.y * TY + ty, ox = blockIdx.x * TX + tx;
    if (oy >= ny || ox >= nx) continue;
    const int l = (ty + T::MY) * EX + tx + T::MX;
    const size_t g = (size_t)oy * nx + ox;
    h_out[g] = h[l];
    u_out[g] = u[l];
    v_out[g] = v[l];
    dh_out[g] = dh[l];
    du_out[g] = du[l];
    dv_out[g] = dv[l];
  }
}

template <int NSTEPS>
cudaError_t launch(const float* const* in, float* const* out, const Params& p,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<NSTEPS>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_steps_kernel<NSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((p.nx + TX - 1) / TX, (p.ny + TY - 1) / TY);
  sw_steps_kernel<NSTEPS><<<grid, NTHREADS, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5],
      out[0], out[1], out[2], out[3], out[4], out[5], p);
  return cudaGetLastError();
}

}  // namespace

// Launch NSTEPS fused steps on `stream`.  Returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
extern "C" int sw_steps_launch(
    const float* h, const float* u, const float* v, const float* dh,
    const float* du, const float* dv, float* oh, float* ou, float* ov,
    float* odh, float* odu, float* odv, int ny, int nx, int first, int nsteps,
    int has_visc, float dx, float dy, float g, float dt, float ab_a,
    float ab_b, float f0, float beta, float visc, void* stream) {
  const float* in[6] = {h, u, v, dh, du, dv};
  float* out[6] = {oh, ou, ov, odh, odu, odv};
  const Params p{ny, nx, first, has_visc, dx, dy, g, dt,
                 ab_a, ab_b, f0, beta, visc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nsteps) {
    case 1: return (int)launch<1>(in, out, p, s);
    case 2: return (int)launch<2>(in, out, p, s);
    case 3: return (int)launch<3>(in, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
