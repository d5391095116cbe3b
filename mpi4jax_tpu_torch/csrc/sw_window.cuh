// The shallow-water phase windows on a shared-memory tile, for the
// split-phase kernel (sw_phase.cu) and the wide-halo kernel (sw_wide.cu).
//
// Device counterparts of _phase1_window and _phase2_window in
// mpi4jax_tpu_torch/kernels/sw_steps.py, in both mask frames of its
// _window_masks: the default frame (a rank's local array; the update mask
// tests local indices) and the wide frame (the widened arrays of the
// wide-halo path; every mask tests domain-global indices, and the kept
// masks use inequalities).  Each expression keeps the plain version's
// operand order; the kernels are built with -fmad=false, so they round as
// PyTorch's elementwise ops do.
//
// A tile is EY x EX cells of an array of ny x nx, gathered with periodic
// addressing: tile row y holds array row ly[y] (= (y0 + y) mod ny), which
// is what torch.roll over the whole array reads.  A neighbour read clamps
// to the tile, so the cells within a dependency radius of the tile's edge
// hold garbage that the caller's output tile never reads.  Every wall or
// kept test is a select, never a product with a 0/1 mask: the beyond-wall
// rows of a widened frame hold zero depths, where q and the flux averages
// are inf or NaN, and 0 * NaN is NaN.

#pragma once

#include <cuda_runtime.h>

namespace sw {

// The array a kernel walks and where it sits in the domain.
struct Frame {
  int ny, nx;  // array rows, cols (a rank's local array, or a widened frame)
  int oy, ox;  // domain-global row, col of the array's element (0, 0)
  int GY, GX;  // domain-global extent with its 1-cell border (cfg.ny + 2, cfg.nx + 2)
  int walls;   // 1 when x is walled (cfg.periodic_x false)
};

struct Consts {
  float dx, dy, g, dt, ab_a, ab_b, f0, beta, visc;
};

struct Masks {
  bool kept, interior, u_wall, wall_v;
};

// _window_masks at array cell (ly, lx); signed global indices, since a
// widened frame starts before the domain's first row and column.
template <bool WIDE>
__device__ __forceinline__ Masks masks(const Frame& f, int ly, int lx) {
  const int gy = ly + f.oy, gx = lx + f.ox;
  Masks m;
  m.wall_v = gy == f.GY - 2;
  m.u_wall = f.walls && gx == f.GX - 2;
  if (WIDE) {
    m.kept = gy <= 0 || gy >= f.GY - 1 ||
             (f.walls && (gx <= 0 || gx >= f.GX - 1));
    m.interior = gy >= 1 && gy <= f.GY - 2 &&
                 (!f.walls || (gx >= 1 && gx <= f.GX - 2));
  } else {
    m.kept = gy == 0 || gy == f.GY - 1 ||
             (f.walls && (gx == 0 || gx == f.GX - 1));
    m.interior = ly > 0 && ly < f.ny - 1 && lx > 0 && lx < f.nx - 1;
  }
  return m;
}

__device__ __forceinline__ int pmod(int a, int n) { return ((a % n) + n) % n; }

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// A tile of EY x EX cells and the array index of each of its rows, cols.
struct Tile {
  int EY, EX;
  const int* ly;
  const int* lx;

  __device__ __forceinline__ int at(int y, int x) const {
    return clampi(y, EY - 1) * EX + clampi(x, EX - 1);
  }
};

// hc: the depth with edge-replicated pad rows at the y walls ...
__device__ __forceinline__ float hc_y(const Tile& t, const Frame& f,
                                      const float* h, int y, int x) {
  y = clampi(y, t.EY - 1);
  x = clampi(x, t.EX - 1);
  const int gy = t.ly[y] + f.oy;
  if (gy == 0) return h[t.at(y + 1, x)];
  if (gy == f.GY - 1) return h[t.at(y - 1, x)];
  return h[y * t.EX + x];
}

// ... and, where x is walled, pad columns of that at the x walls.
__device__ __forceinline__ float hc(const Tile& t, const Frame& f,
                                    const float* h, int y, int x) {
  y = clampi(y, t.EY - 1);
  x = clampi(x, t.EX - 1);
  if (f.walls) {
    const int gx = t.lx[x] + f.ox;
    if (gx == 0) return hc_y(t, f, h, y, x + 1);
    if (gx == f.GX - 1) return hc_y(t, f, h, y, x - 1);
  }
  return hc_y(t, f, h, y, x);
}

// Phase 1a over every tile cell: fluxes fe, fn, potential vorticity q and
// kinetic energy ke from h, u, v.
template <bool WIDE>
__device__ void phase1_fluxes(const Tile& t, const Frame& f, const Consts& k,
                              const float* h, const float* u, const float* v,
                              float* fe, float* fn, float* q, float* ke) {
  const int n = t.EY * t.EX;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int y = c / t.EX, x = c % t.EX;
    const int ly = t.ly[y], lx = t.lx[x];
    const Masks m = masks<WIDE>(f, ly, lx);
    const float hc0 = hc(t, f, h, y, x), hcE = hc(t, f, h, y, x + 1);
    const float hcN = hc(t, f, h, y + 1, x), hcNE = hc(t, f, h, y + 1, x + 1);
    fe[c] = (m.kept || m.u_wall) ? 0.0f : 0.5f * (hc0 + hcE) * u[c];
    fn[c] = (m.kept || m.wall_v) ? 0.0f : 0.5f * (hc0 + hcN) * v[c];
    const float cor = k.f0 + (float)(ly + f.oy - 1) * k.dy * k.beta;
    const float rel_vort =
        (v[t.at(y, x + 1)] - v[c]) / k.dx - (u[t.at(y + 1, x)] - u[c]) / k.dy;
    const float depth_q = 0.25f * (hc0 + hcE + hcN + hcNE);
    q[c] = m.kept ? 0.0f : (cor + rel_vort) / depth_q;
    const float uc = u[c], uw = u[t.at(y, x - 1)];
    const float vc = v[c], vs = v[t.at(y - 1, x)];
    const float u_sq = uc * uc, uw_sq = uw * uw;
    const float v_sq = vc * vc, vs_sq = vs * vs;
    ke[c] = m.kept ? 0.0f
                   : 0.5f * (0.5f * (u_sq + uw_sq) + 0.5f * (v_sq + vs_sq));
  }
}

// Phase 1b at tile cell (y, x): tendencies from the fluxes, then the AB-2
// (or, on the first step, Euler) update.  ``dh``, ``du``, ``dv`` are the
// old tendencies at the cell; out = h1, u1, v1, dh_new, du_new, dv_new.
template <bool WIDE>
__device__ __forceinline__ void phase1_update(
    const Tile& t, const Frame& f, const Consts& k, bool first,
    const float* h, const float* u, const float* v, const float* fe,
    const float* fn, const float* q, const float* ke, int y, int x,
    float dh, float du, float dv, float* out) {
  const int c = y * t.EX + x;
  const Masks m = masks<WIDE>(f, t.ly[y], t.lx[x]);
  float dh_new = 0.0f, du_new = 0.0f, dv_new = 0.0f;
  if (m.interior) {
    dh_new = -(fe[c] - fe[t.at(y, x - 1)]) / k.dx -
             (fn[c] - fn[t.at(y - 1, x)]) / k.dy;
    const float fn_e = 0.5f * (fn[c] + fn[t.at(y, x + 1)]);
    const float fn_e_s = 0.5f * (fn[t.at(y - 1, x)] + fn[t.at(y - 1, x + 1)]);
    du_new = -k.g * (h[t.at(y, x + 1)] - h[c]) / k.dx +
             0.5f * (q[c] * fn_e + q[t.at(y - 1, x)] * fn_e_s) -
             (ke[t.at(y, x + 1)] - ke[c]) / k.dx;
    const float fe_n = 0.5f * (fe[c] + fe[t.at(y + 1, x)]);
    const float fe_n_w = 0.5f * (fe[t.at(y, x - 1)] + fe[t.at(y + 1, x - 1)]);
    dv_new = -k.g * (h[t.at(y + 1, x)] - h[c]) / k.dy -
             0.5f * (q[c] * fe_n + q[t.at(y, x - 1)] * fe_n_w) -
             (ke[t.at(y + 1, x)] - ke[c]) / k.dy;
  }
  if (first) {
    out[0] = h[c] + k.dt * dh_new;
    out[1] = u[c] + k.dt * du_new;
    out[2] = v[c] + k.dt * dv_new;
  } else {
    out[0] = h[c] + k.dt * (k.ab_a * dh_new + k.ab_b * dh);
    out[1] = u[c] + k.dt * (k.ab_a * du_new + k.ab_b * du);
    out[2] = v[c] + k.dt * (k.ab_a * dv_new + k.ab_b * dv);
  }
  out[3] = dh_new;
  out[4] = du_new;
  out[5] = dv_new;
}

// Phase 2a over every tile cell: the viscous fluxes of one field a.
template <bool WIDE>
__device__ void phase2_fluxes(const Tile& t, const Frame& f, const Consts& k,
                              const float* a, float* gx, float* gy) {
  const int n = t.EY * t.EX;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int y = c / t.EX, x = c % t.EX;
    const Masks m = masks<WIDE>(f, t.ly[y], t.lx[x]);
    gx[c] = (m.kept || m.u_wall) ? 0.0f
                                 : k.visc * (a[t.at(y, x + 1)] - a[c]) / k.dx;
    gy[c] = (m.kept || m.wall_v) ? 0.0f
                                 : k.visc * (a[t.at(y + 1, x)] - a[c]) / k.dy;
  }
}

// Phase 2b at tile cell (y, x): a plus the divergence of its viscous
// fluxes inside the update mask, a plus 0 elsewhere.
template <bool WIDE>
__device__ __forceinline__ float phase2_update(const Tile& t, const Frame& f,
                                               const Consts& k, const float* a,
                                               const float* gx, const float* gy,
                                               int y, int x) {
  const int c = y * t.EX + x;
  const Masks m = masks<WIDE>(f, t.ly[y], t.lx[x]);
  const float da = m.interior
      ? k.dt * ((gx[c] - gx[t.at(y, x - 1)]) / k.dx +
                (gy[c] - gy[t.at(y - 1, x)]) / k.dy)
      : 0.0f;
  return a[c] + da;
}

}  // namespace sw
