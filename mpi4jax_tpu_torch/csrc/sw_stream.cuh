// Streamed shallow-water physics for Hopper (sm_90a), shared by the
// fused-step kernel (sw_steps.cu, the single-rank periodic frame), the
// wide-halo kernel (sw_wide.cu, a rank's widened frame) and the split-phase
// kernels (sw_phase.cu, a rank's local array).
//
// One step is _step_window (periodic frame) or _wide_step_window (wide
// frame) of mpi4jax_tpu_torch/kernels/sw_steps.py and sw_wide.py: phase 1
// (hc, fluxes fe fn, potential vorticity q, kinetic energy ke, tendencies,
// the AB-2 or Euler update), the post-integration conditions, phase 2
// (lateral viscosity), and in the periodic frame the column fix (col 0 <-
// col nx-2, col nx-1 <- col 1) after phase 1 and at the end of the step.
// The local frame runs one phase per launch (sw_phase.cu's own block loops
// over the stage physics below): _phase1_window or _phase2_window over a
// rank's local array, no conditions and no fix.
// Each expression keeps the plain version's operand order and every
// division gives the true quotient (those by dx and dy from a reciprocal
// held once, corrected by the exact residual, where the host has checked
// that this gives the true quotient: Divisor); the kernels are built with
// -fmad=false, so they round as PyTorch's elementwise ops do.
// Every wall or kept test is a select, never a product with a 0/1 mask.
//
// The three frames (Frame) differ only in their masks and where a stage
// reads: the periodic frame fixes its seam columns, the wide frame tests
// domain-global indices by inequalities (its margins reach beyond the
// walls), the local frame tests the walls by equality and its update mask
// on local indices (the halo ring is left to the next exchange).
//
// Geometry.  A block of NT threads owns a strip of output columns and a
// chunk of output rows.  Thread t owns column t of the strip's extended
// width of NT columns: the output columns plus a margin on each side.  It
// walks the chunk's rows grown by MY = RY NSTEPS rows on each side, one row
// per iteration.  Rows and columns are addressed periodically in the
// array, which is what torch.roll over the whole array reads.  The margins
// are the measured dependency radius times NSTEPS (SW_RY, SW_RX, SW_EDGE_RX,
// passed as -D flags by the Python modules; tests/test_torch_sw_kernel.py,
// test_torch_sw_wide.py and test_torch_sw_phase.py measure them by NaN
// injection):
// - rows: 2 per step in the periodic and wide frames (the wall rows reach
//   no farther, so no chunk needs a wider margin), 1 for one phase;
// - columns: as many, but in the periodic frame the first and last strips
//   (the ones holding the seam columns 0 and nx-1, whose fix reads the far
//   end of the array) take 6 per step.  All strips have the same extended
//   width, so an edge strip keeps fewer output columns.
// The cells within a margin of the extended region's border compute from
// padding and ring rows not yet written: garbage that no output cell
// reads, from rings zeroed when the block starts.
//
// The pipeline.  Each step is four stages, each a row behind the last:
//   S1 (row r): fe, fn, q, ke from the state rows r-1..r+1;
//   S2 (r - 2): tendencies and the update from the S1 rows r-3..r-1;
//   S3 (r - 4): the viscous fluxes of u1, v1 from the S2 rows;
//   S4 (r - 5): u2, v2 from the S3 rows: the next step's state.
// Stage lags (LAG_S1, STEP_LAG) are chosen so that at iteration i every
// stage reads only rows that an earlier iteration wrote, and each ring is
// deep enough that the row written at iteration i lands in a slot no stage
// reads at iteration i.  So one __syncthreads per iteration orders every
// shared-memory read after its write, and no two stages touch one slot
// between two barriers, whatever order the warps run in.
//
// Shared memory holds only what is read at a neighbour: rings of a few
// rows per field (Group), each row NT columns padded by PAD on each side,
// so neighbour reads need no clamping (the farthest is a fixed column's
// neighbour, three columns out).  What a cell reads only at itself
// stays in registers of the thread that owns it, carried by delay lines
// from the stage that computes it to the stage that reads it: u, v (S1 to
// S2), h1 (S2 to S4), u1, v1 (S3 to S4), the tendencies (S2 of one step to
// S2 of the next, STEP_LAG iterations), the old tendencies (loaded one
// iteration ahead).  The masks come from per-column flags computed once
// and per-row flags computed per stage; threads map to columns directly,
// so no cell does a division or modulo of its index.
//
// Copies: the input state rows (h, u, v) go to their ring by 4-byte
// cp.async one row ahead: the local array's row pitch (3602 x 4 bytes) is
// not a multiple of 16, and each thread copies its own column.
//
// Lanes.  One launch may run LANES independent states (a vmapped call):
// blockIdx.z is the lane, and a block offsets every field pointer by its
// lane times the lane's plane stride (lane_of) before anything else.  The
// grid of each lane is the one-lane grid, so a lane's blocks compute what
// its own one-lane launch computes, bit for bit; nothing is shared between
// lanes (each block has its own rings and divisors).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>

#if !defined(SW_NT) || !defined(SW_RY) || !defined(SW_RX) || !defined(SW_EDGE_RX)
#error "build through mpi4jax_tpu_torch/kernels/sw_steps.py, sw_wide.py or sw_phase.py (geometry flags)"
#endif

namespace sws {

// the strip width and the margins per step come from the Python modules,
// which measure the radii (INTERIOR_RADIUS, STEP_RADIUS)
constexpr int NT = SW_NT;          // threads of a block = extended strip width
constexpr int RY = SW_RY;          // rows of dependency per step
constexpr int RX = SW_RX;          // columns of dependency per step, inner strips
constexpr int EDGE_RX = SW_EDGE_RX;  // ... in the first and last strips
constexpr int PAD = 3;             // ring columns beyond each side of a strip
constexpr int PITCH = NT + 2 * PAD;
constexpr int LAG_S1 = 2;          // S1 of step 0 trails the loaded rows
constexpr int STEP_LAG = 7;        // S1 of step s+1 trails S1 of step s

__host__ __device__ constexpr int lag1(int s) { return LAG_S1 + STEP_LAG * s; }
// the output of the last step trails its S4 (lag1 + 5) by one
__host__ __device__ constexpr int out_lag(int nsteps) { return lag1(nsteps - 1) + 6; }

struct Consts {
  float dx, dy, g, dt, ab_a, ab_b, f0, beta, visc;
};

struct Args {
  const float* in[6];  // h u v dh du dv
  float* out[6];
  int ny, nx;          // the array
  int oy, ox;          // domain-global row, col of its element (0, 0)
  int GY, GX;          // domain extent with its 1-cell border
  int walls;           // x walled (wide frame only)
  int y0, rows;        // output rows [y0, y0 + rows)
  int x0, cols;        // output columns [x0, x0 + cols)
  int rows_per_block;  // output rows of a chunk (set by grid())
  int nstrips;         // (set by grid())
  int first, has_visc;
  Consts k;
  int exact_dx, exact_dy;  // a / dx, a / dy exact by reciprocal (set by launch())
  int lanes;               // states of one launch, one a blockIdx.z
  long long lane_stride;   // elements from one lane's field to the next's
};

// a's fields at the lane of this block (blockIdx.z); unset fields stay null
__device__ __forceinline__ Args lane_of(const Args& a) {
  Args l = a;
  const long long off = (long long)blockIdx.z * a.lane_stride;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    l.in[f] = a.in[f] == nullptr ? nullptr : a.in[f] + off;
    l.out[f] = a.out[f] == nullptr ? nullptr : a.out[f] + off;
  }
  return l;
}

__host__ __device__ inline int pmod(int a, int n) { return ((a % n) + n) % n; }

// ---------------------------------------------------------------------------
// the strips: one per blockIdx.x, the first and last with the edge margin
// ---------------------------------------------------------------------------

struct Strip {
  int ox, w, m;  // first output column, output columns, margin
};

__host__ __device__ inline int strip_count(int cols, int te, int ti) {
  if (cols <= te) return 1;
  if (cols <= 2 * te) return 2;
  return 2 + (cols - 2 * te + ti - 1) / ti;
}

__host__ __device__ inline Strip strip_at(int s, int n, int x0, int cols, int me, int mi) {
  const int te = NT - 2 * me, ti = NT - 2 * mi;
  if (n == 1) return {x0, cols, me};
  if (s == 0) return {x0, te, me};
  if (s == n - 1) {
    const int ox = x0 + cols - te > x0 + te ? x0 + cols - te : x0 + te;
    return {ox, x0 + cols - ox, me};
  }
  const int ox = x0 + te + (s - 1) * ti, rest = x0 + cols - te - ox;
  return {ox, rest < ti ? rest : ti, mi};
}

// the block (bx, by): output rows [oy, oy + h) and columns [ox, ox + w),
// walked with my rows and computed with mx columns of margin on each side
struct Span {
  int oy, h, ox, w, my, mx;
};

__host__ __device__ inline Span span_of(const Args& a, int nsteps, int bx, int by) {
  const Strip st = strip_at(bx, a.nstrips, a.x0, a.cols, EDGE_RX * nsteps, RX * nsteps);
  const int oy = a.y0 + by * a.rows_per_block, rest = a.y0 + a.rows - oy;
  return {oy, rest < a.rows_per_block ? rest : a.rows_per_block, st.ox, st.w, RY * nsteps,
          st.m};
}

// ---------------------------------------------------------------------------
// the per-cell physics, operand for operand the plain version's
// ---------------------------------------------------------------------------

struct Derived {
  float fe, fn, q, ke;
};

// A divisor the same for every cell (dx, dy) and its reciprocal, rounded
// to nearest once, so that a division need not compute it again; the
// reciprocal is used for numerators within [lo, hi] only.
struct Divisor {
  float b, r, lo, hi;
};

// exact: the host has checked that the reciprocal gives RN(a / b) for
// every numerator a with |a| in [2^-100, 2^100] (reciprocal_is_exact)
__device__ __forceinline__ Divisor divisor(float b, bool exact) {
  return {b, __frcp_rn(b), exact ? 0x1p-100f : __uint_as_float(0x7f800000u),
          exact ? 0x1p100f : 0.0f};
}

// a / d.b, the true division, bit for bit: with r = RN(1/b), the quotient
// q = RN(a r) corrected by its exact residual, RN(q + r (a - b q)), for
// numerators within [d.lo, d.hi]; a zero numerator gives the zero of the
// quotient's sign; every other numerator goes to the division routine
__device__ __forceinline__ float operator/(float a, const Divisor& d) {
  const float m = fabsf(a);
  if (m >= d.lo && m <= d.hi) {
    const float q = __fmaf_rn(a, d.r, 0.0f);
    return __fmaf_rn(d.r, __fmaf_rn(-d.b, q, a), q);
  }
  return a == 0.0f ? a * d.r : a / d.b;
}

struct Divisors {
  Divisor dx, dy;
};

// A Divisor whose numerators outside [lo, hi], zeros apart, divide in
// double: the quotient rounded to double and then to float is RN(a / b),
// subnormal quotients included, since 53 >= 2 * 24 + 2 bits make the
// double rounding innocuous (Figueroa).  So no numerator takes the f32
// division routine's slow path, as tiny ones (the initial jet's
// exponential tails, subnormal in f32) otherwise do.  The quotient of the
// held reciprocal is computed whatever the numerator and kept by a select
// (RN(a r) alone for a zero numerator: the quotient's zero); only the
// numerators outside the range and not zero branch.  The intrinsics keep
// the compiler from folding the double division back into an f32 one.
struct TailDivisor {
  Divisor d;
};

__device__ __forceinline__ float operator/(float a, const TailDivisor& t) {
  const Divisor& d = t.d;
  const float q = __fmul_rn(a, d.r);
  const float c = __fmaf_rn(d.r, __fmaf_rn(-d.b, q, a), q);
  const float m = fabsf(a);
  const bool held = m >= d.lo && m <= d.hi;
  if (held || m == 0.0f) return held ? c : q;
  return __double2float_rn(__ddiv_rn((double)a, (double)d.b));
}

struct TailDivisors {
  TailDivisor dx, dy;
};

// phase 1's fluxes, potential vorticity and kinetic energy at one cell:
// hc at the cell and its east, north and north-east neighbours; u at the
// cell, north and west; v at the cell, east and south
template <class Div>
__device__ __forceinline__ Derived fluxes(const Consts& k, const Div& d, bool kept,
                                          bool u_wall,
                                          bool wall_v, int gy, float hc0, float hcE,
                                          float hcN, float hcNE, float u, float uN,
                                          float uW, float v, float vE, float vS) {
  Derived f;
  f.fe = (kept || u_wall) ? 0.0f : 0.5f * (hc0 + hcE) * u;
  f.fn = (kept || wall_v) ? 0.0f : 0.5f * (hc0 + hcN) * v;
  // a branch, not a select, around each masked division: beyond a wide
  // frame's walls the depths are zero and a division there would take the
  // slow path of the division routine for a value no cell keeps
  f.q = 0.0f;
  if (!kept) {
    const float cor = k.f0 + (float)(gy - 1) * k.dy * k.beta;
    const float rel_vort = (vE - v) / d.dx - (uN - u) / d.dy;
    const float depth_q = 0.25f * (hc0 + hcE + hcN + hcNE);
    f.q = (cor + rel_vort) / depth_q;
  }
  const float u_sq = u * u, uw_sq = uW * uW;
  const float v_sq = v * v, vs_sq = vS * vS;
  f.ke = kept ? 0.0f : 0.5f * (0.5f * (u_sq + uw_sq) + 0.5f * (v_sq + vs_sq));
  return f;
}

// phase 1's tendencies at one cell, zero outside the update mask
template <class Div>
__device__ __forceinline__ void tendencies(const Consts& k, const Div& d, bool interior,
                                           float fe,
                                           float feW, float feN, float feNW, float fn,
                                           float fnE, float fnS, float fnSE, float q,
                                           float qS, float qW, float ke, float keE,
                                           float keN, float h, float hE, float hN,
                                           float& dh, float& du, float& dv) {
  dh = 0.0f;
  du = 0.0f;
  dv = 0.0f;
  if (interior) {
    dh = -(fe - feW) / d.dx - (fn - fnS) / d.dy;
    const float fn_e = 0.5f * (fn + fnE);
    const float fn_e_s = 0.5f * (fnS + fnSE);
    du = -k.g * (hE - h) / d.dx + 0.5f * (q * fn_e + qS * fn_e_s) - (keE - ke) / d.dx;
    const float fe_n = 0.5f * (fe + feN);
    const float fe_n_w = 0.5f * (feW + feNW);
    dv = -k.g * (hN - h) / d.dy - 0.5f * (q * fe_n + qW * fe_n_w) - (keN - ke) / d.dy;
  }
}

// the AB-2 (or, on the first step, Euler) update of one field at one cell
__device__ __forceinline__ float advance(const Consts& k, bool first, float a, float da_new,
                                         float da_old) {
  return first ? a + k.dt * da_new : a + k.dt * (k.ab_a * da_new + k.ab_b * da_old);
}

// phase 2's viscous fluxes of one field a at one cell (a east and north)
template <class Div>
__device__ __forceinline__ void visc_fluxes(const Consts& k, const Div& d, bool kept,
                                            bool u_wall,
                                            bool wall_v, float a, float aE, float aN,
                                            float& gx, float& gy) {
  gx = 0.0f;
  gy = 0.0f;
  if (!(kept || u_wall)) gx = k.visc * (aE - a) / d.dx;
  if (!(kept || wall_v)) gy = k.visc * (aN - a) / d.dy;
}

// phase 2's update: a plus the divergence of its fluxes inside the update
// mask, a plus 0 elsewhere
template <class Div>
__device__ __forceinline__ float viscous(const Consts& k, const Div& d, bool interior,
                                         float a, float gx,
                                         float gxW, float gy, float gyS) {
  float da = 0.0f;
  if (interior) da = k.dt * ((gx - gxW) / d.dx + (gy - gyS) / d.dy);
  return a + da;
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// rings
// ---------------------------------------------------------------------------

// D rows of F fields; field f of array row r at slot r mod D.  Reads reach
// one row before the first (r = -1), never more.
template <int F, int D>
struct Group {
  float* p;
  static constexpr int FLOATS = F * D * PITCH;
  __device__ __forceinline__ float* at(int r, int f) const {
    return p + (((r + D) % D) * F + f) * PITCH + PAD;
  }
};

// the input state of step s: h u v.  Step 0's rows are copied one row
// ahead of the S1 reads, so its ring holds one row more.
template <int S>
using StateRing = Group<3, S == 0 ? 6 : 5>;
using DerivedRing = Group<4, 4>;  // fe fn q ke
using MidRing = Group<2, 3>;      // u1 v1
using ViscRing = Group<4, 3>;     // gx gy of u, of v
using OutRing = Group<3, 2>;      // h u v after the last step

template <int NS>
struct Layout {
  __host__ __device__ static constexpr int step_floats(int s) {
    return (s == 0 ? StateRing<0>::FLOATS : StateRing<1>::FLOATS) + DerivedRing::FLOATS +
           MidRing::FLOATS + ViscRing::FLOATS;
  }
  __host__ __device__ static constexpr int step_at(int s) {
    return s == 0 ? 0 : step_at(s - 1) + step_floats(s - 1);
  }
  __host__ __device__ static constexpr int out_at() { return step_at(NS); }
  static constexpr size_t BYTES = sizeof(float) * (size_t)(step_at(NS) + OutRing::FLOATS);
};

template <int NS, int S>
struct StepRings {
  StateRing<S> st;
  DerivedRing dv;
  MidRing mid;
  ViscRing vs;
  __device__ __forceinline__ explicit StepRings(float* sm) {
    float* p = sm + Layout<NS>::step_at(S);
    st.p = p;
    dv.p = p + StateRing<S>::FLOATS;
    mid.p = dv.p + DerivedRing::FLOATS;
    vs.p = mid.p + MidRing::FLOATS;
  }
};

// ---------------------------------------------------------------------------
// the frame: masks and where a stage reads
// ---------------------------------------------------------------------------

enum Frame {
  PERIODIC,  // one rank, periodic in x: the column fix (sw_steps)
  WIDE,      // a rank's widened frame: global masks by inequalities (sw_wide)
  LOCAL,     // a rank's local array: _window_masks' default frame (sw_phase)
};

// per-row flags of array row ly, at the domain-global row gy (the periodic
// and wide frames share their tests: in the periodic one gy runs over
// 0..GY-1 only; the local frame's kept rows are tested by equality and its
// update mask on the local row)
struct Row {
  int gy;
  bool kept, interior, wall_v;
};

template <Frame F>
__device__ __forceinline__ Row row_flags(const Args& a, int ly) {
  Row w;
  w.gy = ly + a.oy;
  if (F == LOCAL) {
    w.kept = w.gy == 0 || w.gy == a.GY - 1;
    w.interior = ly >= 1 && ly <= a.ny - 2;
  } else {
    w.kept = w.gy <= 0 || w.gy >= a.GY - 1;
    w.interior = w.gy >= 1 && w.gy <= a.GY - 2;
  }
  w.wall_v = w.gy == a.GY - 2;
  return w;
}

// per-thread column data: the ring columns a stage reads (the periodic
// frame's fixed columns read the ones they copy) and the column flags
// (tested as the row flags are)
struct Cols {
  int lx;                      // array column
  int sW, sC, sE;              // state of steps >= 1 at t-1, t, t+1
  int hC, hE;                  // hc of steps >= 1 at t, t+1
  int hC0, hE0;                // hc of step 0
  bool u_wall, u_wallE;        // the u wall column (x walled) at t, t+1
  bool kept, interior;
};

template <Frame F>
__device__ __forceinline__ Cols col_flags(const Args& a, int ex0, int t) {
  Cols c;
  c.lx = pmod(ex0 + t, a.nx);
  const int lxW = pmod(ex0 + t - 1, a.nx), lxE = pmod(ex0 + t + 1, a.nx);
  if (F == PERIODIC) {
    // the periodic column fix: col 0 holds col nx-2, col nx-1 holds col 1,
    // which in periodic addressing lie two columns away
    auto fix = [&](int col, int l) { return l == 0 ? col - 2 : (l == a.nx - 1 ? col + 2 : col); };
    c.sW = fix(t - 1, lxW);
    c.sC = fix(t, c.lx);
    c.sE = fix(t + 1, lxE);
    c.hC = c.sC;
    c.hE = c.sE;
    c.hC0 = t;
    c.hE0 = t + 1;
    c.u_wall = c.u_wallE = false;
    c.kept = false;
    c.interior = c.lx > 0 && c.lx < a.nx - 1;
  } else {
    const int gx = c.lx + a.ox, gxE = lxE + a.ox;
    const bool w = a.walls != 0;
    c.sW = t - 1;
    c.sC = t;
    c.sE = t + 1;
    // hc's pad columns at the x walls; at gxE == 0 the cell is kept (in
    // the local frame, a halo column whose east wraps to column 0: no
    // output cell reads its fe or q) and its hcE unused
    c.hC = c.hC0 = w && gx == 0 ? t + 1 : (w && gx == a.GX - 1 ? t - 1 : t);
    c.hE = c.hE0 = w && gxE == a.GX - 1 ? t : t + 1;
    c.u_wall = w && gx == a.GX - 2;
    c.u_wallE = w && gxE == a.GX - 2;
    if (F == LOCAL) {
      c.kept = w && (gx == 0 || gx == a.GX - 1);
      c.interior = c.lx >= 1 && c.lx <= a.nx - 2;
    } else {
      c.kept = w && (gx <= 0 || gx >= a.GX - 1);
      c.interior = !w || (gx >= 1 && gx <= a.GX - 2);
    }
  }
  return c;
}

// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

template <Frame F, int NS>
struct Block {
  const Args a;
  const Consts k;
  const Divisors dd;  // dx and dy with their reciprocals
  float* sm;
  int t, ex0, ey0, ly0, nrows, my0, my1;  // output rows [my0, my1) of the walk
  bool out_col;
  Cols c;

  // registers carried between stages (delay lines, newest first)
  float uv_d[NS][2][2];                      // S1 -> S2: u, v at the cell
  float h1_d[NS][3];                         // S2 -> S4: h1
  float u1_d[NS][2];                         // S3 -> S4: u1, v1 at the cell
  float td_d[NS > 1 ? NS - 1 : 1][3][STEP_LAG];  // S2 -> next step's S2
  float pre[3];                              // step 0's old tendencies

  // array row of walk row r (r >= -1): one subtraction where the walk
  // wraps, more only on arrays shorter than the walk
  __device__ __forceinline__ int ly_of(int r) const {
    int l = ly0 + r;
    while (l >= a.ny) l -= a.ny;
    return l < 0 ? l + a.ny : l;
  }

  template <int S>
  __device__ __forceinline__ void s1(int r) {
    StepRings<NS, S> R(sm);
    float pu = 0.0f, pv = 0.0f;
    if (r >= 0 && r < nrows) {
      const Row r0 = row_flags<F>(a, ly_of(r)), r1 = row_flags<F>(a, ly_of(r + 1));
      const int sW = S == 0 ? t - 1 : c.sW, sC = S == 0 ? t : c.sC, sE = S == 0 ? t + 1 : c.sE;
      const int hC = S == 0 ? c.hC0 : c.hC, hE = S == 0 ? c.hE0 : c.hE;
      // hc's pad rows at the y walls; where row r+1 is row 0, row r is
      // kept and hcN unused
      const int rs0 = r0.gy == 0 ? r + 1 : (r0.gy == a.GY - 1 ? r - 1 : r);
      const int rsN = r1.gy == a.GY - 1 ? r : r + 1;
      const float* h0 = R.st.at(rs0, 0);
      const float* hN = R.st.at(rsN, 0);
      const float* u = R.st.at(r, 1);
      const float* v = R.st.at(r, 2);
      pu = u[sC];
      pv = v[sC];
      const Derived d = fluxes(k, dd, r0.kept || c.kept, c.u_wall, r0.wall_v, r0.gy, h0[hC], h0[hE],
                               hN[hC], hN[hE], pu, R.st.at(r + 1, 1)[sC], u[sW], pv, v[sE],
                               R.st.at(r - 1, 2)[sC]);
      R.dv.at(r, 0)[t] = d.fe;
      R.dv.at(r, 1)[t] = d.fn;
      R.dv.at(r, 2)[t] = d.q;
      R.dv.at(r, 3)[t] = d.ke;
    }
    uv_d[S][1][0] = uv_d[S][0][0];
    uv_d[S][1][1] = uv_d[S][0][1];
    uv_d[S][0][0] = pu;
    uv_d[S][0][1] = pv;
  }

  template <int S>
  __device__ __forceinline__ void s2(int r) {
    StepRings<NS, S> R(sm);
    float h1 = 0.0f, nd[3] = {0.0f, 0.0f, 0.0f};
    if (r >= 0 && r < nrows) {
      const int ly = ly_of(r);
      const Row r0 = row_flags<F>(a, ly);
      const int sC = S == 0 ? t : c.sC, sE = S == 0 ? t + 1 : c.sE;
      const float* fe = R.dv.at(r, 0);
      const float* feN = R.dv.at(r + 1, 0);
      const float* fn = R.dv.at(r, 1);
      const float* fnS = R.dv.at(r - 1, 1);
      const float* q = R.dv.at(r, 2);
      const float* ke = R.dv.at(r, 3);
      const float* h = R.st.at(r, 0);
      tendencies(k, dd, r0.interior && c.interior, fe[t], fe[t - 1], feN[t], feN[t - 1], fn[t],
                 fn[t + 1], fnS[t], fnS[t + 1], q[t], R.dv.at(r - 1, 2)[t], q[t - 1], ke[t],
                 ke[t + 1], R.dv.at(r + 1, 3)[t], h[sC], h[sE], R.st.at(r + 1, 0)[sC], nd[0],
                 nd[1], nd[2]);
      const bool first = S == 0 && a.first != 0;
      float old[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) old[f] = S == 0 ? pre[f] : td_d[S > 0 ? S - 1 : 0][f][STEP_LAG - 1];
      h1 = advance(k, first, h[sC], nd[0], old[0]);
      R.mid.at(r, 0)[t] = advance(k, first, uv_d[S][1][0], nd[1], old[1]);
      R.mid.at(r, 1)[t] = advance(k, first, uv_d[S][1][1], nd[2], old[2]);
      if (S == NS - 1 && r >= my0 && r < my1 && out_col) {
        const size_t g = (size_t)ly * a.nx + c.lx;
#pragma unroll
        for (int f = 0; f < 3; ++f) a.out[3 + f][g] = nd[f];
      }
    }
    h1_d[S][2] = h1_d[S][1];
    h1_d[S][1] = h1_d[S][0];
    h1_d[S][0] = h1;
    if (S < NS - 1) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {
#pragma unroll
        for (int j = STEP_LAG - 1; j > 0; --j) td_d[S][f][j] = td_d[S][f][j - 1];
        td_d[S][f][0] = nd[f];
      }
    }
  }

  template <int S>
  __device__ __forceinline__ void s3(int r) {
    StepRings<NS, S> R(sm);
    float pu = 0.0f, pv = 0.0f;
    if (r >= 0 && r < nrows) {
      const Row r0 = row_flags<F>(a, ly_of(r)), r1 = row_flags<F>(a, ly_of(r + 1));
      // u1 and v1 as phase 2 sees them: the wall conditions (wide frame)
      // or the column fix (periodic frame), and v's wall row
      const float* u1 = R.mid.at(r, 0);
      const float* v1 = R.mid.at(r, 1);
      pu = c.u_wall ? 0.0f : u1[c.sC];
      pv = r0.wall_v ? 0.0f : v1[c.sC];
      if (a.has_visc) {
        const float uE = c.u_wallE ? 0.0f : u1[c.sE];
        const float uN = c.u_wall ? 0.0f : R.mid.at(r + 1, 0)[c.sC];
        const float vE = r0.wall_v ? 0.0f : v1[c.sE];
        const float vN = r1.wall_v ? 0.0f : R.mid.at(r + 1, 1)[c.sC];
        const bool kept = r0.kept || c.kept;
        float gx, gy;
        visc_fluxes(k, dd, kept, c.u_wall, r0.wall_v, pu, uE, uN, gx, gy);
        R.vs.at(r, 0)[t] = gx;
        R.vs.at(r, 1)[t] = gy;
        visc_fluxes(k, dd, kept, c.u_wall, r0.wall_v, pv, vE, vN, gx, gy);
        R.vs.at(r, 2)[t] = gx;
        R.vs.at(r, 3)[t] = gy;
      }
    }
    u1_d[S][0] = pu;
    u1_d[S][1] = pv;
  }

  // S4 writes the next step's state ring, or after the last step the
  // output ring
  template <int S>
  __device__ __forceinline__ float* next_state(int r, int f) const {
    if (S == NS - 1) {
      OutRing o{sm + Layout<NS>::out_at()};
      return o.at(r, f);
    }
    StateRing<1> st{sm + Layout<NS>::step_at(S + 1 < NS ? S + 1 : S)};
    return st.at(r, f);
  }

  template <int S>
  __device__ __forceinline__ void s4(int r) {
    StepRings<NS, S> R(sm);
    if (r >= 0 && r < nrows) {
      float u2 = u1_d[S][0], v2 = u1_d[S][1];
      if (a.has_visc) {
        const bool interior = row_flags<F>(a, ly_of(r)).interior && c.interior;
        const float* gu = R.vs.at(r, 0);
        const float* gv = R.vs.at(r, 2);
        u2 = viscous(k, dd, interior, u2, gu[t], gu[t - 1], R.vs.at(r, 1)[t],
                     R.vs.at(r - 1, 1)[t]);
        v2 = viscous(k, dd, interior, v2, gv[t], gv[t - 1], R.vs.at(r, 3)[t],
                     R.vs.at(r - 1, 3)[t]);
      }
      next_state<S>(r, 0)[t] = h1_d[S][2];
      next_state<S>(r, 1)[t] = u2;
      next_state<S>(r, 2)[t] = v2;
    }
  }

  // h, u, v after the last step (the periodic frame's end-of-step fix
  // read where it points)
  __device__ __forceinline__ void output(int r) {
    if (r >= my0 && r < my1 && out_col) {
      OutRing o{sm + Layout<NS>::out_at()};
      const size_t g = (size_t)ly_of(r) * a.nx + c.lx;
#pragma unroll
      for (int f = 0; f < 3; ++f) a.out[f][g] = o.at(r, f)[c.sC];
    }
  }

  // the next input row of step 0, in flight during one iteration
  __device__ __forceinline__ void load_row(int r) {
    if (r < nrows) {
      StateRing<0> st{sm};
      const size_t g = (size_t)ly_of(r) * a.nx + c.lx;
#pragma unroll
      for (int f = 0; f < 3; ++f) cp_async4(st.at(r, f) + t, a.in[f] + g, true);
    }
    cp_commit();
  }

  // step 0's old tendencies at the cell of its S2 in the next iteration
  __device__ __forceinline__ void load_old(int r) {
    if (!a.first && r >= 0 && r < nrows) {
      const size_t g = (size_t)ly_of(r) * a.nx + c.lx;
#pragma unroll
      for (int f = 0; f < 3; ++f) pre[f] = a.in[3 + f][g];
    }
  }

  template <int S>
  __device__ __forceinline__ void stages(int i) {
    // later stages first: each reads its delay line before the stage that
    // feeds it pushes this iteration's value
    s4<S>(i - lag1(S) - 5);
    s3<S>(i - lag1(S) - 4);
    s2<S>(i - lag1(S) - 2);
    s1<S>(i - lag1(S));
  }

  __device__ __forceinline__ Block(const Args& args, float* smem)
      : a(lane_of(args)), k(args.k), dd{divisor(args.k.dx, args.exact_dx != 0),
                               divisor(args.k.dy, args.exact_dy != 0)},
        sm(smem), t(threadIdx.x) {
    const Span s = span_of(a, NS, blockIdx.x, blockIdx.y);
    ex0 = s.ox - s.mx;
    out_col = t >= s.mx && t < s.mx + s.w;
    ey0 = s.oy - s.my;
    ly0 = pmod(ey0, a.ny);
    my0 = s.my;
    my1 = my0 + s.h;
    nrows = s.h + 2 * s.my;
    c = col_flags<F>(a, ex0, t);
#pragma unroll
    for (int f = 0; f < 3; ++f) pre[f] = 0.0f;
  }

  __device__ __forceinline__ void run() {
    // zero the rings first: the margin cells read the pad columns, which
    // nothing writes, and the first rows before the walk has written them;
    // left as another kernel left them, such a value (tiny, NaN) sends the
    // margin cells' divisions down the division routine's slow path, and
    // the one barrier a row makes every warp wait for theirs
    for (int i = t; i < (int)(Layout<NS>::BYTES / sizeof(float)); i += NT) sm[i] = 0.0f;
    __syncthreads();
    load_row(0);
    cp_wait<0>();
    __syncthreads();
    const int nit = nrows + out_lag(NS);
    for (int i = 0; i < nit; ++i) {
      load_row(i + 1);
      if constexpr (NS > 2) stages<2>(i);
      if constexpr (NS > 1) stages<1>(i);
      stages<0>(i);
      output(i - out_lag(NS));
      load_old(i + 1 - lag1(0) - 2);
      cp_wait<1>();
      __syncthreads();
    }
  }
};

template <Frame F, int NS>
__device__ __forceinline__ void stream_block(const Args& a, float* smem) {
  Block<F, NS> b(a, smem);
  b.run();
}

// ---------------------------------------------------------------------------
// host side: the divisors' check, the grid, and the chunk height that
// fills the card once
// ---------------------------------------------------------------------------

// Whether RN(q + r (a - b q)) with q = RN(a r), r = RN(1/b), is RN(a / b)
// for every numerator a with |a| in [2^-100, 2^100], given |b| in
// [2^-20, 2^20] (false outside).  There no step leaves the normal range
// and the residual is exact, so every step scales exactly with a power of
// two in a, and the signs are symmetric: the 2^23 significands of [1, 2)
// decide it.  Markstein's theorem does not cover every b, since RN(a r)
// can be more than an ulp from a / b.  Each divisor is swept once (about
// 80 ms on one host core) and its answer kept.
inline bool reciprocal_is_exact(float b) {
  static std::mutex mu;
  static std::map<float, bool> checked;
  const float mb = std::fabs(b);
  if (!(mb >= 0x1p-20f && mb <= 0x1p20f)) return false;
  std::lock_guard<std::mutex> lock(mu);
  auto it = checked.find(b);
  if (it != checked.end()) return it->second;
  const float r = 1.0f / b;
  bool exact = true;
  for (uint32_t m = 0; exact && m < (1u << 23); ++m) {
    const uint32_t bits = 0x3f800000u | m;
    float a;
    std::memcpy(&a, &bits, sizeof a);
    const float q = a * r;
    exact = std::fma(r, std::fma(-b, q, a), q) == a / b;
  }
  checked.emplace(b, exact);
  return exact;
}

// blocks of KERNEL resident per SM with smem bytes of dynamic shared
// memory, and the SMs of the current device: asked of the runtime once a
// device (the shared-memory limit set with it), kept for every later launch
struct Residency {
  int per_sm, sms;
};

template <void (*KERNEL)(Args)>
cudaError_t residency(size_t smem, Residency& out) {
  static std::mutex mu;
  static std::map<int, Residency> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  auto it = seen.find(dev);
  if (it == seen.end()) {
    Residency r{0, 0};
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.per_sm, KERNEL, NT, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    it = seen.emplace(dev, r).first;
  }
  out = it->second;
  return cudaSuccess;
}

// Sets a.nstrips and a.rows_per_block: as many chunks as fill every SM's
// resident blocks once, each at least min_rows tall.  out (may be null):
// strips, chunks, output rows per chunk, blocks resident per SM, threads
// per block, shared-memory bytes per block, rows walked in all.  blocks
// (may be null): span_of's six ints for every block, strip by strip within
// each chunk.
inline cudaError_t grid(Args& a, int nsteps, int min_rows, Residency res, size_t smem,
                        int* out, int* blocks) {
  const int me = EDGE_RX * nsteps, mi = RX * nsteps;
  if (NT <= 2 * me || a.rows < 1 || a.cols < 1 || a.lanes < 1 || a.lanes > 65535)
    return cudaErrorInvalidValue;
  a.nstrips = strip_count(a.cols, NT - 2 * me, NT - 2 * mi);
  int chunks = res.per_sm * res.sms / a.nstrips;
  chunks = chunks < 1 ? 1 : chunks;
  int rpb = (a.rows + chunks - 1) / chunks;
  rpb = rpb < min_rows ? min_rows : rpb;
  a.rows_per_block = rpb;
  chunks = (a.rows + rpb - 1) / rpb;
  if (out != nullptr) {
    const int geo[7] = {a.nstrips, chunks, rpb, res.per_sm, NT, (int)smem,
                        a.rows + chunks * 2 * RY * nsteps};
    std::memcpy(out, geo, sizeof geo);
  }
  for (int by = 0; blocks != nullptr && by < chunks; ++by)
    for (int bx = 0; bx < a.nstrips; ++bx, blocks += 6) {
      const Span sp = span_of(a, nsteps, bx, by);
      const int v[6] = {sp.oy, sp.h, sp.ox, sp.w, sp.my, sp.mx};
      std::memcpy(blocks, v, sizeof v);
    }
  return cudaSuccess;
}

// The launch of KERNEL with smem bytes of shared memory a block, the
// margins of nsteps steps and chunks of at least min_rows rows, or with
// out or blocks given the geometry alone (grid()'s)
template <void (*KERNEL)(Args)>
cudaError_t launch_with(Args a, int nsteps, int min_rows, size_t smem, int* out,
                        int* blocks, cudaStream_t stream) {
  Residency res;
  cudaError_t e = residency<KERNEL>(smem, res);
  if (e != cudaSuccess) return e;
  e = grid(a, nsteps, min_rows, res, smem, out, blocks);
  if (e != cudaSuccess || out != nullptr || blocks != nullptr) return e;
  a.exact_dx = reciprocal_is_exact(a.k.dx);
  a.exact_dy = reciprocal_is_exact(a.k.dy);
  const dim3 g(a.nstrips, (a.rows + a.rows_per_block - 1) / a.rows_per_block, a.lanes);
  KERNEL<<<g, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// ... of a whole-step kernel of NS steps (stream_block's shared memory;
// chunks at least twice as tall as their two margins)
template <void (*KERNEL)(Args), int NS>
cudaError_t launch(Args a, int* out, int* blocks, cudaStream_t stream) {
  return launch_with<KERNEL>(a, NS, 4 * RY * NS, Layout<NS>::BYTES, out, blocks, stream);
}

}  // namespace sws
