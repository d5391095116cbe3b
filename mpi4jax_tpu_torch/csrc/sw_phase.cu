// Split-phase shallow-water kernels for Hopper (sm_90a).
//
// Replace the TPU kernel examples/shallow_water.py:_sw_phase_kernel, which
// model_step_pallas_halo launches twice per step with real halo exchanges
// between the launches:
// - phase 1 (_phase1_window): depth pad hc, fluxes, potential vorticity,
//   kinetic energy, tendencies and the AB-2 or Euler update; six f32
//   (ny, nx) fields in (h u v dh du dv), six out;
// - phase 2 (_phase2_window): lateral viscosity; u and v in and out.
// Both work on one rank's local array in the default mask frame (the local
// frame of sw_stream.cuh).  The rank's domain-global offsets come in as
// two ints, so one build serves every rank.  Every output cell, the halo
// ring included, equals what the plain version (mpi4jax_tpu_torch/kernels/
// sw_phase.py: the window over the whole array with torch.roll) gives, bit
// for bit: rows and columns are addressed periodically, which is what
// torch.roll reads.
//
// Bound: bytes.  The output's halo ring is overwritten or feeds only ring
// cells, so AB-2 phase 1 must read h, u, v whole, the tendencies on the
// interior and write six fields on the interior (311.2 MB at 3602 x 1802,
// 0.0929 ms at 3.35 TB/s); phase 2 reads u, v whole and writes their
// interior (0.0310 ms).  Their 81 and 26 f32 operations per cell need a
// fraction of that.
//
// Design: the streamed rows of sw_stream.cuh, one phase per launch.  A
// block of NT = 256 threads, one a column, walks a chunk of rows of a
// 256-column strip with margins of the phases' radius, one row and one
// column on each side (a strip keeps 254 columns); the chunk height is set
// on the host so that the grid fills the card's resident blocks once, but
// not under MIN_ROWS.
// Each iteration is one row and ends at the one barrier:
// - phase 1: h, u, v of row i + 1 go to their ring by 4-byte cp.async
//   while S1 (fe, fn, q, ke: sw_stream.cuh's fluxes) runs on row i - 2 and
//   S2 (tendencies and the update) on row i - 4, which writes the six
//   outputs; u, v at the cell reach S2 by a register delay line, the old
//   tendencies (AB-2) a ring of their own, copied with the state;
// - phase 2: u, v of row i + 1 go to their ring while S3 (the viscous
//   fluxes) runs on row i - 2 and S4 (the update) on row i - 3; only the x
//   fluxes are read at a neighbour, so only they pass through shared
//   memory, the y fluxes and the field at the cell through registers.
// Divisions by dx and dy go through sw_stream.cuh's TailDivisor (bit for
// bit: the held reciprocal where the host has certified it, its range
// bounds compile-time constants of the kernel's instance, a double
// division for the numerators outside it); q's division by its depth,
// which varies from cell to cell, stays a true division.  Row indices and
// offsets are carried from one iteration to the next.  The rings are
// zeroed when a block starts, so the margin cells never read what another
// kernel left in shared memory.

#include "sw_stream.cuh"

namespace {

using sws::Args;
using sws::NT;

constexpr sws::Frame LOCAL = sws::LOCAL;

// The rings, each a power of two of rows deep (a slot by a mask).  Input
// rows are copied one iteration ahead, so the rows of the last two
// iterations may be in flight.  Phase 1: h u v (S1 reads rows r-1..r+1 at
// lag 2, S2 rows r, r+1 at lag 4: 6 rows), the old tendencies (read at
// S2's row, copied two iterations before: 3 rows) and fe fn q ke (S2
// reads rows r-1..r+1 of S1's, which S1 writes two rows on: 4 rows).
using P1State = sws::Group<3, 8>;
using P1Old = sws::Group<3, 4>;
using P1Derived = sws::Group<4, 4>;
constexpr size_t P1_BYTES =
    sizeof(float) * (P1State::FLOATS + P1Old::FLOATS + P1Derived::FLOATS);
// Phase 2: u v (S3 reads rows r, r+1 at lag 2: 4 rows) and the x fluxes of
// u and v (S4 reads the row S3 wrote one iteration before: 2 rows).
using P2In = sws::Group<2, 4>;
using P2Flux = sws::Group<2, 2>;
constexpr size_t P2_BYTES = sizeof(float) * (P2In::FLOATS + P2Flux::FLOATS);
// output rows of a chunk at least: a block spends 6 (phase 1) or 5 (phase
// 2) of its iterations on its margin rows and on filling and draining its
// pipeline
constexpr int MIN_ROWS = 16;

// The array row of a walk row that advances one row an iteration.
struct RowAt {
  int r, ly;
  __device__ __forceinline__ void next(int ny) {
    ++r;
    ly = ly + 1 == ny ? 0 : ly + 1;
  }
};

// A block's walk over its chunk: the span, the column flags and the rows.
// EXACT: the host has certified the reciprocals of dx and dy, so the
// range of the held reciprocal is a constant of the instance.
template <bool EXACT>
struct Walk {
  const Args a;
  const sws::Consts k;
  const sws::TailDivisors dd;
  float* sm;
  int t, ly0, nrows, my0, my1;  // output rows [my0, my1) of the walk
  bool out_col;
  sws::Cols c;

  __device__ __forceinline__ Walk(const Args& args, float* smem)
      : a(sws::lane_of(args)), k(args.k), dd{{sws::divisor(args.k.dx, EXACT)},
                               {sws::divisor(args.k.dy, EXACT)}},
        sm(smem), t(threadIdx.x) {
    const sws::Span s = sws::span_of(a, 1, blockIdx.x, blockIdx.y);
    const int ex0 = s.ox - s.mx;
    out_col = t >= s.mx && t < s.mx + s.w;
    ly0 = sws::pmod(s.oy - s.my, a.ny);
    my0 = s.my;
    my1 = my0 + s.h;
    nrows = s.h + 2 * s.my;
    c = sws::col_flags<LOCAL>(a, ex0, t);
  }

  // walk row r (any sign) and its array row
  __device__ __forceinline__ RowAt row(int r) const { return {r, sws::pmod(ly0 + r, a.ny)}; }

  __device__ __forceinline__ bool out_row(int r) const { return r >= my0 && r < my1; }

  // the offset of this thread's cell in array row ly (the host checks that
  // an array has fewer than 2^31 cells)
  __device__ __forceinline__ int at(int ly) const { return ly * a.nx + c.lx; }

  // zero the shared memory (the margin cells read the pad columns, which
  // nothing writes, and ring rows before the walk has written them)
  __device__ __forceinline__ void zero(int floats) {
    for (int i = t; i < floats; i += NT) sm[i] = 0.0f;
    __syncthreads();
  }

  // fields [f0, f0 + F) of walk row w into their ring, by 4-byte cp.async
  template <int F, int D>
  __device__ __forceinline__ void load_row(const sws::Group<F, D>& ring, int f0,
                                           const RowAt& w) {
    const int g = at(w.ly);
#pragma unroll
    for (int f = 0; f < F; ++f) sws::cp_async4(ring.at(w.r, f) + t, a.in[f0 + f] + g, true);
  }
};

// Phase 1: S1 and S2 of one step; h1 u1 v1 and the new tendencies out.
template <bool EXACT>
struct Phase1 : Walk<EXACT> {
  using W = Walk<EXACT>;
  using W::a;
  using W::c;
  using W::dd;
  using W::k;
  using W::t;
  P1State st;
  P1Old old;
  P1Derived dv;
  float uv_d[2][2];  // S1 -> S2: u, v at the cell, newest first

  __device__ __forceinline__ Phase1(const Args& args, float* smem) : W(args, smem) {
    st.p = W::sm;
    old.p = st.p + P1State::FLOATS;
    dv.p = old.p + P1Old::FLOATS;
  }

  __device__ __forceinline__ void s1(const RowAt& w) {
    const int r = w.r;
    float pu = 0.0f, pv = 0.0f;
    if (r >= 0 && r < W::nrows) {
      const sws::Row r0 = sws::row_flags<LOCAL>(a, w.ly);
      const sws::Row r1 = sws::row_flags<LOCAL>(a, w.ly + 1 == a.ny ? 0 : w.ly + 1);
      // hc's pad rows at the y walls; where row r+1 is row 0, row r is
      // kept or a halo row whose q no output cell reads
      const int rs0 = r0.gy == 0 ? r + 1 : (r0.gy == a.GY - 1 ? r - 1 : r);
      const int rsN = r1.gy == a.GY - 1 ? r : r + 1;
      const float* h0 = st.at(rs0, 0);
      const float* hN = st.at(rsN, 0);
      const float* u = st.at(r, 1);
      const float* v = st.at(r, 2);
      pu = u[t];
      pv = v[t];
      const sws::Derived d = sws::fluxes(k, dd, r0.kept || c.kept, c.u_wall, r0.wall_v, r0.gy,
                                         h0[c.hC], h0[c.hE], hN[c.hC], hN[c.hE], pu,
                                         st.at(r + 1, 1)[t], u[t - 1], pv, v[t + 1],
                                         st.at(r - 1, 2)[t]);
      dv.at(r, 0)[t] = d.fe;
      dv.at(r, 1)[t] = d.fn;
      dv.at(r, 2)[t] = d.q;
      dv.at(r, 3)[t] = d.ke;
    }
    uv_d[1][0] = uv_d[0][0];
    uv_d[1][1] = uv_d[0][1];
    uv_d[0][0] = pu;
    uv_d[0][1] = pv;
  }

  __device__ __forceinline__ void s2(const RowAt& w) {
    const int r = w.r;
    if (!(W::out_row(r) && W::out_col)) return;
    const sws::Row r0 = sws::row_flags<LOCAL>(a, w.ly);
    const float* fe = dv.at(r, 0);
    const float* feN = dv.at(r + 1, 0);
    const float* fn = dv.at(r, 1);
    const float* fnS = dv.at(r - 1, 1);
    const float* q = dv.at(r, 2);
    const float* ke = dv.at(r, 3);
    const float* h = st.at(r, 0);
    float nd[3];
    sws::tendencies(k, dd, r0.interior && c.interior, fe[t], fe[t - 1], feN[t], feN[t - 1],
                    fn[t], fn[t + 1], fnS[t], fnS[t + 1], q[t], dv.at(r - 1, 2)[t], q[t - 1],
                    ke[t], ke[t + 1], dv.at(r + 1, 3)[t], h[t], h[t + 1], st.at(r + 1, 0)[t],
                    nd[0], nd[1], nd[2]);
    const bool first = a.first != 0;
    const int g = W::at(w.ly);
    a.out[0][g] = sws::advance(k, first, h[t], nd[0], old.at(r, 0)[t]);
    a.out[1][g] = sws::advance(k, first, uv_d[1][0], nd[1], old.at(r, 1)[t]);
    a.out[2][g] = sws::advance(k, first, uv_d[1][1], nd[2], old.at(r, 2)[t]);
#pragma unroll
    for (int f = 0; f < 3; ++f) a.out[3 + f][g] = nd[f];
  }

  __device__ __forceinline__ void run() {
    W::zero((int)(P1_BYTES / sizeof(float)));
    // the copies of an iteration, one commit group: the state of the next
    // row, and the old tendencies at the cell of S2's row two iterations
    // on (AB-2 only)
    RowAt ld = W::row(0), od = W::row(-3);
    auto load = [&]() {
      if (ld.r < W::nrows) W::load_row(st, 0, ld);
      if (!a.first && W::out_row(od.r) && W::out_col) W::load_row(old, 3, od);
      sws::cp_commit();
      ld.next(a.ny);
      od.next(a.ny);
    };
    load();
    // S2 of the last output row, my1 - 1, runs at iteration my1 + 3; at
    // the end of iteration i the copies of iteration i - 1 are complete:
    // state rows to i, old tendencies to S2's row at i + 1
    RowAt w2 = W::row(-4), w1 = W::row(-2);
    for (int i = 0; i < W::my1 + 4; ++i) {
      load();
      s2(w2);  // before S1 pushes this iteration's u, v
      s1(w1);
      w2.next(a.ny);
      w1.next(a.ny);
      sws::cp_wait<1>();
      __syncthreads();
    }
  }
};

// Phase 2: S3 and S4 of one step on u and v.
template <bool EXACT>
struct Phase2 : Walk<EXACT> {
  using W = Walk<EXACT>;
  using W::a;
  using W::c;
  using W::dd;
  using W::k;
  using W::t;
  P2In in;
  P2Flux fx;
  float gy_d[2][2];  // S3 -> S4: gy of u, v at the cell, newest first
  float uv[2];       // S3 -> S4: u, v at the cell

  __device__ __forceinline__ Phase2(const Args& args, float* smem) : W(args, smem) {
    in.p = W::sm;
    fx.p = W::sm + P2In::FLOATS;
  }

  __device__ __forceinline__ void s3(const RowAt& w) {
    const int r = w.r;
    float gy[2] = {0.0f, 0.0f}, pa[2] = {0.0f, 0.0f};
    if (r >= 0 && r < W::nrows - 1) {
      const sws::Row r0 = sws::row_flags<LOCAL>(a, w.ly);
      const bool kept = r0.kept || c.kept;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float* x = in.at(r, f);
        pa[f] = x[t];
        float gx;
        sws::visc_fluxes(k, dd, kept, c.u_wall, r0.wall_v, pa[f], x[t + 1],
                         in.at(r + 1, f)[t], gx, gy[f]);
        fx.at(r, f)[t] = gx;
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      gy_d[1][f] = gy_d[0][f];
      gy_d[0][f] = gy[f];
      uv[f] = pa[f];
    }
  }

  __device__ __forceinline__ void s4(const RowAt& w) {
    const int r = w.r;
    if (!(W::out_row(r) && W::out_col)) return;
    const bool interior = sws::row_flags<LOCAL>(a, w.ly).interior && c.interior;
    const int g = W::at(w.ly);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const float* gx = fx.at(r, f);
      a.out[1 + f][g] = sws::viscous(k, dd, interior, uv[f], gx[t], gx[t - 1], gy_d[0][f],
                                     gy_d[1][f]);
    }
  }

  __device__ __forceinline__ void run() {
    W::zero((int)(P2_BYTES / sizeof(float)));
    // the copies of an iteration, one commit group: u, v of the next row
    RowAt ld = W::row(0);
    auto load = [&]() {
      if (ld.r < W::nrows) W::load_row(in, 1, ld);
      sws::cp_commit();
      ld.next(a.ny);
    };
    load();
    // S4 of the last output row, my1 - 1, runs at iteration my1 + 2; at
    // the end of iteration i the rows to i are complete
    RowAt w4 = W::row(-3), w3 = W::row(-2);
    for (int i = 0; i < W::my1 + 3; ++i) {
      load();
      s4(w4);  // before S3 pushes this iteration's fluxes and fields
      s3(w3);
      w4.next(a.ny);
      w3.next(a.ny);
      sws::cp_wait<1>();
      __syncthreads();
    }
  }
};

template <bool EXACT>
__global__ void __launch_bounds__(NT, 4) sw_phase1_kernel(Args a) {
  extern __shared__ float4 smem4[];
  Phase1<EXACT> b(a, reinterpret_cast<float*>(smem4));
  b.run();
}

template <bool EXACT>
__global__ void __launch_bounds__(NT, 4) sw_phase2_kernel(Args a) {
  extern __shared__ float4 smem4[];
  Phase2<EXACT> b(a, reinterpret_cast<float*>(smem4));
  b.run();
}

// phase 1 or 2 on `stream`, or with geo or blocks given its geometry alone
template <bool EXACT>
cudaError_t dispatch_exact(const Args& a, int phase, int* geo, int* blocks,
                           cudaStream_t stream) {
  switch (phase) {
    case 1:
      return sws::launch_with<sw_phase1_kernel<EXACT>>(a, 1, MIN_ROWS, P1_BYTES, geo, blocks,
                                                       stream);
    case 2:
      return sws::launch_with<sw_phase2_kernel<EXACT>>(a, 1, MIN_ROWS, P2_BYTES, geo, blocks,
                                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Args& a, int phase, int* geo, int* blocks, cudaStream_t stream) {
  if ((long long)a.ny * a.nx >= (1LL << 31)) return cudaErrorInvalidValue;
  const bool exact = geo != nullptr || blocks != nullptr ||
                     (sws::reciprocal_is_exact(a.k.dx) && sws::reciprocal_is_exact(a.k.dy));
  return exact ? dispatch_exact<true>(a, phase, geo, blocks, stream)
               : dispatch_exact<false>(a, phase, geo, blocks, stream);
}

// the whole local array is the output, of one lane unless the launch says
// otherwise
Args args(int ny, int nx, int oy, int ox, int GY, int GX, int walls, float dx, float dy,
          float g, float dt, float ab_a, float ab_b, float f0, float beta, float visc) {
  Args a{};
  a.lanes = 1;
  a.ny = ny;
  a.nx = nx;
  a.oy = oy;
  a.ox = ox;
  a.GY = GY;
  a.GX = GX;
  a.walls = walls;
  a.rows = ny;
  a.cols = nx;
  a.k = sws::Consts{dx, dy, g, dt, ab_a, ab_b, f0, beta, visc};
  return a;
}

}  // namespace

// Phase 1 on `stream`, on `lanes` states whose fields lie `lane_stride`
// elements apart; returns the launch's cudaError_t (0 on success).
extern "C" int sw_phase1_launch(
    const float* h, const float* u, const float* v, const float* dh,
    const float* du, const float* dv, float* oh, float* ou, float* ov,
    float* odh, float* odu, float* odv, int ny, int nx, int oy, int ox,
    int GY, int GX, int walls, int first, float dx, float dy, float g,
    float dt, float ab_a, float ab_b, float f0, float beta, float visc,
    int lanes, long long lane_stride, void* stream) {
  Args a = args(ny, nx, oy, ox, GY, GX, walls, dx, dy, g, dt, ab_a, ab_b, f0, beta, visc);
  a.lanes = lanes;
  a.lane_stride = lane_stride;
  const float* in[6] = {h, u, v, dh, du, dv};
  float* out[6] = {oh, ou, ov, odh, odu, odv};
  for (int f = 0; f < 6; ++f) {
    a.in[f] = in[f];
    a.out[f] = out[f];
  }
  a.first = first;
  return (int)dispatch(a, 1, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// Phase 2 on `stream`, on `lanes` pairs (u, v) whose fields lie
// `lane_stride` elements apart; returns the launch's cudaError_t (0 on
// success).
extern "C" int sw_phase2_launch(
    const float* u, const float* v, float* ou, float* ov, int ny, int nx,
    int oy, int ox, int GY, int GX, int walls, float dx, float dy, float g,
    float dt, float ab_a, float ab_b, float f0, float beta, float visc,
    int lanes, long long lane_stride, void* stream) {
  Args a = args(ny, nx, oy, ox, GY, GX, walls, dx, dy, g, dt, ab_a, ab_b, f0, beta, visc);
  a.lanes = lanes;
  a.lane_stride = lane_stride;
  a.in[1] = u;
  a.in[2] = v;
  a.out[1] = ou;
  a.out[2] = ov;
  return (int)dispatch(a, 2, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// Phase 1's or 2's geometry on a local array of ny x nx, without launching
// (out and blocks as sw_steps_geometry's).
extern "C" int sw_phase_geometry(int ny, int nx, int phase, int* out, int* blocks) {
  return (int)dispatch(args(ny, nx, 0, 0, 0, 0, 0, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                            0.0f, 0.0f),
                       phase, out, blocks, nullptr);
}
