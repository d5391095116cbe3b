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
// two ints, so one build serves every rank.
//
// Only the crop region [m-1, m-1+ny_l) x [m-1, m-1+nx_l) is computed and
// written; there every cell equals the plain version's (the frame addressed
// periodically, as torch.roll over the whole frame does).  The other output
// cells are not written: the caller overwrites every one of them
// (_wide_refresh, _wide_crop in models/shallow_water.py) before any read.
//
// Bound: bytes.  An AB-2 call must read h, u, v on the crop grown by
// NSTEPS x the step radius, the tendencies on the crop grown by
// (NSTEPS - 1) x it, and write six fields on the crop (312.3 MB for a pair
// on the 1802 x 3602 crop of 3600 x 1800, 0.0932 ms at 3.35 TB/s); ~107 f32
// operations per cell and step need far less.
//
// Design: the streamed rows of sw_stream.cuh in the wide frame: 256-column
// strips and chunks of rows over the crop, each with margins of 2 cells a
// step (no seams here), the chunk height set on the host so that the grid
// fills the card's resident blocks once.

#include "sw_stream.cuh"

namespace {

template <int NS>
__global__ void __launch_bounds__(sws::NT, NS == 1 ? 3 : 2) sw_wide_kernel(sws::Args a) {
  extern __shared__ float4 smem4[];
  sws::stream_block<sws::WIDE, NS>(a, reinterpret_cast<float*>(smem4));
}

cudaError_t dispatch(const sws::Args& a, int nsteps, int* geo, int* blocks,
                     cudaStream_t stream) {
  switch (nsteps) {
    case 1: return sws::launch<sw_wide_kernel<1>, 1>(a, geo, blocks, stream);
    case 2: return sws::launch<sw_wide_kernel<2>, 2>(a, geo, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

sws::Args args(int ny, int nx, int oy, int ox, int GY, int GX, int walls, int cy, int cx,
               int crop_ny, int crop_nx) {
  sws::Args a{};
  a.lanes = 1;
  a.ny = ny;
  a.nx = nx;
  a.oy = oy;
  a.ox = ox;
  a.GY = GY;
  a.GX = GX;
  a.walls = walls;
  a.y0 = cy;
  a.rows = crop_ny;
  a.x0 = cx;
  a.cols = crop_nx;
  return a;
}

}  // namespace

// NSTEPS wide-frame steps on `stream`, computed on the crop whose first
// row and column are (cy, cx) and whose extent is crop_ny x crop_nx, in
// chunks of rows that fill the card's resident blocks once, on `lanes`
// frames whose fields lie `lane_stride` elements apart.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int sw_wide_launch(
    const float* h, const float* u, const float* v, const float* dh,
    const float* du, const float* dv, float* oh, float* ou, float* ov,
    float* odh, float* odu, float* odv, int ny, int nx, int oy, int ox,
    int GY, int GX, int walls, int cy, int cx, int crop_ny, int crop_nx, int first,
    int nsteps, int has_visc, float dx, float dy, float g, float dt,
    float ab_a, float ab_b, float f0, float beta, float visc, int lanes,
    long long lane_stride, void* stream) {
  sws::Args a = args(ny, nx, oy, ox, GY, GX, walls, cy, cx, crop_ny, crop_nx);
  a.lanes = lanes;
  a.lane_stride = lane_stride;
  const float* in[6] = {h, u, v, dh, du, dv};
  float* out[6] = {oh, ou, ov, odh, odu, odv};
  for (int f = 0; f < 6; ++f) {
    a.in[f] = in[f];
    a.out[f] = out[f];
  }
  a.first = first;
  a.has_visc = has_visc;
  a.k = sws::Consts{dx, dy, g, dt, ab_a, ab_b, f0, beta, visc};
  return (int)dispatch(a, nsteps, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// The launch's geometry, without launching (out and blocks as
// sw_steps_geometry's).
extern "C" int sw_wide_geometry(int ny, int nx, int cy, int cx, int crop_ny, int crop_nx,
                                int nsteps, int* out, int* blocks) {
  return (int)dispatch(args(ny, nx, 0, 0, 0, 0, 0, cy, cx, crop_ny, crop_nx), nsteps, out,
                       blocks, nullptr);
}
