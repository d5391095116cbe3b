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
// Design: the streamed rows of sw_stream.cuh in the periodic frame.  A
// block of 256 threads walks a chunk of rows of a 256-column strip; the
// strips holding the seam columns (0 and nx-1, whose periodic fix reads
// the far end of the array) keep margins of 6 columns a step, every other
// strip 2, and every chunk 2 rows a step.  The chunk height is set on the
// host so that the grid fills the card's resident blocks once.

#include "sw_stream.cuh"

namespace {

template <int NS>
__global__ void __launch_bounds__(sws::NT, NS == 1 ? 3 : (NS == 2 ? 2 : 1))
    sw_steps_kernel(sws::Args a) {
  extern __shared__ float4 smem4[];
  sws::stream_block<sws::PERIODIC, NS>(a, reinterpret_cast<float*>(smem4));
}

cudaError_t dispatch(const sws::Args& a, int nsteps, int* geo, int* blocks,
                     cudaStream_t stream) {
  switch (nsteps) {
    case 1: return sws::launch<sw_steps_kernel<1>, 1>(a, geo, blocks, stream);
    case 2: return sws::launch<sw_steps_kernel<2>, 2>(a, geo, blocks, stream);
    case 3: return sws::launch<sw_steps_kernel<3>, 3>(a, geo, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the whole local array is the output; one rank, so local = global; one
// lane unless the launch says otherwise
sws::Args args(int ny, int nx) {
  sws::Args a{};
  a.lanes = 1;
  a.ny = ny;
  a.nx = nx;
  a.GY = ny;
  a.GX = nx;
  a.rows = ny;
  a.cols = nx;
  return a;
}

}  // namespace

// Launch NSTEPS fused steps on `stream`, in chunks of rows that fill the
// card's resident blocks once, on `lanes` states whose fields lie
// `lane_stride` elements apart (one lane: the fields alone).  Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else.
extern "C" int sw_steps_launch(
    const float* h, const float* u, const float* v, const float* dh,
    const float* du, const float* dv, float* oh, float* ou, float* ov,
    float* odh, float* odu, float* odv, int ny, int nx, int first, int nsteps,
    int has_visc, float dx, float dy, float g, float dt,
    float ab_a, float ab_b, float f0, float beta, float visc, int lanes,
    long long lane_stride, void* stream) {
  sws::Args a = args(ny, nx);
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

// The launch's geometry, without launching: out[0..6] = strips, chunks,
// output rows per chunk, blocks resident per SM, threads per block,
// shared-memory bytes per block, rows walked over all chunks; blocks (may
// be null; 6 ints for each of strips x chunks blocks) each block's output
// rows, columns and margins (oy, h, ox, w, my, mx).
extern "C" int sw_steps_geometry(int ny, int nx, int nsteps, int* out, int* blocks) {
  return (int)dispatch(args(ny, nx), nsteps, out, blocks, nullptr);
}
