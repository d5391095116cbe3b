// Host emulation of the CUDA pieces the flash and streamed stencil sources
// use, so that their fragment maps, masks, softmax shuffles, rings and
// loop bounds run under a host C++ compiler (tests/test_torch_warp_emulation.py,
// tests/test_torch_sw_emulation.py).  Not used by nvcc.
//
// A launch runs its blocks one after another.  A block's threads are
// coroutines (ucontext) that switch at every barrier and every
// warp-collective instruction: each thread deposits its operands, and
// once all have, each computes its own result from its warp's deposits.
// This needs every thread of a warp to meet the same sequence of
// collectives, and every thread of a block the same barriers, which the
// kernels do; a thread that does not aborts the run.  The deposits
// alternate between two slots, so a thread may deposit for the next
// collective before the others have read the last one.
//
// Two schedules (host_emu_schedule).  Lockstep, the default: every thread
// of the block runs to its next collective in turn, so all warps move
// together and shared memory is read and written in program order.
// Warp-serial: each warp in turn, in ascending or descending order, runs
// alone from one barrier to the next.  One warp then finishes its reads
// and writes of shared memory before another begins, as a warp that runs
// ahead on the card may: a stage refilled before every warp has read it,
// with no barrier between, gives a wrong result under one of the two
// orders.  Neither schedule sees a missing cp.async wait, since cp.async
// lands at once here.
//
// The test replaces the inline-asm helpers with the emu_* functions below:
// mma.sync m16n8k8 TF32 and m16n8k16 bf16 (f32 accumulate, operands as the
// tensor cores read them: TF32 truncated to its 19 bits), ldmatrix x4 and
// its transpose, __shfl_xor_sync, cp.async as a plain copy (zeros where the
// source size is 0).  With HOST_EMU_TRUNCATE each mma's f32 sum is the exact sum
// truncated toward zero, as the tensor cores' accumulation truncates.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>

#include <algorithm>
#include <functional>
#include <vector>

using std::max;
using std::min;

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

constexpr int EMU_SMEM_MAX = 232448;  // dynamic shared memory a block can have on sm_90

template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= EMU_SMEM_MAX ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// an H100's residency: 132 SMs, 2048 threads and 228 KB of shared memory
// each, 1 KB of it reserved per block
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 132;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int threads, size_t smem) {
  *n = std::min<int>(2048 / threads, 233472 / (int)(smem + 1024));
  return cudaSuccess;
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
inline uint3 threadIdx, blockIdx;
inline dim3 gridDim;

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __frcp_rn(float b) { return 1.0f / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __double2float_rn(double x) { return (float)x; }

namespace emu {

struct Slot {
  uint32_t a[4], b[2];
  const void* addr;
};

struct Block {
  int n = 0, cur = 0;
  std::vector<Slot> slots[2];
  std::vector<int> count;
  std::vector<char> done, at_barrier;
  std::vector<ucontext_t> ctx;
  std::vector<std::vector<char>> stacks;
  ucontext_t sched;
  std::function<void()> body;
};
inline Block blk;

inline void yield() { swapcontext(&blk.ctx[blk.cur], &blk.sched); }

// this thread's next collective: the slot set it deposits into
inline std::vector<Slot>& step() { return blk.slots[blk.count[threadIdx.x]++ & 1]; }

inline void trampoline(int i) {
  blk.body();
  blk.done[i] = 1;
}

// 0 lockstep, 1 warp-serial ascending, -1 warp-serial descending
inline int schedule = 0;

inline void abort_if(bool bad, const char* what, int i) {
  if (!bad) return;
  fprintf(stderr, "host emulation: thread %d %s\n", i, what);
  abort();
}

// runs thread i to its next collective, barrier or end
inline void resume(int i) {
  blk.cur = i;
  threadIdx = {(unsigned)i, 0u, 0u};
  swapcontext(&blk.sched, &blk.ctx[i]);
}

inline void run_block(int n) {
  blk.n = n;
  for (auto& s : blk.slots) s.assign(n, Slot{});
  blk.count.assign(n, 0);
  blk.done.assign(n, 0);
  blk.at_barrier.assign(n, 0);
  blk.ctx.resize(n);
  blk.stacks.resize(n);
  for (int i = 0; i < n; ++i) {
    blk.stacks[i].resize(1 << 18);
    getcontext(&blk.ctx[i]);
    blk.ctx[i].uc_stack.ss_sp = blk.stacks[i].data();
    blk.ctx[i].uc_stack.ss_size = blk.stacks[i].size();
    blk.ctx[i].uc_link = &blk.sched;
    makecontext(&blk.ctx[i], (void (*)())trampoline, 1, i);
  }
  const int nw = (n + 31) / 32;
  for (bool alive = true; alive;) {
    alive = false;
    if (schedule == 0) {
      for (int i = 0; i < n; ++i)
        if (!blk.done[i]) resume(i);
    } else {
      for (int k = 0; k < nw; ++k) {  // warp w alone up to its next barrier
        const int w = schedule > 0 ? k : nw - 1 - k, lo = 32 * w, hi = min(n, lo + 32);
        for (bool moved = true; moved;) {
          moved = false;
          for (int i = lo; i < hi; ++i)
            if (!blk.done[i] && !blk.at_barrier[i]) resume(i), moved = true;
          for (int i = lo + 1; i < hi; ++i)
            abort_if(blk.count[i] != blk.count[lo], "left its warp's collectives", i);
        }
      }
    }
    for (int i = 0; i < n; ++i) {
      abort_if(blk.count[i] != blk.count[0] || blk.done[i] != blk.done[0],
               "left its block's barriers", i);
      blk.at_barrier[i] = 0;
      alive = alive || !blk.done[i];
    }
  }
}

}  // namespace emu

inline void __syncthreads() {
  emu::step();
  emu::blk.at_barrier[threadIdx.x] = 1;
  emu::yield();
}

// the schedule of the launches that follow: 0 lockstep, 1 warp-serial in
// ascending warp order, -1 in descending
extern "C" void host_emu_schedule(int s) { emu::schedule = s; }

template <typename K, typename A>
void launch_stub(K kernel, dim3 grid, int threads, A a) {
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        emu::blk.body = [&] { kernel(a); };
        emu::run_block(threads);
      }
}

// __shfl_xor_sync over the whole warp: each lane deposits x and reads the
// x of lane ^ mask
inline float __shfl_xor_sync(unsigned, float x, int mask) {
  const int tid = threadIdx.x, lane = tid % 32, w0 = tid - lane;
  std::vector<emu::Slot>& slots = emu::step();
  slots[tid].a[0] = __float_as_uint(x);
  emu::yield();
  return __uint_as_float(slots[w0 + (lane ^ mask)].a[0]);
}

// d = c + a . b for the lane's four C elements (c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1)), A (16 x K) and B (K x 8) gathered from
// the warp's deposits by fill(lane's slot, g, t, A, B)
template <int K, typename Fill>
inline void emu_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                    Fill fill) {
  const int tid = threadIdx.x, lane = tid % 32, w0 = tid - lane;
  std::vector<emu::Slot>& slots = emu::step();
  emu::Slot& mine = slots[tid];
  memcpy(mine.a, a, sizeof(mine.a));
  mine.b[0] = b0;
  mine.b[1] = b1;
  emu::yield();
  float A[16][K], B[K][8];
  for (int l = 0; l < 32; ++l) fill(slots[w0 + l], l / 4, l % 4, A, B);
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
#ifdef HOST_EMU_TRUNCATE
    double sum = c[e];
    for (int k = 0; k < K; ++k) sum += (double)A[row][k] * B[k][col];
    float f = (float)sum;
    if (fabs((double)f) > fabs(sum)) f = nextafterf(f, 0.f);
    c[e] = f;
#else
    float sum = c[e];
    for (int k = 0; k < K; ++k) sum += A[row][k] * B[k][col];
    c[e] = sum;
#endif
  }
}

// mma.sync m16n8k8 f32.tf32: A (g, t) a0, (g+8, t) a1, (g, t+4) a2,
// (g+8, t+4) a3; B (t, g) b0, (t+4, g) b1; 19 bits of each operand read
inline void emu_mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  emu_mma<8>(c, a, b0, b1, [](const emu::Slot& s, int g, int t, float (&A)[16][8],
                              float (&B)[8][8]) {
    auto tf = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
    A[g][t] = tf(s.a[0]);
    A[g + 8][t] = tf(s.a[1]);
    A[g][t + 4] = tf(s.a[2]);
    A[g + 8][t + 4] = tf(s.a[3]);
    B[t][g] = tf(s.b[0]);
    B[t + 4][g] = tf(s.b[1]);
  });
}

// mma.sync m16n8k16 f32.bf16: each register two bf16, the lower half the
// lower column (A) or row (B); A rows g, g+8 at columns 2t, 2t+1 and 8 on;
// B rows 2t, 2t+1 and 8 on at column g
inline void emu_mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  emu_mma<16>(c, a, b0, b1, [](const emu::Slot& s, int g, int t, float (&A)[16][16],
                               float (&B)[16][8]) {
    auto half = [](uint32_t u, int hi) { return __uint_as_float(hi ? u & 0xffff0000u : u << 16); };
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = half(s.a[0], h);
      A[g + 8][2 * t + h] = half(s.a[1], h);
      A[g][2 * t + 8 + h] = half(s.a[2], h);
      A[g + 8][2 * t + 8 + h] = half(s.a[3], h);
      B[2 * t + h][g] = half(s.b[0], h);
      B[2 * t + 8 + h][g] = half(s.b[1], h);
    }
  });
}

// ldmatrix x4 of 8 x 8 b16 matrices: lane l gives the address of row l % 8
// of matrix l / 8 and receives, of each matrix i, word l % 4 of row l / 4
// in r[i]; transposed, the two b16 at column l / 4 of rows 2 (l % 4) and
// 2 (l % 4) + 1
inline void emu_ldsm4(uint32_t (&r)[4], const void* p, bool trans) {
  const int tid = threadIdx.x, lane = tid % 32, w0 = tid - lane;
  std::vector<emu::Slot>& slots = emu::step();
  slots[tid].addr = p;
  emu::yield();
  for (int i = 0; i < 4; ++i) {
    auto row = [&](int k) { return (const char*)slots[w0 + 8 * i + k].addr; };
    if (!trans) {
      memcpy(&r[i], row(lane / 4) + 4 * (lane % 4), 4);
    } else {
      uint16_t lo, hi;
      memcpy(&lo, row(2 * (lane % 4)) + 2 * (lane / 4), 2);
      memcpy(&hi, row(2 * (lane % 4) + 1) + 2 * (lane / 4), 2);
      r[i] = lo | ((uint32_t)hi << 16);
    }
  }
}
