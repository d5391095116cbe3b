// Host emulation of the bf16 type the flash sources use (see cuda_runtime.h
// beside it): storage and round-to-nearest-even packing.
#pragma once

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline __nv_bfloat16 emu_to_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {emu_to_bf16(lo), emu_to_bf16(hi)};
}
