// K2's stochastic-rounding hash, shared by K2 (stream_update.cu) and its
// plain version's torch integer ops (ops/stream_kernels.py repeats it).
// K2's first Hopper design (a CTA per 128-row tile walking all of its
// block's items), which this header held, is gone: P3's probe
// (k2_bisect.cu) now finds each tile's hits by binary search and sums them
// in registers.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace k2 {

__host__ __device__ __forceinline__ uint32_t hash32(uint32_t x) {
  // multipliers < 2^31 so the plain version can run this in int64 ops
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x2c1b3c6du;
  x ^= x >> 16;
  x *= 0x297a2d39u;
  x ^= x >> 15;
  return x;
}

}  // namespace k2
