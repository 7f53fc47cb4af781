// Shared by the U-layout kernels K1-K4 (window_grads.cu, stream_update.cu,
// stream_rows.cu, window_pool.cu): the layout's constants, 4-wide row loads
// and stores, and the mm_dtype rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ulayout {

constexpr int kWindow = 1024;  // U-slots per window (w2t's unit)
constexpr int kChunk = 256;    // U-slots per work item
constexpr int kSentinel = -1;  // rows_u of a padding slot
constexpr int kThreads = 256;  // 8 warps
constexpr unsigned kFull = 0xffffffffu;

// Four neighbouring row elements as fp32: one 16-byte (fp32) or 8-byte
// (bf16) load. The callers require 4-element-aligned row starts.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four neighbouring fp32 values into a row of G_u or R_u: one 16-byte
// (fp32) store, or one 8-byte store of the values rounded to the nearest
// bf16, ties to even (the JAX kernels' astype of their fp32 results).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(v.x, v.y));
  const __nv_bfloat162 hi = __float22bfloat162_rn(make_float2(v.z, v.w));
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// The TPU kernels cast both operands of their one-hot matmuls to mm_dtype:
// round to the nearest bf16 (ties to even) when MM_BF16, else keep fp32.
template <bool MM_BF16>
__device__ __forceinline__ float mm_round(float v) {
  return MM_BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <bool MM_BF16>
__device__ __forceinline__ float4 mm_round4(float4 v) {
  return make_float4(mm_round<MM_BF16>(v.x), mm_round<MM_BF16>(v.y),
                     mm_round<MM_BF16>(v.z), mm_round<MM_BF16>(v.w));
}

// Grid for a grid-stride loop of one warp per slot.
inline unsigned warp_grid(int64_t slots) {
  const int64_t want = (slots + kThreads / 32 - 1) / (kThreads / 32);
  return unsigned(want < 8192 ? (want > 0 ? want : 1) : 8192);
}

}  // namespace ulayout
