// Coalesce the row-sorted hits of a batch into one gradient row per touched
// table row, for Hopper (sm_90a): the segmented sum of the fused train
// step's sparse update (dlrm_tpu_torch/ops/sparse_update.py).
//
// It has no Pallas counterpart: dlrm_tpu/ops/sparse_update.py: coalesce_hits
// and coalesce leave this sum to XLA (a take, then jax.ops.segment_sum with
// indices_are_sorted=True). On the card an index_add_ would add each row's
// hits with atomics, in an order that changes from run to run; this kernel
// adds them in slot order, so that every run gives the same bits, and
// gathers and weighs each hit's cotangent row on the way, so that the [n, d]
// per-hit rows are never written out.
//
// With n hits sorted by row (r_s), seg[k] the run index of slot k
// (cumsum of run heads - 1), bag_s[k] the row of dly that hit k reads and
// w_s[k] its weight (or none: every weight 1):
//
//   for every run r_s[k .. k+len) of one row (a head: k == 0 or
//   r_s[k] != r_s[k-1]):
//     G[seg[k]]     = ((0 + dly[bag_s[k]] * w_s[k]) + ...) in slot order
//     urows[seg[k]] = r_s[k]
//   for every slot k past the last run (k >= seg[n-1] + 1):
//     G[k] = 0, urows[k] = total_rows + k   (distinct rows past the table,
//                                            which the table update skips)
//
// Multiplies and adds are __fmul_rn / __fadd_rn: no fused multiply-add, so
// the bits are the plain version's (sparse_update.coalesce_rows_plain).
//
// What bounds it on this card: bytes. Each hit reads one dly row (d floats)
// and 12 bytes of row, bag and weight; each slot writes one G row and one
// row id. Design: one warp per slot, grid-stride; a slot that does not start
// a run returns at once. The head's warp walks its run 32 hits at a time:
// each lane reads one hit's bag and weight, shuffles broadcast them, and the
// warp keeps 16 / NC dly rows in flight (each lane 4 columns of each, as
// float4; NC = ceil(d / 128) float4 a lane per row) before adding them in
// order. A hot row's run is walked by one warp: the price of a fixed
// summation order.
//
// C interface for ctypes: the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

unsigned warp_grid(int64_t n) {
  const int64_t want = (n + kWarps - 1) / kWarps;
  return unsigned(want < 16384 ? (want > 0 ? want : 1) : 16384);
}

__device__ __forceinline__ float4 madd(float4 acc, float4 v, float w,
                                       bool weighted) {
  if (weighted) {
    v.x = __fmul_rn(v.x, w);
    v.y = __fmul_rn(v.y, w);
    v.z = __fmul_rn(v.z, w);
    v.w = __fmul_rn(v.w, w);
  }
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
  return acc;
}

// NC: float4 columns per lane (d <= 128 * NC); kUnroll rows in flight
template <int NC>
__global__ void __launch_bounds__(kThreads)
    coalesce_rows_kernel(const int* __restrict__ r_s,
                         const int* __restrict__ seg,
                         const int* __restrict__ bag_s,
                         const float* __restrict__ w_s,
                         const float* __restrict__ dly, int64_t n, int d,
                         int64_t total_rows, float* __restrict__ G,
                         int* __restrict__ urows) {
  constexpr int kUnroll = 16 / NC;
  const int lane = threadIdx.x % 32;
  const int64_t num_seg = int64_t(seg[n - 1]) + 1;
  const bool weighted = w_s != nullptr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t k = (blockIdx.x * int64_t(kThreads) + threadIdx.x) / 32;
       k < n; k += int64_t(gridDim.x) * kWarps) {
    if (k >= num_seg) {  // a slot past the last run
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int c = lane * 4 + q * 128;
        if (c < d) *reinterpret_cast<float4*>(G + k * d + c) = zero;
      }
      if (lane == 0) urows[k] = int(total_rows + k);
    }
    const int r = r_s[k];
    if (k > 0 && r_s[k - 1] == r) continue;  // not the head of its run
    float4 acc[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[q] = zero;
    for (int64_t j = k;; j += 32) {
      // the run's next 32 hits, one per lane; sorted rows make the lanes
      // still in the run a prefix of the warp
      const int64_t jj = j + lane;
      const bool in = jj < n && r_s[jj] == r;
      const int my_bag = in ? bag_s[jj] : 0;
      const float my_w = (in && weighted) ? w_s[jj] : 1.f;
      const int cnt = __popc(__ballot_sync(kFull, in));
      for (int i0 = 0; i0 < cnt; i0 += kUnroll) {
        float4 v[kUnroll][NC];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u;
          const int b = __shfl_sync(kFull, my_bag, i & 31);
          wv[u] = __shfl_sync(kFull, my_w, i & 31);
          const float* row = dly + int64_t(b) * d;
#pragma unroll
          for (int q = 0; q < NC; ++q) {
            const int c = lane * 4 + q * 128;
            v[u][q] = (i < cnt && c < d)
                          ? *reinterpret_cast<const float4*>(row + c)
                          : zero;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u < cnt) {
#pragma unroll
            for (int q = 0; q < NC; ++q)
              acc[q] = madd(acc[q], v[u][q], wv[u], weighted);
          }
        }
      }
      if (cnt < 32) break;
    }
    const int64_t o = seg[k];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = lane * 4 + q * 128;
      if (c < d) *reinterpret_cast<float4*>(G + o * d + c) = acc[q];
    }
    if (lane == 0) urows[o] = r;
  }
}

template <int NC>
void launch(const int* r_s, const int* seg, const int* bag_s,
            const float* w_s, const float* dly, int64_t n, int d,
            int64_t total_rows, float* G, int* urows, cudaStream_t st) {
  coalesce_rows_kernel<NC><<<warp_grid(n), kThreads, 0, st>>>(
      r_s, seg, bag_s, w_s, dly, n, d, total_rows, G, urows);
}

}  // namespace

// r_s, seg, bag_s [n] int32; w_s [n] f32 or null; dly [*, d] f32 and
// G [n, d] f32 contiguous and 16-byte aligned, d % 4 == 0, d <= 512;
// urows [n] int32
extern "C" int coalesce_rows(const int* r_s, const int* seg, const int* bag_s,
                             const float* w_s, const float* dly, int64_t n,
                             int d, int64_t total_rows, float* G, int* urows,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || d <= 0 || d % 4 != 0 || d > 512)
    return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaGetLastError());
  const int nc = (d + 127) / 128;
  if (nc == 1) {
    launch<1>(r_s, seg, bag_s, w_s, dly, n, d, total_rows, G, urows, st);
  } else if (nc == 2) {
    launch<2>(r_s, seg, bag_s, w_s, dly, n, d, total_rows, G, urows, st);
  } else {
    launch<4>(r_s, seg, bag_s, w_s, dly, n, d, total_rows, G, urows, st);
  }
  return int(cudaGetLastError());
}
