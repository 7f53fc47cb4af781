// K4 window_pool for Hopper (sm_90a): the sum pooling of the streamed
// embedding forward, from the per-slot rows R_u that K3 wrote.
//
// Replaces the Pallas TPU kernel dlrm_tpu/ops/stream_kernels.py:
// window_pool (_window_pool_kernel). Same function on the same host-built
// U-layout inputs (dlrm_tpu_torch/ops/stream_plan.py):
//
//   pooled[t, b, :] = sum over the slots u of table t's windows with
//                     vals_u[u] == b of mm(wts_u[u]) * mm(R_u[u, :])  (fp32)
//
// where mm() rounds to bf16 when mm_bf16 is set (the TPU kernel carries the
// weight in a one-hot matrix of mm_dtype and casts R_u to mm_dtype). The
// caller passes pooled zero-filled (the TPU kernel zeroes each table's
// output block at its first window).
//
// What bounds it on this card: bytes, or the rate at which L2 takes the
// atomic adds. It reads each hit's R row once and adds it into one pooled
// row; pooled (T * B * d fp32, 218 MB at bench.py's width) is written once.
// The TPU kernel revolved a [B, d] output block per table through VMEM and
// added 128 slots at a time with a one-hot MXU matmul; at B = 16,384 that
// block is 8 MiB, which no GPU shared memory holds, and within a table the
// slots are sorted by row, not by bag, so a GPU CTA has no bag locality to
// keep in shared memory.
//
// Design (first, simple and right): one warp per slot in a grid-stride
// loop; lane j takes 4 neighbouring columns and adds them into the bag's
// pooled row with one vector fp32 atomic add (float4 atomicAdd, sm_90).
// Slots of weight 0 (the sentinels) add exactly 0 and are skipped. The
// atomics land in an order that changes from run to run, so the fp32 sums
// do too, within rounding; a deterministic order is later work.
//
// C interface for ctypes: k4_window_pool returns cudaGetLastError().

#include "u_layout.cuh"

namespace {

using namespace ulayout;

template <bool MM_BF16>
__global__ void __launch_bounds__(kThreads)
    k4_kernel(const float* __restrict__ r_u, const int* __restrict__ vals_u,
              const float* __restrict__ wts_u, const int* __restrict__ w2t,
              float* __restrict__ pooled, int64_t u_total, int batch, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t step = (int64_t(gridDim.x) * kThreads) >> 5;
  for (int64_t u = first; u < u_total; u += step) {
    const float w0 = wts_u[u];
    if (w0 == 0.f) continue;
    const float w = mm_round<MM_BF16>(w0);
    const float* src = r_u + u * d;
    float* dst =
        pooled + (int64_t(w2t[u / kWindow]) * batch + vals_u[u]) * d;
    for (int c = lane * 4; c < d; c += 128) {
      const float4 x = mm_round4<MM_BF16>(load4(src + c));
      atomicAdd(reinterpret_cast<float4*>(dst + c),
                make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y),
                            __fmul_rn(w, x.z), __fmul_rn(w, x.w)));
    }
  }
}

}  // namespace

extern "C" int k4_window_pool(const float* r_u, const int* vals_u,
                              const float* wts_u, const int* w2t,
                              float* pooled, int64_t u_total, int batch,
                              int d, int mm_bf16, void* stream) {
  if (d <= 0 || d % 4 != 0 || batch <= 0 || u_total < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (u_total == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = warp_grid(u_total);
  if (mm_bf16) {
    k4_kernel<true><<<grid, kThreads, 0, st>>>(r_u, vals_u, wts_u, w2t,
                                               pooled, u_total, batch, d);
  } else {
    k4_kernel<false><<<grid, kThreads, 0, st>>>(r_u, vals_u, wts_u, w2t,
                                                pooled, u_total, batch, d);
  }
  return int(cudaGetLastError());
}
