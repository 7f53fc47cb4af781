// K1 window_grads for Hopper (sm_90a): the per-hit gradients in U-order.
//
// Replaces the Pallas TPU kernel dlrm_tpu/ops/stream_kernels.py:
// window_grads (_window_grads_kernel). Same function on the same host-built
// U-layout inputs (dlrm_tpu_torch/ops/stream_plan.py):
//
//   G_u[u, :] = mm(wts_u[u]) * mm(dly[w2t[u / 1024], vals_u[u], :])
//
// where mm() rounds to bf16 when mm_bf16 is set (the TPU kernel carries the
// weight inside a one-hot matrix of mm_dtype and casts dly to mm_dtype) and
// keeps fp32 otherwise. The product is taken in fp32 and stored as fp32, or
// rounded once to the nearest bf16 (ties to even) when out_bf16 is set (the
// JAX step's g_dtype). Sentinel slots have weight 0 and give 0.
//
// What bounds it on this card: bytes. Per slot it writes one G row (512 B
// in fp32 at d = 128, 256 B in bf16) and reads one dly row. The TPU kernel
// spent B * d * 2 FLOPs per hit on a one-hot MXU matmul that only emulated
// this gather; a GPU gathers directly and multiplies once per element, so
// the least time is the G_u write plus one read of dly over the memory
// rate.
//
// Design: one warp per slot in a grid-stride loop; lane j takes 4
// neighbouring columns (one 16-byte fp32 or 8-byte bf16 store per lane).
// dly is read through its strides, so the [B, T, d] cotangent that
// autograd gives is passed as its [T, B, d] transposed view with no copy.
// Nothing of a whole [B, d] block is held on chip, so there is no batch
// limit (the TPU kernel's VMEM guard does not apply).
//
// C interface for ctypes: k1_window_grads returns cudaGetLastError().

#include "u_layout.cuh"

namespace {

using namespace ulayout;

template <typename TD, typename TO, bool MM_BF16>
__global__ void __launch_bounds__(kThreads)
    k1_kernel(const TD* __restrict__ dly, int64_t stride_t, int64_t stride_b,
              const int* __restrict__ vals_u, const float* __restrict__ wts_u,
              const int* __restrict__ w2t, TO* __restrict__ g_u,
              int64_t u_total, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t step = (int64_t(gridDim.x) * kThreads) >> 5;
  for (int64_t u = first; u < u_total; u += step) {
    const float w = mm_round<MM_BF16>(wts_u[u]);
    const TD* src = dly + int64_t(w2t[u / kWindow]) * stride_t +
                    int64_t(vals_u[u]) * stride_b;
    TO* dst = g_u + u * d;
    for (int c = lane * 4; c < d; c += 128) {
      const float4 x = mm_round4<MM_BF16>(load4(src + c));
      store4(dst + c, make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y),
                                  __fmul_rn(w, x.z), __fmul_rn(w, x.w)));
    }
  }
}

template <typename TD, typename TO>
cudaError_t launch(const void* dly, int64_t stride_t, int64_t stride_b,
                   const int* vals_u, const float* wts_u, const int* w2t,
                   void* g_u, int64_t u_total, int d, int mm_bf16,
                   cudaStream_t st) {
  const TD* x = static_cast<const TD*>(dly);
  TO* g = static_cast<TO*>(g_u);
  const unsigned grid = warp_grid(u_total);
  if (mm_bf16) {
    k1_kernel<TD, TO, true><<<grid, kThreads, 0, st>>>(
        x, stride_t, stride_b, vals_u, wts_u, w2t, g, u_total, d);
  } else {
    k1_kernel<TD, TO, false><<<grid, kThreads, 0, st>>>(
        x, stride_t, stride_b, vals_u, wts_u, w2t, g, u_total, d);
  }
  return cudaGetLastError();
}

template <typename TD>
cudaError_t launch_out(int out_bf16, const void* dly, int64_t stride_t,
                       int64_t stride_b, const int* vals_u,
                       const float* wts_u, const int* w2t, void* g_u,
                       int64_t u_total, int d, int mm_bf16, cudaStream_t st) {
  return out_bf16
             ? launch<TD, __nv_bfloat16>(dly, stride_t, stride_b, vals_u,
                                         wts_u, w2t, g_u, u_total, d,
                                         mm_bf16, st)
             : launch<TD, float>(dly, stride_t, stride_b, vals_u, wts_u, w2t,
                                 g_u, u_total, d, mm_bf16, st);
}

}  // namespace

extern "C" int k1_window_grads(int dly_bf16, const void* dly,
                               int64_t stride_t, int64_t stride_b,
                               const int* vals_u, const float* wts_u,
                               const int* w2t, void* g_u, int64_t u_total,
                               int d, int mm_bf16, int out_bf16,
                               void* stream) {
  if (d <= 0 || d % 4 != 0 || u_total < 0 || stride_t % 4 != 0 ||
      stride_b % 4 != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (u_total == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dly_bf16 ? launch_out<__nv_bfloat16>(out_bf16, dly, stride_t, stride_b,
                                           vals_u, wts_u, w2t, g_u, u_total,
                                           d, mm_bf16, st)
               : launch_out<float>(out_bf16, dly, stride_t, stride_b, vals_u,
                                   wts_u, w2t, g_u, u_total, d, mm_bf16, st);
  return int(e);
}
