// The feasibility probes' building blocks for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of bench_scripts/kernel_feasibility.py,
// each a test of whether Mosaic could lower one building block of K1-K4
// (T1 and T5 are row_gather in probe_rows.cu and block_stream in
// block_stream.cu):
//   T2 contract          out[r, c] = sum over (s, l) of a[s, l, r] * b[s, l, c]
//                        (einsum "slr,sld->rd": a dot_general with two
//                        contracting dims); a 16 x 16 tiled fp32 product
//                        through shared memory, FMA in (s, l) order.
//   T3 reshape_add       out = x.reshape(-1).reshape(rows, cols) + 1 on
//                        int32: each element's flat index and back.
//   T4 onehot_accumulate out[r] = sum of g[c] over the c with idx[c] == r
//                        (the TPU built a one-hot matrix and ran it on the
//                        MXU); one warp per output row, idx staged in
//                        shared memory, added in index order from 0, so
//                        the sum is deterministic.
//   T6 revolve_accumulate out block k = sum over j < steps of x block
//                        k * steps + j, added in j order from 0 (the TPU
//                        carried the output block across grid steps).
//
// What bounds them: at the probes' sizes (a few hundred KB) the launch; at
// scale, bytes for T3, T4 and T6 and operations for T2 (2 * K FLOPs per
// output element against 4 * (R + C) bytes per k).
//
// C interface for ctypes: each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 16;  // T2 tile

__global__ void contract_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ out, int k_total,
                                int rows, int cols) {
  __shared__ float as[kT][kT + 1];  // [k][r]
  __shared__ float bs[kT][kT + 1];  // [k][c]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = blockIdx.y * kT + ty;
  const int c = blockIdx.x * kT + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < k_total; k0 += kT) {
    const int k = k0 + ty;
    const int ra = blockIdx.y * kT + tx;
    as[ty][tx] = (k < k_total && ra < rows) ? a[int64_t(k) * rows + ra] : 0.f;
    bs[ty][tx] = (k < k_total && c < cols) ? b[int64_t(k) * cols + c] : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT; ++kk) acc = fmaf(as[kk][ty], bs[kk][tx], acc);
    __syncthreads();
  }
  if (r < rows && c < cols) out[int64_t(r) * cols + c] = acc;
}

__global__ void reshape_add_kernel(const int* __restrict__ x,
                                   int* __restrict__ out, int64_t rows,
                                   int64_t cols) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       i < rows * cols; i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t row = i / cols, col = i % cols;  // flat -> [rows, cols]
    out[row * cols + col] = x[i] + 1;
  }
}

__global__ void onehot_accumulate_kernel(const int* __restrict__ idx,
                                         const float* __restrict__ g,
                                         int cap, int d, int rows,
                                         float* __restrict__ out) {
  extern __shared__ int idx_s[];  // [cap]
  for (int i = threadIdx.x; i < cap; i += blockDim.x) idx_s[i] = idx[i];
  __syncthreads();
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  for (int col = lane; col < d; col += 32) {
    float acc = 0.f;
    for (int c = 0; c < cap; ++c) {
      if (idx_s[c] == r) acc = __fadd_rn(acc, g[int64_t(c) * d + col]);
    }
    out[int64_t(r) * d + col] = acc;
  }
}

__global__ void revolve_accumulate_kernel(const float* __restrict__ x,
                                          float* __restrict__ out,
                                          int64_t n_out_blocks, int steps,
                                          int64_t block_elems) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       i < n_out_blocks * block_elems; i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t k = i / block_elems, e = i % block_elems;
    float acc = 0.f;
    for (int j = 0; j < steps; ++j) {
      acc = __fadd_rn(acc, x[(k * steps + j) * block_elems + e]);
    }
    out[i] = acc;
  }
}

unsigned grid_for(int64_t n, int threads) {
  const int64_t want = (n + threads - 1) / threads;
  return unsigned(want < 65535 ? (want > 0 ? want : 1) : 65535);
}

}  // namespace

// a [k_total, rows], b [k_total, cols], out [rows, cols]; contiguous fp32
extern "C" int t2_contract(const float* a, const float* b, float* out,
                           int k_total, int rows, int cols, void* stream) {
  if (k_total < 0 || rows <= 0 || cols <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid((cols + kT - 1) / kT, (rows + kT - 1) / kT);
  contract_kernel<<<grid, dim3(kT, kT), 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, k_total, rows, cols);
  return int(cudaGetLastError());
}

extern "C" int t3_reshape_add(const int* x, int* out, int64_t rows,
                              int64_t cols, void* stream) {
  if (rows <= 0 || cols <= 0) return int(cudaErrorInvalidValue);
  reshape_add_kernel<<<grid_for(rows * cols, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, rows, cols);
  return int(cudaGetLastError());
}

// idx [cap] int32, g [cap, d] fp32, out [rows, d] fp32
extern "C" int t4_onehot_accumulate(const int* idx, const float* g, int cap,
                                    int d, int rows, float* out,
                                    void* stream) {
  if (cap < 0 || d <= 0 || rows <= 0 ||
      size_t(cap) * sizeof(int) > 232448) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = size_t(cap > 0 ? cap : 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        onehot_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  onehot_accumulate_kernel<<<unsigned((rows + 7) / 8), 256, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      idx, g, cap, d, rows, out);
  return int(cudaGetLastError());
}

// x [n_out_blocks * steps * block_elems], out [n_out_blocks * block_elems]
extern "C" int t6_revolve_accumulate(const float* x, float* out,
                                     int64_t n_out_blocks, int steps,
                                     int64_t block_elems, void* stream) {
  if (n_out_blocks <= 0 || steps < 0 || block_elems <= 0) {
    return int(cudaErrorInvalidValue);
  }
  revolve_accumulate_kernel<<<grid_for(n_out_blocks * block_elems, 256), 256,
                              0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n_out_blocks, steps, block_elems);
  return int(cudaGetLastError());
}
