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
//                        int32 (kernel_feasibility.py:83). On a contiguous
//                        x the reshape round trip is the identity, so this
//                        is one flat streaming pass out[i] = x[i] + 1.
//   T4 onehot_accumulate out[r] = sum of g[c] over the c with idx[c] == r
//                        (the TPU built a one-hot matrix and ran it on the
//                        MXU); one warp per output row, idx staged in
//                        shared memory, added in index order from 0, so
//                        the sum is deterministic.
//   T6 revolve_accumulate out block k = sum over j < steps of x block
//                        k * steps + j, added in j order from +0.0f
//                        (kernel_feasibility.py:162; the TPU carried the
//                        output block across sequential grid steps).
//
// What bounds them: at the probes' sizes (a few hundred KB) the launch; at
// scale, bytes for T3, T4 and T6 and operations for T2 (2 * K FLOPs per
// output element against 4 * (R + C) bytes per k).
//
// T3 and T6 are built for the bytes bound. Neither has reuse or a product,
// so neither uses shared memory or the tensor cores; each moves 16 bytes a
// thread per access with streaming hints (__ldcs / __stcs: read once,
// written once) and computes its offsets with no integer division.
// - T3: each block takes a tile of kDepth x kThreads int4s (8 KB), a
//   thread loading its kDepth int4s before its first store, neighbouring
//   threads on neighbouring 16 bytes. The grid covers the array once, a
//   tile a block (a loop over tiles takes what a grid's limit leaves). An
//   earlier form with a persistent grid-stride grid of SMs x resident
//   blocks took 190 us on an H100 at 268 MB in chip_smoke.py phase 5, 6 %
//   behind torch.add's 178, so the grid follows the data. The
//   wrapper gives out the same offset from a 16-byte boundary as x, so both
//   take 16-byte accesses past a scalar head; a scalar tail takes the last
//   numel % 4.
// - T6: a loop inside the thread takes the place of the TPU's sequential
//   grid dimension. A 2-D grid: blockIdx.y is the output block (looping
//   when there are more than the y limit), x runs over the block's float4
//   chunks. A thread loads its chunk of all `steps` input blocks (4 at a
//   time, the rest predicated) before its first add, then adds them in j
//   order with __fadd_rn from +0.0f: the plain version's bits. A scalar
//   instance takes a block of numel % 4 != 0 or a start that is not 16-byte
//   aligned.
//
// C interface for ctypes: each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 16;  // T2 tile
constexpr int kThreads = 256;  // T3 and T6 block
constexpr int kDepth = 2;  // T3: int4 loads in flight a thread
constexpr int64_t kTile = int64_t(kThreads) * kDepth;  // T3: int4s a block

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

// + 1 with int32 wrap-around, as ATen's add
__device__ __forceinline__ int plus_one(int v) {
  return int(unsigned(v) + 1u);
}

__device__ __forceinline__ int4 plus_one(int4 v) {
  return make_int4(plus_one(v.x), plus_one(v.y), plus_one(v.z),
                   plus_one(v.w));
}

// x[0, head) and x[head + 4 * n4, n) one element at a time (head, tail < 4),
// x[head, head + 4 * n4) as n4 int4s, a tile of kTile a block
__global__ void __launch_bounds__(kThreads)
    reshape_add_kernel(const int* __restrict__ x, int* __restrict__ out,
                       int64_t n, int head, int64_t n4) {
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  for (int64_t t0 = int64_t(blockIdx.x) * kTile; t0 < n4;
       t0 += int64_t(gridDim.x) * kTile) {
    const int64_t e0 = t0 + threadIdx.x;
    if (t0 + kTile <= n4) {
      int4 v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) v[u] = __ldcs(xv + e0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        __stcs(ov + e0 + u * kThreads, plus_one(v[u]));
      }
    } else {  // the last, partial tile
      for (int64_t e = e0; e < n4; e += kThreads) {
        __stcs(ov + e, plus_one(__ldcs(xv + e)));
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {  // the scalar head and tail
    const int t = threadIdx.x;
    const int64_t e = t < 4 ? t : head + 4 * n4 + (t - 4);
    if (t < 4 ? t < head : e < n) __stcs(out + e, plus_one(__ldcs(x + e)));
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

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// T is float4 (a block of whole float4s, 16-byte aligned) or float; n_e is
// a block's count of T
template <typename T>
__global__ void __launch_bounds__(kThreads)
    revolve_accumulate_kernel(const T* __restrict__ x, T* __restrict__ out,
                              int64_t n_out_blocks, int steps, int64_t n_e) {
  for (int64_t k = blockIdx.y; k < n_out_blocks; k += gridDim.y) {
    const T* xk = x + k * steps * n_e;
    T* ok = out + k * n_e;
    for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < n_e;
         e += int64_t(gridDim.x) * blockDim.x) {
      T acc{};  // +0.0f
      int j = 0;
      for (; j + 4 <= steps; j += 4) {
        T v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = __ldcs(xk + (j + u) * n_e + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc = add_rn(acc, v[u]);
      }
      const int rest = steps - j;  // < 4
      T v[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (u < rest) v[u] = __ldcs(xk + (j + u) * n_e + e);
      }
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (u < rest) acc = add_rn(acc, v[u]);
      }
      __stcs(ok + e, acc);
    }
  }
}

template <typename T>
int launch_revolve(const void* x, void* out, int64_t n_out_blocks, int steps,
                   int64_t n_e, cudaStream_t stream) {
  const int64_t gx = (n_e + kThreads - 1) / kThreads;
  const dim3 grid(unsigned(gx < (1 << 30) ? gx : (1 << 30)),
                  unsigned(n_out_blocks < 65535 ? n_out_blocks : 65535));
  revolve_accumulate_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_out_blocks, steps,
      n_e);
  return int(cudaGetLastError());
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

// x, out [rows * cols] int32, at the same offset from a 16-byte boundary
extern "C" int t3_reshape_add(const int* x, int* out, int64_t rows,
                              int64_t cols, void* stream) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) % 16;
  if (rows <= 0 || cols <= 0 || mis % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16 != mis) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t n = rows * cols;
  int64_t head = mis ? int64_t(16 - mis) / 4 : 0;  // elements to the boundary
  if (head > n) head = n;
  const int64_t n4 = (n - head) / 4;
  const int64_t tiles = (n4 + kTile - 1) / kTile;
  const unsigned grid = unsigned(tiles < 1 ? 1 : tiles < 0x7fffffff ? tiles
                                                                  : 0x7fffffff);
  reshape_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, int(head), n4);
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
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = block_elems % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_revolve<float4>(x, out, n_out_blocks, steps,
                                      block_elems / 4, s)
             : launch_revolve<float>(x, out, n_out_blocks, steps,
                                     block_elems, s);
}
