// Row gather and row scatter-add for Hopper (sm_90a): the per-row
// measurement probes.
//
// row_gather replaces the Pallas TPU kernels bench_scripts/scan_probe.py:
// pallas_gather (P1) and pallas_probe.py: pallas_gather (P5a), which issue
// one row DMA per index, and the in-VMEM takes of stream_variants.py:
// t1_variants (P2b) and kernel_feasibility.py: t1 (P6 T1):
//     out[k, :] = table[idx[k], :]
// over any row stride and element stride, so P2b's lane take
// (dlyT[:, idx]) is the same kernel on the transposed view.
// row_scatter_add replaces pallas_probe.py: pallas_scatter_add (P5b), a
// per-row read-modify-write DMA:
//     table[idx[k], :] += delta[k, :]   in place, idx unique
//
// What bounds them on this card: bytes, and the latency of the scattered
// row accesses (no arithmetic but one add per scattered element). The TPU
// kernels were limited by their DMA issue rate; here every warp has its own
// row in flight and the SMs keep thousands of warps resident.
//
// Design: one warp per row, grid-stride over the rows; a contiguous row
// moves as float4 (16 bytes a lane, 512 bytes a warp at d = 128), a strided
// row, or one whose width is not a multiple of 4, element by element. Unique scatter indices mean each table row has
// one writer, so no atomics. An index outside [0, rows) is not read: the
// gather writes a zero row for it, the scatter skips it.
//
// C interface for ctypes: each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

unsigned warp_grid(int64_t n) {
  const int64_t want = (n + kWarps - 1) / kWarps;
  return unsigned(want < 16384 ? (want > 0 ? want : 1) : 16384);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const float* __restrict__ table, int64_t rows,
                int64_t row_stride, int64_t elem_stride,
                const int* __restrict__ idx, int64_t n, int d,
                float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  for (int64_t k = (blockIdx.x * int64_t(kThreads) + threadIdx.x) / 32;
       k < n; k += int64_t(gridDim.x) * kWarps) {
    const int64_t r = idx[k];
    const bool ok = r >= 0 && r < rows;
    const float* src = table + (ok ? r : 0) * row_stride;
    float* dst = out + k * d;
    if (VEC) {
      for (int c = lane * 4; c < d; c += 128) {
        *reinterpret_cast<float4*>(dst + c) =
            ok ? *reinterpret_cast<const float4*>(src + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int c = lane; c < d; c += 32) dst[c] = ok ? src[c * elem_stride] : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows(float* __restrict__ table, int64_t rows,
                     const int* __restrict__ idx,
                     const float* __restrict__ delta, int64_t n, int d) {
  const int lane = threadIdx.x % 32;
  for (int64_t k = (blockIdx.x * int64_t(kThreads) + threadIdx.x) / 32;
       k < n; k += int64_t(gridDim.x) * kWarps) {
    const int64_t r = idx[k];
    if (r < 0 || r >= rows) continue;
    float* row = table + r * d;
    const float* dr = delta + k * d;
    if (kVec) {
      for (int c = lane * 4; c < d; c += 128) {
        float4 t = *reinterpret_cast<const float4*>(row + c);
        const float4 v = *reinterpret_cast<const float4*>(dr + c);
        t.x = __fadd_rn(t.x, v.x);
        t.y = __fadd_rn(t.y, v.y);
        t.z = __fadd_rn(t.z, v.z);
        t.w = __fadd_rn(t.w, v.w);
        *reinterpret_cast<float4*>(row + c) = t;
      }
    } else {
      for (int c = lane; c < d; c += 32) row[c] = __fadd_rn(row[c], dr[c]);
    }
  }
}

}  // namespace

// vec: rows are contiguous (elem_stride 1) and 16-byte aligned, d % 4 == 0
extern "C" int row_gather(const float* table, int64_t rows, int64_t row_stride,
                          int64_t elem_stride, const int* idx, int64_t n,
                          int d, int vec, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || d <= 0 || (vec && d % 4 != 0)) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaGetLastError());
  if (vec) {
    gather_rows<true><<<warp_grid(n), kThreads, 0, st>>>(
        table, rows, row_stride, elem_stride, idx, n, d, out);
  } else {
    gather_rows<false><<<warp_grid(n), kThreads, 0, st>>>(
        table, rows, row_stride, elem_stride, idx, n, d, out);
  }
  return int(cudaGetLastError());
}

// table [rows, d] and delta [n, d] contiguous; with d % 4 == 0 both
// 16-byte aligned (float4 rows), else element by element
extern "C" int row_scatter_add(float* table, int64_t rows, const int* idx,
                               const float* delta, int64_t n, int d,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || d <= 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaGetLastError());
  if (d % 4 == 0) {
    scatter_add_rows<true><<<warp_grid(n), kThreads, 0, st>>>(
        table, rows, idx, delta, n, d);
  } else {
    scatter_add_rows<false><<<warp_grid(n), kThreads, 0, st>>>(
        table, rows, idx, delta, n, d);
  }
  return int(cudaGetLastError());
}
