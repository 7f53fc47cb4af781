// Streamed block update for Hopper (sm_90a): the copy and revolve probes.
//
// Replaces the Pallas TPU kernels of bench_scripts/stream_variants.py:
// make_stream (P2a), kernel_feasibility.py: t5 (P6 T5) and
// revolve_probe.py: build (P4, variants S, D, M, N, P, Q), which stream a
// table through VMEM block by block:
//     out[blk] = t[blk] * scale + shift   for blk = ib[g], g = 0, 1, ...
// (ib absent: blk = g, the static map), each element rounded as the plain
// version's two torch ops round it (__fmul_rn, then __fadd_rn), so the two
// agree to the bit. out may be t itself (in place, P2's aliased stream);
// then the walk's blocks must be distinct.
//
// The TPU variants differed in how the pipeline was driven: a static or a
// data-dependent (scalar-prefetched) block map, the pipeline's blocked
// output or a manual DMA out, and 2 or 4 manual read-aheads. Here they
// become what a GPU can vary:
//   * the block map: static (blk = g) or read from ib;
//   * separate output or in place;
//   * depth: the number of 16-byte loads each thread keeps in flight before
//     it stores them (1, 2 or 4), the counterpart of P and Q's read-ahead.
//     Nothing lets the compiler move a load above an earlier store (in and
//     out may alias), so depth 1 means one load in flight per thread.
//
// What bounds it: bytes (one read and one write of each element; a
// multiply and an add per element is far below the card's rate).
//
// Grid: one CTA per (walk position, 64 KB chunk of the block).
//
// C interface for ctypes: block_stream returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk4 = 4096;  // float4s per CTA: 64 KB

__device__ __forceinline__ float4 affine(float4 v, float scale, float shift) {
  return make_float4(__fadd_rn(__fmul_rn(v.x, scale), shift),
                     __fadd_rn(__fmul_rn(v.y, scale), shift),
                     __fadd_rn(__fmul_rn(v.z, scale), shift),
                     __fadd_rn(__fmul_rn(v.w, scale), shift));
}

template <int DEPTH, bool DYN>
__global__ void __launch_bounds__(kThreads)
    stream_blocks(const float4* in, float4* out, const int* __restrict__ ib,
                  int64_t block4, int64_t total4, int chunks_per_block,
                  float scale, float shift) {
  const int64_t g = blockIdx.x / chunks_per_block;
  const int64_t chunk = blockIdx.x % chunks_per_block;
  const int64_t blk = DYN ? int64_t(ib[g]) : g;
  const int64_t lo = blk * block4 + chunk * kChunk4;
  int64_t hi = lo + kChunk4;
  if (hi > (blk + 1) * block4) hi = (blk + 1) * block4;
  if (hi > total4) hi = total4;
  for (int64_t i = lo + threadIdx.x; i < hi; i += int64_t(kThreads) * DEPTH) {
    float4 v[DEPTH];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int64_t j = i + int64_t(k) * kThreads;
      if (j < hi) v[k] = in[j];
    }
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int64_t j = i + int64_t(k) * kThreads;
      if (j < hi) out[j] = affine(v[k], scale, shift);
    }
  }
}

template <int DEPTH>
void launch(const float4* in, float4* out, const int* ib, unsigned grid,
            int64_t block4, int64_t total4, int cpb, float scale, float shift,
            cudaStream_t st) {
  if (ib) {
    stream_blocks<DEPTH, true><<<grid, kThreads, 0, st>>>(
        in, out, ib, block4, total4, cpb, scale, shift);
  } else {
    stream_blocks<DEPTH, false><<<grid, kThreads, 0, st>>>(
        in, out, ib, block4, total4, cpb, scale, shift);
  }
}

}  // namespace

// in/out: contiguous fp32, 16-byte aligned, total4 float4s; a block is
// block4 float4s; the walk has n_walk positions (ib[n_walk], or nullptr for
// the static map); in == out for the in-place update.
extern "C" int block_stream(const float* in, float* out, const int* ib,
                            int64_t n_walk, int64_t block4, int64_t total4,
                            int depth, float scale, float shift,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_walk < 0 || block4 <= 0 || total4 < 0 ||
      (depth != 1 && depth != 2 && depth != 4)) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t cpb = (block4 + kChunk4 - 1) / kChunk4;
  const int64_t grid = n_walk * cpb;
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (grid == 0) return int(cudaGetLastError());
  const float4* i4 = reinterpret_cast<const float4*>(in);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (depth == 1) {
    launch<1>(i4, o4, ib, unsigned(grid), block4, total4, int(cpb), scale,
              shift, st);
  } else if (depth == 2) {
    launch<2>(i4, o4, ib, unsigned(grid), block4, total4, int(cpb), scale,
              shift, st);
  } else {
    launch<4>(i4, o4, ib, unsigned(grid), block4, total4, int(cpb), scale,
              shift, st);
  }
  return int(cudaGetLastError());
}
