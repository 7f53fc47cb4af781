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
// What the design does about it: many short CTAs. Grid: one CTA per
// (walk position, span of the block). A CTA has 512 threads (256 at depth
// 4, so that a round of its loads stays at 16 KB) and a span is one round:
// threads x depth float4s (8 KB at depth 1), so each thread loads its
// depth float4s once and stores them; on a walk read from ib, which each
// CTA reads before its first load, a span is two rounds. The design sweep
// (probes/block_stream_sweep.py, its table in PERF.md; NVIDIA H100 80GB
// HBM3, 700 W) measured the first design's 64 KB CTAs of 256 threads 3 %
// behind a copy: each CTA waits a whole load latency before its first
// store, and the last of ~16 waves runs half empty. Short spans fix both:
// 8 KB of 512 threads matches the card's copy on the static map (P4 S
// 0.704 ms against t + 1's 0.709-0.710); a walk read from ib hides its
// extra dependent read behind a second round (P4 D 0.707-0.708 ms, 0.722
// with one); depth 4 over 512 threads (32 KB spans) trails t + 1 by 1 %,
// over 256 threads by 0.4 %. A grid sized to the card (each CTA an equal
// share of the walk: 5-6 % slower), 1,024 threads, streaming cache hints
// (__ldcs/__stcs, an L2 evict_first policy) and copies by TMA through
// shared memory were all slower or no faster.
//
// C interface for ctypes: block_stream returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// a CTA's threads: a round of its loads (threads x depth) is <= 16 KB
template <int DEPTH>
__host__ __device__ constexpr int cta_threads() {
  return DEPTH == 4 ? 256 : 512;
}

// float4s a CTA covers: one round, two on a walk from ib
template <int DEPTH, bool DYN>
__host__ __device__ constexpr int64_t span4() {
  return int64_t(cta_threads<DEPTH>()) * DEPTH * (DYN ? 2 : 1);
}

__device__ __forceinline__ float4 affine(float4 v, float scale, float shift) {
  return make_float4(__fadd_rn(__fmul_rn(v.x, scale), shift),
                     __fadd_rn(__fmul_rn(v.y, scale), shift),
                     __fadd_rn(__fmul_rn(v.z, scale), shift),
                     __fadd_rn(__fmul_rn(v.w, scale), shift));
}

template <int DEPTH, bool DYN>
__global__ void __launch_bounds__(DEPTH == 4 ? 256 : 512)
    stream_blocks(const float4* in, float4* out, const int* __restrict__ ib,
                  int64_t block4, int64_t total4, unsigned spans_per_block,
                  float scale, float shift) {
  constexpr int kThreads = cta_threads<DEPTH>();
  constexpr int64_t kSpan = span4<DEPTH, DYN>();
  const unsigned g = blockIdx.x / spans_per_block;
  const unsigned span = blockIdx.x - g * spans_per_block;
  const int64_t blk = DYN ? int64_t(ib[g]) : int64_t(g);
  const int64_t lo = blk * block4 + int64_t(span) * kSpan;
  int64_t hi = lo + kSpan;
  if (hi > (blk + 1) * block4) hi = (blk + 1) * block4;  // a ragged block
  if (hi > total4) hi = total4;  // the static map's ragged last block
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

template <int DEPTH, bool DYN>
int launch(const float4* in, float4* out, const int* ib, int64_t n_walk,
           int64_t block4, int64_t total4, float scale, float shift,
           cudaStream_t st) {
  const int64_t spans = (block4 + span4<DEPTH, DYN>() - 1) /
                        span4<DEPTH, DYN>();
  const int64_t grid = n_walk * spans;
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (grid == 0) return int(cudaGetLastError());
  stream_blocks<DEPTH, DYN><<<unsigned(grid), cta_threads<DEPTH>(), 0, st>>>(
      in, out, ib, block4, total4, unsigned(spans), scale, shift);
  return int(cudaGetLastError());
}

template <int DEPTH>
int launch_map(const float4* in, float4* out, const int* ib, int64_t n_walk,
               int64_t block4, int64_t total4, float scale, float shift,
               cudaStream_t st) {
  return ib ? launch<DEPTH, true>(in, out, ib, n_walk, block4, total4, scale,
                                  shift, st)
            : launch<DEPTH, false>(in, out, ib, n_walk, block4, total4, scale,
                                   shift, st);
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
  const float4* i4 = reinterpret_cast<const float4*>(in);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (depth == 1) {
    return launch_map<1>(i4, o4, ib, n_walk, block4, total4, scale, shift, st);
  }
  if (depth == 2) {
    return launch_map<2>(i4, o4, ib, n_walk, block4, total4, scale, shift, st);
  }
  return launch_map<4>(i4, o4, ib, n_walk, block4, total4, scale, shift, st);
}
