// block_stream's design sweep on the card (probes/block_stream_sweep.py
// builds, calls and times it): variants of the streamed block update
// out[blk] = t[blk] * scale + shift (csrc/block_stream.cu, included here so
// that the shipped kernel is timed beside them).
//
//   even  a SIMT kernel: CTA k takes the walk's float4s [k * share4,
//         (k + 1) * share4) and walks them block by block (blk = ib[g] or
//         g). share4 = the bytes a CTA covers / 16; a grid of one CTA a
//         chunk is share4 = chunk, a grid sized to the card is share4 =
//         walk / (SMs x resident CTAs). Template knobs: threads (128,
//         256, 512, 1,024), DEPTH (16-byte loads in flight a thread: 1,
//         2, 4) and the cache hint of every load and store (plain;
//         __ldcs/__stcs; an L2 evict_first policy).
//   tma   a persistent CTA a share of 16-byte-aligned chunks of chunk4
//         float4s (never crossing a block), each brought into shared
//         memory by one cp.async.bulk behind an mbarrier, 2 or 3 stages
//         in flight; the affine is applied in shared memory and the chunk
//         stored by one cp.async.bulk shared -> global.
//
// Every variant reads each element once and writes it once, in the same
// thread (even) or after its load completed (tma), so in place is legal.
//
// C interface for ctypes: bs_sweep launches one variant and returns
// cudaGetLastError(); bs_sweep_resident returns the CTAs an SM holds.

#include "../csrc/block_stream.cu"

namespace bsv {

enum Hint { kPlain = 0, kStream = 1, kEvictFirst = 2 };

template <int HINT>
__device__ __forceinline__ float4 ld(const float4* p, uint64_t pol) {
  if (HINT == kStream) return __ldcs(p);
  if (HINT == kEvictFirst) {
    float4 v;
    asm volatile(
        "ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p), "l"(pol)
        : "memory");
    return v;
  }
  return *p;
}

template <int HINT>
__device__ __forceinline__ void st(float4* p, float4 v, uint64_t pol) {
  if (HINT == kStream) {
    __stcs(p, v);
  } else if (HINT == kEvictFirst) {
    asm volatile(
        "st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
        : "memory");
  } else {
    *p = v;
  }
}

template <int TH, int DEPTH, int HINT>
__device__ __forceinline__ void stream_range(const float4* in, float4* out,
                                             int64_t lo, int64_t hi,
                                             float scale, float shift,
                                             uint64_t pol) {
  for (int64_t i = lo + threadIdx.x; i < hi; i += int64_t(TH) * DEPTH) {
    float4 v[DEPTH];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int64_t j = i + int64_t(k) * TH;
      if (j < hi) v[k] = ld<HINT>(in + j, pol);
    }
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int64_t j = i + int64_t(k) * TH;
      if (j < hi) st<HINT>(out + j, affine(v[k], scale, shift), pol);
    }
  }
}

// walk4: the walk's float4s (total4 for the static map, whose blk = g
// makes the walk the table itself, ragged last block included)
template <int TH, int DEPTH, bool DYN, int HINT>
__global__ void __launch_bounds__(TH)
    even(const float4* in, float4* out, const int* __restrict__ ib,
         int64_t block4, int64_t total4, int64_t walk4, int64_t share4,
         float scale, float shift) {
  uint64_t pol = 0;
  if (HINT == kEvictFirst) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol));
  }
  int64_t p = int64_t(blockIdx.x) * share4;
  int64_t p1 = p + share4;
  if (p1 > walk4) p1 = walk4;
  if (!DYN) {
    stream_range<TH, DEPTH, HINT>(in, out, p, p1, scale, shift, pol);
    return;
  }
  while (p < p1) {
    const int64_t g = p / block4;
    const int64_t off = p - g * block4;
    int64_t n = block4 - off;
    if (n > p1 - p) n = p1 - p;
    const int64_t lo = int64_t(ib[g]) * block4 + off;
    stream_range<TH, DEPTH, HINT>(in, out, lo, lo + n, scale, shift, pol);
    p += n;
  }
}

using EvenFn = void (*)(const float4*, float4*, const int*, int64_t, int64_t,
                        int64_t, int64_t, float, float);

template <int TH, int DEPTH, int HINT>
EvenFn pick_dyn(bool dyn) {
  return dyn ? &even<TH, DEPTH, true, HINT> : &even<TH, DEPTH, false, HINT>;
}
template <int TH, int DEPTH>
EvenFn pick_hint(int hint, bool dyn) {
  if (hint == kStream) return pick_dyn<TH, DEPTH, kStream>(dyn);
  if (hint == kEvictFirst) return pick_dyn<TH, DEPTH, kEvictFirst>(dyn);
  return pick_dyn<TH, DEPTH, kPlain>(dyn);
}
template <int TH>
EvenFn pick_depth(int depth, int hint, bool dyn) {
  if (depth == 2) return pick_hint<TH, 2>(hint, dyn);
  if (depth == 4) return pick_hint<TH, 4>(hint, dyn);
  return pick_hint<TH, 1>(hint, dyn);
}
EvenFn pick_even(int threads, int depth, int hint, bool dyn) {
  if (threads == 128) return pick_depth<128>(depth, hint, dyn);
  if (threads == 1024) return pick_depth<1024>(depth, hint, dyn);
  return threads == 512 ? pick_depth<512>(depth, hint, dyn)
                        : pick_depth<256>(depth, hint, dyn);
}

// ------------------------------------------------------------------ tma
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(float4* dst, const float4* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

constexpr int kTmaThreads = 256;
constexpr int kMaxStages = 4;

template <bool DYN>
__device__ __forceinline__ int64_t chunk_at(int64_t c, const int* ib,
                                            int64_t block4, int64_t total4,
                                            int64_t chunk4, int64_t cpb,
                                            int* n) {
  int64_t lo, lim;
  if (DYN) {
    const int64_t g = c / cpb;
    const int64_t off = (c - g * cpb) * chunk4;
    lo = int64_t(ib[g]) * block4 + off;
    lim = block4 - off;
  } else {
    lo = c * chunk4;
    lim = total4 - lo;
  }
  *n = int(lim < chunk4 ? lim : chunk4);
  return lo;
}

template <bool DYN>
__global__ void __launch_bounds__(kTmaThreads)
    tma(const float4* in, float4* out, const int* __restrict__ ib,
        int64_t block4, int64_t total4, int64_t chunk4, int64_t cpb,
        int64_t n_chunks, int stages, float scale, float shift) {
  extern __shared__ __align__(128) float4 buf[];  // [stages][chunk4]
  __shared__ __align__(8) uint64_t bar[kMaxStages];
  const int64_t step = gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bar[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < stages; ++s) {
      const int64_t c = blockIdx.x + s * step;
      if (c >= n_chunks) break;
      int n;
      const int64_t lo = chunk_at<DYN>(c, ib, block4, total4, chunk4, cpb, &n);
      bulk_load(buf + s * chunk4, in + lo, uint32_t(n) * 16u, &bar[s]);
    }
  }
  __syncthreads();
  for (int64_t i = 0;; ++i) {
    const int64_t c = blockIdx.x + i * step;
    if (c >= n_chunks) break;
    const int s = int(i % stages);
    bar_wait(&bar[s], uint32_t(i / stages) & 1u);
    int n;
    const int64_t lo = chunk_at<DYN>(c, ib, block4, total4, chunk4, cpb, &n);
    float4* b = buf + s * chunk4;
    for (int j = threadIdx.x; j < n; j += kTmaThreads) {
      b[j] = affine(b[j], scale, shift);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              out + lo),
          "r"(smem_addr(b)), "r"(uint32_t(n) * 16u)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      const int64_t next = c + stages * step;
      if (next < n_chunks) {
        // the stage's store must have read the buffer before it refills
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        int n2;
        const int64_t lo2 =
            chunk_at<DYN>(next, ib, block4, total4, chunk4, cpb, &n2);
        bulk_load(b, in + lo2, uint32_t(n2) * 16u, &bar[s]);
      }
    }
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

}  // namespace bsv

// kind 0: even (threads, depth, hint; share4 float4s a CTA); kind 1: tma
// (chunks of share4 float4s, `stages` in flight, `grid` persistent CTAs).
// ib nullptr: the static map.
extern "C" int bs_sweep(int kind, int threads, int depth, int hint,
                        int stages, int64_t share4, int64_t grid,
                        const float* in, float* out, const int* ib,
                        int64_t n_walk, int64_t block4, int64_t total4,
                        float scale, float shift, void* stream) {
  using namespace bsv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* i4 = reinterpret_cast<const float4*>(in);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (share4 <= 0 || grid <= 0 || grid > 0x7fffffffLL || block4 <= 0) {
    return int(cudaErrorInvalidValue);
  }
  if (kind == 0) {
    const int64_t walk4 = ib ? n_walk * block4 : total4;
    EvenFn fn = pick_even(threads, depth, hint, ib != nullptr);
    fn<<<unsigned(grid), threads, 0, st>>>(i4, o4, ib, block4, total4, walk4,
                                           share4, scale, shift);
    return int(cudaGetLastError());
  }
  if (stages < 1 || stages > kMaxStages) return int(cudaErrorInvalidValue);
  const int64_t cpb = (block4 + share4 - 1) / share4;
  const int64_t n_chunks =
      ib ? n_walk * cpb : (total4 + share4 - 1) / share4;
  const size_t smem = size_t(stages) * size_t(share4) * 16;
  auto fn = ib ? &tma<true> : &tma<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fn<<<unsigned(grid), kTmaThreads, smem, st>>>(i4, o4, ib, block4, total4,
                                               share4, cpb, n_chunks, stages,
                                               scale, shift);
  return int(cudaGetLastError());
}

extern "C" int bs_sweep_resident(int kind, int threads, int depth, int hint,
                                 int stages, int64_t share4, int dyn) {
  using namespace bsv;
  int n = 0;
  if (kind == 0) {
    EvenFn fn = pick_even(threads, depth, hint, dyn != 0);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, 0)) {
      return -1;
    }
    return n;
  }
  const size_t smem = size_t(stages) * size_t(share4) * 16;
  auto fn = dyn ? &tma<true> : &tma<false>;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem)) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kTmaThreads,
                                                    smem)) {
    return -1;
  }
  return n;
}
