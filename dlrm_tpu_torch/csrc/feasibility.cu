// The feasibility probes' building blocks for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of bench_scripts/kernel_feasibility.py,
// each a test of whether Mosaic could lower one building block of K1-K4
// (T1 and T5 are row_gather in probe_rows.cu and block_stream in
// block_stream.cu):
//   T2 contract          out[r, c] = sum over (s, l) of a[s, l, r] * b[s, l, c]
//                        (einsum "slr,sld->rd": a dot_general with two
//                        contracting dims, K = S * L); fp32 FMA, K split
//                        over a thread-block cluster, partials reduced in
//                        a fixed order.
//   T3 reshape_add       out = x.reshape(-1).reshape(rows, cols) + 1 on
//                        int32 (kernel_feasibility.py:83). On a contiguous
//                        x the reshape round trip is the identity, so this
//                        is one flat streaming pass out[i] = x[i] + 1.
//   T4 onehot_accumulate out[r] = sum of g[c] over the c with idx[c] == r
//                        (the TPU built a one-hot matrix and ran it on the
//                        MXU); one warp per output row, 32 indices
//                        compared at a time, added in index order from
//                        +0.0f. An index outside [0, rows) matches no row
//                        and is dropped, as the one-hot drops it.
//   T6 revolve_accumulate out block k = sum over j < steps of x block
//                        k * steps + j, added in j order from +0.0f
//                        (kernel_feasibility.py:162; the TPU carried the
//                        output block across sequential grid steps).
//
// What bounds them: at the probes' sizes (a few hundred KB) the launch; at
// scale, bytes for T3, T4 and T6 and operations for T2 (2 * K FLOPs per
// output element against 4 * (R + C) bytes per k).
//
// T2 is built for the operations bound in fp32 FFMA: TF32 (wgmma, mma)
// keeps about three decimal digits and could not hold rtol 1e-5 / atol
// 1e-4 against the fp32 product.
// - Split K over a cluster. An output tile of kBM x kBN (64 x 32) belongs
//   to a cluster of `split` CTAs (cudaLaunchKernelEx with a cluster
//   dimension), and CTA q takes the q-th contiguous 1/split of K, so the
//   work spreads over the SMs where R x C makes few tiles (P6's [256, 128]
//   output is 16 tiles). The split is the one of 1 .. 8 whose clusters
//   finish first, counting the waves the card needs to hold them
//   (cudaOccupancyMaxActiveClusters, asked once a device): an H100's GPCs
//   differ in size, so at one CTA an SM it holds 15 clusters of 8 or of 7
//   but 17 of 6, and 16 tiles in clusters of 8 would take two waves (T2 at
//   K 16,384 on an H100 80GB HBM3: 69 us in clusters of 8, 46 us in
//   clusters of 6; probes/t2_sweep.py).
// - Register tiling. Inside a CTA each warp holds the whole tile, a thread
//   an 8 x 8 block of it fed by four float4 shared reads per 64 FFMA, and
//   the 8 warps take kGroupK k each of every kBK-deep stage (sliced K). A
//   4 x 4 block (two float4 reads per 16 FFMA, two groups of 128 threads)
//   took 78 us there. What holds a CTA to about half of an SM's FFMA rate
//   is not yet separated; with the loads taken out it reaches about two
//   thirds.
// - Loads. The stages come in by cp.async through a ring of kStages
//   buffers: 16 bytes a copy where R and C are multiples of 4 and a and b
//   start 16-byte aligned, 4 bytes a copy otherwise; ragged K, R and C
//   zero-filled.
// - A fixed reduction. The warps' partials (stored in fragment order,
//   so the stores meet no bank conflict) are summed in warp order; each
//   CTA stores slice j of its sum into rank j's shared memory (distributed
//   shared memory, after a cluster barrier that every CTA arrived at when
//   it started), and after one more cluster barrier each rank sums its
//   slice over the ranks in rank order and writes it. One launch, and the
//   same bits on every call (the split is fixed for a shape on a card). A
//   cluster launch the driver refuses is returned as its error.
//
// T4: one warp owns an output row, and a block holds 4 (a grid of rows / 4
// blocks: P6's 512 rows are 128 blocks, about one wave). Lane i reads
// idx[c0 + i] (from L1/L2, four 32-index chunks in flight) and the warp
// takes __ballot_sync(idx == r); the set bits are walked in ascending
// order (__ffs), and for each matching hit every lane adds its float4 of
// g[c] (4 floats 32 apart in the scalar instance, for d % 4 != 0 or a g or
// out that is not 16-byte aligned) with __fadd_rn from +0.0f: the plain
// version's in-order sum. d > 128 takes passes of 128 columns, each
// scanning idx again. The work grows as rows x cap / 32 ballots (8 a row
// at P6's cap 256): a building block for K2's chunks, which are 256 hits,
// not for a cap in the thousands (chip_smoke.py phase 5 times cap 4,096
// into 4,096 rows).
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;  // T2: output tile rows (r)
constexpr int kBN = 32;  // T2: output tile columns (c)
constexpr int kBK = 64;  // T2: k a stage
constexpr int kStages = 4;  // T2: stages in the cp.async ring
constexpr int kT2Threads = 256;
constexpr int kTM = 8, kTN = 8;  // T2: a thread's outputs
// T2: a group of threads holds the whole tile (one warp), and the groups
// of a CTA take their kGroupK k of every stage each
constexpr int kGroupThreads = kBM * kBN / (kTM * kTN);
constexpr int kGroups = kT2Threads / kGroupThreads;
constexpr int kGroupK = kBK / kGroups;
constexpr int kTile4 = kBM * kBN / 4;  // float4s a tile
constexpr int kStageFloats = kBK * (kBM + kBN);
constexpr int kMaxSplit = 8;  // T2: CTAs a cluster (portable maximum)
// shared memory: the ring, which then holds the groups' partial tiles,
// and the slices the cluster's ranks send this one
constexpr int kRingFloats = kStages * kStageFloats > kGroups * kTile4 * 4
                                ? kStages * kStageFloats
                                : kGroups * kTile4 * 4;
constexpr int kT2SmemBytes = (kRingFloats + 4 * (kTile4 + kMaxSplit)) * 4;
constexpr int kMaxDevices = 64;
constexpr int kT4Warps = 4;  // T4: output rows a block
constexpr int kThreads = 256;  // T3 and T6 block
constexpr int kDepth = 2;  // T3: int4 loads in flight a thread
constexpr int64_t kTile = int64_t(kThreads) * kDepth;  // T3: int4s a block

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool full, bool vec16) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  if (vec16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(full ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// stage rows [k0, k0 + kBK) of a's [r0, r0 + kBM) and b's [c0, c0 + kBN)
// into st (a [kBK][kBM], then b [kBK][kBN]), zero past kend, rows and cols
template <bool kVec>
__device__ __forceinline__ void contract_stage(
    float* st, const float* __restrict__ a, const float* __restrict__ b,
    int k0, int kend, int rows, int cols, int r0, int c0) {
  constexpr int kW = kVec ? 4 : 1;  // floats a copy
  constexpr int kAc = kBM / kW, kBc = kBN / kW;  // copies a k row
#pragma unroll
  for (int u = 0; u < kBK * kAc / kT2Threads; ++u) {
    const int i = threadIdx.x + u * kT2Threads;
    const int kk = i / kAc, j = i % kAc * kW, k = k0 + kk;
    const bool ok = k < kend && r0 + j < rows;
    cp_async(st + kk * kBM + j, ok ? a + int64_t(k) * rows + r0 + j : a, ok,
             kVec);
  }
  float* bs = st + kBK * kBM;
#pragma unroll
  for (int u = 0; u < kBK * kBc / kT2Threads; ++u) {
    const int i = threadIdx.x + u * kT2Threads;
    const int kk = i / kBc, j = i % kBc * kW, k = k0 + kk;
    const bool ok = k < kend && c0 + j < cols;
    cp_async(bs + kk * kBN + j, ok ? b + int64_t(k) * cols + c0 + j : b, ok,
             kVec);
  }
}

// the element of a tile at float4 f (fragment order: the groups' partials
// are stored so that a warp's float4 stores are contiguous), lane w: its
// row and column in the tile
__device__ __forceinline__ void tile_at(int f, int w, int& row, int& col) {
  const int frag = f / kGroupThreads, gt = f % kGroupThreads;
  const int i = frag / (kTN / 4), q = frag % (kTN / 4);
  row = i / 4 * (kBM / 2) + gt / (kBN / kTN) * 4 + i % 4;
  col = q * (kBN / 2) + gt % (kBN / kTN) * 4 + w;
}

// grid: split CTAs (one cluster) per output tile, tile-major; k_per is K's
// share a rank. Dynamic shared memory: kT2SmemBytes.
template <bool kVec>
__global__ void __launch_bounds__(kT2Threads, 1)
    contract_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int k_total, int rows, int cols,
                    int k_per, int tiles_c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* recv4 = smem4 + kRingFloats / 4;  // [split][per4]: ranks' slices
  cg::cluster_group cluster = cg::this_cluster();
  // this CTA has started: the ranks may write into its shared memory once
  // they have all arrived (the wait below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int split = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int tile = blockIdx.x / split;
  const int r0 = tile / tiles_c * kBM, c0 = tile % tiles_c * kBN;
  const int kbeg = min(k_total, rank * k_per);
  const int kend = min(k_total, kbeg + k_per);
  const int n = (kend - kbeg + kBK - 1) / kBK;
  const int grp = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  // rows tr*4 .. +3 and kBM/2 + tr*4 .. +3; columns tc*4 .. +3 and
  // kBN/2 + tc*4 .. +3: a warp's float4 reads of a k row are contiguous
  const int tr = gt / (kBN / kTN), tc = gt % (kBN / kTN);

  float acc[kTM][kTN] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) {
      contract_stage<kVec>(smem + s * kStageFloats, a, b, kbeg + s * kBK,
                           kend, rows, cols, r0, c0);
    }
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every thread is done with s - 1
    const int next = s + kStages - 1;
    if (next < n) {
      contract_stage<kVec>(smem + next % kStages * kStageFloats, a, b,
                           kbeg + next * kBK, kend, rows, cols, r0, c0);
    }
    cp_async_commit();
    const float* as = smem + s % kStages * kStageFloats;
    const float* bs = as + kBK * kBM;
#pragma unroll
    for (int kk = 0; kk < kGroupK; ++kk) {
      const int k = grp * kGroupK + kk;
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kBM + tr * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(
          as + k * kBM + kBM / 2 + tr * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kBN + tc * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          bs + k * kBN + kBN / 2 + tc * 4);
      const float ar[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the groups' partials

  float4* part4 = smem4 + grp * kTile4;  // fragment order (tile_at)
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q) {
      part4[(i * (kTN / 4) + q) * kGroupThreads + gt] =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                      acc[i][4 * q + 3]);
    }
  }
  __syncthreads();
  // the CTA's partial (groups summed in group order), sent in slices of
  // per4 float4s: slice j to rank j, at this rank's place in its buffer
  const int per4 = (kTile4 + split - 1) / split;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int f = threadIdx.x; f < kTile4; f += kT2Threads) {
    float4 v = smem4[f];
    for (int g = 1; g < kGroups; ++g) {
      const float4 o = smem4[g * kTile4 + f];
      v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y),
                      __fadd_rn(v.z, o.z), __fadd_rn(v.w, o.w));
    }
    const int j = f / per4;
    cluster.map_shared_rank(recv4, j)[rank * per4 + f - j * per4] = v;
  }
  cluster.sync();  // every slice has reached its rank

  // this rank's slice, summed over the ranks in rank order
  const int f_end = min(kTile4, (rank + 1) * per4);
  for (int f = rank * per4 + int(threadIdx.x); f < f_end; f += kT2Threads) {
    const int t = f - rank * per4;
    float4 v = recv4[t];
    for (int q = 1; q < split; ++q) {
      const float4 o = recv4[q * per4 + t];
      v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y),
                      __fadd_rn(v.z, o.z), __fadd_rn(v.w, o.w));
    }
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      int row, col;
      tile_at(f, w, row, col);
      if (r0 + row < rows && c0 + col < cols) {
        out[int64_t(r0 + row) * cols + c0 + col] = e[w];
      }
    }
  }
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

// a warp an output row r; kVec: lane holds the float4 at columns
// col0 + 4 * lane, else the floats at col0 + lane + 32 * j (j < 4)
template <bool kVec>
__global__ void __launch_bounds__(kT4Warps * 32)
    onehot_accumulate_kernel(const int* __restrict__ idx,
                             const float* __restrict__ g, int cap, int d,
                             int rows, float* __restrict__ out) {
  const int r = blockIdx.x * kT4Warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // the whole warp
  for (int col0 = 0; col0 < d; col0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};  // +0.0f
    for (int c0 = 0; c0 < cap; c0 += 128) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u + lane;
        v[u] = c < cap ? __ldg(idx + c) : -1;  // -1 matches no row
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        unsigned m = __ballot_sync(0xffffffffu, v[u] == r);
        while (m) {  // the hits of row r among these 32, in index order
          const int c = c0 + 32 * u + __ffs(m) - 1;
          m &= m - 1;
          const float* gc = g + int64_t(c) * d + col0;
          if (kVec) {
            if (col0 + 4 * lane < d) {
              const float4 x = __ldg(reinterpret_cast<const float4*>(gc) + lane);
              acc[0] = __fadd_rn(acc[0], x.x);
              acc[1] = __fadd_rn(acc[1], x.y);
              acc[2] = __fadd_rn(acc[2], x.z);
              acc[3] = __fadd_rn(acc[3], x.w);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (col0 + lane + 32 * j < d) {
                acc[j] = __fadd_rn(acc[j], __ldg(gc + lane + 32 * j));
              }
            }
          }
        }
      }
    }
    float* o = out + int64_t(r) * d + col0;
    if (kVec) {
      if (col0 + 4 * lane < d) {
        reinterpret_cast<float4*>(o)[lane] =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + lane + 32 * j < d) o[lane + 32 * j] = acc[j];
      }
    }
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

template <bool kVec>
cudaError_t contract_attrs(int dev) {
  static std::atomic<bool> done[kMaxDevices];
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      contract_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kT2SmemBytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return e;
}

cudaLaunchConfig_t contract_config(int64_t tiles, int split,
                                   cudaLaunchAttribute* attr,
                                   cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = unsigned(split);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(tiles * split));
  cfg.blockDim = dim3(kT2Threads);
  cfg.dynamicSmemBytes = size_t(kT2SmemBytes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of `split` CTAs the card holds at once (asked once a device)
template <bool kVec>
int contract_active_clusters(int dev, int split) {
  static std::atomic<int> known[kMaxDevices][kMaxSplit + 1];  // value + 1
  if (dev < kMaxDevices && known[dev][split].load() > 0) {
    return known[dev][split].load() - 1;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = contract_config(1, split, &attr, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, contract_kernel<kVec>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();  // a size the card refuses: not a candidate
    n = 0;
  }
  if (dev < kMaxDevices) known[dev][split].store(n + 1);
  return n;
}

// T2's split: the one of 1 .. kMaxSplit (each rank at least 2 * kBK of K)
// whose clusters finish first, counting the waves the card needs for the
// tiles' clusters; ties go to the smaller split
template <bool kVec>
int contract_split(int dev, int64_t tiles, int k_total) {
  int best = 1;
  int64_t best_cost = int64_t(k_total);  // split 1: no cluster to place
  for (int split = 2; split <= kMaxSplit; ++split) {
    if (int64_t(k_total) < int64_t(split) * 2 * kBK) break;
    const int active = contract_active_clusters<kVec>(dev, split);
    if (active <= 0) continue;
    const int64_t waves = (tiles + active - 1) / active;
    const int64_t cost = waves * ((k_total + split - 1) / split);
    if (cost < best_cost) {
      best = split;
      best_cost = cost;
    }
  }
  return best;
}

template <bool kVec>
int launch_contract(const float* a, const float* b, float* out, int k_total,
                    int rows, int cols, int split, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = contract_attrs<kVec>(dev);
  if (e != cudaSuccess) return int(e);
  const int64_t tiles_c = (cols + kBN - 1) / kBN;
  const int64_t tiles = (rows + kBM - 1) / kBM * tiles_c;
  if (split <= 0) split = contract_split<kVec>(dev, tiles, k_total);
  if (tiles * split > 0x7fffffff) return int(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = contract_config(tiles, split, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, contract_kernel<kVec>, a, b, out, k_total,
                         rows, cols, (k_total + split - 1) / split,
                         int(tiles_c));
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

// a [k_total, rows], b [k_total, cols], out [rows, cols]; contiguous fp32
extern "C" int t2_contract(const float* a, const float* b, float* out,
                           int k_total, int rows, int cols, void* stream) {
  if (k_total < 0 || rows <= 0 || cols <= 0) return int(cudaErrorInvalidValue);
  const bool vec = rows % 4 == 0 && cols % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_contract<true>(a, b, out, k_total, rows, cols, 0, s)
             : launch_contract<false>(a, b, out, k_total, rows, cols, 0, s);
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
  if (cap < 0 || d <= 0 || rows <= 0) return int(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned grid = unsigned((int64_t(rows) + kT4Warps - 1) / kT4Warps);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    onehot_accumulate_kernel<true><<<grid, kT4Warps * 32, 0, s>>>(
        idx, g, cap, d, rows, out);
  } else {
    onehot_accumulate_kernel<false><<<grid, kT4Warps * 32, 0, s>>>(
        idx, g, cap, d, rows, out);
  }
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
