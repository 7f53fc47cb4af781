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
// weight in a one-hot matrix of mm_dtype and casts R_u to mm_dtype). R_u is
// fp32, or bf16 when r_bf16 is set (the JAX step's g_dtype); the sums and
// pooled stay fp32. A bag that no slot hits comes out as a zero row.
//
// What bounds it on this card: bytes. It reads each hit's R row once (512 B
// in fp32 at d = 128, 256 B in bf16) and writes each pooled row once
// (pooled is T * B * d fp32, 218 MB at bench.py's width). The TPU kernel
// revolved a [B, d] output block per table through VMEM and added 128
// slots at a time with a one-hot MXU matmul; at B = 16,384 that block is
// 8 MiB, which no GPU shared memory holds, and within a table the slots
// are sorted by row, not by bag, so consecutive slots scatter over the
// bags.
//
// What the design does about it: it turns the slot-major layout bag-major,
// then pools one bag per warp, with no float atomics, in a fixed order:
//   1. count each (table, bag)'s slots of nonzero weight (integer atomics:
//      counts do not depend on order);
//   2. an exclusive scan of the T * B counts (a block scan per 2048-count
//      tile, then one CTA scans the tile totals);
//   3. place each such slot's id into its bag's list (in any order);
//   4. one warp per bag sorts its list ascending by rank (each id counts the
//      smaller ids; at most hot[t] ids, 100 at DLRM-v2's widths), sums
//      mm(w) * mm(R row) over it in slot order from zero, lane j holding 4
//      neighbouring columns, up to 4 rows in flight, and writes its pooled
//      row once (zeros for an empty bag).
// The sum order is the plain version's (ops/stream_kernels.py::
// window_pool_plain), so the two agree to the bit, and every run gives the
// same result. A slot of weight 0 (the sentinels, whose R row K3 writes as
// 0, and real zero weights) would add exactly +0 to a sum that starts at +0
// and is never -0, so it is left out of the lists; only a non-finite R row
// at such a slot (0 * inf) would have told.
//
// The R row type is a template parameter (fp32 or bf16). C interface for
// ctypes: k4_window_pool returns cudaGetLastError().

#include <climits>

#include "u_layout.cuh"

namespace {

using namespace ulayout;

constexpr int kScanPer = 8;                     // counts per scan thread
constexpr int kScanTile = kThreads * kScanPer;  // counts per scan CTA

__device__ __forceinline__ int64_t bag_of(const int* __restrict__ vals_u,
                                          const int* __restrict__ w2t,
                                          int64_t u, int batch) {
  return int64_t(w2t[u / kWindow]) * batch + vals_u[u];
}

__global__ void k4_zero(int* __restrict__ cnt, int64_t n) {
  for (int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * kThreads) {
    cnt[i] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    k4_count(const int* __restrict__ vals_u, const float* __restrict__ wts_u,
             const int* __restrict__ w2t, int* __restrict__ cnt,
             int64_t u_total, int batch) {
  for (int64_t u = blockIdx.x * int64_t(kThreads) + threadIdx.x; u < u_total;
       u += int64_t(gridDim.x) * kThreads) {
    if (wts_u[u] != 0.f) atomicAdd(cnt + bag_of(vals_u, w2t, u, batch), 1);
  }
}

// Exclusive prefix of the counts within each tile of kScanTile; each
// tile's total into tile_sum.
__global__ void __launch_bounds__(kThreads)
    k4_scan_tiles(const int* __restrict__ cnt, int* __restrict__ loc,
                  int* __restrict__ tile_sum, int64_t n) {
  __shared__ int warp_sum[kThreads / 32];
  const int64_t base =
      int64_t(blockIdx.x) * kScanTile + int64_t(threadIdx.x) * kScanPer;
  int v[kScanPer];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    const int x = base + i < n ? cnt[base + i] : 0;
    v[i] = mine;
    mine += x;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = mine;  // inclusive scan of the threads' totals in the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0;  // the totals of the warps before this one
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  const int excl = before + incl - mine;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    if (base + i < n) loc[base + i] = excl + v[i];
  }
  if (threadIdx.x == kThreads - 1) tile_sum[blockIdx.x] = excl + mine;
}

// One CTA: tile_sum becomes its exclusive prefix.
__global__ void __launch_bounds__(kThreads)
    k4_scan_sums(int* __restrict__ tile_sum, int tiles) {
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int b = 0; b < tiles; b += kThreads) {
    const int i = b + threadIdx.x;
    const int x = i < tiles ? tile_sum[i] : 0;
    int incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry;
    int all = carry;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += warp_sum[w];
      all += warp_sum[w];
    }
    if (i < tiles) tile_sum[i] = before + incl - x;
    carry = all;
    __syncthreads();  // warp_sum is rewritten by the next round
  }
}

__device__ __forceinline__ int64_t offset_of(const int* __restrict__ loc,
                                             const int* __restrict__ tile_pre,
                                             int64_t bag) {
  return int64_t(loc[bag]) + tile_pre[bag / kScanTile];
}

// Each listed slot's id into its bag's list; cnt counts down to 0.
__global__ void __launch_bounds__(kThreads)
    k4_place(const int* __restrict__ vals_u, const float* __restrict__ wts_u,
             const int* __restrict__ w2t, int* __restrict__ cnt,
             const int* __restrict__ loc, const int* __restrict__ tile_pre,
             int* __restrict__ list, int64_t u_total, int batch) {
  for (int64_t u = blockIdx.x * int64_t(kThreads) + threadIdx.x; u < u_total;
       u += int64_t(gridDim.x) * kThreads) {
    if (wts_u[u] == 0.f) continue;
    const int64_t bag = bag_of(vals_u, w2t, u, batch);
    const int pos = atomicSub(cnt + bag, 1) - 1;
    list[offset_of(loc, tile_pre, bag) + pos] = int(u);
  }
}

// One warp per bag: sort its slot ids, sum in that order, write the row.
// NV: 4-column groups per lane (d <= 128 * NV).
template <typename TR, bool MM_BF16, int NV>
__global__ void __launch_bounds__(kThreads)
    k4_pool(const TR* __restrict__ r_u, const float* __restrict__ wts_u,
            const int* __restrict__ loc, const int* __restrict__ tile_pre,
            const int* __restrict__ list, int* sorted,
            float* __restrict__ pooled, int64_t bags, int d) {
  constexpr int UNROLL = NV == 1 ? 4 : (NV == 2 ? 2 : 1);
  const int lane = threadIdx.x & 31;
  for (int64_t bag = (blockIdx.x * int64_t(kThreads) + threadIdx.x) >> 5;
       bag < bags; bag += (int64_t(gridDim.x) * kThreads) >> 5) {
    const int64_t off = offset_of(loc, tile_pre, bag);
    const int n = int(offset_of(loc, tile_pre, bag + 1) - off);
    // rank = the number of smaller ids (ids are distinct slots)
    for (int b = 0; b < n; b += 32) {
      const int my = b + lane < n ? list[off + b + lane] : INT_MAX;
      int rank = 0;
      for (int b2 = 0; b2 < n; b2 += 32) {
        const int other = b2 + lane < n ? list[off + b2 + lane] : INT_MAX;
        const int m = min(32, n - b2);
        for (int j = 0; j < m; ++j) {
          rank += __shfl_sync(kFull, other, j) < my;
        }
      }
      if (b + lane < n) sorted[off + rank] = my;
    }
    __syncwarp();

    float4 s[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) s[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < n; b += 32) {
      const int id = b + lane < n ? sorted[off + b + lane] : 0;
      const float w = b + lane < n ? mm_round<MM_BF16>(wts_u[id]) : 0.f;
      const int m = min(32, n - b);
      for (int k = 0; k < m; k += UNROLL) {
        float4 x[UNROLL][NV];
        float wk[UNROLL];
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
          const int src = min(k + i, m - 1);
          const int u = __shfl_sync(kFull, id, src);
          wk[i] = __shfl_sync(kFull, w, src);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = v * 128 + lane * 4;
            if (k + i < m && c < d) {
              x[i][v] = mm_round4<MM_BF16>(load4(r_u + int64_t(u) * d + c));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = v * 128 + lane * 4;
            if (k + i < m && c < d) {
              s[v] = make_float4(
                  __fadd_rn(s[v].x, __fmul_rn(wk[i], x[i][v].x)),
                  __fadd_rn(s[v].y, __fmul_rn(wk[i], x[i][v].y)),
                  __fadd_rn(s[v].z, __fmul_rn(wk[i], x[i][v].z)),
                  __fadd_rn(s[v].w, __fmul_rn(wk[i], x[i][v].w)));
            }
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * 128 + lane * 4;
      if (c < d) *reinterpret_cast<float4*>(pooled + bag * d + c) = s[v];
    }
  }
}

template <typename TR, bool MM_BF16, int NV>
void launch_pool(unsigned grid, cudaStream_t st, const void* r_u,
                 const float* wts_u, const int* loc, const int* tile_pre,
                 const int* list, int* sorted, float* pooled, int64_t bags,
                 int d) {
  k4_pool<TR, MM_BF16, NV><<<grid, kThreads, 0, st>>>(
      static_cast<const TR*>(r_u), wts_u, loc, tile_pre, list, sorted, pooled,
      bags, d);
}

template <typename TR>
void launch_pools(int mm_bf16, int nv, unsigned grid, cudaStream_t st,
                  const void* r_u, const float* wts_u, const int* loc,
                  const int* tile_pre, const int* list, int* sorted,
                  float* pooled, int64_t bags, int d) {
#define K4_POOL(MM, NV)                                                      \
  launch_pool<TR, MM, NV>(grid, st, r_u, wts_u, loc, tile_pre, list, sorted, \
                          pooled, bags, d)
  if (mm_bf16) {
    if (nv == 1) K4_POOL(true, 1);
    else if (nv == 2) K4_POOL(true, 2);
    else K4_POOL(true, 4);
  } else {
    if (nv == 1) K4_POOL(false, 1);
    else if (nv == 2) K4_POOL(false, 2);
    else K4_POOL(false, 4);
  }
#undef K4_POOL
}

inline unsigned capped_grid(int64_t threads) {
  const int64_t want = (threads + kThreads - 1) / kThreads;
  return unsigned(want < 65536 ? (want > 0 ? want : 1) : 65536);
}

}  // namespace

// Scratch (int32, from the caller): cnt and loc [tables * batch + 1] each,
// tile_sum [tiles = ceil((tables * batch + 1) / 2048)], list and sorted
// [u_total] each.
extern "C" int k4_window_pool(const void* r_u, const int* vals_u,
                              const float* wts_u, const int* w2t,
                              float* pooled, int* cnt, int* loc,
                              int* tile_sum, int* list, int* sorted,
                              int64_t u_total, int tables, int batch, int d,
                              int tiles, int mm_bf16, int r_bf16,
                              void* stream) {
  const int64_t bags = int64_t(tables) * batch;
  if (d <= 0 || d % 4 != 0 || d > 512 || batch <= 0 || tables <= 0 ||
      u_total < 0 || u_total > INT_MAX || bags + 1 > INT_MAX ||
      tiles != (bags + 1 + kScanTile - 1) / kScanTile) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = bags + 1;  // the extra zero count gives the end offset
  k4_zero<<<capped_grid(n), kThreads, 0, st>>>(cnt, n);
  k4_count<<<capped_grid(u_total), kThreads, 0, st>>>(vals_u, wts_u, w2t,
                                                       cnt, u_total, batch);
  k4_scan_tiles<<<unsigned(tiles), kThreads, 0, st>>>(cnt, loc, tile_sum, n);
  k4_scan_sums<<<1, kThreads, 0, st>>>(tile_sum, tiles);
  k4_place<<<capped_grid(u_total), kThreads, 0, st>>>(
      vals_u, wts_u, w2t, cnt, loc, tile_sum, list, u_total, batch);
  const unsigned grid = capped_grid(bags * 32);
  const int nv = d <= 128 ? 1 : (d <= 256 ? 2 : 4);
  if (r_bf16) {
    launch_pools<__nv_bfloat16>(mm_bf16, nv, grid, st, r_u, wts_u, loc,
                                tile_sum, list, sorted, pooled, bags, d);
  } else {
    launch_pools<float>(mm_bf16, nv, grid, st, r_u, wts_u, loc, tile_sum,
                        list, sorted, pooled, bags, d);
  }
  return int(cudaGetLastError());
}
