// P3 k2_bisect for Hopper (sm_90a): K2's sgd update on an fp32 table with
// its stages compiled in or out, to show which stage costs the time.
//
// Replaces the Pallas TPU probe bench_scripts/k2_bisect.py (run_variant's
// make_sgd_kernel, V1-V4, and run_variant_manual's make_sgd_manual_out,
// V5-V6). The TPU variants switched its DMAs, its one-hot matmuls and its
// write (conditional at the block's last item or at every grid step; the
// pipeline's blocked output or a manual DMA). Here the unit stays the
// TPU's, one CTA per (table block, 128-row tile), which makes the
// whole-tile variants the revolve floor, and the stages are switched:
//
//   V1  full update, writing only rows that got a hit: K2's bits (sgd,
//       fp32; both sum each row's hits in slot order from +0.0f)
//   V2  full update, writing every row of each visited 128-row tile
//   V3  skeleton: no G row read, no sums; finds the tile's hit rows and
//       rewrites only those
//   V4  skeleton rewriting every row of each visited tile, no search: the
//       revolve floor (read and write each visited tile once)
//   V5  V4 with the tile staged in shared memory and stored by one
//       cp.async.bulk shared -> global copy (the TPU's "manual out")
//   V6  V2 with the same bulk store
//
// Values: V1, V2, V5 and V6 give sgd's W[r] -= lr * Gsum[r] (a row with no
// hit is rewritten unchanged); the skeletons leave the table's bits as
// they were (W - lr * 0 is W). (The TPU skeletons left their Gsum scratch
// uninitialised and wrote whatever it held: a probe's shortcut, not a
// result to reproduce.)
//
// What bounds it: bytes, as K2. V4 reads and writes each visited tile
// once; V1 reads each hit's G row and reads and writes each touched row.
//
// What the design does about it. The U-layout sorts a table's hits by row
// (stably) and gives each block one contiguous run of slots from its first
// item (ops/stream_plan.py), so a tile's hits are one contiguous slot
// range. Over the block's slot span [item_u[first], item_u[last - 1] +
// 256) the predicate rows_u[s] < 0 || rows_u[s] >= x is monotone for any
// row x of the block: its real rows ascend, then come sentinels (-1) or
// the next block's (larger) rows, and a table's segment ends in at least
// 256 sentinel slots, so the span never reaches another table. Per CTA:
//   * two warps find the tile's range [lo, hi) by a 32-way search each
//     (x = the tile's first row, then its end): about three dependent
//     reads, where the first design walked all of the block's items (about
//     7 at the main-path shape) in every one of the block's 16 tiles;
//   * the CTA marks the run starts of [lo, hi) (a slot whose row differs
//     from the slot before) and compacts them in slot order into shared
//     memory: at most 128 runs, one per row of the tile;
//   * warp w takes runs w, w + 8, ...: each lane holds a float4 of the row
//     and of its sum, adds the run's G rows in slot order from +0.0f
//     (__fadd_rn; up to 4 rows in flight) and writes W - lr * sum once
//     (__fmul_rn, __fsub_rn). No Gsum in shared memory, nothing to zero,
//     and no shared memory limit on residency;
//   * the whole-tile variants rewrite the rows without a hit too, every
//     thread 4 float4s in flight; V5 and V6 stage the tile in shared
//     memory (128 x d fp32) for their one bulk store.
// A skewed row with thousands of hits is summed serially by its one warp,
// as K2 does: the bits stay K2's, the time is that warp's.
//
// Rows are moved 16 bytes at a time: d must be a multiple of 4 and the
// table and G_u 16-byte aligned (the wrapper refuses anything else).
//
// C interface for ctypes: k2_bisect returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;     // U-slots per work item
constexpr int kTileRows = 128;  // table rows per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kInFlight = 4;  // G rows (or tile float4s) a lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;
// the bulk variants' tile in shared memory, beside the static arrays
constexpr size_t kMaxSmem = 232448 - 4096;

// first[b]/last[b] = the item range [first, last) of real block b
// (first stays -1 for a block with no items). The full cover list puts
// pad-block items between tables, so item_block is not sorted overall.
__global__ void block_ranges(const int* __restrict__ item_block, int64_t m,
                             int num_blocks, int* __restrict__ first,
                             int* __restrict__ last) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < m;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int b = item_block[i];
    if (b < 0 || b >= num_blocks) continue;
    if (i == 0 || item_block[i - 1] != b) first[b] = int(i);
    if (i == m - 1 || item_block[i + 1] != b) last[b] = int(i + 1);
  }
}

// The slot's row lies at or past table-local row x (a sentinel counts as
// past): monotone over a block's slot span.
__device__ __forceinline__ bool past(int row, int x) {
  return row < 0 || row >= x;
}

// The first slot s in [a, b) with past(rows_u[s], x), or b; one warp.
// Each round probes the last slot of 32 equal segments and keeps the
// first segment whose probe is past: the range shrinks 32-fold a round.
__device__ int first_past(const int* __restrict__ rows_u, int a, int b,
                          int x, int lane) {
  while (b - a > 32) {  // invariant: the answer lies in [a, b]
    const int step = (b - a + 31) / 32;
    const int p = a + (lane + 1) * step - 1;
    const unsigned m =
        __ballot_sync(kFull, p >= b || past(rows_u[p], x));
    if (m == 0) return b;  // lane 31 probed b - 1: nothing is past
    const int k = __ffs(m) - 1;
    const int end = a + (k + 1) * step - 1;  // past, or >= b
    a += k * step;
    if (end < b) b = end;
  }
  const int p = a + lane;
  const unsigned m = __ballot_sync(kFull, p < b && past(rows_u[p], x));
  return m ? a + __ffs(m) - 1 : b;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 sgd4(float4 w, float4 g, float lr) {
  return make_float4(__fsub_rn(w.x, __fmul_rn(lr, g.x)),
                     __fsub_rn(w.y, __fmul_rn(lr, g.y)),
                     __fsub_rn(w.z, __fmul_rn(lr, g.z)),
                     __fsub_rn(w.w, __fmul_rn(lr, g.w)));
}

// The stages:
//   SUM       read each hit's G row and add it into the row's sum; off,
//             the sum stays 0 and no G row is read;
//   ALL_ROWS  write every row of the tile; off, only the rows that got a
//             hit. Without SUM and with ALL_ROWS there is nothing to find:
//             the search and the run scan are skipped;
//   BULK      write the updated tile into shared memory and store it with
//             one cp.async.bulk shared -> global copy (ALL_ROWS only).
template <bool SUM, bool ALL_ROWS, bool BULK>
__global__ void __launch_bounds__(kThreads, 4)
    bisect_tile(float* __restrict__ table, const float* __restrict__ g_u,
                const int* __restrict__ rows_u,
                const int* __restrict__ item_row0,
                const int* __restrict__ item_u,
                const int* __restrict__ first, const int* __restrict__ last,
                int tiles, int block_rows, int d, int u_total, float lr) {
  static_assert(!BULK || ALL_ROWS, "the bulk store writes whole tiles");
  constexpr bool kFind = SUM || !ALL_ROWS;
  extern __shared__ __align__(16) float4 tile_s[];  // BULK: [128][d / 4]
  __shared__ int run_s[kTileRows + 1];  // run starts in slot order, then hi
  __shared__ int row_s[kTileRows];      // each run's tile-local row
  __shared__ int hit_s[kTileRows];      // ALL_ROWS: the row has a run
  __shared__ int warp_n[kWarps];
  __shared__ int range_s[2];

  const int blk = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int i0 = first[blk];
  if (i0 < 0) return;  // block absent from the item list: untouched
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int x0 = item_row0[i0] + tile * kTileRows;  // table-local
  const int d4 = d / 4;
  float4* w4 = reinterpret_cast<float4*>(table) +
               (int64_t(blk) * block_rows + tile * kTileRows) * d4;
  const float4* g4 = reinterpret_cast<const float4*>(g_u);

  int runs = 0;
  if (kFind) {
    if (warp < 2) {
      const int a = item_u[i0];
      const int64_t end = int64_t(item_u[last[blk] - 1]) + kChunk;
      const int b = int(end < u_total ? end : u_total);
      const int s = first_past(rows_u, a, b, x0 + warp * kTileRows, lane);
      if (lane == 0) range_s[warp] = s;
    }
    if (ALL_ROWS) {
      for (int l = threadIdx.x; l < kTileRows; l += kThreads) hit_s[l] = 0;
    }
    __syncthreads();
    const int lo = range_s[0];
    const int hi = range_s[1];
    for (int s0 = lo; s0 < hi; s0 += kThreads) {
      const int s = s0 + threadIdx.x;
      int row = 0;
      bool start = false;
      if (s < hi) {
        row = rows_u[s];
        start = s == lo || rows_u[s - 1] != row;
      }
      const unsigned m = __ballot_sync(kFull, start);
      if (lane == 0) warp_n[warp] = __popc(m);
      __syncthreads();
      int at = runs, total = runs;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at += warp_n[w];
        total += warp_n[w];
      }
      const int j = at + __popc(m & ((1u << lane) - 1u));
      if (start && j < kTileRows) {  // a row-sorted plan has <= 128 runs
        run_s[j] = s;
        row_s[j] = row - x0;
        if (ALL_ROWS) hit_s[row - x0] = 1;
      }
      runs = total < kTileRows ? total : kTileRows;
      __syncthreads();  // warp_n is rewritten by the next piece
    }
    if (threadIdx.x == 0) run_s[runs] = hi;
    __syncthreads();
  }

  // the runs: warp w takes runs w, w + 8, ...; a lane its float4 columns
  for (int j = warp; j < runs; j += kWarps) {
    const int l = row_s[j];
    const int s1 = run_s[j + 1];
    for (int c = lane; c < d4; c += 32) {
      const float4 w = w4[l * d4 + c];
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      if (SUM) {
        for (int s = run_s[j]; s < s1; s += kInFlight) {
          float4 x[kInFlight];
#pragma unroll
          for (int i = 0; i < kInFlight; ++i) {
            if (s + i < s1) x[i] = g4[int64_t(s + i) * d4 + c];
          }
#pragma unroll
          for (int i = 0; i < kInFlight; ++i) {
            if (s + i < s1) g = add4(g, x[i]);
          }
        }
      }
      const float4 v = sgd4(w, g, lr);
      if (BULK) {
        tile_s[l * d4 + c] = v;
      } else {
        w4[l * d4 + c] = v;
      }
    }
  }

  if (ALL_ROWS) {  // the rows without a hit, rewritten unchanged
    const int n4 = kTileRows * d4;
    for (int i = threadIdx.x; i < n4; i += kThreads * kInFlight) {
      float4 v[kInFlight];
      bool on[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int at = i + k * kThreads;
        on[k] = at < n4 && !(kFind && hit_s[at / d4]);
        if (on[k]) v[k] = w4[at];
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int at = i + k * kThreads;
        if (!on[k]) continue;
        if (BULK) {
          tile_s[at] = v[k];
        } else {
          w4[at] = v[k];
        }
      }
    }
  }

  if (BULK) {
    // make the generic-proxy smem writes visible to the async proxy, then
    // one thread stores the whole tile and waits for the copy to finish
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t src =
          static_cast<uint32_t>(__cvta_generic_to_shared(tile_s));
      const uint32_t bytes = uint32_t(sizeof(float4)) * kTileRows * d4;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              w4),
          "r"(src), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  }
}

template <bool SUM, bool ALL_ROWS, bool BULK>
cudaError_t launch(float* table, const float* g_u, const int* rows_u,
                   const int* item_row0, const int* item_u, const int* first,
                   const int* last, int num_blocks, int block_rows, int d,
                   int u_total, float lr, cudaStream_t st) {
  auto kern = bisect_tile<SUM, ALL_ROWS, BULK>;
  const int tiles = block_rows / kTileRows;
  const size_t smem = BULK ? sizeof(float) * kTileRows * size_t(d) : 0;
  if (BULK) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<unsigned(int64_t(num_blocks) * tiles), kThreads, smem, st>>>(
      table, g_u, rows_u, item_row0, item_u, first, last, tiles, block_rows,
      d, u_total, lr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k2_bisect(int variant, float* table, const float* g_u,
                         const int* rows_u, const int* item_block,
                         const int* item_row0, const int* item_u,
                         int* block_first,  // [num_blocks] scratch
                         int* block_last,   // [num_blocks] scratch
                         int64_t m_items, int64_t u_total, int num_blocks,
                         int block_rows, int d, float lr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bulk = variant == 5 || variant == 6;
  if (variant < 1 || variant > 6 || d <= 0 || d % 4 != 0 ||
      block_rows <= 0 || block_rows % kTileRows != 0 || num_blocks < 0 ||
      m_items < 0 || u_total < 0 || u_total > 0x7fffffffLL ||
      (bulk && sizeof(float) * kTileRows * size_t(d) > kMaxSmem) ||
      int64_t(num_blocks) * (block_rows / kTileRows) > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  if (num_blocks == 0 || m_items == 0) return int(cudaGetLastError());
  cudaError_t e = cudaMemsetAsync(block_first, 0xFF,
                                  sizeof(int) * size_t(num_blocks), st);
  if (e != cudaSuccess) return int(e);
  const int64_t want = (m_items + 255) / 256;
  block_ranges<<<unsigned(want < 4096 ? want : 4096), 256, 0, st>>>(
      item_block, m_items, num_blocks, block_first, block_last);
#define K2_VARIANT(SUM, ALL_ROWS, BULK)                                      \
  launch<SUM, ALL_ROWS, BULK>(table, g_u, rows_u, item_row0, item_u,         \
                              block_first, block_last, num_blocks,           \
                              block_rows, d, int(u_total), lr, st)
  switch (variant) {
    case 1: return int(K2_VARIANT(true, false, false));
    case 2: return int(K2_VARIANT(true, true, false));
    case 3: return int(K2_VARIANT(false, false, false));
    case 4: return int(K2_VARIANT(false, true, false));
    case 5: return int(K2_VARIANT(false, true, true));
    default: return int(K2_VARIANT(true, true, true));
  }
#undef K2_VARIANT
}
