// The first Hopper design of K2, now the measurement probe P3's alone
// (k2_bisect.cu compiles its stages in or out): one CTA per (table block,
// 128-row tile) with the tile's Gsum in shared memory; the CTA walks all of
// its block's items in order, stages each item's 256 slot rows, and warp w
// adds the hits of the tile rows r % 8 == w serially. K2 itself
// (stream_update.cu) is now a warp per touched row's run of hits;
// stream_update.cu takes only hash32 from here. V1 (this kernel with every
// stage on, sgd) sums each row's hits in slot order from zero, as K2 does,
// so the two agree to the bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace k2 {

constexpr int kChunk = 256;     // U-slots per work item
constexpr int kTileRows = 128;  // table rows per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
static_assert(kThreads == kChunk, "one thread stages one slot row");

enum Opt { kSgd = 0, kRowwiseAdagrad = 1, kAdagrad = 2 };

__host__ __device__ __forceinline__ uint32_t hash32(uint32_t x) {
  // multipliers < 2^31 so the plain version can run this in int64 ops
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x2c1b3c6du;
  x ^= x >> 16;
  x *= 0x297a2d39u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_row_elem(float* p, float v, int,
                                               uint32_t) {
  *p = v;
}
__device__ __forceinline__ void store_row_elem(__nv_bfloat16* p, float v,
                                               int sr, uint32_t sr_bits) {
  if (sr) {  // add 16 random bits below the bf16 mantissa, then truncate
    const uint32_t u =
        (__float_as_uint(v) + (sr_bits & 0xFFFFu)) & 0xFFFF0000u;
    *p = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  } else {
    *p = __float2bfloat16_rn(v);
  }
}

// first[b]/last[b] = the item range [first, last) of real block b
// (first stays -1 for a block with no items).
__global__ void k2_block_ranges(const int* __restrict__ item_block,
                                int64_t m, int num_blocks,
                                int* __restrict__ first,
                                int* __restrict__ last) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < m;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int b = item_block[i];
    if (b < 0 || b >= num_blocks) continue;
    if (i == 0 || item_block[i - 1] != b) first[b] = int(i);
    if (i == m - 1 || item_block[i + 1] != b) last[b] = int(i + 1);
  }
}

// The stages of the update, which k2_bisect.cu switches (K2 itself runs
// with the defaults):
//   SUM       read each hit's G row and add it into Gsum; off, Gsum stays
//             0 and no G row is read;
//   ALL_ROWS  write every row of the tile; off, only the rows that got a
//             hit. Without SUM and with ALL_ROWS the item walk (the rows_u
//             scan) has nothing to find and is skipped;
//   BULK      write the updated tile into shared memory (over Gsum) and
//             store it with one cp.async.bulk shared -> global copy (fp32
//             tables and ALL_ROWS only).
template <typename TW, int OPT, bool SUM = true, bool ALL_ROWS = false,
          bool BULK = false>
__global__ void __launch_bounds__(kThreads)
    k2_update(TW* __restrict__ table, float* __restrict__ acc,
              const float* __restrict__ g_u, const int* __restrict__ rows_u,
              const int* __restrict__ item_row0,
              const int* __restrict__ item_u,
              const int* __restrict__ first, const int* __restrict__ last,
              int tiles, int block_rows, int d, int64_t u_total, float lr,
              float eps, uint32_t seed_hash, int mm_bf16, int sr) {
  static_assert(!BULK || (ALL_ROWS && std::is_same<TW, float>::value),
                "the bulk store writes whole fp32 tiles");
  extern __shared__ __align__(16) float smem[];
  float* gsum = smem;                                     // [128][d]
  int* rows_s = reinterpret_cast<int*>(gsum + kTileRows * d);  // [256]
  int* hit = rows_s + kChunk;                             // [128]

  const int blk = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int i0 = first[blk];
  if (i0 < 0) return;  // block absent from the item list: untouched
  const int i1 = last[blk];
  const int tile_lo = item_row0[i0] + tile * kTileRows;  // table-local
  const int64_t grow0 = int64_t(blk) * block_rows + tile * kTileRows;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kTileRows * d; i += kThreads) gsum[i] = 0.f;
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) hit[i] = 0;

  constexpr bool kScan = SUM || !ALL_ROWS;
  for (int it = i0; kScan && it < i1; ++it) {
    const int64_t u0 = item_u[it];
    const int64_t us = u0 + threadIdx.x;
    __syncthreads();  // previous item's rows_s fully consumed
    rows_s[threadIdx.x] = (us >= 0 && us < u_total) ? rows_u[us] : -1;
    __syncthreads();
    for (int g = 0; g < kChunk / 32; ++g) {
      const int local = rows_s[g * 32 + lane] - tile_lo;
      const bool mine = static_cast<unsigned>(local) <
                            static_cast<unsigned>(kTileRows) &&
                        (local % kWarps) == warp;
      unsigned mask = __ballot_sync(0xffffffffu, mine);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const int l = __shfl_sync(0xffffffffu, local, src);
        if (SUM) {
          const float* gr = g_u + (u0 + g * 32 + src) * d;
          float* row = gsum + l * d;
          for (int c = lane; c < d; c += 32) {
            float v = gr[c];
            if (mm_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
            row[c] += v;
          }
        }
        if (lane == 0) hit[l] = 1;
      }
    }
  }
  __syncthreads();

  for (int l = warp; l < kTileRows; l += kWarps) {
    if (!ALL_ROWS && !hit[l]) continue;
    const int64_t r = grow0 + l;
    float* gs = gsum + l * d;
    TW* w = table + r * d;
    const uint32_t row_key = hash32(static_cast<uint32_t>(r) ^ seed_hash);
    float denom_row = 0.f;  // rwsadagrad's per-row denominator
    if (OPT == kRowwiseAdagrad) {
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = __fadd_rn(s, __fmul_rn(gs[c], gs[c]));
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float new_acc = __fadd_rn(acc[r], __fdiv_rn(s, float(d)));
      denom_row = __fadd_rn(sqrtf(new_acc), eps);
      if (lane == 0) acc[r] = new_acc;
    }
    for (int c = lane; c < d; c += 32) {
      const float g = gs[c];
      float step;
      if (OPT == kSgd) {
        step = __fmul_rn(lr, g);
      } else if (OPT == kRowwiseAdagrad) {
        step = __fdiv_rn(__fmul_rn(lr, g), denom_row);
      } else {
        float* a = acc + r * d + c;
        const float na = __fadd_rn(*a, __fmul_rn(g, g));
        *a = na;
        step = __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(sqrtf(na), eps));
      }
      const float v = __fsub_rn(to_f32(w[c]), step);
      if (BULK) {
        gs[c] = v;  // the same lane read gs[c] above
      } else {
        const uint32_t bits =
            sr ? hash32(row_key ^ static_cast<uint32_t>(c)) >> 16 : 0u;
        store_row_elem(w + c, v, sr, bits);
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
          static_cast<uint32_t>(__cvta_generic_to_shared(gsum));
      const uint32_t bytes = uint32_t(sizeof(float)) * kTileRows * d;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          ::"l"(table + grow0 * d), "r"(src), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  }
}

inline size_t smem_bytes(int d) {
  return sizeof(float) * size_t(kTileRows) * (d > 0 ? d : 0) +
         sizeof(int) * (kChunk + kTileRows);
}

// Checks the geometry and fills first/last (scratch of num_blocks ints
// each). *empty is set when there is nothing to update.
inline cudaError_t find_block_ranges(const int* item_block, int64_t m_items,
                                     int num_blocks, int block_rows, int d,
                                     int* first, int* last, cudaStream_t st,
                                     bool* empty) {
  if (d <= 0 || block_rows <= 0 || block_rows % kTileRows != 0 ||
      num_blocks < 0 || m_items < 0 || smem_bytes(d) > 232448 ||
      int64_t(num_blocks) * (block_rows / kTileRows) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  *empty = num_blocks == 0 || m_items == 0;
  if (*empty) return cudaGetLastError();
  cudaError_t e =
      cudaMemsetAsync(first, 0xFF, sizeof(int) * size_t(num_blocks), st);
  if (e != cudaSuccess) return e;
  const int64_t want = (m_items + 255) / 256;
  const unsigned grid = unsigned(want < 4096 ? want : 4096);
  k2_block_ranges<<<grid, 256, 0, st>>>(item_block, m_items, num_blocks,
                                        first, last);
  return cudaGetLastError();
}

// One CTA per (block, 128-row tile), Gsum and the staged rows in dynamic
// shared memory.
template <typename TW, int OPT, bool SUM = true, bool ALL_ROWS = false,
          bool BULK = false>
cudaError_t launch_update(void* table, float* acc, const float* g_u,
                          const int* rows_u, const int* item_row0,
                          const int* item_u, const int* first,
                          const int* last, int num_blocks, int block_rows,
                          int d, int64_t u_total, float lr, float eps,
                          uint32_t seed_hash, int mm_bf16, int sr,
                          cudaStream_t st) {
  auto kern = k2_update<TW, OPT, SUM, ALL_ROWS, BULK>;
  const int tiles = block_rows / kTileRows;
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kern<<<unsigned(int64_t(num_blocks) * tiles), kThreads, smem, st>>>(
      static_cast<TW*>(table), acc, g_u, rows_u, item_row0, item_u, first,
      last, tiles, block_rows, d, u_total, lr, eps, seed_hash, mm_bf16, sr);
  return cudaGetLastError();
}

}  // namespace k2
