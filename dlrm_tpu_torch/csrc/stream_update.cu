// K2 stream_update for Hopper (sm_90a): the streamed embedding-table update.
//
// Replaces the Pallas TPU kernel dlrm_tpu/ops/stream_kernels.py:
// stream_update (_sgd_kernel, _rowwise_adagrad_kernel, _adagrad_kernel with
// the shared _accumulate_gsum, _flags and _cast_out). Same function, same
// host-built U-layout inputs (dlrm_tpu_torch/ops/stream_plan.py):
//
//   for every table block b named by the work items:
//     Gsum[r] = sum of G_u[u] (fp32) over the slots u of b's items whose
//               table-local row rows_u[u] lies in b's row range (fp32
//               sums; each G row rounded to bf16 first when mm_bf16 is set)
//     sgd        W[r] -= lr * Gsum[r]
//     rwsadagrad acc[r] += sum_d(Gsum[r]^2) / d;
//                W[r] -= lr * Gsum[r] / (sqrt(acc[r]) + eps)
//     adagrad    acc[r] += Gsum[r]^2 (elementwise); W[r] -= the same
//   updating table and accumulator IN PLACE, with round-to-nearest or
//   stochastic rounding into a bf16 table.
//
// What bounds it on this card: bytes. Per hit it reads one G_u row (512 B
// in fp32) and adds it once; per touched table row it reads and writes the
// row and its accumulator once. There is no matrix product: the TPU kernel's
// one-hot MXU matmuls only emulated a gather/scatter-add, which a GPU does
// directly. The least time is those bytes over the memory rate.
//
// What the design does about it. The TPU walked the items in order on one
// core and carried Gsum [block_rows, d] in VMEM from item to item. Here the
// blocks run in parallel and nothing carries over between CTAs:
//   * one CTA per (table block, 128-row tile): Gsum for the tile is
//     128 x d fp32 in shared memory (64 KB at d = 128; a whole 2048-row
//     block would be 1 MiB and does not fit);
//   * a first small kernel finds each block's contiguous item range (the
//     builder emits a block's items together, _flags' first/last), so a CTA
//     of an untouched block exits at once and the pad block is never
//     visited (its items read only sentinel slots: an exact no-op);
//   * the CTA walks its block's items in order and stages each item's 256
//     slot rows in shared memory; warp w owns the tile rows r with
//     r % 8 == w and adds its slots serially in item/slot order, lane j
//     taking columns j, j+32, ...: the sum is deterministic, with no atomics,
//     and every G row is read by exactly one warp of one CTA;
//   * slots outside the tile (sentinel rows -1, the next block's hits a
//     256-slot chunk overruns into, other tiles' rows) are dropped by the
//     row-range test;
//   * only rows that received a hit are updated: for the others the update
//     is an exact no-op in all three optimizers, also under stochastic
//     rounding (a bf16 value's low 16 bits are zero, so no carry). Each
//     tile's rows belong to one CTA, so the in-place write has no race.
//
// Stochastic rounding adds 16 pseudo-random low bits to the fp32 pattern
// and truncates (FBGEMM's scheme, as _cast_out). The TPU's PRNG cannot be
// replayed, so the bits come from a counter-based hash of (seed, global
// row, column); dlrm_tpu_torch/ops/stream_kernels.py computes the same hash
// in torch integer ops for the plain version.
//
// C interface for ctypes: k2_stream_update returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

template <typename TW, int OPT>
__global__ void __launch_bounds__(kThreads)
    k2_update(TW* __restrict__ table, float* __restrict__ acc,
              const float* __restrict__ g_u, const int* __restrict__ rows_u,
              const int* __restrict__ item_row0,
              const int* __restrict__ item_u,
              const int* __restrict__ first, const int* __restrict__ last,
              int tiles, int block_rows, int d, int64_t u_total, float lr,
              float eps, uint32_t seed_hash, int mm_bf16, int sr) {
  extern __shared__ float smem[];
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

  for (int it = i0; it < i1; ++it) {
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
        const float* gr = g_u + (u0 + g * 32 + src) * d;
        float* row = gsum + l * d;
        for (int c = lane; c < d; c += 32) {
          float v = gr[c];
          if (mm_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
          row[c] += v;
        }
        if (lane == 0) hit[l] = 1;
      }
    }
  }
  __syncthreads();

  for (int l = warp; l < kTileRows; l += kWarps) {
    if (!hit[l]) continue;
    const int64_t r = grow0 + l;
    const float* gs = gsum + l * d;
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
      const uint32_t bits =
          sr ? hash32(row_key ^ static_cast<uint32_t>(c)) >> 16 : 0u;
      store_row_elem(w + c, v, sr, bits);
    }
  }
}

template <typename TW>
cudaError_t launch_update(int opt, void* table, float* acc, const float* g_u,
                          const int* rows_u, const int* item_row0,
                          const int* item_u, const int* first,
                          const int* last, int num_blocks, int block_rows,
                          int d, int64_t u_total, float lr, float eps,
                          uint32_t seed_hash, int mm_bf16, int sr,
                          cudaStream_t st) {
  void (*kern)(TW*, float*, const float*, const int*, const int*,
               const int*, const int*, const int*, int, int, int, int64_t,
               float, float, uint32_t, int, int);
  if (opt == kSgd) {
    kern = k2_update<TW, kSgd>;
  } else if (opt == kRowwiseAdagrad) {
    kern = k2_update<TW, kRowwiseAdagrad>;
  } else if (opt == kAdagrad) {
    kern = k2_update<TW, kAdagrad>;
  } else {
    return cudaErrorInvalidValue;
  }
  const int tiles = block_rows / kTileRows;
  const size_t smem =
      sizeof(float) * size_t(kTileRows) * d + sizeof(int) * (kChunk + kTileRows);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kern<<<unsigned(int64_t(num_blocks) * tiles), kThreads, smem, st>>>(
      static_cast<TW*>(table), acc, g_u, rows_u,
      item_row0, item_u, first, last, tiles, block_rows, d, u_total, lr, eps,
      seed_hash, mm_bf16, sr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k2_stream_update(
    int opt, int table_bf16, void* table, void* acc, const float* g_u,
    const int* rows_u, const int* item_block,
    const int* item_row0, const int* item_u,
    int* block_first,  // [num_blocks] scratch
    int* block_last,   // [num_blocks] scratch
    int64_t m_items, int64_t u_total, int num_blocks, int block_rows, int d,
    float lr, float eps, uint32_t seed, int mm_bf16, int sr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * size_t(kTileRows) * (d > 0 ? d : 0) +
      sizeof(int) * (kChunk + kTileRows);
  if (d <= 0 || block_rows <= 0 || block_rows % kTileRows != 0 ||
      num_blocks < 0 || m_items < 0 || smem > 232448 ||
      int64_t(num_blocks) * (block_rows / kTileRows) > 0x7fffffffLL ||
      (opt != kSgd && acc == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  if (num_blocks == 0 || m_items == 0) return int(cudaGetLastError());
  cudaError_t e = cudaMemsetAsync(block_first, 0xFF,
                                  sizeof(int) * size_t(num_blocks), st);
  if (e != cudaSuccess) return int(e);
  const int64_t want = (m_items + 255) / 256;
  const unsigned grid = unsigned(want < 4096 ? want : 4096);
  k2_block_ranges<<<grid, 256, 0, st>>>(item_block, m_items, num_blocks,
                                        block_first, block_last);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const uint32_t seed_hash = hash32(seed);
  float* accf = static_cast<float*>(acc);
  if (table_bf16) {
    e = launch_update<__nv_bfloat16>(
        opt, table, accf, g_u, rows_u, item_row0, item_u, block_first,
        block_last, num_blocks, block_rows, d, u_total, lr, eps, seed_hash,
        mm_bf16, sr, st);
  } else {
    e = launch_update<float>(
        opt, table, accf, g_u, rows_u, item_row0, item_u, block_first,
        block_last, num_blocks, block_rows, d, u_total, lr, eps, seed_hash,
        mm_bf16, sr, st);
  }
  return int(e);
}
