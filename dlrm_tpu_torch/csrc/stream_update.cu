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
// The kernel itself is k2_update.cuh's k2_update at its default stages (sum
// the G rows, write only the rows that got a hit); this file is its C
// interface for ctypes: k2_stream_update returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "k2_update.cuh"

extern "C" int k2_stream_update(
    int opt, int table_bf16, void* table, void* acc, const float* g_u,
    const int* rows_u, const int* item_block,
    const int* item_row0, const int* item_u,
    int* block_first,  // [num_blocks] scratch
    int* block_last,   // [num_blocks] scratch
    int64_t m_items, int64_t u_total, int num_blocks, int block_rows, int d,
    float lr, float eps, uint32_t seed, int mm_bf16, int sr, void* stream) {
  using namespace k2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (opt != kSgd && opt != kRowwiseAdagrad && opt != kAdagrad) {
    return int(cudaErrorInvalidValue);
  }
  if (opt != kSgd && acc == nullptr) return int(cudaErrorInvalidValue);
  bool empty = false;
  cudaError_t e = find_block_ranges(item_block, m_items, num_blocks,
                                    block_rows, d, block_first, block_last,
                                    st, &empty);
  if (e != cudaSuccess || empty) return int(e);
  const uint32_t seed_hash = hash32(seed);
  float* accf = static_cast<float*>(acc);
#define K2_LAUNCH(TW, OPT)                                                   \
  launch_update<TW, OPT>(table, accf, g_u, rows_u, item_row0, item_u,        \
                         block_first, block_last, num_blocks, block_rows, d, \
                         u_total, lr, eps, seed_hash, mm_bf16, sr, st)
  if (table_bf16) {
    if (opt == kSgd) return int(K2_LAUNCH(__nv_bfloat16, kSgd));
    if (opt == kRowwiseAdagrad) {
      return int(K2_LAUNCH(__nv_bfloat16, kRowwiseAdagrad));
    }
    return int(K2_LAUNCH(__nv_bfloat16, kAdagrad));
  }
  if (opt == kSgd) return int(K2_LAUNCH(float, kSgd));
  if (opt == kRowwiseAdagrad) return int(K2_LAUNCH(float, kRowwiseAdagrad));
  return int(K2_LAUNCH(float, kAdagrad));
#undef K2_LAUNCH
}
