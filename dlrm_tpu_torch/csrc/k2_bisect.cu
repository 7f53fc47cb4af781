// P3 k2_bisect for Hopper (sm_90a): K2's sgd update on an fp32 table with
// its stages compiled in or out, to show which stage costs the time.
//
// Replaces the Pallas TPU probe bench_scripts/k2_bisect.py (run_variant's
// make_sgd_kernel, V1-V4, and run_variant_manual's make_sgd_manual_out,
// V5-V6). The TPU variants switched its DMAs, its one-hot matmuls and its
// write (conditional at the block's last item or at every grid step; the
// pipeline's blocked output or a manual DMA). The port's K2 has other
// stages, so the variants are K2's first Hopper design (k2_update.cuh, a
// CTA per 128-row tile) with its stages switched:
//
//   V1  full update, writing only rows that got a hit: K2's bits (sgd,
//       fp32; both sum each row's hits in slot order from zero)
//   V2  full update, writing every row of each visited 128-row tile
//   V3  skeleton: no G row read, no sums; scans rows_u for the hit rows and
//       writes only those
//   V4  skeleton writing every row of each visited tile, no scan: the
//       revolve floor (read and write each visited tile once)
//   V5  V4 with the tile staged in shared memory and stored by one
//       cp.async.bulk shared -> global copy (the TPU's "manual out")
//   V6  V2 with the same bulk store
//
// Values: V1, V2, V5 and V6 give sgd's W[r] -= lr * Gsum[r] (a row with no
// hit is rewritten unchanged); the skeletons zero Gsum, so the table keeps
// its values bit for bit. (The TPU skeletons left their Gsum scratch
// uninitialised and wrote whatever it held: a probe's shortcut, not a
// result to reproduce.)
//
// What bounds it: bytes, as K2. V4 reads and writes each visited tile
// once; V1 reads each hit's G row and reads and writes each touched row.
//
// C interface for ctypes: k2_bisect returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "k2_update.cuh"

extern "C" int k2_bisect(int variant, float* table, const float* g_u,
                         const int* rows_u, const int* item_block,
                         const int* item_row0, const int* item_u,
                         int* block_first,  // [num_blocks] scratch
                         int* block_last,   // [num_blocks] scratch
                         int64_t m_items, int64_t u_total, int num_blocks,
                         int block_rows, int d, float lr, void* stream) {
  using namespace k2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant < 1 || variant > 6) return int(cudaErrorInvalidValue);
  bool empty = false;
  cudaError_t e = find_block_ranges(item_block, m_items, num_blocks,
                                    block_rows, d, block_first, block_last,
                                    st, &empty);
  if (e != cudaSuccess || empty) return int(e);
#define K2_VARIANT(SUM, ALL_ROWS, BULK)                                     \
  launch_update<float, kSgd, SUM, ALL_ROWS, BULK>(                          \
      table, nullptr, g_u, rows_u, item_row0, item_u, block_first,          \
      block_last, num_blocks, block_rows, d, u_total, lr, 0.f, 0u, 0, 0, st)
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
