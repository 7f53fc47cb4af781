// K3 stream_rows for Hopper (sm_90a): the table rows of every U-slot, the
// first half of the streamed embedding forward.
//
// Replaces the Pallas TPU kernel dlrm_tpu/ops/stream_kernels.py:
// stream_rows (_stream_rows_kernel). Same function on the same host-built
// U-layout inputs (dlrm_tpu_torch/ops/stream_plan.py), given the FULL item
// list (every block's chunks, the hit-free blocks' sentinel chunks and the
// cover items of the tail padding):
//
//   R_u[u, :] = mm(table[blk * block_rows + rows_u[u] - row0])  (fp32)
//               for the item (blk, row0, u0) whose block holds rows_u[u],
//   R_u[u, :] = 0 for sentinel slots (rows_u[u] == -1),
//
// where mm() rounds to bf16 when mm_bf16 is set (the TPU kernel casts the
// table block to mm_dtype before its one-hot matmul).
//
// What bounds it on this card: bytes. It writes every R_u row once (fp32)
// and reads each slot's table row once; the TPU kernel streamed the whole
// table block through VMEM and picked rows with a one-hot MXU matmul, which
// a GPU replaces by a direct row read.
//
// What the design does about the TPU kernel's reliance on grid order. On the
// TPU each item writes its whole 256-slot chunk, zeros included where a
// chunk overruns into the next block's run, and the next block's item,
// later in the sequential grid, overwrites them. Here the items run in
// parallel in no order, so an item writes ONLY
//   * the slots whose row lies in its own block (row0 <= r < row0 +
//     block_rows, real blocks only: the trailing pad block's cover items
//     own no row), and
//   * the sentinel slots, as 0.
// Each real slot then has exactly one writer (the blocks of one table own
// disjoint row ranges, and a real block's chunk never crosses its table's
// segment end), and the sentinel slots' writers all write 0. The full item
// list covers every slot, so every row of R_u is written; the output is
// allocated with torch.empty, and a missing write shows as garbage. An item
// equal to the one before it (the list's padding items) would repeat the
// same writes and returns at once.
//
// One CTA of 8 warps per item; warp w takes slots w*32 .. w*32+31 of the
// chunk, loads their rows with one coalesced 32-lane read, and copies each
// owned row with lane j taking 4 neighbouring columns.
//
// C interface for ctypes: k3_stream_rows returns cudaGetLastError().

#include "u_layout.cuh"

namespace {

using namespace ulayout;

static_assert(kThreads == kChunk, "one thread loads one slot's row id");

template <typename TW, bool MM_BF16>
__global__ void __launch_bounds__(kThreads)
    k3_kernel(const TW* __restrict__ table, const int* __restrict__ rows_u,
              const int* __restrict__ item_block,
              const int* __restrict__ item_row0,
              const int* __restrict__ item_u, float* __restrict__ r_u,
              int64_t u_total, int num_blocks, int block_rows, int d) {
  const int64_t it = blockIdx.x;
  const int blk = item_block[it];
  const int row0 = item_row0[it];
  const int u0 = item_u[it];
  if (it > 0 && item_block[it - 1] == blk && item_row0[it - 1] == row0 &&
      item_u[it - 1] == u0) {
    return;  // the same writes as the item before it
  }
  const bool real = blk >= 0 && blk < num_blocks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t base = int64_t(u0) + warp * 32;
  const int64_t mine = base + lane;
  // -2: a slot beyond U, which no item owns and nothing writes
  const int r_lane = (mine >= 0 && mine < u_total) ? rows_u[mine] : -2;
  for (int i = 0; i < 32; ++i) {
    const int r = __shfl_sync(kFull, r_lane, i);
    float* dst = r_u + (base + i) * d;
    if (r == kSentinel) {
      for (int c = lane * 4; c < d; c += 128) {
        *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else if (real && r >= 0 && r >= row0 && r - row0 < block_rows) {
      const TW* src = table + (int64_t(blk) * block_rows + (r - row0)) * d;
      for (int c = lane * 4; c < d; c += 128) {
        *reinterpret_cast<float4*>(dst + c) =
            mm_round4<MM_BF16>(load4(src + c));
      }
    }
  }
}

template <typename TW>
cudaError_t launch(const void* table, const int* rows_u,
                   const int* item_block, const int* item_row0,
                   const int* item_u, float* r_u, int64_t m_items,
                   int64_t u_total, int num_blocks, int block_rows, int d,
                   int mm_bf16, cudaStream_t st) {
  const TW* w = static_cast<const TW*>(table);
  const unsigned grid = unsigned(m_items);
  if (mm_bf16) {
    k3_kernel<TW, true><<<grid, kThreads, 0, st>>>(
        w, rows_u, item_block, item_row0, item_u, r_u, u_total, num_blocks,
        block_rows, d);
  } else {
    k3_kernel<TW, false><<<grid, kThreads, 0, st>>>(
        w, rows_u, item_block, item_row0, item_u, r_u, u_total, num_blocks,
        block_rows, d);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int k3_stream_rows(int table_bf16, const void* table,
                              const int* rows_u, const int* item_block,
                              const int* item_row0, const int* item_u,
                              float* r_u, int64_t m_items, int64_t u_total,
                              int num_blocks, int block_rows, int d,
                              int mm_bf16, void* stream) {
  if (d <= 0 || d % 4 != 0 || block_rows <= 0 || num_blocks < 0 ||
      m_items < 0 || m_items > 0x7fffffffLL || u_total < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (m_items == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      table_bf16
          ? launch<__nv_bfloat16>(table, rows_u, item_block, item_row0,
                                  item_u, r_u, m_items, u_total, num_blocks,
                                  block_rows, d, mm_bf16, st)
          : launch<float>(table, rows_u, item_block, item_row0, item_u, r_u,
                          m_items, u_total, num_blocks, block_rows, d,
                          mm_bf16, st);
  return int(e);
}
