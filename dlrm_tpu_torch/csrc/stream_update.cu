// K2 stream_update for Hopper (sm_90a): the streamed embedding-table update.
//
// Replaces the Pallas TPU kernel dlrm_tpu/ops/stream_kernels.py:
// stream_update (_sgd_kernel, _rowwise_adagrad_kernel, _adagrad_kernel with
// the shared _accumulate_gsum, _flags and _cast_out). Same function, same
// host-built U-layout inputs (dlrm_tpu_torch/ops/stream_plan.py):
//
//   for every table block b named by the work items:
//     Gsum[r] = sum of G_u[u] over the slots u of b's items whose
//               table-local row rows_u[u] lies in b's row range (fp32
//               sums; each G row rounded to bf16 first when mm_bf16 is set;
//               G_u is fp32, or bf16 when g_bf16 is set: the JAX step's
//               g_dtype)
//     sgd        W[r] -= lr * Gsum[r]
//     rwsadagrad acc[r] += sum_d(Gsum[r]^2) / d;
//                W[r] -= lr * Gsum[r] / (sqrt(acc[r]) + eps)
//     adagrad    acc[r] += Gsum[r]^2 (elementwise); W[r] -= the same
//   updating table and accumulator IN PLACE, with round-to-nearest or
//   stochastic rounding into a bf16 table.
//
// What bounds it on this card: bytes. Per hit it reads one G_u row (512 B
// in fp32 at d = 128, 256 B in bf16); per touched table row it reads and
// writes the row and its accumulator once. There is no matrix product: the
// TPU kernel's one-hot MXU matmuls only emulated a gather/scatter-add. The
// least time is those bytes over the memory rate.
//
// What the design does about it. The TPU walked the items in order on one
// core and carried Gsum [block_rows, d] in VMEM from item to item; a GPU has
// no such scratch across CTAs. The layout gives what replaces it: within a
// table the builder sorts the hits by row with a stable sort, so all hits of
// one table row sit in one contiguous run of U-slots, in slot order, and
// their G_u rows are contiguous in memory. So:
//   * one CTA of 8 warps per work item (256 slots), warp w taking slots
//     32w .. 32w+31; items of the trailing pad block exit at once;
//   * a warp loads its 32 rows_u with one coalesced read and marks a slot
//     as a run start when its row is real, lies in the item's block range,
//     and the slot before holds another row. Overrun chunks (another
//     block's hits) and sentinels fall out of the range test. Table-local
//     rows repeat across tables, but every table's U-segment ends in at
//     least one 256-slot chunk of sentinels (the plan's invariant that
//     keeps an item's overrun out of the next table, for the TPU kernel and
//     the plain version alike), so no run spans two tables;
//   * the warp holding a run's first slot owns the whole run and walks it to
//     its end, across its item's boundary if need be, 32 rows_u at a time.
//     Every touched row is read and written by exactly one warp: no atomics,
//     no shared memory, no Gsum buffer;
//   * each lane owns 4 neighbouring columns (per 128): a G row is one 16-byte
//     (fp32) or 8-byte (bf16) load per lane, up to 4 rows in flight before
//     the adds; the sum is taken in slot order from zero, the plain
//     version's order, so the kernel agrees with it to the bit. The table
//     row (and for rwsadagrad acc[r], for adagrad the accumulator row) is
//     loaded before the G rows, so its latency hides behind theirs;
//   * the epilogue's arithmetic is that of the TPU kernel in IEEE single
//     operations (__f*_rn, sqrtf); rwsadagrad's row sum of squares is a
//     lane partial over the lane's columns in order, then an xor butterfly
//     (ops/stream_kernels.py::_warp_sum repeats it).
// A long run (one very popular row) is summed serially by its one warp: a
// row with 20,000 hits reads 10 MB through one warp. That keeps the sum
// deterministic; chip_smoke.py times such a case.
//
// Only rows that received a hit are updated: for the others the update is
// an exact no-op in all three optimizers, also under stochastic rounding (a
// bf16 value's low 16 bits are zero, so no carry).
//
// Stochastic rounding adds 16 pseudo-random low bits to the fp32 pattern
// and truncates (FBGEMM's scheme, as _cast_out). The TPU's PRNG cannot be
// replayed, so the bits come from a counter-based hash of (seed, global
// row, column) (k2::hash32); dlrm_tpu_torch/ops/stream_kernels.py computes
// the same hash in torch integer ops for the plain version.
//
// The G row type is a template parameter (fp32 or bf16: TW x TG x OPT x NV,
// 36 instances). C interface for ctypes: k2_stream_update returns
// cudaGetLastError().

#include "k2_update.cuh"  // hash32
#include "u_layout.cuh"

namespace {

using namespace ulayout;
static_assert(kThreads == kChunk, "one thread per slot of an item");

enum Opt { kSgd = 0, kRowwiseAdagrad = 1, kAdagrad = 2 };

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The 4 updated elements of one lane into the table row: fp32 as is, bf16
// rounded to nearest or stochastically with the hash of (row, column).
__device__ __forceinline__ void store4(float* p, float4 v, int, uint32_t,
                                       int) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ unsigned short to_bf16_bits(float v, int sr,
                                                       uint32_t row_key,
                                                       int c) {
  if (sr) {  // add 16 random bits below the bf16 mantissa, then truncate
    const uint32_t bits = k2::hash32(row_key ^ static_cast<uint32_t>(c)) >> 16;
    return static_cast<unsigned short>((__float_as_uint(v) + bits) >> 16);
  }
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, int sr,
                                       uint32_t row_key, int c) {
  const uint32_t lo = to_bf16_bits(v.x, sr, row_key, c) |
                      uint32_t(to_bf16_bits(v.y, sr, row_key, c + 1)) << 16;
  const uint32_t hi = to_bf16_bits(v.z, sr, row_key, c + 2) |
                      uint32_t(to_bf16_bits(v.w, sr, row_key, c + 3)) << 16;
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

// NV: 4-column groups per lane (d <= 128 * NV); UNROLL: G rows in flight.
template <typename TW, typename TG, int OPT, int NV>
__global__ void __launch_bounds__(kThreads, 4)
    k2_kernel(TW* __restrict__ table, float* __restrict__ acc,
              const TG* __restrict__ g_u, const int* __restrict__ rows_u,
              const int* __restrict__ item_block,
              const int* __restrict__ item_row0,
              const int* __restrict__ item_u, int64_t u_total,
              int num_blocks, int block_rows, int d, float lr, float eps,
              uint32_t seed_hash, int mm_bf16, int sr) {
  constexpr int UNROLL = NV == 1 ? 4 : (NV == 2 ? 2 : 1);
  const int64_t it = blockIdx.x;
  const int blk = item_block[it];
  if (blk < 0 || blk >= num_blocks) return;  // the pad block: a no-op
  const int row0 = item_row0[it];
  const int lane = threadIdx.x & 31;
  const int64_t s0 = int64_t(item_u[it]) + (threadIdx.x & ~31);
  const int64_t s = s0 + lane;

  const int r = (s >= 0 && s < u_total) ? rows_u[s] : kSentinel;
  int r_prev = __shfl_up_sync(kFull, r, 1);
  if (lane == 0) r_prev = (s > 0 && s <= u_total) ? rows_u[s - 1] : kSentinel;
  const bool cont = r != kSentinel && r == r_prev;  // r_prev: slot s - 1
  const bool start = r != kSentinel &&
                     static_cast<unsigned>(r - row0) <
                         static_cast<unsigned>(block_rows) &&
                     !cont;
  unsigned starts = __ballot_sync(kFull, start);
  const unsigned breaks = __ballot_sync(kFull, !cont);

  while (starts) {  // the runs this warp owns, one after another
    const int a = __ffs(starts) - 1;
    starts &= starts - 1;
    const int row = __shfl_sync(kFull, r, a);
    const int64_t grow = int64_t(blk) * block_rows + (row - row0);
    TW* w_row = table + grow * d;

    // the row's own operands first: their loads overlap the G reads
    float4 w[NV], av[NV], g[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * 128 + lane * 4;
      g[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < d) {
        w[v] = load4(w_row + c);
        if (OPT == kAdagrad) av[v] = load4(acc + grow * d + c);
      }
    }
    float acc_row = 0.f;
    if (OPT == kRowwiseAdagrad) acc_row = acc[grow];

    // the run: slots [u, u + left) in this piece; `open` while the run may
    // go on past the piece
    const unsigned later = breaks & ~((2u << a) - 1u);
    int64_t u = s0 + a;
    int left = later ? __ffs(later) - 1 - a : 32 - a;
    bool open = later == 0;
    while (true) {
      for (; left > 0; left -= UNROLL, u += UNROLL) {
        float4 x[UNROLL][NV];
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = v * 128 + lane * 4;
            if (i < left && c < d) x[i][v] = load4(g_u + (u + i) * d + c);
          }
        }
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = v * 128 + lane * 4;
            if (i < left && c < d) {
              g[v] = add4(g[v], mm_bf16 ? mm_round4<true>(x[i][v]) : x[i][v]);
            }
          }
        }
      }
      if (left < 0) u += left;  // the last group was short
      if (!open) break;
      // walk on: the next 32 slots, up to the first that does not continue
      const int64_t p = u + lane;
      const bool more = p < u_total && rows_u[p] == row;
      const unsigned stop = __ballot_sync(kFull, !more);
      left = stop ? __ffs(stop) - 1 : 32;
      open = stop == 0;
      if (left == 0) break;
    }

    // the update
    float denom_row = 0.f;
    if (OPT == kRowwiseAdagrad) {
      float ss = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v * 128 + lane * 4 < d) {
          ss = __fadd_rn(ss, __fmul_rn(g[v].x, g[v].x));
          ss = __fadd_rn(ss, __fmul_rn(g[v].y, g[v].y));
          ss = __fadd_rn(ss, __fmul_rn(g[v].z, g[v].z));
          ss = __fadd_rn(ss, __fmul_rn(g[v].w, g[v].w));
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
      }
      const float new_acc = __fadd_rn(acc_row, __fdiv_rn(ss, float(d)));
      denom_row = __fadd_rn(sqrtf(new_acc), eps);
      if (lane == 0) acc[grow] = new_acc;
    }
    const uint32_t row_key = k2::hash32(static_cast<uint32_t>(grow) ^ seed_hash);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * 128 + lane * 4;
      if (c >= d) continue;
      const float gs[4] = {g[v].x, g[v].y, g[v].z, g[v].w};
      const float ws[4] = {w[v].x, w[v].y, w[v].z, w[v].w};
      float as[4] = {0.f, 0.f, 0.f, 0.f};
      if (OPT == kAdagrad) {
        as[0] = av[v].x; as[1] = av[v].y; as[2] = av[v].z; as[3] = av[v].w;
      }
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float step;
        if (OPT == kSgd) {
          step = __fmul_rn(lr, gs[q]);
        } else if (OPT == kRowwiseAdagrad) {
          step = __fdiv_rn(__fmul_rn(lr, gs[q]), denom_row);
        } else {
          as[q] = __fadd_rn(as[q], __fmul_rn(gs[q], gs[q]));
          step = __fdiv_rn(__fmul_rn(lr, gs[q]), __fadd_rn(sqrtf(as[q]), eps));
        }
        out[q] = __fsub_rn(ws[q], step);
      }
      if (OPT == kAdagrad) {
        *reinterpret_cast<float4*>(acc + grow * d + c) =
            make_float4(as[0], as[1], as[2], as[3]);
      }
      store4(w_row + c, make_float4(out[0], out[1], out[2], out[3]), sr,
             row_key, c);
    }
  }
}

template <typename TW, typename TG, int OPT, int NV>
cudaError_t launch(void* table, float* acc, const void* g_u,
                   const int* rows_u, const int* item_block,
                   const int* item_row0, const int* item_u, int64_t m_items,
                   int64_t u_total, int num_blocks, int block_rows, int d,
                   float lr, float eps, uint32_t seed_hash, int mm_bf16,
                   int sr, cudaStream_t st) {
  k2_kernel<TW, TG, OPT, NV><<<unsigned(m_items), kThreads, 0, st>>>(
      static_cast<TW*>(table), acc, static_cast<const TG*>(g_u), rows_u,
      item_block, item_row0, item_u, u_total, num_blocks, block_rows, d, lr,
      eps, seed_hash, mm_bf16, sr);
  return cudaGetLastError();
}

template <typename TW, typename TG, int OPT>
cudaError_t launch_nv(int nv, void* table, float* acc, const void* g_u,
                      const int* rows_u, const int* item_block,
                      const int* item_row0,
                      const int* item_u, int64_t m_items, int64_t u_total,
                      int num_blocks, int block_rows, int d, float lr,
                      float eps, uint32_t seed_hash, int mm_bf16, int sr,
                      cudaStream_t st) {
#define K2_LAUNCH(NV)                                                        \
  launch<TW, TG, OPT, NV>(table, acc, g_u, rows_u, item_block, item_row0,    \
                          item_u, m_items, u_total, num_blocks, block_rows,  \
                          d, lr, eps, seed_hash, mm_bf16, sr, st)
  if (nv == 1) return K2_LAUNCH(1);
  if (nv == 2) return K2_LAUNCH(2);
  return K2_LAUNCH(4);
#undef K2_LAUNCH
}

}  // namespace

extern "C" int k2_stream_update(
    int opt, int table_bf16, int g_bf16, void* table, void* acc,
    const void* g_u, const int* rows_u, const int* item_block,
    const int* item_row0, const int* item_u, int64_t m_items,
    int64_t u_total, int num_blocks, int block_rows, int d, float lr,
    float eps, uint32_t seed, int mm_bf16, int sr, void* stream) {
  if (opt != kSgd && opt != kRowwiseAdagrad && opt != kAdagrad) {
    return int(cudaErrorInvalidValue);
  }
  if (opt != kSgd && acc == nullptr) return int(cudaErrorInvalidValue);
  if (d <= 0 || d % 4 != 0 || d > 512 || block_rows <= 0 || num_blocks < 0 ||
      m_items < 0 || m_items > 0x7fffffffLL || u_total < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (m_items == 0 || num_blocks == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = d <= 128 ? 1 : (d <= 256 ? 2 : 4);
  const uint32_t seed_hash = k2::hash32(seed);
  float* accf = static_cast<float*>(acc);
#define K2_OPT(TW, TG, OPT)                                                  \
  launch_nv<TW, TG, OPT>(nv, table, accf, g_u, rows_u, item_block,           \
                         item_row0, item_u, m_items, u_total, num_blocks,    \
                         block_rows, d, lr, eps, seed_hash, mm_bf16, sr, st)
#define K2_OPTS(TW, TG)                                                      \
  (opt == kSgd ? K2_OPT(TW, TG, kSgd)                                        \
   : opt == kRowwiseAdagrad ? K2_OPT(TW, TG, kRowwiseAdagrad)                \
                            : K2_OPT(TW, TG, kAdagrad))
  cudaError_t e;
  if (table_bf16) {
    e = g_bf16 ? K2_OPTS(__nv_bfloat16, __nv_bfloat16)
               : K2_OPTS(__nv_bfloat16, float);
  } else {
    e = g_bf16 ? K2_OPTS(float, __nv_bfloat16) : K2_OPTS(float, float);
  }
#undef K2_OPTS
#undef K2_OPT
  return int(e);
}
