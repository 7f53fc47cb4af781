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
// The order of each row's sum, with C = kRunChunk = 512 and the row's hits
// at slots h .. h+L-1 (one run: see below):
//   L <= C: ((0 + G_h) + G_{h+1}) + ...                    in slot order
//   L >  C: chunk c covers slots h + cC .. min(h + (c+1)C, h + L) - 1,
//           P_c = its slot-order sum from zero, and
//           Gsum = ((0 + P_0) + P_1) + ...                  in chunk order
// (coalesce_rows.cu's order; C = 512 as there: runs of up to 512 hits keep
// the plain slot-order bits, and a hot row's chunks are few to add in
// order). ops/stream_kernels.py::stream_update_plain takes the same order,
// so the two agree to the bit.
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
// their G_u rows are contiguous in memory. Four launches on the caller's
// stream:
//   0. k2_kernel_clear marks every entry of the long runs' chunk table
//      empty (-1).
//   1. k2_kernel, the runs of <= C hits: one CTA of 8 warps per work item
//      (256 slots), warp w taking slots 32w .. 32w+31; items of the
//      trailing pad block exit at once.
//      * a warp loads its 32 rows_u with one coalesced read and marks a
//        slot as a run start when its row is real, lies in the item's block
//        range, and the slot before holds another row. Overrun chunks
//        (another block's hits) and sentinels fall out of the range test.
//        Table-local rows repeat across tables, but every table's U-segment
//        ends in at least kProbe = 256 slots of sentinels (the plan's
//        invariant that keeps an item's overrun out of the next table), so
//        no run spans two tables;
//      * with the same round of loads each lane reads the row C = 2 kProbe
//        slots on, and a start whose row is found there reads the one
//        kProbe on. A start whose row is found at both is a run of more
//        than C hits: a sentinel tail of >= kProbe slots cannot lie between
//        probes kProbe apart, so both probes are inside this table's
//        segment, where a row's hits are one run. (The probe at h + C alone
//        could land in the next table, on the same local row.) Such a run
//        is left to passes 2-3 (below);
//      * the warp holding a short run's first slot owns the whole run and
//        walks it to its end, across its item's boundary if need be, 32
//        rows_u at a time. Every touched row is read and written by exactly
//        one warp: no atomics, no Gsum buffer;
//      * each lane owns 4 neighbouring columns (per 128): a G row is one
//        16-byte (fp32) or 8-byte (bf16) load per lane, up to 4 rows in
//        flight before the adds. The table row (and for rwsadagrad acc[r],
//        for adagrad the accumulator row) is loaded before the G rows, so
//        its latency hides behind theirs;
//      * the owner of a long run finds its end by probes kProbe apart (128
//        a round, 32 KB of slots; the first probe off the row brackets the
//        end, by the same sentinel-tail argument) and a scan of the 256
//        slots before it, then writes the run's length, block and row by
//        the C-window of its start h (at most one run of > C hits starts
//        in a window of C slots) and its start into the chunk table at each
//        chunk head k = h + cC: entry 2 (k / C) + (h > (k / C) C), as
//        coalesce_rows places its partials (a window holds the chunk heads
//        of at most two long runs: the one that holds its first slot and
//        one that starts inside it). No count of long runs, no atomics.
//   2. k2_kernel_chunks: a warp per chunk-table entry; an entry that holds
//      a start sums its chunk's <= C contiguous G rows in slot order, 12
//      fp32 or 8 bf16 rows in flight (at d 128), into its row of the fp32
//      partials. A hot
//      row's 500 chunks run on 500 warps at once, where one warp walked
//      them all before: a row with 260,000 hits read 130 MB through one
//      warp (46 ms in the pareto cell; the pass now streams its 1.08 GB in
//      0.38 ms, 85 % of the byte rate).
//   3. k2_kernel_combine: a warp per C-window; where a long run starts in
//      it, the warp adds the run's ceil(L / C) partials in chunk order and
//      applies the update, the same epilogue code as pass 1.
// The epilogue's arithmetic is that of the TPU kernel in IEEE single
// operations (__f*_rn, sqrtf); rwsadagrad's row sum of squares is a lane
// partial over the lane's columns in order, then an xor butterfly
// (ops/stream_kernels.py::_warp_sum repeats it). Every kernel's name holds
// "k2_kernel", which the benchmark's trace reader sums as K2's time.
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
// 36 instances of pass 1). C interface for ctypes: k2_stream_update returns
// cudaGetLastError(), and k2_chunk() returns C for the wrapper to check
// against its own (it sizes the scratch: 5 ceil(u_total / C) int32 and
// 2 ceil(u_total / C) fp32 rows of d).

#include "k2_update.cuh"  // hash32
#include "u_layout.cuh"

namespace {

using namespace ulayout;
static_assert(kThreads == kChunk, "one thread per slot of an item");

constexpr int kRunChunk = 512;  // C: a longer run is summed in chunks of C
constexpr int kProbe = kChunk;  // the least sentinel tail of a U-segment
static_assert(kRunChunk == 2 * kProbe, "the long-run test probes C/2 apart");

enum Opt { kSgd = 0, kRowwiseAdagrad = 1, kAdagrad = 2 };

// The long runs' scratch, in C-windows of U (nwin = ceil(u_total / C)).
struct LongRuns {
  int* chunk_s;  // [2 nwin] the start of the run whose chunk an entry heads
  int* len;      // [nwin] by the window of a long run's start: its hits,
  int* blk;      //        its global block
  int* row;      //        and its row within the block
  float* part;   // [2 nwin, d] each chunk's fp32 sum, by its entry
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ int64_t warp_id() {
  return (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
}

__device__ __forceinline__ int64_t warp_stride() {
  return int64_t(gridDim.x) * blockDim.x / 32;
}

// the chunk-table entry of the chunk headed by slot k of a run starting at s
__device__ __forceinline__ int64_t chunk_entry(int64_t k, int64_t s) {
  const int64_t m = k / kRunChunk;
  return 2 * m + (s > m * kRunChunk ? 1 : 0);
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

// g += the rows row(0) .. row(n-1) in order, each rounded to bf16 first
// when mm_bf16; each lane its 4 columns per 128, UNROLL rows in flight
template <int NV, int UNROLL, typename Row>
__device__ __forceinline__ void add_rows(float4 (&g)[NV], Row row, int n,
                                         int d, int mm_bf16) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < n; i0 += UNROLL) {
    float4 x[UNROLL][NV];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = v * 128 + lane * 4;
        if (i0 + i < n && c < d) x[i][v] = load4(row(i0 + i) + c);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = v * 128 + lane * 4;
        if (i0 + i < n && c < d) {
          g[v] = add4(g[v], mm_bf16 ? mm_round4<true>(x[i][v]) : x[i][v]);
        }
      }
    }
  }
}

// A touched row's own operands: the table row, and the accumulator's.
template <int OPT, int NV>
struct RowState {
  float4 w[NV], av[NV];
  float acc_row;
};

template <typename TW, int OPT, int NV>
__device__ __forceinline__ void load_row(RowState<OPT, NV>& st,
                                         const TW* __restrict__ table,
                                         const float* __restrict__ acc,
                                         int64_t grow, int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * 128 + lane * 4;
    if (c < d) {
      st.w[v] = load4(table + grow * d + c);
      if (OPT == kAdagrad) st.av[v] = load4(acc + grow * d + c);
    }
  }
  st.acc_row = OPT == kRowwiseAdagrad ? acc[grow] : 0.f;
}

// The update of row grow from its Gsum g (the warp's lanes together).
template <typename TW, int OPT, int NV>
__device__ __forceinline__ void update_row(const RowState<OPT, NV>& st,
                                           const float4 (&g)[NV],
                                           TW* __restrict__ table,
                                           float* __restrict__ acc,
                                           int64_t grow, int d, float lr,
                                           float eps, uint32_t seed_hash,
                                           int sr) {
  const int lane = threadIdx.x & 31;
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
    const float new_acc = __fadd_rn(st.acc_row, __fdiv_rn(ss, float(d)));
    denom_row = __fadd_rn(sqrtf(new_acc), eps);
    if (lane == 0) acc[grow] = new_acc;
  }
  const uint32_t row_key = k2::hash32(static_cast<uint32_t>(grow) ^ seed_hash);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * 128 + lane * 4;
    if (c >= d) continue;
    const float gs[4] = {g[v].x, g[v].y, g[v].z, g[v].w};
    const float ws[4] = {st.w[v].x, st.w[v].y, st.w[v].z, st.w[v].w};
    float as[4] = {0.f, 0.f, 0.f, 0.f};
    if (OPT == kAdagrad) {
      as[0] = st.av[v].x; as[1] = st.av[v].y;
      as[2] = st.av[v].z; as[3] = st.av[v].w;
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
    store4(table + grow * d + c, make_float4(out[0], out[1], out[2], out[3]),
           sr, row_key, c);
  }
}

// The first slot past h (h's run holds at least h .. h + C) whose row is
// not `row`, for the whole warp: probes kProbe apart, 128 a round, then the
// kProbe slots up to the first probe off the row.
__device__ __forceinline__ int64_t run_end(const int* __restrict__ rows_u,
                                           int64_t u_total, int64_t h,
                                           int row) {
  const int lane = threadIdx.x & 31;
  auto off = [&](int64_t p) { return p >= u_total || rows_u[p] != row; };
  int64_t base = h + kRunChunk;  // in the run
  int j = -1;  // the first probe base + kProbe (1 + j) off the row
  while (j < 0) {
    bool out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[q] = off(base + int64_t(kProbe) * (1 + lane + 32 * q));
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      const unsigned b = __ballot_sync(kFull, out[q]);
      if (b) j = 32 * q + __ffs(b) - 1;
    }
    if (j < 0) base += int64_t(kProbe) * 128;
  }
  base += int64_t(kProbe) * j;  // in the run; the end is in (base, base + kProbe]
  bool out[kProbe / 32];
#pragma unroll
  for (int t = 0; t < kProbe / 32; ++t) out[t] = off(base + 1 + 32 * t + lane);
  int64_t end = base + kProbe;
#pragma unroll
  for (int t = kProbe / 32 - 1; t >= 0; --t) {
    const unsigned b = __ballot_sync(kFull, out[t]);
    if (b) end = base + 1 + 32 * t + __ffs(b) - 1;
  }
  return end;
}

__global__ void __launch_bounds__(kThreads)
    k2_kernel_clear(int* __restrict__ chunk_s, int64_t entries) {
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       e < entries; e += int64_t(gridDim.x) * blockDim.x)
    chunk_s[e] = -1;
}

// NV: 4-column groups per lane (d <= 128 * NV); UNROLL: G rows in flight.
// Five blocks an SM at d <= 128 (51 registers; at four the uniform cell's
// K2 took 14 % longer, with fewer warps in flight; at six it spilled).
template <typename TW, typename TG, int OPT, int NV>
__global__ void __launch_bounds__(kThreads, NV == 1 ? 5 : 4)
    k2_kernel(TW* __restrict__ table, float* __restrict__ acc,
              const TG* __restrict__ g_u, const int* __restrict__ rows_u,
              const int* __restrict__ item_block,
              const int* __restrict__ item_row0,
              const int* __restrict__ item_u, int64_t u_total,
              int num_blocks, int block_rows, int d, float lr, float eps,
              uint32_t seed_hash, int mm_bf16, int sr, LongRuns runs) {
  constexpr int UNROLL = NV == 1 ? 4 : (NV == 2 ? 2 : 1);
  const int64_t it = blockIdx.x;
  const int blk = item_block[it];
  if (blk < 0 || blk >= num_blocks) return;  // the pad block: a no-op
  const int row0 = item_row0[it];
  const int lane = threadIdx.x & 31;
  const int64_t s0 = int64_t(item_u[it]) + (threadIdx.x & ~31);
  const int64_t s = s0 + lane;

  auto row_at = [&](int64_t p) {
    return (p >= 0 && p < u_total) ? rows_u[p] : kSentinel;
  };
  const int r = row_at(s);
  const int r2 = row_at(s + 2 * kProbe);
  int r_prev = __shfl_up_sync(kFull, r, 1);
  if (lane == 0) r_prev = row_at(s - 1);
  const bool cont = r != kSentinel && r == r_prev;  // r_prev: slot s - 1
  const bool start = r != kSentinel &&
                     static_cast<unsigned>(r - row0) <
                         static_cast<unsigned>(block_rows) &&
                     !cont;
  const bool is_long = start && r2 == r && row_at(s + kProbe) == r;
  unsigned starts = __ballot_sync(kFull, start && !is_long);
  unsigned longs = __ballot_sync(kFull, is_long);
  const unsigned breaks = __ballot_sync(kFull, !cont);

  while (longs) {  // the runs of more than C hits this warp heads
    const int a = __ffs(longs) - 1;
    longs &= longs - 1;
    const int row = __shfl_sync(kFull, r, a);
    const int64_t h = s0 + a;
    const int64_t len = run_end(rows_u, u_total, h, row) - h;
    const int64_t m = h / kRunChunk;
    if (lane == 0) {
      runs.len[m] = int(len);
      runs.blk[m] = blk;
      runs.row[m] = row - row0;
    }
    for (int64_t c = lane; c * kRunChunk < len; c += 32)
      runs.chunk_s[chunk_entry(h + c * kRunChunk, h)] = int(h);
  }

  while (starts) {  // the runs of <= C hits this warp owns, one by one
    const int a = __ffs(starts) - 1;
    starts &= starts - 1;
    const int row = __shfl_sync(kFull, r, a);
    const int64_t grow = int64_t(blk) * block_rows + (row - row0);

    // the row's own operands first: their loads overlap the G reads
    RowState<OPT, NV> st;
    load_row<TW, OPT, NV>(st, table, acc, grow, d);
    float4 g[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) g[v] = make_float4(0.f, 0.f, 0.f, 0.f);

    // the run: slots [u, u + left) in this piece; `open` while the run may
    // go on past the piece
    const unsigned later = breaks & ~((2u << a) - 1u);
    int64_t u = s0 + a;
    int left = later ? __ffs(later) - 1 - a : 32 - a;
    bool open = later == 0;
    while (true) {
      add_rows<NV, UNROLL>(
          g, [&](int i) { return g_u + (u + i) * d; }, left, d, mm_bf16);
      u += left;
      if (!open) break;
      // walk on: the next 32 slots, up to the first that does not continue
      const int64_t p = u + lane;
      const bool more = p < u_total && rows_u[p] == row;
      const unsigned stop = __ballot_sync(kFull, !more);
      left = stop ? __ffs(stop) - 1 : 32;
      open = stop == 0;
      if (left == 0) break;
    }
    update_row<TW, OPT, NV>(st, g, table, acc, grow, d, lr, eps, seed_hash,
                            sr);
  }
}

// Two blocks an SM, 12 fp32 or 8 bf16 rows in flight a warp at d <= 128
// (16 rows at one block an SM took 40 % longer on the pareto cell's batch,
// and 12 bf16 rows twice as long as 8).
template <typename TG, int NV>
__global__ void __launch_bounds__(kThreads, 2)
    k2_kernel_chunks(const TG* __restrict__ g_u, const int* __restrict__ chunk_s,
                     const int* __restrict__ run_len,
                     float* __restrict__ part, int64_t entries, int d,
                     int mm_bf16) {
  constexpr int UNROLL = (sizeof(TG) == 4 ? 12 : 8) / NV;
  const int lane = threadIdx.x & 31;
  for (int64_t e = warp_id(); e < entries; e += warp_stride()) {
    const int64_t s = chunk_s[e];
    if (s < 0) continue;
    const int64_t w0 = (e / 2) * kRunChunk;  // the entry's window
    const int64_t k =  // the chunk head in the window
        s >= w0 ? s : s + (w0 - s + kRunChunk - 1) / kRunChunk * kRunChunk;
    const int64_t left = s + run_len[s / kRunChunk] - k;
    float4 g[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) g[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    add_rows<NV, UNROLL>(
        g, [&](int i) { return g_u + (k + i) * d; },
        int(left < kRunChunk ? left : kRunChunk), d, mm_bf16);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * 128 + lane * 4;
      if (c < d) *reinterpret_cast<float4*>(part + e * d + c) = g[v];
    }
  }
}

template <typename TW, int OPT, int NV>
__global__ void __launch_bounds__(kThreads)
    k2_kernel_combine(TW* __restrict__ table, float* __restrict__ acc,
                      LongRuns runs, int64_t windows, int block_rows, int d,
                      float lr, float eps, uint32_t seed_hash, int sr) {
  constexpr int UNROLL = 16 / NV;
  for (int64_t m = warp_id(); m < windows; m += warp_stride()) {
    // a long run starts at the window's first slot (entry 2m) or inside
    // it (entry 2m + 1), or none does
    const int64_t inside = runs.chunk_s[2 * m + 1];
    const int64_t s = inside >= 0 ? inside
                      : runs.chunk_s[2 * m] == m * kRunChunk ? m * kRunChunk
                                                             : -1;
    if (s < 0) continue;
    const int64_t grow = int64_t(runs.blk[m]) * block_rows + runs.row[m];
    RowState<OPT, NV> st;
    load_row<TW, OPT, NV>(st, table, acc, grow, d);
    float4 g[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) g[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* part = runs.part;
    add_rows<NV, UNROLL>(
        g,
        [&](int c) {
          return part + chunk_entry(s + int64_t(c) * kRunChunk, s) * d;
        },
        (runs.len[m] + kRunChunk - 1) / kRunChunk, d, 0);
    update_row<TW, OPT, NV>(st, g, table, acc, grow, d, lr, eps, seed_hash,
                            sr);
  }
}

unsigned warp_blocks(int64_t warps) {
  const int64_t want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  return unsigned(want > 0 ? want : 1);
}

template <typename TW, typename TG, int OPT, int NV>
cudaError_t launch(void* table, float* acc, const void* g_u,
                   const int* rows_u, const int* item_block,
                   const int* item_row0, const int* item_u, int64_t m_items,
                   int64_t u_total, int num_blocks, int block_rows, int d,
                   float lr, float eps, uint32_t seed_hash, int mm_bf16,
                   int sr, LongRuns runs, cudaStream_t st) {
  const int64_t windows = (u_total + kRunChunk - 1) / kRunChunk;
  TW* tw = static_cast<TW*>(table);
  k2_kernel_clear<<<unsigned((2 * windows + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>(runs.chunk_s, 2 * windows);
  k2_kernel<TW, TG, OPT, NV><<<unsigned(m_items), kThreads, 0, st>>>(
      tw, acc, static_cast<const TG*>(g_u), rows_u, item_block, item_row0,
      item_u, u_total, num_blocks, block_rows, d, lr, eps, seed_hash,
      mm_bf16, sr, runs);
  k2_kernel_chunks<TG, NV><<<warp_blocks(2 * windows), kThreads, 0, st>>>(
      static_cast<const TG*>(g_u), runs.chunk_s, runs.len, runs.part,
      2 * windows, d, mm_bf16);
  k2_kernel_combine<TW, OPT, NV><<<warp_blocks(windows), kThreads, 0, st>>>(
      tw, acc, runs, windows, block_rows, d, lr, eps, seed_hash, sr);
  return cudaGetLastError();
}

template <typename TW, typename TG, int OPT>
cudaError_t launch_nv(int nv, void* table, float* acc, const void* g_u,
                      const int* rows_u, const int* item_block,
                      const int* item_row0,
                      const int* item_u, int64_t m_items, int64_t u_total,
                      int num_blocks, int block_rows, int d, float lr,
                      float eps, uint32_t seed_hash, int mm_bf16, int sr,
                      LongRuns runs, cudaStream_t st) {
#define K2_LAUNCH(NV)                                                        \
  launch<TW, TG, OPT, NV>(table, acc, g_u, rows_u, item_block, item_row0,    \
                          item_u, m_items, u_total, num_blocks, block_rows,  \
                          d, lr, eps, seed_hash, mm_bf16, sr, runs, st)
  if (nv == 1) return K2_LAUNCH(1);
  if (nv == 2) return K2_LAUNCH(2);
  return K2_LAUNCH(4);
#undef K2_LAUNCH
}

}  // namespace

extern "C" int k2_chunk() { return kRunChunk; }

// scratch: runs_i [5 ceil(u_total / C)] int32, part [2 ceil(u_total / C), d]
// f32, both contiguous
extern "C" int k2_stream_update(
    int opt, int table_bf16, int g_bf16, void* table, void* acc,
    const void* g_u, const int* rows_u, const int* item_block,
    const int* item_row0, const int* item_u, int64_t m_items,
    int64_t u_total, int num_blocks, int block_rows, int d, float lr,
    float eps, uint32_t seed, int mm_bf16, int sr, int* runs_i, float* part,
    void* stream) {
  if (opt != kSgd && opt != kRowwiseAdagrad && opt != kAdagrad) {
    return int(cudaErrorInvalidValue);
  }
  if (opt != kSgd && acc == nullptr) return int(cudaErrorInvalidValue);
  if (d <= 0 || d % 4 != 0 || d > 512 || block_rows <= 0 || num_blocks < 0 ||
      m_items < 0 || m_items > 0x7fffffffLL || u_total < 0 ||
      u_total > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  if (m_items == 0 || num_blocks == 0 || u_total == 0) {
    return int(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = d <= 128 ? 1 : (d <= 256 ? 2 : 4);
  const uint32_t seed_hash = k2::hash32(seed);
  float* accf = static_cast<float*>(acc);
  const int64_t windows = (u_total + kRunChunk - 1) / kRunChunk;
  const LongRuns runs{runs_i, runs_i + 2 * windows, runs_i + 3 * windows,
                      runs_i + 4 * windows, part};
#define K2_OPT(TW, TG, OPT)                                                  \
  launch_nv<TW, TG, OPT>(nv, table, accf, g_u, rows_u, item_block,           \
                         item_row0, item_u, m_items, u_total, num_blocks,    \
                         block_rows, d, lr, eps, seed_hash, mm_bf16, sr,     \
                         runs, st)
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
