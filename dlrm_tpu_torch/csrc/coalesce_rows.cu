// Coalesce the row-sorted hits of a batch into one gradient row per touched
// table row, for Hopper (sm_90a): the segmented sum of the fused train
// step's sparse update (dlrm_tpu_torch/ops/sparse_update.py).
//
// It has no Pallas counterpart: dlrm_tpu/ops/sparse_update.py: coalesce_hits
// and coalesce leave this sum to XLA (a take, then jax.ops.segment_sum with
// indices_are_sorted=True). On the card an index_add_ would add each row's
// hits with atomics, in an order that changes from run to run; this kernel
// adds them in a fixed order, so that every run gives the same bits, and
// gathers and weighs each hit's cotangent row on the way, so that the [n, d]
// per-hit rows are never written out.
//
// With n hits sorted by row (r_s), seg[k] the run index of slot k
// (cumsum of run heads - 1), bag_s[k] the row of dly that hit k reads and
// w_s[k] its weight (or none: every weight 1), t_j = dly[bag_s[j]] * w_s[j],
// and C = kChunk:
//
//   for every run r_s[h .. h+L) of one row (a head: h == 0 or
//   r_s[h] != r_s[h-1]):
//     L <= C: G[seg[h]] = ((0 + t_h) + t_{h+1}) + ...   in slot order
//     L >  C: chunk c covers slots h + cC .. min(h + (c+1)C, h + L) - 1,
//             P_c = its slot-order sum from zero, and
//             G[seg[h]] = ((0 + P_0) + P_1) + ...         in chunk order
//     urows[seg[h]] = r_s[h]
//   for every slot k past the last run (k >= seg[n-1] + 1):
//     G[k] = 0, urows[k] = total_rows + k   (distinct rows past the table,
//                                            which the table update skips)
//
// A run of up to C hits keeps the bits of a slot-order sum, which are
// jax.ops.segment_sum's on the CPU. Multiplies and adds are __fmul_rn /
// __fadd_rn: no fused multiply-add, so the bits are the plain version's
// (sparse_update.coalesce_rows_plain).
//
// What bounds it on this card: bytes. Each hit reads one dly row (d floats)
// and 12 bytes of row, bag and weight; each slot writes one G row and one
// row id. What keeps it from that bound is latency: a hot row's run
// (65,275 hits at the Criteo Kaggle counts) walked by one warp would pace
// the whole kernel, and one warp alone streams rows at a small fraction of
// the card's rate however many loads it keeps in flight. So a warp takes 32
// slots at once, and a long run's chunks are summed by whole blocks, eight
// warps loading into shared memory and one adding. Three passes on the
// caller's stream, with C = 512 (chosen over 256 on the card: fewer
// partials to add in order, and runs of up to 512 hits keep JAX's bits):
//   1. short_runs: the runs of <= C hits, one warp per tile of 32 slots
//      (lane i holds slot b + i), grid-stride over the tiles. One round of
//      independent loads gives each lane its row, run index, bag and weight
//      and tells it whether it heads a run and whether that run reaches C
//      slots on (then it is a long run, left to pass 2). The warp walks its
//      slots from its first short run's head on, in slot order: shuffles
//      broadcast each slot's bag and weight, kTileUnroll / NC dly rows are
//      in flight (each lane 4 columns of each, as float4; NC = ceil(d / 128)
//      float4 a lane per row), a run's sum starts from zero at its head and
//      is stored to G at its end. The tile's last run may go on past the
//      tile, walked 32 hits at a time. So a short run costs its share of one
//      round of index loads and one of row loads, and the many short runs
//      of a batch keep the card's memory busy. The pass also writes every
//      run's row id and first slot (start) and zeroes the slots past the
//      last run.
//   2. long_chunks: each chunk of a run of > C hits, by one block of
//      kThreads: its warps copy the chunk's dly rows into one half of a
//      shared buffer, kStage / NC rows at a time (cp.async), while warp 0
//      adds the other half's in slot order, each lane 4 columns of each row. Two blocks per window of C slots
//      [mC, mC + C) find all chunks: a window holds the chunk heads of at
//      most two runs longer than C (the one that holds slot mC, and one that
//      starts inside the window and so holds its last slot). The same fact
//      places P_c with no count of the long runs: the head at slot k of a
//      run starting at s takes scratch row 2 * (k / C) + (s > (k / C) * C)
//      of 2 * ceil(n / C).
//   3. combine: one block per window whose slot mC is the first multiple of
//      C in a run longer than C: it finds the run's length from start, and
//      its warps stage the run's ceil(L / C) partials the same way (their
//      rows follow from s and C, with no index to load) for warp 0 to add in
//      chunk order; warp 0 writes G.
//
// C interface for ctypes: the entry point returns cudaGetLastError(), and
// coalesce_chunk() returns C for the wrapper to check against its own.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 512;  // C: a long run is summed in chunks of C hits
constexpr int kThreads = 256;
constexpr int kTileUnroll = 16;    // short_runs' dly rows in flight at d 128
constexpr int kStage = 64;  // rows a block stages at a time at d 128 (32 KB)
constexpr int kStageBlocks = 3;  // staging blocks an SM holds (66 KB each)
constexpr unsigned kFull = 0xffffffffu;

unsigned blocks(int64_t items, int per_block) {
  const int64_t want = (items + per_block - 1) / per_block;
  return unsigned(want < 65536 ? (want > 0 ? want : 1) : 65536);
}

__device__ __forceinline__ int64_t warp_id() {
  return (blockIdx.x * int64_t(blockDim.x) + threadIdx.x) / 32;
}

__device__ __forceinline__ int64_t warp_stride() {
  return int64_t(gridDim.x) * blockDim.x / 32;
}

__device__ __forceinline__ float4 madd(float4 acc, float4 v, float w,
                                       bool weighted) {
  if (weighted) {
    v.x = __fmul_rn(v.x, w);
    v.y = __fmul_rn(v.y, w);
    v.z = __fmul_rn(v.z, w);
    v.w = __fmul_rn(v.w, w);
  }
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
  return acc;
}

template <int NC>
__device__ __forceinline__ void set_zero(float4 (&acc)[NC]) {
#pragma unroll
  for (int q = 0; q < NC; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// v = row[the lane's columns], zero past d or when !in
template <int NC>
__device__ __forceinline__ void load_row(float4 (&v)[NC],
                                         const float* __restrict__ row,
                                         bool in, int d) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = lane * 4 + q * 128;
    v[q] = (in && c < d) ? *reinterpret_cast<const float4*>(row + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int NC>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float4 (&acc)[NC], int d) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = lane * 4 + q * 128;
    if (c < d) *reinterpret_cast<float4*>(dst + c) = acc[q];
  }
}

// acc += dly[bag_i] (* w_i) for i = 0 .. cnt-1 in order, where lane i
// holds bag_i and w_i (cnt <= 32); kUnroll rows in flight
template <int NC, int kUnroll>
__device__ __forceinline__ void add_hits(float4 (&acc)[NC],
                                         const float* __restrict__ dly,
                                         int my_bag, float my_w, int cnt,
                                         int d, bool weighted) {
  for (int i0 = 0; i0 < cnt; i0 += kUnroll) {
    float4 v[kUnroll][NC];
    float wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      const int b = __shfl_sync(kFull, my_bag, i & 31);
      wv[u] = __shfl_sync(kFull, my_w, i & 31);
      load_row<NC>(v[u], dly + int64_t(b) * d, i < cnt, d);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < cnt) {
#pragma unroll
        for (int q = 0; q < NC; ++q)
          acc[q] = madd(acc[q], v[u][q], wv[u], weighted);
      }
    }
  }
}

// the scratch row of the partial of the chunk headed by slot k of a run
// that starts at slot s
__device__ __forceinline__ int64_t partial_row(int64_t k, int64_t s) {
  const int64_t m = k / kChunk;
  return 2 * m + (s > m * kChunk ? 1 : 0);
}

// one past the last slot of the run with index sg
__device__ __forceinline__ int64_t run_end(const int* __restrict__ start,
                                           int64_t sg, int64_t num_seg,
                                           int64_t n) {
  return sg + 1 < num_seg ? start[sg + 1] : n;
}

// 16 bytes global -> shared, asynchronously (through L2)
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(src)
               : "memory");
}

// acc += rows[i] (* w[i]) for i = 0 .. cnt-1 in order, from shared memory,
// kUnroll rows read at a time
template <int NC>
__device__ __forceinline__ void add_staged(float4 (&acc)[NC],
                                           const float* rows, const float* w,
                                           int cnt, int d, bool weighted) {
  constexpr int kUnroll = 16 / NC;
  for (int i0 = 0; i0 < cnt; i0 += kUnroll) {
    float4 v[kUnroll][NC];
    float wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      wv[u] = (weighted && i < cnt) ? w[i] : 1.f;
      load_row<NC>(v[u], rows + i * d, i < cnt, d);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < cnt) {
#pragma unroll
        for (int q = 0; q < NC; ++q)
          acc[q] = madd(acc[q], v[u][q], wv[u], weighted);
      }
    }
  }
}

// warp 0's acc += row(i) (* w[i]) for i = 0 .. count-1 in order: the
// block's warps copy the rows (d floats each, 16-byte aligned) into the two
// halves of buf, kStage / NC rows a half, the next half's copy in flight
// while warp 0 adds the last one's
template <int NC, class Row>
__device__ __forceinline__ void staged_sum(float4 (&acc)[NC], float* buf,
                                           int64_t count, Row row,
                                           const float* w, int d,
                                           bool weighted) {
  constexpr int kRows = kStage / NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto fetch = [&](int64_t base) {
    float* dst = buf + ((base / kRows) % 2) * kRows * d;
    const int cnt = int(count - base < kRows ? count - base : kRows);
    for (int i = warp; i < cnt; i += kThreads / 32) {
      const float* src = row(base + i);
      for (int c = lane * 4; c < d; c += 128)
        copy16(dst + i * d + c, src + c);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  fetch(0);
  for (int64_t base = 0; base < count; base += kRows) {
    if (base + kRows < count) {
      fetch(base + kRows);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    if (warp == 0)
      add_staged<NC>(acc, buf + ((base / kRows) % 2) * kRows * d,
                     weighted ? w + base : nullptr,
                     int(count - base < kRows ? count - base : kRows), d,
                     weighted);
    __syncthreads();
  }
}

// dynamic shared memory of the staging passes: two halves of kStage / NC
// rows of d floats, then a chunk's bags and weights
template <int NC>
size_t stage_bytes(int d) {
  return 2 * size_t(kStage / NC) * d * sizeof(float) +
         size_t(kChunk) * (sizeof(int) + sizeof(float));
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
    short_runs_kernel(const int* __restrict__ r_s,
                      const int* __restrict__ seg,
                      const int* __restrict__ bag_s,
                      const float* __restrict__ w_s,
                      const float* __restrict__ dly, int64_t n, int d,
                      int64_t total_rows, float* __restrict__ G,
                      int* __restrict__ urows, int* __restrict__ start) {
  constexpr int kUnroll = kTileUnroll / NC;
  const int lane = threadIdx.x % 32;
  const int64_t num_seg = int64_t(seg[n - 1]) + 1;
  const bool weighted = w_s != nullptr;
  const int64_t tiles = (n + 31) / 32;
  for (int64_t tile = warp_id(); tile < tiles; tile += warp_stride()) {
    // lane i holds slot b + i: one round of independent loads
    const int64_t b = tile * 32;
    const int64_t k = b + lane;
    const int last = int(n - b < 32 ? n - b : 32);  // slots in the tile
    const bool valid = lane < last;
    const int r = valid ? r_s[k] : 0;
    const int sg = valid ? seg[k] : 0;
    const int my_bag = valid ? bag_s[k] : 0;
    const float my_w = (valid && weighted) ? w_s[k] : 1.f;
    const bool head = valid && (k == 0 || r_s[k - 1] != r);
    const bool long_run = valid && k + kChunk < n && r_s[k + kChunk] == r;
    // the tile's last run goes on past the tile
    const bool cont = __any_sync(
        kFull, lane == last - 1 && k + 1 < n && r_s[k + 1] == r);

    float4 acc[NC];
    set_zero<NC>(acc);
    if (valid && k >= num_seg) urows[k] = int(total_rows + k);
    for (int64_t z = b > num_seg ? b : num_seg; z < b + last; ++z)
      store_row<NC>(G + z * d, acc, d);
    if (head) {
      urows[sg] = r;
      start[sg] = int(k);
    }
    // the heads of the tile's runs, and of those of <= C hits (the slots
    // from a head to the next belong to its run)
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned shorts = __ballot_sync(kFull, head && !long_run);
    if (shorts == 0) continue;

    float* out = nullptr;
    bool mine = false;  // the current run is one of this tile's short runs
    for (int i0 = __ffs(shorts) - 1; i0 < last; i0 += kUnroll) {
      float4 v[kUnroll][NC];
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u;
        const int bg = __shfl_sync(kFull, my_bag, i & 31);
        wv[u] = __shfl_sync(kFull, my_w, i & 31);
        load_row<NC>(v[u], dly + int64_t(bg) * d, i < last, d);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u;
        if (i < last) {
          if ((heads >> i) & 1) {
            mine = (shorts >> i) & 1;
            set_zero<NC>(acc);
            out = G + int64_t(__shfl_sync(kFull, sg, i)) * d;
          }
          if (mine) {
#pragma unroll
            for (int q = 0; q < NC; ++q)
              acc[q] = madd(acc[q], v[u][q], wv[u], weighted);
            const bool ends =
                i + 1 < last ? ((heads >> (i + 1)) & 1) != 0 : !cont;
            if (ends) store_row<NC>(out, acc, d);
          }
        }
      }
    }
    if (cont && mine) {
      // the tile's last run goes on past the tile, to at most C slots from
      // its head: 32 hits at a time, one per lane (sorted rows make the
      // lanes still in the run a prefix of the warp)
      const int rr = __shfl_sync(kFull, r, last - 1);
      const int64_t kh = b + 31 - __clz(heads);
      const int64_t end = kh + kChunk < n ? kh + kChunk : n;
      for (int64_t j = b + last; j < end; j += 32) {
        const int64_t jj = j + lane;
        const bool inside = jj < end;
        const bool in = inside && r_s[jj] == rr;
        const int bg = inside ? bag_s[jj] : 0;
        const float w = (inside && weighted) ? w_s[jj] : 1.f;
        const int cnt = __popc(__ballot_sync(kFull, in));
        add_hits<NC, kUnroll>(acc, dly, bg, w, cnt, d, weighted);
        if (cnt < 32) break;
      }
      store_row<NC>(out, acc, d);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, kStageBlocks)
    long_chunks_kernel(const int* __restrict__ seg,
                       const int* __restrict__ start,
                       const int* __restrict__ bag_s,
                       const float* __restrict__ w_s,
                       const float* __restrict__ dly, int64_t n, int d,
                       float* __restrict__ P) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  int* bags = reinterpret_cast<int*>(buf + 2 * (kStage / NC) * d);
  float* wts = reinterpret_cast<float*>(bags + kChunk);
  const int warp = threadIdx.x / 32;
  const int64_t num_seg = int64_t(seg[n - 1]) + 1;
  const bool weighted = w_s != nullptr;
  const int64_t windows = (n + kChunk - 1) / kChunk;
  for (int64_t w = blockIdx.x; w < 2 * windows; w += gridDim.x) {
    // block 2m takes the run that holds slot mC; block 2m + 1 the one that
    // holds the window's last slot, if it starts inside the window
    const int64_t k0 = (w / 2) * kChunk;
    const int64_t k1 = k0 + kChunk < n ? k0 + kChunk : n;
    const int64_t sg = seg[w % 2 ? k1 - 1 : k0];
    const int64_t s = start[sg];
    if (w % 2 && s <= k0) continue;
    const int64_t e = run_end(start, sg, num_seg, n);
    if (e - s <= kChunk) continue;
    // the run's chunk head in the window, if it has one there
    const int64_t h = s + (k0 > s ? (k0 - s + kChunk - 1) / kChunk : 0) *
                              int64_t(kChunk);
    if (h >= e) continue;
    const int len = int(e - h < kChunk ? e - h : kChunk);

    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      bags[t] = bag_s[h + t];
      wts[t] = weighted ? w_s[h + t] : 1.f;
    }
    __syncthreads();
    float4 acc[NC];
    set_zero<NC>(acc);
    staged_sum<NC>(
        acc, buf, len,
        [&](int64_t i) { return dly + int64_t(bags[i]) * d; }, wts, d,
        weighted);
    if (warp == 0) store_row<NC>(P + partial_row(h, s) * d, acc, d);
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, kStageBlocks)
    combine_kernel(const int* __restrict__ seg, const int* __restrict__ start,
                   const float* __restrict__ P, int64_t n, int d,
                   float* __restrict__ G) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int64_t num_seg = int64_t(seg[n - 1]) + 1;
  const int64_t windows = (n + kChunk - 1) / kChunk;
  for (int64_t m = blockIdx.x; m < windows; m += gridDim.x) {
    const int64_t k = m * kChunk;
    const int sg = seg[k];
    const int64_t s = start[sg];
    // the run's first multiple of C owns it; only a run of > C hits is split
    if (s <= k - kChunk) continue;
    const int64_t len = run_end(start, sg, num_seg, n) - s;
    if (len <= kChunk) continue;
    float4 acc[NC];
    set_zero<NC>(acc);
    staged_sum<NC>(
        acc, buf, (len + kChunk - 1) / kChunk,
        [&](int64_t c) { return P + partial_row(s + c * kChunk, s) * d; },
        nullptr, d, false);
    if (warp == 0) store_row<NC>(G + int64_t(sg) * d, acc, d);
  }
}

template <int NC>
cudaError_t launch(const int* r_s, const int* seg, const int* bag_s,
                   const float* w_s, const float* dly, int64_t n, int d,
                   int64_t total_rows, float* G, int* urows, int* start,
                   float* P, cudaStream_t st) {
  static bool opted_in = false;  // into stage_bytes' most, once per NC
  if (!opted_in) {
    const int most = int(stage_bytes<NC>(NC * 128));
    cudaError_t e = cudaFuncSetAttribute(
        long_chunks_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(combine_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int64_t windows = (n + kChunk - 1) / kChunk;
  const size_t smem = stage_bytes<NC>(d);
  short_runs_kernel<NC><<<blocks((n + 31) / 32, kThreads / 32), kThreads, 0,
                          st>>>(r_s, seg, bag_s, w_s, dly, n, d, total_rows,
                                G, urows, start);
  long_chunks_kernel<NC><<<blocks(2 * windows, 1), kThreads, smem, st>>>(
      seg, start, bag_s, w_s, dly, n, d, P);
  combine_kernel<NC><<<blocks(windows, 1), kThreads, smem, st>>>(
      seg, start, P, n, d, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" int coalesce_chunk() { return kChunk; }

// r_s, seg, bag_s [n] int32; w_s [n] f32 or null; dly [*, d] f32 and
// G [n, d] f32 contiguous and 16-byte aligned, d % 4 == 0, d <= 512;
// urows [n] int32; scratch: start [n] int32, P [2 * ceil(n / C), d] f32
extern "C" int coalesce_rows(const int* r_s, const int* seg, const int* bag_s,
                             const float* w_s, const float* dly, int64_t n,
                             int d, int64_t total_rows, float* G, int* urows,
                             int* start, float* P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || d <= 0 || d % 4 != 0 || d > 512)
    return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaGetLastError());
  const int nc = (d + 127) / 128;
  if (nc == 1)
    return int(launch<1>(r_s, seg, bag_s, w_s, dly, n, d, total_rows, G,
                         urows, start, P, st));
  if (nc == 2)
    return int(launch<2>(r_s, seg, bag_s, w_s, dly, n, d, total_rows, G,
                         urows, start, P, st));
  return int(launch<4>(r_s, seg, bag_s, w_s, dly, n, d, total_rows, G, urows,
                       start, P, st));
}
