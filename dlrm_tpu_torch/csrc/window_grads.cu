// K1 window_grads for Hopper (sm_90a): the per-hit gradients in U-order.
//
// Replaces the Pallas TPU kernel dlrm_tpu/ops/stream_kernels.py:
// window_grads (_window_grads_kernel). Same function on the same host-built
// U-layout inputs (dlrm_tpu_torch/ops/stream_plan.py):
//
//   G_u[u, :] = mm(wts_u[u]) * mm(dly[w2t[u / 1024], vals_u[u], :])
//
// where mm() rounds to bf16 when mm_bf16 is set (the TPU kernel carries the
// weight inside a one-hot matrix of mm_dtype and casts dly to mm_dtype) and
// keeps fp32 otherwise. The product is taken in fp32 and stored as fp32, or
// rounded once to the nearest bf16 (ties to even) when out_bf16 is set (the
// JAX step's g_dtype). Sentinel slots have weight 0 and give 0.
//
// What bounds it on this card: bytes. Per slot it writes one G row (512 B
// in fp32 at d = 128, 256 B in bf16) and reads one dly row. The TPU kernel
// spent B * d * 2 FLOPs per hit on a one-hot MXU matmul that only emulated
// this gather; a GPU gathers directly and multiplies once per element, so
// the least time is the G_u write plus one read of dly over the memory
// rate.
//
// What keeps it off that bound: the random read of one dly row a slot.
// Within a table the slots are sorted by table row, so their bags are in
// no order, and a warp that waits on one row at a time cannot cover the
// memory's latency. The design:
//
//   - Warp tiles of kTile = 32 contiguous slots. A tile lies in one window
//     (32 divides 1024), so it reads w2t once; lane j loads slot j's bag
//     and weight (one coalesced load each), and the lanes take them from
//     each other with shuffles.
//   - The tile's G block [32, d] is contiguous: lane j takes its 4-column
//     chunks k = j, j + 32, j + 64, ... of it (slot k / (d / 4)), so every
//     store instruction of the warp writes 32 neighbouring chunks, and any
//     d that is a multiple of 4 needs no other path.
//   - kDepth chunk loads a lane are issued before any of them is used:
//     kDepth dly rows in flight a warp at d = 128, not one.
//   - A warp a tile (the wrapper's window_grads_grid), blocks launched in
//     slot order, so the rows live at once are about one table's dly (8 MB
//     at B = 16,384, d = 128, fp32), well inside the 50 MB L2. A
//     grid-stride loop of 8,192 blocks (a stride of 65,536 slots) would
//     spread the resident warps over every table at once. G_u is stored
//     with a streaming hint (st.global.cs) so that it does not push the
//     rows out.
//
// probes/window_grads_sweep.py times other depths, register budgets,
// store hints and a persistent grid (the blocks an SM holds x SMs, each
// warp walking tiles a grid apart). On an H100 at chip_smoke.py phase 4's
// work (3.85 M slots, d = 128, fp32 dly), with fp32 G_u, every persistent
// form took 0.95-1.19 ms, and a warp a tile at this depth and budget
// 0.83 ms (PERF.md §6).
//
// dly is read through its strides, so the [B, T, d] cotangent that
// autograd gives is passed as its [T, B, d] transposed view with no copy.
// Nothing of a whole [B, d] block is held on chip, so there is no batch
// limit (the TPU kernel's VMEM guard does not apply).
//
// C interface for ctypes: k1_window_grads returns cudaGetLastError().

#include "u_layout.cuh"

namespace {

using namespace ulayout;

constexpr int kTile = 32;          // slots a warp tile: one lane a slot
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 8;          // chunk loads in flight a lane
constexpr int kMinBlocks = 3;      // blocks an SM the registers must allow
constexpr bool kStreamStore = true;

// Four G values: one 16-byte (fp32) or 8-byte (bf16, nearest, ties to even)
// store, with the streaming hint when CS.
template <bool CS>
__device__ __forceinline__ void store_g(float* p, float4 v) {
  if (CS) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    store4(p, v);
  }
}
template <bool CS>
__device__ __forceinline__ void store_g(__nv_bfloat16* p, float4 v) {
  if (!CS) {
    store4(p, v);
    return;
  }
  const __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(v.x, v.y));
  const __nv_bfloat162 hi = __float22bfloat162_rn(make_float2(v.z, v.w));
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi)));
}

// A tile's inputs as lane `lane` holds them: its slot's bag and weight (0
// past u_total) and the tile's table.
struct Slot {
  int bag;
  float wt;
  int table;
};

__device__ __forceinline__ Slot tile_slot(int64_t tile, int64_t u_total,
                                          int lane,
                                          const int* __restrict__ vals_u,
                                          const float* __restrict__ wts_u,
                                          const int* __restrict__ w2t) {
  Slot s{0, 0.f, w2t[tile * kTile / kWindow]};
  const int64_t u = tile * kTile + lane;
  if (u < u_total) {
    s.bag = vals_u[u];
    s.wt = wts_u[u];
  }
  return s;
}

template <int DEPTH, int MINB, bool CS, typename TD, typename TO,
          bool MM_BF16>
__global__ void __launch_bounds__(kThreads, MINB)
    k1_kernel(const TD* __restrict__ dly, int64_t stride_t, int64_t stride_b,
              const int* __restrict__ vals_u,
              const float* __restrict__ wts_u, const int* __restrict__ w2t,
              TO* __restrict__ g_u, int64_t u_total, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (u_total + kTile - 1) / kTile;
  const int64_t step = int64_t(gridDim.x) * kWarps;
  const int per_row = d >> 2;  // 4-column chunks a row
  // chunk k = lane + 32 i lies in slot k / per_row, at column 4 (k %
  // per_row); from one i to the next, slot and chunk column advance by:
  const int adv_s = 32 / per_row, adv_c = 32 % per_row;
  for (int64_t tile = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += step) {
    const Slot cur = tile_slot(tile, u_total, lane, vals_u, wts_u, w2t);
    const float wt = mm_round<MM_BF16>(cur.wt);
    const int64_t u0 = tile * kTile;
    const int chunks =
        int(u_total - u0 < kTile ? u_total - u0 : kTile) * per_row;
    const TD* src = dly + int64_t(cur.table) * stride_t;
    TO* dst = g_u + u0 * d;
    int s = lane / per_row, c = lane % per_row;
    // the bound is the same for every lane: the shuffles need all 32
    for (int k0 = 0; k0 < chunks; k0 += 32 * DEPTH) {
      float4 x[DEPTH];
      float w[DEPTH];
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        const int bag = __shfl_sync(kFull, cur.bag, s & 31);
        w[j] = __shfl_sync(kFull, wt, s & 31);
        x[j] = k0 + 32 * j + lane < chunks
                   ? load4(src + int64_t(bag) * stride_b + 4 * c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        s += adv_s;
        c += adv_c;
        if (c >= per_row) {
          c -= per_row;
          ++s;
        }
      }
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        const int k = k0 + 32 * j + lane;
        if (k < chunks) {
          const float4 y = mm_round4<MM_BF16>(x[j]);
          store_g<CS>(dst + 4 * int64_t(k),
                      make_float4(__fmul_rn(w[j], y.x), __fmul_rn(w[j], y.y),
                                  __fmul_rn(w[j], y.z),
                                  __fmul_rn(w[j], y.w)));
        }
      }
    }
  }
}

struct Args {
  const void* dly;
  int64_t stride_t, stride_b;
  const int* vals_u;
  const float* wts_u;
  const int* w2t;
  void* g_u;
  int64_t u_total;
  int d, grid;
  cudaStream_t st;
};

template <int DEPTH, int MINB, bool CS, typename TD, typename TO,
          bool MM_BF16>
cudaError_t launch(const Args& a) {
  k1_kernel<DEPTH, MINB, CS, TD, TO, MM_BF16>
      <<<a.grid, kThreads, 0, a.st>>>(
          static_cast<const TD*>(a.dly), a.stride_t, a.stride_b, a.vals_u,
          a.wts_u, a.w2t, static_cast<TO*>(a.g_u), a.u_total, a.d);
  return cudaGetLastError();
}

template <int DEPTH, int MINB, bool CS, typename TD, typename TO>
cudaError_t launch_mm(int mm_bf16, const Args& a) {
  return mm_bf16 ? launch<DEPTH, MINB, CS, TD, TO, true>(a)
                 : launch<DEPTH, MINB, CS, TD, TO, false>(a);
}

template <int DEPTH, int MINB, bool CS, typename TD>
cudaError_t launch_out(int out_bf16, int mm_bf16, const Args& a) {
  return out_bf16 ? launch_mm<DEPTH, MINB, CS, TD, __nv_bfloat16>(mm_bf16, a)
                  : launch_mm<DEPTH, MINB, CS, TD, float>(mm_bf16, a);
}

// One configuration of the kernel on the given types; the checks of
// k1_window_grads first.
template <int DEPTH, int MINB, bool CS>
int run(int dly_bf16, int mm_bf16, int out_bf16, const Args& a) {
  if (a.d <= 0 || a.d % 4 != 0 || a.u_total < 0 || a.stride_t % 4 != 0 ||
      a.stride_b % 4 != 0 || (a.u_total > 0 && a.grid <= 0)) {
    return int(cudaErrorInvalidValue);
  }
  if (a.u_total == 0) return int(cudaGetLastError());
  return int(dly_bf16
                 ? launch_out<DEPTH, MINB, CS, __nv_bfloat16>(out_bf16,
                                                              mm_bf16, a)
                 : launch_out<DEPTH, MINB, CS, float>(out_bf16, mm_bf16, a));
}

}  // namespace

// grid: the blocks (window_grads_grid in ops/stream_kernels.py: a warp a
// tile); a smaller grid walks the tiles grid-stride.
extern "C" int k1_window_grads(int dly_bf16, const void* dly,
                               int64_t stride_t, int64_t stride_b,
                               const int* vals_u, const float* wts_u,
                               const int* w2t, void* g_u, int64_t u_total,
                               int d, int mm_bf16, int out_bf16, int grid,
                               void* stream) {
  return run<kDepth, kMinBlocks, kStreamStore>(
      dly_bf16, mm_bf16, out_bf16,
      Args{dly, stride_t, stride_b, vals_u, wts_u, w2t, g_u, u_total, d,
               grid, static_cast<cudaStream_t>(stream)});
}
