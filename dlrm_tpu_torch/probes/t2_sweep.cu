// T2 t2_contract's design sweep on the card (probes/t2_sweep.py builds and
// calls it): the shipped kernel (csrc/feasibility.cu) at every split of K,
// then variants of its CTA at one split, each at P6's shape (K 1,024) and
// at chip_smoke.py's T2_SCALE (K 16,384), R 256, C 128. A variant differs
// from the shipped kernel in its thread tile (TM x TN), its stage depth
// (BK, ST), optionally its loads (none: the FFMA loop alone) and its
// cluster reduction (each rank reads the others' partials: two cluster
// barriers). Times: the card's us a call, 20 calls in one CUDA graph
// replayed 5 times between CUDA events.

#include "../csrc/feasibility.cu"

#include <cmath>
#include <cstdio>
#include <map>
#include <random>
#include <vector>

namespace {

template <int BM, int BN, int BK, int ST, int TH, int TM, int TN>
struct Var {
  static constexpr int kGT = BM * BN / (TM * TN);  // threads a group
  static constexpr int kG = TH / kGT;
  static constexpr int kGK = BK / kG;
  static constexpr int kSF = BK * (BM + BN);
  static constexpr int kSmem =
      (ST * kSF > kG * BM * BN ? ST * kSF : kG * BM * BN) * 4;
};

template <int BM, int BN, int BK, int ST, int TH>
__device__ __forceinline__ void var_stage(float* st, const float* a,
                                          const float* b, int k0, int kend,
                                          int rows, int cols, int r0,
                                          int c0) {
  constexpr int kAc = BM / 4, kBc = BN / 4;
  for (int i = threadIdx.x; i < BK * kAc; i += TH) {
    const int kk = i / kAc, j = i % kAc * 4, k = k0 + kk;
    const bool ok = k < kend && r0 + j < rows;
    cp_async(st + kk * BM + j, ok ? a + int64_t(k) * rows + r0 + j : a, ok,
             true);
  }
  for (int i = threadIdx.x; i < BK * kBc; i += TH) {
    const int kk = i / kBc, j = i % kBc * 4, k = k0 + kk;
    const bool ok = k < kend && c0 + j < cols;
    cp_async(st + BK * BM + kk * BN + j,
             ok ? b + int64_t(k) * cols + c0 + j : b, ok, true);
  }
}

// mode 0: the whole kernel; 1: no loads; 2: return at once (the launch)
template <int BM, int BN, int BK, int ST, int TH, int TM, int TN>
__global__ void __launch_bounds__(TH, 1)
    var_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int k_total, int rows, int cols,
               int k_per, int tiles_c, int* smids, int mode) {
  using V = Var<BM, BN, BK, ST, TH, TM, TN>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  if (threadIdx.x == 0 && smids) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    smids[blockIdx.x] = int(sm);
  }
  if (mode == 2) return;
  const int tile = blockIdx.x / split;
  const int r0 = tile / tiles_c * BM, c0 = tile % tiles_c * BN;
  const int kbeg = min(k_total, rank * k_per);
  const int kend = min(k_total, kbeg + k_per);
  const int n = (kend - kbeg + BK - 1) / BK;
  const int grp = threadIdx.x / V::kGT, gt = threadIdx.x % V::kGT;
  const int tr = gt / (BN / TN), tc = gt % (BN / TN);
  float acc[TM][TN] = {};
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n && mode == 0) {
      var_stage<BM, BN, BK, ST, TH>(smem + s * V::kSF, a, b, kbeg + s * BK,
                                    kend, rows, cols, r0, c0);
    }
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    const int next = s + ST - 1;
    if (next < n && mode == 0) {
      var_stage<BM, BN, BK, ST, TH>(smem + next % ST * V::kSF, a, b,
                                    kbeg + next * BK, kend, rows, cols, r0,
                                    c0);
    }
    cp_async_commit();
    const float* as = smem + s % ST * V::kSF;
    const float* bs = as + BK * BM;
#pragma unroll
    for (int kk = 0; kk < V::kGK; ++kk) {
      const int k = grp * V::kGK + kk;
      float ar[TM], br[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + k * BM + q * (BM / (TM / 4)) + tr * 4);
        ar[4 * q] = v.x, ar[4 * q + 1] = v.y, ar[4 * q + 2] = v.z,
                 ar[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + k * BN + q * (BN / (TN / 4)) + tc * 4);
        br[4 * q] = v.x, br[4 * q + 1] = v.y, br[4 * q + 2] = v.z,
                 br[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* part = smem + grp * BM * BN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i / 4 * (BM / (TM / 4)) + tr * 4 + i % 4;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      *reinterpret_cast<float4*>(part + row * BN + q * (BN / (TN / 4)) +
                                 tc * 4) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                      acc[i][4 * q + 3]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += TH) {
    float v = smem[e];
    for (int g = 1; g < V::kG; ++g) v += smem[g * BM * BN + e];
    smem[e] = v;
  }
  cluster.sync();
  const int per = (BM * BN + split - 1) / split;
  const int e_end = min(BM * BN, (rank + 1) * per);
  for (int e = rank * per + int(threadIdx.x); e < e_end; e += TH) {
    float v = *cluster.map_shared_rank(smem + e, 0);
    for (int q = 1; q < split; ++q) v += *cluster.map_shared_rank(smem + e, q);
    const int r = r0 + e / BN, c = c0 + e % BN;
    if (r < rows && c < cols) out[int64_t(r) * cols + c] = v;
  }
  cluster.sync();
}

struct Inputs {
  int k, rows, cols;
  float *a, *b, *out;
  std::vector<double> exact;
};

// the card's us a call of fn(stream): 20 calls in one graph, 5 replays
template <typename F>
float graph_us(F fn) {
  cudaStream_t st;
  cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  fn(st);
  cudaStreamSynchronize(st);
  cudaGraph_t g;
  cudaGraphExec_t ge;
  cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal);
  for (int i = 0; i < 20; ++i) fn(st);
  cudaStreamEndCapture(st, &g);
  cudaGraphInstantiate(&ge, g, 0);
  cudaGraphLaunch(ge, st);
  cudaStreamSynchronize(st);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0, st);
  for (int i = 0; i < 5; ++i) cudaGraphLaunch(ge, st);
  cudaEventRecord(e1, st);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaGraphExecDestroy(ge);
  cudaGraphDestroy(g);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaStreamDestroy(st);
  return ms * 1e3f / 100;
}

double max_err(const Inputs& in) {
  std::vector<float> h(size_t(in.rows) * in.cols);
  cudaMemcpy(h.data(), in.out, h.size() * 4, cudaMemcpyDeviceToHost);
  double err = 0;
  for (size_t i = 0; i < h.size(); ++i) {
    err = std::fmax(err, std::fabs(h[i] - in.exact[i]));
  }
  return err;
}

double bound_share(const Inputs& in, float us) {
  return 2.0 * in.k * in.rows * in.cols / 67e12 * 1e6 / us;
}

template <int BM, int BN, int BK, int ST, int TH, int TM, int TN>
void run_variant(const char* name, const Inputs& in, int split, int mode) {
  using V = Var<BM, BN, BK, ST, TH, TM, TN>;
  auto fn = var_kernel<BM, BN, BK, ST, TH, TM, TN>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       V::kSmem);
  const int tiles_c = (in.cols + BN - 1) / BN;
  const int tiles = (in.rows + BM - 1) / BM * tiles_c;
  const int k_per = (in.k + split - 1) / split;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = unsigned(split);
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(tiles * split));
  cfg.blockDim = dim3(TH);
  cfg.dynamicSmemBytes = size_t(V::kSmem);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
  cudaFuncAttributes fa;
  cudaFuncGetAttributes(&fa, fn);
  int* smids = nullptr;
  cudaMalloc(&smids, size_t(tiles) * split * 4);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, in.a, in.b, in.out,
                                           in.k, in.rows, in.cols, k_per,
                                           tiles_c, smids, mode);
  cudaDeviceSynchronize();
  std::vector<int> hs(size_t(tiles) * split);
  cudaMemcpy(hs.data(), smids, hs.size() * 4, cudaMemcpyDeviceToHost);
  cudaFree(smids);
  std::map<int, int> per_sm;
  for (int s : hs) per_sm[s]++;
  int most = 0;
  for (const auto& kv : per_sm) most = kv.second > most ? kv.second : most;
  const double err = mode == 0 ? max_err(in) : NAN;
  const float us = graph_us([&](cudaStream_t st) {
    cfg.stream = st;
    cudaLaunchKernelEx(&cfg, fn, in.a, in.b, in.out, in.k, in.rows, in.cols,
                       k_per, tiles_c, static_cast<int*>(nullptr), mode);
  });
  static const char* kModes[] = {"", " no loads", " launch only"};
  printf("variant %s%s K %d split %d: %s, %d regs, %d B shared, %d "
         "clusters at once, %d CTAs on %zu SMs (at most %d an SM), max abs "
         "err vs fp64 %.3e, %.2f us on the card, %.1f%% of the bound\n",
         name, kModes[mode], in.k, split, cudaGetErrorString(e), fa.numRegs,
         V::kSmem, active, tiles * split, per_sm.size(), most, err, us,
         100 * bound_share(in, us));
}

void run_shipped(const Inputs& in, int split) {
  const int tiles = (in.rows + kBM - 1) / kBM * ((in.cols + kBN - 1) / kBN);
  int dev = 0;
  cudaGetDevice(&dev);
  contract_attrs<true>(dev);
  const int active = contract_active_clusters<true>(dev, split);
  const int chosen = contract_split<true>(dev, tiles, in.k);
  const int e = launch_contract<true>(in.a, in.b, in.out, in.k, in.rows,
                                      in.cols, split, nullptr);
  cudaDeviceSynchronize();
  const double err = max_err(in);
  const float us = graph_us([&](cudaStream_t st) {
    launch_contract<true>(in.a, in.b, in.out, in.k, in.rows, in.cols, split,
                          st);
  });
  printf("shipped K %d split %d%s: error %d, %d clusters at once (%d "
         "wave%s), max abs err vs fp64 %.3e, %.2f us on the card, %.1f%% of "
         "the bound\n",
         in.k, split, split == chosen ? " (t2_contract's choice)" : "", e,
         active, int((tiles + active - 1) / (active > 0 ? active : 1)),
         (tiles + active - 1) / (active > 0 ? active : 1) == 1 ? "" : "s",
         err, us, 100 * bound_share(in, us));
}

}  // namespace

extern "C" int t2_sweep() {
  const int rows = 256, cols = 128;
  for (int k : {1024, 16384}) {
    Inputs in{k, rows, cols, nullptr, nullptr, nullptr, {}};
    std::vector<float> ha(size_t(k) * rows), hb(size_t(k) * cols);
    std::mt19937 gen(1);
    std::normal_distribution<float> nd;
    for (auto& v : ha) v = nd(gen);
    for (auto& v : hb) v = nd(gen);
    in.exact.assign(size_t(rows) * cols, 0.0);
    for (int kk = 0; kk < k; ++kk) {
      for (int r = 0; r < rows; ++r) {
        const double av = ha[size_t(kk) * rows + r];
        for (int c = 0; c < cols; ++c) {
          in.exact[size_t(r) * cols + c] += av * hb[size_t(kk) * cols + c];
        }
      }
    }
    cudaMalloc(&in.a, ha.size() * 4);
    cudaMalloc(&in.b, hb.size() * 4);
    cudaMalloc(&in.out, size_t(rows) * cols * 4);
    cudaMemcpy(in.a, ha.data(), ha.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(in.b, hb.data(), hb.size() * 4, cudaMemcpyHostToDevice);
    for (int split = 1; split <= kMaxSplit; ++split) run_shipped(in, split);
    // the first design: a 4 x 4 thread tile, two groups of 128 threads
    run_variant<64, 32, 32, 3, 256, 4, 4>("4x4 bk32 st3", in, 8, 0);
    run_variant<64, 32, 32, 3, 256, 4, 4>("4x4 bk32 st3", in, 6, 0);
    run_variant<64, 32, 32, 4, 256, 8, 8>("8x8 bk32 st4", in, 6, 0);
    run_variant<64, 32, 64, 4, 256, 8, 8>("8x8 bk64 st4", in, 6, 0);
    run_variant<64, 32, 64, 4, 256, 8, 8>("8x8 bk64 st4", in, 6, 1);
    run_variant<64, 32, 64, 4, 256, 8, 8>("8x8 bk64 st4", in, 6, 2);
    run_variant<64, 32, 128, 3, 256, 8, 8>("8x8 bk128 st3", in, 6, 0);
    run_variant<64, 32, 64, 3, 256, 8, 16>("8x16 bk64 st3", in, 6, 0);
    cudaFree(in.a);
    cudaFree(in.b);
    cudaFree(in.out);
  }
  fflush(stdout);
  return int(cudaGetLastError());
}
