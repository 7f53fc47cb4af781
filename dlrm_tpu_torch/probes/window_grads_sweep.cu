// K1 window_grads' design sweep on the card (probes/window_grads_sweep.py
// builds, calls and times it): the shipped kernel (csrc/window_grads.cu,
// included here) at other depths (chunk loads in flight a lane), other
// register budgets (the blocks an SM its launch bounds must allow) and
// with or without the streaming store hint on G_u; the grid is the
// caller's.
//
// C interface for ctypes: k1_sweep runs variant `v` of kVariants with
// k1_window_grads' arguments and returns its CUDA error; k1_sweep_count
// returns how many variants there are, k1_sweep_resident(v) the blocks of
// variant v an SM holds.

#include "../csrc/window_grads.cu"

namespace {

using Runner = int (*)(int, int, int, const Args&);

// in the order of window_grads_sweep.py's VARIANTS: <depth, blocks an SM,
// streaming store>
constexpr Runner kVariants[] = {
    run<1, 4, true>,  run<2, 4, true>,  run<4, 4, true>, run<4, 4, false>,
    run<8, 3, true>,  run<8, 3, false>, run<8, 4, true>, run<8, 2, true>,
    run<16, 2, true>, run<4, 8, true>,  run<2, 8, true>, run<1, 8, true>,
};

// the blocks of a variant an SM holds (fp32 dly and G_u, mm_dtype bf16)
template <int DEPTH, int MINB, bool CS>
int resident() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, k1_kernel<DEPTH, MINB, CS, float, float, true>, kThreads, 0);
  return e == cudaSuccess ? n : -int(e);
}

using Resident = int (*)();

constexpr Resident kResident[] = {
    resident<1, 4, true>,  resident<2, 4, true>,  resident<4, 4, true>,
    resident<4, 4, false>, resident<8, 3, true>,  resident<8, 3, false>,
    resident<8, 4, true>,  resident<8, 2, true>,  resident<16, 2, true>,
    resident<4, 8, true>,  resident<2, 8, true>,  resident<1, 8, true>,
};
static_assert(sizeof(kResident) / sizeof(kResident[0]) ==
              sizeof(kVariants) / sizeof(kVariants[0]));

}  // namespace

extern "C" int k1_sweep_resident(int v) { return kResident[v](); }

extern "C" int k1_sweep_count() {
  return int(sizeof(kVariants) / sizeof(kVariants[0]));
}

extern "C" int k1_sweep(int v, int dly_bf16, const void* dly,
                        int64_t stride_t, int64_t stride_b,
                        const int* vals_u, const float* wts_u,
                        const int* w2t, void* g_u, int64_t u_total, int d,
                        int mm_bf16, int out_bf16, int grid, void* stream) {
  if (v < 0 || v >= k1_sweep_count()) return int(cudaErrorInvalidValue);
  return kVariants[v](dly_bf16, mm_bf16, out_bf16,
                      Args{dly, stride_t, stride_b, vals_u, wts_u, w2t,
                               g_u, u_total, d, grid,
                               static_cast<cudaStream_t>(stream)});
}
