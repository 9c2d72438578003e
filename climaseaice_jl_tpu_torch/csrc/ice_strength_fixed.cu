// Fixed-tile ice strength for NVIDIA Hopper (sm_90a): P = P★·h·exp(−C(1 − ℵ)).
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py::
// _p_kernel` (called by `_fixed_tile_P`), which evaluates the ice strength on
// pinned (TX, TY) tiles so that the P the fixed-tile tripolar step returns
// has the same bits under any decomposition.  Here one thread computes one
// point, in the plain version's operation order: (P★·h)·exp((−C)·(1 − ℵ)),
// with P★ and C read from a float32[2] on the card.
//
// What bounds it on an H100: h and ℵ read, P written, 12 bytes a point
// against 6 operations: at the basin's 1162×1018 widened points 14.2 MB,
// 4.2 µs at 3.35 TB/s; bound by bytes.  Built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK) ice_strength(const float* __restrict__ prm,
                                                      const float* __restrict__ h,
                                                      const float* __restrict__ a,
                                                      float* __restrict__ P, long long n) {
  const long long k = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (k >= n) return;
  P[k] = prm[0] * h[k] * expf(-prm[1] * (1.0f - a[k]));
}

}  // namespace

// P at the n points of h and a into P on `stream`; `params` = (P★, C) on the
// card.  Returns 0 or the CUDA error of the launch.
extern "C" int csi_ice_strength_fixed(const float* params, const float* h, const float* a,
                                      float* P, long long n, void* stream) {
  if (n <= 0) return 0;
  ice_strength<<<static_cast<unsigned>((n + BLOCK - 1) / BLOCK), BLOCK, 0,
                 static_cast<cudaStream_t>(stream)>>>(params, h, a, P, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
