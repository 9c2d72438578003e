// Fixed-tile pointwise evaluation of an elementwise callable for NVIDIA
// Hopper (sm_90a).
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_pointwise.py::
// fixed_tile_pointwise`, which re-traces a Python callable of arrays and
// SMEM scalars inside a Pallas kernel on pinned (TX, TY) tiles so that its
// per-point bits do not depend on the decomposition (the basin's winds,
// `validation/run_distributed_basin.py:76-94`).  Here the callable arrives
// as the postfix program that dynamics/fixed_tile_pointwise.py records from
// it (pointwise_program.cuh), and every thread runs it at one point.
//
// What bounds it on an H100: the basin's wind component reads two arrays
// (longitude and latitude) and writes one, 12 bytes a point, and does about
// a hundred operations a point (six sines and cosines and two exponentials
// among them): at 1162×970 points 13.5 MB, 4.0 µs at 3.35 TB/s, against
// about 1.7 µs of float32 operations at 67 TFLOP/s, so it is bound by bytes.
//
// Design (simple and right first): one thread per point, one launch per
// call; the program, its constants and the input pointers travel by value
// in one struct; the interpreter keeps its stack and registers in local
// memory.  Built with -fmad=false: a point's bits depend on neither the
// launch nor the array shape.

#include "pointwise_program.cuh"

namespace {

using namespace csi_prog;

constexpr int MAX_OPS = 192, MAX_K = 64, MAX_PTRS = 16;
constexpr int BLOCK = 256;

struct Args {
  Prog<MAX_OPS> prog;
  float k[MAX_K];
  const float* p[MAX_PTRS];
};

__global__ void __launch_bounds__(BLOCK) pointwise(const __grid_constant__ Args A,
                                                   float* __restrict__ out, long long n) {
  const long long pt = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (pt >= n) return;
  out[pt] = run(A.prog, A.k, A.p, pt, 0.0f);
}

}  // namespace

// The program (ints: count, then (op, a, b) triples) at each of the n points
// into `out` on `stream`; `consts` and `ptrs` are host arrays of its
// constants and device pointers.  Returns 0, a CUDA error, or -1 for
// arguments it cannot take.
extern "C" int csi_pointwise_fixed(const int* ints, int n_ints, const float* consts, int n_k,
                                   const void* const* ptrs, int n_p, float* out,
                                   long long n, void* stream) {
  Args A{};
  int at = 0;
  if (n_k > MAX_K || n_p > MAX_PTRS ||
      csi_prog::read_prog(ints, n_ints, at, A.prog))
    return -1;
  for (int q = 0; q < n_k; ++q) A.k[q] = consts[q];
  for (int q = 0; q < n_p; ++q) A.p[q] = static_cast<const float*>(ptrs[q]);
  if (n <= 0) return 0;
  pointwise<<<static_cast<unsigned>((n + BLOCK - 1) / BLOCK), BLOCK, 0,
              static_cast<cudaStream_t>(stream)>>>(A, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
