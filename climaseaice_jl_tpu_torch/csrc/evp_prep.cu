// Fixed-tile EVP coefficients for NVIDIA Hopper (sm_90a).
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_padded.py::_prep_kernel`
// (run over fixed tiles by `_fixed_tile_prepare`): from h and ℵ on the
// padded (nxp, nyp) arrays, the ten constant arrays of the EVP substep loop,
// P, Pff, gcc, gff, drag_u, invm_u, act_u, drag_v, invm_v, act_v.  A point
// needs its own h, ℵ and those of its i−1, j−1 and (i−1, j−1) neighbours.
// The TPU kernel gathers halo-extended tiles, wrapping into the interior
// along a periodic direction and clamping at the padded edge along a
// bounded one, and along one split across the ranks of the distributed step
// (`_fixed_tile_prepare`'s wrap flags, pallas_evp_padded.py:585-588); here a
// thread reads those images directly.
//
// What bounds it on an H100: per point 35 float32 operations with one exp
// (counted once per point in chip_smoke.py's PREP_FLOPS_PER_POINT) against
// 2 arrays read and 10 written, 48 bytes: at 522² 13 MB, 0.0039 ms at
// 3.35 TB/s, against 0.0002 ms of operations.  The call is bound by bytes;
// a thread recomputes P and m at its three neighbours (4× the exp), which
// costs nothing against that bound.
//
// Design: one thread per padded point, threadIdx.x along the contiguous y
// axis; the ten outputs are planes of one (10, nxp, nyp) array.
//
// Arithmetic: `_prep_kernel`'s operation order, IEEE division, `expf` (the
// function torch.exp calls on the card).  This source is built with
// -fmad=false (`_build.py`): no multiply-add is contracted, so a point's
// bits do not depend on the launch, the array shape or the halo width, and
// the kernel computes what its plain PyTorch version computes.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads along y (the contiguous axis)
constexpr int BY = 8;   // threads along x

// Padded source index of padded index k along one direction: the interior
// image where it wraps, the clamped index where it does not.
__device__ __forceinline__ int image(int k, int ext, int H, int N, int wrap) {
  if (wrap) {
    int r = (k - H) % N;
    return H + (r < 0 ? r + N : r);
  }
  return k < 0 ? 0 : (k >= ext ? ext - 1 : k);
}

__global__ void __launch_bounds__(BX * BY) evp_prep(
    const float* __restrict__ prm, const float* __restrict__ h,
    const float* __restrict__ a, float* __restrict__ out, int nxp, int nyp,
    int Hx, int Nx, int Hy, int Ny, int wrap_x, int wrap_y) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const float rho = prm[0];
  const float Pstar = prm[1];
  const float Chard = prm[2];
  const float cadt = prm[3];      // relaxation strength · Δt
  const float az = prm[4];
  const float mass_min = prm[5];
  const float conc_min = prm[6];

  // [0] the i−1 or j−1 image, [1] the point itself
  const int xs[2] = {image(i - 1, nxp, Hx, Nx, wrap_x), image(i, nxp, Hx, Nx, wrap_x)};
  const int ys[2] = {image(j - 1, nyp, Hy, Ny, wrap_y), image(j, nyp, Hy, Ny, wrap_y)};
  float m[2][2], P[2][2], av[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = xs[p] * nyp + ys[q];
      const float hv = h[k];
      av[p][q] = a[k];
      m[p][q] = hv * av[p][q] * rho;
      P[p][q] = Pstar * hv * expf(-Chard * (1.0f - av[p][q]));
    }
  }
  // ixf(iyf(q)) = 0.5·(0.5·(q + q[j−1]) + 0.5·(q[i−1] + q[i−1, j−1]))
  const float Pff = 0.5f * (0.5f * (P[1][1] + P[1][0]) + 0.5f * (P[0][1] + P[0][0]));
  const float m_ff = 0.5f * (0.5f * (m[1][1] + m[1][0]) + 0.5f * (m[0][1] + m[0][0]));
  const float m_cc = m[1][1];
  const float m_fc = 0.5f * (m_cc + m[0][1]);
  const float a_fc = 0.5f * (av[1][1] + av[0][1]);
  const float m_cf = 0.5f * (m_cc + m[1][0]);
  const float a_cf = 0.5f * (av[1][1] + av[1][0]);

  const float gcc = m_cc > 0.0f ? cadt / (m_cc * az) : -1.0f;
  const float gff = m_ff > 0.0f ? cadt / (m_ff * az) : -1.0f;
  const float invm_u = m_fc > 0.0f ? 1.0f / m_fc : 0.0f;
  const float invm_v = m_cf > 0.0f ? 1.0f / m_cf : 0.0f;

  const size_t plane = static_cast<size_t>(nxp) * nyp;
  const size_t k = static_cast<size_t>(i) * nyp + j;
  out[k] = P[1][1];
  out[plane + k] = Pff;
  out[2 * plane + k] = gcc;
  out[3 * plane + k] = gff;
  out[4 * plane + k] = invm_u * a_fc;
  out[5 * plane + k] = invm_u;
  out[6 * plane + k] = (m_fc >= mass_min && a_fc >= conc_min) ? 1.0f : 0.0f;
  out[7 * plane + k] = invm_v * a_cf;
  out[8 * plane + k] = invm_v;
  out[9 * plane + k] = (m_cf >= mass_min && a_cf >= conc_min) ? 1.0f : 0.0f;
}

}  // namespace

// The ten coefficient planes of `out` (10 × nxp × nyp, row-major, y
// contiguous) from h and a (nxp × nyp) on `stream`; wrap_x / wrap_y are 1
// where a direction is periodic and not split across ranks.  Returns 0, or the
// cudaGetLastError() after the launch.
extern "C" int csi_evp_prep(const float* params, const float* h, const float* a,
                            float* out, int nxp, int nyp, int Hx, int Nx, int Hy,
                            int Ny, int wrap_x, int wrap_y, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  evp_prep<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      params, h, a, out, nxp, nyp, Hx, Nx, Hy, Ny, wrap_x, wrap_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
