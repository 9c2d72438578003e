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
// (`_fixed_tile_prepare`'s wrap flags, pallas_evp_padded.py:585-588).
//
// What bounds it on an H100: per point 35 float32 operations with one exp
// (counted once per point in chip_smoke.py's PREP_FLOPS_PER_POINT) against
// 2 arrays read and 10 written, 48 bytes: at 522² 13 MB, 0.0039 ms at
// 3.35 TB/s, against 0.0002 ms of operations.  The call is bound by bytes.
//
// Design: a block of 32 × 8 threads owns 8 rows (x) by 32 columns (y, the
// contiguous axis) of outputs, one a thread.  Its threads load the
// (8 + 1) × (32 + 1) tile of h and ℵ in row-major order, the one-point halo
// at i−1 and j−1 included, through the images of the TPU kernel's gather
// (the integer remainder only for an index in the halo of a wrapped
// direction), and form m and P once a tile point in shared memory: one expf a point and a little over, where reading the
// neighbours' h and ℵ would take four.  Then each thread writes its ten
// outputs, coalesced along y.  The parameters travel in the launch as
// float32 values rounded on the host; c_α·Δt is formed here from the
// relaxation strength and the 0-d Δt on the device, one float32 product as
// the plain version forms it.  Two optional 0/1 masks (bytes, the
// peripheral nodes) zero act_u and act_v where they are set.
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

// ρ, P★, C, the relaxation strength c_α, Az, minimum mass and concentration
struct Params {
  float rho, Pstar, Chard, relax, az, mass_min, conc_min;
};

// Padded source index of padded index k along one direction: the interior
// image where it wraps, the clamped index where it does not.
__device__ __forceinline__ int image(int k, int ext, int H, int N, int wrap) {
  if (wrap) {
    if (k >= H && k < H + N) return k;
    int r = (k - H) % N;
    return H + (r < 0 ? r + N : r);
  }
  return k < 0 ? 0 : (k >= ext ? ext - 1 : k);
}

// The ten outputs of tile point (r, c), padded index k, in `_prep_kernel`'s
// operation order; act_u and act_v are 0 where `per_u`, `per_v`.
__device__ __forceinline__ void point(const Params& prm, float cadt,
                                      const float (&sm)[BY + 1][BX + 1],
                                      const float (&sP)[BY + 1][BX + 1],
                                      const float (&sa)[BY + 1][BX + 1], int r, int c, size_t k,
                                      size_t plane, bool per_u, bool per_v,
                                      float* __restrict__ out) {
  // ixf(iyf(q)) = 0.5·(0.5·(q + q[j−1]) + 0.5·(q[i−1] + q[i−1, j−1]))
  const float Pff = 0.5f * (0.5f * (sP[r][c] + sP[r][c - 1]) +
                            0.5f * (sP[r - 1][c] + sP[r - 1][c - 1]));
  const float m_ff = 0.5f * (0.5f * (sm[r][c] + sm[r][c - 1]) +
                             0.5f * (sm[r - 1][c] + sm[r - 1][c - 1]));
  const float m_cc = sm[r][c];
  const float m_fc = 0.5f * (m_cc + sm[r - 1][c]);
  const float a_fc = 0.5f * (sa[r][c] + sa[r - 1][c]);
  const float m_cf = 0.5f * (m_cc + sm[r][c - 1]);
  const float a_cf = 0.5f * (sa[r][c] + sa[r][c - 1]);

  const float gcc = m_cc > 0.0f ? cadt / (m_cc * prm.az) : -1.0f;
  const float gff = m_ff > 0.0f ? cadt / (m_ff * prm.az) : -1.0f;
  const float invm_u = m_fc > 0.0f ? 1.0f / m_fc : 0.0f;
  const float invm_v = m_cf > 0.0f ? 1.0f / m_cf : 0.0f;

  const bool act_u = m_fc >= prm.mass_min && a_fc >= prm.conc_min && !per_u;
  const bool act_v = m_cf >= prm.mass_min && a_cf >= prm.conc_min && !per_v;
  out[k] = sP[r][c];
  out[plane + k] = Pff;
  out[2 * plane + k] = gcc;
  out[3 * plane + k] = gff;
  out[4 * plane + k] = invm_u * a_fc;
  out[5 * plane + k] = invm_u;
  out[6 * plane + k] = act_u ? 1.0f : 0.0f;
  out[7 * plane + k] = invm_v * a_cf;
  out[8 * plane + k] = invm_v;
  out[9 * plane + k] = act_v ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(BX * BY) evp_prep_tile(
    const Params prm, const float* __restrict__ dt, const float* __restrict__ h,
    const float* __restrict__ a, const unsigned char* __restrict__ per_u,
    const unsigned char* __restrict__ per_v, float* __restrict__ out, int nxp, int nyp,
    int Hx, int Nx, int Hy, int Ny, int wrap_x, int wrap_y) {
  // tile row r, column c holds padded (i0 − 1 + r, j0 − 1 + c)
  __shared__ float sm[BY + 1][BX + 1], sP[BY + 1][BX + 1], sa[BY + 1][BX + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * BY, j0 = blockIdx.x * BX;
  const int i = i0 + ty, j = j0 + tx;
  const size_t plane = static_cast<size_t>(nxp) * nyp;
  const size_t k = static_cast<size_t>(i) * nyp + j;
  const bool inside = i < nxp && j < nyp;

  // this thread's loads that do not wait for the tile: Δt and its point's
  // masks, issued with the tile's
  const float dt0 = dt[0];
  const bool pu = per_u && inside && per_u[k];
  const bool pv = per_v && inside && per_v[k];

  // the tile point (r, c): its image's m, P and ℵ; a point past the
  // array's ragged edge reads the last row or column (its output is not
  // written)
  auto load = [&](int r, int c) {
    const int ii = image(min(i0 - 1 + r, nxp - 1), nxp, Hx, Nx, wrap_x);
    const int jj = image(min(j0 - 1 + c, nyp - 1), nyp, Hy, Ny, wrap_y);
    const size_t kk = static_cast<size_t>(ii) * nyp + jj;
    const float hv = h[kk];
    const float av = a[kk];
    sa[r][c] = av;
    sm[r][c] = hv * av * prm.rho;
    sP[r][c] = prm.Pstar * hv * expf(-prm.Chard * (1.0f - av));
  };
  // the tile's points in row-major order, consecutive threads on
  // consecutive points: 9·33 loads over 256 threads
  constexpr int TILE = (BY + 1) * (BX + 1);
#pragma unroll
  for (int q0 = 0; q0 < TILE; q0 += BX * BY) {
    const int q = q0 + ty * BX + tx;
    if (q < TILE) load(q / (BX + 1), q % (BX + 1));
  }
  __syncthreads();

  if (!inside) return;
  const float cadt = prm.relax * dt0;     // relaxation strength · Δt
  point(prm, cadt, sm, sP, sa, ty + 1, tx + 1, k, plane, pu, pv, out);
}

}  // namespace

// The ten coefficient planes of `out` (10 × nxp × nyp, row-major, y
// contiguous) from h and a (nxp × nyp) on `stream`: `params` a host array of
// the seven parameters, `dt` a 0-d device value, `per_u` and `per_v` the
// peripheral masks (bytes, or null for none); wrap_x / wrap_y are 1 where a
// direction is periodic and not split across ranks.  Returns 0, or the
// cudaGetLastError() after the launch.
extern "C" int csi_evp_prep(const float* params, const float* dt, const float* h,
                            const float* a, const unsigned char* per_u,
                            const unsigned char* per_v, float* out, int nxp, int nyp, int Hx,
                            int Nx, int Hy, int Ny, int wrap_x, int wrap_y, void* stream) {
  const Params prm{params[0], params[1], params[2], params[3], params[4], params[5],
                   params[6]};
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  evp_prep_tile<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      prm, dt, h, a, per_u, per_v, out, nxp, nyp, Hx, Nx, Hy, Ny, wrap_x, wrap_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
