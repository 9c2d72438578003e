// Split-explicit αEVP substep loop for NVIDIA Hopper (sm_90a).
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp.py::_evp_kernel`: the
// whole `nsub`-substep loop on interior-only, doubly periodic,
// uniform-metric float32 arrays (strain rates, Δ, ζ/η, replacement
// pressure, σ relaxation with the dynamic γ, α = γ, then the alternating
// semi-implicit u/v updates).
//
// What bounds it on an H100.  Per point and substep the function needs 142
// float32 operations, each value computed once at its own point (72 for
// the σ relaxation, 35 for each update; counted in chip_smoke.py's
// FLOPS_PER_POINT_SUBSTEP); the kernel below does 183, because a thread
// recomputes the strain rates of its neighbours.  A whole call only has to
// read 18 arrays and write 6, once.  At 512² and 120 substeps that is 4.5
// GFLOP (0.067 ms at 67 TFLOP/s) against 25 MB (7.5 µs at 3.35 TB/s): the
// call is bound by operations.  The TPU kernel keeps all 18 arrays on
// chip for every substep; no on-chip memory of the H100 holds a 512² state
// (18 MiB), so the carried state goes through the memory hierarchy on every
// substep here.
//
// Design (simple and right first).  Three kernels per substep, one thread
// per interior point, threadIdx.x along the contiguous y axis, periodic
// neighbours found by index wrap: `evp_stress` writes σ₁₁, σ₂₂, σ₁₂ and α,
// then `evp_u_update` and `evp_v_update` in the substep's order (odd
// substeps v then u, even substeps u then v; substeps count from 1).  That
// is about 33 array passes and 3 launches per substep.  The 512² state
// fits in the 50 MB L2, so most passes are served from L2 rather than HBM,
// and the cost is launch rate and L2 bandwidth, well above the bound.  The
// candidate for making it fast is the design of
// `pallas_evp_tiled.py::_tiled_kernel`: K substeps per tile in shared
// memory over a halo of width 2K+3.
//
// The updates are in place.  Each kernel writes, at its own point only,
// arrays that it reads only at that point:
//   evp_stress   reads u, v around the point and σ and the constants at the
//                point; writes σ₁₁, σ₂₂, σ₁₂, α (α is not read);
//   evp_u_update reads v, σ₁₁, σ₁₂, α around the point and u and the
//                constants at the point; writes u;
//   evp_v_update reads u, σ₂₂, σ₁₂, α around the point and v and the
//                constants at the point; writes v.
// So no thread of a launch reads a value that another thread of the same
// launch writes, and no second buffer is needed.
//
// Arithmetic: float32 with the TPU kernel's algebra and operation order
// (pallas_evp.py:213-315).  `rsqrtf` (the hardware reciprocal square root,
// not correctly rounded) stands for `lax.rsqrt`; `sqrtf` and division are
// IEEE because the build does not use --use_fast_math; nvcc contracts
// multiply-adds into FMAs (its default).  Both change results by ulps per
// substep only.

#include "evp_common.cuh"

namespace {

using namespace csi_evp;

// semi-implicit u update at (f,c) (pallas_evp.py:278-295)
__global__ void __launch_bounds__(BX * BY) evp_u_update(
    const float* __restrict__ prm,
    const float* __restrict__ drag_u, const float* __restrict__ invm_u,
    const float* __restrict__ act_u, const float* __restrict__ un,
    const float* __restrict__ v, const float* __restrict__ s11,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ u, int nx, int ny) {
  Point p;
  if (!locate(nx, ny, p)) return;

  const float inv_dt = 1.0f / prm[P_DT];
  const float inv_dx = 1.0f / prm[P_DX];
  const float inv_dy = 1.0f / prm[P_DY];
  const float f_cor = prm[P_F];
  const float tau_top = prm[P_TAUU];
  const float rC = prm[P_RC];
  const float ue = prm[P_UE];
  const float ve = prm[P_VE];

  const float div_x = (s11[p.k] - s11[p.row_m + p.j]) * inv_dx
                      + (s12[p.row_0 + p.jp] - s12[p.k]) * inv_dy;
  const float v_fc = 0.25f * ((v[p.k] + v[p.row_0 + p.jp])
                              + (v[p.row_m + p.j] + v[p.row_m + p.jp]));
  const float uk = u[p.k];
  const float du = ue - uk;
  const float dv = ve - v_fc;
  const float speed = sqrtf(du * du + dv * dv);
  const float drag = drag_u[p.k];
  const float invm = invm_u[p.k];
  const float tau_b = rC * speed * ue;
  const float tau_i = rC * speed * drag;  // implicit drag · a/m

  float G = f_cor * v_fc - tau_top * drag + tau_b * drag + div_x * invm
            + (un[p.k] - uk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al[p.k] + al[p.row_m + p.j]) * inv_dt;  // 1/Δτ
  const float uD = (uk * idtau + G) / (idtau + tau_i);
  u[p.k] = uD * act_u[p.k];
}

// semi-implicit v update at (c,f) (pallas_evp.py:297-314)
__global__ void __launch_bounds__(BX * BY) evp_v_update(
    const float* __restrict__ prm,
    const float* __restrict__ drag_v, const float* __restrict__ invm_v,
    const float* __restrict__ act_v, const float* __restrict__ vn,
    const float* __restrict__ u, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ v, int nx, int ny) {
  Point p;
  if (!locate(nx, ny, p)) return;

  const float inv_dt = 1.0f / prm[P_DT];
  const float inv_dx = 1.0f / prm[P_DX];
  const float inv_dy = 1.0f / prm[P_DY];
  const float f_cor = prm[P_F];
  const float tau_top = prm[P_TAUV];
  const float rC = prm[P_RC];
  const float ue = prm[P_UE];
  const float ve = prm[P_VE];

  const float div_y = (s22[p.k] - s22[p.row_0 + p.jm]) * inv_dy
                      + (s12[p.row_p + p.j] - s12[p.k]) * inv_dx;
  const float u_cf = 0.25f * ((u[p.k] + u[p.row_0 + p.jm])
                              + (u[p.row_p + p.j] + u[p.row_p + p.jm]));
  const float vk = v[p.k];
  const float dv = ve - vk;
  const float du = ue - u_cf;
  const float speed = sqrtf(du * du + dv * dv);
  const float drag = drag_v[p.k];
  const float invm = invm_v[p.k];
  const float tau_b = rC * speed * ve;
  const float tau_i = rC * speed * drag;

  float G = -f_cor * u_cf - tau_top * drag + tau_b * drag + div_y * invm
            + (vn[p.k] - vk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al[p.k] + al[p.row_0 + p.jm]) * inv_dt;
  const float vD = (vk * idtau + G) / (idtau + tau_i);
  v[p.k] = vD * act_v[p.k];
}

}  // namespace

// Runs `nsub` substeps on the current contents of u, v, s11, s22, s12, al
// (each nx×ny, row-major, y contiguous), in place, on `stream`.  Returns 0,
// or the first nonzero cudaGetLastError() after a launch.
extern "C" int csi_evp_substeps(
    const float* params,
    const float* P, const float* Pff, const float* gcc, const float* gff,
    const float* drag_u, const float* invm_u, const float* act_u,
    const float* un,
    const float* drag_v, const float* invm_v, const float* act_v,
    const float* vn,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    int nx, int ny, int nsub, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BX, BY);
  const dim3 grid((ny + BX - 1) / BX, (nx + BY - 1) / BY);
  cudaError_t err;
  for (int k = 1; k <= nsub; ++k) {
    evp_stress<<<grid, block, 0, s>>>(params, P, Pff, gcc, gff, u, v,
                                      s11, s22, s12, al, nx, ny);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      if ((k % 2 == 0) == (half == 0)) {
        evp_u_update<<<grid, block, 0, s>>>(params, drag_u, invm_u, act_u,
                                            un, v, s11, s12, al, u, nx, ny);
      } else {
        evp_v_update<<<grid, block, 0, s>>>(params, drag_v, invm_v, act_v,
                                            vn, u, s22, s12, al, v, nx, ny);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return 0;
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
