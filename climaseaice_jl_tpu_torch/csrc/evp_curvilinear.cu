// Curvilinear split-explicit αEVP substep loop for NVIDIA Hopper (sm_90a):
// array metrics, the Zipper fold, f as a scalar or as f(φ) planes, walls,
// land masks and the linear immersed drag.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_curvilinear.py::
// _curvilinear_kernel` and, on one card, computes the function of
// `pallas_evp_tiled_curvilinear.py::_tiled_curv_kernel`: the whole `nsub`-
// substep loop on halo-inclusive (nxp, nyp) float32 arrays of a latitude-
// longitude, curvilinear or tripolar grid, with the full SBP strain rates
// and stress divergence on 8 metric arrays and 4 inverse areas
// (pallas_evp_curvilinear.py:323-394).  After every half-update u (f,c) or
// v (c,f) has its halos refilled as `_make_fillers_folded` does
// (pallas_evp_curvilinear.py:131-199): periodic or bounded x, then y with a
// bounded south edge (u copies row Hy, v is zero beyond face Hy) and, on a
// folded grid, the Zipper fold of the north edge:
//   u row Hy+Ny+k    ← −u(fold_f(i), Hy+Ny−1−k), fold_f(i) = (Nx−(i−Hx)) mod Nx + Hx
//   v seam row Hy+Ny ← 0.5·(v(i) − v(fold_c(i))), fold_c(i) = (Nx−1−(i−Hx)) mod Nx + Hx
//   v row Hy+Ny+k    ← −v(fold_c(i), Hy+Ny−k), k ≥ 1.
// The x fill and the fold compose into one gather: every fold source
// column is an interior column.  σ is never fold-filled in the loop: its
// halo rows are computed from the fold-filled velocities.
//
// What bounds it on an H100.  Per padded point and substep the function
// needs 185 float32 operations with drag, each value computed once at its
// own point as the plain version computes it (σ relaxation 84, the metric
// stress divergences 31, each update 35; 175 without drag; counted in
// chip_smoke.py's CURV_FLOPS_PER_POINT_SUBSTEP), and 16 per point and call
// for the loop-invariant forms.  The kernel below does 311: a σ thread
// computes ϵ̇D and ϵ̇T at 4 cc points and ϵ̇S at 4 ff points, an update
// thread recomputes its neighbours' masked σ and the transverse averages
// of the ocean velocity.  A call only has to read 42 arrays (12 metrics,
// 14 constants, 4 drag, 4 stresses, 2 f planes, 6 carried fields) and write
// 6.  At the tripolar basin's 1162×970 padded points and 120 substeps that
// is 25 GFLOP (0.37 ms at 67 TFLOP/s) against 216 MB (0.065 ms at 3.35
// TB/s): the call is bound by operations.
//
// Design, as evp_padded.cu: one thread per padded point, threadIdx.x along
// the contiguous y axis, neighbours by index wrap over the padded extent
// (the TPU kernel's `pltpu.roll`).  One prep launch (`curv_prep`) computes
// the loop-invariant forms into a scratch block: the metric forms (Δ²,
// reciprocals), the transverse averages of the ocean velocity (ve at (f,c),
// ue at (c,f)), τ·drag for u and v, and one byte a point holding the 0/1
// arrays act_u, act_v, msk_cc and msk_ff as bits; and it flags the settled
// blocks (below).  Two launches fill the incoming u and v; then per
// substep three launches: `curv_stress`, then `curv_u_update` and
// `curv_v_update` in the substep's order (odd substeps v then u, even u
// then v).  A thread of an update kernel maps its point to the source of
// the composed fill and computes the update there, so a fill costs no pass
// of its own; the v seam thread computes the update at its own column and
// at its mirror.  u and v ping-pong between the caller's buffer and a
// scratch buffer, because halo and seam threads read the neighbourhoods of
// points that other threads of the same launch write.
//
// Settled blocks.  A point is dead where gcc ≤ 0, gff ≤ 0, act_u = act_v =
// 0 and 1/m ≤ 0 at (f,c) and (c,f): there σ relaxes by +0 (σ + 0 from the
// first substep on), α = α⁺, and an update with G = 0 and act = 0 gives
// u = (u·1/Δτ)/(1/Δτ)·0, which is +0 from the second substep on (the sign
// of the first substep's zero follows u's), given finite velocities nearby
// and α⁺ > 0.  The prep launch flags a block of the launch grid as settled
// where every point within one of its points, and within one of every fill
// source its threads compute at (the fold's and the seam mirror's
// included), is dead: then every value the block writes is fixed after
// substep 2, and by the end of substep 3 both buffers of u and of v hold
// it.  From substep FIRST_SKIPPED = 4 on a settled block returns at once,
// in all three launches; nothing is read back to the host.  On the
// tripolar basin 76 % of the blocks are settled: the southern rows that
// are land across every x (the TPU tier crops those rows) and the
// continents.  A grid with no land has no settled block and pays one
// flag load a block.
//
// f: with `f_fc`/`f_cf` null the scalar f of params is used at every point,
// otherwise the two planes; an FPlane gives bit for bit the scalar form.
//
// Arithmetic: the TPU kernel's algebra and operation order, `rsqrtf` for
// `lax.rsqrt`, IEEE `sqrtf` and division (no --use_fast_math).  The per-point
// code lives in evp_curvilinear_point.cuh, shared with the pinned tiled
// kernel (evp_tiled_curvilinear.cu); both are built with -fmad=false, so
// the two give the same bits on the same input.

#include "evp_curvilinear_point.cuh"

namespace {

using namespace csi_curv;

constexpr int FIRST_SKIPPED = 4;   // the first substep a settled block skips

// the forms of the prep launch after csi_curv's metric forms
enum CurvForm { F_VE_FC = N_FORMS, F_UE_CF, F_TAUD_U, F_TAUD_V, N_CURV_FORMS };

__device__ __forceinline__ bool settled_block(const int* __restrict__ settled, int skip) {
  return skip && settled[blockIdx.y * gridDim.x + blockIdx.x];
}

__device__ __forceinline__ bool locate_point(const Layout& L, int& i, int& j, int& k) {
  j = blockIdx.x * BX + threadIdx.x;
  i = blockIdx.y * BY + threadIdx.y;
  if (i >= L.nxp || j >= L.nyp) return false;
  k = i * L.nyp + j;
  return true;
}

// a point where the loop leaves σ, α, u and v at fixed values
__device__ __forceinline__ bool dead(const Consts& c, int k) {
  return c.gcc[k] <= 0.0f && c.gff[k] <= 0.0f && c.act_u[k] == 0.0f && c.act_v[k] == 0.0f &&
         c.invm_u[k] <= 0.0f && c.invm_v[k] <= 0.0f;
}

// every point within one of (i, j), by wrap over the padded extent, dead
__device__ __forceinline__ bool dead_around(const Consts& c, const Layout& L, int i, int j) {
  bool d = true;
#pragma unroll
  for (int a = -1; a <= 1; ++a) {
    const int r = wrap(i + a, L.nxp) * L.nyp;
#pragma unroll
    for (int b = -1; b <= 1; ++b) d = d && dead(c, r + wrap(j + b, L.nyp));
  }
  return d;
}

// The loop-invariant forms at point k (Δ²cc, Δ²ff, 1/Δ at the faces as
// pallas_evp_curvilinear.py:237-250; the ocean velocity's transverse
// averages, τ·drag and the flag bits as the updates form them), and each
// block's settled flag.
__global__ void __launch_bounds__(BX * BY) curv_prep(
    const float* __restrict__ dx_cc, const float* __restrict__ dx_fc,
    const float* __restrict__ dx_cf, const float* __restrict__ dx_ff,
    const float* __restrict__ dy_cc, const float* __restrict__ dy_fc,
    const float* __restrict__ dy_cf, const float* __restrict__ dy_ff, Consts c, Layout L,
    float* __restrict__ forms, unsigned char* __restrict__ bits, int* __restrict__ settled) {
  int i, j, k;
  bool ok = true;
  if (locate_point(L, i, j, k)) {
    const long long n = static_cast<long long>(L.nxp) * L.nyp;
    forms[F_DY_CC2 * n + k] = dy_cc[k] * dy_cc[k];
    forms[F_DX_CC2 * n + k] = dx_cc[k] * dx_cc[k];
    forms[F_DX_FF2 * n + k] = dx_ff[k] * dx_ff[k];
    forms[F_DY_FF2 * n + k] = dy_ff[k] * dy_ff[k];
    forms[F_INV_DY_FC * n + k] = 1.0f / dy_fc[k];
    forms[F_INV_DX_CF * n + k] = 1.0f / dx_cf[k];
    forms[F_INV_DX_FC * n + k] = 1.0f / dx_fc[k];
    forms[F_INV_DY_CF * n + k] = 1.0f / dy_cf[k];
    const int ny = L.nyp;
    const int iw = wrap(i - 1, L.nxp) * ny, ie = wrap(i + 1, L.nxp) * ny, r = i * ny;
    const int jn = wrap(j + 1, ny), js = wrap(j - 1, ny);
    const RawForms raw{&c};
    forms[F_VE_FC * n + k] = raw.ve_fc(k, r + jn, iw + j, iw + jn);
    forms[F_UE_CF * n + k] = raw.ue_cf(k, r + js, ie + j, ie + js);
    forms[F_TAUD_U * n + k] = raw.tau_drag_u(k, c.drag_u[k]);
    forms[F_TAUD_V * n + k] = raw.tau_drag_v(k, c.drag_v[k]);
    bits[k] = static_cast<unsigned char>((c.act_u[k] != 0.0f ? B_ACT_U : 0) |
                                         (c.act_v[k] != 0.0f ? B_ACT_V : 0) |
                                         (c.msk_cc[k] != 0.0f ? B_MSK_CC : 0) |
                                         (c.msk_ff[k] != 0.0f ? B_MSK_FF : 0));
    int si, sj, sm = 0;
    ok = dead_around(c, L, i, j);
    if (ok && u_source(L, i, j, si, sj) != 0.0f) ok = dead_around(c, L, si, sj);
    const int kind = v_source(L, i, j, si, sj, sm);
    if (ok && kind != V_ZERO) ok = dead_around(c, L, si, sj);
    if (ok && kind == V_SEAM) ok = dead_around(c, L, sm, sj);
  }
  const int all = __syncthreads_and(ok);
  if (threadIdx.x == 0 && threadIdx.y == 0) settled[blockIdx.y * gridDim.x + blockIdx.x] = all;
}

// Halo fills of the incoming u and v into other arrays.
__global__ void __launch_bounds__(BX * BY) fill_u(const float* __restrict__ in,
                                                 float* __restrict__ out, Layout L) {
  int i, j, k, si, sj;
  if (!locate_point(L, i, j, k)) return;
  const float sign = u_source(L, i, j, si, sj);
  out[k] = sign == 0.0f ? 0.0f : sign * in[si * L.nyp + sj];
}

__global__ void __launch_bounds__(BX * BY) fill_v(const float* __restrict__ in,
                                                 float* __restrict__ out, Layout L) {
  int i, j, k, si, sj, sm = 0;
  if (!locate_point(L, i, j, k)) return;
  const int kind = v_source(L, i, j, si, sj, sm);
  const int ny = L.nyp;
  float val = 0.0f;
  if (kind == V_COPY) val = in[si * ny + sj];
  else if (kind == V_FLIP) val = -in[si * ny + sj];
  else if (kind == V_SEAM) val = 0.5f * (in[si * ny + sj] - in[sm * ny + sj]);
  out[k] = val;
}

// σ relaxation (pallas_evp_curvilinear.py:323-373)
__global__ void __launch_bounds__(BX * BY) curv_stress(
    const float* __restrict__ prm, Metrics m, Consts c, Layout L,
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ s11, float* __restrict__ s22,
    float* __restrict__ s12, float* __restrict__ al, const int* __restrict__ settled,
    int skip) {
  int i, j, k;
  if (settled_block(settled, skip) || !locate_point(L, i, j, k)) return;
  const int nx = L.nxp, ny = L.nyp;
  // rows and columns at offsets -1, 0, +1 (wrapped over the padded extent)
  const int R[3] = {wrap(i - 1, nx) * ny, i * ny, wrap(i + 1, nx) * ny};
  const int C[3] = {wrap(j - 1, ny), j, wrap(j + 1, ny)};

  stress_at(prm, m, c, u, v, R, C, k, s11, s22, s12, al);
}

// the u and v updates at (si, sj), neighbours by wrap over the padded extent
__device__ __forceinline__ float u_here(const float* prm, const Metrics& m, const Consts& c,
                                        const CallForms& F, const Layout& L, int has_drag,
                                        const float* u, const float* v, const float* s11,
                                        const float* s22, const float* s12, const float* al,
                                        int si, int sj) {
  const int ny = L.nyp;
  const int iw = wrap(si - 1, L.nxp), jn = wrap(sj + 1, ny);
  return u_at(prm, m, c, F, has_drag, u, v, s11, s22, s12, al, si * ny + sj, iw * ny + sj,
              si * ny + jn, iw * ny + jn);
}

__device__ __forceinline__ float v_here(const float* prm, const Metrics& m, const Consts& c,
                                        const CallForms& F, const Layout& L, int has_drag,
                                        const float* u, const float* v, const float* s11,
                                        const float* s22, const float* s12, const float* al,
                                        int si, int sj) {
  const int ny = L.nyp;
  const int js = wrap(sj - 1, ny), ie = wrap(si + 1, L.nxp);
  return v_at(prm, m, c, F, has_drag, u, v, s11, s22, s12, al, si * ny + sj, si * ny + js,
              ie * ny + sj, ie * ny + js);
}

// u update followed by the (f,c) fill with the fold
__global__ void __launch_bounds__(BX * BY) curv_u_update(
    const float* __restrict__ prm, Metrics m, Consts c, CallForms F, Layout L, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ u_out, const int* __restrict__ settled, int skip) {
  int i, j, k, si, sj;
  if (settled_block(settled, skip) || !locate_point(L, i, j, k)) return;
  const float sign = u_source(L, i, j, si, sj);
  u_out[k] = sign == 0.0f ? 0.0f
             : sign * u_here(prm, m, c, F, L, has_drag, u, v, s11, s22, s12, al, si, sj);
}

// v update followed by the (c,f) fill with the fold: the seam row takes
// 0.5·(v(i) − v(mirror)) of two freshly updated values
__global__ void __launch_bounds__(BX * BY) curv_v_update(
    const float* __restrict__ prm, Metrics m, Consts c, CallForms F, Layout L, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ v_out, const int* __restrict__ settled, int skip) {
  int i, j, k, si, sj, sm = 0;
  if (settled_block(settled, skip) || !locate_point(L, i, j, k)) return;
  const int kind = v_source(L, i, j, si, sj, sm);
  float val = 0.0f;
  if (kind != V_ZERO) {
    val = v_here(prm, m, c, F, L, has_drag, u, v, s11, s22, s12, al, si, sj);
    if (kind == V_FLIP) {
      val = -val;
    } else if (kind == V_SEAM) {
      val = 0.5f * (val - v_here(prm, m, c, F, L, has_drag, u, v, s11, s22, s12, al, sm, sj));
    }
  }
  v_out[k] = val;
}

}  // namespace

// Runs `nsub` substeps on the current contents of u, v, s11, s22, s12, al
// (each nxp×nyp, row-major, y contiguous) on `stream`; u_tmp and v_tmp are
// scratch arrays of that shape, `forms` scratch for N_CURV_FORMS (12) of
// them, `bits` scratch of nxp·nyp bytes and `settled` one int per block of
// the launch grid (ceil(nyp / 32) · ceil(nxp / 8), row-major by block row
// along x).  act_u, act_v, msk_cc and msk_ff must hold only 0 and 1.  The
// results are left in u, v, s11, s22, s12, al, the settled flags in
// `settled`.  The drag arrays may be null when has_drag is 0, f_fc and f_cf
// null for the scalar f of params.  Returns 0, or the first nonzero
// cudaGetLastError() after a launch.
extern "C" int csi_evp_curvilinear_substeps(
    const float* params,
    const float* dx_cc, const float* dx_fc, const float* dx_cf, const float* dx_ff,
    const float* dy_cc, const float* dy_fc, const float* dy_cf, const float* dy_ff,
    const float* inv_az_cc, const float* inv_az_fc, const float* inv_az_cf,
    const float* inv_az_ff,
    const float* P, const float* Pff, const float* gcc, const float* gff,
    const float* drag_u, const float* invm_u, const float* act_u, const float* un,
    const float* drag_v, const float* invm_v, const float* act_v, const float* vn,
    const float* msk_cc, const float* msk_ff,
    const float* imms_u, const float* immn_u, const float* immw_v,
    const float* imme_v,
    const float* tau_u, const float* tau_v, const float* ue, const float* ve,
    const float* f_fc, const float* f_cf,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    float* u_tmp, float* v_tmp, float* forms, unsigned char* bits, int* settled,
    int nxp, int nyp, int Hx, int Nx, int Hy, int Ny, int per_x, int per_y,
    int fold, int has_drag, int nsub, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{nxp, nyp, Hx, Nx, Hy, Ny, per_x, per_y, fold};
  const long long n = static_cast<long long>(nxp) * nyp;
  const Metrics m{dy_fc, dx_cf, inv_az_cc, inv_az_fc, inv_az_cf, inv_az_ff,
                  forms + F_DY_CC2 * n, forms + F_DX_CC2 * n,
                  forms + F_DX_FF2 * n, forms + F_DY_FF2 * n,
                  forms + F_INV_DY_FC * n, forms + F_INV_DX_CF * n,
                  forms + F_INV_DX_FC * n, forms + F_INV_DY_CF * n};
  const Consts c{P, Pff, gcc, gff, drag_u, invm_u, act_u, un, drag_v, invm_v,
                 act_v, vn, msk_cc, msk_ff, imms_u, immn_u, immw_v, imme_v,
                 tau_u, tau_v, ue, ve, f_fc, f_cf};
  const CallForms F{bits, forms + F_VE_FC * n, forms + F_UE_CF * n, forms + F_TAUD_U * n,
                    forms + F_TAUD_V * n};
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  cudaError_t err;

  curv_prep<<<grid, block, 0, s>>>(dx_cc, dx_fc, dx_cf, dx_ff, dy_cc, dy_fc, dy_cf, dy_ff, c,
                                   L, forms, bits, settled);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  float* u_cur = u_tmp;
  float* u_oth = u;
  float* v_cur = v_tmp;
  float* v_oth = v;
  fill_u<<<grid, block, 0, s>>>(u, u_cur, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fill_v<<<grid, block, 0, s>>>(v, v_cur, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  for (int k = 1; k <= nsub; ++k) {
    const int skip = k >= FIRST_SKIPPED;
    curv_stress<<<grid, block, 0, s>>>(params, m, c, L, u_cur, v_cur, s11, s22,
                                       s12, al, settled, skip);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      if ((k % 2 == 0) == (half == 0)) {
        curv_u_update<<<grid, block, 0, s>>>(params, m, c, F, L, has_drag, u_cur,
                                             v_cur, s11, s22, s12, al, u_oth, settled, skip);
        float* t = u_cur;
        u_cur = u_oth;
        u_oth = t;
      } else {
        curv_v_update<<<grid, block, 0, s>>>(params, m, c, F, L, has_drag, u_cur,
                                             v_cur, s11, s22, s12, al, v_oth, settled, skip);
        float* t = v_cur;
        v_cur = v_oth;
        v_oth = t;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  const size_t bytes = sizeof(float) * static_cast<size_t>(n);
  if (u_cur != u &&
      (err = cudaMemcpyAsync(u, u_cur, bytes, cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return err;
  if (v_cur != v &&
      (err = cudaMemcpyAsync(v, v_cur, bytes, cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return err;
  return 0;
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
