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
// Design (simple and right first), as evp_padded.cu: one thread per padded
// point, threadIdx.x along the contiguous y axis, neighbours by index wrap
// over the padded extent (the TPU kernel's `pltpu.roll`).  One prep launch
// computes the loop-invariant metric forms (Δ², reciprocals) into a scratch
// block; two launches fill the incoming u and v; then per substep three
// launches: `curv_stress`, then `curv_u_update` and `curv_v_update` in the
// substep's order (odd substeps v then u, even u then v).  A thread of an
// update kernel maps its point to the source of the composed fill and
// computes the update there, so a fill costs no pass of its own; the v seam
// thread computes the update at its own column and at its mirror.  u and v
// ping-pong between the caller's buffer and a scratch buffer, because halo
// and seam threads read the neighbourhoods of points that other threads of
// the same launch write.  Rows that are land across every x run like any
// other; their results are the values the TPU tier's solid-row crop writes
// there (u = v = 0, σ unchanged, α = α⁺), so no crop is needed for the
// numbers.
//
// f: with `f_fc`/`f_cf` null the scalar f of params is used at every point,
// otherwise the two planes; an FPlane gives bit for bit the scalar form.
//
// Arithmetic: the TPU kernel's algebra and operation order, `rsqrtf` for
// `lax.rsqrt`, IEEE `sqrtf` and division (no --use_fast_math), nvcc's
// default FMA contraction.

#include "evp_common.cuh"

namespace {

using namespace csi_evp;

struct Layout {
  int nxp, nyp;        // padded extents
  int Hx, Nx, Hy, Ny;  // halos and interior sizes
  int per_x, per_y;    // 1 where the direction is periodic, 0 where bounded
  int fold;            // 1 on a north-folded grid
};

// the loop-invariant metric forms, in the prep launch's output order
enum Form {
  F_DY_CC2 = 0, F_DX_CC2, F_DX_FF2, F_DY_FF2,
  F_INV_DY_FC, F_INV_DX_CF, F_INV_DX_FC, F_INV_DY_CF, N_FORMS
};

struct Metrics {
  const float *dy_fc, *dx_cf;
  const float *inv_az_cc, *inv_az_fc, *inv_az_cf, *inv_az_ff;
  const float *dy_cc2, *dx_cc2, *dx_ff2, *dy_ff2;
  const float *inv_dy_fc, *inv_dx_cf, *inv_dx_fc, *inv_dy_cf;
};

// The constant arrays of one call.  The drag arrays are null without drag,
// the f planes null for a scalar f.
struct Consts {
  const float *P, *Pff, *gcc, *gff;
  const float *drag_u, *invm_u, *act_u, *un;
  const float *drag_v, *invm_v, *act_v, *vn;
  const float *msk_cc, *msk_ff;
  const float *imms_u, *immn_u, *immw_v, *imme_v;
  const float *tau_u, *tau_v, *ue, *ve;
  const float *f_fc, *f_cf;
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ int mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Source index of padded index i along one direction of the halo fill, or
// -1 where the fill writes zero (pallas_evp_curvilinear.py:143-189).
__device__ __forceinline__ int fill_source(int i, int H, int N, int periodic,
                                           bool face) {
  if (H == 0) return i;
  if (periodic) return i < H ? i + N : (i >= H + N ? i - N : i);
  if (face) return (i < H || i > H + N) ? -1 : i;
  return i < H ? H : (i >= H + N ? H + N - 1 : i);
}

// the interior column that the fold maps onto padded column i
__device__ __forceinline__ int fold_column(const Layout& L, int i, bool face) {
  return mod((face ? L.Nx : L.Nx - 1) - (i - L.Hx), L.Nx) + L.Hx;
}

// Where the (f,c) fill of u takes padded (i, j) from: (si, sj) and a sign,
// 0 where the fill writes zero.
__device__ __forceinline__ float u_source(const Layout& L, int i, int j,
                                          int& si, int& sj) {
  if (L.fold && j >= L.Hy + L.Ny) {
    si = fold_column(L, i, true);
    sj = 2 * (L.Hy + L.Ny) - 1 - j;
    return -1.0f;
  }
  si = fill_source(i, L.Hx, L.Nx, L.per_x, true);
  sj = fill_source(j, L.Hy, L.Ny, L.per_y, false);
  return (si < 0 || sj < 0) ? 0.0f : 1.0f;
}

enum VSource { V_ZERO, V_COPY, V_FLIP, V_SEAM };

// Where the (c,f) fill of v takes padded (i, j) from: (si, sj), and for the
// seam row also the mirror column sm.
__device__ __forceinline__ int v_source(const Layout& L, int i, int j, int& si,
                                        int& sj, int& sm) {
  const int seam = L.Hy + L.Ny;
  if (L.fold && j >= seam) {
    sm = fold_column(L, i, false);
    if (j == seam) {
      si = fill_source(i, L.Hx, L.Nx, L.per_x, false);
      sj = seam;
      return V_SEAM;
    }
    si = sm;
    sj = 2 * seam - j;
    return V_FLIP;
  }
  si = fill_source(i, L.Hx, L.Nx, L.per_x, false);
  sj = fill_source(j, L.Hy, L.Ny, L.per_y, true);
  return (si < 0 || sj < 0) ? V_ZERO : V_COPY;
}

__device__ __forceinline__ bool locate_point(const Layout& L, int& i, int& j, int& k) {
  j = blockIdx.x * BX + threadIdx.x;
  i = blockIdx.y * BY + threadIdx.y;
  if (i >= L.nxp || j >= L.nyp) return false;
  k = i * L.nyp + j;
  return true;
}

// Δ²cc, Δ²ff, 1/Δ at the faces (pallas_evp_curvilinear.py:237-250)
__global__ void __launch_bounds__(256) metric_forms(
    const float* __restrict__ dx_cc, const float* __restrict__ dx_fc,
    const float* __restrict__ dx_cf, const float* __restrict__ dx_ff,
    const float* __restrict__ dy_cc, const float* __restrict__ dy_fc,
    const float* __restrict__ dy_cf, const float* __restrict__ dy_ff,
    float* __restrict__ forms, long long n) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  forms[F_DY_CC2 * n + k] = dy_cc[k] * dy_cc[k];
  forms[F_DX_CC2 * n + k] = dx_cc[k] * dx_cc[k];
  forms[F_DX_FF2 * n + k] = dx_ff[k] * dx_ff[k];
  forms[F_DY_FF2 * n + k] = dy_ff[k] * dy_ff[k];
  forms[F_INV_DY_FC * n + k] = 1.0f / dy_fc[k];
  forms[F_INV_DX_CF * n + k] = 1.0f / dx_cf[k];
  forms[F_INV_DX_FC * n + k] = 1.0f / dx_fc[k];
  forms[F_INV_DY_CF * n + k] = 1.0f / dy_cf[k];
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

// ϵ̇D, ϵ̇T at the cc point k, with k_e = (i+1, j), k_n = (i, j+1)
__device__ __forceinline__ void strain_cc(const Metrics& m, const float* u,
                                          const float* v, int k, int k_e, int k_n,
                                          float& eD, float& eT) {
  const float u_dy = u[k] * m.dy_fc[k];
  const float u_dy_e = u[k_e] * m.dy_fc[k_e];
  const float v_dx = v[k] * m.dx_cf[k];
  const float v_dx_n = v[k_n] * m.dx_cf[k_n];
  eD = ((u_dy_e - u_dy) + (v_dx_n - v_dx)) * m.inv_az_cc[k];
  const float u_ody = u[k] * m.inv_dy_fc[k];
  const float u_ody_e = u[k_e] * m.inv_dy_fc[k_e];
  const float v_odx = v[k] * m.inv_dx_cf[k];
  const float v_odx_n = v[k_n] * m.inv_dx_cf[k_n];
  eT = (m.dy_cc2[k] * (u_ody_e - u_ody) - m.dx_cc2[k] * (v_odx_n - v_odx))
       * m.inv_az_cc[k];
}

// ϵ̇S (= 2ϵ̇₁₂) at the ff point k, with k_s = (i, j-1), k_w = (i-1, j)
__device__ __forceinline__ float strain_ff(const Metrics& m, const float* u,
                                           const float* v, int k, int k_s, int k_w) {
  const float u_odx = u[k] * m.inv_dx_fc[k];
  const float u_odx_s = u[k_s] * m.inv_dx_fc[k_s];
  const float v_ody = v[k] * m.inv_dy_cf[k];
  const float v_ody_w = v[k_w] * m.inv_dy_cf[k_w];
  return (m.dx_ff2[k] * (u_odx - u_odx_s) + m.dy_ff2[k] * (v_ody - v_ody_w))
         * m.inv_az_ff[k];
}

// σ relaxation (pallas_evp_curvilinear.py:323-373)
__global__ void __launch_bounds__(BX * BY) curv_stress(
    const float* __restrict__ prm, Metrics m, Consts c, Layout L,
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ s11, float* __restrict__ s22,
    float* __restrict__ s12, float* __restrict__ al) {
  int i, j, k;
  if (!locate_point(L, i, j, k)) return;
  const int nx = L.nxp, ny = L.nyp;
  // rows and columns at offsets -1, 0, +1 (wrapped over the padded extent)
  const int R[3] = {wrap(i - 1, nx) * ny, i * ny, wrap(i + 1, nx) * ny};
  const int C[3] = {wrap(j - 1, ny), j, wrap(j + 1, ny)};

  // ϵ̇D, ϵ̇T at the cc points (i + a - 1, j + b - 1), a, b ∈ {0, 1}
  float eD[2][2], eT[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      strain_cc(m, u, v, R[a] + C[b], R[a + 1] + C[b], R[a] + C[b + 1],
                eD[a][b], eT[a][b]);
    }
  }
  // ϵ̇S at the ff points (i + a - 1, j + b - 1), a, b ∈ {1, 2}
  float eS[2][2];
#pragma unroll
  for (int a = 1; a < 3; ++a) {
#pragma unroll
    for (int b = 1; b < 3; ++b) {
      eS[a - 1][b - 1] = strain_ff(m, u, v, R[a] + C[b], R[a] + C[b - 1],
                                   R[a - 1] + C[b]);
    }
  }

  const float e_inv2 = prm[P_EINV2];
  const float a_max = prm[P_AMAX];
  const float a_min = prm[P_AMIN];
  const float d_min = prm[P_DMIN];
  const float inv_dmin = 1.0f / d_min;
  const float amin2 = a_min * a_min;
  const float amax2 = a_max * a_max;
  const bool repl_on = prm[P_REPL] != 0.0f;

  const float eDc = eD[1][1];
  const float eTc = eT[1][1];
  // cc → ff: 0.25·((q[i,j] + q[i,j-1]) + (q[i-1,j] + q[i-1,j-1]))
  const float d_ff = 0.25f * ((eD[1][1] + eD[1][0]) + (eD[0][1] + eD[0][0]));
  const float t_ff = 0.25f * ((eT[1][1] + eT[1][0]) + (eT[0][1] + eT[0][0]));
  // ff → cc: 0.25·((q[i,j] + q[i,j+1]) + (q[i+1,j] + q[i+1,j+1]))
  const float eS_ff = eS[0][0];
  const float eS_cc = 0.25f * ((eS[0][0] + eS[0][1]) + (eS[1][0] + eS[1][1]));

  const float dd_cc = eDc * eDc + (eTc * eTc + eS_cc * eS_cc) * e_inv2;
  const float dd_ff = d_ff * d_ff + (t_ff * t_ff + eS_ff * eS_ff) * e_inv2;
  const float rD_cc = fminf(rsqrtf(dd_cc), inv_dmin);  // 1/max(Δcc, Δmin)
  const float rD_ff = fminf(rsqrtf(dd_ff), inv_dmin);

  const float Ph = 0.5f * c.P[k];
  const float Pffh = 0.5f * c.Pff[k];
  const float zcc = Ph * rD_cc;
  const float zff = Pffh * rD_ff;
  float Prh = Ph;
  if (repl_on) {
    const float Dcc = fmaxf(dd_cc * rD_cc, d_min);
    Prh = Ph * Dcc / (Dcc + d_min);
  }
  const float eta_cc = zcc * e_inv2;
  const float eta_ff = zff * e_inv2;
  const float iso = (zcc - eta_cc) * eDc - Prh;
  const float s11_t = eta_cc * (eDc + eTc) + iso;
  const float s22_t = eta_cc * (eDc - eTc) + iso;
  const float s12_t = eta_ff * eS_ff;

  const float gcc = c.gcc[k];
  const float gff = c.gff[k];
  const float g2cc = fminf(fmaxf(zcc * gcc, amin2), amax2);
  const float g2ff = fminf(fmaxf(zff * gff, amin2), amax2);
  const float rg_cc = rsqrtf(g2cc);
  const float rg_ff = rsqrtf(g2ff);
  const bool ok_cc = gcc > 0.0f;
  const bool ok_ff = gff > 0.0f;

  const float s11_0 = s11[k];
  const float s22_0 = s22[k];
  const float s12_0 = s12[k];
  s11[k] = s11_0 + (ok_cc ? (s11_t - s11_0) * rg_cc : 0.0f);
  s22[k] = s22_0 + (ok_cc ? (s22_t - s22_0) * rg_cc : 0.0f);
  s12[k] = s12_0 + (ok_ff ? (s12_t - s12_0) * rg_ff : 0.0f);
  al[k] = ok_cc ? g2cc * rg_cc : a_max;
}

// the semi-implicit u update at (si, sj) (pallas_evp_curvilinear.py:375-408)
__device__ __forceinline__ float u_at(const float* prm, const Metrics& m,
                                      const Consts& c, const Layout& L, int has_drag,
                                      const float* u, const float* v,
                                      const float* s11, const float* s22,
                                      const float* s12, const float* al,
                                      int si, int sj) {
  const int ny = L.nyp;
  const int ks = si * ny + sj;                        // (i, j)
  const int kw = wrap(si - 1, L.nxp) * ny + sj;       // (i-1, j)
  const int jn = wrap(sj + 1, ny);
  const int kn = si * ny + jn;                        // (i, j+1)
  const int kwn = wrap(si - 1, L.nxp) * ny + jn;      // (i-1, j+1)

  const float inv_dt = 1.0f / prm[P_DT];
  const float rC = prm[P_RC];
  const float f = c.f_fc ? c.f_fc[ks] : prm[P_F];

  // divergence of σ at (f,c) from the masked σ
  const float s11m = s11[ks] * c.msk_cc[ks], s22m = s22[ks] * c.msk_cc[ks];
  const float s11m_w = s11[kw] * c.msk_cc[kw], s22m_w = s22[kw] * c.msk_cc[kw];
  const float sD = s11m + s22m, sD_w = s11m_w + s22m_w;
  const float yT = m.dy_cc2[ks] * (s11m - s22m);
  const float yT_w = m.dy_cc2[kw] * (s11m_w - s22m_w);
  const float xS = m.dx_ff2[ks] * (s12[ks] * c.msk_ff[ks]);
  const float xS_n = m.dx_ff2[kn] * (s12[kn] * c.msk_ff[kn]);
  const float div_x = (m.dy_fc[ks] * (sD - sD_w) * 0.5f
                       + (yT - yT_w) * m.inv_dy_fc[ks] * 0.5f
                       + (xS_n - xS) * m.inv_dx_fc[ks]) * m.inv_az_fc[ks];

  // (c,f) → (f,c): 0.25·((q[i,j] + q[i,j+1]) + (q[i-1,j] + q[i-1,j+1]))
  const float v_fc = 0.25f * ((v[ks] + v[kn]) + (v[kw] + v[kwn]));
  const float ve_fc = 0.25f * ((c.ve[ks] + c.ve[kn]) + (c.ve[kw] + c.ve[kwn]));
  const float uk = u[ks];
  const float ue = c.ue[ks];
  const float du = ue - uk;
  const float dv = ve_fc - v_fc;
  const float speed = sqrtf(du * du + dv * dv);
  const float drag = c.drag_u[ks];
  const float invm = c.invm_u[ks];

  float G = f * v_fc - c.tau_u[ks] * drag + rC * speed * ue * drag + div_x * invm;
  if (has_drag) G = G - (c.imms_u[ks] * uk + c.immn_u[ks] * u[kn]) * invm;
  G = G + (c.un[ks] - uk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al[ks] + al[kw]) * inv_dt;  // 1/Δτ
  return (uk * idtau + G) / (idtau + rC * speed * drag) * c.act_u[ks];
}

// the semi-implicit v update at (si, sj) (pallas_evp_curvilinear.py:375-422)
__device__ __forceinline__ float v_at(const float* prm, const Metrics& m,
                                      const Consts& c, const Layout& L, int has_drag,
                                      const float* u, const float* v,
                                      const float* s11, const float* s22,
                                      const float* s12, const float* al,
                                      int si, int sj) {
  const int ny = L.nyp;
  const int ks = si * ny + sj;                        // (i, j)
  const int js = wrap(sj - 1, ny);
  const int kso = si * ny + js;                       // (i, j-1)
  const int ie = wrap(si + 1, L.nxp);
  const int ke = ie * ny + sj;                        // (i+1, j)
  const int kes = ie * ny + js;                       // (i+1, j-1)

  const float inv_dt = 1.0f / prm[P_DT];
  const float rC = prm[P_RC];
  const float f = c.f_cf ? c.f_cf[ks] : prm[P_F];

  // divergence of σ at (c,f) from the masked σ
  const float s11m = s11[ks] * c.msk_cc[ks], s22m = s22[ks] * c.msk_cc[ks];
  const float s11m_s = s11[kso] * c.msk_cc[kso], s22m_s = s22[kso] * c.msk_cc[kso];
  const float sD = s11m + s22m, sD_s = s11m_s + s22m_s;
  const float xT = m.dx_cc2[ks] * (s11m - s22m);
  const float xT_s = m.dx_cc2[kso] * (s11m_s - s22m_s);
  const float yS = m.dy_ff2[ks] * (s12[ks] * c.msk_ff[ks]);
  const float yS_e = m.dy_ff2[ke] * (s12[ke] * c.msk_ff[ke]);
  const float div_y = (m.dx_cf[ks] * (sD - sD_s) * 0.5f
                       - (xT - xT_s) * m.inv_dx_cf[ks] * 0.5f
                       + (yS_e - yS) * m.inv_dy_cf[ks]) * m.inv_az_cf[ks];

  // (f,c) → (c,f): 0.25·((q[i,j] + q[i,j-1]) + (q[i+1,j] + q[i+1,j-1]))
  const float u_cf = 0.25f * ((u[ks] + u[kso]) + (u[ke] + u[kes]));
  const float ue_cf = 0.25f * ((c.ue[ks] + c.ue[kso]) + (c.ue[ke] + c.ue[kes]));
  const float vk = v[ks];
  const float ve = c.ve[ks];
  const float dv = ve - vk;
  const float du = ue_cf - u_cf;
  const float speed = sqrtf(du * du + dv * dv);
  const float drag = c.drag_v[ks];
  const float invm = c.invm_v[ks];

  float G = -f * u_cf - c.tau_v[ks] * drag + rC * speed * ve * drag + div_y * invm;
  if (has_drag) G = G - (c.immw_v[ks] * vk + c.imme_v[ks] * v[ke]) * invm;
  G = G + (c.vn[ks] - vk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al[ks] + al[kso]) * inv_dt;
  return (vk * idtau + G) / (idtau + rC * speed * drag) * c.act_v[ks];
}

// u update followed by the (f,c) fill with the fold
__global__ void __launch_bounds__(BX * BY) curv_u_update(
    const float* __restrict__ prm, Metrics m, Consts c, Layout L, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ u_out) {
  int i, j, k, si, sj;
  if (!locate_point(L, i, j, k)) return;
  const float sign = u_source(L, i, j, si, sj);
  u_out[k] = sign == 0.0f ? 0.0f
             : sign * u_at(prm, m, c, L, has_drag, u, v, s11, s22, s12, al, si, sj);
}

// v update followed by the (c,f) fill with the fold: the seam row takes
// 0.5·(v(i) − v(mirror)) of two freshly updated values
__global__ void __launch_bounds__(BX * BY) curv_v_update(
    const float* __restrict__ prm, Metrics m, Consts c, Layout L, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ v_out) {
  int i, j, k, si, sj, sm = 0;
  if (!locate_point(L, i, j, k)) return;
  const int kind = v_source(L, i, j, si, sj, sm);
  float val = 0.0f;
  if (kind != V_ZERO) {
    val = v_at(prm, m, c, L, has_drag, u, v, s11, s22, s12, al, si, sj);
    if (kind == V_FLIP) {
      val = -val;
    } else if (kind == V_SEAM) {
      val = 0.5f * (val - v_at(prm, m, c, L, has_drag, u, v, s11, s22, s12, al, sm, sj));
    }
  }
  v_out[k] = val;
}

}  // namespace

// Runs `nsub` substeps on the current contents of u, v, s11, s22, s12, al
// (each nxp×nyp, row-major, y contiguous) on `stream`; u_tmp and v_tmp are
// scratch arrays of that shape and `forms` scratch for 8 of them.  The
// results are left in u, v, s11, s22, s12, al.  The drag arrays may be null
// when has_drag is 0, f_fc and f_cf null for the scalar f of params.
// Returns 0, or the first nonzero cudaGetLastError() after a launch.
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
    float* u_tmp, float* v_tmp, float* forms,
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
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  cudaError_t err;

  metric_forms<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      dx_cc, dx_fc, dx_cf, dx_ff, dy_cc, dy_fc, dy_cf, dy_ff, forms, n);
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
    curv_stress<<<grid, block, 0, s>>>(params, m, c, L, u_cur, v_cur, s11, s22,
                                       s12, al);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      if ((k % 2 == 0) == (half == 0)) {
        curv_u_update<<<grid, block, 0, s>>>(params, m, c, L, has_drag, u_cur,
                                             v_cur, s11, s22, s12, al, u_oth);
        float* t = u_cur;
        u_cur = u_oth;
        u_oth = t;
      } else {
        curv_v_update<<<grid, block, 0, s>>>(params, m, c, L, has_drag, u_cur,
                                             v_cur, s11, s22, s12, al, v_oth);
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
