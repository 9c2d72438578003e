// Shared by evp_curvilinear.cu (kernel 2.6) and evp_tiled_curvilinear.cu
// (kernel 2.7): the per-point σ relaxation, metric stress divergences and
// semi-implicit u and v updates of the curvilinear αEVP substep
// (pallas_evp_curvilinear.py:323-422, which pallas_evp_tiled_curvilinear.py:
// 843-941 repeats), and the sources of 2.6's halo fills with the Zipper
// fold.  The callers find the neighbours: 2.6 by index wrap over the padded
// extent, 2.7 by wrap into the interior along a periodic direction and
// clamp at the padded edge along a bounded one.  Both read the 0/1 masks,
// the ocean velocity's transverse averages and τ·drag through `CallForms`,
// formed by their prep launches.  Both sources are built with -fmad=false,
// so this code rounds alike in both.

#pragma once

#include "evp_common.cuh"

namespace csi_curv {

using namespace csi_evp;

struct Layout {
  int nxp, nyp;        // padded extents
  int Hx, Nx, Hy, Ny;  // halos and interior sizes
  int per_x, per_y;    // 1 where the direction is periodic, 0 where bounded
  int fold;            // 1 on a north-folded grid
};

// the loop-invariant metric forms, in the prep launches' output order
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

// How an update reads the loop constants that are 0/1 flags, the transverse
// averages of the ocean velocity and the top stress times the drag.
// `RawForms` reads and forms them from the caller's arrays, as the plain
// version's operations do: the prep launches of 2.6 and 2.7 form them so,
// once per call, and the updates read them through `CallForms` below.
struct RawForms {
  const Consts* c;
  __device__ __forceinline__ float msk_cc(int k) const { return c->msk_cc[k]; }
  __device__ __forceinline__ float msk_ff(int k) const { return c->msk_ff[k]; }
  __device__ __forceinline__ float act_u(int k) const { return c->act_u[k]; }
  __device__ __forceinline__ float act_v(int k) const { return c->act_v[k]; }
  // (c,f) → (f,c): 0.25·((q[i,j] + q[i,j+1]) + (q[i-1,j] + q[i-1,j+1]))
  __device__ __forceinline__ float ve_fc(int ks, int kn, int kw, int kwn) const {
    return 0.25f * ((c->ve[ks] + c->ve[kn]) + (c->ve[kw] + c->ve[kwn]));
  }
  // (f,c) → (c,f): 0.25·((q[i,j] + q[i,j-1]) + (q[i+1,j] + q[i+1,j-1]))
  __device__ __forceinline__ float ue_cf(int ks, int kso, int ke, int kes) const {
    return 0.25f * ((c->ue[ks] + c->ue[kso]) + (c->ue[ke] + c->ue[kes]));
  }
  __device__ __forceinline__ float tau_drag_u(int k, float drag) const {
    return c->tau_u[k] * drag;
  }
  __device__ __forceinline__ float tau_drag_v(int k, float drag) const {
    return c->tau_v[k] * drag;
  }
};

// bits of the flag byte of a point (2.6 and 2.7 set the first four, 2.7
// also the fifth)
enum FlagBit { B_ACT_U = 1, B_ACT_V = 2, B_MSK_CC = 4, B_MSK_FF = 8, B_DEAD = 16 };

// The updates' reader of the forms a prep launch makes once per call
// (RawForms' values: the flags are 0 or 1, the averages and products the
// same operations), at the update's own point.
struct CallForms {
  const unsigned char* __restrict__ bits;
  const float* __restrict__ ve_fc_;
  const float* __restrict__ ue_cf_;
  const float* __restrict__ taud_u;
  const float* __restrict__ taud_v;
  __device__ __forceinline__ float msk_cc(int k) const { return (bits[k] & B_MSK_CC) ? 1.0f : 0.0f; }
  __device__ __forceinline__ float msk_ff(int k) const { return (bits[k] & B_MSK_FF) ? 1.0f : 0.0f; }
  __device__ __forceinline__ float act_u(int k) const { return (bits[k] & B_ACT_U) ? 1.0f : 0.0f; }
  __device__ __forceinline__ float act_v(int k) const { return (bits[k] & B_ACT_V) ? 1.0f : 0.0f; }
  __device__ __forceinline__ float ve_fc(int ks, int, int, int) const { return ve_fc_[ks]; }
  __device__ __forceinline__ float ue_cf(int ks, int, int, int) const { return ue_cf_[ks]; }
  __device__ __forceinline__ float tau_drag_u(int k, float) const { return taud_u[k]; }
  __device__ __forceinline__ float tau_drag_v(int k, float) const { return taud_v[k]; }
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

// σ relaxation at one point (pallas_evp_curvilinear.py:323-373).  R holds
// the neighbours' rows (offsets −1, 0, +1, times nyp) and C their columns;
// σ and α are read and written at k, the constants read at k.
__device__ __forceinline__ void stress_at(const float* __restrict__ prm, const Metrics& m,
                                          const Consts& c, const float* u, const float* v,
                                          const int (&R)[3], const int (&C)[3], int k,
                                          float* s11, float* s22, float* s12, float* al) {
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

// the semi-implicit u update at ks (pallas_evp_curvilinear.py:375-408), with
// kw = (i-1, j), kn = (i, j+1), kwn = (i-1, j+1)
template <class Forms>
__device__ __forceinline__ float u_at(const float* prm, const Metrics& m, const Consts& c,
                                      const Forms& F, int has_drag, const float* u,
                                      const float* v, const float* s11, const float* s22,
                                      const float* s12, const float* al,
                                      int ks, int kw, int kn, int kwn) {
  const float inv_dt = 1.0f / prm[P_DT];
  const float rC = prm[P_RC];
  const float f = c.f_fc ? c.f_fc[ks] : prm[P_F];

  // divergence of σ at (f,c) from the masked σ
  const float mk = F.msk_cc(ks), mk_w = F.msk_cc(kw);
  const float s11m = s11[ks] * mk, s22m = s22[ks] * mk;
  const float s11m_w = s11[kw] * mk_w, s22m_w = s22[kw] * mk_w;
  const float sD = s11m + s22m, sD_w = s11m_w + s22m_w;
  const float yT = m.dy_cc2[ks] * (s11m - s22m);
  const float yT_w = m.dy_cc2[kw] * (s11m_w - s22m_w);
  const float xS = m.dx_ff2[ks] * (s12[ks] * F.msk_ff(ks));
  const float xS_n = m.dx_ff2[kn] * (s12[kn] * F.msk_ff(kn));
  const float div_x = (m.dy_fc[ks] * (sD - sD_w) * 0.5f
                       + (yT - yT_w) * m.inv_dy_fc[ks] * 0.5f
                       + (xS_n - xS) * m.inv_dx_fc[ks]) * m.inv_az_fc[ks];

  // (c,f) → (f,c): 0.25·((q[i,j] + q[i,j+1]) + (q[i-1,j] + q[i-1,j+1]))
  const float v_fc = 0.25f * ((v[ks] + v[kn]) + (v[kw] + v[kwn]));
  const float ve_fc = F.ve_fc(ks, kn, kw, kwn);
  const float uk = u[ks];
  const float ue = c.ue[ks];
  const float du = ue - uk;
  const float dv = ve_fc - v_fc;
  const float speed = sqrtf(du * du + dv * dv);
  const float drag = c.drag_u[ks];
  const float invm = c.invm_u[ks];

  float G = f * v_fc - F.tau_drag_u(ks, drag) + rC * speed * ue * drag + div_x * invm;
  if (has_drag) G = G - (c.imms_u[ks] * uk + c.immn_u[ks] * u[kn]) * invm;
  G = G + (c.un[ks] - uk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al[ks] + al[kw]) * inv_dt;  // 1/Δτ
  return (uk * idtau + G) / (idtau + rC * speed * drag) * F.act_u(ks);
}


// the semi-implicit v update at ks (pallas_evp_curvilinear.py:375-422), with
// kso = (i, j-1), ke = (i+1, j), kes = (i+1, j-1)
template <class Forms>
__device__ __forceinline__ float v_at(const float* prm, const Metrics& m, const Consts& c,
                                      const Forms& F, int has_drag, const float* u,
                                      const float* v, const float* s11, const float* s22,
                                      const float* s12, const float* al,
                                      int ks, int kso, int ke, int kes) {
  const float inv_dt = 1.0f / prm[P_DT];
  const float rC = prm[P_RC];
  const float f = c.f_cf ? c.f_cf[ks] : prm[P_F];

  // divergence of σ at (c,f) from the masked σ
  const float mk = F.msk_cc(ks), mk_s = F.msk_cc(kso);
  const float s11m = s11[ks] * mk, s22m = s22[ks] * mk;
  const float s11m_s = s11[kso] * mk_s, s22m_s = s22[kso] * mk_s;
  const float sD = s11m + s22m, sD_s = s11m_s + s22m_s;
  const float xT = m.dx_cc2[ks] * (s11m - s22m);
  const float xT_s = m.dx_cc2[kso] * (s11m_s - s22m_s);
  const float yS = m.dy_ff2[ks] * (s12[ks] * F.msk_ff(ks));
  const float yS_e = m.dy_ff2[ke] * (s12[ke] * F.msk_ff(ke));
  const float div_y = (m.dx_cf[ks] * (sD - sD_s) * 0.5f
                       - (xT - xT_s) * m.inv_dx_cf[ks] * 0.5f
                       + (yS_e - yS) * m.inv_dy_cf[ks]) * m.inv_az_cf[ks];

  // (f,c) → (c,f): 0.25·((q[i,j] + q[i,j-1]) + (q[i+1,j] + q[i+1,j-1]))
  const float u_cf = 0.25f * ((u[ks] + u[kso]) + (u[ke] + u[kes]));
  const float ue_cf = F.ue_cf(ks, kso, ke, kes);
  const float vk = v[ks];
  const float ve = c.ve[ks];
  const float dv = ve - vk;
  const float du = ue_cf - u_cf;
  const float speed = sqrtf(du * du + dv * dv);
  const float drag = c.drag_v[ks];
  const float invm = c.invm_v[ks];

  float G = -f * u_cf - F.tau_drag_v(ks, drag) + rC * speed * ve * drag + div_y * invm;
  if (has_drag) G = G - (c.immw_v[ks] * vk + c.imme_v[ks] * v[ke]) * invm;
  G = G + (c.vn[ks] - vk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al[ks] + al[kso]) * inv_dt;
  return (vk * idtau + G) / (idtau + rC * speed * drag) * F.act_v(ks);
}

}  // namespace csi_curv
