// Shared by evp.cu, evp_padded.cu, evp_tiled_padded.cu and evp_tiled.cu:
// the params layout, the thread layout, periodic point location and the
// tiles' index rules, the σ relaxation at one point and the kernel that
// runs it over an array, and the u and v updates at one point.
//
// `stress_point` computes, from the 3×3 u, v neighbourhood of a point, what
// the TPU kernels' `stresses` computes with circular rolls
// (pallas_evp.py:230-276, pallas_evp_padded.py:268-306; the two are the
// same algebra).  `evp_stress` runs it at every point of an nx×ny array
// with neighbours found by index wrap: evp_padded.cu on whole padded
// arrays (its per-phase plan, for halos too wide for its tiles), where the
// wrap over the padded extent matches `pltpu.roll` on the halo ring.  The
// tile engines (evp_periodic_tile.cuh for evp.cu and evp_tiled.cu,
// evp_padded_tile.cuh for evp_padded.cu and evp_tiled_padded.cu) run
// `stress_point`, `u_update_point` and `v_update_point` on tiles in shared
// memory.

#pragma once

#include <cuda_runtime.h>

namespace csi_evp {

// params layout, as in pallas_evp.py:44-46 (the last entry is padding)
enum Param {
  P_DT = 0, P_DX, P_DY, P_F, P_TAUU, P_TAUV, P_RC, P_UE, P_VE,
  P_EINV2, P_AMIN, P_AMAX, P_CALPHA, P_DMIN, P_MASSMIN, P_CONCMIN,
  P_REPL, P_NPARAMS
};

constexpr int BX = 32;  // threads along y (the contiguous axis)
constexpr int BY = 8;   // threads along x

struct Point {
  int i, j, k;            // x index, y index, linear index i*ny + j
  int row_m, row_0, row_p;  // i-1, i, i+1 rows (periodic), times ny
  int jm, jp;             // j-1, j+1 (periodic)
};

// g wrapped into [0, n), and g clamped to [lo, hi]: the tiled kernels'
// index rules
__device__ __forceinline__ int wrapi(int g, int n) {
  const int r = g % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int clampi(int g, int lo, int hi) {
  return g < lo ? lo : (g > hi ? hi : g);
}

__device__ __forceinline__ bool locate(int nx, int ny, Point& p) {
  p.j = blockIdx.x * BX + threadIdx.x;
  p.i = blockIdx.y * BY + threadIdx.y;
  if (p.i >= nx || p.j >= ny) return false;
  p.row_0 = p.i * ny;
  p.row_m = (p.i == 0 ? nx - 1 : p.i - 1) * ny;
  p.row_p = (p.i == nx - 1 ? 0 : p.i + 1) * ny;
  p.jm = p.j == 0 ? ny - 1 : p.j - 1;
  p.jp = p.j == ny - 1 ? 0 : p.j + 1;
  p.k = p.row_0 + p.j;
  return true;
}

// The parameters of the σ relaxation and of the updates, with their
// reciprocals and squares, formed from params by the operations the
// per-point functions used to apply at every point: a kernel may form them
// once per thread and pass them to every point it computes.
struct StressParams {
  float inv_dx, inv_dy, e_inv2, a_min, a_max, d_min, inv_dmin, amin2, amax2;
  bool repl_on;
};

__device__ __forceinline__ StressParams stress_params(const float* __restrict__ prm) {
  StressParams q;
  q.inv_dx = 1.0f / prm[P_DX];
  q.inv_dy = 1.0f / prm[P_DY];
  q.e_inv2 = prm[P_EINV2];
  q.a_min = prm[P_AMIN];
  q.a_max = prm[P_AMAX];
  q.d_min = prm[P_DMIN];
  q.inv_dmin = 1.0f / q.d_min;
  q.amin2 = q.a_min * q.a_min;
  q.amax2 = q.a_max * q.a_max;
  q.repl_on = prm[P_REPL] != 0.0f;
  return q;
}

struct UpdateParams {
  float inv_dt, inv_dx, inv_dy, f_cor, rC;
};

__device__ __forceinline__ UpdateParams update_params(const float* __restrict__ prm) {
  UpdateParams q;
  q.inv_dt = 1.0f / prm[P_DT];
  q.inv_dx = 1.0f / prm[P_DX];
  q.inv_dy = 1.0f / prm[P_DY];
  q.f_cor = prm[P_F];
  q.rC = prm[P_RC];
  return q;
}

// σ relaxation at one point: strain rates from the u, v neighbourhood
// U[a][b] = u(i + a − 1, j + b − 1) (V likewise), then Δ, ζ/η, the
// replacement pressure and the dynamic γ (pallas_evp.py:230-276).  Updates
// s11, s22, s12 in place and returns α.
__device__ __forceinline__ float stress_point(
    const StressParams& q, const float (&U)[3][3], const float (&V)[3][3],
    float P, float Pff, float gcc, float gff, float& s11, float& s22, float& s12) {
  const float inv_dx = q.inv_dx;
  const float inv_dy = q.inv_dy;
  const float e_inv2 = q.e_inv2;
  const float a_max = q.a_max;
  const float d_min = q.d_min;
  const float inv_dmin = q.inv_dmin;
  const float amin2 = q.amin2;
  const float amax2 = q.amax2;
  const bool repl_on = q.repl_on;

  // ϵ̇₁₁, ϵ̇₂₂ and their sum d / difference t at the cc points
  // (i + a - 1, j + b - 1), a, b ∈ {0, 1}
  float d[2][2], t[2][2], e11c = 0.0f, e22c = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float e11 = (U[a + 1][b] - U[a][b]) * inv_dx;
      const float e22 = (V[a][b + 1] - V[a][b]) * inv_dy;
      d[a][b] = e11 + e22;
      t[a][b] = e11 - e22;
      if (a == 1 && b == 1) {
        e11c = e11;
        e22c = e22;
      }
    }
  }
  // eS = 2ϵ̇₁₂ at the ff points (i + a - 1, j + b - 1), a, b ∈ {1, 2}
  float eS[2][2];
#pragma unroll
  for (int a = 1; a < 3; ++a) {
#pragma unroll
    for (int b = 1; b < 3; ++b) {
      eS[a - 1][b - 1] = (U[a][b] - U[a][b - 1]) * inv_dy
                         + (V[a][b] - V[a - 1][b]) * inv_dx;
    }
  }

  const float d_cc = d[1][1];
  const float t_cc = t[1][1];
  // cc → ff: 0.25·((q[i,j] + q[i,j-1]) + (q[i-1,j] + q[i-1,j-1]))
  const float d_ff = 0.25f * ((d[1][1] + d[1][0]) + (d[0][1] + d[0][0]));
  const float t_ff = 0.25f * ((t[1][1] + t[1][0]) + (t[0][1] + t[0][0]));
  // ff → cc: 0.25·((q[i,j] + q[i,j+1]) + (q[i+1,j] + q[i+1,j+1]))
  const float eS_ff = eS[0][0];
  const float eS_cc = 0.25f * ((eS[0][0] + eS[0][1]) + (eS[1][0] + eS[1][1]));

  const float dd_cc = d_cc * d_cc + (t_cc * t_cc + eS_cc * eS_cc) * e_inv2;
  const float dd_ff = d_ff * d_ff + (t_ff * t_ff + eS_ff * eS_ff) * e_inv2;
  const float rD_cc = fminf(rsqrtf(dd_cc), inv_dmin);  // 1/max(Δcc, Δmin)
  const float rD_ff = fminf(rsqrtf(dd_ff), inv_dmin);

  const float Ph = 0.5f * P;
  const float Pffh = 0.5f * Pff;
  const float zcc = Ph * rD_cc;
  const float zff = Pffh * rD_ff;

  float Prh = Ph;
  if (repl_on) {
    const float Dcc = fmaxf(dd_cc * rD_cc, d_min);
    Prh = Ph * Dcc / (Dcc + d_min);
  }

  const float eta_cc = zcc * e_inv2;
  const float eta_ff = zff * e_inv2;
  const float iso = (zcc - eta_cc) * d_cc - Prh;
  const float s11_t = 2.0f * eta_cc * e11c + iso;
  const float s22_t = 2.0f * eta_cc * e22c + iso;
  const float s12_t = eta_ff * eS_ff;

  // dynamic relaxation γ = clamp(√(ζ·cαΔt/m/Az)); α⁺ where m ≤ 0
  const float g2cc = fminf(fmaxf(zcc * gcc, amin2), amax2);
  const float g2ff = fminf(fmaxf(zff * gff, amin2), amax2);
  const float rg_cc = rsqrtf(g2cc);
  const float rg_ff = rsqrtf(g2ff);
  const bool ok_cc = gcc > 0.0f;
  const bool ok_ff = gff > 0.0f;

  s11 = s11 + (ok_cc ? (s11_t - s11) * rg_cc : 0.0f);
  s22 = s22 + (ok_cc ? (s22_t - s22) * rg_cc : 0.0f);
  s12 = s12 + (ok_ff ? (s12_t - s12) * rg_ff : 0.0f);
  return ok_cc ? g2cc * rg_cc : a_max;
}

__device__ __forceinline__ float stress_point(
    const float* __restrict__ prm, const float (&U)[3][3], const float (&V)[3][3],
    float P, float Pff, float gcc, float gff, float& s11, float& s22, float& s12) {
  return stress_point(stress_params(prm), U, V, P, Pff, gcc, gff, s11, s22, s12);
}

// σ relaxation at every point of an nx×ny array, neighbours by index wrap.
__global__ void __launch_bounds__(BX * BY) evp_stress(
    const float* __restrict__ prm,
    const float* __restrict__ P, const float* __restrict__ Pff,
    const float* __restrict__ gcc, const float* __restrict__ gff,
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ s11, float* __restrict__ s22,
    float* __restrict__ s12, float* __restrict__ al, int nx, int ny) {
  Point p;
  if (!locate(nx, ny, p)) return;

  // U[a][b] = u at (i + a - 1, j + b - 1); V likewise
  const int rows[3] = {p.row_m, p.row_0, p.row_p};
  const int cols[3] = {p.jm, p.j, p.jp};
  float U[3][3], V[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      U[a][b] = u[rows[a] + cols[b]];
      V[a][b] = v[rows[a] + cols[b]];
    }
  }
  float s11_k = s11[p.k], s22_k = s22[p.k], s12_k = s12[p.k];
  const float al_k = stress_point(prm, U, V, P[p.k], Pff[p.k], gcc[p.k], gff[p.k],
                                  s11_k, s22_k, s12_k);
  s11[p.k] = s11_k;
  s22[p.k] = s22_k;
  s12[p.k] = s12_k;
  al[p.k] = al_k;
}

// The semi-implicit u update at one (f,c) point of the padded kernels
// (pallas_evp_padded.py:308-323).  Suffixes name the neighbour a value is
// taken at: _w (i−1, j), _n (i, j+1), _wn (i−1, j+1).  s11m and s12m are σ
// already multiplied by their masks; the immersed-drag coefficients
// imms/immn are read only with has_drag.
__device__ __forceinline__ float u_update_point(
    const UpdateParams& q, float s11m, float s11m_w, float s12m, float s12m_n,
    float v, float v_n, float v_w, float v_wn, float ve, float ve_n, float ve_w,
    float ve_wn, float uk, float u_n, float ue, float tau, float drag, float invm,
    float un, float act, bool has_drag, float imms, float immn, float al, float al_w) {
  const float inv_dt = q.inv_dt;
  const float inv_dx = q.inv_dx;
  const float inv_dy = q.inv_dy;
  const float f_cor = q.f_cor;
  const float rC = q.rC;
  const float div_x = (s11m - s11m_w) * inv_dx + (s12m_n - s12m) * inv_dy;
  // (c,f) → (f,c): 0.25·((q[i,j] + q[i,j+1]) + (q[i-1,j] + q[i-1,j+1]))
  const float v_fc = 0.25f * ((v + v_n) + (v_w + v_wn));
  const float ve_fc = 0.25f * ((ve + ve_n) + (ve_w + ve_wn));
  const float du = ue - uk;
  const float dv = ve_fc - v_fc;
  const float speed = sqrtf(du * du + dv * dv);
  float G = f_cor * v_fc - tau * drag + rC * speed * ue * drag + div_x * invm;
  if (has_drag) G = G - (imms * uk + immn * u_n) * invm;
  G = G + (un - uk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al + al_w) * inv_dt;  // 1/Δτ
  return (uk * idtau + G) / (idtau + rC * speed * drag) * act;
}

// The semi-implicit v update at one (c,f) point of the padded kernels
// (pallas_evp_padded.py:325-340).  Suffixes: _s (i, j−1), _e (i+1, j),
// _es (i+1, j−1).
__device__ __forceinline__ float v_update_point(
    const UpdateParams& q, float s22m, float s22m_s, float s12m, float s12m_e,
    float u, float u_s, float u_e, float u_es, float ue, float ue_s, float ue_e,
    float ue_es, float vk, float v_e, float ve, float tau, float drag, float invm,
    float vn, float act, bool has_drag, float immw, float imme, float al, float al_s) {
  const float inv_dt = q.inv_dt;
  const float inv_dx = q.inv_dx;
  const float inv_dy = q.inv_dy;
  const float f_cor = q.f_cor;
  const float rC = q.rC;
  const float div_y = (s22m - s22m_s) * inv_dy + (s12m_e - s12m) * inv_dx;
  // (f,c) → (c,f): 0.25·((q[i,j] + q[i,j-1]) + (q[i+1,j] + q[i+1,j-1]))
  const float u_cf = 0.25f * ((u + u_s) + (u_e + u_es));
  const float ue_cf = 0.25f * ((ue + ue_s) + (ue_e + ue_es));
  const float dv = ve - vk;
  const float du = ue_cf - u_cf;
  const float speed = sqrtf(du * du + dv * dv);
  float G = -f_cor * u_cf - tau * drag + rC * speed * ve * drag + div_y * invm;
  if (has_drag) G = G - (immw * vk + imme * v_e) * invm;
  G = G + (vn - vk) * inv_dt;
  G = invm > 0.0f ? G : 0.0f;
  const float idtau = 0.5f * (al + al_s) * inv_dt;
  return (vk * idtau + G) / (idtau + rC * speed * drag) * act;
}

__device__ __forceinline__ float u_update_point(
    const float* __restrict__ prm, float s11m, float s11m_w, float s12m, float s12m_n,
    float v, float v_n, float v_w, float v_wn, float ve, float ve_n, float ve_w,
    float ve_wn, float uk, float u_n, float ue, float tau, float drag, float invm,
    float un, float act, bool has_drag, float imms, float immn, float al, float al_w) {
  return u_update_point(update_params(prm), s11m, s11m_w, s12m, s12m_n, v, v_n, v_w, v_wn,
                        ve, ve_n, ve_w, ve_wn, uk, u_n, ue, tau, drag, invm, un, act,
                        has_drag, imms, immn, al, al_w);
}

__device__ __forceinline__ float v_update_point(
    const float* __restrict__ prm, float s22m, float s22m_s, float s12m, float s12m_e,
    float u, float u_s, float u_e, float u_es, float ue, float ue_s, float ue_e,
    float ue_es, float vk, float v_e, float ve, float tau, float drag, float invm,
    float vn, float act, bool has_drag, float immw, float imme, float al, float al_s) {
  return v_update_point(update_params(prm), s22m, s22m_s, s12m, s12m_e, u, u_s, u_e, u_es,
                        ue, ue_s, ue_e, ue_es, vk, v_e, ve, tau, drag, invm, vn, act,
                        has_drag, immw, imme, al, al_s);
}

}  // namespace csi_evp
