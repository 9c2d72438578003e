// Shared by evp.cu and evp_padded.cu: the params layout, the thread
// layout, periodic point location and the σ relaxation kernel.
//
// `evp_stress` computes, at every point of an nx×ny array with neighbours
// found by index wrap, what the TPU kernels' `stresses` computes with
// circular rolls (pallas_evp.py:230-276, pallas_evp_padded.py:268-306; the
// two are the same algebra).  evp.cu runs it on interior-only periodic
// arrays, evp_padded.cu on whole padded arrays, where the wrap over the
// padded extent matches `pltpu.roll` on the halo ring.

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

// σ relaxation: strain rates from the u, v neighbourhood, then Δ, ζ/η, the
// replacement pressure and the dynamic γ (pallas_evp.py:230-276).
__global__ void __launch_bounds__(BX * BY) evp_stress(
    const float* __restrict__ prm,
    const float* __restrict__ P, const float* __restrict__ Pff,
    const float* __restrict__ gcc_, const float* __restrict__ gff_,
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

  const float inv_dx = 1.0f / prm[P_DX];
  const float inv_dy = 1.0f / prm[P_DY];
  const float e_inv2 = prm[P_EINV2];
  const float a_min = prm[P_AMIN];
  const float a_max = prm[P_AMAX];
  const float d_min = prm[P_DMIN];
  const float inv_dmin = 1.0f / d_min;
  const float amin2 = a_min * a_min;
  const float amax2 = a_max * a_max;
  const bool repl_on = prm[P_REPL] != 0.0f;

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

  const float Ph = 0.5f * P[p.k];
  const float Pffh = 0.5f * Pff[p.k];
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
  const float gcc = gcc_[p.k];
  const float gff = gff_[p.k];
  const float g2cc = fminf(fmaxf(zcc * gcc, amin2), amax2);
  const float g2ff = fminf(fmaxf(zff * gff, amin2), amax2);
  const float rg_cc = rsqrtf(g2cc);
  const float rg_ff = rsqrtf(g2ff);
  const bool ok_cc = gcc > 0.0f;
  const bool ok_ff = gff > 0.0f;

  const float s11_0 = s11[p.k];
  const float s22_0 = s22[p.k];
  const float s12_0 = s12[p.k];
  s11[p.k] = s11_0 + (ok_cc ? (s11_t - s11_0) * rg_cc : 0.0f);
  s22[p.k] = s22_0 + (ok_cc ? (s22_t - s22_0) * rg_cc : 0.0f);
  s12[p.k] = s12_0 + (ok_ff ? (s12_t - s12_0) * rg_ff : 0.0f);
  al[p.k] = ok_cc ? g2cc * rg_cc : a_max;
}

}  // namespace csi_evp
