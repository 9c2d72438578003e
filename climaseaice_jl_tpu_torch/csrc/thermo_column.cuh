// Fixed-tile slab and snow column thermodynamics for NVIDIA Hopper (sm_90a):
// the column kernel, templated on its three flux functors.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_pointwise.py::
// fixed_tile_pointwise_multi` as `thermodynamics/pallas_thermo.py:169`
// runs it: the whole column step of `slab.bare_ice_thermodynamic_step` or
// `slab.layered_thermodynamic_step` at every padded point.  That is the
// fixed-iteration secant for the surface temperature (an iterate freezes
// where the flux difference vanishes), the snow-ice interface temperature,
// the volume and concentration update with its clipping and ridging,
// snowfall, flooding, and the diagnostics mf_ice, mf_snow, mf_snowfall,
// Qtop and Qbot.
//
// The external heat fluxes are compiled into the kernel: a configuration's
// flux programs (constants, arrays, 0-d device values such as a
// FieldTimeSeries resolved at the clock's time, radiative emission
// c·(T + T_r)⁴, the recorded operations of FluxFunction callables, and sums
// in the order heat_bcs.getflux adds them) become one generated unit
// (dynamics/fixed_tile_codegen.py) that defines three functors, Top, Bottom
// and Snow, and instantiates this header with them.  A functor's
// prologue(A, pt) computes once per point the values that do not depend on
// the surface temperature; flux(A, T) computes the rest, at every secant
// iterate.  Every operation of the program is kept, through
// pointwise_program.cuh's helpers, so each value has the bits of the
// program's operations in order.  Constants, pointers and 0-d values travel in the launch arguments.
//
// What bounds it on an H100: for the bare-ice slice with 20 secant
// iterations the column needs 254 float32 operations per point (counted
// as the plain version computes them: chip_smoke.py's
// THERMO_FLOPS_PER_POINT) against 4 arrays read and 8 written, 48 bytes:
// at 522² 0.0039 ms of bytes and 0.0011 ms of operations.  The call is bound
// by bytes.  With the tripolar basin's solar FluxFunction, three series and
// emission in the top flux, 756 operations and 17 arrays a point: at
// 1162×970 0.0229 ms of bytes.
//
// Design: one thread per padded point, one launch per call; the arguments
// (flags, constants, pointers) travel by value in one struct.  No array is
// indexed at run time, so nothing lives in local memory.
//
// Arithmetic: the plain version's operation order.  Where the plain
// version divides a tensor by a Python number, PyTorch's CUDA division
// multiplies by the float reciprocal, and so does this kernel; a tensor
// divided by dt takes that form where dt is a Python number.  The
// configuration's products of Python numbers arrive formed in double and
// rounded to float32, as they meet a tensor in the plain version.  powf is
// the function torch.pow calls on the card.  Built with -fmad=false
// (`_build.py`): no multiply-add is contracted, so a point's bits do not
// depend on the launch, the array shape or the halo width.

#pragma once

#include "pointwise_program.cuh"

namespace csi_thermo {

constexpr int MAX_K = 64, MAX_PTRS = 32;
constexpr int BLOCK = 256;

// constants (fixed_tile_thermo._K_NAMES), then the programs' own
enum K { K_HC, K_RHOI, K_NEGKI, K_T0, K_SLOPE, K_L0, K_KL, K_TREF, K_KS, K_KI, K_RHOS,
         K_RHOSL, K_RHOIL, K_FLOOD, K_RHOW };
// pointers (fixed_tile_thermo._P_NAMES), then the programs' own
enum P { P_H, P_A, P_HS, P_S, P_TU, P_TUS, P_DT, P_TB };

struct Args {
  int layered, n, prescribed, iterations, dt_number, hc_pos, tb_array;
  float k[MAX_K];
  const float* p[MAX_PTRS];
};

// x / c for a Python number c, as PyTorch's CUDA division computes it
__device__ __forceinline__ float rdiv(float x, float c) { return x * (1.0f / c); }

template <class Top>
struct Column {
  const Args& A;
  const Top& top;
  int pt;
  float dt, Tb;

  __device__ float by_dt(float x) const { return A.dt_number ? rdiv(x, dt) : x / dt; }
  __device__ float latent(float T) const {
    return A.k[K_L0] + A.k[K_KL] * (T - A.k[K_TREF]);
  }
  // ConductiveFlux of the ice: −k (T − Tb)/h where h > 0
  __device__ float conduct(float T, float h) const {
    return h > 0.0f ? (A.k[K_NEGKI] * (T - Tb)) / h : 0.0f;
  }
  // snow and ice in series: (Tb − T)/(hs/ks + hi/ki) where positive
  __device__ float conduct2(float T, float hi, float hs) const {
    const float R = rdiv(hs, A.k[K_KS]) + rdiv(hi, A.k[K_KI]);
    return R > 0.0f ? (Tb - T) / R : 0.0f;
  }
  // heat_bcs.solve_surface_temperature with the balance Qx(T) − conduction
  template <typename Conduction>
  __device__ float secant(float T0, Conduction cond) const {
    float T1 = T0 + 1.0f, T2 = T0 + 0.0f;
    float F1 = top.flux(A, T1) - cond(T1);
    float F2 = top.flux(A, T2) - cond(T2);
    for (int it = 0; it < A.iterations; ++it) {
      const float dF = F2 - F1;
      const float step = fabsf(dF) > 0.0f ? F2 * (T2 - T1) / dF : 0.0f;
      const float T3 = T2 - step;
      T1 = T2;
      F1 = F2;
      T2 = T3;
      F2 = top.flux(A, T3) - cond(T3);
    }
    return T2;
  }
  // slab.ice_volume_update with ProportionalEvolution
  __device__ void volume(float dVdt, float hn, float an, float& h_new, float& a_new) const {
    const float hc = A.k[K_HC];
    const float V1 = fmaxf(hn * an + dt * dVdt, 0.0f);
    const float dVe = by_dt(V1 - hn * an);
    const bool freezing = dVe >= 0.0f;
    const float da_f = (freezing && A.hc_pos) ? (1.0f - an) * rdiv(dVe, hc) : 0.0f;
    const float da_m = (!freezing && hn > 0.0f) ? an * (dVe / (2.0f * hn)) : 0.0f;
    float a_plus = fmaxf(an + dt * (da_f + da_m), 0.0f);
    float h_plus = a_plus > 0.0f ? V1 / a_plus : 0.0f;
    h_plus = a_plus <= 0.0f ? 0.0f : h_plus;
    a_plus = dVe == 0.0f ? an : a_plus;
    h_plus = dVe == 0.0f ? hn : h_plus;
    a_plus = h_plus == 0.0f ? 0.0f : a_plus;
    h_plus = a_plus == 0.0f ? 0.0f : h_plus;
    h_new = a_plus > 1.0f ? h_plus * a_plus : h_plus;
    a_new = a_plus > 1.0f ? 1.0f : a_plus;
  }
};

template <class Top, class Bottom, class Snow>
__global__ void __launch_bounds__(BLOCK) thermo_column(const __grid_constant__ Args A,
                                                       float* __restrict__ out) {
  const int pt = blockIdx.x * BLOCK + threadIdx.x;
  if (pt >= A.n) return;
  Top top;
  Bottom bottom;
  Snow snow;
  top.prologue(A, pt);
  bottom.prologue(A, pt);
  snow.prologue(A, pt);
  const float dt = A.p[P_DT][0];
  const Column<Top> col{A, top, pt, dt, A.p[P_TB][A.tb_array ? pt : 0]};
  const float Tb = col.Tb;
  const float hn = A.p[P_H][pt], an = A.p[P_A][pt], S = A.p[P_S][pt];
  const bool consolidated = hn >= A.k[K_HC];
  const float Tm = A.k[K_T0] - S * A.k[K_SLOPE];
  const float rho_i = A.k[K_RHOI];
  const size_t plane = static_cast<size_t>(A.n);

  if (!A.layered) {
    float Tu;
    if (A.prescribed) {
      Tu = A.p[P_TU][pt];
    } else {
      const float Ts = col.secant(A.p[P_TU][pt], [&](float T) { return col.conduct(T, hn); });
      Tu = consolidated ? fminf(Ts, Tm) : Tb;
    }
    const float Qui = top.flux(A, Tu);
    const float Qbi = bottom.flux(A, Tu);
    const float Qii = consolidated ? col.conduct(Tu, hn) : 0.0f;
    const float Eu = rho_i * col.latent(Tu);
    const float Eb = rho_i * col.latent(Tb);
    const float dVdt = (Qui - Qii) / Eu + (Qii - Qbi) / Eb;
    float h1, a1;
    col.volume(dVdt, hn, an, h1, a1);
    const float outs[8] = {h1, a1, Tu, col.by_dt(rho_i * (h1 * a1 - hn * an)), 0.0f, 0.0f,
                           Qui + 0.0f, Qbi + 0.0f};
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q * plane + pt] = outs[q];
    return;
  }

  const float hsn = A.p[P_HS][pt];
  const float Vin = hn * an, Vsn = hsn * an;
  const float Tm_eff = hsn > 0.0f ? 0.0f : Tm;
  float Tus;
  if (A.prescribed) {
    Tus = A.p[P_TUS][pt];
  } else {
    const float Ts =
        col.secant(A.p[P_TUS][pt], [&](float T) { return col.conduct2(T, hn, hsn); });
    Tus = consolidated ? fminf(Ts, Tm_eff) : Tb;
  }
  // snow-ice interface temperature Tb + (Tus − Tb)·Ri/(Rs + Ri)
  const float Ri = rdiv(hn, A.k[K_KI]);
  const float Rs = rdiv(hsn, A.k[K_KS]);
  const float R = Rs + Ri;
  const float Tsi = R > 0.0f ? Tb + (Tus - Tb) * (Ri / R) : Tb;

  const float Qis = consolidated ? col.conduct2(Tus, hn, hsn) : 0.0f;
  const float Qui = top.flux(A, Tus);
  const float Qui_per_ice = an > 0.0f ? Qui / an : 0.0f;
  const float dQ = Qui_per_ice - Qis;
  const float melt_energy = fmaxf(-dQ, 0.0f);
  const float capacity = col.by_dt(A.k[K_RHOSL] * hsn);
  const float Qs = fminf(melt_energy, capacity);
  const float Gs_minus = rdiv(Qs, A.k[K_RHOSL]);

  // closed-form self-consistent ℵⁿ⁺¹
  const float Qbi = bottom.flux(A, Tus);
  const float alpha = rdiv(Qui - Qbi, A.k[K_RHOIL]);
  const float beta = rdiv(Qs, A.k[K_RHOIL]);
  const float Cm = hn > 0.0f ? an * (1.0f / (2.0f * hn)) : 0.0f;
  const float Cf = (1.0f - an) * (A.hc_pos ? rdiv(1.0f, A.k[K_HC]) : 0.0f);
  const float Km = dt * Cm, Kf = dt * Cf;
  const float eps = 1.1920929e-07f;   // float32 machine epsilon
  const float Dm = 1.0f - Km * beta, Df = 1.0f - Kf * beta;
  const float am = fabsf(Dm) > eps ? (an + Km * alpha) / Dm : an + Km * alpha;
  const float af = fabsf(Df) > eps ? (an + Kf * alpha) / Df : an + Kf * alpha;
  const float a_tmp = alpha + beta * am < 0.0f ? am : af;

  const float Qui_eff = Qui + Qs * a_tmp;
  const float Qii = consolidated ? col.conduct(Tsi, hn) : 0.0f;
  const float Eu = rho_i * col.latent(Tsi);
  const float Eb = rho_i * col.latent(Tb);
  const float dVdt = (Qui_eff - Qii) / Eu + (Qii - Qbi) / Eb;
  float hi1, a1;
  col.volume(dVdt, hn, an, hi1, a1);

  // snow volume kept under the concentration change, snowfall, flooding
  const float rho_s = A.k[K_RHOS];
  const float hs_rebased = a1 > 0.0f ? hsn * an * (1.0f / a1) : 0.0f;
  const float rate = snow.flux(A, 0.0f);
  const float Gs_plus = a1 > 0.0f ? rdiv(rate, rho_s) : 0.0f;
  float hs_p = fmaxf(hs_rebased + dt * (Gs_plus - Gs_minus), 0.0f);
  const float hf = hi1 * A.k[K_FLOOD] - rdiv(hs_p * rho_s, A.k[K_RHOW]);
  const float dhs = hf < 0.0f ? rdiv(-hf * rho_i, rho_s) : 0.0f;
  const float hs_new = fmaxf(hs_p - dhs, 0.0f);
  hi1 = hi1 + rdiv((hs_p - hs_new) * rho_s, rho_i);
  hs_p = a1 <= 0.0f ? 0.0f : hs_new;

  const float Ps_abs = rho_s * Gs_plus * a1;
  const float outs[10] = {hi1, a1, hs_p, Tsi, Tus,
                          col.by_dt(rho_i * (hi1 * a1 - Vin)) + 0.0f,
                          col.by_dt(rho_s * (hs_p * a1 - Vsn)) - Ps_abs + 0.0f,
                          Ps_abs + 0.0f, Qui + 0.0f, Qbi + 0.0f};
#pragma unroll
  for (int q = 0; q < 10; ++q) out[q * plane + pt] = outs[q];
}

// The column step over n = ints[1] padded points into `out` (8 planes for
// bare ice, 10 with snow, each n long) on `stream`.  `ints`: layered, n,
// prescribed top temperature, secant iterations, dt is a number, hc > 0, Tb
// is an array; `consts` and `ptrs` are host arrays of the constants and
// device pointers.  Returns 0, a CUDA error, or −1 for arguments it cannot
// take.
template <class Top, class Bottom, class Snow>
int launch(const int* ints, int n_ints, const float* consts, int n_k, const void* const* ptrs,
           int n_p, float* out, void* stream) {
  Args A{};
  if (n_ints != 7 || n_k > MAX_K || n_p > MAX_PTRS) return -1;
  A.layered = ints[0];
  A.n = ints[1];
  A.prescribed = ints[2];
  A.iterations = ints[3];
  A.dt_number = ints[4];
  A.hc_pos = ints[5];
  A.tb_array = ints[6];
  for (int q = 0; q < n_k; ++q) A.k[q] = consts[q];
  for (int q = 0; q < n_p; ++q) A.p[q] = static_cast<const float*>(ptrs[q]);
  thermo_column<Top, Bottom, Snow>
      <<<(A.n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(A, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace csi_thermo
