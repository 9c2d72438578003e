// Tiled αEVP loop for NVIDIA Hopper (sm_90a): doubly periodic grids above
// the whole-array kernel's limit.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_tiled.py::_tiled_kernel`
// (2.2): the αEVP substeps of evp.cu on interior-only, doubly periodic,
// uniform-metric float32 arrays, with the loop's coefficients derived from
// m = h·ℵ·ρ, ℵ and P in the TPU kernel's own forms
// (pallas_evp_tiled.py:253-282; the γ² coefficient is cα·Δt·(1/Δx·1/Δy)/m).
//
// What bounds it on an H100: per point and substep the function needs
// evp.cu's 142 float32 operations (chip_smoke.py's FLOPS_PER_POINT_SUBSTEP)
// and per call 24 for the coefficients; a call reads 11 arrays (m, ℵ, P,
// uⁿ, vⁿ and the carried six) and writes 6, once.  At 2048² and 120
// substeps that is 71.6 GFLOP (1.07 ms at 67 TFLOP/s) against 285 MB
// (0.085 ms at 3.35 TB/s): bound by operations.  A kernel that keeps no
// state on chip between substeps moves instead, per substep, what one
// substep reads and writes: 10 arrays in (u, v, σ₁₁, σ₂₂, σ₁₂, m, ℵ, P, uⁿ,
// vⁿ) and 5 out (α only at the end), 252 MB at 2048², 0.075 ms.
//
// Design: the periodic tile engine (evp_periodic_tile.cuh), shared with
// evp.cu (2.1): K substeps a launch on tiles held with an overlap of 2K in
// shared memory, α never loaded, the carried fields ping-ponging with
// scratch arrays, every chunk after a call's first launched as a
// programmatic dependent of the one before.  2.2's forms reader stages m, ℵ
// and P in the tile, and each point derives the coefficients it uses from
// them, with the operations `fused_evp_tiled.tiled_evp_coefficients`
// applies, where it uses them (Pff, γ² at cc and ff in the σ relaxation;
// 1/m, drag and the active flag at (f,c) or (c,f) in an update); uⁿ and
// vⁿ are read at the point from device memory.  The loop's nine derived
// coefficients are stored nowhere.
//
// The plan: K = 2, tiles of 32 × 64 output points, 512 threads, 104 KB of
// shared memory, so two blocks (32 warps) an SM; one launch per two
// substeps, 1.17× the points computed.  (One substep a launch on 16 × 64
// tiles, four blocks an SM, was measured 1.21× slower on an H100: PERF.md.)
//
// Arithmetic: built with -fmad=false (`_build.py`) in the plain version's
// operation order, so the kernel equals
// `fused_evp_tiled.tiled_evp_substeps_reference` bitwise, whatever the
// tile, the chunk or the launch.

#include "evp_periodic_tile.cuh"

namespace {

using namespace csi_evp;

// K = 2 substeps a launch on 32 × 64 tiles, 512 threads, two blocks an SM
using Plan = PeriodicPlan<2, 32, 64, 512, 2>;

// 2.2's coefficients, derived at each use from m, ℵ and P staged in shared
// memory, with the operations tiled_evp_coefficients applies; uⁿ, vⁿ read
// at the point
struct DerivedForms {
  static constexpr int N_STAGED = 3;   // m, ℵ, P
  const float *m, *a, *P, *un, *vn;
  float num, mass_min, conc_min;

  __device__ __forceinline__ void begin(const float* __restrict__ prm, const StressParams& sp) {
    // the γ² numerator in tiled_evp_coefficients' order: cα·Δt·(1/Δx·1/Δy)
    num = prm[P_CALPHA] * prm[P_DT] * (sp.inv_dx * sp.inv_dy);
    mass_min = prm[P_MASSMIN];
    conc_min = prm[P_CONCMIN];
  }
  __device__ __forceinline__ void stage(float* st, int ns, int l, int k) const {
    st[l] = m[k];
    st[ns + l] = a[k];
    st[2 * ns + l] = P[k];
  }
  // Pff and the γ² coefficients at cc and ff
  template <class Pl>
  __device__ __forceinline__ StressCoeffs stress(const float* st, int s, int) const {
    const float* tm = st;
    const float* tP = st + 2 * Pl::NS;
    const int ks = s - 1, kw = s - Pl::SY, kws = s - Pl::SY - 1;
    // cc → ff: 0.25·((q[i,j] + q[i,j-1]) + (q[i-1,j] + q[i-1,j-1]))
    const float Pff = 0.25f * ((tP[s] + tP[ks]) + (tP[kw] + tP[kws]));
    const float m_ff = 0.25f * ((tm[s] + tm[ks]) + (tm[kw] + tm[kws]));
    const float mc = tm[s];
    return {tP[s], Pff, mc > 0.0f ? num / mc : -1.0f, m_ff > 0.0f ? num / m_ff : -1.0f};
  }
  // 1/m, drag and the active flag at (f,c) from s and its west neighbour
  template <class Pl>
  __device__ __forceinline__ UpdateCoeffs u_face(const float* st, int s, int k) const {
    return face(st + 0, st + Pl::NS, s, s - Pl::SY, un[k]);
  }
  // at (c,f) from s and its south neighbour
  template <class Pl>
  __device__ __forceinline__ UpdateCoeffs v_face(const float* st, int s, int k) const {
    return face(st + 0, st + Pl::NS, s, s - 1, vn[k]);
  }
  __device__ __forceinline__ UpdateCoeffs face(const float* tm, const float* ta, int s, int o,
                                               float start) const {
    const float m_f = 0.5f * (tm[s] + tm[o]);
    const float a_f = 0.5f * (ta[s] + ta[o]);
    const float invm = m_f > 0.0f ? 1.0f / m_f : 0.0f;
    return {invm * a_f, invm, (m_f >= mass_min && a_f >= conc_min) ? 1.0f : 0.0f, start};
  }
};

}  // namespace

// The substeps one launch runs (the plan's K).
extern "C" int csi_evp_tiled_chunk_substeps() { return Plan::K; }

// The kernel's build and occupancy into out[6]: registers a thread, spill
// bytes a thread, static and dynamic shared bytes a block, blocks an SM,
// threads a block.  Returns 0 or a CUDA error.
extern "C" int csi_evp_tiled_describe(int* out) {
  return describe_periodic_chunks<Plan, DerivedForms>(out);
}

// Runs `nsub` substeps on u, v, s11, s22, s12, al (each nx×ny, row-major, y
// contiguous) from m, a, P, un, vn of the same shape, on `stream`: one
// launch per chunk of K substeps, ping-ponging the fields with the six
// scratch arrays `t_*`.  The results are left in u … al; the number of
// kernel launches is stored in *launches.  Returns 0, or the first nonzero
// CUDA error.
extern "C" int csi_evp_tiled_substeps(
    const float* params, const float* m, const float* a, const float* P,
    const float* un, const float* vn,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    float* t_u, float* t_v, float* t_s11, float* t_s22, float* t_s12, float* t_al,
    int nx, int ny, int nsub, int* launches, void* stream) {
  DerivedForms forms{};
  forms.m = m;
  forms.a = a;
  forms.P = P;
  forms.un = un;
  forms.vn = vn;
  *launches = 0;
  return run_periodic_chunks<Plan>(params, forms, nx, ny,
                                   PeriodicFields{u, v, s11, s22, s12, al},
                                   PeriodicFields{t_u, t_v, t_s11, t_s22, t_s12, t_al}, nsub,
                                   static_cast<cudaStream_t>(stream), launches);
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
