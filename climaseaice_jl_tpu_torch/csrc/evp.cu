// Split-explicit αEVP substep loop for NVIDIA Hopper (sm_90a).
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp.py::_evp_kernel` (2.1):
// the whole `nsub`-substep loop on interior-only, doubly periodic,
// uniform-metric float32 arrays (strain rates, Δ, ζ/η, replacement
// pressure, σ relaxation with the dynamic γ, α = γ, then the alternating
// semi-implicit u/v updates), with the twelve constant arrays the launcher
// `fused_evp.evp_coefficients` prepares (P, Pff, gcc, gff, and drag, 1/m,
// the active flag and uⁿ or vⁿ for u and for v).
//
// What bounds it on an H100.  Per point and substep the function needs 142
// float32 operations, each value computed once at its own point (72 for
// the σ relaxation, 35 for each update; counted in chip_smoke.py's
// FLOPS_PER_POINT_SUBSTEP).  A whole call only has to read 18 arrays and
// write 6, once.  At 512² and 120 substeps that is 4.5 GFLOP (0.067 ms at
// 67 TFLOP/s) against 25 MB (7.5 µs at 3.35 TB/s): the call is bound by
// operations.  The TPU kernel keeps all 18 arrays on chip for every
// substep; no one SM of the H100 holds a 512² state (18 MiB), so the
// carried state goes through L2 between launches here.
//
// Design: the periodic tile engine (evp_periodic_tile.cuh), shared with
// evp_tiled.cu (2.2): one launch runs a chunk of K substeps on tiles held
// with an overlap of 2K in shared memory (u, v, σ₁₁, σ₂₂, σ₁₂; α is never
// loaded, since each substep's σ relaxation forms it before any update
// reads it, and it is written only at the end), each phase on a region one
// point smaller than the phase before, so the tile's own points are exact
// after K substeps.  2.1's forms reader (`LoadedForms` below) reads its
// twelve constant arrays at the point that uses them, from L2: each is read
// only at a point's own position, so none needs shared memory.  The carried
// fields ping-pong between the caller's arrays and scratch arrays; every
// chunk after a call's first is launched as a programmatic dependent of the
// chunk before it; the last chunk is shorter when K does not divide nsub.
// One launch a chunk, ⌈nsub/K⌉ a call, where the first design made three a
// substep.
//
// The plan: K = 2 substeps a launch on tiles of 16 × 32 output points, 256
// threads, four blocks an SM: 512 blocks at 512², one wave of the card's
// 528 slots, with 1.41× the points computed.
//
// Arithmetic: built with -fmad=false (`_build.py`) in the plain version's
// operation order (`rsqrtf` for `torch.rsqrt`, IEEE `sqrtf` and division,
// no --use_fast_math), so the kernel equals
// `fused_evp.evp_substeps_reference` bitwise, whatever the tile, the chunk
// or the launch.

#include "evp_periodic_tile.cuh"

namespace {

using namespace csi_evp;

using Plan = PeriodicPlan<2, 16, 32, 256, 4>;

// 2.1's coefficients, read from the launcher's arrays at the point
struct LoadedForms {
  static constexpr int N_STAGED = 0;
  const float *P, *Pff, *gcc, *gff;
  const float *drag_u, *invm_u, *act_u, *un;
  const float *drag_v, *invm_v, *act_v, *vn;

  __device__ __forceinline__ void begin(const float*, const StressParams&) {}
  template <class Pl>
  __device__ __forceinline__ StressCoeffs stress(const float*, int, int k) const {
    return {__ldg(P + k), __ldg(Pff + k), __ldg(gcc + k), __ldg(gff + k)};
  }
  template <class Pl>
  __device__ __forceinline__ UpdateCoeffs u_face(const float*, int, int k) const {
    return {__ldg(drag_u + k), __ldg(invm_u + k), __ldg(act_u + k), __ldg(un + k)};
  }
  template <class Pl>
  __device__ __forceinline__ UpdateCoeffs v_face(const float*, int, int k) const {
    return {__ldg(drag_v + k), __ldg(invm_v + k), __ldg(act_v + k), __ldg(vn + k)};
  }
};

}  // namespace

// The substeps one launch runs (the plan's K).
extern "C" int csi_evp_chunk_substeps() { return Plan::K; }

// The kernel's build and occupancy into out[6]: registers a thread, spill
// bytes a thread, static and dynamic shared bytes a block, blocks an SM,
// threads a block.  Returns 0 or a CUDA error.
extern "C" int csi_evp_describe(int* out) {
  return describe_periodic_chunks<Plan, LoadedForms>(out);
}

// Runs `nsub` substeps on the current contents of u, v, s11, s22, s12, al
// (each nx×ny, row-major, y contiguous) on `stream`: one launch per chunk
// of K substeps, ping-ponging the fields with the six scratch arrays `t_*`
// of the same shape.  The results are left in u … al; the number of kernel
// launches is stored in *launches.  Returns 0, or the first nonzero CUDA
// error.
extern "C" int csi_evp_substeps(
    const float* params,
    const float* P, const float* Pff, const float* gcc, const float* gff,
    const float* drag_u, const float* invm_u, const float* act_u,
    const float* un,
    const float* drag_v, const float* invm_v, const float* act_v,
    const float* vn,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    float* t_u, float* t_v, float* t_s11, float* t_s22, float* t_s12, float* t_al,
    int nx, int ny, int nsub, int* launches, void* stream) {
  const LoadedForms forms{P, Pff, gcc, gff, drag_u, invm_u, act_u, un,
                          drag_v, invm_v, act_v, vn};
  *launches = 0;
  return run_periodic_chunks<Plan>(params, forms, nx, ny,
                                   PeriodicFields{u, v, s11, s22, s12, al},
                                   PeriodicFields{t_u, t_v, t_s11, t_s22, t_s12, t_al}, nsub,
                                   static_cast<cudaStream_t>(stream), launches);
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
