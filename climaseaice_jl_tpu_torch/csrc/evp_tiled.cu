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
// Design.  One launch runs K substeps (a chunk) on tiles of TX × TY output
// points.  A block loads its tile with an overlap of H = 2K points on each
// side into shared memory: u, v, σ₁₁, σ₂₂, σ₁₂ and the inputs m, ℵ, P (α
// is not loaded: a substep's σ relaxation recomputes it before any update
// reads it).  The loop's nine derived coefficients are not stored
// anywhere: each point derives the ones it needs from m, ℵ, P in shared
// memory, with the operations `fused_evp_tiled.tiled_evp_coefficients`
// applies, where it uses them (Pff, γ² at cc and ff in the σ relaxation;
// 1/m, drag and the active flag at (f,c) or (c,f) in an update); uⁿ and
// vⁿ are read at the point from device memory.  Substep t of a chunk
// computes σ and its first half-update on the tile grown by 2(K − t) + 1,
// its second half-update on the tile grown by 2(K − t): each phase reads
// neighbours one point away, so after K substeps the tile itself is exact.
// The carried fields go from the input arrays to the scratch arrays and
// back on alternate chunks, since neighbouring tiles read what a chunk
// overwrites.  Odd substeps update v then u, even ones u then v; the
// substep number comes from the chunk's base, and the last chunk may be
// shorter than K: a point's value does not depend on K or on the tile.
//
// The plan: K = 2, tiles of 32 × 64 output points, 512 threads, 104 KB of
// shared memory, so two blocks (32 warps) an SM; one launch per two
// substeps, 1.17× the points computed.  (One substep a launch on 16 × 64
// tiles, four blocks an SM, was measured 1.21× slower on an H100: PERF.md.)
// Region loops divide only by compile-time widths and tile writes index by
// powers of two.  The parameters' reciprocals are formed once per thread
// (evp_common.cuh's StressParams and UpdateParams).
//
// In shared memory the updates are in place, as in evp.cu: in the σ phase
// a thread writes σ and α at its own point and reads σ only there; in the
// u phase it writes u at its own point and reads u only there (no immersed
// drag), in the v phase likewise v.
//
// Arithmetic: built with -fmad=false (`_build.py`) in the plain version's
// operation order, so the kernel equals
// `fused_evp_tiled.tiled_evp_substeps_reference` bitwise, whatever the
// tile, the chunk or the launch.

#include "evp_common.cuh"

namespace {

using namespace csi_evp;

constexpr int N_SHARED = 9;   // tile arrays: u, v, σ₁₁, σ₂₂, σ₁₂, α, m, ℵ, P

struct Inputs {
  const float *m, *a, *P, *un, *vn;
};

struct Fields {
  float *u, *v, *s11, *s22, *s12, *al;
};

struct Plan {
  static constexpr int K = 2;               // substeps a launch
  static constexpr int TX = 32;             // output rows (x)
  static constexpr int TY = 64;             // output columns (y, contiguous)
  static constexpr int NTH = 512;           // threads a block
  static constexpr int MINB = 1024 / NTH;   // blocks an SM: 32 warps, ≤ 64 registers
  static constexpr int H = 2 * K;           // overlap on each side
  static constexpr int SX = TX + 2 * H;     // shared rows
  static constexpr int SY = TY + 2 * H;     // shared row stride
  static constexpr int NS = SX * SY;
  static constexpr size_t SMEM = N_SHARED * NS * sizeof(float);
  static_assert((TY & (TY - 1)) == 0, "TY must be a power of two");
};

// What every phase of a block reads: the shared tile, the wrapped global
// offsets of its rows and columns, and the parameters.
struct Tile {
  float *u, *v, *s11, *s22, *s12, *al, *m, *a, *P;
  const int *crow, *ccol;   // global row offsets (times ny) and columns
  StressParams sp;
  UpdateParams up;
  float num, mass_min, conc_min, ue, ve, tau_u, tau_v;
};

// f(s, r, c) at every point of the tile grown by R on each side: shared
// index s, shared row r and column c.
template <int R, class F>
__device__ __forceinline__ void over_region(F&& f) {
  constexpr int RX = Plan::TX + 2 * R, RY = Plan::TY + 2 * R, N = RX * RY, O = Plan::H - R;
  static_assert(O >= 1, "a region reads one point beyond itself");
  for (int l = threadIdx.x; l < N; l += Plan::NTH) {
    const int r = l / RY;
    const int c = l - r * RY;
    f((r + O) * Plan::SY + (c + O), r + O, c + O);
  }
}

// σ relaxation at shared point s, with Pff and the γ² coefficients derived
// as tiled_evp_coefficients derives them
__device__ __forceinline__ void stress_at(const Tile& t, int s) {
  constexpr int SY = Plan::SY;
  float U[3][3], V[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      U[a][b] = t.u[s + (a - 1) * SY + (b - 1)];
      V[a][b] = t.v[s + (a - 1) * SY + (b - 1)];
    }
  }
  const int ks = s - 1, kw = s - SY, kws = s - SY - 1;
  // cc → ff: 0.25·((q[i,j] + q[i,j-1]) + (q[i-1,j] + q[i-1,j-1]))
  const float Pff = 0.25f * ((t.P[s] + t.P[ks]) + (t.P[kw] + t.P[kws]));
  const float m_ff = 0.25f * ((t.m[s] + t.m[ks]) + (t.m[kw] + t.m[kws]));
  const float mc = t.m[s];
  const float gcc = mc > 0.0f ? t.num / mc : -1.0f;
  const float gff = m_ff > 0.0f ? t.num / m_ff : -1.0f;
  float x11 = t.s11[s], x22 = t.s22[s], x12 = t.s12[s];
  t.al[s] = stress_point(t.sp, U, V, t.P[s], Pff, gcc, gff, x11, x22, x12);
  t.s11[s] = x11;
  t.s22[s] = x22;
  t.s12[s] = x12;
}

// the u update at shared point s (global offset k), with 1/m, drag and the
// active flag at (f,c) derived from m, ℵ at s and its west neighbour
__device__ __forceinline__ void u_at(const Tile& t, const float* __restrict__ un, int s,
                                     int k) {
  constexpr int SY = Plan::SY;
  const int lw = s - SY, ln = s + 1, lwn = s - SY + 1;
  const float m_fc = 0.5f * (t.m[s] + t.m[lw]);
  const float a_fc = 0.5f * (t.a[s] + t.a[lw]);
  const float invm = m_fc > 0.0f ? 1.0f / m_fc : 0.0f;
  const float drag = invm * a_fc;
  const float act = (m_fc >= t.mass_min && a_fc >= t.conc_min) ? 1.0f : 0.0f;
  t.u[s] = u_update_point(t.up, t.s11[s], t.s11[lw], t.s12[s], t.s12[ln], t.v[s], t.v[ln],
                          t.v[lw], t.v[lwn], t.ve, t.ve, t.ve, t.ve, t.u[s], 0.0f, t.ue,
                          t.tau_u, drag, invm, un[k], act, false, 0.0f, 0.0f, t.al[s],
                          t.al[lw]);
}

// the v update at shared point s, coefficients at (c,f) from s and its
// south neighbour
__device__ __forceinline__ void v_at(const Tile& t, const float* __restrict__ vn, int s,
                                     int k) {
  constexpr int SY = Plan::SY;
  const int ls = s - 1, le = s + SY, les = s + SY - 1;
  const float m_cf = 0.5f * (t.m[s] + t.m[ls]);
  const float a_cf = 0.5f * (t.a[s] + t.a[ls]);
  const float invm = m_cf > 0.0f ? 1.0f / m_cf : 0.0f;
  const float drag = invm * a_cf;
  const float act = (m_cf >= t.mass_min && a_cf >= t.conc_min) ? 1.0f : 0.0f;
  t.v[s] = v_update_point(t.up, t.s22[s], t.s22[ls], t.s12[s], t.s12[le], t.u[s], t.u[ls],
                          t.u[le], t.u[les], t.ue, t.ue, t.ue, t.ue, t.v[s], 0.0f, t.ve,
                          t.tau_v, drag, invm, vn[k], act, false, 0.0f, 0.0f, t.al[s],
                          t.al[ls]);
}

template <int R>
__device__ __forceinline__ void update_region(const Tile& t, const Inputs& in, bool u_phase) {
  if (u_phase) {
    over_region<R>([&](int s, int r, int c) { u_at(t, in.un, s, t.crow[r] + t.ccol[c]); });
  } else {
    over_region<R>([&](int s, int r, int c) { v_at(t, in.vn, s, t.crow[r] + t.ccol[c]); });
  }
}

// substeps T … K of the chunk (substep k0 + T first), stopping after nk
template <int T>
__device__ __forceinline__ void substeps(const Tile& t, const Inputs& in, int k0, int nk) {
  if constexpr (T <= Plan::K) {
    if (T > nk) return;
    constexpr int R = 2 * (Plan::K - T);   // the region exact after this substep
    over_region<R + 1>([&](int s, int, int) { stress_at(t, s); });
    __syncthreads();
    // odd substeps: v then u; even substeps: u then v
    const bool even = (k0 + T) % 2 == 0;
    update_region<R + 1>(t, in, even);
    __syncthreads();
    update_region<R>(t, in, !even);
    __syncthreads();
    substeps<T + 1>(t, in, k0, nk);
  }
}

// Substeps k0 + 1 … k0 + nk on one tile; α is written only with write_al.
__global__ void __launch_bounds__(Plan::NTH, Plan::MINB) tiled_chunk(
    const float* __restrict__ prm, Inputs in, int nx, int ny, Fields src, Fields dst,
    int k0, int nk, int write_al) {
  extern __shared__ float sm[];
  __shared__ int crow[Plan::SX], ccol[Plan::SY];
  constexpr int NS = Plan::NS, SY = Plan::SY;
  const int gx0 = blockIdx.y * Plan::TX - Plan::H;   // interior coordinates of shared (0, 0)
  const int gy0 = blockIdx.x * Plan::TY - Plan::H;
  for (int l = threadIdx.x; l < Plan::SX; l += Plan::NTH) crow[l] = wrapi(gx0 + l, nx) * ny;
  for (int l = threadIdx.x; l < SY; l += Plan::NTH) ccol[l] = wrapi(gy0 + l, ny);

  Tile t;
  t.u = sm;
  t.v = sm + NS;
  t.s11 = sm + 2 * NS;
  t.s22 = sm + 3 * NS;
  t.s12 = sm + 4 * NS;
  t.al = sm + 5 * NS;
  t.m = sm + 6 * NS;
  t.a = sm + 7 * NS;
  t.P = sm + 8 * NS;
  t.crow = crow;
  t.ccol = ccol;
  t.sp = stress_params(prm);
  t.up = update_params(prm);
  // the γ² numerator in tiled_evp_coefficients' order: cα·Δt·(1/Δx·1/Δy)
  t.num = prm[P_CALPHA] * prm[P_DT] * (t.sp.inv_dx * t.sp.inv_dy);
  t.mass_min = prm[P_MASSMIN];
  t.conc_min = prm[P_CONCMIN];
  t.ue = prm[P_UE];
  t.ve = prm[P_VE];
  t.tau_u = prm[P_TAUU];
  t.tau_v = prm[P_TAUV];
  __syncthreads();

  for (int l = threadIdx.x; l < NS; l += Plan::NTH) {
    const int r = l / SY;
    const int k = crow[r] + ccol[l - r * SY];
    t.u[l] = src.u[k];
    t.v[l] = src.v[k];
    t.s11[l] = src.s11[k];
    t.s22[l] = src.s22[k];
    t.s12[l] = src.s12[k];
    t.m[l] = in.m[k];
    t.a[l] = in.a[k];
    t.P[l] = in.P[k];
  }
  __syncthreads();

  substeps<1>(t, in, k0, nk);

  // the tile's points inside the domain go back to device memory
  for (int l = threadIdx.x; l < Plan::TX * Plan::TY; l += Plan::NTH) {
    const int r = l / Plan::TY;              // a shift: TY is a power of two
    const int c = l & (Plan::TY - 1);
    const int gx = gx0 + Plan::H + r, gy = gy0 + Plan::H + c;
    if (gx >= nx || gy >= ny) continue;
    const int k = gx * ny + gy;
    const int s = (r + Plan::H) * SY + (c + Plan::H);
    dst.u[k] = t.u[s];
    dst.v[k] = t.v[s];
    dst.s11[k] = t.s11[s];
    dst.s22[k] = t.s22[s];
    dst.s12[k] = t.s12[s];
    if (write_al) dst.al[k] = t.al[s];
  }
}

cudaError_t prepare() {
  return cudaFuncSetAttribute(tiled_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Plan::SMEM));
}

}  // namespace

// The substeps one launch runs (the plan's K).
extern "C" int csi_evp_tiled_chunk_substeps() { return Plan::K; }

// The kernel's build and occupancy into out[6]: registers a thread, spill
// bytes a thread, static and dynamic shared bytes a block, blocks an SM,
// threads a block.  Returns 0 or a CUDA error.
extern "C" int csi_evp_tiled_describe(int* out) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, tiled_chunk)) != cudaSuccess) return err;
  int blocks = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tiled_chunk, Plan::NTH,
                                                           Plan::SMEM)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(Plan::SMEM);
  out[4] = blocks;
  out[5] = Plan::NTH;
  return 0;
}

// Runs `nsub` substeps on u, v, s11, s22, s12, al (each nx×ny, row-major, y
// contiguous) from m, a, P, un, vn of the same shape, on `stream`: one
// launch per chunk of K substeps, ping-ponging the fields with the six
// scratch arrays `t_*`.  The results are left in u … al.  Returns 0, or the
// first nonzero CUDA error.
extern "C" int csi_evp_tiled_substeps(
    const float* params, const float* m, const float* a, const float* P,
    const float* un, const float* vn,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    float* t_u, float* t_v, float* t_s11, float* t_s22, float* t_s12, float* t_al,
    int nx, int ny, int nsub, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Inputs in{m, a, P, un, vn};
  Fields f{u, v, s11, s22, s12, al};
  Fields g{t_u, t_v, t_s11, t_s22, t_s12, t_al};
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  const dim3 grid((ny + Plan::TY - 1) / Plan::TY, (nx + Plan::TX - 1) / Plan::TX);
  for (int k0 = 0; k0 < nsub; k0 += Plan::K) {
    const int nk = nsub - k0 < Plan::K ? nsub - k0 : Plan::K;
    tiled_chunk<<<grid, Plan::NTH, Plan::SMEM, s>>>(params, in, nx, ny, f, g, k0, nk,
                                                    k0 + nk == nsub);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const Fields t = f;
    f = g;
    g = t;
  }
  if (f.u != u) {   // an odd number of chunks left the results in t_*
    const size_t bytes = sizeof(float) * static_cast<size_t>(nx) * ny;
    float* dst[6] = {u, v, s11, s22, s12, al};
    const float* src[6] = {f.u, f.v, f.s11, f.s22, f.s12, f.al};
    for (int q = 0; q < 6; ++q)
      if ((err = cudaMemcpyAsync(dst[q], src[q], bytes, cudaMemcpyDeviceToDevice, s)) !=
          cudaSuccess)
        return err;
  }
  return 0;
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
