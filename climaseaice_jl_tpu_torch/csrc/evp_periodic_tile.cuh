// The tile engine of the doubly periodic αEVP loop, shared by evp.cu (2.1,
// the twelve coefficient arrays loaded) and evp_tiled.cu (2.2, the
// coefficients derived from m, ℵ and P).  Both kernels run the same
// substep at a point (evp_common.cuh's `stress_point`, `u_update_point`,
// `v_update_point`); they differ only in where a point's coefficients come
// from, which a forms reader (`LoadedForms` in evp.cu, `DerivedForms` in
// evp_tiled.cu) says.
//
// One launch runs up to K substeps (a chunk) on tiles of TX × TY output
// points of the interior-only periodic arrays.  A block loads its tile with
// an overlap of H = 2K points on each side, by periodic wrap, into shared
// memory: u, v, σ₁₁, σ₂₂, σ₁₂, and the arrays the forms reader stages there
// (2.2: m, ℵ, P; 2.1: none, every coefficient it reads is read at the
// point that uses it, from L2).  α is not loaded: a substep's σ relaxation
// recomputes it before any update reads it, and it is written only at the
// end of a call.  Substep t of a chunk computes σ and its first
// half-update on the tile grown by 2(K − t) + 1, its second half-update on
// the tile grown by 2(K − t): each phase reads neighbours one point away,
// so after K substeps the tile itself is exact.  Odd substeps update v then
// u, even ones u then v; the substep number comes from the chunk's base,
// and the last chunk may be shorter than K: a point's value does not depend
// on K or on the tile.  The carried fields go from the input arrays to the
// scratch arrays and back on alternate chunks, since neighbouring tiles read
// what a chunk overwrites.  Every chunk but a call's first is launched as a
// programmatic dependent of the chunk before it: it stages its inputs and
// its index tables while that chunk's last blocks still run, and waits for
// it before it reads the carried fields.
//
// In shared memory the updates are in place: in the σ phase a thread writes
// σ and α at its own point and reads σ only there; in the u phase it writes
// u at its own point and reads u only there (no immersed drag), in the v
// phase likewise v.  Region loops divide only by compile-time widths and
// tile writes index by powers of two.  The parameters' reciprocals are
// formed once per thread (StressParams, UpdateParams).
//
// Arithmetic: the sources build with -fmad=false (`_build.py`) and compute in
// the plain version's operation order, so a point's bits depend neither on
// the tile, the chunk length nor the launch.

#pragma once

#include "evp_common.cuh"

namespace csi_evp {

// K substeps a launch on tiles of TX rows (x) × TY columns (y, contiguous),
// NTH threads a block, MINB blocks an SM (the launch bound).
template <int K_, int TX_, int TY_, int NTH_, int MINB_>
struct PeriodicPlan {
  static constexpr int K = K_;
  static constexpr int TX = TX_;
  static constexpr int TY = TY_;
  static constexpr int NTH = NTH_;
  static constexpr int MINB = MINB_;
  static constexpr int H = 2 * K;           // overlap on each side
  static constexpr int SX = TX + 2 * H;     // shared rows
  static constexpr int SY = TY + 2 * H;     // shared row stride
  static constexpr int NS = SX * SY;
  static_assert((TY & (TY - 1)) == 0, "TY must be a power of two");
};

struct PeriodicFields {
  float *u, *v, *s11, *s22, *s12, *al;
};

// A point's coefficients of the σ relaxation and of one update, as a forms
// reader gives them.
struct StressCoeffs {
  float P, Pff, gcc, gff;
};

struct UpdateCoeffs {
  float drag, invm, act, start;   // start: uⁿ or vⁿ at the point
};

constexpr int N_CARRIED = 6;   // u, v, σ₁₁, σ₂₂, σ₁₂, α in shared memory

// What every phase of a block reads: the shared tile, the wrapped global
// offsets of its rows and columns, and the parameters.
struct PeriodicTile {
  float *u, *v, *s11, *s22, *s12, *al;
  const float* staged;      // the forms reader's staged arrays (N_STAGED of them; stage()
                            // is called only where there are any)
  const int *crow, *ccol;   // global row offsets (times ny) and columns
  StressParams sp;
  UpdateParams up;
  float ue, ve, tau_u, tau_v;
};

template <class Plan, class Forms>
constexpr size_t periodic_smem() {
  return (N_CARRIED + Forms::N_STAGED) * Plan::NS * sizeof(float);
}

// f(s, r, c) at every point of the tile grown by R on each side: shared
// index s, shared row r and column c.
template <class Plan, int R, class F>
__device__ __forceinline__ void over_region(F&& f) {
  constexpr int RX = Plan::TX + 2 * R, RY = Plan::TY + 2 * R, N = RX * RY, O = Plan::H - R;
  static_assert(O >= 1, "a region reads one point beyond itself");
  for (int l = threadIdx.x; l < N; l += Plan::NTH) {
    const int r = l / RY;
    const int c = l - r * RY;
    f((r + O) * Plan::SY + (c + O), r + O, c + O);
  }
}

// σ relaxation at shared point s (global offset k)
template <class Plan, class Forms>
__device__ __forceinline__ void stress_at(const PeriodicTile& t, const Forms& F, int s, int k) {
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
  const StressCoeffs q = F.template stress<Plan>(t.staged, s, k);
  float x11 = t.s11[s], x22 = t.s22[s], x12 = t.s12[s];
  t.al[s] = stress_point(t.sp, U, V, q.P, q.Pff, q.gcc, q.gff, x11, x22, x12);
  t.s11[s] = x11;
  t.s22[s] = x22;
  t.s12[s] = x12;
}

// the u update at shared point s (global offset k), at (f,c)
template <class Plan, class Forms>
__device__ __forceinline__ void u_at(const PeriodicTile& t, const Forms& F, int s, int k) {
  constexpr int SY = Plan::SY;
  const int lw = s - SY, ln = s + 1, lwn = s - SY + 1;
  const UpdateCoeffs q = F.template u_face<Plan>(t.staged, s, k);
  t.u[s] = u_update_point(t.up, t.s11[s], t.s11[lw], t.s12[s], t.s12[ln], t.v[s], t.v[ln],
                          t.v[lw], t.v[lwn], t.ve, t.ve, t.ve, t.ve, t.u[s], 0.0f, t.ue,
                          t.tau_u, q.drag, q.invm, q.start, q.act, false, 0.0f, 0.0f,
                          t.al[s], t.al[lw]);
}

// the v update at shared point s, at (c,f)
template <class Plan, class Forms>
__device__ __forceinline__ void v_at(const PeriodicTile& t, const Forms& F, int s, int k) {
  constexpr int SY = Plan::SY;
  const int ls = s - 1, le = s + SY, les = s + SY - 1;
  const UpdateCoeffs q = F.template v_face<Plan>(t.staged, s, k);
  t.v[s] = v_update_point(t.up, t.s22[s], t.s22[ls], t.s12[s], t.s12[le], t.u[s], t.u[ls],
                          t.u[le], t.u[les], t.ue, t.ue, t.ue, t.ue, t.v[s], 0.0f, t.ve,
                          t.tau_v, q.drag, q.invm, q.start, q.act, false, 0.0f, 0.0f,
                          t.al[s], t.al[ls]);
}

template <class Plan, class Forms, int R>
__device__ __forceinline__ void update_region(const PeriodicTile& t, const Forms& F,
                                              bool u_phase) {
  if (u_phase) {
    over_region<Plan, R>([&](int s, int r, int c) {
      u_at<Plan>(t, F, s, t.crow[r] + t.ccol[c]);
    });
  } else {
    over_region<Plan, R>([&](int s, int r, int c) {
      v_at<Plan>(t, F, s, t.crow[r] + t.ccol[c]);
    });
  }
}

// substeps T … K of the chunk (substep k0 + T first), stopping after nk
template <class Plan, class Forms, int T>
__device__ __forceinline__ void periodic_substeps(const PeriodicTile& t, const Forms& F, int k0,
                                                  int nk) {
  if constexpr (T <= Plan::K) {
    if (T > nk) return;
    constexpr int R = 2 * (Plan::K - T);   // the region exact after this substep
    over_region<Plan, R + 1>([&](int s, int r, int c) {
      stress_at<Plan>(t, F, s, t.crow[r] + t.ccol[c]);
    });
    __syncthreads();
    // odd substeps: v then u; even substeps: u then v
    const bool even = (k0 + T) % 2 == 0;
    update_region<Plan, Forms, R + 1>(t, F, even);
    __syncthreads();
    update_region<Plan, Forms, R>(t, F, !even);
    __syncthreads();
    periodic_substeps<Plan, Forms, T + 1>(t, F, k0, nk);
  }
}

// Substeps k0 + 1 … k0 + nk on one tile; α is written only with write_al.
template <class Plan, class Forms>
__global__ void __launch_bounds__(Plan::NTH, Plan::MINB) periodic_chunk(
    const float* __restrict__ prm, Forms forms, int nx, int ny, PeriodicFields src,
    PeriodicFields dst, int k0, int nk, int write_al) {
  extern __shared__ float sm[];
  __shared__ int crow[Plan::SX], ccol[Plan::SY];
  constexpr int NS = Plan::NS, SY = Plan::SY;
  const int gx0 = blockIdx.y * Plan::TX - Plan::H;   // interior coordinates of shared (0, 0)
  const int gy0 = blockIdx.x * Plan::TY - Plan::H;
  for (int l = threadIdx.x; l < Plan::SX; l += Plan::NTH) crow[l] = wrapi(gx0 + l, nx) * ny;
  for (int l = threadIdx.x; l < SY; l += Plan::NTH) ccol[l] = wrapi(gy0 + l, ny);

  PeriodicTile t;
  t.u = sm;
  t.v = sm + NS;
  t.s11 = sm + 2 * NS;
  t.s22 = sm + 3 * NS;
  t.s12 = sm + 4 * NS;
  t.al = sm + 5 * NS;
  float* staged = sm + N_CARRIED * NS;
  t.staged = staged;
  t.crow = crow;
  t.ccol = ccol;
  t.sp = stress_params(prm);
  t.up = update_params(prm);
  t.ue = prm[P_UE];
  t.ve = prm[P_VE];
  t.tau_u = prm[P_TAUU];
  t.tau_v = prm[P_TAUV];
  Forms F = forms;
  F.begin(prm, t.sp);
  __syncthreads();

  if constexpr (Forms::N_STAGED > 0) {
    for (int l = threadIdx.x; l < NS; l += Plan::NTH) {
      const int r = l / SY;
      F.stage(staged, NS, l, crow[r] + ccol[l - r * SY]);
    }
  }
  // Up to here nothing reads what the previous chunk writes: a chunk
  // launched as a programmatic dependent of the previous one waits for it
  // only now (a no-op for a chunk launched the ordinary way).
  cudaGridDependencySynchronize();
  for (int l = threadIdx.x; l < NS; l += Plan::NTH) {
    const int r = l / SY;
    const int k = crow[r] + ccol[l - r * SY];
    t.u[l] = src.u[k];
    t.v[l] = src.v[k];
    t.s11[l] = src.s11[k];
    t.s22[l] = src.s22[k];
    t.s12[l] = src.s12[k];
  }
  __syncthreads();
  cudaTriggerProgrammaticLaunchCompletion();

  periodic_substeps<Plan, Forms, 1>(t, F, k0, nk);

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

template <class Plan, class Forms>
cudaError_t prepare_periodic_chunks() {
  return cudaFuncSetAttribute(periodic_chunk<Plan, Forms>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(periodic_smem<Plan, Forms>()));
}

// Runs nsub substeps on the nx × ny fields f, one launch per chunk of K,
// ping-ponging them with the scratch fields g; the results are left in f.
// Returns 0 or the first CUDA error; `launches` counts the kernel launches.
template <class Plan, class Forms>
cudaError_t run_periodic_chunks(const float* params, const Forms& forms, int nx, int ny,
                                PeriodicFields f, PeriodicFields g, int nsub, cudaStream_t s,
                                int* launches) {
  cudaError_t err = prepare_periodic_chunks<Plan, Forms>();
  if (err != cudaSuccess) return err;
  const dim3 grid((ny + Plan::TY - 1) / Plan::TY, (nx + Plan::TX - 1) / Plan::TX);
  const PeriodicFields out = f;
  for (int k0 = 0; k0 < nsub; k0 += Plan::K) {
    const int nk = nsub - k0 < Plan::K ? nsub - k0 : Plan::K;
    // Every chunk but the first (which follows the caller's kernels, the
    // inputs' writers) may start before the previous chunk ends.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = k0 > 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(Plan::NTH);
    cfg.dynamicSmemBytes = periodic_smem<Plan, Forms>();
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, periodic_chunk<Plan, Forms>, params, forms, nx, ny, f,
                                  g, k0, nk, static_cast<int>(k0 + nk == nsub))) !=
        cudaSuccess)
      return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
    const PeriodicFields t = f;
    f = g;
    g = t;
  }
  if (f.u != out.u) {   // an odd number of chunks left the results in the scratch arrays
    const size_t bytes = sizeof(float) * static_cast<size_t>(nx) * ny;
    float* to[6] = {out.u, out.v, out.s11, out.s22, out.s12, out.al};
    const float* from[6] = {f.u, f.v, f.s11, f.s22, f.s12, f.al};
    for (int q = 0; q < 6; ++q)
      if ((err = cudaMemcpyAsync(to[q], from[q], bytes, cudaMemcpyDeviceToDevice, s)) !=
          cudaSuccess)
        return err;
  }
  return cudaSuccess;
}

// The kernel's build and occupancy into out[6]: registers a thread, spill
// bytes a thread, static and dynamic shared bytes a block, blocks an SM,
// threads a block.
template <class Plan, class Forms>
cudaError_t describe_periodic_chunks(int* out) {
  cudaError_t err = prepare_periodic_chunks<Plan, Forms>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, periodic_chunk<Plan, Forms>)) != cudaSuccess)
    return err;
  int blocks = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks, periodic_chunk<Plan, Forms>, Plan::NTH, periodic_smem<Plan, Forms>())) !=
      cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(periodic_smem<Plan, Forms>());
  out[4] = blocks;
  out[5] = Plan::NTH;
  return cudaSuccess;
}

}  // namespace csi_evp
