// The tile engine of the padded αEVP loop, shared by evp_padded.cu (2.3,
// whole padded arrays) and evp_tiled_padded.cu (2.5, the fixed-tile mode on
// interiors).  Both kernels compute the same function at a point
// (evp_common.cuh's `stress_point`, `u_update_point`, `v_update_point`);
// they differ only in what a tile position stands for: which array element
// its carried fields and constants are read from, where its velocity fill
// takes its value, and whether it is written back.  A geometry (the
// `entry` of `TorusGeometry` in evp_padded.cu, `InteriorGeometry` in
// evp_tiled_padded.cu) says that per direction; the engine below does the
// rest.
//
// One launch runs up to K substeps (a chunk) on tiles of TX × TY output
// positions held with an overlap of O = 2K positions on each side in shared
// memory: u, v, σ₁₁, σ₂₂, σ₁₂, α, and the constants that are read at
// neighbours (uₑ, vₑ as floats; msk_cc and msk_ff as bytes, which leaves L1
// more room for the other constants: the launchers hold the masks at 0 or
// 1, `fused_evp_padded.padded_evp_inputs`).  α is not loaded: a substep's
// σ relaxation recomputes it before any update reads it.  The other
// constants are read from device memory (L2) at the point that uses them,
// once per point and phase, coalesced along y.  Every chunk but a call's
// first is launched as a programmatic dependent of the chunk before it: it
// stages its constants while that chunk's last blocks still run.
//
// Substep t of a chunk computes σ and its first half-update on the tile
// grown by 2(K − t) + 1, its second half-update on the tile grown by
// 2(K − t).  Each phase reads one position beyond its region, and only on
// the sides that the next phase does not need (the u update reads σ₁₁ and
// α to its west and σ₁₂ to its north, the v update the other way round), so
// after K substeps the output positions are exact.  A velocity update at a
// position computes the update at the position's fill source (zero where
// the fill writes zero), so the halo fills after every half-update need no
// pass of their own: each geometry keeps every fill source inside the
// region that holds its position.  Because a thread reads its source's
// neighbourhood and, with the immersed drag, u(i, j+1) or v(i+1, j), an
// update phase computes all its points into registers, waits for the
// block, then writes them.  The σ phase writes σ and α only at the point it
// reads them.  Carried fields go from the input arrays to the scratch
// arrays and back on alternate chunks, since neighbouring tiles read what a
// chunk overwrites.
//
// Arithmetic: the point functions with the parameters' reciprocals formed
// once per thread (StressParams, UpdateParams), in the plain versions'
// operation order; the sources build with -fmad=false (`_build.py`), so a
// point's bits depend neither on the tile, the chunk length nor the launch.

#pragma once

#include "evp_common.cuh"

namespace csi_evp {

// how a direction's halos are treated (fused_evp_padded.direction_kinds)
constexpr int KIND_WALL = 0;    // bounded walls: zero or edge copy
constexpr int KIND_WRAP = 1;    // periodic
constexpr int KIND_SPLIT = 2;   // split across ranks: no fill

// a displacement to a fill source that writes zero
constexpr int ZERO_SOURCE = 1 << 24;

struct Direction {
  int ext, H, N, kind;   // padded extent, halo, interior size, KIND_*
};

// The constant arrays of one call (padded layout).  The four drag arrays are
// null without drag.
struct PaddedConsts {
  const float *P, *Pff, *gcc, *gff;
  const float *drag_u, *invm_u, *act_u, *un;
  const float *drag_v, *invm_v, *act_v, *vn;
  const float *msk_cc, *msk_ff;
  const float *imms_u, *immn_u, *immw_v, *imme_v;
  const float *tau_u, *tau_v, *ue, *ve;
};

struct PaddedFields {
  float *u, *v, *s11, *s22, *s12, *al;
};

// What one tile position stands for along one direction.
struct AxisEntry {
  int ld;        // offset of its carried fields (σ)
  int ldF, ldC;  // offset of its face (u along x, v along y) and centre
                 // fill source, the velocities' loads; ldF −1 where zero
  int cs;        // offset of its constants
  int dF, dC;    // tile displacement to those sources (dF may be ZERO_SOURCE)
  int out;       // offset it is written back to, or −1
};

// A direction's entries for every tile position, row offsets already
// multiplied by the row length.
template <int S>
struct AxisTable {
  int ld[S], ldF[S], ldC[S], cs[S], dF[S], dC[S], out[S];

  static __device__ __forceinline__ bool inner(int l) { return l >= 1 && l <= S - 2; }

  __device__ __forceinline__ void set(int l, const AxisEntry& e, int stride) {
    ld[l] = e.ld * stride;
    ldF[l] = e.ldF < 0 ? -1 : e.ldF * stride;
    ldC[l] = e.ldC * stride;
    cs[l] = e.cs * stride;
    // A position whose source lies outside the tile's inner positions is
    // one no output depends on (the geometries keep every source that an
    // output needs inside the region that needs it): it computes at itself,
    // so that no read leaves the tile.
    dF[l] = e.dF == ZERO_SOURCE || inner(l + e.dF) ? e.dF : 0;
    dC[l] = inner(l + e.dC) ? e.dC : 0;
    out[l] = e.out < 0 ? -1 : e.out * stride;
  }
};

// K substeps a launch on tiles of TX × TY output positions, NTH threads and
// at least MINB resident blocks an SM.
template <int K_, int TX_, int TY_, int NTH_, int MINB_>
struct TilePlan {
  static constexpr int K = K_, TX = TX_, TY = TY_, NTH = NTH_, MINB = MINB_;
  static constexpr int O = 2 * K;             // overlap on each side
  static constexpr int SX = TX + 2 * O;       // shared rows
  static constexpr int SY = TY + 2 * O;       // shared row stride
  static constexpr int NS = SX * SY;
  // u, v, σ₁₁, σ₂₂, σ₁₂, α, uₑ, vₑ as floats, msk_cc and msk_ff as bytes
  static constexpr size_t SMEM = NS * (8 * sizeof(float) + 2);
};

template <class Plan>
struct Tile {
  float *u, *v, *s11, *s22, *s12, *al, *ue, *ve;
  unsigned char *mcc, *mff;
  const AxisTable<Plan::SX>* ax;
  const AxisTable<Plan::SY>* ay;
  StressParams sp;
  UpdateParams up;
};

// f(r, c) at every tile position of the output tile grown by R on each side
template <class Plan, int R, class F>
__device__ __forceinline__ void over_region(F&& f) {
  constexpr int RY = Plan::TY + 2 * R, N = (Plan::TX + 2 * R) * RY, O = Plan::O - R;
  static_assert(O >= 1, "a region reads one position beyond itself");
  for (int l = threadIdx.x; l < N; l += Plan::NTH) {
    const int r = l / RY;
    f(r + O, l - r * RY + O);
  }
}

// q(r, c) = f(r, c) over the output tile grown by R, every value computed
// before any is written
template <class Plan, int R, class F>
__device__ __forceinline__ void update_region(float* q, F&& f) {
  constexpr int RY = Plan::TY + 2 * R, N = (Plan::TX + 2 * R) * RY, O = Plan::O - R;
  constexpr int NP = (N + Plan::NTH - 1) / Plan::NTH;
  static_assert(O >= 1, "a region reads one position beyond itself");
  float res[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int l = threadIdx.x + i * Plan::NTH;
    if (l < N) {
      const int r = l / RY;
      res[i] = f(r + O, l - r * RY + O);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int l = threadIdx.x + i * Plan::NTH;
    if (l < N) {
      const int r = l / RY;
      q[(r + O) * Plan::SY + l - r * RY + O] = res[i];
    }
  }
  __syncthreads();
}

// σ relaxation at tile position (r, c)
template <class Plan>
__device__ __forceinline__ void stress_at(const Tile<Plan>& t, const PaddedConsts& c, int r,
                                          int col) {
  constexpr int SY = Plan::SY;
  const int s = r * SY + col;
  const int k = t.ax->cs[r] + t.ay->cs[col];
  float U[3][3], V[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      U[a][b] = t.u[s + (a - 1) * SY + (b - 1)];
      V[a][b] = t.v[s + (a - 1) * SY + (b - 1)];
    }
  }
  float x11 = t.s11[s], x22 = t.s22[s], x12 = t.s12[s];
  t.al[s] = stress_point(t.sp, U, V, __ldg(c.P + k), __ldg(c.Pff + k), __ldg(c.gcc + k),
                         __ldg(c.gff + k), x11, x22, x12);
  t.s11[s] = x11;
  t.s22[s] = x22;
  t.s12[s] = x12;
}

// the u update of tile position (r, c): the update at its fill source
template <class Plan, bool DRAG>
__device__ __forceinline__ float u_at(const Tile<Plan>& t, const PaddedConsts& c, int r,
                                      int col) {
  constexpr int SY = Plan::SY;
  const int dr = t.ax->dF[r];
  if (dr == ZERO_SOURCE) return 0.0f;
  const int sr = r + dr, sc = col + t.ay->dC[col];
  const int s = sr * SY + sc, lw = s - SY, ln = s + 1, lwn = s - SY + 1;
  const int k = t.ax->cs[sr] + t.ay->cs[sc];
  return u_update_point(
      t.up, t.s11[s] * static_cast<float>(t.mcc[s]), t.s11[lw] * static_cast<float>(t.mcc[lw]),
      t.s12[s] * static_cast<float>(t.mff[s]), t.s12[ln] * static_cast<float>(t.mff[ln]),
      t.v[s], t.v[ln], t.v[lw], t.v[lwn], t.ve[s], t.ve[ln], t.ve[lw], t.ve[lwn], t.u[s],
      DRAG ? t.u[ln] : 0.0f, t.ue[s], __ldg(c.tau_u + k), __ldg(c.drag_u + k),
      __ldg(c.invm_u + k), __ldg(c.un + k), __ldg(c.act_u + k), DRAG,
      DRAG ? __ldg(c.imms_u + k) : 0.0f, DRAG ? __ldg(c.immn_u + k) : 0.0f, t.al[s], t.al[lw]);
}

// the v update of tile position (r, c): the update at its fill source
template <class Plan, bool DRAG>
__device__ __forceinline__ float v_at(const Tile<Plan>& t, const PaddedConsts& c, int r,
                                      int col) {
  constexpr int SY = Plan::SY;
  const int dc = t.ay->dF[col];
  if (dc == ZERO_SOURCE) return 0.0f;
  const int sr = r + t.ax->dC[r], sc = col + dc;
  const int s = sr * SY + sc, lso = s - 1, le = s + SY, les = s + SY - 1;
  const int k = t.ax->cs[sr] + t.ay->cs[sc];
  return v_update_point(
      t.up, t.s22[s] * static_cast<float>(t.mcc[s]), t.s22[lso] * static_cast<float>(t.mcc[lso]),
      t.s12[s] * static_cast<float>(t.mff[s]), t.s12[le] * static_cast<float>(t.mff[le]),
      t.u[s], t.u[lso], t.u[le], t.u[les], t.ue[s], t.ue[lso], t.ue[le], t.ue[les], t.v[s],
      DRAG ? t.v[le] : 0.0f, t.ve[s], __ldg(c.tau_v + k), __ldg(c.drag_v + k),
      __ldg(c.invm_v + k), __ldg(c.vn + k), __ldg(c.act_v + k), DRAG,
      DRAG ? __ldg(c.immw_v + k) : 0.0f, DRAG ? __ldg(c.imme_v + k) : 0.0f, t.al[s], t.al[lso]);
}

// substeps T … K of the chunk (substep k0 + T first), stopping after nk
template <class Plan, bool DRAG, int T>
__device__ __forceinline__ void substeps(Tile<Plan>& t, const PaddedConsts& c, int k0,
                                         int nk) {
  if constexpr (T <= Plan::K) {
    if (T > nk) return;
    constexpr int R = 2 * (Plan::K - T);   // the region exact after this substep
    over_region<Plan, R + 1>([&](int r, int col) { stress_at(t, c, r, col); });
    __syncthreads();
    auto u_new = [&](int r, int col) { return u_at<Plan, DRAG>(t, c, r, col); };
    auto v_new = [&](int r, int col) { return v_at<Plan, DRAG>(t, c, r, col); };
    // odd substeps: v then u; even substeps: u then v
    if ((k0 + T) % 2 == 0) {
      update_region<Plan, R + 1>(t.u, u_new);
      update_region<Plan, R>(t.v, v_new);
    } else {
      update_region<Plan, R + 1>(t.v, v_new);
      update_region<Plan, R>(t.u, u_new);
    }
    substeps<Plan, DRAG, T + 1>(t, c, k0, nk);
  }
}

// Substeps k0 + 1 … k0 + nk on the tile (blockIdx.y, blockIdx.x) of
// `geo`, from src into dst; α is written only with write_al.
template <class Plan, bool DRAG, class Geometry>
__global__ void __launch_bounds__(Plan::NTH, Plan::MINB) padded_tile_chunk(
    const float* __restrict__ prm, PaddedConsts c, Geometry geo, PaddedFields src,
    PaddedFields dst, int k0, int nk, int write_al) {
  extern __shared__ float sm[];
  __shared__ AxisTable<Plan::SX> ax;
  __shared__ AxisTable<Plan::SY> ay;
  constexpr int NS = Plan::NS, SX = Plan::SX, SY = Plan::SY;
  const int ny = geo.row_length();
  for (int l = threadIdx.x; l < SX + SY; l += Plan::NTH) {
    AxisEntry e;
    if (l < SX) {
      geo.entry(0, blockIdx.y, Plan::TX, Plan::O, l, e);
      ax.set(l, e, ny);
    } else {
      geo.entry(1, blockIdx.x, Plan::TY, Plan::O, l - SX, e);
      ay.set(l - SX, e, 1);
    }
  }
  Tile<Plan> t;
  t.u = sm;
  t.v = sm + NS;
  t.s11 = sm + 2 * NS;
  t.s22 = sm + 3 * NS;
  t.s12 = sm + 4 * NS;
  t.al = sm + 5 * NS;
  t.ue = sm + 6 * NS;
  t.ve = sm + 7 * NS;
  t.mcc = reinterpret_cast<unsigned char*>(sm + 8 * NS);
  t.mff = t.mcc + NS;
  t.ax = &ax;
  t.ay = &ay;
  t.sp = stress_params(prm);
  t.up = update_params(prm);
  __syncthreads();

  for (int l = threadIdx.x; l < NS; l += Plan::NTH) {
    const int r = l / SY, col = l - r * SY;
    const int k = ax.cs[r] + ay.cs[col];
    t.ue[l] = __ldg(c.ue + k);
    t.ve[l] = __ldg(c.ve + k);
    t.mcc[l] = __ldg(c.msk_cc + k) != 0.0f;
    t.mff[l] = __ldg(c.msk_ff + k) != 0.0f;
  }
  // Up to here nothing reads what the previous chunk writes: a chunk
  // launched as a programmatic dependent of the previous one waits for it
  // only now (a no-op for a chunk launched the ordinary way).
  cudaGridDependencySynchronize();
  // the chunk starts from filled velocities: each position reads its fill
  // source (wherever it lies) or zero
  for (int l = threadIdx.x; l < NS; l += Plan::NTH) {
    const int r = l / SY, col = l - r * SY;
    const int fx = ax.ldF[r], fy = ay.ldF[col];
    t.u[l] = fx < 0 ? 0.0f : src.u[fx + ay.ldC[col]];
    t.v[l] = fy < 0 ? 0.0f : src.v[ax.ldC[r] + fy];
    const int g = ax.ld[r] + ay.ld[col];
    t.s11[l] = src.s11[g];
    t.s22[l] = src.s22[g];
    t.s12[l] = src.s12[g];
  }
  __syncthreads();
  cudaTriggerProgrammaticLaunchCompletion();

  substeps<Plan, DRAG, 1>(t, c, k0, nk);

  for (int l = threadIdx.x; l < Plan::TX * Plan::TY; l += Plan::NTH) {
    const int r = l / Plan::TY + Plan::O, col = l % Plan::TY + Plan::O;
    const int ox = ax.out[r], oy = ay.out[col];
    if (ox < 0 || oy < 0) continue;
    const int s = r * SY + col, g = ox + oy;
    dst.u[g] = t.u[s];
    dst.v[g] = t.v[s];
    dst.s11[g] = t.s11[s];
    dst.s22[g] = t.s22[s];
    dst.s12[g] = t.s12[s];
    if (write_al) dst.al[g] = t.al[s];
  }
}

template <class Plan, class Geometry>
cudaError_t prepare_tile_chunks() {
  cudaError_t err = cudaFuncSetAttribute(padded_tile_chunk<Plan, true, Geometry>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Plan::SMEM));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(padded_tile_chunk<Plan, false, Geometry>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Plan::SMEM));
}

// Runs nsub substeps in chunks of `chunk` (at most K) on a grid of
// (tiles_y, tiles_x) tiles, ping-ponging the fields between f and g; the
// results are left in f.  Returns 0 or the first CUDA error; `launches`
// counts the kernel launches.
template <class Plan, class Geometry>
cudaError_t run_tile_chunks(const float* params, const PaddedConsts& c, const Geometry& geo,
                            PaddedFields f, PaddedFields g, int tiles_x, int tiles_y,
                            bool has_drag, int nsub, int chunk, size_t elements,
                            cudaStream_t s, int* launches) {
  cudaError_t err = prepare_tile_chunks<Plan, Geometry>();
  if (err != cudaSuccess) return err;
  const int K = chunk > 0 && chunk < Plan::K ? chunk : Plan::K;
  const dim3 grid(tiles_y, tiles_x);
  const PaddedFields out = f;
  for (int k0 = 0; k0 < nsub; k0 += K) {
    const int nk = nsub - k0 < K ? nsub - k0 : K;
    const int last = k0 + nk == nsub;
    // Every chunk but the first (which follows the caller's kernels, the
    // constants' writers) may start before the previous chunk ends.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = k0 > 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(Plan::NTH);
    cfg.dynamicSmemBytes = Plan::SMEM;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = has_drag
        ? cudaLaunchKernelEx(&cfg, padded_tile_chunk<Plan, true, Geometry>, params, c, geo, f,
                             g, k0, nk, last)
        : cudaLaunchKernelEx(&cfg, padded_tile_chunk<Plan, false, Geometry>, params, c, geo, f,
                             g, k0, nk, last);
    if (err != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
    const PaddedFields t = f;
    f = g;
    g = t;
  }
  if (f.u != out.u) {   // an odd number of chunks left the results in the scratch arrays
    const size_t bytes = sizeof(float) * elements;
    float* dst[6] = {out.u, out.v, out.s11, out.s22, out.s12, out.al};
    const float* from[6] = {f.u, f.v, f.s11, f.s22, f.s12, f.al};
    for (int q = 0; q < 6; ++q)
      if ((err = cudaMemcpyAsync(dst[q], from[q], bytes, cudaMemcpyDeviceToDevice, s)) !=
          cudaSuccess)
        return err;
  }
  return cudaSuccess;
}

// The drag kernel's build and occupancy into out[6]: registers a thread,
// spill bytes a thread, static and dynamic shared bytes a block, blocks an
// SM, threads a block.
template <class Plan, class Geometry>
cudaError_t describe_tile_chunks(int* out) {
  cudaError_t err = prepare_tile_chunks<Plan, Geometry>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, padded_tile_chunk<Plan, true, Geometry>)) !=
      cudaSuccess)
    return err;
  int blocks = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks, padded_tile_chunk<Plan, true, Geometry>, Plan::NTH, Plan::SMEM)) !=
      cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(Plan::SMEM);
  out[4] = blocks;
  out[5] = Plan::NTH;
  return cudaSuccess;
}

}  // namespace csi_evp
