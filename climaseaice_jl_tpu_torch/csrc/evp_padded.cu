// Padded split-explicit αEVP substep loop for NVIDIA Hopper (sm_90a):
// bounded walls, immersed land masks and the linear immersed drag.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_padded.py::_padded_kernel`:
// the whole `nsub`-substep loop on halo-inclusive (nxp, nyp) float32 arrays.
// After every half-update the new u (f,c) or v (c,f) has its halos refilled
// as `_make_fillers` does: zero beyond a bounded wall for the wall-normal
// component, edge copy for the tangential one, wrap where periodic, corners
// from fill_y(fill_x(q)).  σ read by the divergence is masked at solid cc
// and peripheral ff nodes, velocities by the activity masks, and with
// `has_drag` the immersed drag −(gˢ·u(i,j) + gᴺ·u(i,j+1))·invm_u (west/east
// for v) enters G.  Stresses and ocean velocities are arrays.  Neighbours
// wrap over the padded extent (the TPU kernel's `pltpu.roll`), so σ and α
// in the outermost halo ring come from the far side's halo.
//
// On one rank's shard of the distributed step (the 'wide' halo policy,
// halos of 2·substeps+3 along the split directions) a direction split
// across ranks gets no fill (`_make_fillers`' skip_x / skip_y,
// pallas_evp_padded.py:119-129): its halo points are real points that
// evolve in place, with neighbours wrapped over the padded extent as
// everywhere else, and go stale from the outside in, two points a substep;
// the caller's halo width keeps the staleness out of the interior.
//
// What bounds it on an H100.  Per point and substep the function needs 155
// float32 operations with drag, each value computed once at its own point
// (145 without drag; counted in chip_smoke.py's
// PADDED_FLOPS_PER_POINT_SUBSTEP), and 8 per point and call for the
// loop-invariant forms.  A call only has to read 28 arrays (24 without
// drag) and write 6, once.  At 512² (522² padded) and 120 substeps that is
// 5.1 GFLOP (0.076 ms at 67 TFLOP/s) against 37 MB (0.011 ms at 3.35
// TB/s): the call is bound by operations.
//
// Design: evp_padded_tile.cuh's engine, K substeps a launch, on tiles of
// the padded arrays seen as a torus (a tile's positions are consecutive
// padded indices, wrapped), which is where the function's neighbours are.
// A velocity at a halo position is the update at its fill source: along a
// bounded direction at most H + 1 positions away across the padded edge
// (the edge copy of the far side's last row), along a periodic one 2H
// positions away across it (padded index q < H takes q + N, which on the
// torus of nxp = N + 2H points is q − 2H).  So along such a direction one
// tile is centred on the padded edge, and its half-width covers every fill
// source of the halo (`seam_fits`); the other tiles' regions stay clear of
// the halo.  Along a split direction nothing is filled and the tiles start
// at 0.  Each position loads its velocities at its fill source, wherever
// that lies, so the chunk starts from filled velocities.  A configuration
// whose halo is too wide for the plan's tile (with K = 2 on 22 × 24 tiles:
// a periodic halo above 5 along x or 6 along y, a bounded one above 10 or
// 11; the serial periodic grid with the wide halo of the distributed step)
// runs the per-phase kernels below instead: three launches a substep, one
// thread per padded point, each update thread computing at its fill
// source, and two fills before the loop.
//
// The plan (K, TX, TY) is this file's, chosen for the card at 522² by
// timing candidates in turns (PERF.md): K = 2 substeps a launch on 22 × 24
// output tiles (30 × 32 positions in shared memory, 32.6 KB), 256 threads,
// four blocks (32 warps) an SM; at 522² that is 24 × 22 = 528 blocks, one
// for every four-block slot of the 132 SMs, and 1.3× the function's
// points; one substep a launch was 1.2× slower.
//
// Arithmetic: evp_common.cuh's point functions, the same code
// evp_tiled_padded.cu runs, in the TPU kernel's algebra and operation order
// (pallas_evp_padded.py:268-340), `rsqrtf` for `lax.rsqrt`, IEEE `sqrtf`
// and division (no --use_fast_math), built with -fmad=false (`_build.py`):
// the two kernels compute the same bits at a point from the same inputs.

#include "evp_padded_tile.cuh"

namespace {

using namespace csi_evp;

using Plan = TilePlan<2, 22, 24, 256, 4>;

// Source index of padded index i along a direction of the halo fill, or -1
// where the fill writes zero (pallas_evp_padded.py:131-156); the point
// itself along a split direction, which is not filled.
__host__ __device__ __forceinline__ int fill_source(int i, const Direction& d, bool face) {
  if (d.H == 0 || d.kind == KIND_SPLIT) return i;
  if (d.kind == KIND_WRAP) return i < d.H ? i + d.N : (i >= d.H + d.N ? i - d.N : i);
  if (face) return (i < d.H || i > d.H + d.N) ? -1 : i;
  return i < d.H ? d.H : (i >= d.H + d.N ? d.H + d.N - 1 : i);
}

// whether a direction's fills reach across the padded edge
__host__ __device__ __forceinline__ bool has_seam(const Direction& d) {
  return d.H > 0 && d.kind != KIND_SPLIT;
}

// Whether one tile of T positions centred on the padded edge holds every
// fill source of the halo (periodic: 2H positions from the edge; bounded:
// H + 1), the other tiles' regions (up to 2K − 1 positions beyond their
// output) stay clear of the halo, and the tile does not wrap onto itself.
bool seam_fits(const Direction& d, int T) {
  if (!has_seam(d)) return true;
  const int reach = d.kind == KIND_WRAP ? 2 * d.H : d.H + 1;
  const int clear = d.kind == KIND_WRAP ? d.H + 2 * Plan::K : 2 * Plan::K;
  return T / 2 >= reach && T / 2 >= clear && d.ext >= T + 2 * Plan::O;
}

// tiles along a direction
int tiles_along(const Direction& d, int T) { return (d.ext + T - 1) / T; }

// Tiles on the padded torus: along a direction with a seam tile 0 covers
// [−T/2, T/2) and the others follow it; otherwise tiles start at 0.
struct TorusGeometry {
  Direction dir[2];

  __device__ int row_length() const { return dir[1].ext; }

  __device__ void entry(int axis, int tile, int T, int O, int l, AxisEntry& e) const {
    const Direction& d = dir[axis];
    int o0, end;
    if (has_seam(d)) {
      o0 = tile == 0 ? -T / 2 : T / 2 + (tile - 1) * T;
      end = tile == 0 ? o0 + T : min(o0 + T, d.ext - T / 2);
    } else {
      o0 = tile * T;
      end = min(o0 + T, d.ext);
    }
    const int p = o0 - O + l;            // torus coordinate
    const int q = wrapi(p, d.ext);       // its padded index
    e.ld = e.cs = q;
    e.ldF = fill_source(q, d, true);
    e.ldC = fill_source(q, d, false);
    // the displacement to the source on the torus: across the edge for a
    // periodic halo point
    auto step = [&](int src) {
      const int delta = src - q;
      if (d.kind != KIND_WRAP || delta == 0) return delta;
      return delta > 0 ? delta - d.ext : delta + d.ext;
    };
    e.dF = e.ldF < 0 ? ZERO_SOURCE : step(e.ldF);
    e.dC = step(e.ldC);
    e.out = p >= o0 && p < end ? q : -1;
  }
};

// --- the per-phase kernels, for halos too wide for the plan's tile ----------

// The padded point of this thread and the source point of its fill; false
// when the thread is off the array.  `zero` is set where the fill writes 0.
__device__ __forceinline__ bool locate_source(const Direction& dx, const Direction& dy,
                                              bool face_x, bool face_y, int& k, int& si,
                                              int& sj, bool& zero) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= dx.ext || j >= dy.ext) return false;
  k = i * dy.ext + j;
  si = fill_source(i, dx, face_x);
  sj = fill_source(j, dy, face_y);
  zero = si < 0 || sj < 0;
  return true;
}

__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// Halo fill of u (face_x) or v (face_y) from `in` into another array `out`.
__global__ void __launch_bounds__(BX * BY) fill_halos(
    const float* __restrict__ in, float* __restrict__ out, Direction dx, Direction dy,
    int face_x, int face_y) {
  int k, si, sj;
  bool zero;
  if (!locate_source(dx, dy, face_x, face_y, k, si, sj, zero)) return;
  out[k] = zero ? 0.0f : in[si * dy.ext + sj];
}

// semi-implicit u update at (f,c) followed by the (f,c) halo fill
// (pallas_evp_padded.py:308-323)
__global__ void __launch_bounds__(BX * BY) padded_u_update(
    const float* __restrict__ prm, PaddedConsts c, Direction dx, Direction dy, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s12,
    const float* __restrict__ al, float* __restrict__ u_out) {
  int k, si, sj;
  bool zero;
  if (!locate_source(dx, dy, true, false, k, si, sj, zero)) return;
  if (zero) {
    u_out[k] = 0.0f;
    return;
  }
  const int ny = dy.ext;
  const int ks = si * ny + sj;                        // (i, j)
  const int kw = wrap1(si - 1, dx.ext) * ny + sj;     // (i-1, j)
  const int jn = wrap1(sj + 1, ny);
  const int kn = si * ny + jn;                        // (i, j+1)
  const int kwn = wrap1(si - 1, dx.ext) * ny + jn;    // (i-1, j+1)
  u_out[k] = u_update_point(
      update_params(prm), s11[ks] * c.msk_cc[ks], s11[kw] * c.msk_cc[kw],
      s12[ks] * c.msk_ff[ks], s12[kn] * c.msk_ff[kn], v[ks], v[kn], v[kw], v[kwn], c.ve[ks],
      c.ve[kn], c.ve[kw], c.ve[kwn], u[ks], has_drag ? u[kn] : 0.0f, c.ue[ks], c.tau_u[ks],
      c.drag_u[ks], c.invm_u[ks], c.un[ks], c.act_u[ks], has_drag,
      has_drag ? c.imms_u[ks] : 0.0f, has_drag ? c.immn_u[ks] : 0.0f, al[ks], al[kw]);
}

// semi-implicit v update at (c,f) followed by the (c,f) halo fill
// (pallas_evp_padded.py:325-340)
__global__ void __launch_bounds__(BX * BY) padded_v_update(
    const float* __restrict__ prm, PaddedConsts c, Direction dx, Direction dy, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s22, const float* __restrict__ s12,
    const float* __restrict__ al, float* __restrict__ v_out) {
  int k, si, sj;
  bool zero;
  if (!locate_source(dx, dy, false, true, k, si, sj, zero)) return;
  if (zero) {
    v_out[k] = 0.0f;
    return;
  }
  const int ny = dy.ext;
  const int ks = si * ny + sj;                        // (i, j)
  const int js = wrap1(sj - 1, ny);
  const int kso = si * ny + js;                       // (i, j-1)
  const int ie = wrap1(si + 1, dx.ext);
  const int ke = ie * ny + sj;                        // (i+1, j)
  const int kes = ie * ny + js;                       // (i+1, j-1)
  v_out[k] = v_update_point(
      update_params(prm), s22[ks] * c.msk_cc[ks], s22[kso] * c.msk_cc[kso],
      s12[ks] * c.msk_ff[ks], s12[ke] * c.msk_ff[ke], u[ks], u[kso], u[ke], u[kes], c.ue[ks],
      c.ue[kso], c.ue[ke], c.ue[kes], v[ks], has_drag ? v[ke] : 0.0f, c.ve[ks], c.tau_v[ks],
      c.drag_v[ks], c.invm_v[ks], c.vn[ks], c.act_v[ks], has_drag,
      has_drag ? c.immw_v[ks] : 0.0f, has_drag ? c.imme_v[ks] : 0.0f, al[ks], al[kso]);
}

// The loop with three launches a substep and two fills before it; u_tmp and
// v_tmp are scratch arrays.
cudaError_t run_phases(const float* params, const PaddedConsts& c, const Direction& dx,
                       const Direction& dy, int has_drag, PaddedFields f, float* u_tmp,
                       float* v_tmp, int nsub, cudaStream_t s, int* launches) {
  const dim3 block(BX, BY);
  const dim3 grid((dy.ext + BX - 1) / BX, (dx.ext + BY - 1) / BY);
  cudaError_t err;
  float* u_cur = u_tmp;
  float* u_oth = f.u;
  float* v_cur = v_tmp;
  float* v_oth = f.v;
  fill_halos<<<grid, block, 0, s>>>(f.u, u_cur, dx, dy, 1, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fill_halos<<<grid, block, 0, s>>>(f.v, v_cur, dx, dy, 0, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  *launches += 2;
  for (int k = 1; k <= nsub; ++k) {
    evp_stress<<<grid, block, 0, s>>>(params, c.P, c.Pff, c.gcc, c.gff, u_cur, v_cur, f.s11,
                                      f.s22, f.s12, f.al, dx.ext, dy.ext);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      if ((k % 2 == 0) == (half == 0)) {
        padded_u_update<<<grid, block, 0, s>>>(params, c, dx, dy, has_drag, u_cur, v_cur,
                                               f.s11, f.s12, f.al, u_oth);
        float* t = u_cur;
        u_cur = u_oth;
        u_oth = t;
      } else {
        padded_v_update<<<grid, block, 0, s>>>(params, c, dx, dy, has_drag, u_cur, v_cur,
                                               f.s22, f.s12, f.al, v_oth);
        float* t = v_cur;
        v_cur = v_oth;
        v_oth = t;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    *launches += 3;
  }
  const size_t bytes = sizeof(float) * static_cast<size_t>(dx.ext) * dy.ext;
  if (u_cur != f.u &&
      (err = cudaMemcpyAsync(f.u, u_cur, bytes, cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return err;
  if (v_cur != f.v &&
      (err = cudaMemcpyAsync(f.v, v_cur, bytes, cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

}  // namespace

// The substeps a launch of the tiled plan runs.
extern "C" int csi_evp_padded_chunk_substeps() { return Plan::K; }

// The tiled plan's build and occupancy into out[6] (evp_padded_tile.cuh's
// describe_tile_chunks).  Returns 0 or a CUDA error.
extern "C" int csi_evp_padded_describe(int* out) {
  return describe_tile_chunks<Plan, TorusGeometry>(out);
}

// Runs `nsub` substeps on the current contents of u, v, s11, s22, s12, al
// (each nxp×nyp, row-major, y contiguous; α is not read) on `stream`, each
// direction filled as its kind_x / kind_y (KIND_*) says; t_* are six
// scratch arrays of the same shape.  The results, the whole padded arrays,
// are left in u, v, s11, s22, s12, al.  msk_cc and msk_ff hold 0 or 1.  The
// drag arrays may be null when has_drag is 0.  The number of kernel
// launches is stored in *launches.  Returns 0, or the first nonzero CUDA
// error.
extern "C" int csi_evp_padded_substeps(
    const float* params,
    const float* P, const float* Pff, const float* gcc, const float* gff,
    const float* drag_u, const float* invm_u, const float* act_u, const float* un,
    const float* drag_v, const float* invm_v, const float* act_v, const float* vn,
    const float* msk_cc, const float* msk_ff,
    const float* imms_u, const float* immn_u, const float* immw_v, const float* imme_v,
    const float* tau_u, const float* tau_v, const float* ue, const float* ve,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    float* t_u, float* t_v, float* t_s11, float* t_s22, float* t_s12, float* t_al,
    int nxp, int nyp, int Hx, int Nx, int Hy, int Ny, int kind_x, int kind_y,
    int has_drag, int nsub, int* launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PaddedConsts c{P, Pff, gcc, gff, drag_u, invm_u, act_u, un, drag_v, invm_v, act_v,
                       vn, msk_cc, msk_ff, imms_u, immn_u, immw_v, imme_v, tau_u, tau_v,
                       ue, ve};
  const TorusGeometry geo{{{nxp, Hx, Nx, kind_x}, {nyp, Hy, Ny, kind_y}}};
  const PaddedFields f{u, v, s11, s22, s12, al};
  *launches = 0;
  if (seam_fits(geo.dir[0], Plan::TX) && seam_fits(geo.dir[1], Plan::TY))
    return run_tile_chunks<Plan>(params, c, geo, f,
                                 PaddedFields{t_u, t_v, t_s11, t_s22, t_s12, t_al},
                                 tiles_along(geo.dir[0], Plan::TX),
                                 tiles_along(geo.dir[1], Plan::TY), has_drag != 0, nsub, 0,
                                 static_cast<size_t>(nxp) * nyp, s, launches);
  return run_phases(params, c, geo.dir[0], geo.dir[1], has_drag, f, t_u, t_v, nsub, s,
                    launches);
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
