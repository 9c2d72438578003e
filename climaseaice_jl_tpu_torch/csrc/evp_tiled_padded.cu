// Substep-chunked tiled padded αEVP loop for NVIDIA Hopper (sm_90a): the
// decomposition-invariant (fixed-tile) EVP route.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_tiled_padded.py::
// _tiled_padded_kernel`: the padded kernel's substeps (evp_padded.cu) on
// the interiors of padded arrays, K substeps a launch on tiles in shared
// memory (the engine of evp_padded_tile.cuh).
//
// Tiles are indexed by interior coordinates g (0 ≤ g < N inside the domain),
// as the TPU kernel's: a carried field is read at its interior image (wrap
// where periodic, clamp where bounded), a constant at its padded image
// (true halo values, clamped beyond the padded edge).  After every
// half-update the velocities get the TPU kernel's gated wall fills
// (`_make_slab_fillers`): along a bounded direction the wall-normal
// component is zero outside [0, N) and the tangential one repeats the
// domain's edge row; a fill source lies between its position and the
// domain, so inside any region that holds the position.
//
// On one rank's shard of the distributed step (the 'wide' halo policy) a
// direction split across ranks is carried over its whole padded extent,
// −H ≤ g < N + H (pallas_evp_tiled_padded.py:496-530, 664-683): its halo
// points are real points whose values go stale from the outside in, two
// points a substep.  Along it the tiles cover the padded extent, carried
// fields and constants alike are read at the padded index clamped at the
// padded edge, no wall fill applies (`_make_slab_fillers`' skip, :212-217),
// and every point of the padded extent is written back.
//
// What bounds it on an H100: the function is evp_padded.cu's, 155 float32
// operations per point and substep with drag (chip_smoke.py's
// PADDED_FLOPS_PER_POINT_SUBSTEP), so at 512² (522² padded) and 120
// substeps the call is bound by operations (0.076 ms at 67 TFLOP/s)
// against 37 MB of bytes (0.011 ms).  The kernel issues several times the
// operations' instructions (index arithmetic, shared-memory traffic, the
// recomputed overlap), and reads the constants that are not staged from L2
// once per point and phase.
//
// The plan (K, TX, TY) is this file's, chosen for the card at 512² by
// timing candidates in turns (PERF.md): K = 2 substeps a launch on 16 × 32
// output tiles (24 × 40 positions in shared memory, 32.6 KB), 256 threads,
// four blocks (32 warps) an SM, 512 blocks at 512², 1.35× the function's
// points; one substep a launch was 1.1× slower, three 1.02×.  The TPU's
// (8, 128) tiles and W = 3K + 3 only served Mosaic.  `fixed_tiles` selects
// this route; it does not set the tile: a point's value does not depend on
// the plan.

#include "evp_padded_tile.cuh"

namespace {

using namespace csi_evp;

using Plan = TilePlan<2, 16, 32, 256, 4>;

// index of the carried field's image at interior coordinate g
__device__ __forceinline__ int carry_index(int g, const Direction& d) {
  if (d.kind == KIND_SPLIT) return clampi(g + d.H, 0, d.ext - 1);
  return d.H + (d.kind == KIND_WRAP ? wrapi(g, d.N) : clampi(g, 0, d.N - 1));
}

// index of the constant's image at interior coordinate g
__device__ __forceinline__ int const_index(int g, const Direction& d) {
  return d.kind == KIND_WRAP ? d.H + wrapi(g, d.N) : clampi(g + d.H, 0, d.ext - 1);
}

// the first interior coordinate a direction carries, and how many
__host__ __device__ __forceinline__ int carried_lo(const Direction& d) {
  return d.kind == KIND_SPLIT ? -d.H : 0;
}
__host__ __device__ __forceinline__ int carried_n(const Direction& d) {
  return d.kind == KIND_SPLIT ? d.N + 2 * d.H : d.N;
}

// Tiles in interior coordinates, TX × TY positions of the carried extent
// each, from its first coordinate on.
struct InteriorGeometry {
  Direction dir[2];

  __device__ int row_length() const { return dir[1].ext; }

  __device__ void entry(int axis, int tile, int T, int O, int l, AxisEntry& e) const {
    const Direction& d = dir[axis];
    const int o0 = carried_lo(d) + tile * T;
    const int end = min(o0 + T, carried_lo(d) + carried_n(d));
    const int g = o0 - O + l;
    e.ld = e.ldC = carry_index(g, d);
    e.cs = const_index(g, d);
    const bool wall = d.kind == KIND_WALL && d.H > 0;   // the gated wall fills
    const bool zero = wall && (g < 0 || g >= d.N);
    e.ldF = zero ? -1 : e.ld;
    e.dF = zero ? ZERO_SOURCE : 0;
    e.dC = wall ? clampi(g, 0, d.N - 1) - g : 0;
    e.out = g >= o0 && g < end ? d.H + g : -1;
  }
};

}  // namespace

// The most substeps a launch runs.
extern "C" int csi_evp_tiled_chunk_substeps() { return Plan::K; }

// The kernel's build and occupancy into out[6] (evp_padded_tile.cuh's
// describe_tile_chunks).  Returns 0 or a CUDA error.
extern "C" int csi_evp_tiled_padded_describe(int* out) {
  return describe_tile_chunks<Plan, InteriorGeometry>(out);
}

// Runs `nsub` substeps on u, v, s11, s22, s12, al (each nxp×nyp, row-major,
// y contiguous; only their interiors are read, and their halos along a
// direction of kind KIND_SPLIT; α is not read) on `stream`, in chunks of
// `chunk` substeps (K where chunk is 0 or larger), ping-ponging with the
// six scratch arrays `tmp` (tmp[0..5] in the same order).  The interiors of
// the results (and the halos along a split direction) are left in u … al;
// the other halos are not defined (the caller refills them).  msk_cc and
// msk_ff hold 0 or 1.  The drag arrays may be null when has_drag is 0.
// Returns 0, or the first nonzero CUDA error.
extern "C" int csi_evp_tiled_padded_substeps(
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
    int has_drag, int nsub, int chunk, void* stream) {
  const PaddedConsts c{P, Pff, gcc, gff, drag_u, invm_u, act_u, un, drag_v, invm_v, act_v,
                       vn, msk_cc, msk_ff, imms_u, immn_u, immw_v, imme_v, tau_u, tau_v,
                       ue, ve};
  const InteriorGeometry geo{{{nxp, Hx, Nx, kind_x}, {nyp, Hy, Ny, kind_y}}};
  const int tiles_x = (carried_n(geo.dir[0]) + Plan::TX - 1) / Plan::TX;
  const int tiles_y = (carried_n(geo.dir[1]) + Plan::TY - 1) / Plan::TY;
  int launches = 0;
  return run_tile_chunks<Plan>(params, c, geo, PaddedFields{u, v, s11, s22, s12, al},
                               PaddedFields{t_u, t_v, t_s11, t_s22, t_s12, t_al}, tiles_x,
                               tiles_y, has_drag != 0, nsub, chunk,
                               static_cast<size_t>(nxp) * nyp,
                               static_cast<cudaStream_t>(stream), &launches);
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
