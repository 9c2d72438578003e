// Substep-chunked tiled padded αEVP loop for NVIDIA Hopper (sm_90a): the
// decomposition-invariant (fixed-tile) EVP route.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_tiled_padded.py::
// _tiled_padded_kernel`: the padded kernel's substeps (evp_padded.cu) run
// in chunks of K on halo-extended tiles.  A launch takes one chunk: each
// block loads a tile of the six carried fields (u, v, σ₁₁, σ₂₂, σ₁₂, α)
// into shared memory, runs K substeps there and writes the tile's interior
// back.  The overlap W = 2K + 3 on each side covers the 2 points per
// substep by which a value at the tile edge, whose neighbours outside the
// tile are not known, spoils the points inside.  Constants are read from
// device memory.
//
// Tiles are indexed by interior coordinates g (0 ≤ g < N inside the domain),
// as the TPU kernel's: a carried field is read at its interior image (wrap
// where periodic, clamp where bounded), a constant at its padded image
// (true halo values, clamped beyond the padded edge).
//
// On one rank's shard of the distributed step (the 'wide' halo policy) a
// direction split across ranks is carried over its whole padded extent,
// −H ≤ g < N + H (pallas_evp_tiled_padded.py:496-530, 664-683): its halo
// points are real points whose values go stale from the outside in, two
// points a substep.  Along it the tiles cover the padded extent, carried
// fields and constants alike are read at the padded index clamped at the
// padded edge, no wall fill applies (`_make_slab_fillers`' skip, :212-217),
// and every point of the padded extent is written back.  After every
// half-update the velocities get the TPU kernel's gated wall fills
// (`_make_slab_fillers`): along a bounded direction the wall-normal
// component is zero outside [0, N) and the tangential one repeats the
// domain's edge row.  As in evp_padded.cu a thread writes the update of its
// fill source, or zero, so the fill needs no pass of its own; u and v are
// ping-ponged between two shared buffers, and nothing a thread reads in a
// phase is written by another thread in that phase.
//
// What bounds it on an H100: the function is evp_padded.cu's, 155 float32
// operations per point and substep with drag (chip_smoke.py's
// PADDED_FLOPS_PER_POINT_SUBSTEP), so at 512² (522² padded) and 120
// substeps the call is bound by operations (0.076 ms at 67 TFLOP/s)
// against 37 MB of bytes (0.011 ms).  The tiles recompute their overlap:
// with TX × TY = 64 × 96 and W = 11 a tile writes 42 × 74 of its 6144
// points, 1.97× the function's operations, and each substep reads the 22
// constants from device memory (L2), as evp_padded.cu does.
//
// The plan (TX, TY, K) is this file's, chosen for the card: 8 arrays of
// 64 × 96 floats are 196,608 bytes of shared memory, one block per SM, 512
// threads.  The TPU's (8, 128) tiles and W = 3K + 3 only served Mosaic.
// `fixed_tiles` selects this route; it does not set the tile: a point's
// value does not depend on the plan.
//
// Arithmetic: evp_common.cuh's `stress_point`, `u_update_point` and
// `v_update_point`, the same code evp_padded.cu runs, built with
// -fmad=false (`_build.py`): no multiply-add is contracted, so a point's
// bits do not depend on the tile, the chunk, the halo width or the launch.

#include "evp_common.cuh"

namespace {

using namespace csi_evp;

constexpr int KMAX = 4;             // the most substeps a launch runs
constexpr int W = 2 * KMAX + 3;     // overlap on each side of a tile
constexpr int TX = 64;              // tile rows (x)
constexpr int TY = 96;              // tile columns (y, the contiguous axis)
constexpr int OX = TX - 2 * W;      // interior rows a tile writes
constexpr int OY = TY - 2 * W;      // interior columns a tile writes
constexpr int NT = TX * TY;
constexpr int TBX = 32;             // threads along y
constexpr int TBY = 16;             // threads along x
constexpr int NTHREADS = TBX * TBY;
constexpr size_t SMEM_BYTES = 8 * NT * sizeof(float);

// how a direction's halos are treated (fused_evp_padded.direction_kinds)
constexpr int KIND_BOUNDED = 0;   // walls, filled in the kernel
constexpr int KIND_PERIODIC = 1;  // wrap into the interior
constexpr int KIND_SPLIT = 2;     // split across ranks: the padded extent carried

struct Layout {
  int nxp, nyp;        // padded extents
  int Hx, Nx, Hy, Ny;  // halos and interior sizes
  int kind_x, kind_y;  // KIND_* of each direction
};

// The constant arrays of one call (padded layout).  The four drag arrays
// are null without drag.
struct Consts {
  const float *P, *Pff, *gcc, *gff;
  const float *drag_u, *invm_u, *act_u, *un;
  const float *drag_v, *invm_v, *act_v, *vn;
  const float *msk_cc, *msk_ff;
  const float *imms_u, *immn_u, *immw_v, *imme_v;
  const float *tau_u, *tau_v, *ue, *ve;
};

struct Fields {
  float *u, *v, *s11, *s22, *s12, *al;
};

// padded index of a carried field's image at interior coordinate g
__device__ __forceinline__ int carry_index(int g, int H, int N, int ext, int kind) {
  if (kind == KIND_SPLIT) return clampi(g + H, 0, ext - 1);
  return H + (kind == KIND_PERIODIC ? wrapi(g, N) : clampi(g, 0, N - 1));
}

// padded index of a constant's image at interior coordinate g
__device__ __forceinline__ int const_index(int g, int H, int N, int ext, int kind) {
  return kind == KIND_PERIODIC ? H + wrapi(g, N) : clampi(g + H, 0, ext - 1);
}

// the first interior coordinate a direction carries, and how many
__device__ __host__ __forceinline__ int carried_lo(int H, int kind) {
  return kind == KIND_SPLIT ? -H : 0;
}
__device__ __host__ __forceinline__ int carried_n(int H, int N, int kind) {
  return kind == KIND_SPLIT ? N + 2 * H : N;
}

__global__ void __launch_bounds__(NTHREADS) tiled_chunk(
    const float* __restrict__ prm, Consts c, Layout L, int has_drag_i, Fields in,
    Fields out, int k0, int nk) {
  extern __shared__ float sm[];
  __shared__ int crow[TX], ccol[TY];   // padded rows / columns of the constants
  float* ua = sm;
  float* ub = sm + NT;
  float* va = sm + 2 * NT;
  float* vb = sm + 3 * NT;
  float* s11 = sm + 4 * NT;
  float* s22 = sm + 5 * NT;
  float* s12 = sm + 6 * NT;
  float* al = sm + 7 * NT;
  const bool has_drag = has_drag_i != 0;
  // interior coordinates of tile point (0, 0)
  const int gx0 = carried_lo(L.Hx, L.kind_x) + blockIdx.y * OX - W;
  const int gy0 = carried_lo(L.Hy, L.kind_y) + blockIdx.x * OY - W;
  const int tid = threadIdx.y * TBX + threadIdx.x;
  const int ny = L.nyp;
  // the gated wall fills act along bounded directions with a halo
  const bool wall_x = L.kind_x == KIND_BOUNDED && L.Hx > 0;
  const bool wall_y = L.kind_y == KIND_BOUNDED && L.Hy > 0;

  for (int l = tid; l < TX; l += NTHREADS)
    crow[l] = const_index(gx0 + l, L.Hx, L.Nx, L.nxp, L.kind_x);
  for (int l = tid; l < TY; l += NTHREADS)
    ccol[l] = const_index(gy0 + l, L.Hy, L.Ny, L.nyp, L.kind_y);
  for (int l = tid; l < NT; l += NTHREADS) {
    const int li = l / TY, lj = l % TY;
    const int k = carry_index(gx0 + li, L.Hx, L.Nx, L.nxp, L.kind_x) * ny
                  + carry_index(gy0 + lj, L.Hy, L.Ny, L.nyp, L.kind_y);
    ua[l] = in.u[k];
    va[l] = in.v[k];
    s11[l] = in.s11[k];
    s22[l] = in.s22[k];
    s12[l] = in.s12[k];
    al[l] = in.al[k];
  }
  __syncthreads();

  // Fill sources: u (f,c) is zero off [0, Nx) along a bounded x and takes
  // the edge column along a bounded y; v (c,f) the other way round
  // (fill_y(fill_x(·)) of `_make_slab_fillers`).  False where it is zero.
  auto u_source = [&](int li, int lj, int& sj) {
    const int gx = gx0 + li, gy = gy0 + lj;
    if (wall_x && (gx < 0 || gx >= L.Nx)) return false;
    sj = wall_y ? lj + (clampi(gy, 0, L.Ny - 1) - gy) : lj;
    return true;
  };
  auto v_source = [&](int li, int lj, int& si) {
    const int gx = gx0 + li, gy = gy0 + lj;
    if (wall_y && (gy < 0 || gy >= L.Ny)) return false;
    si = wall_x ? li + (clampi(gx, 0, L.Nx - 1) - gx) : li;
    return true;
  };

  // the chunk starts from filled velocities, as the TPU kernel's does
  for (int l = tid; l < NT; l += NTHREADS) {
    const int li = l / TY, lj = l % TY;
    int sj, si;
    ub[l] = u_source(li, lj, sj) ? ua[li * TY + sj] : 0.0f;
    vb[l] = v_source(li, lj, si) ? va[si * TY + lj] : 0.0f;
  }
  __syncthreads();
  float* u = ub;
  float* u_next = ua;
  float* v = vb;
  float* v_next = va;

  for (int t = 0; t < nk; ++t) {
    const int substep = k0 + t + 1;
    for (int l = tid; l < NT; l += NTHREADS) {
      const int li = l / TY, lj = l % TY;
      float U[3][3], V[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int r = clampi(li + a - 1, 0, TX - 1) * TY;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int q = r + clampi(lj + b - 1, 0, TY - 1);
          U[a][b] = u[q];
          V[a][b] = v[q];
        }
      }
      const int k = crow[li] * ny + ccol[lj];
      float x11 = s11[l], x22 = s22[l], x12 = s12[l];
      al[l] = stress_point(prm, U, V, c.P[k], c.Pff[k], c.gcc[k], c.gff[k], x11, x22, x12);
      s11[l] = x11;
      s22[l] = x22;
      s12[l] = x12;
    }
    __syncthreads();
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      if ((substep % 2 == 0) == (half == 0)) {
        for (int l = tid; l < NT; l += NTHREADS) {
          const int li = l / TY, lj0 = l % TY;
          int lj;
          if (!u_source(li, lj0, lj)) {
            u_next[l] = 0.0f;
            continue;
          }
          const int iw = li > 0 ? li - 1 : 0;
          const int jn = lj < TY - 1 ? lj + 1 : TY - 1;
          const int ls = li * TY + lj, lw = iw * TY + lj, ln = li * TY + jn,
                    lwn = iw * TY + jn;
          const int ks = crow[li] * ny + ccol[lj], kw = crow[iw] * ny + ccol[lj],
                    kn = crow[li] * ny + ccol[jn], kwn = crow[iw] * ny + ccol[jn];
          u_next[l] = u_update_point(
              prm, s11[ls] * c.msk_cc[ks], s11[lw] * c.msk_cc[kw], s12[ls] * c.msk_ff[ks],
              s12[ln] * c.msk_ff[kn], v[ls], v[ln], v[lw], v[lwn], c.ve[ks], c.ve[kn],
              c.ve[kw], c.ve[kwn], u[ls], has_drag ? u[ln] : 0.0f, c.ue[ks], c.tau_u[ks],
              c.drag_u[ks], c.invm_u[ks], c.un[ks], c.act_u[ks], has_drag,
              has_drag ? c.imms_u[ks] : 0.0f, has_drag ? c.immn_u[ks] : 0.0f, al[ls], al[lw]);
        }
        float* swap = u;
        u = u_next;
        u_next = swap;
      } else {
        for (int l = tid; l < NT; l += NTHREADS) {
          const int li0 = l / TY, lj = l % TY;
          int li;
          if (!v_source(li0, lj, li)) {
            v_next[l] = 0.0f;
            continue;
          }
          const int js = lj > 0 ? lj - 1 : 0;
          const int ie = li < TX - 1 ? li + 1 : TX - 1;
          const int ls = li * TY + lj, lso = li * TY + js, le = ie * TY + lj,
                    les = ie * TY + js;
          const int ks = crow[li] * ny + ccol[lj], kso = crow[li] * ny + ccol[js],
                    ke = crow[ie] * ny + ccol[lj], kes = crow[ie] * ny + ccol[js];
          v_next[l] = v_update_point(
              prm, s22[ls] * c.msk_cc[ks], s22[lso] * c.msk_cc[kso], s12[ls] * c.msk_ff[ks],
              s12[le] * c.msk_ff[ke], u[ls], u[lso], u[le], u[les], c.ue[ks], c.ue[kso],
              c.ue[ke], c.ue[kes], v[ls], has_drag ? v[le] : 0.0f, c.ve[ks], c.tau_v[ks],
              c.drag_v[ks], c.invm_v[ks], c.vn[ks], c.act_v[ks], has_drag,
              has_drag ? c.immw_v[ks] : 0.0f, has_drag ? c.imme_v[ks] : 0.0f, al[ls], al[lso]);
        }
        float* swap = v;
        v = v_next;
        v_next = swap;
      }
      __syncthreads();
    }
  }

  // the tile's interior points inside the carried extent go back to device
  // memory
  const int gx_end = carried_lo(L.Hx, L.kind_x) + carried_n(L.Hx, L.Nx, L.kind_x);
  const int gy_end = carried_lo(L.Hy, L.kind_y) + carried_n(L.Hy, L.Ny, L.kind_y);
  for (int l = tid; l < NT; l += NTHREADS) {
    const int li = l / TY, lj = l % TY;
    const int gx = gx0 + li, gy = gy0 + lj;
    if (li < W || li >= W + OX || lj < W || lj >= W + OY || gx >= gx_end || gy >= gy_end)
      continue;
    const int k = (L.Hx + gx) * ny + L.Hy + gy;
    out.u[k] = u[l];
    out.v[k] = v[l];
    out.s11[k] = s11[l];
    out.s22[k] = s22[l];
    out.s12[k] = s12[l];
    out.al[k] = al[l];
  }
}

}  // namespace

// The most substeps a launch runs (the overlap W is sized for it).
extern "C" int csi_evp_tiled_chunk_substeps() { return KMAX; }

// Runs `nsub` substeps on u, v, s11, s22, s12, al (each nxp×nyp, row-major,
// y contiguous; only their interiors are read, and their halos along a
// direction of kind KIND_SPLIT) on `stream`, in chunks of
// `chunk` substeps (KMAX where chunk is 0 or larger), ping-ponging with the six scratch arrays `tmp` (tmp[0..5] in the
// same order).  The interiors of the results (and the halos along a split
// direction) are left in u … al; the other halos are not defined (the
// caller refills them).  The drag arrays may be
// null when has_drag is 0.  Returns 0, or the first nonzero CUDA error.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = chunk > 0 && chunk < KMAX ? chunk : KMAX;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const Layout L{nxp, nyp, Hx, Nx, Hy, Ny, kind_x, kind_y};
  const Consts c{P, Pff, gcc, gff, drag_u, invm_u, act_u, un, drag_v, invm_v, act_v, vn,
                 msk_cc, msk_ff, imms_u, immn_u, immw_v, imme_v, tau_u, tau_v, ue, ve};
  Fields a{u, v, s11, s22, s12, al};
  Fields b{t_u, t_v, t_s11, t_s22, t_s12, t_al};
  const dim3 block(TBX, TBY);
  const dim3 grid((carried_n(Hy, Ny, kind_y) + OY - 1) / OY,
                  (carried_n(Hx, Nx, kind_x) + OX - 1) / OX);
  for (int k0 = 0; k0 < nsub; k0 += K) {
    const int nk = nsub - k0 < K ? nsub - k0 : K;
    tiled_chunk<<<grid, block, SMEM_BYTES, s>>>(params, c, L, has_drag, a, b, k0, nk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const Fields t = a;
    a = b;
    b = t;
  }
  if (a.u != u) {   // an odd number of chunks left the results in tmp
    const size_t bytes = sizeof(float) * static_cast<size_t>(nxp) * nyp;
    float* dst[6] = {u, v, s11, s22, s12, al};
    const float* src[6] = {a.u, a.v, a.s11, a.s22, a.s12, a.al};
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
