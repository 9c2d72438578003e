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
// for v) enters G.  Stresses and ocean velocities are arrays.
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
// loop-invariant forms; the kernel below does 201, because a thread
// recomputes its neighbours' strain rates and masked σ and the transverse
// averages of the ocean velocity, which the TPU kernel hoists out of the
// loop.  A call only has to read 28 arrays (24 without drag) and write 6,
// once.  At 512² (522² padded) and 120 substeps that is 5.1 GFLOP (0.076
// ms at 67 TFLOP/s) against 37 MB (0.011 ms at 3.35 TB/s): the call is
// bound by operations.
//
// Design (simple and right first), as evp.cu: one thread per padded point,
// threadIdx.x along the contiguous y axis, neighbours by index wrap over
// the padded extent (the TPU kernel's `pltpu.roll`).  Per substep three
// launches: `evp_stress` (evp_common.cuh), then `padded_u_update` and
// `padded_v_update` in the substep's order (odd substeps v then u, even u
// then v).  Each call starts with two `fill_halos` launches that fill the
// incoming u and v, as the TPU kernel does before its loop.
//
// Fills without a fill pass.  The halo fill only copies or zeroes, so the
// value at a halo point is the new value at its source point.  A thread of
// an update kernel maps its point (i, j) to the source (src_x(i), src_y(j))
// of `fill_y(fill_x(.))`, writes 0 where either map says zero, and else
// computes the update at the source from the old arrays.  The result is
// bitwise the update followed by the fill: the same arithmetic on the same
// inputs.
//
// Ping-pong buffers for u and v.  With drag the u update reads u(i, j+1)
// and the v update v(i+1, j); and a halo thread reads the neighbourhood of
// its source point, which other threads of the same launch write.  So each
// update reads the current buffer and writes the other one (the caller's
// array or a scratch array); σ and α are written only by `evp_stress`, each
// at its own point, where it alone reads them, as in evp.cu.  No thread of
// a launch reads what another thread of the same launch writes.  The first
// fill writes the scratch array; when the last update of u or v lands in
// scratch (nsub even), one device-to-device copy moves it to the caller's
// array.
//
// Arithmetic: the TPU kernel's algebra and operation order
// (pallas_evp_padded.py:268-340), `rsqrtf` for `lax.rsqrt`, IEEE `sqrtf`
// and division (no --use_fast_math).  The σ relaxation and the two updates
// are evp_common.cuh's point functions, which evp_tiled_padded.cu runs too;
// both sources are built with -fmad=false (`_build.py`), so the two kernels
// compute the same bits at a point from the same inputs.

#include "evp_common.cuh"

namespace {

using namespace csi_evp;

// how a direction's halos are filled (fused_evp_padded.direction_kinds)
constexpr int KIND_BOUNDED = 0;   // walls: zero or edge copy
constexpr int KIND_PERIODIC = 1;  // wrap into the interior
constexpr int KIND_SPLIT = 2;     // split across ranks: no fill

struct Layout {
  int nxp, nyp;        // padded extents
  int Hx, Nx, Hy, Ny;  // halos and interior sizes
  int kind_x, kind_y;  // KIND_* of each direction
};

// The constant arrays of one call.  The four drag arrays are null without
// drag.
struct Consts {
  const float *drag_u, *invm_u, *act_u, *un;
  const float *drag_v, *invm_v, *act_v, *vn;
  const float *msk_cc, *msk_ff;
  const float *imms_u, *immn_u, *immw_v, *imme_v;
  const float *tau_u, *tau_v, *ue, *ve;
};

// Source index of padded index i along a direction of the halo fill, or -1
// where the fill writes zero (pallas_evp_padded.py:131-156); the point
// itself along a split direction, which is not filled.
__device__ __forceinline__ int fill_source(int i, int H, int N, int kind,
                                           bool face) {
  if (H == 0 || kind == KIND_SPLIT) return i;
  if (kind == KIND_PERIODIC) return i < H ? i + N : (i >= H + N ? i - N : i);
  if (face) return (i < H || i > H + N) ? -1 : i;
  return i < H ? H : (i >= H + N ? H + N - 1 : i);
}

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// The padded point of this thread and the source point of its fill; false
// when the thread is off the array.  `zero` is set where the fill writes 0.
__device__ __forceinline__ bool locate_source(const Layout& L, bool face_x,
                                              bool face_y, int& k, int& si,
                                              int& sj, bool& zero) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= L.nxp || j >= L.nyp) return false;
  k = i * L.nyp + j;
  si = fill_source(i, L.Hx, L.Nx, L.kind_x, face_x);
  sj = fill_source(j, L.Hy, L.Ny, L.kind_y, face_y);
  zero = si < 0 || sj < 0;
  return true;
}

// Halo fill of u (face_x) or v (face_y) from `in` into another array `out`.
__global__ void __launch_bounds__(BX * BY) fill_halos(
    const float* __restrict__ in, float* __restrict__ out, Layout L,
    int face_x, int face_y) {
  int k, si, sj;
  bool zero;
  if (!locate_source(L, face_x, face_y, k, si, sj, zero)) return;
  out[k] = zero ? 0.0f : in[si * L.nyp + sj];
}

// semi-implicit u update at (f,c) followed by the (f,c) halo fill
// (pallas_evp_padded.py:308-323)
__global__ void __launch_bounds__(BX * BY) padded_u_update(
    const float* __restrict__ prm, Consts c, Layout L, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s12,
    const float* __restrict__ al, float* __restrict__ u_out) {
  int k, si, sj;
  bool zero;
  if (!locate_source(L, true, false, k, si, sj, zero)) return;
  if (zero) {
    u_out[k] = 0.0f;
    return;
  }
  const int ny = L.nyp;
  const int ks = si * ny + sj;                        // (i, j)
  const int kw = wrap(si - 1, L.nxp) * ny + sj;       // (i-1, j)
  const int jn = wrap(sj + 1, ny);
  const int kn = si * ny + jn;                        // (i, j+1)
  const int kwn = wrap(si - 1, L.nxp) * ny + jn;      // (i-1, j+1)

  u_out[k] = u_update_point(
      prm, s11[ks] * c.msk_cc[ks], s11[kw] * c.msk_cc[kw], s12[ks] * c.msk_ff[ks],
      s12[kn] * c.msk_ff[kn], v[ks], v[kn], v[kw], v[kwn], c.ve[ks], c.ve[kn], c.ve[kw],
      c.ve[kwn], u[ks], has_drag ? u[kn] : 0.0f, c.ue[ks], c.tau_u[ks], c.drag_u[ks],
      c.invm_u[ks], c.un[ks], c.act_u[ks], has_drag, has_drag ? c.imms_u[ks] : 0.0f,
      has_drag ? c.immn_u[ks] : 0.0f, al[ks], al[kw]);
}

// semi-implicit v update at (c,f) followed by the (c,f) halo fill
// (pallas_evp_padded.py:325-340)
__global__ void __launch_bounds__(BX * BY) padded_v_update(
    const float* __restrict__ prm, Consts c, Layout L, int has_drag,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s22, const float* __restrict__ s12,
    const float* __restrict__ al, float* __restrict__ v_out) {
  int k, si, sj;
  bool zero;
  if (!locate_source(L, false, true, k, si, sj, zero)) return;
  if (zero) {
    v_out[k] = 0.0f;
    return;
  }
  const int ny = L.nyp;
  const int ks = si * ny + sj;                        // (i, j)
  const int js = wrap(sj - 1, ny);
  const int kso = si * ny + js;                       // (i, j-1)
  const int ie = wrap(si + 1, L.nxp);
  const int ke = ie * ny + sj;                        // (i+1, j)
  const int kes = ie * ny + js;                       // (i+1, j-1)

  v_out[k] = v_update_point(
      prm, s22[ks] * c.msk_cc[ks], s22[kso] * c.msk_cc[kso], s12[ks] * c.msk_ff[ks],
      s12[ke] * c.msk_ff[ke], u[ks], u[kso], u[ke], u[kes], c.ue[ks], c.ue[kso], c.ue[ke],
      c.ue[kes], v[ks], has_drag ? v[ke] : 0.0f, c.ve[ks], c.tau_v[ks], c.drag_v[ks],
      c.invm_v[ks], c.vn[ks], c.act_v[ks], has_drag, has_drag ? c.immw_v[ks] : 0.0f,
      has_drag ? c.imme_v[ks] : 0.0f, al[ks], al[kso]);
}

}  // namespace

// Runs `nsub` substeps on the current contents of u, v, s11, s22, s12, al
// (each nxp×nyp, row-major, y contiguous) on `stream`, each direction
// filled as its kind_x / kind_y (KIND_*) says; u_tmp and v_tmp are
// scratch arrays of the same shape.  The results are left in u, v, s11,
// s22, s12, al.  The drag arrays may be null when has_drag is 0.  Returns 0,
// or the first nonzero cudaGetLastError() after a launch.
extern "C" int csi_evp_padded_substeps(
    const float* params,
    const float* P, const float* Pff, const float* gcc, const float* gff,
    const float* drag_u, const float* invm_u, const float* act_u,
    const float* un,
    const float* drag_v, const float* invm_v, const float* act_v,
    const float* vn,
    const float* msk_cc, const float* msk_ff,
    const float* imms_u, const float* immn_u, const float* immw_v,
    const float* imme_v,
    const float* tau_u, const float* tau_v, const float* ue, const float* ve,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    float* u_tmp, float* v_tmp,
    int nxp, int nyp, int Hx, int Nx, int Hy, int Ny, int kind_x, int kind_y,
    int has_drag, int nsub, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{nxp, nyp, Hx, Nx, Hy, Ny, kind_x, kind_y};
  const Consts c{drag_u, invm_u, act_u, un, drag_v, invm_v, act_v, vn,
                 msk_cc, msk_ff, imms_u, immn_u, immw_v, imme_v,
                 tau_u, tau_v, ue, ve};
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  cudaError_t err;

  float* u_cur = u_tmp;
  float* u_oth = u;
  float* v_cur = v_tmp;
  float* v_oth = v;
  fill_halos<<<grid, block, 0, s>>>(u, u_cur, L, 1, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fill_halos<<<grid, block, 0, s>>>(v, v_cur, L, 0, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  for (int k = 1; k <= nsub; ++k) {
    evp_stress<<<grid, block, 0, s>>>(params, P, Pff, gcc, gff, u_cur, v_cur,
                                      s11, s22, s12, al, nxp, nyp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      if ((k % 2 == 0) == (half == 0)) {
        padded_u_update<<<grid, block, 0, s>>>(params, c, L, has_drag, u_cur,
                                               v_cur, s11, s12, al, u_oth);
        float* t = u_cur;
        u_cur = u_oth;
        u_oth = t;
      } else {
        padded_v_update<<<grid, block, 0, s>>>(params, c, L, has_drag, u_cur,
                                               v_cur, s22, s12, al, v_oth);
        float* t = v_cur;
        v_cur = v_oth;
        v_oth = t;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  const size_t bytes = sizeof(float) * static_cast<size_t>(nxp) * nyp;
  if (u_cur != u &&
      (err = cudaMemcpyAsync(u, u_cur, bytes, cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return err;
  if (v_cur != v &&
      (err = cudaMemcpyAsync(v, v_cur, bytes, cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return err;
  return 0;
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
