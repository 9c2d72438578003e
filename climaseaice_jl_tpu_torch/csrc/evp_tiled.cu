// Tiled, substep-chunked αEVP loop for NVIDIA Hopper (sm_90a): doubly
// periodic grids above the whole-array kernel's limit.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_tiled.py::_tiled_kernel`
// (2.2): the αEVP substeps of evp.cu on interior-only, doubly periodic,
// uniform-metric float32 arrays, with the loop's coefficients derived from
// m = h·ℵ·ρ, ℵ and P in the TPU kernel's own forms
// (pallas_evp_tiled.py:253-282; the γ² coefficient is cα·Δt·(1/Δx·1/Δy)/m).
//
// Design.  The coefficients depend only on m, ℵ and P, which do not change
// during a call, so one launch (`tiled_prep`, one thread per point) derives
// them into device scratch: the same bits as deriving them per tile and
// chunk as the TPU kernel does.  Then one launch per chunk of K substeps
// (`tiled_chunk`): each block loads a tile of the six carried fields (u, v,
// σ₁₁, σ₂₂, σ₁₂, α) with an overlap of W = 2·KMAX + 3 points on each side
// into shared memory, runs evp_common.cuh's `stress_point`,
// `u_update_point` and `v_update_point` K times there and writes the
// tile's interior back.  A value at the tile's edge, whose neighbours
// outside the tile are not known, spoils at most 2 points further inward
// per substep, so the interior the block writes is exact.  The tile is
// indexed by interior coordinates with periodic wrap (the only index rule:
// no walls, fold, drag or mask), so a tile larger than the grid, or a ragged
// last tile, holds the periodic images and writes each point once.  The
// carried fields go from the input arrays to the scratch arrays and back
// on alternate chunks, since neighbouring tiles read what a chunk
// overwrites.  Odd substeps update v then u, even ones u then v; the
// substep number comes from the chunk's base, as in
// pallas_evp_tiled.py:368-385, 490-526, and the last chunk may be shorter
// than K: a point's value does not depend on K.
//
// In shared memory the updates are in place, as in evp.cu: in the stress
// phase a thread writes σ and α at its own point and reads σ only there;
// in the u phase it writes u at its own point and reads u only there (no
// immersed drag), in the v phase likewise v.  So one buffer a field will
// do: 6 × 96 × 96 floats, 221,184 bytes, one block of 512 threads per SM.
// The TPU kernel's (TX, TY, Wy) plan served Mosaic's (8, 128) tiling and is
// not this file's.
//
// What bounds it on an H100: per point and substep the function needs
// evp.cu's 142 float32 operations (chip_smoke.py's FLOPS_PER_POINT_SUBSTEP)
// and per call 24 for the coefficients; a call reads 11 arrays (m, ℵ, P,
// uⁿ, vⁿ and the carried six) and writes 6, once.  At 2048² and 120
// substeps that is 71.6 GFLOP (1.07 ms at 67 TFLOP/s) against 285 MB
// (0.085 ms at 3.35 TB/s): bound by operations.  The kernel does more:
// a 96 × 96 tile writes 74 × 74 points (1.68× the points), a thread
// recomputes its neighbours' strain rates (183 operations), and every
// substep reads the twelve constants of its tile from device memory (L2).
// Making it fast is later work.
//
// Arithmetic: built with -fmad=false (`_build.py`) in the plain version's
// operation order, so the kernel equals
// `fused_evp_tiled.tiled_evp_substeps_reference` bitwise, whatever the
// tile, the chunk or the launch.

#include "evp_common.cuh"

namespace {

using namespace csi_evp;

constexpr int KMAX = 4;             // the most substeps a launch runs
constexpr int W = 2 * KMAX + 3;     // overlap on each side of a tile
constexpr int TX = 96;              // tile rows (x)
constexpr int TY = 96;              // tile columns (y, the contiguous axis)
constexpr int OX = TX - 2 * W;      // interior rows a tile writes
constexpr int OY = TY - 2 * W;      // interior columns a tile writes
constexpr int NT = TX * TY;
constexpr int TBX = 32;             // threads along y
constexpr int TBY = 16;             // threads along x
constexpr int NTHREADS = TBX * TBY;
constexpr size_t SMEM_BYTES = 6 * NT * sizeof(float);

// The twelve constants of the loop, in evp.cu's roles: P and the starting
// velocities as given, the other nine derived by `tiled_prep`.
struct Consts {
  const float *P, *Pff, *gcc, *gff;
  const float *drag_u, *invm_u, *act_u, *un;
  const float *drag_v, *invm_v, *act_v, *vn;
};

struct Coeffs {
  float *Pff, *gcc, *gff, *drag_u, *invm_u, *act_u, *drag_v, *invm_v, *act_v;
};

struct Fields {
  float *u, *v, *s11, *s22, *s12, *al;
};

// 2.2's coefficients at one point (pallas_evp_tiled.py:253-282), in the
// plain version's order; neighbours by periodic wrap.
__global__ void __launch_bounds__(BX * BY) tiled_prep(
    const float* __restrict__ prm, const float* __restrict__ m,
    const float* __restrict__ a, const float* __restrict__ P, Coeffs c, int nx, int ny) {
  Point p;
  if (!locate(nx, ny, p)) return;
  const float inv_dx = 1.0f / prm[P_DX];
  const float inv_dy = 1.0f / prm[P_DY];
  const float inv_az = inv_dx * inv_dy;
  const float num = prm[P_CALPHA] * prm[P_DT] * inv_az;
  const float mass_min = prm[P_MASSMIN];
  const float conc_min = prm[P_CONCMIN];
  const int kw = p.row_m + p.j, ks = p.row_0 + p.jm, kws = p.row_m + p.jm;

  const float m_fc = 0.5f * (m[p.k] + m[kw]);
  const float a_fc = 0.5f * (a[p.k] + a[kw]);
  const float m_cf = 0.5f * (m[p.k] + m[ks]);
  const float a_cf = 0.5f * (a[p.k] + a[ks]);
  const float invm_u = m_fc > 0.0f ? 1.0f / m_fc : 0.0f;
  const float invm_v = m_cf > 0.0f ? 1.0f / m_cf : 0.0f;
  // cc → ff: 0.25·((q[i,j] + q[i,j-1]) + (q[i-1,j] + q[i-1,j-1]))
  const float m_ff = 0.25f * ((m[p.k] + m[ks]) + (m[kw] + m[kws]));
  c.Pff[p.k] = 0.25f * ((P[p.k] + P[ks]) + (P[kw] + P[kws]));
  c.gcc[p.k] = m[p.k] > 0.0f ? num / m[p.k] : -1.0f;
  c.gff[p.k] = m_ff > 0.0f ? num / m_ff : -1.0f;
  c.drag_u[p.k] = invm_u * a_fc;
  c.invm_u[p.k] = invm_u;
  c.act_u[p.k] = (m_fc >= mass_min && a_fc >= conc_min) ? 1.0f : 0.0f;
  c.drag_v[p.k] = invm_v * a_cf;
  c.invm_v[p.k] = invm_v;
  c.act_v[p.k] = (m_cf >= mass_min && a_cf >= conc_min) ? 1.0f : 0.0f;
}

// Substeps k0 + 1 … k0 + nk on one tile.
__global__ void __launch_bounds__(NTHREADS) tiled_chunk(
    const float* __restrict__ prm, Consts c, int nx, int ny, Fields in, Fields out,
    int k0, int nk) {
  extern __shared__ float sm[];
  __shared__ int crow[TX], ccol[TY];   // wrapped rows (times ny) and columns
  float* u = sm;
  float* v = sm + NT;
  float* s11 = sm + 2 * NT;
  float* s22 = sm + 3 * NT;
  float* s12 = sm + 4 * NT;
  float* al = sm + 5 * NT;
  const int gx0 = blockIdx.y * OX - W;   // interior coordinates of tile point (0, 0)
  const int gy0 = blockIdx.x * OY - W;
  const int tid = threadIdx.y * TBX + threadIdx.x;
  const float ue = prm[P_UE], ve = prm[P_VE];
  const float tau_u = prm[P_TAUU], tau_v = prm[P_TAUV];

  for (int l = tid; l < TX; l += NTHREADS) crow[l] = wrapi(gx0 + l, nx) * ny;
  for (int l = tid; l < TY; l += NTHREADS) ccol[l] = wrapi(gy0 + l, ny);
  __syncthreads();
  for (int l = tid; l < NT; l += NTHREADS) {
    const int k = crow[l / TY] + ccol[l % TY];
    u[l] = in.u[k];
    v[l] = in.v[k];
    s11[l] = in.s11[k];
    s22[l] = in.s22[k];
    s12[l] = in.s12[k];
    al[l] = in.al[k];
  }
  __syncthreads();

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
      const int k = crow[li] + ccol[lj];
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
          const int li = l / TY, lj = l % TY;
          const int iw = li > 0 ? li - 1 : 0;
          const int jn = lj < TY - 1 ? lj + 1 : TY - 1;
          const int lw = iw * TY + lj, ln = li * TY + jn, lwn = iw * TY + jn;
          const int k = crow[li] + ccol[lj];
          u[l] = u_update_point(prm, s11[l], s11[lw], s12[l], s12[ln], v[l], v[ln], v[lw],
                                v[lwn], ve, ve, ve, ve, u[l], 0.0f, ue, tau_u, c.drag_u[k],
                                c.invm_u[k], c.un[k], c.act_u[k], false, 0.0f, 0.0f, al[l],
                                al[lw]);
        }
      } else {
        for (int l = tid; l < NT; l += NTHREADS) {
          const int li = l / TY, lj = l % TY;
          const int js = lj > 0 ? lj - 1 : 0;
          const int ie = li < TX - 1 ? li + 1 : TX - 1;
          const int ls = li * TY + js, le = ie * TY + lj, les = ie * TY + js;
          const int k = crow[li] + ccol[lj];
          v[l] = v_update_point(prm, s22[l], s22[ls], s12[l], s12[le], u[l], u[ls], u[le],
                                u[les], ue, ue, ue, ue, v[l], 0.0f, ve, tau_v, c.drag_v[k],
                                c.invm_v[k], c.vn[k], c.act_v[k], false, 0.0f, 0.0f, al[l],
                                al[ls]);
        }
      }
      __syncthreads();
    }
  }

  // the tile's interior points inside the domain go back to device memory
  for (int l = tid; l < NT; l += NTHREADS) {
    const int li = l / TY, lj = l % TY;
    const int gx = gx0 + li, gy = gy0 + lj;
    if (li < W || li >= W + OX || lj < W || lj >= W + OY || gx >= nx || gy >= ny) continue;
    const int k = gx * ny + gy;
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

// Runs `nsub` substeps on u, v, s11, s22, s12, al (each nx×ny, row-major,
// y contiguous) from m, a, P, un, vn of the same shape, on `stream`: one
// launch derives the coefficients into the nine scratch arrays `c_*`, then
// one launch per chunk of KMAX substeps ping-pongs the fields with the six
// scratch arrays `t_*`.  The results are left in u … al.  Returns 0, or the
// first nonzero CUDA error.
extern "C" int csi_evp_tiled_substeps(
    const float* params, const float* m, const float* a, const float* P,
    const float* un, const float* vn,
    float* c_Pff, float* c_gcc, float* c_gff, float* c_drag_u, float* c_invm_u,
    float* c_act_u, float* c_drag_v, float* c_invm_v, float* c_act_v,
    float* u, float* v, float* s11, float* s22, float* s12, float* al,
    float* t_u, float* t_v, float* t_s11, float* t_s22, float* t_s12, float* t_al,
    int nx, int ny, int nsub, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      tiled_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const Coeffs co{c_Pff, c_gcc, c_gff, c_drag_u, c_invm_u, c_act_u, c_drag_v, c_invm_v,
                  c_act_v};
  tiled_prep<<<dim3((ny + BX - 1) / BX, (nx + BY - 1) / BY), dim3(BX, BY), 0, s>>>(
      params, m, a, P, co, nx, ny);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const Consts c{P, c_Pff, c_gcc, c_gff, c_drag_u, c_invm_u, c_act_u, un,
                 c_drag_v, c_invm_v, c_act_v, vn};
  Fields f{u, v, s11, s22, s12, al};
  Fields g{t_u, t_v, t_s11, t_s22, t_s12, t_al};
  const dim3 block(TBX, TBY);
  const dim3 grid((ny + OY - 1) / OY, (nx + OX - 1) / OX);
  for (int k0 = 0; k0 < nsub; k0 += KMAX) {
    const int nk = nsub - k0 < KMAX ? nsub - k0 : KMAX;
    tiled_chunk<<<grid, block, SMEM_BYTES, s>>>(params, c, nx, ny, f, g, k0, nk);
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
