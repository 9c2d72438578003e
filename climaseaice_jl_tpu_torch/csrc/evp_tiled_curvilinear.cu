// The decomposition-invariant curvilinear αEVP substep loop for NVIDIA Hopper
// (sm_90a): kernel 2.7 of the fixed-tile mode, with its coefficients derived
// in the call and the fold halo left to evolve between refills.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py::
// _tiled_curv_kernel` under its pinned plan (`_fixed_plan`): the tripolar
// basin's substep loop in chunks of K substeps, on arrays whose y halo the
// caller widened to 2K+5 rows.  It computes that kernel's function, not its
// blocks:
//   * one prep launch derives, at every padded point, the loop-invariant
//     block the TPU kernel derives per chunk from the raw planes (`:744-834`):
//     the metric forms, P, Pff, the masses, γ's coefficients gcc/gff, 1/m,
//     the drags, the activity masks with the peripheral masks made from the
//     solid plane, the σ masks, the immersed-drag weights with the walls
//     written in coordinates, and f at the velocity points.  h and ℵ do not
//     change in the loop, so these are the values every chunk derives;
//   * three launches per substep, σ then the two half-updates in the
//     substep's order (`:943-966`), shared with the whole-array kernel
//     (evp_curvilinear_point.cuh).  A periodic direction is indexed by wrap
//     into the interior (a halo point computes its interior image), a
//     bounded one by clamp at the padded edge, as the TPU kernel's tile
//     gathers index them; the walls are filled in the update as
//     `_make_fillers` fills them (u copies the first or last interior row or
//     column, v is zero beyond a wall face; the folded north edge has none);
//   * the Zipper fold halo is never refilled inside a chunk.  Every
//     coefficient is fold-symmetric and the arithmetic is exactly
//     mirror-antisymmetric, so the fold halo carries the mirror images it
//     started with (the TPU module's docstring, `:21-42`), while its
//     outermost rows, which read clamped neighbours, lose two rows of
//     validity a substep: the 2K+5 rows cover K substeps.  Before each chunk
//     of K substeps one launch refills u, v, σ₁₁, σ₂₂ and σ₁₂ with the
//     local fills and the fold (`refill`, `:1199-1212`).
//   * on one rank's shard of the distributed step (the caller's halos are
//     2·substeps+3 wide along the directions split across ranks) a split
//     direction is indexed by clamp, not wrap (`:1116-1117`); the wall fills
//     and the immersed drag's walls apply only on the shards touching that
//     global edge, four gates for west, east, south and north (`_G_W…_G_N`,
//     `:1133-1142`); a fold split across x is never refilled: its halo
//     evolves through every substep inside the wide y halo, and the caller
//     exchanges u and v once after the loop (`:1199-1211`, `:1254-1259`).
//     On a serial grid every gate is 1.
//
// What bounds it on an H100: the whole-array kernel's function (its file
// counts 185 float32 operations per point and substep with drag and 16 per
// point and call; this kernel's prep adds the coefficient block) against 21
// planes read and 6 written: at the basin's 1162×1018 widened points and 24
// substeps about 5.3 GFLOP (0.078 ms at 67 TFLOP/s) against 127 MB
// (0.038 ms at 3.35 TB/s): bound by operations.
//
// Design (simple and right first): one thread per padded point, threadIdx.x
// along y; u and v ping-pong between the caller's arrays and scratch, and so
// do σ across a refill.  Built with -fmad=false: each operation rounds on
// its own, as in the plain version, and the mirror arithmetic is exact.

#include "evp_curvilinear_point.cuh"

namespace {

using namespace csi_curv;

// extended params after the 18 of evp_common.cuh's layout (its last one padding)
enum ParamX { PX_RHO = 18, PX_PSTAR, PX_CHARD, PX_CDRAG };

// the raw planes (pallas_evp_tiled_curvilinear.py:652-656)
enum Plane {
  C_DXCC, C_DXFC, C_DXCF, C_DXFF, C_DYCC, C_DYFC, C_DYCF, C_DYFF,
  C_IAZCC, C_IAZFC, C_IAZCF, C_IAZFF,
  C_H, C_A, C_SOLID, C_UN, C_VN, C_TAUU, C_TAUV, C_UE, C_VE, C_FCOR, N_PLANES
};

// the derived planes, after the N_FORMS metric forms
enum Derived {
  D_P, D_PFF, D_GCC, D_GFF, D_DRAGU, D_INVMU, D_ACTU, D_DRAGV, D_INVMV, D_ACTV,
  D_MSKCC, D_MSKFF, D_IMMSU, D_IMMNU, D_IMMWV, D_IMMEV, D_FFC, D_FCF, N_DERIVED
};

struct Planes {
  const float* p[N_PLANES];
};

struct Geo {
  Layout L;                      // L.per_x, L.per_y: 1 where the direction wraps
  int bnd_x, bnd_y;              // 1 where the direction is bounded
  int gw, ge, gs, gn;            // 1 where the shard touches that global edge
  int immersed, has_drag, f_plane;
};

__device__ __forceinline__ bool locate(const Layout& L, int& i, int& j, int& k) {
  j = blockIdx.x * BX + threadIdx.x;
  i = blockIdx.y * BY + threadIdx.y;
  if (i >= L.nxp || j >= L.nyp) return false;
  k = i * L.nyp + j;
  return true;
}

// padded index i + d along a direction: wrapped into the interior where it
// wraps (periodic and not split across ranks), clamped at the padded edge
// otherwise
__device__ __forceinline__ int at(int i, int d, int H, int N, int ext, int periodic) {
  return periodic ? H + mod(i + d - H, N) : min(max(i + d, 0), ext - 1);
}

struct Here {
  const Layout& L;
  int i, j;   // the point's interior image (periodic) or itself (bounded)
  __device__ int x(int d) const { return at(i, d, L.Hx, L.Nx, L.nxp, L.per_x); }
  __device__ int y(int d) const { return at(j, d, L.Hy, L.Ny, L.nyp, L.per_y); }
  __device__ int k(int dx, int dy) const { return x(dx) * L.nyp + y(dy); }
};

__device__ __forceinline__ Here image(const Layout& L, int i, int j) {
  return Here{L, at(i, 0, L.Hx, L.Nx, L.nxp, L.per_x), at(j, 0, L.Hy, L.Ny, L.nyp, L.per_y)};
}

// The loop-invariant block at every padded point, in the plain version's
// operation order (pallas_evp_tiled_curvilinear.py:744-834).
__global__ void __launch_bounds__(BX * BY) tc_prep(const float* __restrict__ prm,
                                                   Planes P, Geo G,
                                                   float* __restrict__ forms,
                                                   float* __restrict__ der) {
  const Layout& L = G.L;
  int i, j, k;
  if (!locate(L, i, j, k)) return;
  const Here h = image(L, i, j);
  const long long n = static_cast<long long>(L.nxp) * L.nyp;
  const int kk = h.k(0, 0);
  const float* const* q = P.p;

  forms[F_DY_CC2 * n + k] = q[C_DYCC][kk] * q[C_DYCC][kk];
  forms[F_DX_CC2 * n + k] = q[C_DXCC][kk] * q[C_DXCC][kk];
  forms[F_DX_FF2 * n + k] = q[C_DXFF][kk] * q[C_DXFF][kk];
  forms[F_DY_FF2 * n + k] = q[C_DYFF][kk] * q[C_DYFF][kk];
  forms[F_INV_DY_FC * n + k] = 1.0f / q[C_DYFC][kk];
  forms[F_INV_DX_CF * n + k] = 1.0f / q[C_DXCF][kk];
  forms[F_INV_DX_FC * n + k] = 1.0f / q[C_DXFC][kk];
  forms[F_INV_DY_CF * n + k] = 1.0f / q[C_DYCF][kk];

  const float rho = prm[PX_RHO], Pstar = prm[PX_PSTAR], Chard = prm[PX_CHARD];
  const float* hh = q[C_H];
  const float* aa = q[C_A];
  const float* s = q[C_SOLID];
  auto mass = [&](int p) { return hh[p] * aa[p] * rho; };
  auto strength = [&](int p) { return Pstar * hh[p] * expf(-Chard * (1.0f - aa[p])); };
  const int kw = h.k(-1, 0), ks = h.k(0, -1), kws = h.k(-1, -1);

  const float m_cc = mass(kk);
  const float Pc = strength(kk);
  // ℑxy to (f,f): t = q + q(j−1); 0.25·(t + t(i−1))
  const float Pff = 0.25f * ((Pc + strength(ks)) + (strength(kw) + strength(kws)));
  const float m_ff = 0.25f * ((m_cc + mass(ks)) + (mass(kw) + mass(kws)));
  const float m_fc = 0.5f * (m_cc + mass(kw));
  const float a_fc = 0.5f * (aa[kk] + aa[kw]);
  const float m_cf = 0.5f * (m_cc + mass(ks));
  const float a_cf = 0.5f * (aa[kk] + aa[ks]);
  const float cadt = prm[P_CALPHA] * prm[P_DT];
  const float gcc = m_cc > 0.0f ? cadt * q[C_IAZCC][kk] / m_cc : -1.0f;
  const float gff = m_ff > 0.0f ? cadt * q[C_IAZFF][kk] / m_ff : -1.0f;
  const float invm_u = m_fc > 0.0f ? 1.0f / m_fc : 0.0f;
  const float invm_v = m_cf > 0.0f ? 1.0f / m_cf : 0.0f;

  // peripheral masks from the solid plane (fields.peripheral_masks)
  auto per_fc = [&](int dx, int dy) { return fmaxf(s[h.k(dx, dy)], s[h.k(dx - 1, dy)]); };
  auto per_ff = [&](int dx, int dy) { return fmaxf(per_fc(dx, dy), per_fc(dx, dy - 1)); };
  const float pfc = per_fc(0, 0);
  const float pcf = fmaxf(s[kk], s[ks]);
  const float pff = per_ff(0, 0);
  const float mass_min = prm[P_MASSMIN], conc_min = prm[P_CONCMIN];

  float* d = der;
  d[D_P * n + k] = Pc;
  d[D_PFF * n + k] = Pff;
  d[D_GCC * n + k] = gcc;
  d[D_GFF * n + k] = gff;
  d[D_DRAGU * n + k] = invm_u * a_fc;
  d[D_INVMU * n + k] = invm_u;
  d[D_ACTU * n + k] = (m_fc >= mass_min && a_fc >= conc_min && pfc < 0.5f) ? 1.0f : 0.0f;
  d[D_DRAGV * n + k] = invm_v * a_cf;
  d[D_INVMV * n + k] = invm_v;
  d[D_ACTV * n + k] = (m_cf >= mass_min && a_cf >= conc_min && pcf < 0.5f) ? 1.0f : 0.0f;
  d[D_MSKCC * n + k] = G.immersed ? 1.0f - s[kk] : 1.0f;
  d[D_MSKFF * n + k] = 1.0f - pff;

  if (G.has_drag) {
    // immersed-only (f,f) nodes: peripheral and not on a wall, the walls
    // written in interior coordinates (fields.immersed_only_ff)
    const float Cd = prm[PX_CDRAG];
    auto imm = [&](int dx, int dy) {
      const int gx = h.x(dx) - L.Hx, gy = h.y(dy) - L.Hy;
      bool wall = false;
      if (G.bnd_x) wall = wall || (G.gw && gx <= 0) || (G.ge && gx >= L.Nx);
      if (G.bnd_y) wall = wall || (G.gs && gy <= 0) || (!L.fold && G.gn && gy >= L.Ny);
      return per_ff(dx, dy) > 0.5f && !wall;
    };
    auto wx = [&](int dx, int dy) {
      const int p = h.k(dx, dy);
      return (imm(dx, dy) ? Cd * q[C_DXFF][p] : 0.0f) * q[C_IAZFC][p];
    };
    auto wy = [&](int dx, int dy) {
      const int p = h.k(dx, dy);
      return (imm(dx, dy) ? Cd * q[C_DYFF][p] : 0.0f) * q[C_IAZCF][p];
    };
    d[D_IMMSU * n + k] = wx(0, 0);
    d[D_IMMNU * n + k] = wx(0, 1);
    d[D_IMMWV * n + k] = wy(0, 0);
    d[D_IMMEV * n + k] = wy(1, 0);
  }
  if (G.f_plane) {
    const float* f = q[C_FCOR];
    d[D_FFC * n + k] = 0.5f * (f[kk] + f[kw]);
    d[D_FCF * n + k] = 0.5f * (f[kk] + f[ks]);
  }
}

// Source index of padded index i along one direction of the local fill
// (fields.fill_halos_*_local), or -1 where it writes zero: wrap where the
// direction wraps; where it is bounded, the wall fills on the shards that
// touch the wall (g_lo, g_hi); a periodic direction split across ranks
// keeps its halo.
__device__ __forceinline__ int local_source(int i, int H, int N, int wrap, int bnd,
                                            int g_lo, int g_hi, bool face) {
  if (H == 0) return i;
  if (wrap) return i < H ? i + N : (i >= H + N ? i - N : i);
  if (!bnd) return i;
  if (face) return ((g_lo && i < H) || (g_hi && i > H + N)) ? -1 : i;
  if (g_lo && i < H) return H;
  if (g_hi && i >= H + N) return H + N - 1;
  return i;
}

// The local fill of `in` at padded (i, j) for a field at (xface, yface):
// the x fill, the y fill, then on the northernmost shard of a folded grid
// the Zipper fold with sign `sign` (−1 for u and v, +1 for σ), the y-face
// seam row projected onto its symmetry.  Used only where x is not split.
__device__ __forceinline__ float local_fill_value(const Geo& G, const float* in, int i, int j,
                                                  bool xface, bool yface, float sign) {
  const Layout& L = G.L;
  const int ny = L.nyp;
  const int seam = L.Hy + L.Ny;
  const int si = local_source(i, L.Hx, L.Nx, L.per_x, G.bnd_x, G.gw, G.ge, xface);
  if (L.fold && G.gn && j >= seam) {
    const int m = fold_column(L, i, xface);
    if (!yface) return sign * in[m * ny + 2 * seam - 1 - j];
    if (j > seam) return sign * in[m * ny + 2 * seam - j];
    return 0.5f * (in[si * ny + seam] + sign * in[m * ny + seam]);
  }
  const int sj = local_source(j, L.Hy, L.Ny, L.per_y, G.bnd_y, G.gs, G.gn, yface);
  return (si < 0 || sj < 0) ? 0.0f : in[si * ny + sj];
}

// The local refills of u, v, σ₁₁, σ₂₂ and σ₁₂ between chunks, each from
// `in` into `out`.
struct Five {
  const float* in[5];
  float* out[5];
};

__global__ void __launch_bounds__(BX * BY) tc_refill(Five F, Geo G) {
  int i, j, k;
  if (!locate(G.L, i, j, k)) return;
  F.out[0][k] = local_fill_value(G, F.in[0], i, j, true, false, -1.0f);    // u (f,c)
  F.out[1][k] = local_fill_value(G, F.in[1], i, j, false, true, -1.0f);    // v (c,f)
  F.out[2][k] = local_fill_value(G, F.in[2], i, j, false, false, 1.0f);    // σ₁₁
  F.out[3][k] = local_fill_value(G, F.in[3], i, j, false, false, 1.0f);    // σ₂₂
  F.out[4][k] = local_fill_value(G, F.in[4], i, j, true, true, 1.0f);      // σ₁₂ (f,f)
}

__global__ void __launch_bounds__(BX * BY) tc_stress(
    const float* __restrict__ prm, Metrics m, Consts c, Layout L,
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ s11, float* __restrict__ s22,
    float* __restrict__ s12, float* __restrict__ al) {
  int i, j, k;
  if (!locate(L, i, j, k)) return;
  const Here h = image(L, i, j);
  const int ny = L.nyp;
  const int R[3] = {h.x(-1) * ny, h.x(0) * ny, h.x(1) * ny};
  const int C[3] = {h.y(-1), h.y(0), h.y(1)};
  stress_at(prm, m, c, u, v, R, C, k, s11, s22, s12, al);
}

// u update at (i, j), with the gated wall fill of `_make_fillers`: zero
// beyond a bounded x wall face, the first or last interior row copied
// beyond a bounded y edge (none on the folded north edge), each on the
// shards touching that wall
__global__ void __launch_bounds__(BX * BY) tc_u_update(
    const float* __restrict__ prm, Metrics m, Consts c, Geo G,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ u_out) {
  const Layout& L = G.L;
  int i, j, k;
  if (!locate(L, i, j, k)) return;
  Here h = image(L, i, j);
  if (G.bnd_x && ((G.gw && i < L.Hx) || (G.ge && i > L.Hx + L.Nx))) {
    u_out[k] = 0.0f;
    return;
  }
  if (G.bnd_y) {
    if (G.gs && j < L.Hy) h.j = L.Hy;
    else if (!L.fold && G.gn && j >= L.Hy + L.Ny) h.j = L.Hy + L.Ny - 1;
  }
  u_out[k] = u_at(prm, m, c, G.has_drag, u, v, s11, s22, s12, al, h.k(0, 0), h.k(-1, 0),
                  h.k(0, 1), h.k(-1, 1));
}

// v update at (i, j), with the gated wall fill: the first or last interior
// column copied beyond a bounded x edge, zero beyond a bounded y wall face
__global__ void __launch_bounds__(BX * BY) tc_v_update(
    const float* __restrict__ prm, Metrics m, Consts c, Geo G,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ v_out) {
  const Layout& L = G.L;
  int i, j, k;
  if (!locate(L, i, j, k)) return;
  Here h = image(L, i, j);
  if (G.bnd_y && ((G.gs && j < L.Hy) || (!L.fold && G.gn && j > L.Hy + L.Ny))) {
    v_out[k] = 0.0f;
    return;
  }
  if (G.bnd_x) {
    if (G.gw && i < L.Hx) h.i = L.Hx;
    else if (G.ge && i >= L.Hx + L.Nx) h.i = L.Hx + L.Nx - 1;
  }
  v_out[k] = v_at(prm, m, c, G.has_drag, u, v, s11, s22, s12, al, h.k(0, 0), h.k(0, -1),
                  h.k(1, 0), h.k(1, -1));
}

}  // namespace

// Runs `nsub` substeps on u, v, s11, s22, s12, al (each nxp×nyp, y
// contiguous) on `stream`, refilling the halos before every `chunk`
// substeps where `refill` (a folded grid whose x is not split across
// ranks).  `wrap_*`: the direction wraps; `bnd_*`: it is bounded; `g*`: the
// shard touches the west, east, south, north global edge (all 1 on a serial
// grid).  `planes`: a host array of the N_PLANES raw plane pointers (C_FCOR
// null for a scalar f); `scratch`: 5 arrays of the shape; `work`: N_FORMS +
// N_DERIVED arrays of the shape.  The results are left in the caller's
// arrays.  Returns 0, the first nonzero cudaGetLastError() after a launch,
// or -1 for arguments it cannot take.
extern "C" int csi_evp_tiled_curvilinear_substeps(
    const float* params, const float* const* planes, float* u, float* v, float* s11,
    float* s22, float* s12, float* al, float* scratch, float* work, int nxp, int nyp,
    int Hx, int Nx, int Hy, int Ny, int wrap_x, int wrap_y, int bnd_x, int bnd_y, int fold,
    int gw, int ge, int gs, int gn, int refill, int immersed, int has_drag, int nsub,
    int chunk, void* stream) {
  if (chunk < 1 || nsub < 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Planes P;
  for (int q = 0; q < N_PLANES; ++q) P.p[q] = planes[q];
  const Layout L{nxp, nyp, Hx, Nx, Hy, Ny, wrap_x, wrap_y, fold};
  const Geo G{L, bnd_x, bnd_y, gw, ge, gs, gn, immersed, has_drag, P.p[C_FCOR] != nullptr};
  const long long n = static_cast<long long>(nxp) * nyp;
  float* forms = work;
  float* der = work + N_FORMS * n;
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  cudaError_t err;

  tc_prep<<<grid, block, 0, st>>>(params, P, G, forms, der);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const Metrics m{P.p[C_DYFC], P.p[C_DXCF], P.p[C_IAZCC], P.p[C_IAZFC], P.p[C_IAZCF],
                  P.p[C_IAZFF],
                  forms + F_DY_CC2 * n, forms + F_DX_CC2 * n,
                  forms + F_DX_FF2 * n, forms + F_DY_FF2 * n,
                  forms + F_INV_DY_FC * n, forms + F_INV_DX_CF * n,
                  forms + F_INV_DX_FC * n, forms + F_INV_DY_CF * n};
  auto dp = [&](int d) { return der + d * n; };
  const Consts c{dp(D_P), dp(D_PFF), dp(D_GCC), dp(D_GFF),
                 dp(D_DRAGU), dp(D_INVMU), dp(D_ACTU), P.p[C_UN],
                 dp(D_DRAGV), dp(D_INVMV), dp(D_ACTV), P.p[C_VN],
                 dp(D_MSKCC), dp(D_MSKFF),
                 dp(D_IMMSU), dp(D_IMMNU), dp(D_IMMWV), dp(D_IMMEV),
                 P.p[C_TAUU], P.p[C_TAUV], P.p[C_UE], P.p[C_VE],
                 G.f_plane ? dp(D_FFC) : nullptr, G.f_plane ? dp(D_FCF) : nullptr};

  float* mine[5] = {u, v, s11, s22, s12};
  float* cur[5];
  float* oth[5];
  for (int q = 0; q < 5; ++q) {
    cur[q] = mine[q];
    oth[q] = scratch + q * n;
  }
  for (int s = 1; s <= nsub; ++s) {
    if (refill && (s - 1) % chunk == 0) {
      Five F;
      for (int q = 0; q < 5; ++q) {
        F.in[q] = cur[q];
        F.out[q] = oth[q];
      }
      tc_refill<<<grid, block, 0, st>>>(F, G);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      for (int q = 0; q < 5; ++q) {
        float* t = cur[q];
        cur[q] = oth[q];
        oth[q] = t;
      }
    }
    tc_stress<<<grid, block, 0, st>>>(params, m, c, L, cur[0], cur[1], cur[2], cur[3],
                                      cur[4], al);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      const int q = ((s % 2 == 0) == (half == 0)) ? 0 : 1;
      if (q == 0) {
        tc_u_update<<<grid, block, 0, st>>>(params, m, c, G, cur[0], cur[1], cur[2], cur[3],
                                            cur[4], al, oth[0]);
      } else {
        tc_v_update<<<grid, block, 0, st>>>(params, m, c, G, cur[0], cur[1], cur[2], cur[3],
                                            cur[4], al, oth[1]);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      float* t = cur[q];
      cur[q] = oth[q];
      oth[q] = t;
    }
  }
  const size_t bytes = sizeof(float) * static_cast<size_t>(n);
  for (int q = 0; q < 5; ++q) {
    if (cur[q] != mine[q] &&
        (err = cudaMemcpyAsync(mine[q], cur[q], bytes, cudaMemcpyDeviceToDevice, st)) !=
            cudaSuccess)
      return err;
  }
  return 0;
}

extern "C" const char* csi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
