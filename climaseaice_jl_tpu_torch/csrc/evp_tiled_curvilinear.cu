// The decomposition-invariant curvilinear αEVP substep loop for NVIDIA Hopper
// (sm_90a): kernel 2.7 of the fixed-tile mode, with its coefficients derived
// in the call and the fold halo left to evolve between refills.
//
// Replaces `climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py::
// _tiled_curv_kernel` under its pinned plan (`_fixed_plan`), and under the
// port's unpinned plan on a shard: the tripolar basin's substep loop in
// chunks of K substeps, on arrays whose y halo the caller widened to 2K+5
// rows.  It computes that kernel's function, not its blocks:
//   * one prep launch derives, at every padded point, the loop-invariant
//     block the TPU kernel derives per chunk from the raw planes (`:744-834`):
//     the metric forms, P, Pff, the masses, γ's coefficients gcc/gff, 1/m,
//     the drags, the activity masks with the peripheral masks made from the
//     solid plane, the σ masks, the immersed-drag weights with the walls
//     written in coordinates, and f at the velocity points.  h and ℵ do not
//     change in the loop, so these are the values every chunk derives.  It
//     also forms what the updates used to form at every use, in 2.7's
//     order: the transverse averages of the ocean velocity (ve at (f,c), ue
//     at (c,f)) and τ·drag for u and v; and it keeps act_u, act_v, msk_cc,
//     msk_ff and whether the point is dead as bits of one byte;
//   * one launch flags the settled blocks (below);
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
//     of K substeps one launch refills u, v, σ₁₁, σ₂₂ and σ₁₂, on every
//     block, with the local fills and the fold (`refill`, `:1199-1212`);
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
// Settled blocks, as in evp_curvilinear.cu (2.6).  A point is dead where
// gcc ≤ 0, gff ≤ 0, act_u = act_v = 0 and 1/m ≤ 0 at (f,c) and (c,f): its σ
// relaxes by +0 (fixed from the first substep), α = α⁺, and an update
// computed there gives u = (u·1/Δτ)/(1/Δτ)·0, +0 from the second substep
// on, given finite velocities nearby.  The flag launch marks a block of the
// launch grid settled where, for each of its points, every point within
// one of it (by this kernel's wrap or clamp indexing), within one of the
// source its u and its v update are computed at (the wall fills' clamp
// sources), and, where the fold is refilled, within one of its σ's refill
// source is dead; and where the fold is refilled, where the block holds no
// point of the fold rows: the refill writes there the negated mirror of a
// source, and a dead source's +0 would become −0 where the skipped updates
// no longer turn it back.  Everywhere else the refill, which runs on every
// block, copies into a settled block the values it already holds.  Then
// every value the block writes is fixed after substep 2, and by the end of
// substep 3 both buffers of u and of v hold it: from substep FIRST_SKIPPED
// = 4 on a settled block returns at once in the σ launch and in both
// updates.  `fused_evp_tiled_curvilinear.tiled_settled_blocks_reference` is
// the flags' plain version.
//
// What bounds it on an H100: the whole-array kernel's function (its file
// counts 185 float32 operations per point and substep with drag and 16 per
// point and call; this kernel's prep adds the coefficient block) against 21
// planes read and 6 written: at the basin's 1162×1018 widened points and 24
// substeps about 5.3 GFLOP (0.078 ms at 67 TFLOP/s) against 127 MB
// (0.038 ms at 3.35 TB/s): bound by operations.
//
// Design: one thread per padded point, threadIdx.x along y; u and v
// ping-pong between the caller's arrays and scratch, and so do σ across a
// refill.  A neighbour one point away from an interior image wraps by a
// compare, not a remainder.  Built with -fmad=false: each operation rounds
// on its own, as in the plain version, and the mirror arithmetic is exact.

#include "evp_curvilinear_point.cuh"

namespace {

using namespace csi_curv;

constexpr int FIRST_SKIPPED = 4;   // the first substep a settled block skips

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
  D_P, D_PFF, D_GCC, D_GFF, D_DRAGU, D_INVMU, D_DRAGV, D_INVMV,
  D_IMMSU, D_IMMNU, D_IMMWV, D_IMMEV, D_FFC, D_FCF,
  D_VE_FC, D_UE_CF, D_TAUD_U, D_TAUD_V, N_DERIVED
};

struct Planes {
  const float* p[N_PLANES];
};

struct Geo {
  Layout L;                      // L.per_x, L.per_y: 1 where the direction wraps
  int bnd_x, bnd_y;              // 1 where the direction is bounded
  int gw, ge, gs, gn;            // 1 where the shard touches that global edge
  int immersed, has_drag, f_plane;
  int refill;                    // 1 where the fold halo is refilled between chunks
};

__device__ __forceinline__ bool locate(const Layout& L, int& i, int& j, int& k) {
  j = blockIdx.x * BX + threadIdx.x;
  i = blockIdx.y * BY + threadIdx.y;
  if (i >= L.nxp || j >= L.nyp) return false;
  k = i * L.nyp + j;
  return true;
}

__device__ __forceinline__ bool settled_block(const int* __restrict__ settled, int skip) {
  return skip && settled[blockIdx.y * gridDim.x + blockIdx.x];
}

// padded index i wrapped into the interior where the direction wraps
// (periodic and not split across ranks), i itself otherwise
__device__ __forceinline__ int image_of(int i, int H, int N, int periodic) {
  return periodic ? H + mod(i - H, N) : i;
}

// index i + d (|d| ≤ 1) of an interior image i where the direction wraps,
// clamped at the padded edge otherwise
__device__ __forceinline__ int step(int i, int d, int H, int N, int ext, int periodic) {
  const int r = i + d;
  if (periodic) return r < H ? r + N : (r >= H + N ? r - N : r);
  return min(max(r, 0), ext - 1);
}

// A point's image and its neighbours by this kernel's indexing.
struct Here {
  const Layout* L;
  int i, j;   // the point's interior image (periodic) or itself (bounded)
  __device__ int x(int d) const { return step(i, d, L->Hx, L->Nx, L->nxp, L->per_x); }
  __device__ int y(int d) const { return step(j, d, L->Hy, L->Ny, L->nyp, L->per_y); }
  __device__ int k(int dx, int dy) const { return x(dx) * L->nyp + y(dy); }
};

__device__ __forceinline__ Here image(const Layout& L, int i, int j) {
  return Here{&L, image_of(i, L.Hx, L.Nx, L.per_x), image_of(j, L.Hy, L.Ny, L.per_y)};
}

// Where the u update at padded (i, j) is computed, with the gated wall fill
// of `_make_fillers`: false where it writes zero beyond a bounded x wall
// face; beyond a bounded y edge the first or last interior row (none on the
// folded north edge), each on the shards touching that wall.
__device__ __forceinline__ bool u_update_source(const Geo& G, int i, int j, Here& h) {
  const Layout& L = G.L;
  h = image(L, i, j);
  if (G.bnd_x && ((G.gw && i < L.Hx) || (G.ge && i > L.Hx + L.Nx))) return false;
  if (G.bnd_y) {
    if (G.gs && j < L.Hy) h.j = L.Hy;
    else if (!L.fold && G.gn && j >= L.Hy + L.Ny) h.j = L.Hy + L.Ny - 1;
  }
  return true;
}

// Where the v update is computed: false where it writes zero beyond a
// bounded y wall face; beyond a bounded x edge the first or last interior
// column.
__device__ __forceinline__ bool v_update_source(const Geo& G, int i, int j, Here& h) {
  const Layout& L = G.L;
  h = image(L, i, j);
  if (G.bnd_y && ((G.gs && j < L.Hy) || (!L.fold && G.gn && j > L.Hy + L.Ny))) return false;
  if (G.bnd_x) {
    if (G.gw && i < L.Hx) h.i = L.Hx;
    else if (G.ge && i >= L.Hx + L.Nx) h.i = L.Hx + L.Nx - 1;
  }
  return true;
}

// The loop-invariant block at every padded point, in the plain version's
// operation order (pallas_evp_tiled_curvilinear.py:744-834), and the forms
// and flag bits the updates read.
__global__ void __launch_bounds__(BX * BY) tc_prep(const float* __restrict__ prm,
                                                   Planes P, Geo G,
                                                   float* __restrict__ forms,
                                                   float* __restrict__ der,
                                                   unsigned char* __restrict__ bits) {
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
  const float drag_u = invm_u * a_fc;
  const float drag_v = invm_v * a_cf;

  // peripheral masks from the solid plane (fields.peripheral_masks)
  auto per_fc = [&](int dx, int dy) { return fmaxf(s[h.k(dx, dy)], s[h.k(dx - 1, dy)]); };
  auto per_ff = [&](int dx, int dy) { return fmaxf(per_fc(dx, dy), per_fc(dx, dy - 1)); };
  const float pfc = per_fc(0, 0);
  const float pcf = fmaxf(s[kk], s[ks]);
  const float pff = per_ff(0, 0);
  const float mass_min = prm[P_MASSMIN], conc_min = prm[P_CONCMIN];
  const bool act_u = m_fc >= mass_min && a_fc >= conc_min && pfc < 0.5f;
  const bool act_v = m_cf >= mass_min && a_cf >= conc_min && pcf < 0.5f;
  // the σ masks are 0 or 1: the solid plane holds only 0 and 1
  const bool msk_cc = !G.immersed || 1.0f - s[kk] != 0.0f;
  const bool msk_ff = 1.0f - pff != 0.0f;
  const bool dead = gcc <= 0.0f && gff <= 0.0f && !act_u && !act_v && invm_u <= 0.0f &&
                    invm_v <= 0.0f;

  float* d = der;
  d[D_P * n + k] = Pc;
  d[D_PFF * n + k] = Pff;
  d[D_GCC * n + k] = gcc;
  d[D_GFF * n + k] = gff;
  d[D_DRAGU * n + k] = drag_u;
  d[D_INVMU * n + k] = invm_u;
  d[D_DRAGV * n + k] = drag_v;
  d[D_INVMV * n + k] = invm_v;
  bits[k] = static_cast<unsigned char>((act_u ? B_ACT_U : 0) | (act_v ? B_ACT_V : 0) |
                                       (msk_cc ? B_MSK_CC : 0) | (msk_ff ? B_MSK_FF : 0) |
                                       (dead ? B_DEAD : 0));

  // the updates' transverse averages of the ocean velocity and τ·drag, formed
  // as the update at this point forms them: an update is computed at a
  // point that is its own image, whose neighbours these are
  Consts raw{};
  raw.ue = q[C_UE];
  raw.ve = q[C_VE];
  raw.tau_u = q[C_TAUU];
  raw.tau_v = q[C_TAUV];
  const RawForms R{&raw};
  d[D_VE_FC * n + k] = R.ve_fc(kk, h.k(0, 1), kw, h.k(-1, 1));
  d[D_UE_CF * n + k] = R.ue_cf(kk, ks, h.k(1, 0), h.k(1, -1));
  d[D_TAUD_U * n + k] = R.tau_drag_u(k, drag_u);
  d[D_TAUD_V * n + k] = R.tau_drag_v(k, drag_v);

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

// every point within one of h dead
__device__ __forceinline__ bool dead_around(const unsigned char* __restrict__ bits,
                                            const Here& h) {
  bool d = true;
#pragma unroll
  for (int a = -1; a <= 1; ++a) {
    const int r = h.x(a) * h.L->nyp;
#pragma unroll
    for (int b = -1; b <= 1; ++b) d = d && (bits[r + h.y(b)] & B_DEAD);
  }
  return d;
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

// Each block's settled flag (see the head of this file).
__global__ void __launch_bounds__(BX * BY) tc_settle(const unsigned char* __restrict__ bits,
                                                     Geo G, int* __restrict__ settled) {
  const Layout& L = G.L;
  int i, j, k;
  bool ok = true;
  if (locate(L, i, j, k)) {
    const bool fold_row = L.fold && G.gn && j >= L.Hy + L.Ny;
    Here h;
    ok = !(G.refill && fold_row) && dead_around(bits, image(L, i, j));
    if (ok && u_update_source(G, i, j, h)) ok = dead_around(bits, h);
    if (ok && v_update_source(G, i, j, h)) ok = dead_around(bits, h);
    if (ok && G.refill) {   // σ₁₁ and σ₂₂'s refill source
      const int si = local_source(i, L.Hx, L.Nx, L.per_x, G.bnd_x, G.gw, G.ge, false);
      const int sj = local_source(j, L.Hy, L.Ny, L.per_y, G.bnd_y, G.gs, G.gn, false);
      ok = dead_around(bits, image(L, si, sj));
    }
  }
  const int all = __syncthreads_and(ok);
  if (threadIdx.x == 0 && threadIdx.y == 0) settled[blockIdx.y * gridDim.x + blockIdx.x] = all;
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
    float* __restrict__ s12, float* __restrict__ al, const int* __restrict__ settled,
    int skip) {
  int i, j, k;
  if (settled_block(settled, skip) || !locate(L, i, j, k)) return;
  const Here h = image(L, i, j);
  const int ny = L.nyp;
  const int R[3] = {h.x(-1) * ny, h.x(0) * ny, h.x(1) * ny};
  const int C[3] = {h.y(-1), h.y(0), h.y(1)};
  stress_at(prm, m, c, u, v, R, C, k, s11, s22, s12, al);
}

// u update at (i, j), computed at its source (u_update_source)
__global__ void __launch_bounds__(BX * BY) tc_u_update(
    const float* __restrict__ prm, Metrics m, Consts c, CallForms F, Geo G,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ u_out, const int* __restrict__ settled, int skip) {
  int i, j, k;
  if (settled_block(settled, skip) || !locate(G.L, i, j, k)) return;
  Here h;
  u_out[k] = u_update_source(G, i, j, h)
                 ? u_at(prm, m, c, F, G.has_drag, u, v, s11, s22, s12, al, h.k(0, 0),
                        h.k(-1, 0), h.k(0, 1), h.k(-1, 1))
                 : 0.0f;
}

// v update at (i, j), computed at its source (v_update_source)
__global__ void __launch_bounds__(BX * BY) tc_v_update(
    const float* __restrict__ prm, Metrics m, Consts c, CallForms F, Geo G,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ al,
    float* __restrict__ v_out, const int* __restrict__ settled, int skip) {
  int i, j, k;
  if (settled_block(settled, skip) || !locate(G.L, i, j, k)) return;
  Here h;
  v_out[k] = v_update_source(G, i, j, h)
                 ? v_at(prm, m, c, F, G.has_drag, u, v, s11, s22, s12, al, h.k(0, 0),
                        h.k(0, -1), h.k(1, 0), h.k(1, -1))
                 : 0.0f;
}

}  // namespace

// Runs `nsub` substeps on u, v, s11, s22, s12, al (each nxp×nyp, y
// contiguous) on `stream`, refilling the halos before every `chunk`
// substeps where `refill` (a folded grid whose x is not split across
// ranks).  `wrap_*`: the direction wraps; `bnd_*`: it is bounded; `g*`: the
// shard touches the west, east, south, north global edge (all 1 on a serial
// grid).  `planes`: a host array of the N_PLANES raw plane pointers (C_FCOR
// null for a scalar f; the solid plane holding only 0 and 1); `scratch`: 5
// arrays of the shape; `work`: N_FORMS + N_DERIVED arrays of the shape;
// `bits`: nxp·nyp bytes; `settled`: one int per block of the launch grid
// (ceil(nyp / 32) · ceil(nxp / 8), row-major by block row along x), into
// which the flags are written.  The results are left in the caller's
// arrays; the number of kernel launches is stored in *launches.  Returns 0,
// the first nonzero cudaGetLastError() after a launch, or -1 for arguments
// it cannot take.
extern "C" int csi_evp_tiled_curvilinear_substeps(
    const float* params, const float* const* planes, float* u, float* v, float* s11,
    float* s22, float* s12, float* al, float* scratch, float* work, unsigned char* bits,
    int* settled, int nxp, int nyp, int Hx, int Nx, int Hy, int Ny, int wrap_x, int wrap_y,
    int bnd_x, int bnd_y, int fold, int gw, int ge, int gs, int gn, int refill, int immersed,
    int has_drag, int nsub, int chunk, int* launches, void* stream) {
  if (chunk < 1 || nsub < 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Planes P;
  for (int q = 0; q < N_PLANES; ++q) P.p[q] = planes[q];
  const Layout L{nxp, nyp, Hx, Nx, Hy, Ny, wrap_x, wrap_y, fold};
  const Geo G{L, bnd_x, bnd_y, gw, ge, gs, gn, immersed, has_drag, P.p[C_FCOR] != nullptr,
              refill};
  const long long n = static_cast<long long>(nxp) * nyp;
  float* forms = work;
  float* der = work + N_FORMS * n;
  const dim3 block(BX, BY);
  const dim3 grid((nyp + BX - 1) / BX, (nxp + BY - 1) / BY);
  cudaError_t err;
  *launches = 0;

  tc_prep<<<grid, block, 0, st>>>(params, P, G, forms, der, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tc_settle<<<grid, block, 0, st>>>(bits, G, settled);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  *launches += 2;

  const Metrics m{P.p[C_DYFC], P.p[C_DXCF], P.p[C_IAZCC], P.p[C_IAZFC], P.p[C_IAZCF],
                  P.p[C_IAZFF],
                  forms + F_DY_CC2 * n, forms + F_DX_CC2 * n,
                  forms + F_DX_FF2 * n, forms + F_DY_FF2 * n,
                  forms + F_INV_DY_FC * n, forms + F_INV_DX_CF * n,
                  forms + F_INV_DX_FC * n, forms + F_INV_DY_CF * n};
  auto dp = [&](int d) { return der + d * n; };
  // the 0/1 masks and the ocean velocity's forms are read through F
  const Consts c{dp(D_P), dp(D_PFF), dp(D_GCC), dp(D_GFF),
                 dp(D_DRAGU), dp(D_INVMU), nullptr, P.p[C_UN],
                 dp(D_DRAGV), dp(D_INVMV), nullptr, P.p[C_VN],
                 nullptr, nullptr,
                 dp(D_IMMSU), dp(D_IMMNU), dp(D_IMMWV), dp(D_IMMEV),
                 P.p[C_TAUU], P.p[C_TAUV], P.p[C_UE], P.p[C_VE],
                 G.f_plane ? dp(D_FFC) : nullptr, G.f_plane ? dp(D_FCF) : nullptr};
  const CallForms F{bits, dp(D_VE_FC), dp(D_UE_CF), dp(D_TAUD_U), dp(D_TAUD_V)};

  float* mine[5] = {u, v, s11, s22, s12};
  float* cur[5];
  float* oth[5];
  for (int q = 0; q < 5; ++q) {
    cur[q] = mine[q];
    oth[q] = scratch + q * n;
  }
  for (int s = 1; s <= nsub; ++s) {
    const int skip = s >= FIRST_SKIPPED;
    if (refill && (s - 1) % chunk == 0) {
      Five R;
      for (int q = 0; q < 5; ++q) {
        R.in[q] = cur[q];
        R.out[q] = oth[q];
      }
      tc_refill<<<grid, block, 0, st>>>(R, G);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++*launches;
      for (int q = 0; q < 5; ++q) {
        float* t = cur[q];
        cur[q] = oth[q];
        oth[q] = t;
      }
    }
    tc_stress<<<grid, block, 0, st>>>(params, m, c, L, cur[0], cur[1], cur[2], cur[3],
                                      cur[4], al, settled, skip);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
    for (int half = 0; half < 2; ++half) {
      // odd substeps: v then u; even substeps: u then v
      const int q = ((s % 2 == 0) == (half == 0)) ? 0 : 1;
      if (q == 0) {
        tc_u_update<<<grid, block, 0, st>>>(params, m, c, F, G, cur[0], cur[1], cur[2],
                                            cur[3], cur[4], al, oth[0], settled, skip);
      } else {
        tc_v_update<<<grid, block, 0, st>>>(params, m, c, F, G, cur[0], cur[1], cur[2],
                                            cur[3], cur[4], al, oth[1], settled, skip);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++*launches;
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
