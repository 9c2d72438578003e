"""Curvilinear fused split-explicit αEVP substep loop: the gate, the
launcher, the CUDA kernel's wrapper and its plain version.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_evp_curvilinear.py` and
of the serial part of `pallas_evp_tiled_curvilinear.py`.  The kernel
(``csrc/evp_curvilinear.cu``) replaces the TPU kernel ``_curvilinear_kernel``
and, on one card, computes the function of ``_tiled_curv_kernel`` too: the
whole substep loop on halo-inclusive (nxp, nyp) float32 arrays with the
8 staggered metric arrays and 4 inverse areas of a latitude-longitude,
curvilinear or tripolar grid (or a rectilinear one with a north fold), the
full SBP strain-rate and stress-divergence forms, land masks, the immersed
drag, array stresses, and f as a scalar (``FPlane``) or as (f,c)/(c,f)
planes of f(φ) (``LatitudeCoriolis``).  After every half-update u (v) gets
its halos refilled, the Zipper fold included: u and v change sign across
the fold, and the v seam row becomes 0.5·(v − v_mirror).  σ is never
fold-filled inside the loop; its fold-halo rows are computed from the
fold-filled velocities, as on the TPU.

On the TPU the whole-array kernel (2.6) is limited by VMEM and by f being a
scalar, so the tripolar basin takes the chunked kernel (2.7), whose tiles,
chunk plan and self-evolving fold halo exist for VMEM and for meshes.  The
CUDA kernel keeps its state in device memory and has neither limit.  2.7
has its own kernel (:mod:`.fused_evp_tiled_curvilinear`, sharing this
kernel's per-point code): the pinned plan under ``fixed_tiles``, serial and
on the shards of the distributed step, and the unpinned plan on the shards
of the 'wide' halo policy without ``fixed_tiles``
(`fused_evp_tiled_curvilinear._unpinned_plan`, route "tiled_curvilinear" of
``model.meshed_momentum_route``).

:func:`curvilinear_evp_substeps` picks by the tensors' device: CUDA tensors
go to the kernel, CPU tensors to :func:`curvilinear_evp_substeps_reference`.
A CUDA tensor never reaches the plain version; a kernel that fails to build
or launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..grids import PERIODIC, BOUNDED
from ..ops import ixf, iyf, shift_m
from ..fields import fill_halos_cc, fill_halos_fc, fill_halos_cf, fill_halos_ff, _maybe_fold
from .coriolis import FPlane, LatitudeCoriolis, coriolis_f_cc
from .momentum import SplitExplicitSolver, ImmersedDrag
from .rheologies import ElastoViscoPlasticRheology
from .stresses import SemiImplicitStress, StressFunction, _value
from .fused_evp import (KernelCounter, _scalar, _P_DT, _P_F, _P_RC, _P_EINV2, _P_AMIN,
                        _P_AMAX, _P_DMIN, _P_REPL, check_kernel_args, cuda_error_string,
                        evp_coefficients, evp_params)

N_METRICS = 12      # Δx, Δy at cc, fc, cf, ff; 1/Az at cc, fc, cf, ff
N_CONSTS = 14       # as fused_evp_padded: P, Pff, gcc, gff, drag_u, invm_u, act_u,
                    # un, drag_v, invm_v, act_v, vn, msk_cc, msk_ff
N_DRAG = 4
N_STRESS = 4
N_CARRY = 6
N_FORMS = 12        # the loop-invariant forms the kernel's prep launch makes: 8 metric
                    # forms, the two ocean velocity averages, τ·drag for u and v
LAUNCHES_PER_SUBSTEP = 3
LAUNCHES_PER_CALL = 3   # the forms and settled flags, the initial u and v halo fills
BLOCK = (8, 32)     # the kernel's blocks: rows along x, columns along y
FIRST_SKIPPED = 4   # the first substep a settled block skips (csrc/evp_curvilinear.cu)

curvilinear_evp_counter = KernelCounter()


# --- the solid-row count ------------------------------------------------------

def _first_ocean_rows(solid, grid):
    """Per interior column, the index of its first non-solid row (Ny where
    the column is solid throughout), from the padded boolean mask
    ``solid`` (numpy)."""
    inter = solid[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny]
    return np.where(inter.all(axis=1), grid.Ny, np.argmin(inter, axis=1)).astype(np.int64)


def _solid_crop_rows(solid, grid):
    """Count of southernmost interior rows that are solid across every x
    (0 for an all-solid domain).  On such a row every velocity point is
    peripheral and every σ point has no mass, so the EVP loop leaves u = v =
    0, σ as it was and α = α⁺ there, and the tracer divergence is zero; the
    tripolar basin has 468 such rows of 960."""
    cs = int(_first_ocean_rows(solid, grid).min())
    return 0 if cs >= grid.Ny else cs


# --- the gate -----------------------------------------------------------------

def curvilinear_fused_available(model):
    """True when the model matches the curvilinear fused EVP configuration:
    a grid with array metrics or a north fold, periodic or bounded sides
    (a fold on bounded y), float32, any land mask, scalar, array or
    StressFunction stresses, an FPlane, a LatitudeCoriolis on a grid with
    latitudes, or no Coriolis, no free drift, no user forcing, no immersed
    drag or an ImmersedDrag.

    The physics conditions of the JAX gates of kernels 2.6 and 2.7
    (`pallas_evp_curvilinear.py:52-114`, `pallas_evp_tiled_curvilinear.py:310-394`)
    without their TPU-only ones: the VMEM budgets, the tile and chunk plans
    and the 50 M-point HBM cap kept the state on chip or in tiles.  A
    shard's model never asks this gate (:func:`..model.meshed_momentum_route`
    dispatches it, as the JAX gate's mesh condition sends it elsewhere).
    The CUDA kernel keeps its state in device memory and indexes any
    nxp×nyp, so it has no size limit."""
    grid = model.grid
    dyn = model.dynamics
    if dyn is None or not isinstance(dyn.rheology, ElastoViscoPlasticRheology):
        return False
    if not isinstance(dyn.solver, SplitExplicitSolver):
        return False
    if grid.kind == "rectilinear" and not grid.north_fold:
        # this kernel computes the padded route's function too, but takes
        # 1.7× its time on the same 522² bounded + island + drag input
        # (4.63 against 2.72 ms per call on an H100 SXM at 700 W, timed in
        # turns by chip_smoke.py phase 6)
        return False
    if dyn.solver.fixed_tiles is not None:
        return False   # the pinned route (`pallas_evp_curvilinear.py:69`)
    if any(t not in (PERIODIC, BOUNDED) for t in grid.topology):
        return False
    if grid.north_fold and grid.topology[1] != BOUNDED:
        return False
    if grid.Hx == 0 or grid.Hy == 0:
        return False
    if grid.dtype != torch.float32:
        return False
    if dyn.immersed_drag is not None and not isinstance(dyn.immersed_drag, ImmersedDrag):
        return False

    def ok_value(x):
        return (isinstance(x, StressFunction) or _scalar(x)
                or tuple(getattr(x, "shape", ())) == grid.shape)

    top = dyn.top_momentum_stress
    if isinstance(top, dict):
        if not (ok_value(top.get("u")) and ok_value(top.get("v"))):
            return False
    elif not ok_value(top):
        return False
    bottom = dyn.bottom_momentum_stress
    if bottom is not None and not isinstance(bottom, SemiImplicitStress):
        return False
    if isinstance(bottom, SemiImplicitStress):
        if not (ok_value(bottom.ue) and ok_value(bottom.ve)):
            return False
    cor = dyn.coriolis
    if not (cor is None or isinstance(cor, FPlane)
            or (isinstance(cor, LatitudeCoriolis) and grid.lat_cc is not None)):
        return False
    if dyn.free_drift is not None:
        return False
    if model.forcing:
        return False
    return True


# --- the plain version ----------------------------------------------------------

def metric_forms(metrics):
    """The loop-invariant metric forms of the substep loop
    (`pallas_evp_curvilinear.py:237-250`): Δy²cc, Δx²cc, Δx²ff, Δy²ff,
    1/Δy_fc, 1/Δx_cf, 1/Δx_fc, 1/Δy_cf.  The kernel's prep launch computes
    the same, squares as products and IEEE reciprocals."""
    dx_cc, dx_fc, dx_cf, dx_ff, dy_cc, dy_fc, dy_cf, dy_ff = metrics[:8]
    return (dy_cc * dy_cc, dx_cc * dx_cc, dx_ff * dx_ff, dy_ff * dy_ff,
            1.0 / dy_fc, 1.0 / dx_cf, 1.0 / dx_fc, 1.0 / dy_cf)


def curvilinear_evp_substeps_reference(params, consts, carry, nsub, grid, f_planes=None):
    """Plain PyTorch version of the kernel: ``nsub`` substeps on padded
    arrays with circular shifts over the padded extent, in the TPU kernel's
    operation order (`pallas_evp_curvilinear.py:235-455`).  The u/v halo
    fills are the serial fills of :mod:`..fields`, whose Zipper fold gathers
    by index what the TPU kernel gathers by a permutation matmul
    (`_make_fillers_folded`).  ``f_planes``: (f at (f,c), f at (c,f)), or
    None for the scalar f of ``params``.  Returns the new (u, v, σ₁₁, σ₂₂,
    σ₁₂, α)."""
    p = params
    dt = p[_P_DT]
    rC = p[_P_RC]
    e_inv2 = p[_P_EINV2]
    a_min = p[_P_AMIN]
    a_max = p[_P_AMAX]
    d_min = p[_P_DMIN]
    repl_on = bool(p[_P_REPL] != 0)
    f_fc, f_cf = f_planes if f_planes is not None else (p[_P_F], p[_P_F])

    consts = tuple(consts)
    has_drag = len(consts) == N_METRICS + N_CONSTS + N_DRAG + N_STRESS
    metrics = consts[:N_METRICS]
    dx_cf, dy_fc = metrics[2], metrics[5]
    inv_az_cc, inv_az_fc, inv_az_cf, inv_az_ff = metrics[8:12]
    (dy_cc2, dx_cc2, dx_ff2, dy_ff2,
     inv_dy_fc, inv_dx_cf, inv_dx_fc, inv_dy_cf) = metric_forms(metrics)
    (P, Pff, gcc, gff, drag_u, invm_u, act_u, un,
     drag_v, invm_v, act_v, vn, msk_cc, msk_ff) = consts[N_METRICS:N_METRICS + N_CONSTS]
    if has_drag:
        imms_u, immn_u, immw_v, imme_v = consts[N_METRICS + N_CONSTS:-N_STRESS]
    tau_u_top, tau_v_top, ue, ve = consts[-N_STRESS:]

    def sp(q, axis):   # q[I-1]
        return torch.roll(q, 1, axis)

    def sm(q, axis):   # q[I+1]
        return torch.roll(q, -1, axis)

    def ixf_(q):
        return 0.5 * (q + sp(q, 0))

    def iyf_(q):
        return 0.5 * (q + sp(q, 1))

    def ixyf_(q):
        t = q + sp(q, 1)
        return 0.25 * (t + sp(t, 0))

    def ixyc_(q):
        t = q + sm(q, 1)
        return 0.25 * (t + sm(t, 0))

    def ixf_yc_(q):
        t = q + sm(q, 1)
        return 0.25 * (t + sp(t, 0))

    def ixc_yf_(q):
        t = q + sp(q, 1)
        return 0.25 * (t + sm(t, 0))

    inv_dt = 1.0 / dt
    inv_dmin = 1.0 / d_min
    amin2 = a_min * a_min
    amax2 = a_max * a_max
    Ph = 0.5 * P
    Pffh = 0.5 * Pff
    ve_fc = ixf_yc_(ve)
    ue_cf = ixc_yf_(ue)
    ok_cc = gcc > 0
    ok_ff = gff > 0

    def stresses(u, v, s11, s22, s12):
        u_dy = u * dy_fc
        v_dx = v * dx_cf
        eD = ((sm(u_dy, 0) - u_dy) + (sm(v_dx, 1) - v_dx)) * inv_az_cc
        u_ody = u * inv_dy_fc
        v_odx = v * inv_dx_cf
        eT = (dy_cc2 * (sm(u_ody, 0) - u_ody)
              - dx_cc2 * (sm(v_odx, 1) - v_odx)) * inv_az_cc
        u_odx = u * inv_dx_fc
        v_ody = v * inv_dy_cf
        eS = (dx_ff2 * (u_odx - sp(u_odx, 1))
              + dy_ff2 * (v_ody - sp(v_ody, 0))) * inv_az_ff
        d_ff = ixyf_(eD)
        t_ff = ixyf_(eT)
        eSc = ixyc_(eS)
        dd_cc = eD * eD + (eT * eT + eSc * eSc) * e_inv2
        dd_ff = d_ff * d_ff + (t_ff * t_ff + eS * eS) * e_inv2
        rD_cc = torch.minimum(torch.rsqrt(dd_cc), inv_dmin)
        rD_ff = torch.minimum(torch.rsqrt(dd_ff), inv_dmin)
        zcc = Ph * rD_cc
        zff = Pffh * rD_ff
        if repl_on:
            Dcc = torch.maximum(dd_cc * rD_cc, d_min)
            Prh = Ph * Dcc / (Dcc + d_min)
        else:
            Prh = Ph
        eta_cc = zcc * e_inv2
        eta_ff = zff * e_inv2
        iso = (zcc - eta_cc) * eD - Prh
        s11_t = eta_cc * (eD + eT) + iso
        s22_t = eta_cc * (eD - eT) + iso
        s12_t = eta_ff * eS
        g2cc = torch.clamp(zcc * gcc, amin2, amax2)
        g2ff = torch.clamp(zff * gff, amin2, amax2)
        rg_cc = torch.rsqrt(g2cc)
        rg_ff = torch.rsqrt(g2ff)
        gamma_cc = torch.where(ok_cc, g2cc * rg_cc, a_max)
        s11 = s11 + torch.where(ok_cc, (s11_t - s11) * rg_cc, 0.0)
        s22 = s22 + torch.where(ok_cc, (s22_t - s22) * rg_cc, 0.0)
        s12 = s12 + torch.where(ok_ff, (s12_t - s12) * rg_ff, 0.0)
        return s11, s22, s12, gamma_cc

    def divergences(s11, s22, s12):
        s11m = s11 * msk_cc
        s22m = s22 * msk_cc
        s12m = s12 * msk_ff
        sD = s11m + s22m
        sT = s11m - s22m
        yT = dy_cc2 * sT
        xS = dx_ff2 * s12m
        div_x = (dy_fc * (sD - sp(sD, 0)) * 0.5
                 + (yT - sp(yT, 0)) * inv_dy_fc * 0.5
                 + (sm(xS, 1) - xS) * inv_dx_fc) * inv_az_fc
        xT = dx_cc2 * sT
        yS = dy_ff2 * s12m
        div_y = (dx_cf * (sD - sp(sD, 1)) * 0.5
                 - (xT - sp(xT, 1)) * inv_dx_cf * 0.5
                 + (sm(yS, 0) - yS) * inv_dy_cf) * inv_az_cf
        return div_x, div_y

    def u_update(u, v, div_x, alpha):
        v_fc = ixf_yc_(v)
        du = ue - u
        dv = ve_fc - v_fc
        speed = torch.sqrt(du * du + dv * dv)
        Gu = (f_fc * v_fc - tau_u_top * drag_u + rC * speed * ue * drag_u
              + div_x * invm_u)
        if has_drag:
            Gu = Gu - (imms_u * u + immn_u * sm(u, 1)) * invm_u
        Gu = Gu + (un - u) * inv_dt
        Gu = torch.where(invm_u > 0, Gu, 0.0)
        idtau = ixf_(alpha) * inv_dt
        u_new = (u * idtau + Gu) / (idtau + rC * speed * drag_u) * act_u
        return fill_halos_fc(u_new, grid)

    def v_update(u, v, div_y, alpha):
        u_cf = ixc_yf_(u)
        dv = ve - v
        du = ue_cf - u_cf
        speed = torch.sqrt(du * du + dv * dv)
        Gv = (-f_cf * u_cf - tau_v_top * drag_v + rC * speed * ve * drag_v
              + div_y * invm_v)
        if has_drag:
            Gv = Gv - (immw_v * v + imme_v * sm(v, 0)) * invm_v
        Gv = Gv + (vn - v) * inv_dt
        Gv = torch.where(invm_v > 0, Gv, 0.0)
        idtau = iyf_(alpha) * inv_dt
        v_new = (v * idtau + Gv) / (idtau + rC * speed * drag_v) * act_v
        return fill_halos_cf(v_new, grid)

    u, v, s11, s22, s12, alpha = carry
    u, v = fill_halos_fc(u, grid), fill_halos_cf(v, grid)
    for substep in range(1, nsub + 1):
        s11, s22, s12, alpha = stresses(u, v, s11, s22, s12)
        div_x, div_y = divergences(s11, s22, s12)
        if substep % 2 == 0:
            u = u_update(u, v, div_x, alpha)
            v = v_update(u, v, div_y, alpha)
        else:
            v = v_update(u, v, div_y, alpha)
            u = u_update(u, v, div_x, alpha)
    return u, v, s11, s22, s12, alpha


# --- the settled blocks ---------------------------------------------------------

def _fill_source(i, H, N, periodic, face):
    """The padded index that the halo fill copies padded index ``i`` from
    along one direction, −1 where it writes zero (the kernel's
    ``fill_source``)."""
    if H == 0:
        return i
    if periodic:
        return np.where(i < H, i + N, np.where(i >= H + N, i - N, i))
    if face:
        return np.where((i < H) | (i > H + N), -1, i)
    return np.clip(i, H, H + N - 1)


def fill_sources(grid):
    """Where the kernel's update threads compute, as numpy index arrays over
    the padded points: for u (f,c) the source (si, sj) of the composed fill
    and whether there is one; for v (c,f) the source, whether there is one,
    and on the seam row the mirror column (``u_source``, ``v_source``)."""
    i, j = np.meshgrid(np.arange(grid.nxp), np.arange(grid.nyp), indexing="ij")
    per_x, per_y = grid.topology[0] == PERIODIC, grid.topology[1] == PERIODIC
    seam = grid.Hy + grid.Ny

    def fold_column(face):
        return (((grid.Nx if face else grid.Nx - 1) - (i - grid.Hx)) % grid.Nx) + grid.Hx

    u_si = _fill_source(i, grid.Hx, grid.Nx, per_x, True)
    u_sj = _fill_source(j, grid.Hy, grid.Ny, per_y, False)
    v_si = _fill_source(i, grid.Hx, grid.Nx, per_x, False)
    v_sj = _fill_source(j, grid.Hy, grid.Ny, per_y, True)
    v_sm = np.zeros_like(i)
    on_seam = np.zeros(i.shape, bool)
    if grid.north_fold:
        top = j >= seam
        u_si = np.where(top, fold_column(True), u_si)
        u_sj = np.where(top, 2 * seam - 1 - j, u_sj)
        on_seam = j == seam
        v_sm = np.where(top, fold_column(False), 0)
        v_si = np.where(top & ~on_seam, v_sm, v_si)
        v_sj = np.where(top, np.where(on_seam, seam, 2 * seam - j), v_sj)
    u_on = (u_si >= 0) & (u_sj >= 0)
    v_on = (v_si >= 0) & (v_sj >= 0)
    return dict(u=(u_si, u_sj, u_on), v=(v_si, v_sj, v_on), seam=(v_sm, on_seam))


def settled_blocks_reference(consts, grid):
    """Plain version of the kernel's flag launch: for each block of the
    launch grid (``BLOCK`` points; ceil(nxp/8) × ceil(nyp/32)), True where
    every point within one (by wrap over the padded extent) of each of its
    points, and of each fill source its update threads compute at (the
    seam's mirror included), is dead: gcc ≤ 0, gff ≤ 0, act_u = act_v = 0,
    1/m ≤ 0 at (f,c) and (c,f).  From substep ``FIRST_SKIPPED`` on the
    kernel does no work in such a block: every value it writes there is
    fixed after substep 2 (see csrc/evp_curvilinear.cu)."""
    core = tuple(consts)[N_METRICS:N_METRICS + N_CONSTS]
    (_, _, gcc, gff, _, invm_u, act_u, _, _, invm_v, act_v, _, _, _) = core
    dead = ((gcc <= 0) & (gff <= 0) & (act_u == 0) & (act_v == 0)
            & (invm_u <= 0) & (invm_v <= 0))
    around = dead.clone()
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            around &= torch.roll(dead, (-a, -b), (0, 1))   # dead at (i + a, j + b)
    src = fill_sources(grid)
    ok = around.clone()
    for si, sj, on in (src["u"], src["v"], (src["seam"][0], src["v"][1], src["seam"][1])):
        on = torch.as_tensor(on, device=ok.device)
        at = around[torch.as_tensor(np.maximum(si, 0), device=ok.device),
                    torch.as_tensor(np.maximum(sj, 0), device=ok.device)]
        ok &= torch.where(on, at, True)
    bx, by = BLOCK
    nbx, nby = -(-grid.nxp // bx), -(-grid.nyp // by)
    padded = torch.ones((nbx * bx, nby * by), dtype=torch.bool, device=ok.device)
    padded[:grid.nxp, :grid.nyp] = ok
    return padded.reshape(nbx, bx, nby, by).all(dim=3).all(dim=1)


def settled_share(consts, grid):
    """The share of the kernel's blocks that are settled (host value)."""
    return float(settled_blocks_reference(consts, grid).float().mean().item())


# --- the kernel's wrapper -------------------------------------------------------

def _curvilinear_entry():
    fn = _build.load("evp_curvilinear").csi_evp_curvilinear_substeps
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (1 + N_METRICS + N_CONSTS + N_DRAG + N_STRESS
                                            + 2 + N_CARRY + 5)
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def curvilinear_evp_substeps(params, consts, carry, nsub, grid, f_planes=None, settled=None):
    """Run ``nsub`` αEVP substeps on padded arrays of ``grid``'s shape.

    ``params``: float32[18] (the layout of :mod:`.fused_evp`); ``consts``:
    the 12 metric arrays, the 14 constant arrays (act_u, act_v, msk_cc and
    msk_ff holding only 0 and 1, as the launcher makes them), then the 4
    immersed-drag coefficient arrays if there is drag, then the 4 stress
    arrays; ``carry``: (u, v, σ₁₁, σ₂₂, σ₁₂, α); ``f_planes``: (f_fc, f_cf)
    or None for the scalar f of ``params``.  CUDA tensors go to the CUDA
    kernel, which updates the carry tensors in place and returns them; CPU
    tensors go to :func:`curvilinear_evp_substeps_reference`.  ``settled``:
    an int32 CUDA tensor of ceil(nxp/8)·ceil(nyp/32) elements into which
    the kernel writes its settled flags (:func:`settled_blocks_reference`
    flattened), or None."""
    consts, carry = tuple(consts), tuple(carry)
    base = N_METRICS + N_CONSTS + N_STRESS
    if len(consts) not in (base, base + N_DRAG) or len(carry) != N_CARRY:
        raise ValueError(f"expected {N_METRICS} metric arrays, {N_CONSTS} constants, "
                         f"optionally {N_DRAG} drag arrays, {N_STRESS} stress arrays "
                         f"and {N_CARRY} carries")
    planes = tuple(f_planes) if f_planes is not None else ()
    if len(planes) not in (0, 2):
        raise ValueError("f_planes must be None or (f_fc, f_cf)")
    device = params.device
    if device.type == "cpu":
        if any(q.device != device for q in consts + carry + planes):
            raise ValueError("EVP tensors span devices")
        return curvilinear_evp_substeps_reference(params, consts, carry, nsub, grid,
                                                  f_planes)
    if device.type != "cuda":
        raise ValueError(f"no EVP kernel for device {device}")
    shape = check_kernel_args(params, consts + carry + planes)
    if shape != grid.shape:
        raise ValueError(f"EVP arrays are {shape}, the grid's fields {grid.shape}")
    has_drag = len(consts) == base + N_DRAG
    core = consts[:N_METRICS + N_CONSTS]
    drag = consts[N_METRICS + N_CONSTS:-N_STRESS] if has_drag else (None,) * N_DRAG
    f_ptrs = [q.data_ptr() for q in planes] if planes else [None, None]
    scratch = (torch.empty_like(carry[0]), torch.empty_like(carry[1]))
    forms = torch.empty((N_FORMS,) + shape, dtype=torch.float32, device=device)
    bits = torch.empty(shape, dtype=torch.uint8, device=device)
    blocks = -(-shape[0] // BLOCK[0]) * -(-shape[1] // BLOCK[1])
    if settled is None:
        settled = torch.empty(blocks, dtype=torch.int32, device=device)
    elif (settled.dtype != torch.int32 or settled.device != device
          or settled.numel() != blocks or not settled.is_contiguous()):
        raise ValueError(f"settled must be a contiguous int32 tensor of {blocks} elements "
                         f"on {device}")
    ptrs = [params.data_ptr()]
    ptrs += [q.data_ptr() for q in core]
    ptrs += [None if q is None else q.data_ptr() for q in drag]
    ptrs += [q.data_ptr() for q in consts[-N_STRESS:]]
    ptrs += f_ptrs
    ptrs += [q.data_ptr() for q in carry + scratch]
    ptrs += [forms.data_ptr(), bits.data_ptr(), settled.data_ptr()]
    fn = _curvilinear_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, grid.nxp, grid.nyp, grid.Hx, grid.Nx, grid.Hy, grid.Ny,
                 int(grid.topology[0] == PERIODIC), int(grid.topology[1] == PERIODIC),
                 int(grid.north_fold), int(has_drag), int(nsub), stream)
    if err != 0:
        raise RuntimeError(f"curvilinear EVP kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('evp_curvilinear', err)})")
    curvilinear_evp_counter.calls += 1
    curvilinear_evp_counter.launches += LAUNCHES_PER_SUBSTEP * int(nsub) + LAUNCHES_PER_CALL
    return carry


# --- the launcher ---------------------------------------------------------------

def curvilinear_evp_inputs(model, state, dt, u_start, v_start):
    """(params, consts, carry, P, f_planes) of the curvilinear substep loop,
    as `pallas_evp_curvilinear.py:458-590` assembles them: every metric
    broadcast to a contiguous (nxp, nyp) float32 array, the areas' inverses,
    the coefficients with array areas in γ, the immersed-drag coefficients,
    and the stress arrays with the Zipper sign flip on their fold halo.  A
    StressFunction is evaluated once, at the step-start clock.  For
    LatitudeCoriolis, f_planes is ℑx and ℑy of f(φ) at cell centres
    (`pallas_evp_tiled_curvilinear.py:824-830,1010-1019`); else None.  The
    carry tensors are fresh copies."""
    from ..model import make_fields

    grid = model.grid
    dyn = model.dynamics
    masks = model.masks
    f32 = grid.scalar
    dt = f32(dt)

    def met(name):
        return f32(getattr(grid, name)).broadcast_to(grid.shape)

    az = {loc: met("az_" + loc) for loc in ("cc", "fc", "cf", "ff")}
    metrics = [met(f"d{d}_{loc}") for d in "xy" for loc in ("cc", "fc", "cf", "ff")]
    metrics += [1.0 / az[loc] for loc in ("cc", "fc", "cf", "ff")]
    (P, Pff, gcc, gff, drag_u, invm_u, act_u,
     drag_v, invm_v, act_v) = evp_coefficients(model, state, dt, az["cc"], az["ff"])
    act_u = act_u * (~masks.per_fc).to(torch.float32)
    act_v = act_v * (~masks.per_cf).to(torch.float32)
    msk_cc = (~masks.solid_cc).to(torch.float32)
    msk_ff = (~masks.per_ff).to(torch.float32)

    drag_consts = []
    if dyn.immersed_drag is not None and masks.imm_ff is not None:
        C = f32(dyn.immersed_drag.coefficient)
        wx = torch.where(masks.imm_ff, C * met("dx_ff"), 0.0) / az["fc"]
        wy = torch.where(masks.imm_ff, C * met("dy_ff"), 0.0) / az["cf"]
        drag_consts = [wx, shift_m(wx, 1), wy, shift_m(wy, 0)]

    fields = make_fields(model, state)

    def array(x):   # a scalar, array or StressFunction as a float32 array
        x = _value(0.0 if x is None else x, grid, state.clock, fields)
        return f32(x).broadcast_to(grid.shape)

    def fold(q, comp):   # the Zipper sign flip of a vector component
        return _maybe_fold(q, grid, comp == "u", comp != "u", -1.0)

    top = dyn.top_momentum_stress
    if isinstance(top, dict):
        tau_u_top, tau_v_top = array(top.get("u")), array(top.get("v"))
    else:
        tau_u_top = tau_v_top = array(top)
    tau_u_top, tau_v_top = fold(tau_u_top, "u"), fold(tau_v_top, "v")
    bottom = dyn.bottom_momentum_stress
    if isinstance(bottom, SemiImplicitStress):
        rC = f32(bottom.rho_e * bottom.Cd)
        ue, ve = fold(array(bottom.ue), "u"), fold(array(bottom.ve), "v")
    else:
        rC = f32(0.0)
        ue = ve = f32(0.0).broadcast_to(grid.shape)

    cor = dyn.coriolis
    f_planes = None
    if isinstance(cor, LatitudeCoriolis):
        f_cc = coriolis_f_cc(cor, grid).to(torch.float32)
        f_planes = (ixf(f_cc).contiguous(), iyf(f_cc).contiguous())
    zero = f32(0.0)
    params = evp_params(model, dt, zero, zero, rC, zero, zero, dx=1.0, dy=1.0,
                        f=cor.f if isinstance(cor, FPlane) else 0.0)

    consts = tuple(q.contiguous() for q in (
        metrics + [P, Pff, gcc, gff, drag_u, invm_u, act_u, u_start,
                   drag_v, invm_v, act_v, v_start, msk_cc, msk_ff]
        + drag_consts + [tau_u_top, tau_v_top, ue, ve]))
    carry = tuple(q.clone(memory_format=torch.contiguous_format)
                  for q in (u_start, v_start, state.sig11, state.sig22,
                            state.sig12, state.alpha))
    return params, consts, carry, P, f_planes


def curvilinear_fused_momentum_step(model, state, dt, u_start, v_start):
    """Run the whole substep loop through :func:`curvilinear_evp_substeps`;
    returns the same update dict as the general
    `split_explicit_momentum_step`.  σ halos are refilled afterwards (fold
    included) and α keeps the loop's halos, as in
    `pallas_evp_curvilinear.py:624-631`; Delta, zeta_cc and zeta_ff stay as
    they were."""
    grid = model.grid
    params, consts, carry, P, f_planes = curvilinear_evp_inputs(model, state, dt,
                                                                u_start, v_start)
    u, v, s11, s22, s12, alpha = curvilinear_evp_substeps(
        params, consts, carry, model.dynamics.solver.substeps, grid, f_planes)
    return dict(u=u, v=v, sig11=fill_halos_cc(s11, grid), sig22=fill_halos_cc(s22, grid),
                sig12=fill_halos_ff(s12, grid), alpha=alpha,
                P=P, un=u_start, vn=v_start,
                Delta=state.Delta, zeta_cc=state.zeta_cc, zeta_ff=state.zeta_ff)
