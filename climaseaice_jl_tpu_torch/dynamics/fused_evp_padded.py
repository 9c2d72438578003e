"""Padded fused split-explicit αEVP substep loop for bounded and immersed
grids: the gate, the launcher, the CUDA kernel's wrapper and its plain
version.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_evp_padded.py`.  The
kernel (``csrc/evp_padded.cu``) replaces the TPU kernel ``_padded_kernel``:
the whole substep loop on halo-inclusive (nxp, nyp) float32 arrays, with the
velocity halos refilled after every half-update (zero beyond a bounded wall
for the wall-normal component, edge copy for the tangential one, wrap where
periodic).  Circular shifts wrap over the whole padded extent, as the TPU
kernel's rolls do, so σ and α in the outermost halo ring come from wrapped
neighbours.  On one rank's shard of the distributed step (the 'wide' halo
policy, halos of 2·substeps+3 along the split directions) a direction split
across ranks is not filled (`pallas_evp_padded.py:119-129`): its halo points
are real points that evolve in place, going stale from the outside in by
two points a substep, and the loop ends before the staleness reaches the
interior.  Immersed land enters as in the general path:

* σ read by the divergence is zeroed at solid cc nodes and peripheral ff
  nodes (constant masks);
* velocities are zeroed on peripheral nodes (the activity masks);
* an :class:`~.momentum.ImmersedDrag` enters as geometric coefficients per
  face: the term at a u point is −(gˢ·u(i,j) + gᴺ·u(i,j+1))·invm_u with
  g = C·1_imm·Δx_ff/Az sampled at each face's own ff index.

External stresses are arrays (scalars broadcast); a StressFunction is
evaluated once per momentum step at the step-start clock.

:func:`padded_evp_substeps` picks by the tensors' device: CUDA tensors go to
the kernel, CPU tensors to :func:`padded_evp_substeps_reference`.  A CUDA
tensor never reaches the plain version; a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import _build
from ..tracing import span
from ..grids import PERIODIC, BOUNDED
from ..ops import shift_m
from ..fields import (fill_halos_cc, fill_halos_ff, fill_halos_fc_local, fill_halos_cf_local,
                      _meshed)
from .coriolis import FPlane
from .fixed_tile_advection import _wraps
from .momentum import SplitExplicitSolver, ImmersedDrag
from .rheologies import ElastoViscoPlasticRheology
from .stresses import SemiImplicitStress, StressFunction, _value
from .fused_evp import (KernelCounter, _scalar, _P_DT, _P_DX, _P_DY, _P_F, _P_RC,
                        _P_EINV2, _P_AMIN, _P_AMAX, _P_DMIN, _P_REPL,
                        check_kernel_args, cuda_error_string, describe_kernel,
                        evp_coefficients, evp_params)

N_CONSTS = 14       # P, Pff, gcc, gff, drag_u, invm_u, act_u, un,
                    # drag_v, invm_v, act_v, vn, msk_cc, msk_ff
N_DRAG = 4          # immersed-drag coefficients: S/N faces of u, W/E faces of v
N_STRESS = 4        # τᵤ, τᵥ (top), uₑ, vₑ (bottom), as arrays
N_CARRY = 6         # u, v, σ₁₁, σ₂₂, σ₁₂, α

padded_evp_counter = KernelCounter()

# how the padded kernels treat a direction's halos (csrc/evp_padded.cu,
# csrc/evp_tiled_padded.cu)
KIND_BOUNDED, KIND_PERIODIC, KIND_SPLIT = 0, 1, 2


def direction_kinds(grid):
    """(x, y) kinds of ``grid``: a bounded wall, periodic wrap, or split
    across ranks (no fill)."""
    return tuple(KIND_SPLIT if _meshed(grid, d)
                 else KIND_PERIODIC if grid.topology[d] == PERIODIC else KIND_BOUNDED
                 for d in (0, 1))


def _split_bounded(grid):
    return any(grid.topology[d] == BOUNDED and _meshed(grid, d) for d in (0, 1))


# --- the gate -----------------------------------------------------------------

def padded_fused_available(model):
    """True when the model matches the padded fused EVP configuration:
    uniform rectilinear float32 without a north fold, periodic or bounded
    sides, any land mask,
    scalar, array or StressFunction stresses, an FPlane or no Coriolis, no
    free drift, no user forcing, no immersed drag or an ImmersedDrag.

    The physics conditions of the JAX gate (`pallas_evp_padded.py:46-116`)
    without its TPU-only ones: the scoped-VMEM budget kept the whole padded
    state on chip.  A shard's model (a grid that names mesh axes) takes the
    meshed branch only under the 'wide' halo policy and where no bounded
    direction is split (`:66-74`): the kernel's static fills cannot wall a
    shard at a global edge.  The CUDA kernel keeps its state in device
    memory and indexes any nxp×nyp (ragged edges masked), so it has no size
    limit."""
    grid = model.grid
    dyn = model.dynamics
    if not isinstance(getattr(dyn, "rheology", None), ElastoViscoPlasticRheology):
        return False
    if not isinstance(dyn.solver, SplitExplicitSolver):
        return False
    if grid.kind != "rectilinear" or grid.north_fold:
        return False   # array metrics or a fold: the curvilinear route
    if any(t not in (PERIODIC, BOUNDED) for t in grid.topology):
        return False
    if grid.mesh_axes is not None and (dyn.solver.halo_exchange != "wide"
                                       or _split_bounded(grid)):
        return False
    if grid.dtype != torch.float32:
        return False
    if not all(_scalar(m) for m in (grid.dx_cc, grid.dy_cc)):
        return False
    if dyn.immersed_drag is not None and not isinstance(dyn.immersed_drag, ImmersedDrag):
        return False   # general ImmersedStressBC callables: general path only

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
    if dyn.coriolis is not None and not isinstance(dyn.coriolis, FPlane):
        return False
    if dyn.free_drift is not None:
        return False
    if model.forcing:
        return False
    return True


# --- the plain version ----------------------------------------------------------

def padded_loop_functions(params, consts, fill_fc, fill_cf, ax=0):
    """The padded substep's σ relaxation and u and v updates as closures
    ``stresses(u, v, s11, s22, s12) -> (s11, s22, s12, α)``,
    ``u_update(u, v, s11, s12, α)`` and ``v_update(u, v, s22, s12, α)``, in
    the TPU kernel's operation order (`pallas_evp_padded.py:167-372`), with
    circular shifts along axes ``ax`` (x) and ``ax + 1`` (y): 0 for whole
    padded arrays, 1 for a batch of tiles.  ``fill_fc``/``fill_cf`` refill
    the new u and v."""
    p = params
    dt = p[_P_DT]
    inv_dx = 1.0 / p[_P_DX]
    inv_dy = 1.0 / p[_P_DY]
    f_cor = p[_P_F]
    rC = p[_P_RC]
    e_inv2 = p[_P_EINV2]
    a_min = p[_P_AMIN]
    a_max = p[_P_AMAX]
    d_min = p[_P_DMIN]
    repl_on = bool(p[_P_REPL] != 0)
    X, Y = ax, ax + 1

    consts = tuple(consts)
    has_drag = len(consts) == N_CONSTS + N_DRAG + N_STRESS
    (P, Pff, gcc, gff, drag_u, invm_u, act_u, un,
     drag_v, invm_v, act_v, vn, msk_cc, msk_ff) = consts[:N_CONSTS]
    if has_drag:
        imms_u, immn_u, immw_v, imme_v = consts[N_CONSTS:N_CONSTS + N_DRAG]
    tau_u_top, tau_v_top, ue, ve = consts[-N_STRESS:]

    def sp(q, axis):   # q[I-1]
        return torch.roll(q, 1, axis)

    def sm(q, axis):   # q[I+1]
        return torch.roll(q, -1, axis)

    def ixf_(q):
        return 0.5 * (q + sp(q, X))

    def iyf_(q):
        return 0.5 * (q + sp(q, Y))

    def ixyf_(q):
        t = q + sp(q, Y)
        return 0.25 * (t + sp(t, X))

    def ixyc_(q):
        t = q + sm(q, Y)
        return 0.25 * (t + sm(t, X))

    def ixf_yc_(q):
        t = q + sm(q, Y)
        return 0.25 * (t + sp(t, X))

    def ixc_yf_(q):
        t = q + sp(q, Y)
        return 0.25 * (t + sm(t, X))

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
        e11 = (sm(u, X) - u) * inv_dx
        e22 = (sm(v, Y) - v) * inv_dy
        eS = (u - sp(u, Y)) * inv_dy + (v - sp(v, X)) * inv_dx   # 2ϵ̇₁₂ at ff
        d_cc = e11 + e22
        t_cc = e11 - e22
        d_ff = ixyf_(d_cc)
        t_ff = ixyf_(t_cc)
        eSc = ixyc_(eS)
        dd_cc = d_cc * d_cc + (t_cc * t_cc + eSc * eSc) * e_inv2
        dd_ff = d_ff * d_ff + (t_ff * t_ff + eS * eS) * e_inv2
        rD_cc = torch.minimum(torch.rsqrt(dd_cc), inv_dmin)   # 1/max(Δcc, Δmin)
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
        iso = (zcc - eta_cc) * d_cc - Prh
        s11_t = 2 * eta_cc * e11 + iso
        s22_t = 2 * eta_cc * e22 + iso
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

    def u_update(u, v, s11, s12, alpha):
        s11m = s11 * msk_cc
        s12m = s12 * msk_ff
        div_x = (s11m - sp(s11m, X)) * inv_dx + (sm(s12m, Y) - s12m) * inv_dy
        v_fc = ixf_yc_(v)
        du = ue - u
        dv = ve_fc - v_fc
        speed = torch.sqrt(du * du + dv * dv)
        Gu = (f_cor * v_fc - tau_u_top * drag_u + rC * speed * ue * drag_u
              + div_x * invm_u)
        if has_drag:
            Gu = Gu - (imms_u * u + immn_u * sm(u, Y)) * invm_u
        Gu = Gu + (un - u) * inv_dt
        Gu = torch.where(invm_u > 0, Gu, 0.0)
        idtau = ixf_(alpha) * inv_dt
        u_new = (u * idtau + Gu) / (idtau + rC * speed * drag_u) * act_u
        return fill_fc(u_new)

    def v_update(u, v, s22, s12, alpha):
        s22m = s22 * msk_cc
        s12m = s12 * msk_ff
        div_y = (s22m - sp(s22m, Y)) * inv_dy + (sm(s12m, X) - s12m) * inv_dx
        u_cf = ixc_yf_(u)
        dv = ve - v
        du = ue_cf - u_cf
        speed = torch.sqrt(du * du + dv * dv)
        Gv = (-f_cor * u_cf - tau_v_top * drag_v + rC * speed * ve * drag_v
              + div_y * invm_v)
        if has_drag:
            Gv = Gv - (immw_v * v + imme_v * sm(v, X)) * invm_v
        Gv = Gv + (vn - v) * inv_dt
        Gv = torch.where(invm_v > 0, Gv, 0.0)
        idtau = iyf_(alpha) * inv_dt
        v_new = (v * idtau + Gv) / (idtau + rC * speed * drag_v) * act_v
        return fill_cf(v_new)

    return stresses, u_update, v_update


def run_substeps(functions, carry, first, count):
    """Substeps ``first`` … ``first + count − 1`` of the loop on
    ``carry = (u, v, σ₁₁, σ₂₂, σ₁₂, α)``: σ relaxation, then v and u on odd
    substeps, u and v on even ones."""
    stresses, u_update, v_update = functions
    u, v, s11, s22, s12, alpha = carry
    for substep in range(first, first + count):
        s11, s22, s12, alpha = stresses(u, v, s11, s22, s12)
        if substep % 2 == 0:
            u = u_update(u, v, s11, s12, alpha)
            v = v_update(u, v, s22, s12, alpha)
        else:
            v = v_update(u, v, s22, s12, alpha)
            u = u_update(u, v, s11, s12, alpha)
    return u, v, s11, s22, s12, alpha


def padded_evp_substeps_reference(params, consts, carry, nsub, grid):
    """Plain PyTorch version of the kernel: ``nsub`` substeps on padded
    arrays with circular shifts over the padded extent, in the TPU kernel's
    operation order (`pallas_evp_padded.py:167-372`).  The u/v halo fills
    are the local fills of :mod:`..fields`, which concatenate exactly as the
    TPU kernel's `_make_fillers` (`pallas_evp_padded.py:119-164`) and, on a
    shard, leave the split directions alone.  Returns the new (u, v, σ₁₁,
    σ₂₂, σ₁₂, α)."""
    def fill_fc(q):
        return fill_halos_fc_local(q, grid)

    def fill_cf(q):
        return fill_halos_cf_local(q, grid)

    u, v, s11, s22, s12, alpha = carry
    functions = padded_loop_functions(params, consts, fill_fc, fill_cf)
    return run_substeps(functions, (fill_fc(u), fill_cf(v), s11, s22, s12, alpha), 1, nsub)


# --- the kernel's wrapper -------------------------------------------------------

def _padded_lib():
    lib = _build.load("evp_padded")
    fn = lib.csi_evp_padded_substeps
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (1 + N_CONSTS + N_DRAG + N_STRESS + 2 * N_CARRY)
                       + [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.csi_evp_padded_chunk_substeps.argtypes = []
        lib.csi_evp_padded_chunk_substeps.restype = ctypes.c_int
        lib.csi_evp_padded_describe.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.csi_evp_padded_describe.restype = ctypes.c_int
    return lib


def chunk_substeps():
    """The substeps one launch of the built kernel's tiled plan runs."""
    return _padded_lib().csi_evp_padded_chunk_substeps()


def describe():
    """The built kernel's tiled plan on the current card
    (:func:`.fused_evp.describe_kernel`)."""
    return describe_kernel(_padded_lib(), "csi_evp_padded_describe", "evp_padded")


def padded_evp_substeps(params, consts, carry, nsub, grid):
    """Run ``nsub`` αEVP substeps on padded arrays of ``grid``'s shape.

    ``params``: float32[18] (the layout of :mod:`.fused_evp`); ``consts``:
    the 14 constant arrays, then the 4 immersed-drag coefficient arrays if
    there is drag, then the 4 stress arrays; ``carry``: (u, v, σ₁₁, σ₂₂,
    σ₁₂, α).  CUDA tensors go to the CUDA kernel, which updates the carry
    tensors in place and returns them; CPU tensors go to
    :func:`padded_evp_substeps_reference`.  The kernel holds msk_cc and
    msk_ff as a byte a point: they must be 0 or 1, as
    :func:`padded_evp_inputs` makes them."""
    consts, carry = tuple(consts), tuple(carry)
    if (len(consts) not in (N_CONSTS + N_STRESS, N_CONSTS + N_DRAG + N_STRESS)
            or len(carry) != N_CARRY):
        raise ValueError(f"expected {N_CONSTS} constants, optionally {N_DRAG} drag "
                         f"arrays, {N_STRESS} stress arrays and {N_CARRY} carries")
    device = params.device
    if device.type == "cpu":
        if any(q.device != device for q in consts + carry):
            raise ValueError("EVP tensors span devices")
        return padded_evp_substeps_reference(params, consts, carry, nsub, grid)
    if device.type != "cuda":
        raise ValueError(f"no EVP kernel for device {device}")
    shape = check_kernel_args(params, consts + carry)
    if shape != grid.shape:
        raise ValueError(f"EVP arrays are {shape}, the grid's fields {grid.shape}")
    has_drag = len(consts) == N_CONSTS + N_DRAG + N_STRESS
    drag = consts[N_CONSTS:N_CONSTS + N_DRAG] if has_drag else (None,) * N_DRAG
    scratch = tuple(torch.empty_like(q) for q in carry)
    ptrs = [params.data_ptr()]
    ptrs += [q.data_ptr() for q in consts[:N_CONSTS]]
    ptrs += [None if q is None else q.data_ptr() for q in drag]
    ptrs += [q.data_ptr() for q in consts[-N_STRESS:] + carry + scratch]
    launches = ctypes.c_int(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _padded_lib().csi_evp_padded_substeps(
            *ptrs, grid.nxp, grid.nyp, grid.Hx, grid.Nx, grid.Hy, grid.Ny,
            *direction_kinds(grid), int(has_drag), int(nsub), ctypes.byref(launches), stream)
    if err != 0:
        raise RuntimeError(f"padded EVP kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('evp_padded', err)})")
    padded_evp_counter.calls += 1
    padded_evp_counter.launches += launches.value
    return carry


# --- the fixed-tile coefficient kernel -------------------------------------------
#
# Counterpart of `pallas_evp_padded.py:512-621` (`_prep_kernel` run by
# `_fixed_tile_prepare`): the ten coefficient arrays of the substep loop from
# h and ℵ, each point from its own and its i−1, j−1 neighbours.  The TPU
# kernel gathers (TX+16, TY+128) tiles of the padded arrays, wrapping into
# the interior along a periodic direction and clamping at the padded edge
# along a bounded one or one split across ranks (`pallas_evp_padded.py:
# 585-588`), and shifts inside the tile; a point's neighbours are
# therefore the gathered images of its padded index − 1.  The plain version
# reads those images directly; the kernel (``csrc/evp_prep.cu``) loads them
# into a shared-memory tile a block, one point of halo at i−1 and j−1, and
# forms m and P once a tile point.  Along a periodic direction the point
# itself is read from its interior image too, as the gather does.  This
# differs from :func:`.fused_evp.evp_coefficients`, whose shifts wrap over
# the padded extent, in the outermost halo ring only.

N_PREP_PARAMS = 7   # ρ, P★, C, c_α·Δt (c_α in the launch), Az, minimum mass and concentration
N_PREP_OUT = 10     # P, Pff, gcc, gff, drag_u, invm_u, act_u, drag_v, invm_v, act_v
PREP_TILE = (8, 32)  # a block's outputs, one a thread: rows along x, columns along y

evp_prep_counter = KernelCounter()


def _prep_sources(ext, n_int, H, wrap, device):
    """Padded source index of every padded index k − 1, k = 0 … ext (entry 0
    is the image of index −1): `_tile_indices`' wrap or clamp."""
    k = torch.arange(-1, ext, device=device)
    return H + torch.remainder(k - H, n_int) if wrap else torch.clamp(k, 0, ext - 1)


def evp_prep_params(model, dt):
    """The float32[7] parameters of the coefficient kernel's plain version,
    formed on the device as `pallas_evp_padded.py:595-603` forms them;
    ``dt`` a 0-d float32 tensor."""
    grid = model.grid
    dyn = model.dynamics
    rheo = dyn.rheology
    f32 = grid.scalar
    return torch.stack([f32(model.sea_ice_density), f32(rheo.ice_compressive_strength),
                        f32(rheo.ice_compaction_hardening),
                        f32(rheo.relaxation_strength) * dt,
                        f32(grid.dx_cc) * f32(grid.dy_cc),
                        f32(dyn.minimum_mass), f32(dyn.minimum_concentration)])


def _host_f32(x):
    return np.float32(x.item() if isinstance(x, torch.Tensor) else x)


class PrepPlan:
    """The coefficient kernel's parameters for one model, rounded to float32
    on the host as :func:`evp_prep_params` rounds them on the device: ρ, P★,
    C, the relaxation strength c_α (the kernel forms c_α·Δt with the 0-d
    Δt of the call), Az = f32(Δx)·f32(Δy), minimum mass and minimum
    concentration; ``values`` as Python floats, ``array`` as the ctypes
    array the launch passes."""

    def __init__(self, model):
        grid, dyn = model.grid, model.dynamics
        rheo = dyn.rheology
        values = (_host_f32(model.sea_ice_density), _host_f32(rheo.ice_compressive_strength),
                  _host_f32(rheo.ice_compaction_hardening),
                  _host_f32(rheo.relaxation_strength),
                  _host_f32(grid.dx_cc) * _host_f32(grid.dy_cc),
                  _host_f32(dyn.minimum_mass), _host_f32(dyn.minimum_concentration))
        self.values = tuple(float(v) for v in values)
        self.array = (ctypes.c_float * N_PREP_PARAMS)(*self.values)


_prep_plans = weakref.WeakKeyDictionary()


def prep_plan(model) -> PrepPlan:
    """``model``'s :class:`PrepPlan`, made at its first call."""
    if model not in _prep_plans:
        _prep_plans[model] = PrepPlan(model)
    return _prep_plans[model]


def evp_prep_reference(prm, h, a, grid):
    """Plain PyTorch version of the coefficient kernel, in `_prep_kernel`'s
    operation order (`pallas_evp_padded.py:537-555`): the ten coefficient
    arrays on the padded shape."""
    rho, Pstar, Chard, cadt, az, mass_min, conc_min = prm
    ex = _prep_sources(grid.nxp, grid.Nx, grid.Hx, _wraps(grid, 0), h.device)
    ey = _prep_sources(grid.nyp, grid.Ny, grid.Hy, _wraps(grid, 1), h.device)
    he, ae = h[ex][:, ey], a[ex][:, ey]        # (nxp + 1, nyp + 1) images
    m = he * ae * rho
    P = Pstar * he * torch.exp(-Chard * (1 - ae))

    def c(q):      # the point
        return q[1:, 1:]

    def xm(q):     # its i − 1 image
        return q[:-1, 1:]

    def ym(q):     # its j − 1 image
        return q[1:, :-1]

    def ff(q):     # ixf(iyf(q))
        return 0.5 * (0.5 * (c(q) + ym(q)) + 0.5 * (xm(q) + q[:-1, :-1]))

    m_cc, m_ff = c(m), ff(m)
    m_fc, a_fc = 0.5 * (m_cc + xm(m)), 0.5 * (c(ae) + xm(ae))
    m_cf, a_cf = 0.5 * (m_cc + ym(m)), 0.5 * (c(ae) + ym(ae))

    def gamma2(mq):
        ok = mq > 0
        return torch.where(ok, cadt / (torch.where(ok, mq, 1.0) * az), -1.0)

    def inv0(mq):
        ok = mq > 0
        return torch.where(ok, 1.0 / torch.where(ok, mq, 1.0), 0.0)

    invm_u, invm_v = inv0(m_fc), inv0(m_cf)
    act_u = ((m_fc >= mass_min) & (a_fc >= conc_min)).to(torch.float32)
    act_v = ((m_cf >= mass_min) & (a_cf >= conc_min)).to(torch.float32)
    return tuple(q.contiguous() for q in (
        c(P), ff(P), gamma2(m_cc), gamma2(m_ff), invm_u * a_fc, invm_u, act_u,
        invm_v * a_cf, invm_v, act_v))


def _prep_entry():
    fn = _build.load("evp_prep").csi_evp_prep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def evp_prep(model, dt, h, a, grid=None, per_fc=None, per_cf=None):
    """The ten coefficient arrays of the substep loop from h and ℵ on
    ``grid``'s padded shape (default ``model.grid``; a shard's grid with the
    serial model's parameters), at the 0-d float32 time step ``dt``; with
    the peripheral masks ``per_fc``, ``per_cf`` (bool arrays), act_u and
    act_v are zero where they are set.  CUDA tensors go to the kernel
    (``csrc/evp_prep.cu``: one launch, one output point a thread, the
    parameters from the model's :class:`PrepPlan`, no other device
    operation), CPU tensors to :func:`evp_prep_reference`."""
    grid = model.grid if grid is None else grid
    device = h.device
    if device.type == "cpu":
        if a.device != device or dt.device != device:
            raise ValueError("coefficient tensors span devices")
        out = list(evp_prep_reference(evp_prep_params(model, dt), h, a, grid))
        for k, per in ((6, per_fc), (9, per_cf)):
            if per is not None:
                out[k] = out[k] * (~per).to(torch.float32)
        return tuple(out)
    if device.type != "cuda":
        raise ValueError(f"no coefficient kernel for device {device}")
    if dt.device != device or dt.dtype != torch.float32 or dt.dim() != 0:
        raise ValueError(f"dt must be a 0-d float32 tensor on {device}")
    for q in (h, a):
        if (q.device != device or q.dtype != torch.float32 or tuple(q.shape) != grid.shape
                or not q.is_contiguous()):
            raise ValueError(f"h and ℵ must be contiguous float32 {grid.shape} tensors "
                             f"on {device}")
    masks = []
    for per in (per_fc, per_cf):
        if per is not None and (per.device != device or per.dtype != torch.bool
                                or tuple(per.shape) != grid.shape or not per.is_contiguous()):
            raise ValueError(f"peripheral masks must be contiguous bool {grid.shape} tensors "
                             f"on {device}")
        masks.append(None if per is None else per.data_ptr())
    plan = prep_plan(model)
    out = torch.empty((N_PREP_OUT,) + grid.shape, dtype=torch.float32, device=device)
    fn = _prep_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(plan.array), dt.data_ptr(), h.data_ptr(), a.data_ptr(),
                 *masks, out.data_ptr(), grid.nxp, grid.nyp, grid.Hx, grid.Nx, grid.Hy,
                 grid.Ny, int(_wraps(grid, 0)), int(_wraps(grid, 1)), stream)
    if err != 0:
        raise RuntimeError(f"EVP coefficient kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('evp_prep', err)})")
    evp_prep_counter.calls += 1
    evp_prep_counter.launches += 1
    return tuple(out.unbind(0))


# --- the launcher ---------------------------------------------------------------

def padded_evp_inputs(model, state, dt, u_start, v_start):
    """(params, consts, carry, P) of the padded substep loop, as
    `pallas_evp_padded.py:375-509` assembles them; with
    ``solver.fixed_tiles`` the coefficients come from :func:`evp_prep`
    (kernel 2.4), as its ``fixed_tiles`` branch has them.  The carry tensors
    are fresh copies."""
    from ..model import make_fields

    grid = model.grid
    dyn = model.dynamics
    masks = model.masks
    f32 = grid.scalar
    dt = f32(dt)
    if dyn.solver.fixed_tiles is not None:     # act_u, act_v masked by the kernel
        (P, Pff, gcc, gff, drag_u, invm_u, act_u, drag_v, invm_v, act_v) = evp_prep(
            model, dt, state.h.contiguous(), state.a.contiguous(), grid,
            masks.per_fc.contiguous(), masks.per_cf.contiguous())
    else:
        (P, Pff, gcc, gff, drag_u, invm_u, act_u,
         drag_v, invm_v, act_v) = evp_coefficients(model, state, dt)
        act_u = act_u * (~masks.per_fc).to(torch.float32)
        act_v = act_v * (~masks.per_cf).to(torch.float32)
    # 1 where σ₁₁, σ₂₂ are read (a shard without land has no solid mask)
    msk_cc = (torch.ones(grid.shape, dtype=torch.float32, device=grid.device)
              if masks.solid_cc is None else (~masks.solid_cc).to(torch.float32))
    msk_ff = (~masks.per_ff).to(torch.float32)     # 1 where σ₁₂ is read

    drag_consts = ()
    if dyn.immersed_drag is not None and masks.imm_ff is not None:
        C = f32(dyn.immersed_drag.coefficient)
        az = f32(grid.dx_cc) * f32(grid.dy_cc)
        dx_ff = f32(grid.dx_ff).expand(grid.shape)
        dy_ff = f32(grid.dy_ff).expand(grid.shape)
        wx = torch.where(masks.imm_ff, C * dx_ff, 0.0) / az
        wy = torch.where(masks.imm_ff, C * dy_ff, 0.0) / az
        drag_consts = (wx, shift_m(wx, 1), wy, shift_m(wy, 0))

    fields = make_fields(model, state)

    def array(x):   # a scalar, array or StressFunction as a float32 array
        x = _value(0.0 if x is None else x, grid, state.clock, fields)
        return f32(x).expand(grid.shape)

    top = dyn.top_momentum_stress
    if isinstance(top, dict):
        tau_u_top, tau_v_top = array(top.get("u")), array(top.get("v"))
    else:
        tau_u_top = tau_v_top = array(top)
    bottom = dyn.bottom_momentum_stress
    if isinstance(bottom, SemiImplicitStress):
        rC = f32(bottom.rho_e * bottom.Cd)
        ue, ve = array(bottom.ue), array(bottom.ve)
    else:
        rC = f32(0.0)
        ue = ve = array(None)
    zero = f32(0.0)
    params = evp_params(model, dt, zero, zero, rC, zero, zero)

    consts = tuple(q.contiguous() for q in (
        (P, Pff, gcc, gff, drag_u, invm_u, act_u, u_start,
         drag_v, invm_v, act_v, v_start, msk_cc, msk_ff)
        + drag_consts + (tau_u_top, tau_v_top, ue, ve)))
    carry = tuple(q.clone(memory_format=torch.contiguous_format)
                  for q in (u_start, v_start, state.sig11, state.sig22,
                            state.sig12, state.alpha))
    return params, consts, carry, P


def padded_fused_momentum_step(model, state, dt, u_start, v_start):
    """Run the whole substep loop through :func:`padded_evp_substeps`;
    returns the same update dict as the general
    `split_explicit_momentum_step`.  σ halos are refilled afterwards and α
    keeps the loop's halos, as in `pallas_evp_padded.py:651-658`; Delta,
    zeta_cc and zeta_ff stay as they were."""
    grid = model.grid
    params, consts, carry, P = padded_evp_inputs(model, state, dt, u_start, v_start)
    with span("seaice.evp"):
        u, v, s11, s22, s12, alpha = padded_evp_substeps(
            params, consts, carry, model.dynamics.solver.substeps, grid)
    with span("seaice.fill"):
        s11, s22 = fill_halos_cc(s11, grid), fill_halos_cc(s22, grid)
        s12 = fill_halos_ff(s12, grid)
    return dict(u=u, v=v, sig11=s11, sig22=s22, sig12=s12, alpha=alpha,
                P=P, un=u_start, vn=v_start,
                Delta=state.Delta, zeta_cc=state.zeta_cc, zeta_ff=state.zeta_ff)
