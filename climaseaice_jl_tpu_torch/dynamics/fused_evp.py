"""Fused split-explicit αEVP substep loop: the gate, the dispatch between
the whole-array and the tiled loop, the launcher, the whole-array CUDA
kernel's wrapper and its plain version.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_evp.py`.  Two kernels
compute the loop on interior-only, doubly periodic, uniform-metric float32
arrays with circular shifts, so the arrays need no halos at all:
``csrc/evp.cu`` replaces the TPU kernel ``_evp_kernel`` (2.1, twelve
constants prepared by the launcher, :func:`evp_coefficients`) and runs
grids of up to ``_MAX_POINTS_RICH`` points; ``csrc/evp_tiled.cu``
(:mod:`.fused_evp_tiled`) replaces ``_tiled_kernel`` (2.2, coefficients
derived from m, ℵ and P in its own forms) and runs larger ones, as the JAX
dispatcher does (`pallas_evp.py:440-466`).  Both run one tile engine
(``csrc/evp_periodic_tile.cuh``): one launch per chunk of K substeps on
tiles held in shared memory with an overlap of 2K, α never loaded, the
carried fields ping-ponging with scratch arrays; they differ in how a
point gets its coefficients (2.1 reads its twelve arrays at the point, 2.2
derives them).  Both build with -fmad=false and equal their plain versions
bitwise.  Uniform-metric forms (exact on uniform grids):

    ϵ̇₁₁ = δxᶜu/Δx          ϵ̇₂₂ = δyᶜv/Δy       ϵ̇₁₂ = (δyᶠu/Δy + δxᶠv/Δx)/2
    ∂ⱼσ₁ⱼ = δxᶠσ₁₁/Δx + δyᶜσ₁₂/Δy
    ∂ⱼσ₂ⱼ = δyᶠσ₂₂/Δy + δxᶜσ₁₂/Δx
    EVP forcing (uⁿ−u)/Δτ/ᾱ with Δτ = Δt/ᾱ  ≡  (uⁿ−u)/Δt

:func:`evp_substeps` picks by the tensors' device: CUDA tensors go to the
kernel, CPU tensors to :func:`evp_substeps_reference`.  A CUDA tensor never
reaches the plain version; a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..tracing import span
from ..grids import PERIODIC
from ..ops import ixf, iyf, ixy_ff
from ..fields import fill_halos_cc, fill_halos_fc, fill_halos_cf, fill_halos_ff
from .coriolis import FPlane
from .momentum import SplitExplicitSolver
from .rheologies import ElastoViscoPlasticRheology, ice_strength
from .stresses import SemiImplicitStress, StressFunction

# params vector layout (csrc/evp.cu, pallas_evp.py:44-46); the last is padding
_P_DT, _P_DX, _P_DY, _P_F, _P_TAUU, _P_TAUV, _P_RC, _P_UE, _P_VE, \
    _P_EINV2, _P_AMIN, _P_AMAX, _P_CALPHA, _P_DMIN, _P_MASSMIN, _P_CONCMIN, \
    _P_REPL, _P_PAD = range(18)

N_PARAMS = 18
N_CONSTS = 12   # P, Pff, gcc, gff, drag_u, invm_u, act_u, un, drag_v, invm_v, act_v, vn
N_CARRY = 6     # u, v, σ₁₁, σ₂₂, σ₁₂, α
_MAX_GRID_Y = 65535   # CUDA's limit on gridDim.y; the kernels put x there
_MIN_TILE_ROWS = 8    # the periodic kernels' tiles hold at least 8 rows (x)

# Where the JAX package's function changes (`pallas_evp.py:66-73`): up to
# _MAX_POINTS_RICH points it runs 2.1, above it 2.2, which derives its
# coefficients in other forms, up to _MAX_POINTS_TILED.  The limits come
# from the TPU's memory at JAX's default CSI_VMEM_LIMIT_MB = 126,
# (126 − 4)·2²⁰ // (56·4) points, and 8192²; they are kept because they
# mark where the function changes, so that both packages compute the same
# function at every size.  This package reads no environment variable.
_MAX_POINTS_RICH = 571_099
_MAX_POINTS_TILED = 8192 * 8192
CHUNK_SUBSTEPS = 15   # the TPU kernel's cap on K (`pallas_evp_tiled.py:44`)


def pick_chunk(nsub):
    """The largest divisor of ``nsub`` in [2, CHUNK_SUBSTEPS], or None
    (`pallas_evp_tiled.py:47-58`).  The JAX package runs its tiled kernels
    only for substep counts that have one."""
    for K in range(min(CHUNK_SUBSTEPS, nsub), 1, -1):
        if nsub % K == 0:
            return K
    return None


@dataclasses.dataclass
class KernelCounter:
    """Calls of a kernel wrapper and the kernel launches they made."""
    calls: int = 0
    launches: int = 0

    def reset(self):
        self.calls = 0
        self.launches = 0


evp_counter = KernelCounter()


# --- the gate -----------------------------------------------------------------

def _scalar(x):
    if x is None or isinstance(x, (int, float)):
        return True
    if isinstance(x, StressFunction):
        return False   # time-dependent stress
    if isinstance(x, torch.Tensor):
        return x.dim() == 0
    if callable(x):
        return False   # time-dependent stress
    return np.ndim(x) == 0


def fused_available(model):
    """True when the model matches the fused EVP configuration.

    The conditions of the JAX gate (`pallas_evp.py:91-136`) but its (8, 128)
    alignment, which matched the TPU's vector tiling (both CUDA kernels
    index any Nx×Ny), and the tile plan's fit (`_tiled_eligible`), which
    the CUDA kernel's own plan does not need.  Above ``_MAX_POINTS_RICH``
    points, where the route runs 2.2, the gate refuses what JAX's refuses:
    a substep count without a chunk length (:func:`pick_chunk`) and grids
    above ``_MAX_POINTS_TILED`` points; the step then takes the next route,
    as in JAX."""
    grid = model.grid
    dyn = model.dynamics
    if not isinstance(getattr(dyn, "rheology", None), ElastoViscoPlasticRheology):
        return False
    if not isinstance(dyn.solver, SplitExplicitSolver):
        return False
    if grid.kind != "rectilinear" or grid.topology != (PERIODIC, PERIODIC):
        return False
    if grid.is_immersed:
        return False
    if grid.dtype != torch.float32:
        return False
    if not all(_scalar(m) for m in (grid.dx_cc, grid.dy_cc)):
        return False
    points = grid.Nx * grid.Ny
    if points > _MAX_POINTS_RICH and (pick_chunk(dyn.solver.substeps) is None
                                      or points > _MAX_POINTS_TILED):
        return False

    top = dyn.top_momentum_stress
    if isinstance(top, dict):
        if not (_scalar(top.get("u")) and _scalar(top.get("v"))):
            return False
    elif not _scalar(top):
        return False
    bottom = dyn.bottom_momentum_stress
    if bottom is not None and not isinstance(bottom, SemiImplicitStress):
        return False
    if isinstance(bottom, SemiImplicitStress):
        if not (_scalar(bottom.ue) and _scalar(bottom.ve)):
            return False
    if dyn.coriolis is not None and not isinstance(dyn.coriolis, FPlane):
        return False
    if dyn.free_drift is not None:
        return False
    if model.forcing:
        return False
    return True


# --- the plain version ----------------------------------------------------------

def evp_substep_phases(params, consts):
    """The three phases of the plain version's substep, in the TPU kernel's
    operation order (`pallas_evp.py:213-315`), on interior arrays with
    circular shifts: ``stresses(u, v, σ₁₁, σ₂₂, σ₁₂) → (σ₁₁, σ₂₂, σ₁₂, α)``,
    ``u_update(u, v, σ₁₁, σ₁₂, α) → u`` and ``v_update(u, v, σ₂₂, σ₁₂, α) →
    v``."""
    p = params
    dt = p[_P_DT]
    inv_dx = 1.0 / p[_P_DX]
    inv_dy = 1.0 / p[_P_DY]
    f_cor = p[_P_F]
    tau_u_top = p[_P_TAUU]
    tau_v_top = p[_P_TAUV]
    rC = p[_P_RC]          # ρₑ·Cᴰ of the bottom SemiImplicitStress
    ue = p[_P_UE]
    ve = p[_P_VE]
    e_inv2 = p[_P_EINV2]
    a_min = p[_P_AMIN]
    a_max = p[_P_AMAX]
    d_min = p[_P_DMIN]
    repl_on = p[_P_REPL] != 0

    (P, Pff, gcc, gff, drag_u, invm_u, act_u, un,
     drag_v, invm_v, act_v, vn) = consts

    def sp(q, axis):   # q[I-1]
        return torch.roll(q, 1, axis)

    def sm(q, axis):   # q[I+1]
        return torch.roll(q, -1, axis)

    def ixf_(q):
        return 0.5 * (q + sp(q, 0))

    def iyf_(q):
        return 0.5 * (q + sp(q, 1))

    # double interpolations with one 0.25 scale
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
    ok_cc = gcc > 0
    ok_ff = gff > 0

    def stresses(u, v, s11, s22, s12):
        e11 = (sm(u, 0) - u) * inv_dx
        e22 = (sm(v, 1) - v) * inv_dy
        eS = (u - sp(u, 1)) * inv_dy + (v - sp(v, 0)) * inv_dx   # 2ϵ̇₁₂ at ff

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

        Dcc = torch.maximum(dd_cc * rD_cc, d_min)
        Prh = torch.where(repl_on, Ph * Dcc / (Dcc + d_min), Ph)

        eta_cc = zcc * e_inv2
        eta_ff = zff * e_inv2
        iso = (zcc - eta_cc) * d_cc - Prh
        s11_t = 2 * eta_cc * e11 + iso
        s22_t = 2 * eta_cc * e22 + iso
        s12_t = eta_ff * eS

        # dynamic relaxation γ = clamp(√(ζ·cαΔt/m/Az)), α⁺ where m ≤ 0
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
        div_x = (s11 - sp(s11, 0)) * inv_dx + (sm(s12, 1) - s12) * inv_dy
        v_fc = ixf_yc_(v)
        du = ue - u
        dv = ve - v_fc
        speed = torch.sqrt(du * du + dv * dv)
        tau_bx = rC * speed * ue
        tau_i = rC * speed * drag_u        # implicit drag · a/m

        Gu = (f_cor * v_fc
              - tau_u_top * drag_u
              + tau_bx * drag_u
              + div_x * invm_u
              + (un - u) * inv_dt)
        Gu = torch.where(invm_u > 0, Gu, 0.0)
        idtau = ixf_(alpha) * inv_dt       # 1/Δτ
        uD = (u * idtau + Gu) / (idtau + tau_i)
        return uD * act_u

    def v_update(u, v, s22, s12, alpha):
        div_y = (s22 - sp(s22, 1)) * inv_dy + (sm(s12, 0) - s12) * inv_dx
        u_cf = ixc_yf_(u)
        dv = ve - v
        du = ue - u_cf
        speed = torch.sqrt(du * du + dv * dv)
        tau_by = rC * speed * ve
        tau_i = rC * speed * drag_v

        Gv = (-f_cor * u_cf
              - tau_v_top * drag_v
              + tau_by * drag_v
              + div_y * invm_v
              + (vn - v) * inv_dt)
        Gv = torch.where(invm_v > 0, Gv, 0.0)
        idtau = iyf_(alpha) * inv_dt
        vD = (v * idtau + Gv) / (idtau + tau_i)
        return vD * act_v

    return stresses, u_update, v_update


def evp_substeps_reference(params, consts, carry, nsub):
    """Plain PyTorch version of the kernel: ``nsub`` substeps on interior
    arrays with circular shifts, in the TPU kernel's operation order
    (`pallas_evp.py:139-345`; :func:`evp_substep_phases`).  Returns the new
    (u, v, σ₁₁, σ₂₂, σ₁₂, α)."""
    stresses, u_update, v_update = evp_substep_phases(params, consts)
    u, v, s11, s22, s12, alpha = carry
    for substep in range(1, nsub + 1):
        s11, s22, s12, alpha = stresses(u, v, s11, s22, s12)
        if substep % 2 == 0:
            u = u_update(u, v, s11, s12, alpha)
            v = v_update(u, v, s22, s12, alpha)
        else:
            v = v_update(u, v, s22, s12, alpha)
            u = u_update(u, v, s11, s12, alpha)
    return u, v, s11, s22, s12, alpha


# --- the kernel's wrapper -------------------------------------------------------

def _evp_lib():
    lib = _build.load("evp")
    fn = lib.csi_evp_substeps
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (1 + N_CONSTS + 2 * N_CARRY)
                       + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.csi_evp_chunk_substeps.argtypes = []
        lib.csi_evp_chunk_substeps.restype = ctypes.c_int
    return lib


def chunk_substeps():
    """The substeps one launch of the built kernel runs."""
    return _evp_lib().csi_evp_chunk_substeps()


def describe_kernel(lib, entry, name):
    """A built tile kernel on the current card, from its C entry ``entry``
    (the tile engines' describe functions): registers and spill bytes a
    thread, static and dynamic shared bytes a block, resident blocks an SM
    and threads a block."""
    out = (ctypes.c_int * 6)()
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(out)
    if err != 0:
        raise RuntimeError(f"{name} kernel attributes: CUDA error {err} "
                           f"({cuda_error_string(name, err)})")
    keys = ("registers", "spill_bytes", "static_shared_bytes", "dynamic_shared_bytes",
            "blocks_per_sm", "threads_per_block")
    return dict(zip(keys, out))


def describe():
    """The built kernel on the current card (:func:`describe_kernel`)."""
    return describe_kernel(_evp_lib(), "csi_evp_describe", "evp")


def cuda_error_string(library, code):
    """The CUDA runtime's message for error ``code``, from a built library."""
    fn = _build.load(library).csi_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def check_kernel_args(params, arrays):
    device = params.device
    if params.dtype != torch.float32 or tuple(params.shape) != (N_PARAMS,) \
            or not params.is_contiguous():
        raise ValueError(f"params must be a contiguous float32[{N_PARAMS}] tensor")
    shape = tuple(arrays[0].shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"EVP arrays must be 2-D and non-empty, got {shape}")
    for q in arrays:
        if q.device != device:
            raise ValueError(f"EVP tensors span devices {device} and {q.device}")
        if q.dtype != torch.float32:
            raise ValueError(f"the EVP kernel takes float32, got {q.dtype}")
        if tuple(q.shape) != shape:
            raise ValueError(f"EVP arrays differ in shape: {shape} vs {tuple(q.shape)}")
        if not q.is_contiguous():
            raise ValueError("EVP arrays must be contiguous")
    if -(-shape[0] // _MIN_TILE_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"Nx = {shape[0]} exceeds the kernel's launch grid")
    return shape


def evp_substeps(params, consts, carry, nsub):
    """Run ``nsub`` αEVP substeps on interior arrays.

    ``params``: float32[18] (layout above); ``consts``: the 12 constant
    arrays; ``carry``: (u, v, σ₁₁, σ₂₂, σ₁₂, α).  CUDA tensors go to the
    CUDA kernel (one launch per chunk of :func:`chunk_substeps` substeps),
    which writes the results into the carry tensors and returns them; CPU
    tensors go to :func:`evp_substeps_reference`."""
    consts, carry = tuple(consts), tuple(carry)
    if len(consts) != N_CONSTS or len(carry) != N_CARRY:
        raise ValueError(f"expected {N_CONSTS} constants and {N_CARRY} carries")
    device = params.device
    if device.type == "cpu":
        if any(q.device != device for q in consts + carry):
            raise ValueError("EVP tensors span devices")
        return evp_substeps_reference(params, consts, carry, nsub)
    if device.type != "cuda":
        raise ValueError(f"no EVP kernel for device {device}")
    nx, ny = check_kernel_args(params, consts + carry)
    scratch = tuple(torch.empty_like(q) for q in carry)
    launches = ctypes.c_int(0)
    lib = _evp_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.csi_evp_substeps(params.data_ptr(),
                                   *(q.data_ptr() for q in consts + carry + scratch),
                                   nx, ny, int(nsub), ctypes.byref(launches), stream)
    if err != 0:
        raise RuntimeError(f"EVP kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('evp', err)})")
    evp_counter.calls += 1
    evp_counter.launches += launches.value
    return carry


# --- the launcher ---------------------------------------------------------------

def evp_coefficients(model, state, dt, az_cc=None, az_ff=None):
    """The padded constants of the substep loop that the EVP kernels take,
    in the JAX launchers' operation order (`pallas_evp.py:354-438`,
    `pallas_evp_padded.py:375-429`, `pallas_evp_curvilinear.py:458-518`):
    (P, Pff, gcc, gff, drag_u, invm_u, act_u, drag_v, invm_v, act_v).
    ``dt`` is a 0-d float32 tensor; gcc and gff are the γ² coefficients
    with −1 where the mass is not positive.  ``az_cc``/``az_ff``: the cell
    areas at cc and ff points; by default the uniform Δx·Δy."""
    dyn = model.dynamics
    rheo = dyn.rheology
    grid = model.grid
    f32 = grid.scalar      # the gates guarantee a float32 grid
    h, a = state.h, state.a
    rho = f32(model.sea_ice_density)
    if az_cc is None:
        az_cc = az_ff = f32(grid.dx_cc) * f32(grid.dy_cc)

    P = ice_strength(rheo, h, a)
    Pff = ixy_ff(P)
    m_cc = h * a * rho
    m_ff = ixy_ff(m_cc)
    m_fc = ixf(m_cc)
    a_fc = ixf(a)
    m_cf = iyf(m_cc)
    a_cf = iyf(a)

    def inv0(x):
        ok = x > 0
        return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), 0.0)

    # γ² coefficient with the m ≤ 0 sentinel (negative)
    def gamma2_coefficient(m, az):
        ok = m > 0
        return torch.where(ok, rheo.relaxation_strength * dt
                           / (torch.where(ok, m, 1.0) * az), -1.0)

    invm_u = inv0(m_fc)
    invm_v = inv0(m_cf)
    act_u = ((m_fc >= dyn.minimum_mass)
             & (a_fc >= dyn.minimum_concentration)).to(torch.float32)
    act_v = ((m_cf >= dyn.minimum_mass)
             & (a_cf >= dyn.minimum_concentration)).to(torch.float32)
    return (P, Pff, gamma2_coefficient(m_cc, az_cc), gamma2_coefficient(m_ff, az_ff),
            invm_u * a_fc, invm_u, act_u, invm_v * a_cf, invm_v, act_v)


def evp_params(model, dt, tau_u_top, tau_v_top, rC, ue, ve, dx=None, dy=None, f=None):
    """The float32[18] params vector (layout above) from 0-d tensors.  ``dx``,
    ``dy`` default to the grid's uniform spacings and ``f`` to the FPlane's
    f (0 without Coriolis)."""
    dyn = model.dynamics
    rheo = dyn.rheology
    f32 = model.grid.scalar
    if f is None:
        f = dyn.coriolis.f if dyn.coriolis is not None else 0.0
    return torch.stack([
        dt, f32(model.grid.dx_cc if dx is None else dx),
        f32(model.grid.dy_cc if dy is None else dy), f32(f),
        tau_u_top, tau_v_top, rC, ue, ve,
        f32(rheo.yield_curve_eccentricity) ** -2.0,
        f32(rheo.min_relaxation_parameter),
        f32(rheo.max_relaxation_parameter),
        f32(rheo.relaxation_strength),
        f32(rheo.minimum_plastic_stress),
        f32(dyn.minimum_mass),
        f32(dyn.minimum_concentration),
        f32(1.0 if rheo.pressure_formulation == "replacement" else 0.0),
        f32(0.0),
    ])


def periodic_params(model, dt):
    """The float32[18] params vector of the periodic routes: the model's
    scalar top stress, bottom drag and ocean velocity; ``dt`` a 0-d float32
    tensor."""
    dyn = model.dynamics
    f32 = model.grid.scalar

    def value(x):
        return f32(0.0 if x is None else x)

    top = dyn.top_momentum_stress
    if isinstance(top, dict):
        tau_u_top, tau_v_top = value(top.get("u")), value(top.get("v"))
    else:
        tau_u_top = tau_v_top = value(top)
    bottom = dyn.bottom_momentum_stress
    if isinstance(bottom, SemiImplicitStress):
        rC, ue, ve = f32(bottom.rho_e * bottom.Cd), f32(bottom.ue), f32(bottom.ve)
    else:
        rC = ue = ve = f32(0.0)
    return evp_params(model, dt, tau_u_top, tau_v_top, rC, ue, ve)


def evp_inputs(model, state, dt, u_start, v_start):
    """(params, consts, carry, P) of the whole-array substep loop: the
    constants prepared on padded arrays (correct halos) and cropped to
    contiguous interiors, as `pallas_evp.py:354-438` does, and the padded
    ice strength P for the state.  The carry tensors are fresh copies."""
    grid = model.grid
    dt = grid.scalar(dt)
    I = grid.interior
    (P_pad, Pff_pad, gcc, gff, drag_u, invm_u, act_u,
     drag_v, invm_v, act_v) = evp_coefficients(model, state, dt)
    consts = tuple(I(q).contiguous() for q in (
        P_pad, Pff_pad, gcc, gff, drag_u, invm_u, act_u, u_start,
        drag_v, invm_v, act_v, v_start))
    carry = carry_inputs(model, state, u_start, v_start)
    return periodic_params(model, dt), consts, carry, P_pad


def carry_inputs(model, state, u_start, v_start):
    """Fresh contiguous interior copies of (u, v, σ₁₁, σ₂₂, σ₁₂, α)."""
    I = model.grid.interior
    return tuple(I(q).clone(memory_format=torch.contiguous_format)
                 for q in (u_start, v_start, state.sig11, state.sig22, state.sig12,
                           state.alpha))


def fused_split_explicit_momentum_step(model, state, dt, u_start, v_start):
    """Run the whole substep loop, returning the same update dict as the
    general `split_explicit_momentum_step`.  Up to ``_MAX_POINTS_RICH``
    points through :func:`evp_substeps` (2.1), above them through
    :func:`.fused_evp_tiled.tiled_evp_substeps` (2.2), as
    `pallas_evp.py:440-466` switches.  Like the JAX launcher it leaves
    ``Delta``, ``zeta_cc`` and ``zeta_ff`` as they were."""
    grid = model.grid
    nsub = model.dynamics.solver.substeps
    if grid.Nx * grid.Ny <= _MAX_POINTS_RICH:
        params, consts, carry, P_pad = evp_inputs(model, state, dt, u_start, v_start)
        with span("seaice.evp"):
            out = evp_substeps(params, consts, carry, nsub)
    else:
        from .fused_evp_tiled import tiled_evp_inputs, tiled_evp_substeps
        params, inputs, carry, P_pad = tiled_evp_inputs(model, state, dt, u_start, v_start)
        with span("seaice.evp"):
            out = tiled_evp_substeps(params, *inputs, carry, nsub)
    u_i, v_i, s11_i, s22_i, s12_i, al_i = out

    def repad(filler, q_int, old):
        with span("seaice.fill"):
            q = old.clone()
            q[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny] = q_int
            return filler(q, grid)

    return dict(u=repad(fill_halos_fc, u_i, state.u),
                v=repad(fill_halos_cf, v_i, state.v),
                sig11=repad(fill_halos_cc, s11_i, state.sig11),
                sig22=repad(fill_halos_cc, s22_i, state.sig22),
                sig12=repad(fill_halos_ff, s12_i, state.sig12),
                alpha=repad(fill_halos_cc, al_i, state.alpha),
                P=P_pad, un=u_start, vn=v_start,
                Delta=state.Delta, zeta_cc=state.zeta_cc, zeta_ff=state.zeta_ff)
