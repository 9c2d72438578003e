"""Momentum equations: tendencies and the split-explicit αEVP solver.

Counterpart of `climaseaice_jl_tpu/dynamics/momentum.py`.  This is the
general path: plain tensor code that runs on either device, for
``SplitExplicitSolver(fused="never")`` and for configurations the fused EVP
kernels do not take (:func:`~.fused_evp.fused_available`).  The substep
loop is a Python loop; odd substeps update v then u, even substeps u then v.

On a shard's grid the halo policy decides the velocity fills of the loop
(`momentum.py:489-534`): under 'per_substep' they are the exchanging fills,
one exchange a half-update; under 'wide' the local fills, the halos having
been widened and exchanged once before the step.  The JAX package's
deferred form of 'per_substep' (local fills within a substep and one joint
u, v exchange at its end, which gives the same interiors) and the
'overlap' policy are not ported (queue 9).

Immersed boundaries enter as in the JAX package: σ is zeroed at solid cc
and peripheral ff nodes before the divergence, velocities on peripheral
nodes, and an :class:`ImmersedDrag` or :class:`ImmersedStressBC` adds a
boundary flux on the faces of immersed (not wall) ff nodes.
``ExplicitSolver``, free drift and user forcing belong to a later slice
(queue 7).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import frozen_dataclass
from ..ops import ixf, iyf, shift_m
from ..fields import (fill_halos_fc, fill_halos_cf, fill_halos_many, fill_halos_fc_local,
                      fill_halos_cf_local)
from ..state import ModelFields
from .coriolis import x_f_cross_U, y_f_cross_U
from .stresses import (explicit_tau_x, explicit_tau_y,
                       implicit_tau_x_coefficient, implicit_tau_y_coefficient)
from .rheologies import (ElastoViscoPlasticRheology, ice_strength,
                         compute_evp_viscosities, compute_evp_stresses,
                         stress_divergence, strain_rates,
                         rheology_forcing_u, rheology_forcing_v)

_FUSED_MODES = ("auto", "always", "never")
_HALO_POLICIES = ("per_substep", "wide", "overlap")


@dataclasses.dataclass(frozen=True)
class SplitExplicitSolver:
    """N pseudo-time substeps per step.

    ``fused``: 'auto' and 'always' take the fused EVP route
    (:mod:`.fused_evp`: the CUDA kernel on CUDA tensors, its plain version on
    CPU tensors) when the configuration allows it; 'never' keeps the general
    path.

    ``halo_exchange``: the distributed halo policy of the JAX package
    ('per_substep', 'wide' or 'overlap'; `momentum.py:56-61, 489-534`).
    Only shards read it (:mod:`..parallel.stepper`); serial runs accept and
    ignore it, as the JAX package does.  'overlap' raises on a shard
    (queue 9).

    ``fixed_tiles=(TX, TY)`` (``TY=None``: y-spanning slabs) selects the
    decomposition-invariant mode: the EVP coefficients, the EVP substep loop,
    the tracer advection and the slab thermodynamics go through the
    fixed-tile kernels, whose per-point arithmetic does not depend on the
    array shape, the halo width or the launch geometry."""
    substeps: int = 120
    fused: str = "auto"
    halo_exchange: str = "per_substep"
    fixed_tiles: tuple | None = None

    def __post_init__(self):
        if self.fused not in _FUSED_MODES:
            raise ValueError(f"fused must be one of {_FUSED_MODES}, got {self.fused!r}")
        if self.halo_exchange not in _HALO_POLICIES:
            raise ValueError(f"halo_exchange must be one of {_HALO_POLICIES}, "
                             f"got {self.halo_exchange!r}")
        if self.fixed_tiles is not None:
            tiles = tuple(self.fixed_tiles)
            if (len(tiles) != 2 or not isinstance(tiles[0], int) or tiles[0] < 1
                    or not (tiles[1] is None or (isinstance(tiles[1], int) and tiles[1] >= 1))):
                raise ValueError(f"fixed_tiles must be (TX, TY) with positive integers "
                                 f"(TY may be None), got {self.fixed_tiles!r}")
            object.__setattr__(self, "fixed_tiles", tiles)


@frozen_dataclass
class ImmersedDrag:
    """Linear drag flux −C·u through the faces next to immersed (land)
    cells."""
    coefficient: object = 3e-3


@frozen_dataclass
class ImmersedStressBC:
    """General immersed flux boundary conditions on the stress divergence:
    ``u_flux``/``v_flux`` are callables ``f(grid, clock, fields[,
    parameters])`` returning the boundary flux sampled at every node.  The
    immersed stress divergence applies them on the faces whose (f,f) node is
    immersed, weighted by the face length; :class:`ImmersedDrag` is the case
    ``flux = −C·u``."""
    u_flux: object = None
    v_flux: object = None
    parameters: object = None


def _immersed_flux_values(imm, grid, clock, fields):
    """(Fu, Fv): boundary flux arrays for the immersed stress divergence."""
    if isinstance(imm, ImmersedDrag):
        return -imm.coefficient * fields.u, -imm.coefficient * fields.v
    zeros = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)

    def ev(f):
        if f is None:
            return zeros
        if imm.parameters is None:
            return f(grid, clock, fields)
        return f(grid, clock, fields, imm.parameters)

    return ev(imm.u_flux), ev(imm.v_flux)


@frozen_dataclass
class SeaIceMomentumEquation:
    """Dynamics container."""
    rheology: object = None
    coriolis: object = None
    solver: object = dataclasses.field(default_factory=lambda: SplitExplicitSolver(150))
    top_momentum_stress: object = None
    bottom_momentum_stress: object = None
    free_drift: object = None
    immersed_drag: object = None
    minimum_concentration: object = 1e-3
    minimum_mass: object = 1.0   # kg m⁻²

    def __post_init__(self):
        if self.rheology is None:
            object.__setattr__(self, "rheology", ElastoViscoPlasticRheology())
        if not isinstance(self.rheology, ElastoViscoPlasticRheology):
            raise NotImplementedError("only the αEVP rheology is ported yet "
                                      "(ViscousRheology: queue 7)")
        if not isinstance(self.solver, SplitExplicitSolver):
            raise NotImplementedError("only SplitExplicitSolver is ported yet "
                                      "(ExplicitSolver: queue 7)")
        if self.free_drift is not None:
            raise NotImplementedError("free drift belongs to a later slice of "
                                      "the port (queue 7)")


def _inv(x, ok):
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), 0.0)


def velocity_tendencies(model, dyn, grid, dt, fields, clock, div=None):
    """(Gu, Gv).  ``dt`` may be a scalar or a per-point tensor (the EVP
    substep Δτ).  ``div``: optional precomputed ``(div_x, div_y)``."""
    masks = model.masks
    m_cc = fields.h * fields.a * fields.rho
    a_fc = ixf(fields.a)
    m_fc = ixf(m_cc)
    a_cf = iyf(fields.a)
    m_cf = iyf(m_cc)

    div_x, div_y = div if div is not None else stress_divergence(
        dyn.rheology, grid, fields, masks=(masks.solid_cc, masks.per_ff))

    inv_m_fc = _inv(m_fc, m_fc > 0)
    inv_m_cf = _inv(m_cf, m_cf > 0)

    Fu = rheology_forcing_u(dyn.rheology, grid, dt, fields)
    Fv = rheology_forcing_v(dyn.rheology, grid, dt, fields)

    top, bottom = dyn.top_momentum_stress, dyn.bottom_momentum_stress

    Gu = (-x_f_cross_U(dyn.coriolis, grid, fields.u, fields.v)
          - explicit_tau_x(grid, top, clock, fields) * inv_m_fc * a_fc
          + explicit_tau_x(grid, bottom, clock, fields) * inv_m_fc * a_fc
          + div_x * inv_m_fc
          + Fu)
    Gv = (-y_f_cross_U(dyn.coriolis, grid, fields.u, fields.v)
          - explicit_tau_y(grid, top, clock, fields) * inv_m_cf * a_cf
          + explicit_tau_y(grid, bottom, clock, fields) * inv_m_cf * a_cf
          + div_y * inv_m_cf
          + Fv)

    if dyn.immersed_drag is not None and masks.imm_ff is not None:
        # immersed ∂ⱼσᵢⱼ: for the u point the flux through its south and
        # north (f,f) faces, (qᴺ + qˢ)/Az with q = flux·Δx_ff sampled at each
        # face's own index, on immersed faces only; east/west for v
        Fu, Fv = _immersed_flux_values(dyn.immersed_drag, grid, clock, fields)
        wx = torch.where(masks.imm_ff, grid.dx_ff.broadcast_to(grid.shape), 0.0)
        wy = torch.where(masks.imm_ff, grid.dy_ff.broadcast_to(grid.shape), 0.0)
        imm_x = (shift_m(Fu * wx, 1) + Fu * wx) / grid.az_fc
        imm_y = (shift_m(Fv * wy, 0) + Fv * wy) / grid.az_cf
        Gu = Gu + imm_x * inv_m_fc
        Gv = Gv + imm_y * inv_m_cf

    Gu = torch.where(m_fc <= 0, 0.0, Gu)
    Gv = torch.where(m_cf <= 0, 0.0, Gv)
    return Gu, Gv


def _masked_velocity(grid, uD, uF, m, a, minimum_mass, minimum_concentration, active):
    """3-state select: dynamic / free-drift / zero, then peripheral masking."""
    eps_ = torch.finfo(grid.dtype).eps
    marginal = (m > eps_) & (a > eps_)
    active_ice = (m >= minimum_mass) & (a >= minimum_concentration)
    u_new = torch.where(active_ice, uD, torch.where(marginal, uF, 0.0))
    if active is not None:
        u_new = torch.where(active, u_new, 0.0)
    return u_new


# --- split-explicit αEVP solver ----------------------------------------------

def _make_evp_substep(model, state, dt, clock, P, un, vn, halo_u, halo_v):
    """One αEVP substep as a closure: ``one(u, v, s11, s22, s12, alpha,
    Delta, zcc, zff, substep) -> (u, v, s11, s22, s12, alpha, Delta, zcc,
    zff)``."""
    dyn = model.dynamics
    rheo = dyn.rheology
    grid = model.grid
    masks = model.masks
    h, a = state.h, state.a
    rho = grid.scalar(model.sea_ice_density).broadcast_to(grid.shape)

    m_cc = h * a * rho
    a_fc, m_fc = ixf(a), ixf(m_cc)
    a_cf, m_cf = iyf(a), iyf(m_cc)
    active_u = None if masks.per_fc is None else ~masks.per_fc
    active_v = None if masks.per_cf is None else ~masks.per_cf
    top, bottom = dyn.top_momentum_stress, dyn.bottom_momentum_stress
    zeros = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)

    def fields_of(u, v, s11, s22, s12, alpha):
        return ModelFields(h=h, a=a, S=state.S, hs=state.hs, u=u, v=v,
                           Tu=state.Tu, Tus=state.Tus, rho=rho,
                           sig11=s11, sig22=s22, sig12=s12,
                           un=un, vn=vn, P=P, alpha=alpha,
                           tracers=state.tracers)

    def u_step(u, v, s11, s22, s12, alpha, div):
        f = fields_of(u, v, s11, s22, s12, alpha)
        dtau = dt / ixf(alpha)
        Gu, _ = velocity_tendencies(model, dyn, grid, dtau, f, clock, div=div)
        tau_ui = (implicit_tau_x_coefficient(grid, bottom, clock, f)
                  - implicit_tau_x_coefficient(grid, top, clock, f)
                  ) * _inv(m_fc, m_fc > 0) * a_fc
        tau_ui = torch.where(m_fc <= 0, 0.0, tau_ui)
        uD = (u + dtau * Gu) / (1 + dtau * tau_ui)
        u_new = _masked_velocity(grid, uD, zeros, m_fc, a_fc, dyn.minimum_mass,
                                 dyn.minimum_concentration, active_u)
        return halo_u(u_new)

    def v_step(u, v, s11, s22, s12, alpha, div):
        f = fields_of(u, v, s11, s22, s12, alpha)
        dtau = dt / iyf(alpha)
        _, Gv = velocity_tendencies(model, dyn, grid, dtau, f, clock, div=div)
        tau_vi = (implicit_tau_y_coefficient(grid, bottom, clock, f)
                  - implicit_tau_y_coefficient(grid, top, clock, f)
                  ) * _inv(m_cf, m_cf > 0) * a_cf
        tau_vi = torch.where(m_cf <= 0, 0.0, tau_vi)
        vD = (v + dtau * Gv) / (1 + dtau * tau_vi)
        v_new = _masked_velocity(grid, vD, zeros, m_cf, a_cf, dyn.minimum_mass,
                                 dyn.minimum_concentration, active_v)
        return halo_v(v_new)

    def one(u, v, s11, s22, s12, alpha, Delta, zcc, zff, substep):
        strains = strain_rates(grid, u, v)
        Delta, zcc, zff = compute_evp_viscosities(rheo, grid, u, v, P,
                                                  strains=strains)
        s11, s22, s12, alpha = compute_evp_stresses(
            rheo, grid, u, v, h, a, rho, dt, s11, s22, s12,
            Delta, zcc, zff, P, strains=strains)
        div = stress_divergence(rheo, grid, fields_of(u, v, s11, s22, s12, alpha),
                                masks=(masks.solid_cc, masks.per_ff))
        if substep % 2 == 0:
            u = u_step(u, v, s11, s22, s12, alpha, div)
            v = v_step(u, v, s11, s22, s12, alpha, div)
        else:
            v = v_step(u, v, s11, s22, s12, alpha, div)
            u = u_step(u, v, s11, s22, s12, alpha, div)
        return (u, v, s11, s22, s12, alpha, Delta, zcc, zff)

    return one


def split_explicit_momentum_step(model, state, dt, u_start, v_start):
    """N substeps of {αEVP stresses → alternating semi-implicit u/v}.
    ``u_start``/``v_start`` are the velocities the substeps start from (Ψ⁻
    under RK3).  Returns a dict of updated state components."""
    dyn = model.dynamics
    rheo = dyn.rheology
    grid = model.grid
    # on a serial grid the local fills are the fills
    fill_u, fill_v = ((fill_halos_fc_local, fill_halos_cf_local)
                      if dyn.solver.halo_exchange == "wide" else (fill_halos_fc, fill_halos_cf))

    def halo_u(q):
        return fill_u(q, grid)

    def halo_v(q):
        return fill_v(q, grid)

    # initialize_rheology!: P over the full array incl. halos; snapshot uⁿ, vⁿ
    P = ice_strength(rheo, state.h, state.a)
    un, vn = u_start, v_start

    one = _make_evp_substep(model, state, dt, state.clock, P, un, vn,
                            halo_u, halo_v)

    zeros = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)

    def _or_zeros(q):
        return q if q is not None else zeros

    carry = (halo_u(u_start), halo_v(v_start), _or_zeros(state.sig11),
             _or_zeros(state.sig22), _or_zeros(state.sig12),
             _or_zeros(state.alpha), _or_zeros(state.Delta),
             _or_zeros(state.zeta_cc), _or_zeros(state.zeta_ff))
    for substep in range(1, dyn.solver.substeps + 1):
        carry = one(*carry, substep)
    u, v, s11, s22, s12, alpha, Delta, zcc, zff = carry

    # finalize_rheology!: σ halo refresh
    s11, s22, s12 = fill_halos_many((s11, s22, s12), ("cc", "cc", "ff"), grid)

    return dict(u=u, v=v, sig11=s11, sig22=s22, sig12=s12, alpha=alpha,
                P=P, un=un, vn=vn, Delta=Delta, zeta_cc=zcc, zeta_ff=zff)
