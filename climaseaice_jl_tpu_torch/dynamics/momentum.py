"""Momentum equations: tendencies and the split-explicit αEVP solver.

Counterpart of `climaseaice_jl_tpu/dynamics/momentum.py`.  This is the
general path: plain tensor code that runs on either device, for
``SplitExplicitSolver(fused="never")`` and for configurations the fused EVP
kernels do not take (:func:`~.fused_evp.fused_available`).  The substep
loop is a Python loop; odd substeps update v then u, even substeps u then v.

On a shard's grid the halo policy decides the velocity fills of the loop
(`momentum.py:489-534`).  Under 'per_substep' with an αEVP rheology, no
free drift, halos of at least 4 along the split directions and no fold
split across x (:func:`local_loop_ok`), both half-updates fill locally and
one joint u, v exchange (:func:`..fields.fill_halos_uv`) ends each substep
and precedes the loop: the deferred form, half the exchange rounds of one a
half-update, with the same interiors (a halo cell the substep computes is
the neighbour's value to a depth of H − 4).  Elsewhere 'per_substep' keeps
the exchanging fills.  Under 'wide' the fills are local, the halos having
been widened and exchanged once before the step.  Under 'overlap' (where
the gate holds with halos of at least 5 and shards of at least
``_BAND_W`` points along the split directions; else the exchanging fills)
each substep posts the joint exchange, runs the whole shard on the arrays
from before it, waits, and runs the substep again on a (2H + 8)-wide band
at each split edge with the fresh halos, whose H + 4 edge cells replace the
whole shard's (`momentum.py:345-470, 548-604`).

Immersed boundaries enter as in the JAX package: σ is zeroed at solid cc
and peripheral ff nodes before the divergence, velocities on peripheral
nodes, and an :class:`ImmersedDrag` or :class:`ImmersedStressBC` adds a
boundary flux on the faces of immersed (not wall) ff nodes.

:class:`ExplicitSolver` makes one semi-implicit velocity update a step
(:func:`explicit_momentum_step`, without the peripheral mask, as in the
JAX package).  Marginal ice (mass or concentration under the dynamics'
minimums but above machine epsilon) takes the free-drift velocity
(:mod:`.free_drift`), and a model's user forcing of ``u`` and ``v`` adds
to the tendencies.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import frozen_dataclass
from ..ops import ixf, iyf, shift_m
from ..fields import (fill_halos_fc, fill_halos_cf, fill_halos_many, fill_halos_fc_local,
                      fill_halos_cf_local, fill_halos_uv, start_fill_halos_uv,
                      finish_fill_halos_uv, _meshed)
from ..state import ModelFields
from .coriolis import x_f_cross_U, y_f_cross_U
from .stresses import (explicit_tau_x, explicit_tau_y,
                       implicit_tau_x_coefficient, implicit_tau_y_coefficient)
from .free_drift import free_drift_u, free_drift_v
from .rheologies import (ElastoViscoPlasticRheology, ice_strength,
                         compute_evp_viscosities, compute_evp_stresses,
                         stress_divergence, strain_rates,
                         rheology_forcing_u, rheology_forcing_v)

_FUSED_MODES = ("auto", "always", "never")
_HALO_POLICIES = ("per_substep", "wide", "overlap")


@dataclasses.dataclass(frozen=True)
class ExplicitSolver:
    """One semi-implicit velocity update per step."""


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
    ignore it, as the JAX package does.

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


def _inv(x, ok):
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), 0.0)


def _user_forcing(model, comp, grid, clock, fields):
    """The model's forcing of ``comp`` (``f(grid, clock, fields)``), or None."""
    f = model.forcing_dict().get(comp)
    return None if f is None else f(grid, clock, fields)


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
        dyn.rheology, grid, fields, masks=(masks.solid_cc, masks.per_ff), clock=clock)

    inv_m_fc = _inv(m_fc, m_fc > 0)
    inv_m_cf = _inv(m_cf, m_cf > 0)

    # user forcing plus the EVP convergence forcing (zero for other
    # rheologies); without user forcing the rheology's term alone
    Fu = rheology_forcing_u(dyn.rheology, grid, dt, fields)
    Fv = rheology_forcing_v(dyn.rheology, grid, dt, fields)
    user_u = _user_forcing(model, "u", grid, clock, fields)
    user_v = _user_forcing(model, "v", grid, clock, fields)
    if user_u is not None:
        Fu = user_u + Fu
    if user_v is not None:
        Fv = user_v + Fv

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


# --- explicit solver -----------------------------------------------------------

def explicit_momentum_step(model, state, fields, dt, u_prev, v_prev):
    """Returns (u, v) after one explicit semi-implicit update."""
    dyn = model.dynamics
    grid = model.grid
    clock = state.clock

    Gu, Gv = velocity_tendencies(model, dyn, grid, dt, fields, clock)

    m_cc = fields.h * fields.a * fields.rho
    a_fc, m_fc = ixf(fields.a), ixf(m_cc)
    a_cf, m_cf = iyf(fields.a), iyf(m_cc)

    top, bottom = dyn.top_momentum_stress, dyn.bottom_momentum_stress
    tau_ui = (implicit_tau_x_coefficient(grid, bottom, clock, fields)
              - implicit_tau_x_coefficient(grid, top, clock, fields)) * _inv(m_fc, m_fc > 0) * a_fc
    tau_vi = (implicit_tau_y_coefficient(grid, bottom, clock, fields)
              - implicit_tau_y_coefficient(grid, top, clock, fields)) * _inv(m_cf, m_cf > 0) * a_cf
    tau_ui = torch.where(m_fc <= 0, 0.0, tau_ui)
    tau_vi = torch.where(m_cf <= 0, 0.0, tau_vi)

    uD = (u_prev + dt * Gu) / (1 + dt * tau_ui)
    vD = (v_prev + dt * Gv) / (1 + dt * tau_vi)
    uF = free_drift_u(grid, dyn.free_drift, clock, fields)
    vF = free_drift_v(grid, dyn.free_drift, clock, fields)

    # no peripheral mask here: the JAX package's explicit update has none
    # (`momentum.py:244-246`)
    u = _masked_velocity(grid, uD, uF, m_fc, a_fc,
                         dyn.minimum_mass, dyn.minimum_concentration, None)
    v = _masked_velocity(grid, vD, vF, m_cf, a_cf,
                         dyn.minimum_mass, dyn.minimum_concentration, None)
    return fill_halos_fc(u, grid), fill_halos_cf(v, grid)


# --- split-explicit solver -------------------------------------------------------

def _make_evp_substep(model, state, dt, clock, P, un, vn, halo_u, halo_v):
    """One substep as a closure: ``one(u, v, s11, s22, s12, alpha, Delta,
    zcc, zff, substep) -> (u, v, s11, s22, s12, alpha, Delta, zcc, zff)``.
    With the αEVP rheology it relaxes σ first and its velocity updates take
    Δτ = Δt/ᾱ; with another rheology σ, α and the viscosities pass through,
    Δτ = Δt/substeps and each half-update forms its own stress divergence."""
    dyn = model.dynamics
    rheo = dyn.rheology
    grid = model.grid
    masks = model.masks
    h, a = state.h, state.a
    rho = grid.scalar(model.sea_ice_density).broadcast_to(grid.shape)
    is_evp = isinstance(rheo, ElastoViscoPlasticRheology)

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

    def free_drift(f, comp):
        if dyn.free_drift is None:
            return zeros
        fd = free_drift_u if comp == "u" else free_drift_v
        return fd(grid, dyn.free_drift, clock, f)

    def u_step(u, v, s11, s22, s12, alpha, div):
        f = fields_of(u, v, s11, s22, s12, alpha)
        dtau = dt / ixf(alpha) if is_evp else dt / dyn.solver.substeps
        Gu, _ = velocity_tendencies(model, dyn, grid, dtau, f, clock, div=div)
        tau_ui = (implicit_tau_x_coefficient(grid, bottom, clock, f)
                  - implicit_tau_x_coefficient(grid, top, clock, f)
                  ) * _inv(m_fc, m_fc > 0) * a_fc
        tau_ui = torch.where(m_fc <= 0, 0.0, tau_ui)
        uD = (u + dtau * Gu) / (1 + dtau * tau_ui)
        u_new = _masked_velocity(grid, uD, free_drift(f, "u"), m_fc, a_fc, dyn.minimum_mass,
                                 dyn.minimum_concentration, active_u)
        return halo_u(u_new)

    def v_step(u, v, s11, s22, s12, alpha, div):
        f = fields_of(u, v, s11, s22, s12, alpha)
        dtau = dt / iyf(alpha) if is_evp else dt / dyn.solver.substeps
        _, Gv = velocity_tendencies(model, dyn, grid, dtau, f, clock, div=div)
        tau_vi = (implicit_tau_y_coefficient(grid, bottom, clock, f)
                  - implicit_tau_y_coefficient(grid, top, clock, f)
                  ) * _inv(m_cf, m_cf > 0) * a_cf
        tau_vi = torch.where(m_cf <= 0, 0.0, tau_vi)
        vD = (v + dtau * Gv) / (1 + dtau * tau_vi)
        v_new = _masked_velocity(grid, vD, free_drift(f, "v"), m_cf, a_cf, dyn.minimum_mass,
                                 dyn.minimum_concentration, active_v)
        return halo_v(v_new)

    def one(u, v, s11, s22, s12, alpha, Delta, zcc, zff, substep):
        div = None
        if is_evp:
            strains = strain_rates(grid, u, v)
            Delta, zcc, zff = compute_evp_viscosities(rheo, grid, u, v, P,
                                                      strains=strains)
            s11, s22, s12, alpha = compute_evp_stresses(
                rheo, grid, u, v, h, a, rho, dt, s11, s22, s12,
                Delta, zcc, zff, P, strains=strains)
            div = stress_divergence(rheo, grid, fields_of(u, v, s11, s22, s12, alpha),
                                    masks=(masks.solid_cc, masks.per_ff), clock=clock)
        if substep % 2 == 0:
            u = u_step(u, v, s11, s22, s12, alpha, div)
            v = v_step(u, v, s11, s22, s12, alpha, div)
        else:
            v = v_step(u, v, s11, s22, s12, alpha, div)
            u = u_step(u, v, s11, s22, s12, alpha, div)
        return (u, v, s11, s22, s12, alpha, Delta, zcc, zff)

    return one


# --- the loop's exchanges on a shard ---------------------------------------------

_BAND_W = 8   # interior cells per boundary band: the merge region takes the
              # substep's stencil depth of 4 cells, whose own stencil reads 4 more

def local_loop_ok(model, h_min):
    """The JAX package's gate of the substep loop's local fills on a shard
    (`momentum.py:500-511`): a grid split along some direction, an αEVP
    rheology (the stencil budget is counted for it), no free drift, halos of
    at least ``h_min`` along the split directions, and no fold split across
    x (local fills cannot refresh it)."""
    dyn, grid = model.dynamics, model.grid
    return ((_meshed(grid, 0) or _meshed(grid, 1))
            and isinstance(dyn.rheology, ElastoViscoPlasticRheology)
            and dyn.free_drift is None
            and (not _meshed(grid, 0) or grid.Hx >= h_min)
            and (not _meshed(grid, 1) or grid.Hy >= h_min)
            and not (grid.north_fold and _meshed(grid, 0)))


def loop_form(model):
    """How the split-explicit loop fills u and v on ``model``'s grid:
    "deferred" (local fills, one joint exchange a substep), "overlap" (that
    exchange posted before the whole-shard pass and waited before the edge
    bands), "local" (the 'wide' policy, or a serial grid) or "exchanging"
    (an exchange a half-update)."""
    grid, solver = model.grid, model.dynamics.solver
    if solver.halo_exchange == "per_substep" and local_loop_ok(model, 4):
        return "deferred"
    if (solver.halo_exchange == "overlap" and local_loop_ok(model, 5)
            and (not _meshed(grid, 0) or grid.Nx >= _BAND_W)
            and (not _meshed(grid, 1) or grid.Ny >= _BAND_W)):
        return "overlap"
    if solver.halo_exchange == "wide" or not (_meshed(grid, 0) or _meshed(grid, 1)):
        return "local"
    return "exchanging"


def _band_slicer(grid, dim, side):
    """(cut, paste) for a (2H + _BAND_W)-cell band at one edge of direction
    ``dim`` (`momentum.py:356-381`); ``paste`` gives the whole array with its
    H + 4 edge cells (the halo and the 4 interior cells the pass on the
    arrays from before the exchange got wrong) taken from the band."""
    H = grid.Hx if dim == 0 else grid.Hy
    n = grid.nxp if dim == 0 else grid.nyp
    ext, mw = 2 * H + _BAND_W, H + 4
    start = 0 if side == 0 else n - ext
    keep = slice(0, mw) if side == 0 else slice(n - mw, n)
    from_band = slice(0, mw) if side == 0 else slice(ext - mw, ext)

    def cut(q):
        if not isinstance(q, torch.Tensor) or q.dim() == 0:
            return q
        return q[start:start + ext] if dim == 0 else q[:, start:start + ext]

    def paste(full, band):
        full = full.clone()
        if dim == 0:
            full[keep] = band[from_band]
        else:
            full[:, keep] = band[:, from_band]
        return full

    return cut, paste


def _band_submodel(model, dim, side):
    """The model on one boundary band (`momentum.py:384-445`): the grid's
    coordinates, metrics, land and masks cut to the band, array stresses
    cut, StressFunctions evaluated again on the band grid's coordinates.  A
    south or west band's far edge, which is no edge, gets wall or fold
    treatment from the local fills only at band cells at least H + _BAND_W
    deep, outside every read of the merge region; a south band's north edge
    is not the fold."""
    from ..grids import _METRIC_LOCS
    from .stresses import StressFunction, SemiImplicitStress
    grid = model.grid
    cut, paste = _band_slicer(grid, dim, side)
    n = grid.nxp if dim == 0 else grid.nyp
    ext = 2 * (grid.Hx if dim == 0 else grid.Hy) + _BAND_W
    start = 0 if side == 0 else n - ext

    def cut_m(m):
        if not isinstance(m, torch.Tensor) or m.dim() == 0:
            return m
        if tuple(m.shape) == grid.shape:
            return cut(m)
        if m.dim() == 2 and m.shape[0] == 1:      # (1, nyp) latitude row
            return cut(m) if dim == 1 else m
        raise NotImplementedError(f"band slice of metric shape {tuple(m.shape)}")

    def cut1(c):
        return c[start:start + ext]

    kw = dict(solid_cc=cut_m(grid.solid_cc), lon_cc=cut_m(grid.lon_cc),
              lat_cc=cut_m(grid.lat_cc), **{f: cut_m(getattr(grid, f)) for f in _METRIC_LOCS})
    if dim == 0:
        g = grid.evolve(Nx=_BAND_W, xc=cut1(grid.xc), xf=cut1(grid.xf), **kw)
    else:
        g = grid.evolve(Ny=_BAND_W, yc=cut1(grid.yc), yf=cut1(grid.yf),
                        north_fold=grid.north_fold and side == 1, **kw)
    m = model.masks
    bmasks = m.evolve(**{f: cut_m(getattr(m, f)) for f in (
        "solid_cc", "per_fc", "per_cf", "per_ff", "imm_ff", "solid_full")})

    def cut_s(x):
        if isinstance(x, torch.Tensor) and x.dim() == 2:
            return cut(x)
        return x

    dyn = model.dynamics
    top = dyn.top_momentum_stress
    top = {k: cut_s(x) for k, x in top.items()} if isinstance(top, dict) else cut_s(top)
    bottom = dyn.bottom_momentum_stress
    if isinstance(bottom, SemiImplicitStress):
        bottom = dataclasses.replace(bottom, ue=cut_s(bottom.ue), ve=cut_s(bottom.ve))
    elif not isinstance(bottom, StressFunction):
        bottom = ({k: cut_s(x) for k, x in bottom.items()} if isinstance(bottom, dict)
                  else cut_s(bottom))
    bdyn = dataclasses.replace(dyn, top_momentum_stress=top, bottom_momentum_stress=bottom)
    return model.evolve(grid=g, masks=bmasks, dynamics=bdyn), cut, paste


def _make_bands(model, state, dt, clock, P, un, vn):
    """One substep closure (:func:`_make_evp_substep`) per split edge, on
    its band's model with local fills (`momentum.py:448-470`)."""
    grid = model.grid
    bands = []
    for dim in (0, 1):
        if not _meshed(grid, dim):
            continue
        for side in (0, 1):
            bmodel, cut, paste = _band_submodel(model, dim, side)
            g = bmodel.grid
            bstate = state.evolve(
                h=cut(state.h), a=cut(state.a), hs=cut(state.hs), S=cut(state.S),
                Tu=cut(state.Tu), Tus=cut(state.Tus),
                tracers={k: cut(q) for k, q in (state.tracers or {}).items()})
            one_b = _make_evp_substep(
                bmodel, bstate, dt, clock, cut(P), cut(un), cut(vn),
                lambda q, g=g: fill_halos_fc_local(q, g),
                lambda q, g=g: fill_halos_cf_local(q, g))
            bands.append((one_b, cut, paste))
    return bands


def split_explicit_momentum_step(model, state, dt, u_start, v_start):
    """N substeps of {αEVP stresses → alternating semi-implicit u/v}, or of
    the alternating updates alone for another rheology.  ``u_start``/
    ``v_start`` are the velocities the substeps start from (Ψ⁻ under RK3).
    The velocity fills follow :func:`loop_form`.  Returns a dict of updated
    state components: u and v, and with αEVP its auxiliary fields."""
    dyn = model.dynamics
    rheo = dyn.rheology
    grid = model.grid
    form = loop_form(model)
    local = form != "exchanging"
    fill_u, fill_v = ((fill_halos_fc_local, fill_halos_cf_local) if local
                      else (fill_halos_fc, fill_halos_cf))

    def halo_u(q):
        return fill_u(q, grid)

    def halo_v(q):
        return fill_v(q, grid)

    # initialize_rheology!: P over the full array incl. halos; snapshot uⁿ, vⁿ
    # (αEVP only)
    is_evp = isinstance(rheo, ElastoViscoPlasticRheology)
    P = ice_strength(rheo, state.h, state.a) if is_evp else None
    un, vn = u_start, v_start

    one = _make_evp_substep(model, state, dt, state.clock, P, un, vn,
                            halo_u, halo_v)
    bands = _make_bands(model, state, dt, state.clock, P, un, vn) if form == "overlap" else ()

    zeros = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)

    def _or_zeros(q):
        return q if q is not None else zeros

    u0, v0 = (fill_halos_uv(u_start, v_start, grid) if form == "deferred"
              else (halo_u(u_start), halo_v(v_start)))
    carry = (u0, v0, _or_zeros(state.sig11),
             _or_zeros(state.sig22), _or_zeros(state.sig12),
             _or_zeros(state.alpha), _or_zeros(state.Delta),
             _or_zeros(state.zeta_cc), _or_zeros(state.zeta_ff))
    for substep in range(1, dyn.solver.substeps + 1):
        if form == "overlap":
            # post the exchange, run the whole shard on the arrays from
            # before it (exact 4 cells in from a split edge), wait, and
            # recompute each edge's merge region on its band
            pending = start_fill_halos_uv(carry[0], carry[1], grid)
            out = one(*carry, substep)
            u_ex, v_ex = finish_fill_halos_uv(pending)
            for one_b, cut, paste in bands:
                b = one_b(cut(u_ex), cut(v_ex), *(cut(q) for q in carry[2:]), substep)
                out = tuple(paste(o, q) for o, q in zip(out, b))
            carry = out
        elif form == "deferred":
            out = one(*carry, substep)
            carry = fill_halos_uv(out[0], out[1], grid) + out[2:]
        else:
            carry = one(*carry, substep)
    u, v, s11, s22, s12, alpha, Delta, zcc, zff = carry
    if form == "overlap":
        # the loop carries stale halos along the split directions
        u, v = fill_halos_uv(u, v, grid)
    if not is_evp:
        return dict(u=u, v=v)

    # finalize_rheology!: σ halo refresh
    s11, s22, s12 = fill_halos_many((s11, s22, s12), ("cc", "cc", "ff"), grid)

    return dict(u=u, v=v, sig11=s11, sig22=s22, sig12=s12, alpha=alpha,
                P=P, un=un, vn=vn, Delta=Delta, zeta_cc=zcc, zeta_ff=zff)
