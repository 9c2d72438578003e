"""SeaIceModel: configuration, state factory, and the step functions
(Forward Euler and low-storage split RK3).

Counterpart of `climaseaice_jl_tpu/model.py`.  The model is an immutable
configuration, the state a separate dataclass of tensors, and
``step(model, state, dt) -> state`` a plain function that runs eagerly on
the grid's device.  The EVP substep loop of eligible models goes to a CUDA
kernel: grids with array metrics or a north fold to
:mod:`.dynamics.fused_evp_curvilinear`, doubly periodic rectilinear grids
without land to :mod:`.dynamics.fused_evp` (the whole-array loop up to
571,099 points, the tiled loop of :mod:`.dynamics.fused_evp_tiled` above,
where the JAX package switches too), other bounded or immersed rectilinear
ones to :mod:`.dynamics.fused_evp_padded`.  With
``SplitExplicitSolver(fixed_tiles=…)`` (the decomposition-invariant mode) a
model takes the fixed-tile kernels instead: on grids with array metrics or a
north fold the pinned curvilinear EVP loop with its ice strength
(:mod:`.dynamics.fused_evp_tiled_curvilinear`), on rectilinear ones the
tiled EVP loop (:mod:`.dynamics.fused_evp_tiled_padded`) with its
coefficient kernel; the advection of :mod:`.dynamics.fixed_tile_advection`
and the column physics of :mod:`.thermodynamics.fixed_tile_thermo`.  A
float32 model without ``fixed_tiles`` on the card advects its tracers with
that advection kernel too, on the whole grid.

The momentum dispatch follows the JAX package's order: a
:class:`StressBalanceFreeDrift` as the whole dynamics sets the velocities
to their closed form, an :class:`ExplicitSolver` makes one explicit update,
and only then do the split-explicit routes above apply.  A user
``forcing`` (``{name: f(grid, clock, fields)}``) adds to the tendencies of
the tracers and velocities it names; every fused EVP gate refuses it, as
JAX's gates do, while the fixed-tile advection and column kernels take it.
"""

from __future__ import annotations

import dataclasses

import torch

from .utils import frozen_dataclass
from .tracing import span, spanned
from .grids import Grid, south_crop_grid
from .state import SeaIceState, Clock, ModelFields
from .fields import (fill_halos_many, fill_halos_fc, fill_halos_cf, peripheral_masks,
                     immersed_only_ff, solid_cc_mask, _solid_base)
from .advection import horizontal_div_Uc, required_halo
from .thermodynamics.heat_bcs import PrescribedTemperature
from .thermodynamics.phase_transitions import PhaseTransitions
from .thermodynamics.slab import (sea_ice_slab_thermodynamics,
                                  bare_ice_thermodynamic_step, layered_thermodynamic_step)
from .dynamics.momentum import (ExplicitSolver, SplitExplicitSolver, explicit_momentum_step,
                                split_explicit_momentum_step)
from .dynamics.free_drift import StressBalanceFreeDrift, free_drift_u, free_drift_v
from .dynamics.rheologies import ElastoViscoPlasticRheology, ViscousRheology
from .dynamics.fused_evp import fused_available, fused_split_explicit_momentum_step
from .dynamics.fused_evp_padded import padded_fused_available, padded_fused_momentum_step
from .dynamics.fused_evp_curvilinear import (curvilinear_fused_available,
                                             curvilinear_fused_momentum_step,
                                             _solid_crop_rows)
from .dynamics.fused_evp_tiled_padded import (tiled_padded_available,
                                              tiled_padded_momentum_step)
from .dynamics.fused_evp_tiled_curvilinear import (tiled_curvilinear_available,
                                                   tiled_curvilinear_momentum_step)
from .dynamics.fixed_tile_advection import (fixed_tile_advection_available,
                                            make_fixed_tile_div, whole_grid_advection_available,
                                            make_whole_grid_div)
from .thermodynamics.slab import SlabThermodynamics
from .thermodynamics.fixed_tile_thermo import fixed_tile_thermo_step
from .dynamics.stresses import place_stress


@frozen_dataclass
class Masks:
    solid_cc: object = None
    per_fc: object = None
    per_cf: object = None
    per_ff: object = None
    # immersed-only peripheral ff nodes: gate the immersed stress-divergence
    # fluxes; None on grids without land
    imm_ff: object = None
    # count of southernmost interior rows that are solid across every x,
    # found once on the host at model build (the tendencies skip them)
    solid_rows: int = 0
    # the solid ∪ wall mask the peripheral masks come from (never None): the
    # fixed-tile curvilinear kernel derives its masks from it
    solid_full: object = None


@frozen_dataclass
class SeaIceModel:
    """Model configuration; state lives in a separate :class:`SeaIceState`
    created by :func:`initial_state`."""
    grid: Grid = None
    masks: Masks = None
    ice_thermodynamics: object = None
    snow_thermodynamics: object = None
    phase_transitions: object = None
    sea_ice_density: object = 900.0            # kg m⁻³ (bulk)
    snow_density: object = 330.0               # kg m⁻³ (bulk)
    ice_consolidation_thickness: object = 0.05  # m
    ice_salinity: object = 0.0                 # psu
    top_heat_flux: object = None
    bottom_heat_flux: object = 0.0
    snowfall: object = 0.0
    dynamics: object = None
    advection: object = None
    timestepper: str = "SplitRungeKutta3"
    forcing: object = None   # a sorted tuple of (name, f(grid, clock, fields))

    def forcing_dict(self):
        return dict(self.forcing) if self.forcing else {}


def sea_ice_model(grid: Grid,
                  ice_thermodynamics="default",
                  snow_thermodynamics=None,
                  phase_transitions=None,
                  sea_ice_density=900.0,
                  snow_density=330.0,
                  ice_consolidation_thickness=0.05,
                  ice_salinity=0.0,
                  top_heat_flux=None,
                  bottom_heat_flux=0.0,
                  snowfall=0.0,
                  dynamics=None,
                  advection=None,
                  timestepper="SplitRungeKutta3",
                  forcing=None):
    """Build a :class:`SeaIceModel` with the JAX package's defaults.
    ``forcing``: ``{name: f(grid, clock, fields)}`` for u, v, h, a, hs, S
    or a tracer's name; a name that matches none of the six warns, as in
    the JAX package."""
    if ice_thermodynamics == "default":
        ice_thermodynamics = sea_ice_slab_thermodynamics()
    if phase_transitions is None:
        phase_transitions = PhaseTransitions()

    # default top flux: equilibrium with the internal flux when the top
    # temperature is prescribed and there is no snow
    if ice_thermodynamics is not None and top_heat_flux is None:
        if (snow_thermodynamics is None
                and isinstance(ice_thermodynamics.top_heat_bc, PrescribedTemperature)):
            top_heat_flux = _equilibrium_top_flux(ice_thermodynamics, phase_transitions)
        else:
            top_heat_flux = 0.0

    per_fc, per_cf, per_ff = peripheral_masks(grid)
    solid_cc = solid_cc_mask(grid)
    masks = Masks(solid_cc=solid_cc, per_fc=per_fc, per_cf=per_cf, per_ff=per_ff,
                  imm_ff=immersed_only_ff(grid),
                  solid_rows=_solid_crop_rows(_solid_base(grid), grid), solid_full=solid_cc)

    if isinstance(snowfall, torch.Tensor) or hasattr(snowfall, "shape"):
        snowfall = torch.as_tensor(snowfall, dtype=grid.dtype, device=grid.device)

    if dynamics is not None:
        dynamics = _place_dynamics(dynamics, grid)

    if forcing is not None and not isinstance(forcing, tuple):
        unknown = set(forcing) - {"u", "v", "h", "a", "hs", "S"}
        if unknown:
            import warnings
            warnings.warn(f"forcing keys {sorted(unknown)} match no standard "
                          "prognostic (u, v, h, a, hs, S); they only apply if "
                          "a tracer of that name exists", stacklevel=2)
        forcing = tuple(sorted(forcing.items()))

    fixed_tiles(grid, dynamics)
    if advection is not None:
        need = required_halo(advection)
        if min(h for h in (grid.Hx, grid.Hy) if h > 0) < need:
            raise ValueError(
                f"advection scheme needs halo ≥ {need}; grid has ({grid.Hx}, {grid.Hy})")

    return SeaIceModel(grid=grid, masks=masks,
                       ice_thermodynamics=ice_thermodynamics,
                       snow_thermodynamics=snow_thermodynamics,
                       phase_transitions=phase_transitions,
                       sea_ice_density=sea_ice_density,
                       snow_density=snow_density,
                       ice_consolidation_thickness=ice_consolidation_thickness,
                       ice_salinity=ice_salinity,
                       top_heat_flux=top_heat_flux,
                       bottom_heat_flux=bottom_heat_flux,
                       snowfall=snowfall,
                       dynamics=dynamics,
                       advection=advection,
                       timestepper=timestepper,
                       forcing=forcing or None)


def _place_dynamics(dynamics, grid):
    """``dynamics`` with its array-valued stresses (and a free drift's, and
    an array viscosity) on the grid device once, so that the step never
    copies them from the host."""
    upd = dict(top_momentum_stress=place_stress(dynamics.top_momentum_stress, grid),
               bottom_momentum_stress=place_stress(dynamics.bottom_momentum_stress, grid))
    if isinstance(getattr(dynamics, "free_drift", None), StressBalanceFreeDrift):
        upd["free_drift"] = _place_dynamics(dynamics.free_drift, grid)
    rheology = getattr(dynamics, "rheology", None)
    if isinstance(rheology, ViscousRheology) and hasattr(rheology.nu, "shape"):
        upd["rheology"] = dataclasses.replace(rheology, nu=torch.as_tensor(
            rheology.nu, dtype=grid.dtype, device=grid.device))
    return dataclasses.replace(dynamics, **upd)


def fixed_tiles(grid, dynamics):
    """The solver's ``fixed_tiles``, or None."""
    return getattr(getattr(dynamics, "solver", None), "fixed_tiles", None)


def _equilibrium_top_flux(thermo, pt):
    """FluxFunction equal to the slab's internal conductive flux: keeps a
    prescribed-temperature slab in flux equilibrium."""
    from .thermodynamics.heat_bcs import FluxFunction, bottom_temperature
    from .thermodynamics.slab import eval_internal_flux

    def equilibrium_flux(grid, Tu, clock, fields):
        Tb = bottom_temperature(thermo.bottom_heat_bc, grid, pt.liquidus, fields)
        return eval_internal_flux(thermo.internal_heat_flux, grid, Tu, Tb, clock, fields)

    return FluxFunction(func=equilibrium_flux, top_temperature_dependent=True)


# --- state construction -------------------------------------------------------

def initial_state(model: SeaIceModel, h=0.0, a=0.0, hs=0.0, u=0.0, v=0.0,
                  tracers=None, time=0.0):
    """Allocate and initialise the full state."""
    grid = model.grid

    def cc(val):
        return grid.field_from(val)

    state = SeaIceState(
        h=cc(h), a=cc(a),
        u=cc(u), v=cc(v),
        hs=cc(hs) if model.snow_thermodynamics is not None else None,
        S=cc(model.ice_salinity),
        tracers={k: cc(v0) for k, v0 in (tracers or {}).items()},
        Tu=_initial_surface_temperature(model.ice_thermodynamics, grid),
        Tus=_initial_surface_temperature(model.snow_thermodynamics, grid),
        mf_ice=grid.new_field(), mf_snow=grid.new_field(),
        mf_snowfall=grid.new_field(),
        Qtop=grid.new_field(), Qbot=grid.new_field(),
        clock=Clock(time=grid.scalar(time),
                    iteration=torch.zeros((), dtype=torch.int32, device=grid.device)),
    )

    dyn = model.dynamics
    if isinstance(getattr(dyn, "rheology", None), ElastoViscoPlasticRheology):
        state = state.evolve(
            sig11=grid.new_field(), sig22=grid.new_field(), sig12=grid.new_field(),
            alpha=grid.new_field(dyn.rheology.max_relaxation_parameter),
            P=grid.new_field(), un=grid.new_field(), vn=grid.new_field(),
            Delta=grid.new_field(), zeta_cc=grid.new_field(), zeta_ff=grid.new_field())

    return update_state(model, state)


def _initial_surface_temperature(thermo, grid):
    if thermo is None:
        return None
    if isinstance(thermo.top_heat_bc, PrescribedTemperature):
        return grid.new_field() + grid.scalar(thermo.top_heat_bc.temperature)
    return grid.new_field()


def set_fields(model, state, **kw):
    """Functional ``set!``: overwrite the interiors of the named prognostic
    fields (values as :meth:`Grid.field_from` takes them), then refresh
    halos."""
    state = state.evolve(**{name: model.grid.field_from(val) for name, val in kw.items()})
    return update_state(model, state)


def make_fields(model, state) -> ModelFields:
    grid = model.grid
    rho = grid.scalar(model.sea_ice_density).broadcast_to(grid.shape)
    return ModelFields(h=state.h, a=state.a, S=state.S, hs=state.hs,
                       u=state.u, v=state.v, Tu=state.Tu, Tus=state.Tus,
                       rho=rho, sig11=state.sig11, sig22=state.sig22,
                       sig12=state.sig12, un=state.un, vn=state.vn,
                       P=state.P, alpha=state.alpha, tracers=state.tracers)


# --- update_state: masking + halo fills ---------------------------------------

def update_state(model, state):
    """Mask peripheral velocity nodes and refresh the halos of every
    prognostic field."""
    grid = model.grid
    masks = model.masks

    def mask_cc(q):
        if masks.solid_cc is None:
            return q
        return torch.where(masks.solid_cc, 0.0, q)

    names, qs, locs = [], [], []
    for name in ("h", "a", "hs", "S", "Tu", "Tus",
                 "mf_ice", "mf_snow", "mf_snowfall"):
        q = getattr(state, name)
        if q is not None:
            names.append(name)
            qs.append(mask_cc(q))
            locs.append("cc")
    tracer_names = list(state.tracers or {})
    for k in tracer_names:
        names.append(None)
        qs.append(mask_cc(state.tracers[k]))
        locs.append("cc")
    if state.u is not None:
        names.append("u")
        qs.append(torch.where(masks.per_fc, 0.0, state.u))
        locs.append("fc")
    if state.v is not None:
        names.append("v")
        qs.append(torch.where(masks.per_cf, 0.0, state.v))
        locs.append("cf")

    with span("seaice.fill"):
        filled = fill_halos_many(qs, locs, grid)
    upd = {}
    tracers = {}
    tracer_iter = iter(tracer_names)
    for name, q in zip(names, filled):
        if name is None:
            tracers[next(tracer_iter)] = q
        else:
            upd[name] = q
    if tracers:
        upd["tracers"] = tracers
    return state.evolve(**upd)


# --- tendencies and tracer update ---------------------------------------------

@spanned("seaice.tracers")
def tracer_tendencies(model, state):
    """G = −∇·(U c) + user forcing for h, ℵ, hs and extra tracers.

    With ``fixed_tiles`` the divergence comes from the fixed-tile advection
    kernel where :func:`fixed_tile_advection_available` allows it
    (`model.py:303-310`).  Without it, a float32 model on the card takes the
    same kernel on the whole grid where :func:`whole_grid_advection_available`
    allows it, bitwise the general path in every interior point and exactly
    zero on rows of land, so uncropped.  Otherwise, solid-row crop: on the ≥ 32
    southernmost interior rows that are land across every x, every face is
    peripheral, so the divergence is exactly zero there.  It is computed on
    a row-sliced view of the grid and a band of zeros takes the cropped rows
    and the view's first Hy output rows (whose stencils wrap); every kept
    row is bitwise the uncropped value.  The crop stays off under
    ``fixed_tiles`` and under a user forcing (whose callables see the
    full-shape fields), as in `model.py:317-320`; the fixed-tile kernel
    takes a forced model, as JAX's does."""
    grid = model.grid
    adv = model.advection
    u, v = state.u, state.v
    adv_masks = (model.masks.per_fc, model.masks.per_cf)
    fixed = fixed_tiles(grid, model.dynamics)
    forcing = model.forcing_dict()
    fields = make_fields(model, state) if forcing else None
    cs = model.masks.solid_rows if adv is not None and fixed is None and not forcing else 0
    if fixed is not None and fixed_tile_advection_available(model):
        div = make_fixed_tile_div(model, u, v)
    elif whole_grid_advection_available(model):
        div = make_whole_grid_div(model, u, v)
    elif cs >= 32:
        gc = south_crop_grid(grid, cs)
        uc, vc = u[:, cs:], v[:, cs:]
        mc = (adv_masks[0][:, cs:], adv_masks[1][:, cs:])
        zband = torch.zeros((grid.nxp, cs + grid.Hy), dtype=grid.dtype, device=grid.device)

        def div(c):
            d = horizontal_div_Uc(gc, adv, uc, vc, c[:, cs:], masks=mc)
            return torch.cat([zband, d[:, grid.Hy:]], 1)
    else:
        def div(c):
            return horizontal_div_Uc(grid, adv, u, v, c, masks=adv_masks)

    def G(name, c):
        fn = forcing.get(name)
        return -div(c) if fn is None else -div(c) + fn(grid, state.clock, fields)

    Gh = G("h", state.h)
    Ga = G("a", state.a)
    Ghs = G("hs", state.hs) if state.hs is not None else None
    Gtr = {k: G(k, c) for k, c in (state.tracers or {}).items()}
    return Gh, Ga, Ghs, Gtr


@spanned("seaice.tracers")
def dynamic_step_tracers(model, state, G, dt, base=None):
    """Euler tracer update + clipping + ridging.  ``base``: the state to
    update *from* (Ψ⁻ under RK3); defaults to ``state``."""
    Gh, Ga, Ghs, Gtr = G
    b = base if base is not None else state

    h_plus = b.h + dt * Gh
    a_plus = b.a + dt * Ga
    a_plus = torch.clamp(a_plus, min=0.0)
    h_plus = torch.clamp(h_plus, min=0.0)
    a_plus = torch.where(h_plus == 0, 0.0, a_plus)
    h_plus = torch.where(a_plus == 0, 0.0, h_plus)

    V_plus = h_plus * a_plus
    a_new = torch.where(a_plus > 1, 1.0, a_plus)
    h_new = torch.where(a_plus > 1, V_plus, h_plus)

    upd = dict(h=h_new, a=a_new)

    if state.hs is not None and Ghs is not None:
        hs_plus = torch.clamp(b.hs + dt * Ghs, min=0.0)
        upd["hs"] = torch.where(a_new <= 0, 0.0, hs_plus)

    if Gtr:
        upd["tracers"] = {k: (b.tracers[k] + dt * Gtr[k]) for k in Gtr}

    return state.evolve(**upd)


# --- momentum dispatch --------------------------------------------------------

def meshed_momentum_route(model):
    """The momentum route of a shard's model (a grid that names mesh axes),
    as the JAX package dispatches it on its TPU (`model.py:397-445`):
    "tiled_curvilinear" (kernel 2.7 on a grid with array metrics or a fold,
    its pinned plan under ``fixed_tiles``, else its unpinned plan), without
    ``fixed_tiles`` "padded" (2.3 meshed), with it "tiled_padded" (2.4 and
    2.5 meshed), or "general": the general path, which is also that of free
    drift as the whole dynamics and of ``ExplicitSolver`` (their fills
    exchange), of the 'per_substep' and 'overlap' policies (the loop's fills
    as :func:`.dynamics.momentum.loop_form` says), and under 'wide' of a
    shard whose bounded direction is split, which the kernels' static fills
    cannot wall."""
    solver = getattr(model.dynamics, "solver", None)
    if (not isinstance(solver, SplitExplicitSolver) or solver.fused == "never"
            or solver.halo_exchange != "wide"):
        return "general"
    fixed = fixed_tiles(model.grid, model.dynamics) is not None
    if tiled_curvilinear_available(model):
        return "tiled_curvilinear"
    if not fixed and padded_fused_available(model):
        return "padded"
    if fixed and tiled_padded_available(model):
        return "tiled_padded"
    return "general"


_MESHED_STEPS = {
    "tiled_curvilinear": tiled_curvilinear_momentum_step,
    "padded": padded_fused_momentum_step,
    "tiled_padded": tiled_padded_momentum_step,
    "general": split_explicit_momentum_step,
}


@spanned("seaice.momentum")
def momentum_step(model, state, dt, u_prev=None, v_prev=None):
    """Dispatch on the dynamics in the JAX package's order
    (`model.py:381-445`): free drift as the whole dynamics (the closed-form
    velocities, halos filled), then ``ExplicitSolver``
    (:func:`explicit_momentum_step`), then the split-explicit routes: unless
    ``fused`` is 'never', the curvilinear fused
    EVP route where :func:`curvilinear_fused_available` allows it (never
    with ``fixed_tiles``); the pinned tiled curvilinear one where
    :func:`tiled_curvilinear_available` does (only with ``fixed_tiles``);
    without ``fixed_tiles`` the periodic one where :func:`fused_available`
    does, else the padded one where :func:`padded_fused_available` does; with
    ``fixed_tiles`` the tiled padded one where :func:`tiled_padded_available`
    does; else the general split-explicit path.  A shard's model takes
    :func:`meshed_momentum_route`."""
    dyn = model.dynamics
    if dyn is None:
        return state
    grid = model.grid
    if isinstance(dyn, StressBalanceFreeDrift):
        f = make_fields(model, state)
        u = free_drift_u(grid, dyn, state.clock, f)
        v = free_drift_v(grid, dyn, state.clock, f)
        return state.evolve(u=fill_halos_fc(u, grid), v=fill_halos_cf(v, grid))
    u_start = u_prev if u_prev is not None else state.u
    v_start = v_prev if v_prev is not None else state.v
    if isinstance(dyn.solver, ExplicitSolver):
        u, v = explicit_momentum_step(model, state, make_fields(model, state), dt,
                                      u_start, v_start)
        return state.evolve(u=u, v=v)
    if not isinstance(dyn.solver, SplitExplicitSolver):
        raise TypeError(f"unsupported solver {dyn.solver!r}")
    fused = dyn.solver.fused != "never"
    fixed = fixed_tiles(model.grid, dyn) is not None
    if grid.mesh_axes is not None:
        upd = _MESHED_STEPS[meshed_momentum_route(model)](model, state, dt, u_start, v_start)
    elif fused and curvilinear_fused_available(model):
        upd = curvilinear_fused_momentum_step(model, state, dt, u_start, v_start)
    elif fused and tiled_curvilinear_available(model):
        upd = tiled_curvilinear_momentum_step(model, state, dt, u_start, v_start)
    elif fused and not fixed and fused_available(model):
        upd = fused_split_explicit_momentum_step(model, state, dt, u_start, v_start)
    elif fused and not fixed and padded_fused_available(model):
        upd = padded_fused_momentum_step(model, state, dt, u_start, v_start)
    elif fused and fixed and tiled_padded_available(model):
        upd = tiled_padded_momentum_step(model, state, dt, u_start, v_start)
    else:
        upd = split_explicit_momentum_step(model, state, dt, u_start, v_start)
    return state.evolve(**upd)


# --- thermodynamic dispatch ---------------------------------------------------

@spanned("seaice.column")
def thermodynamic_step(model, state, dt):
    """Slab column step: bare ice, or snow on ice.  A float32
    SlabThermodynamics model with ``fixed_tiles`` runs the column step in the
    fixed-tile kernel (`model.py:458-466`)."""
    if model.ice_thermodynamics is None:
        return state
    if (fixed_tiles(model.grid, model.dynamics) is not None
            and model.grid.dtype == torch.float32
            and isinstance(model.ice_thermodynamics, SlabThermodynamics)):
        return fixed_tile_thermo_step(model, state, dt)
    fields = make_fields(model, state)
    if model.snow_thermodynamics is None:
        h1, a1, Tu, diags = bare_ice_thermodynamic_step(model, state, fields, dt)
        upd = dict(h=h1, a=a1, Tu=Tu)
    else:
        h1, a1, hs1, Tu, Tus, diags = layered_thermodynamic_step(model, state, fields, dt)
        upd = dict(h=h1, a=a1, hs=hs1, Tu=Tu, Tus=Tus)
    return state.evolve(**upd, mf_ice=diags["mf_ice"], mf_snow=diags["mf_snow"],
                        mf_snowfall=diags["mf_snowfall"],
                        Qtop=diags["Qtop"], Qbot=diags["Qbot"])


# --- full step ----------------------------------------------------------------

def _tick(state, dt):
    c = state.clock
    return state.evolve(clock=Clock(time=c.time + dt, iteration=c.iteration + 1))


def forward_euler_step(model, state, dt):
    G = tracer_tendencies(model, state)
    state = momentum_step(model, state, dt)
    state = dynamic_step_tracers(model, state, G, dt)
    state = thermodynamic_step(model, state, dt)
    state = _tick(state, dt)
    return update_state(model, state)


RK3_FRACTIONS = (1.0 / 3.0, 1.0 / 2.0, 1.0)


def rk3_step(model, state, dt):
    """Low-storage split RK3: cache Ψ⁻, then three stages each re-based on
    Ψ⁻ with Δτ = Δt/3, Δt/2, Δt.  The fraction is a tensor of the grid dtype
    so that ``dt·frac`` rounds as in the JAX package."""
    psi = state  # cached Ψ⁻
    for frac in RK3_FRACTIONS:
        dtau = dt * model.grid.scalar(frac)
        G = tracer_tendencies(model, state)
        state = momentum_step(model, state, dtau, u_prev=psi.u, v_prev=psi.v)
        state = dynamic_step_tracers(model, state, G, dtau, base=psi)
        state = thermodynamic_step(model, state, dtau)
        state = update_state(model, state)
    return _tick(state, dt)


@spanned("seaice.step")
def _step(model, state, dt):
    if model.timestepper == "ForwardEuler":
        return forward_euler_step(model, state, dt)
    if model.timestepper == "SplitRungeKutta3":
        return rk3_step(model, state, dt)
    raise ValueError(f"unknown timestepper {model.timestepper!r}")


step = _step
step_unjitted = _step


# --- small shared physics helpers ---------------------------------------------

def ice_mass_cc(h, a, rho):
    """m = ρ h ℵ."""
    return h * a * rho


def cell_advection_timescale(model, state):
    """min(Δx/|u|, Δy/|v|) over the interior, as a 0-d tensor."""
    grid = model.grid
    u = grid.interior(state.u).abs()
    v = grid.interior(state.v).abs()
    dx = grid.interior(torch.as_tensor(grid.dx_fc, dtype=grid.dtype,
                                       device=grid.device).broadcast_to(grid.shape))
    dy = grid.interior(torch.as_tensor(grid.dy_cf, dtype=grid.dtype,
                                       device=grid.device).broadcast_to(grid.shape))
    tx = (dx / torch.clamp(u, min=1e-30)).min()
    ty = (dy / torch.clamp(v, min=1e-30)).min()
    return torch.minimum(tx, ty)
