"""Ice-ocean coupling: a SeaIceModel over a slab or shallow-water ocean.

Counterpart of `climaseaice_jl_tpu/coupled.py`, the reference's coupling
prototype (`validation/ice_ocean_model/ice_ocean_model.jl`) with the ocean
reduced to a mixed layer:

* ice-ocean latent heat (`ice_ocean_model.jl:268-339`): where the ocean is
  below the local melting temperature Tₘ(S), or ice-covered, its
  temperature is set to Tₘ and the heat deficit or excess becomes the ice's
  bottom heat flux on the next step (frazil formation, basal melt);
* ice-ocean salinity flux (`:195-244`): brine rejection and meltwater
  release Qˢ = Δ(hℵ)/Δt (Sᵢ − Sₒ) applied to the mixed layer;
* air-sea flux (`:120-150`): radiative emission and solar insolation over
  the open-water fraction (1 − ℵ);
* ice-ocean drag: with a :class:`~.ocean.ShallowWaterOcean` the ice's
  `SemiImplicitStress` bottom drag takes the ocean's current velocities
  every step, and the ocean takes the opposite stress.

:func:`coupled_step` is one eager step over the combined state.  The ice
step is :func:`.model.step_unjitted`, so it goes through the fused EVP
gates as any ice step does: a float32 αEVP ice model over a shallow-water
ocean has array ``ue``/``ve`` in its drag, which the periodic kernel's gate
refuses and the padded one (2.3) takes.
"""

from __future__ import annotations

import torch

from .utils import frozen_dataclass
from .state import Clock
from .model import step_unjitted as _ice_step, initial_state as _ice_initial_state
from .thermodynamics.phase_transitions import melting_temperature
from .dynamics.stresses import SemiImplicitStress
from .ocean import (ShallowWaterOcean, shallow_water_substeps, advect_tracer,
                    surface_stresses)


@frozen_dataclass
class SlabOcean:
    """Mixed-layer slab ocean: prognostic SST and salinity, prescribed
    currents."""
    mixed_layer_depth: object = 30.0     # m
    density: object = 1024.0             # kg m⁻³ (`ice_ocean_model.jl:61`)
    heat_capacity: object = 3991.0       # J/(kg K)
    emissivity: object = 1.0
    stefan_boltzmann_constant: object = 5.67e-8
    reference_temperature: object = 273.15
    solar_insolation: object = 0.0       # W m⁻² (negative = heating)
    u: object = 0.0                      # prescribed surface currents (fc)
    v: object = 0.0                      # (cf)
    temperature_restoring_rate: object = 0.0   # s⁻¹ toward T_restore
    temperature_restoring_target: object = 0.0


@frozen_dataclass
class IceOceanModel:
    ice: object = None        # SeaIceModel (its bottom_heat_flux is overridden)
    ocean: object = None      # SlabOcean or ocean.ShallowWaterOcean


@frozen_dataclass
class IceOceanState:
    ice: object = None        # SeaIceState
    T_ocean: object = None    # SST (cc, padded)
    S_ocean: object = None
    prev_h: object = None     # previous hℵ-thickness for the salinity flux
    Q_bottom: object = None   # ice-ocean heat flux handed to the ice step
    u_ocean: object = None    # dynamical-ocean prognostics (fc/cf/cc);
    v_ocean: object = None    # None with a SlabOcean
    eta: object = None
    clock: Clock = None


def initial_state(iom: IceOceanModel, T_ocean=-1.0, S_ocean=30.0,
                  u_ocean=None, v_ocean=None, eta=None, **ice_kwargs):
    """The coupled state: the ice's :func:`.model.initial_state` with
    ``ice_kwargs``, the ocean's fields (values as ``Grid.field_from`` takes
    them; u, v, η only with a dynamical ocean, zero by default)."""
    grid = iom.ice.grid
    ice_state = _ice_initial_state(iom.ice, **ice_kwargs)
    dynamic = isinstance(iom.ocean, ShallowWaterOcean)

    def vel(x):
        return grid.field_from(x if x is not None else 0.0) if dynamic else None

    return IceOceanState(
        ice=ice_state,
        T_ocean=grid.field_from(T_ocean),
        S_ocean=grid.field_from(S_ocean),
        prev_h=ice_state.h,
        Q_bottom=grid.new_field(),
        u_ocean=vel(u_ocean), v_ocean=vel(v_ocean), eta=vel(eta),
        clock=ice_state.clock,
    )


def _ice_ocean_latent_heat(iom, T, S, h, dt):
    """Ice-bath adjustment (`ice_ocean_model.jl:268-339`, Nz = 1): returns
    (T adjusted, δQ into the ice in W m⁻²)."""
    ocean = iom.ocean
    liquidus = iom.ice.phase_transitions.liquidus
    Tm = melting_temperature(liquidus, S)
    freezing = T < Tm
    icy = h > 0
    adjust = freezing | icy

    rho_c = ocean.density * ocean.heat_capacity
    dE = torch.where(adjust, rho_c * (Tm - T), 0.0)         # J m⁻³
    T_new = torch.where(adjust, Tm, T)
    # δQ > 0: ocean cooled, heat into the ice (basal melt);
    # δQ < 0: frazil heat from the ice into the ocean
    dQ = -dE * ocean.mixed_layer_depth / dt
    return T_new, dQ


def _pow4(x):
    """x⁴ as (x·x)·(x·x), the products XLA makes of an integer power."""
    x2 = x * x
    return x2 * x2


def _air_sea_flux(iom, T, a):
    """Open-water radiative and solar flux (W m⁻², positive upward, cooling)
    (`ice_ocean_model.jl:120-150`)."""
    ocean = iom.ocean
    Q_rad = (ocean.emissivity * ocean.stefan_boltzmann_constant
             * _pow4(T + ocean.reference_temperature))
    return (1 - a) * (Q_rad + ocean.solar_insolation)


def ice_model_for_step(iom: IceOceanModel, cstate: IceOceanState):
    """The ice model that :func:`coupled_step` steps: ``iom.ice`` with last
    step's ``Q_bottom`` as its bottom heat flux and, over a dynamical ocean,
    its `SemiImplicitStress` bottom drag refreshed with the ocean's current
    u, v, density and ice-ocean drag coefficient
    (`sea_ice_external_stress.jl:132-152`'s refresh, done functionally)."""
    ice_model = iom.ice.evolve(bottom_heat_flux=cstate.Q_bottom)
    if isinstance(iom.ocean, ShallowWaterOcean):
        dyn = ice_model.dynamics
        if dyn is not None and isinstance(dyn.bottom_momentum_stress, SemiImplicitStress):
            bstress = dyn.bottom_momentum_stress.evolve(
                ue=cstate.u_ocean, ve=cstate.v_ocean,
                rho_e=iom.ocean.density, Cd=iom.ocean.ice_ocean_drag)
            ice_model = ice_model.evolve(dynamics=dyn.evolve(bottom_momentum_stress=bstress))
    return ice_model


def coupled_step(iom: IceOceanModel, cstate: IceOceanState, dt):
    """One coupled step, in the reference's order: the ice, the salinity
    flux, the ice-bath adjustment (next step's ``Q_bottom``), the air-sea
    flux and restoring, then with a dynamical ocean its substeps and the
    tracer advection of T and S."""
    ocean = iom.ocean
    grid = iom.ice.grid
    dynamic = isinstance(ocean, ShallowWaterOcean)

    # 1. the ice step, with the bottom heat flux of the previous step
    ice_state = _ice_step(ice_model_for_step(iom, cstate), cstate.ice, dt)

    h = ice_state.h
    a = ice_state.a

    # 2. ice-ocean salinity flux: Qˢ = Δ(hℵ)/Δt (Sᵢ − Sₒ) (`:215-244`)
    V = h * a
    dV = V - cstate.prev_h
    S = cstate.S_ocean
    Si = ice_state.S
    QS = dV / dt * (Si - S)
    S = S - dt * QS / ocean.mixed_layer_depth   # surface flux into the layer

    # 3. latent-heat (ice-bath) adjustment → next step's bottom flux
    T = cstate.T_ocean
    T, Q_bottom = _ice_ocean_latent_heat(iom, T, S, h, dt)

    # 4. air-sea flux over open water and the optional restoring
    rho_c_H = ocean.density * ocean.heat_capacity * ocean.mixed_layer_depth
    T = T - dt * _air_sea_flux(iom, T, a) / rho_c_H
    T = T + dt * ocean.temperature_restoring_rate * (
        ocean.temperature_restoring_target - T)

    # 5. the dynamical ocean: momentum and continuity substeps under the
    #    wind and ice stresses, then tracer advection by the new flow
    u_o, v_o, eta = cstate.u_ocean, cstate.v_ocean, cstate.eta
    if dynamic:
        tau_u, tau_v = surface_stresses(grid, ocean, ice_state.u, ice_state.v, a, u_o, v_o)
        u_o, v_o, eta = shallow_water_substeps(grid, ocean, u_o, v_o, eta, tau_u, tau_v, dt)
        masks = (iom.ice.masks.per_fc, iom.ice.masks.per_cf)
        T = advect_tracer(grid, ocean, u_o, v_o, T, dt, masks=masks)
        S = advect_tracer(grid, ocean, u_o, v_o, S, dt, masks=masks)

    return IceOceanState(ice=ice_state, T_ocean=T, S_ocean=S,
                         prev_h=V, Q_bottom=Q_bottom,
                         u_ocean=u_o, v_ocean=v_o, eta=eta,
                         clock=ice_state.clock)
