"""Slab (Semtner-style) thermodynamics for bare ice and for snow on ice.

Counterpart of `climaseaice_jl_tpu/thermodynamics/slab.py`: the conductive
fluxes (single layer, and snow and ice in series with the interface
temperature), the slab configuration, the volume/concentration update with
clipping and ridging, snow accumulation and flooding, and the bare-ice and
layered snow + ice column steps.  Whole-grid ``torch.where`` arithmetic;
every division by a quantity that may vanish goes through a safe denominator
so no inf/NaN is made.
"""

from __future__ import annotations

import torch

from ..utils import frozen_dataclass
from .phase_transitions import melting_temperature, latent_heat
from .heat_bcs import (PrescribedTemperature, FluxFunction, getflux,
                       bottom_temperature, solve_surface_temperature,
                       MeltingConstrainedFluxBalance, IceWaterThermalEquilibrium)


# --- internal flux models ----------------------------------------------------

@frozen_dataclass
class ConductiveFlux:
    """Single-layer Fourier conduction F = −k (Tu − Tb) / h."""
    conductivity: object = 2.0  # W/(m K)


@frozen_dataclass
class IceSnowConductiveFlux:
    """Snow and ice conduction in series: F = (Tb − Tu)/(hs/ks + hi/ki)."""
    snow_conductivity: object = 0.31
    ice_conductivity: object = 2.0


def _safe_div(num, den, predicate):
    """num/den where predicate else 0, without making inf/NaN.  A Python
    ``bool`` predicate comes from a scalar denominator."""
    if isinstance(predicate, bool):
        return num / den if predicate else torch.zeros_like(num)
    den_safe = torch.where(predicate, den, 1.0)
    return torch.where(predicate, num / den_safe, 0.0)


def conductive_flux_value(flux: ConductiveFlux, Tu, Tb, h):
    k = flux.conductivity
    return _safe_div(-k * (Tu - Tb), h, h > 0)


def ice_snow_conductive_flux_value(flux: IceSnowConductiveFlux, Tu, Tb, hi, hs):
    R = hs / flux.snow_conductivity + hi / flux.ice_conductivity
    return _safe_div(Tb - Tu, R, R > 0)


def interface_temperature(flux: IceSnowConductiveFlux, Tu, Tb, hi, hs):
    """Snow-ice interface temperature Tsi = Tb + (Tu − Tb)·Ri/(Rs + Ri)."""
    Ri = hi / flux.ice_conductivity
    Rs = hs / flux.snow_conductivity
    R = Rs + Ri
    return torch.where(R > 0, Tb + (Tu - Tb) * _safe_div(Ri, R, R > 0), Tb)


def eval_internal_flux(flux, grid, Tu, Tb, clock, fields):
    """Slab-internal heat flux at surface temperature ``Tu``: a conductive
    model, a user FluxFunction, or a bare callable."""
    if isinstance(flux, ConductiveFlux):
        return conductive_flux_value(flux, Tu, Tb, fields.h)
    if isinstance(flux, IceSnowConductiveFlux):
        return ice_snow_conductive_flux_value(flux, Tu, Tb, fields.h, fields.hs)
    if isinstance(flux, FluxFunction) or callable(flux):
        return getflux(flux, grid, Tu, clock, fields)
    raise TypeError(f"unsupported internal heat flux {flux!r}")


# --- thermodynamics config ---------------------------------------------------

class ProportionalEvolution:
    """Hibler (1979) lateral-vs-vertical growth partition (marker)."""
    def __repr__(self):
        return "ProportionalEvolution()"


@frozen_dataclass
class SlabThermodynamics:
    """Single slab layer thermodynamics configuration; the top-surface
    temperature lives in the model state (``state.Tu``)."""
    top_heat_bc: object = None
    bottom_heat_bc: object = None
    internal_heat_flux: object = None
    concentration_evolution: object = None

    def __post_init__(self):
        defaults = dict(top_heat_bc=MeltingConstrainedFluxBalance(),
                        bottom_heat_bc=IceWaterThermalEquilibrium(),
                        internal_heat_flux=ConductiveFlux(2.0),
                        concentration_evolution=ProportionalEvolution())
        for name, value in defaults.items():
            if getattr(self, name) is None:
                object.__setattr__(self, name, value)


def sea_ice_slab_thermodynamics(conductivity=2.0, **kw):
    return SlabThermodynamics(internal_heat_flux=ConductiveFlux(conductivity), **kw)


def snow_slab_thermodynamics(conductivity=0.31, **kw):
    return SlabThermodynamics(internal_heat_flux=ConductiveFlux(conductivity), **kw)


# --- shared helpers ------------------------------------------------------------

def concentration_thermodynamic_step(conc_evolution, dVdt, an, hn, hc, dt):
    if not isinstance(conc_evolution, ProportionalEvolution):
        raise TypeError(f"unsupported concentration evolution {conc_evolution!r}")
    freezing = dVdt >= 0
    da_f = torch.where(freezing & (hc > 0),
                       (1 - an) * _safe_div(dVdt, hc, hc > 0), 0.0)
    da_m = torch.where(~freezing & (hn > 0),
                       an * _safe_div(dVdt, 2 * hn, hn > 0), 0.0)
    a_plus = an + dt * (da_f + da_m)
    return torch.clamp(a_plus, min=0.0)


def ice_volume_update(conc_evolution, dVdt, hn, an, hc, dt):
    """Volume update, clipping, pathological resets and thermodynamic
    ridging."""
    V1 = torch.clamp(hn * an + dt * dVdt, min=0.0)
    dVdt_eff = (V1 - hn * an) / dt
    a_plus = concentration_thermodynamic_step(conc_evolution, dVdt_eff, an, hn, hc, dt)
    h_plus = _safe_div(V1, a_plus, a_plus > 0)

    h_plus = torch.where(a_plus <= 0, 0.0, h_plus)
    a_plus = torch.where(dVdt_eff == 0, an, a_plus)
    h_plus = torch.where(dVdt_eff == 0, hn, h_plus)
    a_plus = torch.where(h_plus == 0, 0.0, a_plus)
    h_plus = torch.where(a_plus == 0, 0.0, h_plus)

    h_new = torch.where(a_plus > 1, h_plus * a_plus, h_plus)
    a_new = torch.where(a_plus > 1, 1.0, a_plus)
    return h_new, a_new


def snow_accumulation(snowfall_rate, rho_s, a):
    """Gs⁺ = Ps/ρs where there is ice."""
    rate = torch.as_tensor(snowfall_rate, dtype=a.dtype, device=a.device)
    return torch.where(a > 0, rate / rho_s, 0.0)


def snow_ice_formation(hi, hs, rho_i, rho_s, rho_w):
    """Negative-freeboard flooding: snow below the waterline turns to ice."""
    hf = hi * (1 - rho_i / rho_w) - hs * rho_s / rho_w
    dhs = torch.where(hf < 0, -hf * rho_i / rho_s, 0.0)
    hs_new = torch.clamp(hs - dhs, min=0.0)
    dhs = hs - hs_new
    return hi + dhs * rho_s / rho_i, hs_new


# --- bare-ice column step ----------------------------------------------------

def bare_ice_thermodynamic_step(model, state, fields, dt):
    """One thermodynamic step for slab ice without snow.  Returns
    ``(h, a, Tu, diagnostics)``; the diagnostics dict holds the mass fluxes
    and the applied external fluxes."""
    grid = model.grid
    thermo = model.ice_thermodynamics
    pt = model.phase_transitions
    liquidus = pt.liquidus
    clock = state.clock

    hn, an = state.h, state.a
    hc = model.ice_consolidation_thickness
    rho_i = model.sea_ice_density
    Qx = model.top_heat_flux
    Qb_ext = model.bottom_heat_flux

    consolidated = hn >= hc
    Tb = bottom_temperature(thermo.bottom_heat_bc, grid, liquidus, fields)

    internal = thermo.internal_heat_flux
    top_bc = thermo.top_heat_bc

    if isinstance(top_bc, PrescribedTemperature):
        Tu = state.Tu
    else:
        def balance(T):
            return (getflux(Qx, grid, T, clock, fields)
                    - eval_internal_flux(internal, grid, T, Tb, clock, fields))
        Ts = solve_surface_temperature(balance, state.Tu, top_bc.iterations)
        Tm = melting_temperature(liquidus, fields.S)
        Tu = torch.where(consolidated, torch.minimum(Ts, Tm), Tb)
        Tu = Tu.broadcast_to(grid.shape)

    Qui = getflux(Qx, grid, Tu, clock, fields)
    Qbi = getflux(Qb_ext, grid, Tu, clock, fields)
    Qii = torch.where(consolidated,
                      eval_internal_flux(internal, grid, Tu, Tb, clock, fields), 0.0)

    Eu = rho_i * latent_heat(pt, Tu)
    Eb = rho_i * latent_heat(pt, Tb)
    dVdt = (Qui - Qii) / Eu + (Qii - Qbi) / Eb

    h1, a1 = ice_volume_update(thermo.concentration_evolution, dVdt, hn, an, hc, dt)

    mf_ice = rho_i * (h1 * a1 - hn * an) / dt
    zeros = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    diags = dict(
        mf_ice=mf_ice.broadcast_to(grid.shape),
        mf_snow=zeros,
        mf_snowfall=zeros,
        Qtop=Qui + zeros,
        Qbot=Qbi + zeros,
    )
    return h1, a1, Tu, diags


# --- layered snow + ice column step ------------------------------------------

def layered_thermodynamic_step(model, state, fields, dt):
    """One thermodynamic step for the layered snow + ice column.  Returns
    ``(h, a, hs, Tu_ice, Tus_snow, diagnostics)``."""
    grid = model.grid
    ice_thermo = model.ice_thermodynamics
    snow_thermo = model.snow_thermodynamics
    pt = model.phase_transitions
    liquidus = pt.liquidus
    clock = state.clock

    hin, an, hsn = state.h, state.a, state.hs
    hc = model.ice_consolidation_thickness
    rho_i = model.sea_ice_density
    rho_s = model.snow_density
    Qx = model.top_heat_flux
    Qb_ext = model.bottom_heat_flux

    Vin = hin * an
    Vsn = hsn * an
    consolidated = hin >= hc

    Tb = bottom_temperature(ice_thermo.bottom_heat_bc, grid, liquidus, fields)
    Tm = melting_temperature(liquidus, fields.S)
    combined = IceSnowConductiveFlux(
        snow_conductivity=snow_thermo.internal_heat_flux.conductivity,
        ice_conductivity=ice_thermo.internal_heat_flux.conductivity)

    # snow melts at 0 °C where there is snow
    Tm_eff = torch.where(hsn > 0, grid.scalar(0.0), Tm)

    snow_top_bc = snow_thermo.top_heat_bc
    if isinstance(snow_top_bc, PrescribedTemperature):
        Tus = state.Tus
    else:
        def balance(T):
            return (getflux(Qx, grid, T, clock, fields)
                    - ice_snow_conductive_flux_value(combined, T, Tb, hin, hsn))
        Ts = solve_surface_temperature(balance, state.Tus, snow_top_bc.iterations)
        Tus = torch.where(consolidated, torch.minimum(Ts, Tm_eff), Tb)
        Tus = Tus.broadcast_to(grid.shape)

    # analytic snow-ice interface temperature, kept as the ice's Tu
    Tsi = interface_temperature(combined, Tus, Tb, hin, hsn)

    # snow-surface energy balance: per-cell external flux vs per-ice conduction
    Qis = torch.where(consolidated,
                      ice_snow_conductive_flux_value(combined, Tus, Tb, hin, hsn), 0.0)
    Qui = getflux(Qx, grid, Tus, clock, fields).broadcast_to(grid.shape)
    Qui_per_ice = _safe_div(Qui, an, an > 0)

    dQ = Qui_per_ice - Qis                     # dQ < 0: energy available for melt
    melt_energy = torch.clamp(-dQ, min=0.0)    # per ice area

    Ls = pt.reference_latent_heat
    snow_energy_capacity = rho_s * Ls * hsn / dt
    Qs = torch.minimum(melt_energy, snow_energy_capacity)
    Gs_minus = Qs / (rho_s * Ls)

    # closed-form self-consistent solve for ℵⁿ⁺¹
    rhoiL = rho_i * Ls
    Qbi = getflux(Qb_ext, grid, Tus, clock, fields)
    alpha = (Qui - Qbi) / rhoiL
    beta = Qs / rhoiL

    one = grid.scalar(1.0)
    Cm = torch.where(hin > 0, an * _safe_div(one, 2 * hin, hin > 0), 0.0)
    Cf = (1 - an) * _safe_div(one, hc, hc > 0)
    Km = dt * Cm
    Kf = dt * Cf

    eps_ = torch.finfo(grid.dtype).eps
    Dm = 1 - Km * beta
    Df = 1 - Kf * beta
    am = torch.where(Dm.abs() > eps_,
                     (an + Km * alpha) / torch.where(Dm.abs() > eps_, Dm, 1.0),
                     an + Km * alpha)
    af = torch.where(Df.abs() > eps_,
                     (an + Kf * alpha) / torch.where(Df.abs() > eps_, Df, 1.0),
                     an + Kf * alpha)

    melting = alpha + beta * am < 0
    a_tmp = torch.where(melting, am, af)

    # the final tendency with the effective top flux
    Qui_eff = Qui + Qs * a_tmp
    Qii = torch.where(consolidated,
                      conductive_flux_value(ice_thermo.internal_heat_flux, Tsi, Tb, hin), 0.0)
    Eu = rho_i * latent_heat(pt, Tsi)
    Eb = rho_i * latent_heat(pt, Tb)
    dVdt = (Qui_eff - Qii) / Eu + (Qii - Qbi) / Eb

    hi1, a1 = ice_volume_update(ice_thermo.concentration_evolution, dVdt, hin, an, hc, dt)

    # snow volume conserved under the concentration change
    hs_rebased = torch.where(a1 > 0, hsn * an * _safe_div(one, a1, a1 > 0), 0.0)

    Gs_plus = snow_accumulation(_snowfall_rate(model, clock), rho_s, a1)
    hs_p = torch.clamp(hs_rebased + dt * (Gs_plus - Gs_minus), min=0.0)

    hi1, hs_p = snow_ice_formation(hi1, hs_p, rho_i, rho_s, pt.liquid_density)
    hs_p = torch.where(a1 <= 0, 0.0, hs_p)

    Ps_abs = rho_s * Gs_plus * a1
    zeros = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    diags = dict(
        mf_ice=rho_i * (hi1 * a1 - Vin) / dt + zeros,
        mf_snow=rho_s * (hs_p * a1 - Vsn) / dt - Ps_abs + zeros,
        mf_snowfall=Ps_abs + zeros,
        Qtop=Qui + zeros,
        Qbot=Qbi + zeros,
    )
    return hi1, a1, hs_p, Tsi.broadcast_to(grid.shape), Tus, diags


def _snowfall_rate(model, clock):
    """Snowfall (kg m⁻² s⁻¹): a number, a tensor, or a FieldTimeSeries."""
    sf = model.snowfall
    if sf is None:
        return model.grid.scalar(0.0)
    if hasattr(sf, "at_time"):
        return sf.at_time(clock.time)
    return model.grid.scalar(sf)
