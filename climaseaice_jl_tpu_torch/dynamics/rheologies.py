"""Sea-ice rheologies, viscous and elasto-visco-plastic (αEVP), and the
metric-aware, energy-conserving (SBP) stress divergence.

Counterpart of `climaseaice_jl_tpu/dynamics/rheologies.py`: Newtonian
σ = ν δu, and αEVP (Kimmritz et al. 2017, dynamic relaxation
α ∈ [α⁻, α⁺]).  Strain rates:

    ϵ̇D = [δx(Δy·u) + δy(Δx·v)] / Az            (divergence, cc)
    ϵ̇T = [Δy² δx(u/Δy) − Δx² δy(v/Δx)] / Az    (tension, cc)
    ϵ̇S = [Δx² δy(u/Δx) + Δy² δx(v/Δy)] / Az    (shear, ff)
    ϵ̇₁₁ = (ϵ̇D + ϵ̇T)/2,  ϵ̇₂₂ = (ϵ̇D − ϵ̇T)/2,  ϵ̇₁₂ = ϵ̇S/2
"""

from __future__ import annotations

import math

import torch

from ..utils import frozen_dataclass
from ..ops import dxc, dxf, dyc, dyf, ixf, iyf, ixy_ff, ixy_cc


# --- strain rates ------------------------------------------------------------

def eps_D_cc(grid, u, v):
    return (dxc(grid.dy_fc * u) + dyc(grid.dx_cf * v)) / grid.az_cc


def eps_T_cc(grid, u, v):
    return (grid.dy_cc ** 2 * dxc(u / grid.dy_fc)
            - grid.dx_cc ** 2 * dyc(v / grid.dx_cf)) / grid.az_cc


def eps_S_ff(grid, u, v):
    return (grid.dx_ff ** 2 * dyf(u / grid.dx_fc)
            + grid.dy_ff ** 2 * dxf(v / grid.dy_cf)) / grid.az_ff


def strain_rates(grid, u, v):
    """(ϵ̇₁₁@cc, ϵ̇₂₂@cc, ϵ̇₁₂@ff), with ϵ̇D and ϵ̇T evaluated once each."""
    eD = eps_D_cc(grid, u, v)
    eT = eps_T_cc(grid, u, v)
    return 0.5 * (eD + eT), 0.5 * (eD - eT), 0.5 * eps_S_ff(grid, u, v)


def strain_rate_xx(grid, u, v):
    """ϵ̇₁₁ at cell centres (`rheologies.py:58-59`)."""
    return 0.5 * (eps_D_cc(grid, u, v) + eps_T_cc(grid, u, v))


def strain_rate_yy(grid, u, v):
    """ϵ̇₂₂ at cell centres."""
    return 0.5 * (eps_D_cc(grid, u, v) - eps_T_cc(grid, u, v))


def strain_rate_xy(grid, u, v):
    """ϵ̇₁₂ at (f,f) nodes."""
    return 0.5 * (eps_S_ff(grid, u, v))


# --- rheology configurations -------------------------------------------------

@frozen_dataclass
class ViscosityFunction:
    """A function-valued viscosity ``ν(x, y, t)``, evaluated at the stress
    location from the grid's coordinates and the clock's time."""
    func: object = None


@frozen_dataclass
class ViscousRheology:
    """Newtonian stress σ = ν δu.  ``nu`` may be a scalar, a centred field
    (face values use the 4-point average), or a function ``ν(x, y, t)``
    evaluated at the stress location."""
    nu: object = 1000.0

    def __post_init__(self):
        if callable(self.nu) and not isinstance(self.nu, ViscosityFunction):
            object.__setattr__(self, "nu", ViscosityFunction(func=self.nu))


@frozen_dataclass
class ElastoViscoPlasticRheology:
    """αEVP of Kimmritz et al. (2017)."""
    ice_compressive_strength: object = 27500.0   # P★ (N m⁻²)
    ice_compaction_hardening: object = 20.0      # C
    yield_curve_eccentricity: object = 2.0       # e
    minimum_plastic_stress: object = 2e-9        # Δ_min
    min_relaxation_parameter: object = 50.0      # α⁻
    max_relaxation_parameter: object = 300.0     # α⁺
    relaxation_strength: object = math.pi ** 2   # c_α
    pressure_formulation: str = "replacement"    # replacement | ice_strength


def ice_strength(rheology: ElastoViscoPlasticRheology, h, a):
    """P = P★ h exp(−C (1 − ℵ))."""
    return (rheology.ice_compressive_strength * h
            * torch.exp(-rheology.ice_compaction_hardening * (1 - a)))


def ice_pressure(rheology: ElastoViscoPlasticRheology, P, Delta):
    """Replacement pressure P·Δ/(Δ+Δmin) or raw ice strength."""
    if rheology.pressure_formulation == "ice_strength":
        return P
    Dm = rheology.minimum_plastic_stress
    return P * Delta / (Delta + Dm)


def compute_evp_viscosities(rheology: ElastoViscoPlasticRheology, grid, u, v, P,
                            strains=None):
    """Strain invariants → (Δ_cc, ζ_cc, ζ_ff).  ``strains``: optional
    precomputed :func:`strain_rates` tuple."""
    e_inv2 = rheology.yield_curve_eccentricity ** -2.0
    Dm = rheology.minimum_plastic_stress

    e11_cc, e22_cc, e12_ff = (strain_rates(grid, u, v)
                              if strains is None else strains)
    e11_ff = ixy_ff(e11_cc)
    e22_ff = ixy_ff(e22_cc)
    e12_cc = ixy_cc(e12_ff)

    d_cc = e11_cc + e22_cc
    d_ff = e11_ff + e22_ff
    s_cc = torch.sqrt((e11_cc - e22_cc) ** 2 + 4 * e12_cc ** 2)
    s_ff = torch.sqrt((e11_ff - e22_ff) ** 2 + 4 * e12_ff ** 2)

    Delta_cc = torch.clamp(torch.sqrt(d_cc ** 2 + s_cc ** 2 * e_inv2), min=Dm)
    Delta_ff = torch.clamp(torch.sqrt(d_ff ** 2 + s_ff ** 2 * e_inv2), min=Dm)

    P_ff = ixy_ff(P)
    zeta_cc = P / (2 * Delta_cc)
    zeta_ff = P_ff / (2 * Delta_ff)
    return Delta_cc, zeta_cc, zeta_ff


def compute_evp_stresses(rheology: ElastoViscoPlasticRheology, grid,
                         u, v, h, a, rho, dt,
                         sig11, sig22, sig12, Delta_cc, zeta_cc, zeta_ff, P,
                         strains=None):
    """One αEVP stress relaxation substep; returns (σ₁₁, σ₂₂, σ₁₂, α)."""
    e_inv2 = rheology.yield_curve_eccentricity ** -2.0
    a_plus = rheology.max_relaxation_parameter
    a_minus = rheology.min_relaxation_parameter
    c_alpha = rheology.relaxation_strength

    e11, e22, e12 = strain_rates(grid, u, v) if strains is None else strains

    Pr = ice_pressure(rheology, P, Delta_cc)

    eta_cc = zeta_cc * e_inv2
    eta_ff = zeta_ff * e_inv2

    sig11_target = 2 * eta_cc * e11 + ((zeta_cc - eta_cc) * (e11 + e22) - Pr / 2)
    sig22_target = 2 * eta_cc * e22 + ((zeta_cc - eta_cc) * (e11 + e22) - Pr / 2)
    sig12_target = 2 * eta_ff * e12

    m_cc = h * a * rho
    m_ff = ixy_ff(m_cc)

    # dynamic relaxation parameter γ = clamp(√(ζ c_α Δt / m / Az), α⁻, α⁺)
    def gamma(zeta, m, az):
        ok = m > 0
        g2 = torch.where(ok, zeta * c_alpha * dt / torch.where(ok, m, 1.0) / az,
                         a_plus ** 2)
        g2 = torch.where(torch.isnan(g2), a_plus ** 2, g2)
        return torch.clamp(torch.sqrt(g2), a_minus, a_plus)

    g_cc = gamma(zeta_cc, m_cc, grid.az_cc)
    g_ff = gamma(zeta_ff, m_ff, grid.az_ff)

    sig11 = sig11 + torch.where(m_cc > 0, (sig11_target - sig11) / g_cc, 0.0)
    sig22 = sig22 + torch.where(m_cc > 0, (sig22_target - sig22) / g_cc, 0.0)
    sig12 = sig12 + torch.where(m_ff > 0, (sig12_target - sig12) / g_ff, 0.0)
    return sig11, sig22, sig12, g_cc


# --- rheology stress lookup --------------------------------------------------

def _clock_time(clock):
    return clock.time if clock is not None else 0.0


def _viscosity_cc(nu, grid, clock):
    if isinstance(nu, ViscosityFunction):
        return nu.func(grid.xc[:, None], grid.yc[None, :], _clock_time(clock))
    return nu


def _viscosity_ff(nu, grid, clock):
    if isinstance(nu, ViscosityFunction):
        return nu.func(grid.xf[:, None], grid.yf[None, :], _clock_time(clock))
    if getattr(nu, "ndim", 0) == 2:
        return ixy_ff(nu)
    return nu


def rheology_stresses(rheology, grid, fields, clock=None):
    """(σ_ux@cc, σ_uy@ff, σ_vx@ff, σ_vy@cc) for the stress divergence."""
    if isinstance(rheology, ElastoViscoPlasticRheology):
        return fields.sig11, fields.sig12, fields.sig12, fields.sig22
    if isinstance(rheology, ViscousRheology):
        nu_cc = _viscosity_cc(rheology.nu, grid, clock)
        nu_ff = _viscosity_ff(rheology.nu, grid, clock)
        return (nu_cc * dxc(fields.u), nu_ff * dyf(fields.u),
                nu_ff * dxf(fields.v), nu_cc * dyc(fields.v))
    if rheology is None:
        z = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
        return z, z, z, z
    raise TypeError(f"unsupported rheology {rheology!r}")


# --- SBP stress divergence ---------------------------------------------------

def stress_divergence(rheology, grid, fields, masks=None, clock=None):
    """(∂ⱼσ₁ⱼ @ (f,c), ∂ⱼσ₂ⱼ @ (c,f)) in the energy-conserving invariant form.
    ``masks``: optional (solid_cc, per_ff) masks zeroing stresses at solid
    locations; ``clock``: the time a function-valued viscosity reads."""
    s_ux, s_uy, s_vx, s_vy = rheology_stresses(rheology, grid, fields, clock=clock)

    if masks is not None:
        solid_cc, per_ff = masks
        if solid_cc is not None:
            s_ux = torch.where(solid_cc, 0.0, s_ux)
            s_vy = torch.where(solid_cc, 0.0, s_vy)
        if per_ff is not None:
            s_uy = torch.where(per_ff, 0.0, s_uy)
            s_vx = torch.where(per_ff, 0.0, s_vx)

    sD = s_ux + s_vy
    sT = s_ux - s_vy

    div_x = (grid.dy_fc * dxf(sD) / 2
             + dxf(grid.dy_cc ** 2 * sT) / grid.dy_fc / 2
             + dyc(grid.dx_ff ** 2 * s_uy) / grid.dx_fc) / grid.az_fc

    div_y = (grid.dx_cf * dyf(sD) / 2
             - dyf(grid.dx_cc ** 2 * sT) / grid.dx_cf / 2
             + dxc(grid.dy_ff ** 2 * s_vx) / grid.dy_cf) / grid.az_cf

    return div_x, div_y


# --- EVP substep Δτ and rheology forcing -------------------------------------

def substep_dt_fc(rheology, grid, dt, fields):
    """Δτ at u points: Δt / ℑxᶠ(α)."""
    if isinstance(rheology, ElastoViscoPlasticRheology):
        return dt / ixf(fields.alpha)
    raise TypeError("substep_dt_fc is EVP-specific")


def substep_dt_cf(rheology, grid, dt, fields):
    if isinstance(rheology, ElastoViscoPlasticRheology):
        return dt / iyf(fields.alpha)
    raise TypeError("substep_dt_cf is EVP-specific")


def rheology_forcing_u(rheology, grid, dt, fields):
    """EVP convergence forcing (uⁿ − u)/Δt/ᾱ; zero for other rheologies."""
    if isinstance(rheology, ElastoViscoPlasticRheology):
        return (fields.un - fields.u) / dt / ixf(fields.alpha)
    return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)


def rheology_forcing_v(rheology, grid, dt, fields):
    if isinstance(rheology, ElastoViscoPlasticRheology):
        return (fields.vn - fields.v) / dt / iyf(fields.alpha)
    return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
