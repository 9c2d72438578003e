"""Dynamical single-layer (shallow-water) ocean for ice-ocean coupling.

Counterpart of `climaseaice_jl_tpu/ocean.py`: a free-surface single-layer
ocean on the ice's staggered C-grid, with prognostic currents (u, v),
surface elevation η, and mixed-layer temperature and salinity tracers.
Unlike :class:`~.coupled.SlabOcean` (prescribed currents) it responds to
wind and ice-ocean stress, and the ice feels its currents through the
`SemiImplicitStress` bottom drag (:mod:`.coupled`).

* Momentum and continuity: the forward-backward scheme (η first with the
  old velocities, then u with the new η, then v with the new u), substepped
  ``ocean.substeps`` times per coupled step, with an implicit quadratic
  bottom drag.
* Flux-form continuity on the grid metrics, so the volume ∑ η·Az is
  conserved to roundoff.
* Tracers: flux-form advection (:mod:`.advection`) in advective form (the
  flux divergence minus c·∇·U), plus optional lateral diffusion.
* Walls and land: velocities zeroed on peripheral faces every substep, as
  the ice momentum solvers do.

The operations follow the JAX package's order, so float64 results agree to
rounding.
"""

from __future__ import annotations

import torch

from .utils import frozen_dataclass
from .ops import dxc, dyc, dxf, dyf, ixf, iyf, ixc, iyc
from .fields import (fill_halos_cc, fill_halos_fc, fill_halos_cf,
                     peripheral_masks, mask_immersed_cc)
from .advection import horizontal_div_Uc, WENO
from .dynamics.coriolis import x_f_cross_U, y_f_cross_U


@frozen_dataclass
class ShallowWaterOcean:
    """Config for the dynamical mixed-layer ocean.

    Fluxes follow the slab ocean's sign conventions (:mod:`.coupled`:
    positive upward, cooling); radiation constants mirror
    `ice_ocean_model.jl:61-66`."""
    depth: object = 50.0                  # resting layer thickness H [m]
    gravity: object = 9.81                # (use ~0.02-0.1 for reduced gravity)
    coriolis: object = None               # FPlane / BetaPlane / None
    bottom_drag: object = 1e-3            # quadratic Cd at the layer base
    lateral_viscosity: object = None      # Ah [m² s⁻¹] (None = off)
    tracer_diffusivity: object = None     # κh [m² s⁻¹] (None = off)
    wind_stress_x: object = 0.0           # open-water τₓ [N m⁻²] (fc)
    wind_stress_y: object = 0.0           # (cf)
    ice_ocean_drag: object = 5.5e-3       # C_io for the ice→ocean stress
    density: object = 1024.0              # `ice_ocean_model.jl:61`
    heat_capacity: object = 3991.0
    emissivity: object = 1.0
    stefan_boltzmann_constant: object = 5.67e-8
    reference_temperature: object = 273.15
    solar_insolation: object = 0.0        # W m⁻² (negative = heating)
    temperature_restoring_rate: object = 0.0
    temperature_restoring_target: object = 0.0
    substeps: int = 16                    # shallow-water substeps a coupled step
    advection: object = WENO(order=5)

    @property
    def mixed_layer_depth(self):
        """Heat and salt capacity thickness: lets :mod:`.coupled` treat the
        slab and shallow-water oceans alike in the flux conversions."""
        return self.depth


def _laplacian_fc(grid, q):
    """∇²q at (f,c) with the grid metrics (both terms at matching stagger)."""
    qxx = dxf(dxc(q) / grid.dx_cc) / grid.dx_fc
    qyy = dyc(dyf(q) / grid.dy_ff) / grid.dy_fc
    return qxx + qyy


def _laplacian_cf(grid, q):
    qxx = dxc(dxf(q) / grid.dx_ff) / grid.dx_cf
    qyy = dyf(dyc(q) / grid.dy_cc) / grid.dy_cf
    return qxx + qyy


def _laplacian_cc(grid, q):
    qxx = dxc(dxf(q) / grid.dx_fc) / grid.dx_cc
    qyy = dyc(dyf(q) / grid.dy_cf) / grid.dy_cc
    return qxx + qyy


def shallow_water_substeps(grid, ocean: ShallowWaterOcean, u, v, eta,
                           tau_u, tau_v, dt):
    """``ocean.substeps`` forward-backward shallow-water substeps.

    ``tau_u``/``tau_v`` are the total surface stresses [N m⁻²] at (f,c) and
    (c,f) (wind over open water and ice-ocean stress), held fixed across the
    substeps of one coupled step.  Returns (u, v, η)."""
    H = ocean.depth
    g = ocean.gravity
    rho = ocean.density
    dtau = dt / ocean.substeps
    per_fc, per_cf, _ = peripheral_masks(grid)

    for _ in range(ocean.substeps):
        # continuity: flux form, layer thickness at faces
        h_fc = H + ixf(eta)
        h_cf = H + iyf(eta)
        div = (dxc(u * h_fc * grid.dy_fc) + dyc(v * h_cf * grid.dx_cf)) / grid.az_cc
        eta = eta - dtau * div
        eta = mask_immersed_cc(eta, grid)
        eta = fill_halos_cc(eta, grid)

        # u with the new η (forward-backward), then v with the new u
        h_u = H + ixf(eta)
        Gu = (-x_f_cross_U(ocean.coriolis, grid, u, v)
              - g * dxf(eta) / grid.dx_fc
              + tau_u / (rho * h_u))
        if ocean.lateral_viscosity is not None:
            Gu = Gu + ocean.lateral_viscosity * _laplacian_fc(grid, u)
        drag_u = ocean.bottom_drag * torch.sqrt(u * u + ixf(iyc(v)) ** 2) / h_u
        u = (u + dtau * Gu) / (1 + dtau * drag_u)
        u = torch.where(per_fc, 0.0, u)
        u = fill_halos_fc(u, grid)

        h_v = H + iyf(eta)
        Gv = (-y_f_cross_U(ocean.coriolis, grid, u, v)
              - g * dyf(eta) / grid.dy_cf
              + tau_v / (rho * h_v))
        if ocean.lateral_viscosity is not None:
            Gv = Gv + ocean.lateral_viscosity * _laplacian_cf(grid, v)
        drag_v = ocean.bottom_drag * torch.sqrt(ixc(iyf(u)) ** 2 + v * v) / h_v
        v = (v + dtau * Gv) / (1 + dtau * drag_v)
        v = torch.where(per_cf, 0.0, v)
        v = fill_halos_cf(v, grid)
    return u, v, eta


def advect_tracer(grid, ocean: ShallowWaterOcean, u, v, c, dt, masks=None):
    """Advective-form tracer update: ∂c/∂t = −[∇·(Uc) − c ∇·U] + κ∇²c.

    The flux-form divergence minus the c-weighted velocity divergence keeps
    the update monotone under the divergent shallow-water flow."""
    div_Uc = horizontal_div_Uc(grid, ocean.advection, u, v, c, masks=masks)
    div_U = (dxc(u * grid.dy_fc) + dyc(v * grid.dx_cf)) / grid.az_cc
    c = c - dt * (div_Uc - c * div_U)
    if ocean.tracer_diffusivity is not None:
        c = c + dt * ocean.tracer_diffusivity * _laplacian_cc(grid, c)
    return fill_halos_cc(c, grid)


def surface_stresses(grid, ocean: ShallowWaterOcean, u_ice, v_ice, a, u_o, v_o):
    """Total surface stress on the ocean: open-water wind and ice-ocean drag.

    τ_io = ρₒ C_io |uᵢ − uₒ| (uᵢ − uₒ), weighted by the ice concentration at
    the velocity point: the equal and opposite partner of the ice's
    `SemiImplicitStress` bottom drag."""
    rho = ocean.density
    a_fc = ixf(a)
    a_cf = iyf(a)
    du = u_ice - u_o
    dv = v_ice - v_o
    du_at_u, dv_at_u = du, ixf(iyc(dv))
    du_at_v, dv_at_v = ixc(iyf(du)), dv
    sp_u = torch.sqrt(du_at_u ** 2 + dv_at_u ** 2)
    sp_v = torch.sqrt(du_at_v ** 2 + dv_at_v ** 2)
    tau_u = (1 - a_fc) * ocean.wind_stress_x + a_fc * rho * ocean.ice_ocean_drag * sp_u * du_at_u
    tau_v = (1 - a_cf) * ocean.wind_stress_y + a_cf * rho * ocean.ice_ocean_drag * sp_v * dv_at_v
    return tau_u, tau_v
