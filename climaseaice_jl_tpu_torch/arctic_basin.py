"""The tripolar Arctic basin: the configuration of
`validation/run_tripolar_basin.py:build` in this package.

A land-masked ``TripolarGrid`` (45°N to the fold, cap from 65°N, halo 5)
with idealised continents, the pole-row cells and every cell whose metric
collapsed near the two grid poles (min(Δx, Δy) < 0.2·median) as land; αEVP
with ``LatitudeCoriolis``, a seasonal anticyclonic gyre plus transpolar
drift as ``StressFunction`` winds, quadratic ocean drag and
``ImmersedDrag(1e-3)``; slab ice and snow under the Semtner monthly flux
climatology as cyclical ``FieldTimeSeries`` (latitude-scaled shortwave with a
temperature-dependent albedo, radiative emission), snowfall 3.2e-6 kg m⁻²
s⁻¹, a −2 W m⁻² ocean flux; WENO-7 and split RK3.  The land mask and the
winds are made with torch on the grid's device; the tables are copied from
`examples/arctic_basin_seasonal_cycle.py:15-27`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .grids import TripolarGrid, ImmersedBoundaryGrid
from .model import sea_ice_model, initial_state
from .advection import WENO
from .forcing_utils import FieldTimeSeries
from .thermodynamics import (FluxFunction, RadiativeEmission, sea_ice_slab_thermodynamics,
                             snow_slab_thermodynamics)
from .dynamics import (ElastoViscoPlasticRheology, LatitudeCoriolis, SeaIceMomentumEquation,
                       SemiImplicitStress, SplitExplicitSolver, StressFunction, ImmersedDrag)

DAY = 86400.0
MONTH_DAYS, N_MONTHS = 30, 12
KCAL = 4184.0
PER_MONTH = KCAL / (MONTH_DAYS * DAY)

# Semtner's monthly climatology (W m⁻²; negative heats the ice)
TAB_SHORTWAVE = -np.array([0, 0, 1.9, 9.9, 17.7, 19.2, 13.6, 9.0, 3.7, 0.4, 0, 0]) * 1e4 * PER_MONTH
TAB_LONGWAVE = -np.array([10.4, 10.3, 10.3, 11.6, 15.1, 18.0, 19.1, 18.7, 16.5, 13.9, 11.2,
                          10.9]) * 1e4 * PER_MONTH
TAB_SENSIBLE = -np.array([1.18, 0.76, 0.72, 0.29, -0.45, -0.39, -0.30, -0.40, -0.17, 0.1, 0.56,
                          0.79]) * 1e4 * PER_MONTH
TAB_LATENT = -np.array([0, -0.02, -0.03, -0.09, -0.46, -0.70, -0.64, -0.66, -0.39, -0.19, -0.01,
                        -0.01]) * 1e4 * PER_MONTH
TIMES = np.arange(15, MONTH_DAYS * N_MONTHS, 30) * DAY

DEG = math.pi / 180.0
TAU0 = 0.12   # N m⁻², peak wind stress


def basin_grid(Nx, Ny, dtype="float32", device=None):
    """The land-masked tripolar grid of the basin."""
    grid = TripolarGrid((Nx, Ny), southernmost_latitude=45.0, transition_latitude=65.0,
                        halo=5, dtype=dtype, device=device)
    I = grid.interior
    lon = I((grid.lon_cc + 180.0) % 360.0 - 180.0)
    lat = I(grid.lat_cc)
    land = lat < 58.0                                     # southern closure
    land |= (lon > 20) & (lon < 180) & (lat < 73.0)       # "Eurasia"
    land |= (lon > -170) & (lon < -60) & (lat < 72.0)     # "North America"
    land |= (lon > -60) & (lon < -20) & (lat < 80.0)      # "Greenland"
    land[[0, 1, Nx - 1], Ny - 1] = True                   # the fold-row cells at the
    land[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True          # two grid poles
    # every cell whose metric collapsed near the grid poles (numpy's median)
    dmin = torch.minimum(I(grid.dx_cc), I(grid.dy_cc)).flatten()
    s = torch.sort(dmin).values
    n = s.numel()
    median = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    land |= torch.minimum(I(grid.dx_cc), I(grid.dy_cc)) < 0.2 * median
    return ImmersedBoundaryGrid(grid, land)


def basin_winds(grid):
    """The seasonal gyre + transpolar drift wind stress as StressFunctions."""
    lon_r = ((grid.lon_cc + 180.0) % 360.0 - 180.0) * DEG
    lat_r = grid.lat_cc * DEG

    def stereo(lon0, lat0):   # local plane around (lon0, lat0), unit sphere
        x = torch.cos(lat_r) * torch.sin(lon_r - lon0 * DEG)
        y = (math.cos(lat0 * DEG) * torch.sin(lat_r)
             - math.sin(lat0 * DEG) * torch.cos(lat_r) * torch.cos(lon_r - lon0 * DEG))
        return x, y

    gx, gy = stereo(-150.0, 80.0)      # gyre centred on (150°W, 80°N)
    fx, fy = stereo(0.0, 78.0)         # drift toward Fram Strait
    r2 = gx * gx + gy * gy
    gyre_amp = torch.exp(-r2 / (2 * 0.25 ** 2))
    tau_gx = gyre_amp * gy / torch.sqrt(r2 + 1e-6)        # anticyclonic
    tau_gy = -gyre_amp * gx / torch.sqrt(r2 + 1e-6)
    drift = torch.exp(-(fx * fx + fy * fy) / (2 * 0.6 ** 2))
    tau_u = 0.7 * tau_gx + 0.5 * (-drift * fx)
    tau_v = 0.7 * tau_gy + 0.5 * (-drift * fy)

    def seasonal(clock):   # 1 ± 0.4 over the year, winter maximum
        return 1.0 + 0.4 * torch.cos(2 * math.pi * clock.time / (360 * DAY))

    def wind_u(grid_, clock, fields):
        return TAU0 * seasonal(clock) * tau_u

    def wind_v(grid_, clock, fields):
        return TAU0 * seasonal(clock) * tau_v

    return {"u": StressFunction(func=wind_u), "v": StressFunction(func=wind_v)}


def basin_heat_flux(grid):
    """The seasonal top heat flux: latitude-scaled shortwave with a
    temperature-dependent albedo, longwave, sensible and latent series, and
    radiative emission."""
    series = [FieldTimeSeries(times=TIMES, data=tab, cyclical=True)
              for tab in (TAB_SHORTWAVE, TAB_LONGWAVE, TAB_SENSIBLE, TAB_LATENT)]
    sw_scale = torch.clamp(torch.cos(grid.lat_cc * DEG) / math.cos(75.0 * DEG), 0.3, 1.6)

    def solar_flux(grid_, Tu, clock, fields, fts):
        albedo = torch.full_like(Tu, 0.64).masked_fill_(Tu < -0.1, 0.75)   # in Tu's dtype
        return fts.at_time(clock.time) * sw_scale * (1 - albedo)

    return (FluxFunction(func=solar_flux, parameters=series[0], top_temperature_dependent=True),
            *series[1:],
            RadiativeEmission(emissivity=1.0, stefan_boltzmann_constant=5.67e-8 * 1.02))


def basin_model(Nx=1152, Ny=960, substeps=120, P_star=27500.0, dtype="float32",
                device=None, fused="auto"):
    """The basin's model on a ``basin_grid(Nx, Ny)``; ``P_star`` and
    ``substeps`` set the rheology's strength and the EVP substeps."""
    grid = basin_grid(Nx, Ny, dtype=dtype, device=device)
    dynamics = SeaIceMomentumEquation(
        rheology=ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=LatitudeCoriolis(),
        top_momentum_stress=basin_winds(grid),
        bottom_momentum_stress=SemiImplicitStress(),
        immersed_drag=ImmersedDrag(coefficient=1e-3),
        solver=SplitExplicitSolver(substeps=substeps, fused=fused))
    return sea_ice_model(grid, dynamics=dynamics,
                         ice_thermodynamics=sea_ice_slab_thermodynamics(),
                         snow_thermodynamics=snow_slab_thermodynamics(),
                         snowfall=3.2e-6, top_heat_flux=basin_heat_flux(grid),
                         bottom_heat_flux=-2.0, advection=WENO(order=7),
                         timestepper="SplitRungeKutta3")


def basin_state(model, snow=0.0):
    """2 m of ice at the pole tapering to open water at the ice edge, none
    on land; ``snow`` metres of snow wherever there is ice (none in the
    validation script)."""
    grid = model.grid
    lat = grid.interior(grid.lat_cc)
    land = grid.interior(grid.solid_cc)
    h0 = torch.where(land, 0.0, torch.clamp((lat - 62.0) / 20.0, 0.0, 1.0) * 2.0)
    a0 = torch.where(land, 0.0, torch.clamp((lat - 60.0) / 10.0, 0.0, 1.0))
    return initial_state(model, h=h0, a=a0, hs=snow * (a0 > 0).to(a0.dtype))
