"""The tripolar basin of the distributed validation: the configuration of
`validation/run_distributed_basin.py:build` in this package, run serially.

A land-masked ``TripolarGrid`` (45°N to the fold, cap from 65°N, halo 5)
with the script's own idealised continents and the pole-row cells as land;
αEVP with ``FPlane(f=1.4e-4)``, a seasonal anticyclonic gyre plus
transpolar drift as two ``StressFunction`` winds evaluated from the grid
argument's longitudes and latitudes, quadratic ocean drag and
``ImmersedDrag(1e-3)``; slab ice and snow under the Semtner climatology with
a latitude-scaled shortwave ``FluxFunction`` and radiative emission,
snowfall 3.2e-6 kg m⁻² s⁻¹, a −2 W m⁻² ocean flux; WENO-7 and Forward
Euler.  With ``fixed_tiles`` the solver is ``SplitExplicitSolver(substeps,
fixed_tiles, halo_exchange="wide", fused="always")`` and the winds are
evaluated by the fixed-tile pointwise kernel
(:func:`.dynamics.fixed_tile_pointwise.fixed_tile_pointwise`); without it,
eagerly.  The initial fields are formed in numpy float32 from the grid's
latitudes, as the script forms them, so that both devices start from the
same bits.
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
from .dynamics import (ElastoViscoPlasticRheology, FPlane, SeaIceMomentumEquation,
                       SemiImplicitStress, SplitExplicitSolver, StressFunction, ImmersedDrag)
from .dynamics.fixed_tile_pointwise import fixed_tile_pointwise
from .arctic_basin import (TAB_SHORTWAVE, TAB_LONGWAVE, TAB_SENSIBLE, TAB_LATENT, TIMES,
                           DAY, DEG, TAU0)


def _wind_expr(lon, lat, t, comp):
    """The seasonal gyre + transpolar drift stress component ``comp`` as an
    elementwise expression of (lon_cc, lat_cc, time)
    (`run_distributed_basin.py:45-73`)."""
    lon = (lon + 180.0) % 360.0 - 180.0
    lon_r, lat_r = lon * DEG, lat * DEG

    def stereo(lon0, lat0):
        x = torch.cos(lat_r) * torch.sin(lon_r - lon0 * DEG)
        y = (math.cos(lat0 * DEG) * torch.sin(lat_r)
             - math.sin(lat0 * DEG) * torch.cos(lat_r) * torch.cos(lon_r - lon0 * DEG))
        return x, y

    gx, gy = stereo(-150.0, 80.0)
    fx, fy = stereo(0.0, 78.0)
    r2 = gx * gx + gy * gy
    amp = torch.exp(-r2 / (2 * 0.25 ** 2))
    tau_gx = amp * gy / torch.sqrt(r2 + 1e-6)
    tau_gy = -amp * gx / torch.sqrt(r2 + 1e-6)
    drift = torch.exp(-(fx * fx + fy * fy) / (2 * 0.6 ** 2))
    seasonal = 1.0 + 0.4 * torch.cos(2 * math.pi * t / (360 * DAY))
    if comp == 0:
        out = TAU0 * seasonal * (0.7 * tau_gx + 0.5 * (-drift * fx))
    else:
        out = TAU0 * seasonal * (0.7 * tau_gy + 0.5 * (-drift * fy))
    return out.to(torch.float32)


def wind_x(lon, lat, t):
    return _wind_expr(lon, lat, t, 0)


def wind_y(lon, lat, t):
    return _wind_expr(lon, lat, t, 1)


WINDS = (wind_x, wind_y)


def wind_component(grid_, clock, comp, fixed_tiles=None):
    """Stress component ``comp`` (0: x, 1: y) from the grid argument's
    coordinates; with ``fixed_tiles`` through the fixed-tile pointwise kernel
    (`run_distributed_basin.py:76-94`)."""
    lon = grid_.lon_cc.to(torch.float32)
    lat = grid_.lat_cc.to(torch.float32)
    if fixed_tiles is None:
        return WINDS[comp](lon, lat, clock.time)
    return fixed_tile_pointwise(WINDS[comp], fixed_tiles, (lon, lat), scalars=(clock.time,))


def solar_flux(grid_, Tu, clock, fields, fts):
    """Latitude-scaled shortwave under a temperature-dependent albedo
    (`run_distributed_basin.py:139-143`)."""
    lat_ = grid_.lat_cc.to(torch.float32)
    sw = torch.clamp(torch.cos(lat_ * DEG) / math.cos(75.0 * DEG), 0.3, 1.6)
    albedo = torch.where(Tu < -0.1, 0.75, 0.64)
    return fts.at_time(clock.time) * sw * (1 - albedo)


def basin_land(grid):
    """The script's land mask over the interior (numpy booleans)."""
    Nx, Ny = grid.Nx, grid.Ny
    lon = (grid.lon_cc.cpu().numpy() + 180.0) % 360.0 - 180.0
    lat = grid.lat_cc.cpu().numpy()
    lonI, latI = grid.interior(lon), grid.interior(lat)
    land = latI < 58.0
    land |= (lonI > 20) & (lonI < 180) & (latI < 73.0)
    land |= (lonI > -170) & (lonI < -60) & (latI < 72.0)
    land |= (lonI > -60) & (lonI < -20) & (latI < 80.0)
    land[[0, 1, Nx - 1], Ny - 1] = True
    land[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True
    return land


def build(Nx, Ny, substeps=24, max_relaxation=300.0, fixed_tiles=None, thermo=True,
          halo=5, device=None):
    """``(model, state)`` of `run_distributed_basin.py:build(Nx, Ny, substeps,
    max_relaxation, fixed_tiles, thermo)` on ``device`` (default the card);
    ``halo`` other than 5 serves the halo-width invariance checks."""
    grid = TripolarGrid((Nx, Ny), southernmost_latitude=45.0, transition_latitude=65.0,
                        halo=halo, dtype="float32", device=device)
    land = basin_land(grid)
    latI = grid.interior(grid.lat_cc.cpu().numpy())
    grid = ImmersedBoundaryGrid(grid, land)

    def wind_u(grid_, clock, fields):
        return wind_component(grid_, clock, 0, fixed_tiles)

    def wind_v(grid_, clock, fields):
        return wind_component(grid_, clock, 1, fixed_tiles)

    dynamics = SeaIceMomentumEquation(
        rheology=ElastoViscoPlasticRheology(max_relaxation_parameter=max_relaxation),
        coriolis=FPlane(f=1.4e-4),
        top_momentum_stress={"u": StressFunction(func=wind_u), "v": StressFunction(func=wind_v)},
        bottom_momentum_stress=SemiImplicitStress(),
        immersed_drag=ImmersedDrag(coefficient=1e-3),
        solver=SplitExplicitSolver(
            substeps=substeps, fixed_tiles=fixed_tiles,
            halo_exchange="wide" if fixed_tiles else "per_substep",
            fused="always" if fixed_tiles else "auto"))
    kw = {}
    if thermo:
        Rs, Rl, Qs, Ql = (FieldTimeSeries(times=TIMES, data=tab, cyclical=True)
                          for tab in (TAB_SHORTWAVE, TAB_LONGWAVE, TAB_SENSIBLE, TAB_LATENT))
        Q_sw = FluxFunction(func=solar_flux, parameters=Rs, top_temperature_dependent=True)
        Q_em = RadiativeEmission(emissivity=1.0, stefan_boltzmann_constant=5.67e-8 * 1.02)
        kw = dict(snow_thermodynamics=snow_slab_thermodynamics(), snowfall=3.2e-6,
                  top_heat_flux=(Q_sw, Rl, Qs, Ql, Q_em), bottom_heat_flux=-2.0)
    model = sea_ice_model(grid, dynamics=dynamics,
                          ice_thermodynamics=sea_ice_slab_thermodynamics() if thermo else None,
                          advection=WENO(order=7), timestepper="ForwardEuler", **kw)

    h0 = np.clip((latI - 62.0) / 20.0, 0.0, 1.0) * 2.0
    a0 = np.clip((latI - 60.0) / 10.0, 0.0, 1.0)
    h0[land] = 0.0
    a0[land] = 0.0

    def field(q):
        return torch.as_tensor(q, dtype=torch.float32, device=grid.device)

    init = dict(h=field(h0), a=field(a0))
    if thermo:
        init["hs"] = 0.0
    return model, initial_state(model, **init)
