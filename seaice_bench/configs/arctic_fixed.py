"""arctic_fixed: the seasonal tripolar Arctic basin of
``validation/run_tripolar_basin.py:build`` at its own dt and substeps, in the
fixed-tile mode of ``validation/run_distributed_basin.py --fixed-tiles 8x128``.

A frozen copy that builds the configuration through the port's public API:
the physics of ``climaseaice_jl_tpu_torch/arctic_basin.py`` (``basin_grid``,
``basin_model``; commit 14c00ef) with the mode of
``distributed_basin.py:build`` (the solver's ``fixed_tiles``, ``halo_exchange``
and ``fused``; the winds through ``fixed_tile_pointwise`` on the grid
argument's coordinates, ``wind_component``; the solar scale formed from the
grid argument's latitudes inside the ``FluxFunction``, ``solar_flux``).  The
sizes come from the cell's traffic, the rest from ``arctic_fixed.json``.  Its
plain reference is ``reference/arctic_fixed.py``, whose grid and land also
make the inputs.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from .. import roofline
from ..reference import arctic_fixed as plain

DAY = 86400.0
DEG = math.pi / 180.0
TAU0 = 0.12
# the kernels of this configuration's route, by name in the device trace:
# 2.7's six launches (coefficients, settled flags, fold refill, stress and
# the two velocity updates)
EVP_KERNELS = r"\btc_(prep|settle|refill|stress|u_update|v_update)\b"
# 2.9's tile kernel, the column unit of 2.11, the ice strength (2.8) and the
# two wind units (2.10)
KERNELS = {"advection": r"\b(tile_div|fixed_tile_div)\b",
           "column": r"\bthermo_column\b",
           "pointwise": r"\b(ice_strength|pointwise_unit)\b"}


def _wind_expr(lon, lat, t, comp):
    """The seasonal gyre + transpolar drift stress component ``comp``
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


def solar_flux(grid_, Tu, clock, fields, fts):
    """Latitude-scaled shortwave under a temperature-dependent albedo
    (`run_distributed_basin.py:139-143`)."""
    lat_ = grid_.lat_cc.to(torch.float32)
    sw = torch.clamp(torch.cos(lat_ * DEG) / math.cos(75.0 * DEG), 0.3, 1.6)
    albedo = torch.where(Tu < -0.1, 0.75, 0.64)
    return fts.at_time(clock.time) * sw * (1 - albedo)


def basin_grid(pkg, Nx, Ny, cfg, device):
    """The land-masked tripolar grid (``arctic_basin.basin_grid``)."""
    grid = pkg.TripolarGrid((Nx, Ny), southernmost_latitude=float(cfg["southernmost_latitude"]),
                            transition_latitude=float(cfg["transition_latitude"]),
                            halo=int(cfg["halo"]), dtype=cfg["dtype"], device=device)
    I = grid.interior
    lon = I((grid.lon_cc + 180.0) % 360.0 - 180.0)
    lat = I(grid.lat_cc)
    land = lat < 58.0
    land |= (lon > 20) & (lon < 180) & (lat < 73.0)
    land |= (lon > -170) & (lon < -60) & (lat < 72.0)
    land |= (lon > -60) & (lon < -20) & (lat < 80.0)
    land[[0, 1, Nx - 1], Ny - 1] = True
    land[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True
    dmin = torch.minimum(I(grid.dx_cc), I(grid.dy_cc)).flatten()
    s = torch.sort(dmin).values
    n = s.numel()
    median = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    land |= torch.minimum(I(grid.dx_cc), I(grid.dy_cc)) < 0.2 * median
    return pkg.ImmersedBoundaryGrid(grid, land)


def build(pkg, cfg, traffic, device):
    """(model, dt) of the configuration at ``traffic``'s Nx × Ny in ``pkg``."""
    Nx, Ny = int(traffic["Nx"]), int(traffic["Ny"])
    fixed = tuple(cfg["fixed_tiles"])
    pointwise = importlib.import_module(
        pkg.__name__ + ".dynamics.fixed_tile_pointwise").fixed_tile_pointwise
    grid = basin_grid(pkg, Nx, Ny, cfg, device)

    def wind(comp):
        fn = (wind_x, wind_y)[comp]

        def stress(grid_, clock, fields):
            lon, lat = grid_.lon_cc.to(torch.float32), grid_.lat_cc.to(torch.float32)
            return pointwise(fn, fixed, (lon, lat), scalars=(clock.time,))
        return pkg.StressFunction(func=stress)

    dynamics = pkg.SeaIceMomentumEquation(
        rheology=pkg.ElastoViscoPlasticRheology(
            ice_compressive_strength=float(cfg["ice_compressive_strength"]),
            max_relaxation_parameter=float(cfg["max_relaxation_parameter"])),
        coriolis=pkg.LatitudeCoriolis(),
        top_momentum_stress={"u": wind(0), "v": wind(1)},
        bottom_momentum_stress=pkg.SemiImplicitStress(),
        immersed_drag=pkg.ImmersedDrag(coefficient=float(cfg["immersed_drag"])),
        solver=pkg.SplitExplicitSolver(substeps=int(cfg["substeps"]), fixed_tiles=fixed,
                                       halo_exchange=cfg["halo_exchange"], fused=cfg["fused"]))
    per_month = float(cfg["kcal_J"]) / (30 * DAY)
    times = np.arange(15, 360, 30) * DAY
    Rs, Rl, Qs, Ql = (pkg.FieldTimeSeries(times=times, data=-np.array(cfg["semtner"][k])
                                          * 1e4 * per_month, cyclical=True)
                      for k in ("shortwave", "longwave", "sensible", "latent"))
    Q_sw = pkg.FluxFunction(func=solar_flux, parameters=Rs, top_temperature_dependent=True)
    Q_em = pkg.RadiativeEmission(emissivity=float(cfg["emissivity"]),
                                 stefan_boltzmann_constant=float(cfg["stefan_boltzmann"]))
    model = pkg.sea_ice_model(grid, dynamics=dynamics,
                              ice_thermodynamics=pkg.sea_ice_slab_thermodynamics(),
                              snow_thermodynamics=pkg.snow_slab_thermodynamics(),
                              snowfall=float(cfg["snowfall"]),
                              top_heat_flux=(Q_sw, Rl, Qs, Ql, Q_em),
                              bottom_heat_flux=float(cfg["bottom_heat_flux"]),
                              advection=pkg.WENO(order=7), timestepper=cfg["timestepper"])
    return model, float(cfg["dt"])


def inputs(model, cfg, traffic, seed, device):
    """The interior fields of the initial state, from the plain reference's
    grid and land: the source's thickness 2·clip((φ − 62)/20, 0, 1) times
    clamp(1 + 0.05 N(0, 1), min 0.5) from the seed, its concentration
    clip((φ − 60)/10, 0, 1), nothing on land, no snow."""
    Nx, Ny = int(traffic["Nx"]), int(traffic["Ny"])
    lat = torch.as_tensor(plain.metrics(Nx, Ny, *plain.latitudes(cfg))["lat_cc"].astype(np.float32),
                          device=device)
    dry = torch.as_tensor(plain.land(Nx, Ny, *plain.latitudes(cfg)), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn((Nx, Ny), generator=gen, dtype=torch.float32, device=device)
    h = torch.clamp((lat - 62.0) / 20.0, 0.0, 1.0) * 2.0
    h = h * (1.0 + float(cfg["h_noise"]) * noise).clamp(min=0.5)
    a = torch.clamp((lat - 60.0) / 10.0, 0.0, 1.0)
    h, a = torch.where(dry, 0.0, h), torch.where(dry, 0.0, a)
    return dict(h=h, a=a, hs=torch.zeros_like(h))


def initial_state(pkg, model, fields):
    return pkg.initial_state(model, **fields)


def work(cfg, traffic):
    """The step's pieces of work a step: three RK3 stages, each one call of
    2.7 on the widened grid (``"evp"``), 2.9 on h, ℵ and hs (``"advection"``),
    one call of 2.11 (``"column"``), and 2.8 with the two winds of 2.10
    (``"pointwise"``)."""
    Nx, Ny, H = int(traffic["Nx"]), int(traffic["Ny"]), int(cfg["halo"])
    nsub = int(cfg["substeps"])
    stages = 3
    padded = (Nx + 2 * H) * (Ny + 2 * H)
    widened = (Nx + 2 * H) * (Ny + 2 * (2 * plain.chunk(nsub) + 5))
    pieces = {"evp": roofline.tiled_curvilinear_evp(widened, nsub),
              "advection": roofline.advection_metrics(padded, 3),
              "column": roofline.layered_column(padded),
              "pointwise": roofline.strength_and_winds(widened, padded, 2)}
    return {k: tuple(stages * q for q in v) for k, v in pieces.items()}
