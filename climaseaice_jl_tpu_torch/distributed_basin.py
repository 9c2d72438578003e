"""The tripolar basin of the distributed validation: the configuration of
`validation/run_distributed_basin.py:build` in this package, and its run
serially and over a mesh of ranks (:func:`run_distributed`, the script's
``main``):

    python -m climaseaice_jl_tpu_torch.distributed_basin --size 1152x960 \
        --mesh 2x2 --fixed-tiles 8x128 [--no-drag] [--steps 3] [--device cpu] \
        [--output DIR]

spawns Px·Py ranks on this machine, steps the basin serially and
distributed, and with ``--fixed-tiles`` gates bit-for-bit equality of u, v,
h, ℵ and hs, as the script does (`run_distributed_basin.py:270-286`),
except with the immersed drag on a mesh that splits the fold across x:
that run is held to :func:`xsplit_drag_band`.  With ``--output`` each rank
writes its snapshot and sharded checkpoint there, rank 0's reassembly of
the snapshots is checked against the gathered state, and h, ℵ, u and v
stream to ``DIR/dist_basin.nc`` through the NetCDF writer, as the script
does (`run_distributed_basin.py:177-269`).

A land-masked ``TripolarGrid`` (45°N to the fold, cap from 65°N, halo 5)
with the script's own idealised continents and the pole-row cells as land;
αEVP with ``FPlane(f=1.4e-4)``, a seasonal anticyclonic gyre plus
transpolar drift as two ``StressFunction`` winds evaluated from the grid
argument's longitudes and latitudes, quadratic ocean drag and
``ImmersedDrag(1e-3)``; slab ice and snow under the Semtner climatology with
a latitude-scaled shortwave ``FluxFunction`` and radiative emission,
snowfall 3.2e-6 kg m⁻² s⁻¹, a −2 W m⁻² ocean flux; WENO-7 and Forward
Euler.  With ``fixed_tiles`` the solver is ``SplitExplicitSolver(substeps,
fixed_tiles, halo_exchange="wide", fused="always")``, without it
``halo_exchange="per_substep"`` unless another policy is asked for (under
"wide" its shards run kernel 2.7's unpinned plan), and the winds are
evaluated by the fixed-tile pointwise kernel
(:func:`.dynamics.fixed_tile_pointwise.fixed_tile_pointwise`); without it,
eagerly.  The initial fields are formed in numpy float32 from the grid's
latitudes, as the script forms them, so that both devices start from the
same bits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

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
          halo=5, device=None, drag=True, halo_exchange=None):
    """``(model, state)`` of `run_distributed_basin.py:build(Nx, Ny, substeps,
    max_relaxation, fixed_tiles, thermo)` on ``device`` (default the card);
    ``halo`` other than 5 serves the halo-width invariance checks,
    ``drag=False`` leaves out the immersed drag, and ``halo_exchange`` sets
    the solver's halo policy (by default "wide" with ``fixed_tiles``, else
    "per_substep")."""
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
        immersed_drag=ImmersedDrag(coefficient=1e-3) if drag else None,
        solver=SplitExplicitSolver(
            substeps=substeps, fixed_tiles=fixed_tiles,
            halo_exchange=halo_exchange or ("wide" if fixed_tiles else "per_substep"),
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


# the rows next to the grid poles, reported apart (`run_distributed_basin.py:233-240`)
CAP = 12
GATED = ("u", "v", "h", "a", "hs")


def compare(serial, distributed):
    """Per field of ``serial`` (interior-only numpy arrays, as is
    ``distributed``): the count of points that differ, the largest
    difference off and in the ``CAP`` rows next to the pole over the
    field's largest value, and the deepest differing row counted down from
    the top one (-1 where none differs)."""
    out = {}
    for name, ref in serial.items():
        got = distributed[name]
        d = np.abs(got.astype(np.float64) - ref) / max(np.abs(ref).max(), 1e-8)
        rows = np.flatnonzero((got != ref).any(axis=0))
        out[name] = dict(points=int((got != ref).sum()), rel_err=float(d[:, :-CAP].max()),
                         cap_rel_err=float(d[:, -CAP:].max()),
                         deepest_row=int(ref.shape[1] - 1 - rows.min()) if len(rows) else -1)
    return out


def within_bars(rel_err, max_relaxation):
    """The script's bars where serial and distributed need not agree bit for
    bit (`run_distributed_basin.py:279-286`), on the largest differences
    off the ``CAP`` rows: u, v below 2e-2 and h, ℵ, hs below 5e-3 at
    α⁺ = 300; 5e-3 and 1e-4 in the contractive regime (α⁺ ≥ 1e3)."""
    vel, tracer = (5e-3, 1e-4) if max_relaxation >= 1e3 else (2e-2, 5e-3)
    return all(rel_err[k] < (vel if k in ("u", "v") else tracer)
               for k in GATED if k in rel_err)


def xsplit_drag_band(cmp, rows, max_relaxation):
    """Whether a fixed-tile run with the immersed drag and the fold split
    across x stays in its band: every differing point in the top ``rows``
    rows (the fold halo, which evolves there without refills and is not an
    exact mirror where the drag samples a face at its own index) and the
    script's bars off the ``CAP`` rows (:func:`within_bars`)."""
    return (all(c["deepest_row"] < rows for c in cmp.values())
            and within_bars({n: c["rel_err"] for n, c in cmp.items()}, max_relaxation))


def run_distributed(Nx, Ny, mesh=(1, 4), steps=3, dt=600.0, fixed_tiles=None, thermo=True,
                    drag=True, max_relaxation=300.0, substeps=24, device=None, timeout=None,
                    output=None):
    """The basin stepped ``steps`` times serially on ``device`` (default the
    card) and on a ``mesh`` of Px·Py spawned ranks (on the CPU where
    ``device`` is, else on their default devices).
    Returns the serial and gathered interior-only fields (numpy; the y-face
    fields keep the seam row), each rank's record (ms per step, kernel calls
    and launches, bytes sent per step) and the comparison (:func:`compare`).
    With ``output`` (a directory), the ranks' snapshots and sharded
    checkpoints go there and the result also holds the reassembled
    ``snapshot`` and the ``netcdf`` file written from it
    (:func:`write_netcdf`)."""
    from .model import step
    from .parallel import launch, strip_halos
    kw = dict(Nx=Nx, Ny=Ny, substeps=substeps, fixed_tiles=fixed_tiles, thermo=thermo,
              drag=drag, max_relaxation=max_relaxation)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    names = ("u", "v", "h", "a") + (("hs",) if thermo else ()) + (
        "sig11", "sig22", "sig12", "alpha")
    case = dict(build=build, kwargs=kw, mesh=tuple(mesh), steps=steps, dt=dt, names=names,
                device="cpu" if on_cpu else None, io=output)
    result = launch.run_cases([case], mesh[0] * mesh[1], timeout=timeout)[0]
    model, state = build(device=device, **kw)
    for _ in range(steps):
        state = step(model, state, dt)
    serial_state = strip_halos(model, state)
    serial = {n: getattr(serial_state, n).cpu().numpy() for n in names}
    out = dict(serial=serial, distributed=result["fields"], records=result["records"],
               comparison=compare(serial, result["fields"]))
    if output is not None:
        out["snapshot"] = result["snapshot"]
        out["netcdf"] = write_netcdf(model, serial_state, result["snapshot"],
                                     os.path.join(output, "dist_basin.nc"), dt)
    return out


def write_netcdf(model, state_int, snapshot, path, dt):
    """Stream h, ℵ, u and v of the reassembled ``snapshot`` (global
    interior-only numpy fields) to the NetCDF file ``path``: the snapshot's
    fields put into the interior-only ``state_int`` (whose clock they share),
    padded and filled, through :class:`.io.NetCDFWriter`."""
    from .io import NetCDFWriter
    from .parallel import unstrip_halos
    from .simulation import Simulation, IterationInterval
    grid = model.grid
    upd = {n: torch.as_tensor(q, device=grid.device) for n, q in snapshot.items()
           if n != "time" and getattr(state_int, n, None) is not None}
    full = unstrip_halos(model, state_int.evolve(**upd))
    sim = Simulation(model, full, dt=dt)
    NetCDFWriter(["h", "a", "u", "v"], path, IterationInterval(1)).maybe_write(sim)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description="The tripolar basin serially and over a mesh of "
                                             "ranks, compared (run_distributed_basin.py).")
    ap.add_argument("--size", default="360x300")
    ap.add_argument("--mesh", default="1x4", help="PxxPy, e.g. 2x2")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dt", type=float, default=600.0)
    ap.add_argument("--substeps", type=int, default=24)
    ap.add_argument("--alpha-max", type=float, default=300.0)
    ap.add_argument("--fixed-tiles", default=None, help="TXxTY, e.g. 8x128: the "
                    "decomposition-invariant mode, gated bit for bit")
    ap.add_argument("--no-thermo", action="store_true")
    ap.add_argument("--no-drag", action="store_true", help="leave out the immersed drag")
    ap.add_argument("--device", default=None, help="the serial run's device (default the card)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds the ranks may take before they are stopped")
    ap.add_argument("--output", default=None, help="a directory for the ranks' snapshots and "
                    "sharded checkpoints and the NetCDF file of the reassembled fields")
    args = ap.parse_args(argv)
    Nx, Ny = map(int, args.size.split("x"))
    mesh = tuple(map(int, args.mesh.split("x")))
    fixed = tuple(map(int, args.fixed_tiles.split("x"))) if args.fixed_tiles else None
    out = run_distributed(Nx, Ny, mesh, args.steps, args.dt, fixed, not args.no_thermo,
                          not args.no_drag, args.alpha_max, args.substeps, args.device,
                          args.timeout, args.output)
    cmp = out["comparison"]
    snapshot_ok = True
    if args.output is not None:
        snapshot_ok = all(np.array_equal(out["snapshot"][n], q)
                          for n, q in out["distributed"].items())
    errs = {n: c["rel_err"] for n, c in cmp.items()}
    print(json.dumps({
        "grid": f"{Nx}x{Ny} tripolar immersed", "mesh": list(mesh), "steps": args.steps,
        "dt_s": args.dt, "fixed_tiles": args.fixed_tiles, "thermo": not args.no_thermo,
        "drag": not args.no_drag, "serial_vs_distributed_rel_err": errs,
        "pole_cap_band_rel_err": {n: c["cap_rel_err"] for n, c in cmp.items()},
        "bitwise_equal": {n: c["points"] == 0 for n, c in cmp.items()},
        "deepest_differing_row": {n: c["deepest_row"] for n, c in cmp.items()},
        "devices": [r["device"] for r in out["records"]],
        "ms_per_step": [r["ms_per_step"] for r in out["records"]],
        "bytes_per_step": [r["bytes_per_step"] for r in out["records"]],
        "staged_through_host": [r["stage"] for r in out["records"]],
        "snapshot_equals_gather": snapshot_ok if args.output else None,
        "checkpoint_bitwise": ([r["checkpoint_bitwise"] for r in out["records"]]
                               if args.output else None),
        "netcdf": out.get("netcdf")}))
    if fixed is not None and mesh[0] > 1 and not args.no_drag:
        ok = xsplit_drag_band(cmp, 2 * args.substeps + 3, args.alpha_max)
    elif fixed is not None:
        ok = all(cmp[n]["points"] == 0 for n in GATED if n in cmp)
    else:
        ok = within_bars(errs, args.alpha_max)
    ok = ok and snapshot_ok and all(r.get("checkpoint_bitwise", True) for r in out["records"])
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
