"""arctic_fixed's plain reference: one SplitRungeKutta3 step of the land-masked
tripolar Arctic basin, in plain PyTorch.

Written from the JAX package's source as the specification, and importing
neither it nor the port (only the WENO face values of this folder's
``periodic_box`` reference):

* the grid, ``climaseaice_jl_tpu/grids.py`` (``TripolarGrid``,
  ``CurvilinearGrid``: corners, great-circle metrics at cc, fc, cf and ff,
  the fold images of the metrics' north halo, the seam row symmetrised);
  the land of ``validation/run_tripolar_basin.py:build`` (four continents,
  the fold-row cells at both grid poles, every cell with min(Δx, Δy) under
  0.2 of the median), made in float32 as the source makes it;
* the fills, ``fields.py``: periodic in x, the southern wall (cc and fc
  fields copy the first interior row, cf and ff fields are 0 beyond the
  wall), the Zipper fold (x mirrored, u and v change sign, a y-face field's
  seam row projected on its fold symmetry); the masks of
  ``peripheral_masks`` and ``immersed_only_ff``;
* the step, ``model.py`` (``rk3_step``, ``tracer_tendencies``,
  ``dynamic_step_tracers``, ``update_state``);
* the momentum, ``dynamics/momentum.py`` (``split_explicit_momentum_step``,
  ``velocity_tendencies`` with the immersed drag, ``_masked_velocity``),
  ``dynamics/rheologies.py`` (the curvilinear strain rates and stress
  divergence, ``compute_evp_viscosities``, ``compute_evp_stresses``),
  ``dynamics/stresses.py`` (the winds with the fold's sign flip, the
  quadratic ocean drag), ``dynamics/coriolis.py`` (``LatitudeCoriolis``);
* the tracers, ``advection.py`` (WENO of order 7, flux form, the fluxes
  through peripheral faces 0);
* the column, ``thermodynamics/slab.py`` (``layered_thermodynamic_step``,
  ``ice_volume_update``, ``snow_ice_formation``), ``heat_bcs.py`` (the
  secant solve, ``RadiativeEmission``), ``forcing_utils.py`` (the cyclical
  ``FieldTimeSeries``);
* the forcing of ``validation/run_distributed_basin.py`` (``_wind_expr``,
  ``solar_flux``) with the Semtner tables of
  ``examples/arctic_basin_seasonal_cycle.py``.

Where it follows kernel 2.7 (the fixed-tile αEVP of
``pallas_evp_tiled_curvilinear.py``, which the configuration's
``fixed_tiles`` selects) rather than the plain ``split_explicit_momentum_step``:
the y halo is widened to 2K + 5 rows, K the substeps' largest divisor up to
15 (``pallas_evp_tiled.py:44-58``); u, v and σ get the fold's fill once
every K substeps, before each chunk, and only the wall's fill between; the
fold halo evolves in between.  Without the immersed drag this is the plain
path's function (a fold-halo point evolves as its mirror), with it the drag
samples each face at its own index and the halo parts from the mirror
(``pallas_evp_tiled_curvilinear.py:1199-1211``).  The coefficients and
updates keep the plain path's forms.  Departures from the source: the state
holds no x halo (x is periodic, so every x shift is a roll of the
interior); the winds, the Coriolis parameter and the solar scale are
evaluated in the dtype of the state, and the monthly tables are
interpolated in float64 and then rounded to it.

It computes in the dtype of the state it is given: float32 as the
configuration states, bfloat16 for the control, float64 for the look at
float32's own rounding.  The state is the program's fields cut by
:func:`interior` (a y-face field keeps its seam row, which the fold's fill
reads), and ``time`` the program's clock before the step.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .periodic_box import weno_face

FIELDS = ("h", "a", "hs", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu", "Tus")
# the program fills every one of them: update_state h, ℵ, hs, Tu, Tus, u, v;
# the momentum step σ and, on the widened grid it crops back, α
FILLED = FIELDS
LOCATION = {"h": "cc", "a": "cc", "hs": "cc", "Tu": "cc", "Tus": "cc", "alpha": "cc",
            "sig11": "cc", "sig22": "cc", "u": "fc", "v": "cf", "sig12": "ff"}
# the compared numbers (seaice_bench/reference/compare.py): a quantile of
# |program − reference| over the live points, over the field's largest value,
# the largest over each group's fields.  Float32's own rounding grows within
# one step to O(1) at a few per cent of the points (packed ice, the ice
# edge's thresholds), in the program as in this reference against its float64
# run, so neither the largest error nor the L2 norm separates float32 from
# bfloat16.  After a 35 s run's 1,100 steps the median of sound runs sits
# 5-240× under a step that returns its state, 6-8× under one that leaves half
# the rows out, and 27-2,000× under bfloat16; the 90th percentile over the
# fold's band (FOLD_ROWS rows) holds the cap, where float32's own error is
# largest, 3.4× under a fold without its change of sign.  α is not
# compared: not carried (each substep derives it afresh), and float32 fixes
# it no better than 0.18 of its largest value at the 90th percentile.
COMPARED = {"tracer_q50": (("h", "a", "hs", "Tu", "Tus"), "q0.5"),
            "velocity_q50": (("u", "v"), "q0.5"),
            "stress_q50": (("sig11", "sig22", "sig12"), "q0.5"),
            "fold_velocity_q90": (("u", "v"), "q0.9@fold")}
FOLD_ROWS = 8
# the comparison hands this reference the program's clock and each field's name
CLOCK_AND_NAMES = True
# the faults planted underneath a run of this cell (seaice_bench/faults.py)
FAULTS = ("unchanged", "half_left_out", "thickness_altered", "fold_sign_flipped",
          "fold_sign_flipped_inside", "forcing_a_month_late")

EARTH_RADIUS = 6371.0e3
DAY = 86400.0
ROTATION = 7.292115e-5
# defaults of the source's constructors (rheologies.py:93-102, stresses.py:50-61,
# momentum.py:126-136, model.py:76-95, slab.py, phase_transitions.py,
# heat_bcs.py:57-66, advection.py:44-47, pallas_evp_tiled.py:44)
RHO_ICE, RHO_SNOW = 900.0, 330.0
COMPACTION_HARDENING, ECCENTRICITY = 20.0, 2.0
MIN_PLASTIC_STRESS = 2e-9
ALPHA_MIN, ALPHA_MAX = 50.0, 300.0
RELAXATION_STRENGTH = math.pi ** 2
RHO_OCEAN, DRAG = 1026.0, 5.5e-3
MIN_CONCENTRATION, MIN_MASS = 1e-3, 1.0
CONSOLIDATION = 0.05
ICE_CONDUCTIVITY, SNOW_CONDUCTIVITY = 2.0, 0.31
LATENT_HEAT = 334e3
LIQUID_DENSITY, LIQUID_HEAT_CAPACITY = 999.8, 4186.0
ICE_DENSITY, ICE_HEAT_CAPACITY = 917.0, 2000.0
SECANT_ITERATIONS = 20
RK3_FRACTIONS = (1.0 / 3.0, 1.0 / 2.0, 1.0)
CHUNK_CAP = 15
KELVIN = 273.15


def chunk(substeps):
    """Kernel 2.7's substeps between fold fills: the largest divisor of
    ``substeps`` up to 15."""
    return max(k for k in range(2, min(CHUNK_CAP, substeps) + 1) if substeps % k == 0)


# --- the grid (numpy float64, as grids.py builds it) ------------------------------------

def _gc_dist(lam1, phi1, lam2, phi2):
    d = np.pi / 180.0
    l1, p1, l2, p2 = lam1 * d, phi1 * d, lam2 * d, phi2 * d
    s = np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin((l2 - l1) / 2) ** 2
    return 2 * EARTH_RADIUS * np.arcsin(np.minimum(1.0, np.sqrt(s)))


def _corners(Nx, Ny, southern, transition, smoothness, poles_longitude):
    """The corner longitudes and latitudes, (Nx+1, Ny+1) (``TripolarGrid``)."""
    Ny_cap = max(4, Ny // 4)
    Ny_s = Ny - Ny_cap
    deg = np.pi / 180.0
    lam_1d = 360.0 * np.arange(Nx + 1) / Nx
    rows_s = southern + (transition - southern) * np.arange(Ny_s + 1) / Ny_s
    r_t = np.tan((90.0 - transition) / 2 * deg)
    u_t = float(smoothness)
    a = r_t / np.cosh(u_t)
    lam = np.empty((Nx + 1, Ny + 1))
    phi = np.empty((Nx + 1, Ny + 1))
    lam[:, :Ny_s + 1] = lam_1d[:, None]
    phi[:, :Ny_s + 1] = rows_s[None, :]
    v = lam_1d * deg
    dphi = (transition - southern) / Ny_s * deg

    def factor(u):
        w = np.sinh(u + 1j * v[:-1])
        r2 = np.abs(a * np.cosh(u + 1j * v[:-1])) ** 2
        return float(np.mean(np.abs(w) * 2.0 / (1.0 + r2)))

    # geometrically graded steps in u, the first matching the rows' spacing
    du0 = dphi / (a * factor(u_t))
    if 0 < du0 < u_t:
        lo, hi = 1e-3, 100.0
        for _ in range(200):
            g = 0.5 * (lo + hi)
            with np.errstate(over="ignore"):
                tot = du0 * (Ny_cap if abs(g - 1) < 1e-12
                             else (np.power(g, float(Ny_cap)) - 1) / (g - 1))
            lo, hi = (g, hi) if tot < u_t else (lo, g)
        if g > 1.25:
            g = 1.25
            du0 = u_t * (g - 1) / (g ** Ny_cap - 1)
        du = du0 * g ** np.arange(Ny_cap)
    else:
        du = np.full(Ny_cap, u_t / Ny_cap)
    u_rows = u_t - np.concatenate([np.cumsum(du)[:-1], [u_t]])
    for j in range(1, Ny_cap + 1):
        z = a * np.cosh(u_rows[j - 1] + 1j * v)
        lam[:, Ny_s + j] = np.angle(z) / deg
        phi[:, Ny_s + j] = 90.0 - 2.0 * np.arctan(np.abs(z)) / deg
    lam = lam + poles_longitude
    lam[Nx, :Ny_s + 1] = lam[0, :Ny_s + 1] + 360.0
    phi[Nx, :] = phi[0, :]
    lam[Nx, Ny_s + 1:] = lam[0, Ny_s + 1:]
    return lam, phi


def _fold_source(Nx, xface):
    """The x index each column's fold image reads."""
    i = np.arange(Nx)
    return (Nx - i) % Nx if xface else Nx - 1 - i


def _pad_metric(q, Hy, xface, yface):
    """An interior metric (Nx, Ny) padded by Hy rows: the south clamped, the
    north the fold's images, the seam row of a y-face metric symmetrised."""
    Nx, Ny = q.shape
    full = np.empty((Nx, Ny + 2 * Hy))
    full[:, Hy:Hy + Ny] = q
    full[:, :Hy] = q[:, :1]
    full[:, Hy + Ny:] = q[:, -1:]
    if Hy == 0:
        return full
    src = _fold_source(Nx, xface)
    if not yface:
        for k in range(Hy):
            full[:, Hy + Ny + k] = full[src, Hy + Ny - 1 - k]
    else:
        full[:, Hy + Ny] = 0.5 * (full[:, Hy + Ny] + full[src, Hy + Ny])
        for k in range(1, Hy):
            full[:, Hy + Ny + k] = full[src, Hy + Ny - k]
    return full


@functools.lru_cache(maxsize=2)
def metrics(Nx, Ny, southern=45.0, transition=65.0, smoothness=2.5, poles_longitude=90.0):
    """The tripolar grid's interior metrics (``dx_cc`` … ``dy_ff``), ``lon_cc``
    and ``lat_cc``, float64, each (Nx, Ny)."""
    lam, phi = _corners(Nx, Ny, southern, transition, smoothness, poles_longitude)

    def to_xyz(lam_d, phi_d):
        lr, pr = np.deg2rad(lam_d), np.deg2rad(phi_d)
        cp = np.cos(pr)
        return np.stack([cp * np.cos(lr), cp * np.sin(lr), np.sin(pr)])

    def to_ll(v):
        v = v / np.linalg.norm(v, axis=0, keepdims=True)
        return np.rad2deg(np.arctan2(v[1], v[0])), np.rad2deg(np.arcsin(np.clip(v[2], -1, 1)))

    xyz = to_xyz(lam, phi)
    lam_xm, phi_xm = to_ll(xyz[:, :-1] + xyz[:, 1:])
    lam_ym, phi_ym = to_ll(xyz[:, :, :-1] + xyz[:, :, 1:])
    lam_c, phi_c = to_ll(xyz[:, :-1, :-1] + xyz[:, 1:, :-1] + xyz[:, :-1, 1:] + xyz[:, 1:, 1:])
    m = {}
    m["dx_cc"] = _gc_dist(lam_ym[:-1], phi_ym[:-1], lam_ym[1:], phi_ym[1:])
    m["dx_cf"] = _gc_dist(lam[:-1], phi[:-1], lam[1:], phi[1:])
    m["dx_fc"] = _gc_dist(np.roll(lam_c, 1, 0), np.roll(phi_c, 1, 0), lam_c, phi_c)
    m["dx_ff"] = _gc_dist(np.roll(lam_xm, 1, 0), np.roll(phi_xm, 1, 0), lam_xm, phi_xm)
    m["dy_cc"] = _gc_dist(lam_xm[:, :-1], phi_xm[:, :-1], lam_xm[:, 1:], phi_xm[:, 1:])
    m["dy_fc"] = _gc_dist(lam[:, :-1], phi[:, :-1], lam[:, 1:], phi[:, 1:])
    dy_cf = np.empty((Nx, Ny + 1))
    dy_cf[:, 1:-1] = _gc_dist(lam_c[:, :-1], phi_c[:, :-1], lam_c[:, 1:], phi_c[:, 1:])
    dy_cf[:, 0], dy_cf[:, -1] = dy_cf[:, 1], dy_cf[:, -2]
    dy_ff = np.empty((Nx + 1, Ny + 1))
    dy_ff[:, 1:-1] = _gc_dist(lam_ym[:, :-1], phi_ym[:, :-1], lam_ym[:, 1:], phi_ym[:, 1:])
    dy_ff[:, 0], dy_ff[:, -1] = dy_ff[:, 1], dy_ff[:, -2]
    m["dy_cf"], m["dy_ff"] = dy_cf, dy_ff
    out = {name: q[:Nx, :Ny] for name, q in m.items()}
    out.update(lon_cc=lam_c, lat_cc=phi_c)
    return out


def tripolar(Nx, Ny, Hy, southern=45.0, transition=65.0):
    """:func:`metrics` padded by Hy rows in y (x without halo): the south
    clamped, the north the fold's images, a y-face metric's seam row
    symmetrised."""
    return {name: _pad_metric(q, Hy, name[-2] == "f", name[-1] == "f")
            for name, q in metrics(Nx, Ny, southern, transition).items()}


def land(Nx, Ny, southern=45.0, transition=65.0):
    """The basin's land over the interior (numpy booleans), from the grid's
    float32 longitudes, latitudes and spacings, as the source makes it."""
    g = {k: v.astype(np.float32) for k, v in metrics(Nx, Ny, southern, transition).items()}
    lon = (g["lon_cc"] + np.float32(180.0)) % np.float32(360.0) - np.float32(180.0)
    lat = g["lat_cc"]
    out = lat < 58.0                                       # southern closure
    out |= (lon > 20) & (lon < 180) & (lat < 73.0)         # "Eurasia"
    out |= (lon > -170) & (lon < -60) & (lat < 72.0)       # "North America"
    out |= (lon > -60) & (lon < -20) & (lat < 80.0)        # "Greenland"
    out[[0, 1, Nx - 1], Ny - 1] = True                     # the fold-row cells
    out[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True            # at the two grid poles
    dmin = np.minimum(g["dx_cc"], g["dy_cc"])
    out |= dmin < 0.2 * np.median(dmin)                    # collapsed cap cells
    return out


# --- shifts, fills and masks on (Nx, Ny + 2·Hy) arrays -------------------------------------

def sp(q, axis):
    """q[I−1]."""
    return torch.roll(q, 1, axis)


def sm(q, axis):
    """q[I+1]."""
    return torch.roll(q, -1, axis)


def ixf(q, axis):
    return 0.5 * (q + sp(q, axis))


def ixc(q, axis):
    return 0.5 * (sm(q, axis) + q)


def south(q, loc, Hy):
    """The southern wall's fill."""
    q = q.clone()
    q[:, :Hy] = 0.0 if loc[1] == "f" else q[:, Hy:Hy + 1]
    return q


@functools.lru_cache(maxsize=16)
def _source(Nx, xface, device):
    return torch.as_tensor(_fold_source(Nx, xface), device=device)


def fold(q, loc, Hy):
    """The Zipper fold's fill of the north halo: x mirrored, u and v negated,
    a y-face field's seam row projected on its symmetry."""
    Nx, n = q.shape
    Ny = n - 2 * Hy
    sign = -1.0 if loc in ("fc", "cf") else 1.0
    r = sign * q[_source(Nx, loc[0] == "f", q.device)]
    q = q.clone()
    if loc[1] == "c":
        q[:, Hy + Ny:] = r[:, Ny:Hy + Ny].flip(1)
    else:
        q[:, Hy + Ny] = 0.5 * (q[:, Hy + Ny] + r[:, Hy + Ny])
        q[:, Hy + Ny + 1:] = r[:, Ny + 1:Hy + Ny].flip(1)
    return q


def fill(q, loc, Hy):
    return fold(south(q, loc, Hy), loc, Hy)


def _rows(name):
    return 1 if LOCATION[name][1] == "f" else 0


def interior(q, halo, name):
    """The program's field ``name`` without its halos; a y-face field keeps
    its seam row (the north face of the last row), which the fold fills from."""
    return q[halo:-halo, halo:q.shape[1] - halo + _rows(name)]


def embed(q, name, Hy):
    """A cut field on (Nx, Ny + 2·Hy), its halos filled."""
    Nx, n = q.shape
    full = q.new_zeros((Nx, n - _rows(name) + 2 * Hy))
    full[:, Hy:Hy + n] = q
    return fill(full, LOCATION[name], Hy)


def region(name, field, shape, device):
    """The points of a compared region on a cut field of ``shape``: "fold",
    the FOLD_ROWS rows next to the fold (a y-face field's seam row among
    them)."""
    if name != "fold":
        raise ValueError(f"no region {name!r}")
    out = torch.zeros(shape, dtype=torch.bool, device=device)
    out[:, -FOLD_ROWS:] = True
    return out


def halo_image(q, halo, name):
    """The padded field whose interior (with the seam of a y-face field) is
    ``q`` and whose halos are its images: periodic in x, the wall in the
    south, the fold in the north."""
    full = embed(q, name, halo)
    return torch.cat([full[-halo:], full, full[:halo]], 0)


@functools.lru_cache(maxsize=4)
def geometry(Nx, Ny, Hy, dtype, device, southern=45.0, transition=65.0):
    """Metrics, coordinates and masks on the y-padded arrays, on ``device``."""
    g = tripolar(Nx, Ny, Hy, southern, transition)
    low = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype

    def t(q):
        return torch.as_tensor(q, dtype=torch.float64).to(low).to(dtype).to(device)

    out = {k: t(v) for k, v in g.items()}
    for loc in ("cc", "fc", "cf", "ff"):
        out["az_" + loc] = out["dx_" + loc] * out["dy_" + loc]
    solid = torch.zeros((Nx, Ny + 2 * Hy))
    solid[:, Hy:Hy + Ny] = torch.as_tensor(land(Nx, Ny, southern, transition), dtype=torch.float32)
    solid = fold(solid, "cc", Hy) > 0.5
    solid[:, :Hy] = True                                   # the southern wall
    solid = solid.to(device)
    per_ff = solid | sp(solid, 0) | sp(solid, 1) | sp(sp(solid, 0), 1)
    wall = torch.zeros_like(solid)
    wall[:, :Hy] = True
    per_wall = wall | sp(wall, 1)
    out.update(solid=solid, per_fc=solid | sp(solid, 0), per_cf=solid | sp(solid, 1),
               per_ff=per_ff, imm_ff=per_ff & ~per_wall)
    return out


# --- the forcing ---------------------------------------------------------------------------

def _series(cfg, name, time):
    """A Semtner table (W m⁻²) at ``time``: monthly means at mid-month,
    cyclical over 360 days, held at its last value past it."""
    per_month = float(cfg["kcal_J"]) / (30 * DAY)
    data = -np.asarray(cfg["semtner"][name], dtype=np.float64) * 1e4 * per_month
    times = np.arange(15, 360, 30) * DAY
    period = times[-1] - times[0] + (times[-1] - times[-2])
    t = times[0] + np.mod(time - times[0], period)
    return float(np.interp(t, times, data, left=data[0], right=data[-1]))


def winds(cfg, g, time, dtype, Hy):
    """The seasonal gyre and transpolar drift stresses at (f,c) and (c,f),
    each evaluated at the cell centres and filled with the fold's sign flip."""
    deg = math.pi / 180.0
    lon = ((g["lon_cc"] + 180.0) % 360.0 - 180.0) * deg
    lat = g["lat_cc"] * deg

    def stereo(lon0, lat0):
        x = torch.cos(lat) * torch.sin(lon - lon0 * deg)
        y = (math.cos(lat0 * deg) * torch.sin(lat)
             - math.sin(lat0 * deg) * torch.cos(lat) * torch.cos(lon - lon0 * deg))
        return x, y

    gx, gy = stereo(-150.0, 80.0)
    fx, fy = stereo(0.0, 78.0)
    r2 = gx * gx + gy * gy
    amp = torch.exp(-r2 / (2 * 0.25 ** 2))
    tau_gx = amp * gy / torch.sqrt(r2 + 1e-6)
    tau_gy = -amp * gx / torch.sqrt(r2 + 1e-6)
    drift = torch.exp(-(fx * fx + fy * fy) / (2 * 0.6 ** 2))
    t = torch.tensor(time, dtype=dtype, device=lon.device)
    seasonal = 1.0 + 0.4 * torch.cos(2 * math.pi * t / (360 * DAY))
    tau0 = float(cfg["tau0"])
    tau_u = tau0 * seasonal * (0.7 * tau_gx + 0.5 * (-drift * fx))
    tau_v = tau0 * seasonal * (0.7 * tau_gy + 0.5 * (-drift * fy))
    return fill(tau_u, "fc", Hy), fill(tau_v, "cf", Hy)


# --- the tracers ------------------------------------------------------------------------------

def divergence(g, c, u, v):
    """∇·(U c) at the centres: [δx(Δy_fc u ĉ) + δy(Δx_cf v ĉ)] / Az_cc, ĉ the
    upwind WENO-7 face value, fluxes through peripheral faces 0."""
    out = None
    for axis, vel, width, per in ((0, u, g["dy_fc"], g["per_fc"]),
                                  (1, v, g["dx_cf"], g["per_cf"])):
        shifted = {k: torch.roll(c, k, axis) for k in range(-3, 5)}
        left = weno_face([shifted[4 - j] for j in range(7)])
        right = weno_face([shifted[j - 3] for j in range(7)])
        face = torch.where(vel > 0, left, torch.where(vel < 0, right, 0.5 * (left + right)))
        flux = torch.where(per, 0.0, width * vel * face)
        term = sm(flux, axis) - flux
        out = term if out is None else out + term
    return out / g["az_cc"]


# --- the momentum: the split-explicit αEVP solver ----------------------------------------------

def _inv(x):
    ok = x > 0
    return torch.where(ok, 1.0 / torch.where(ok, x, torch.ones_like(x)), 0.0)


def momentum(cfg, g, s, u_start, v_start, tau_u, tau_v, f_cc, dt, Hy):
    """``substeps`` αEVP substeps from (u_start, v_start) with the stage's h,
    ℵ, σ; returns (u, v, σ₁₁, σ₂₂, σ₁₂, α), filled."""
    h, a = s["h"], s["a"]
    e_inv2 = ECCENTRICITY ** -2.0
    C_imm = float(cfg["immersed_drag"])
    solid, per_ff = g["solid"], g["per_ff"]
    az_cc, az_fc, az_cf, az_ff = g["az_cc"], g["az_fc"], g["az_cf"], g["az_ff"]
    dx_cc, dx_fc, dx_cf, dx_ff = g["dx_cc"], g["dx_fc"], g["dx_cf"], g["dx_ff"]
    dy_cc, dy_fc, dy_cf, dy_ff = g["dy_cc"], g["dy_fc"], g["dy_cf"], g["dy_ff"]
    m_cc = h * a * RHO_ICE
    a_fc, m_fc = ixf(a, 0), ixf(m_cc, 0)
    a_cf, m_cf = ixf(a, 1), ixf(m_cc, 1)
    m_ff = ixf(ixf(m_cc, 1), 0)
    inv_fc, inv_cf = _inv(m_fc), _inv(m_cf)
    P = float(cfg["ice_compressive_strength"]) * h * torch.exp(-COMPACTION_HARDENING * (1 - a))
    P_ff = ixf(ixf(P, 1), 0)
    moving_u = (m_fc >= MIN_MASS) & (a_fc >= MIN_CONCENTRATION) & ~g["per_fc"]
    moving_v = (m_cf >= MIN_MASS) & (a_cf >= MIN_CONCENTRATION) & ~g["per_cf"]
    f_fc, f_cf = ixf(f_cc, 0), ixf(f_cc, 1)
    # the immersed drag's face weights, on faces whose ff node is immersed
    wx = torch.where(g["imm_ff"], dx_ff, 0.0)
    wy = torch.where(g["imm_ff"], dy_ff, 0.0)

    def gamma(zeta, m, az):
        ok = m > 0
        g2 = torch.where(ok, zeta * RELAXATION_STRENGTH * dt / torch.where(ok, m, 1.0) / az,
                         ALPHA_MAX ** 2)
        g2 = torch.where(torch.isnan(g2), ALPHA_MAX ** 2, g2)
        return torch.clamp(torch.sqrt(g2), ALPHA_MIN, ALPHA_MAX)

    def u_update(u, v, alpha, div_x):
        ia = ixf(alpha, 0)
        dtau = dt / ia
        v_at_u = ixf(ixc(v, 1), 0)
        drag = RHO_OCEAN * DRAG * torch.sqrt((0.0 - u) ** 2 + (0.0 - v_at_u) ** 2)
        Fu = -C_imm * u
        imm = (sm(Fu * wx, 1) + Fu * wx) / az_fc
        G = (f_fc * v_at_u - tau_u * inv_fc * a_fc + div_x * inv_fc
             + (u_start - u) / dtau / ia + imm * inv_fc)
        G = torch.where(m_fc <= 0, 0.0, G)
        implicit = torch.where(m_fc <= 0, 0.0, drag * inv_fc * a_fc)
        return south(torch.where(moving_u, (u + dtau * G) / (1 + dtau * implicit), 0.0),
                     "fc", Hy)

    def v_update(u, v, alpha, div_y):
        ia = ixf(alpha, 1)
        dtau = dt / ia
        u_at_v = ixc(ixf(u, 1), 0)
        drag = RHO_OCEAN * DRAG * torch.sqrt((0.0 - u_at_v) ** 2 + (0.0 - v) ** 2)
        Fv = -C_imm * v
        imm = (sm(Fv * wy, 0) + Fv * wy) / az_cf
        G = (-(f_cf * u_at_v) - tau_v * inv_cf * a_cf + div_y * inv_cf
             + (v_start - v) / dtau / ia + imm * inv_cf)
        G = torch.where(m_cf <= 0, 0.0, G)
        implicit = torch.where(m_cf <= 0, 0.0, drag * inv_cf * a_cf)
        return south(torch.where(moving_v, (v + dtau * G) / (1 + dtau * implicit), 0.0),
                     "cf", Hy)

    u, v = u_start, v_start
    s11, s22, s12, alpha = s["sig11"], s["sig22"], s["sig12"], s["alpha"]
    nsub = int(cfg["substeps"])
    K = chunk(nsub)
    for substep in range(1, nsub + 1):
        if substep % K == 1:        # kernel 2.7's fold fill before each chunk
            u, v = fill(u, "fc", Hy), fill(v, "cf", Hy)
            s11, s22, s12 = fill(s11, "cc", Hy), fill(s22, "cc", Hy), fill(s12, "ff", Hy)
        # curvilinear strain rates: divergence and tension at centres, shear at corners
        eD = ((sm(dy_fc * u, 0) - dy_fc * u) + (sm(dx_cf * v, 1) - dx_cf * v)) / az_cc
        eT = (dy_cc ** 2 * (sm(u / dy_fc, 0) - u / dy_fc)
              - dx_cc ** 2 * (sm(v / dx_cf, 1) - v / dx_cf)) / az_cc
        eS = (dx_ff ** 2 * (u / dx_fc - sp(u / dx_fc, 1))
              + dy_ff ** 2 * (v / dy_cf - sp(v / dy_cf, 0))) / az_ff
        e11, e22, e12 = 0.5 * (eD + eT), 0.5 * (eD - eT), 0.5 * eS
        e11_ff, e22_ff = ixf(ixf(e11, 1), 0), ixf(ixf(e22, 1), 0)
        e12_cc = ixc(ixc(e12, 1), 0)
        shear_cc = torch.sqrt((e11 - e22) ** 2 + 4 * e12_cc ** 2)
        shear_ff = torch.sqrt((e11_ff - e22_ff) ** 2 + 4 * e12 ** 2)
        delta_cc = torch.clamp(torch.sqrt((e11 + e22) ** 2 + shear_cc ** 2 * e_inv2),
                               min=MIN_PLASTIC_STRESS)
        delta_ff = torch.clamp(torch.sqrt((e11_ff + e22_ff) ** 2 + shear_ff ** 2 * e_inv2),
                               min=MIN_PLASTIC_STRESS)
        zeta_cc, zeta_ff = P / (2 * delta_cc), P_ff / (2 * delta_ff)
        pressure = P * delta_cc / (delta_cc + MIN_PLASTIC_STRESS)
        eta_cc, eta_ff = zeta_cc * e_inv2, zeta_ff * e_inv2
        bulk = (zeta_cc - eta_cc) * (e11 + e22) - pressure / 2
        g_cc, g_ff = gamma(zeta_cc, m_cc, az_cc), gamma(zeta_ff, m_ff, az_ff)
        s11 = s11 + torch.where(m_cc > 0, (2 * eta_cc * e11 + bulk - s11) / g_cc, 0.0)
        s22 = s22 + torch.where(m_cc > 0, (2 * eta_cc * e22 + bulk - s22) / g_cc, 0.0)
        s12 = s12 + torch.where(m_ff > 0, (2 * eta_ff * e12 - s12) / g_ff, 0.0)
        alpha = g_cc
        # the metric stress divergence, σ masked on land
        s_ux, s_vy = torch.where(solid, 0.0, s11), torch.where(solid, 0.0, s22)
        s_xy = torch.where(per_ff, 0.0, s12)
        sD, sT = s_ux + s_vy, s_ux - s_vy
        div_x = (dy_fc * (sD - sp(sD, 0)) / 2
                 + (dy_cc ** 2 * sT - sp(dy_cc ** 2 * sT, 0)) / dy_fc / 2
                 + (sm(dx_ff ** 2 * s_xy, 1) - dx_ff ** 2 * s_xy) / dx_fc) / az_fc
        div_y = (dx_cf * (sD - sp(sD, 1)) / 2
                 - (dx_cc ** 2 * sT - sp(dx_cc ** 2 * sT, 1)) / dx_cf / 2
                 + (sm(dy_ff ** 2 * s_xy, 0) - dy_ff ** 2 * s_xy) / dy_cf) / az_cf
        # the two half-updates alternate their order from substep to substep
        if substep % 2 == 0:
            u = u_update(u, v, alpha, div_x)
            v = v_update(u, v, alpha, div_y)
        else:
            v = v_update(u, v, alpha, div_y)
            u = u_update(u, v, alpha, div_x)
    return (fill(u, "fc", Hy), fill(v, "cf", Hy), fill(s11, "cc", Hy), fill(s22, "cc", Hy),
            fill(s12, "ff", Hy), fill(alpha, "cc", Hy))


# --- the column: slab ice under slab snow ------------------------------------------------------

def _latent_heat(T):
    return LATENT_HEAT + (LIQUID_DENSITY * LIQUID_HEAT_CAPACITY / ICE_DENSITY
                          - ICE_HEAT_CAPACITY) * T


def _safe_div(num, den, ok):
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), 0.0)


def _ice_volume_update(dVdt, hn, an, dt):
    V1 = torch.clamp(hn * an + dt * dVdt, min=0.0)
    dVdt = (V1 - hn * an) / dt
    freezing = dVdt >= 0
    grow = torch.where(freezing, (1 - an) * (dVdt / CONSOLIDATION), 0.0)
    melt = torch.where(~freezing & (hn > 0), an * _safe_div(dVdt, 2 * hn, hn > 0), 0.0)
    a1 = torch.clamp(an + dt * (grow + melt), min=0.0)
    h1 = torch.where(a1 <= 0, 0.0, _safe_div(V1, a1, a1 > 0))
    a1 = torch.where(dVdt == 0, an, a1)
    h1 = torch.where(dVdt == 0, hn, h1)
    a1 = torch.where(h1 == 0, 0.0, a1)
    h1 = torch.where(a1 == 0, 0.0, h1)
    return torch.where(a1 > 1, h1 * a1, h1), torch.where(a1 > 1, 1.0, a1)


def column(cfg, g, h, a, hs, Tus, time, dt, sw_scale):
    """One step of the layered column (snow on slab ice): the snow surface
    temperature from the flux balance (secant, capped at melting), the
    interface temperature, snow melt, the closed-form concentration, the
    Stefan volume change, snowfall and flooding; returns (h, ℵ, hs, Tu, Tus)."""
    Tb = 0.0       # the ocean's freezing point at zero salinity
    albedo_cold, albedo_warm = float(cfg["albedo"][0]), float(cfg["albedo"][1])
    shortwave = _series(cfg, "shortwave", time)
    emissivity, sigma = float(cfg["emissivity"]), float(cfg["stefan_boltzmann"])
    bottom = float(cfg["bottom_heat_flux"])
    snowfall = float(cfg["snowfall"])
    series = [_series(cfg, n, time) for n in ("longwave", "sensible", "latent")]

    def top_flux(T):   # the solar FluxFunction, the three series, emission
        albedo = torch.full_like(T, albedo_warm).masked_fill_(T < -0.1, albedo_cold)
        total = shortwave * sw_scale * (1 - albedo)
        for q in series:
            total = total + q
        return total + emissivity * sigma * (T + KELVIN) ** 4

    def conduction(T, hi, hsn):
        R = hsn / SNOW_CONDUCTIVITY + hi / ICE_CONDUCTIVITY
        return _safe_div(Tb - T, R, R > 0)

    consolidated = h >= CONSOLIDATION
    T1, T2 = Tus + 1.0, Tus + 0.0
    F1 = top_flux(T1) - conduction(T1, h, hs)
    F2 = top_flux(T2) - conduction(T2, h, hs)
    for _ in range(SECANT_ITERATIONS):
        dF = F2 - F1
        ok = dF.abs() > 0
        T3 = T2 - torch.where(ok, F2 * (T2 - T1) / torch.where(ok, dF, 1.0), 0.0)
        T1, F1, T2, F2 = T2, F2, T3, top_flux(T3) - conduction(T3, h, hs)
    # capped at melting: 0 °C under snow and, at zero salinity, on bare ice
    Tus = torch.where(consolidated, torch.clamp(T2, max=0.0), torch.full_like(T2, Tb))
    Ri, Rs = h / ICE_CONDUCTIVITY, hs / SNOW_CONDUCTIVITY
    R = Rs + Ri
    Tsi = torch.where(R > 0, Tb + (Tus - Tb) * _safe_div(Ri, R, R > 0), Tb)
    Qis = torch.where(consolidated, conduction(Tus, h, hs), 0.0)
    Qui = top_flux(Tus)
    dQ = _safe_div(Qui, a, a > 0) - Qis
    melt_energy = torch.clamp(-dQ, min=0.0)
    Qs = torch.minimum(melt_energy, RHO_SNOW * LATENT_HEAT * hs / dt)
    Gs_minus = Qs / (RHO_SNOW * LATENT_HEAT)
    rhoiL = RHO_ICE * LATENT_HEAT
    alpha = (Qui - bottom) / rhoiL
    beta = Qs / rhoiL
    one = torch.ones_like(h)
    Km = dt * torch.where(h > 0, a * _safe_div(one, 2 * h, h > 0), 0.0)
    Kf = dt * ((1 - a) * (1.0 / CONSOLIDATION))
    eps = torch.finfo(h.dtype).eps
    Dm, Df = 1 - Km * beta, 1 - Kf * beta
    am = torch.where(Dm.abs() > eps, (a + Km * alpha) / torch.where(Dm.abs() > eps, Dm, 1.0),
                     a + Km * alpha)
    af = torch.where(Df.abs() > eps, (a + Kf * alpha) / torch.where(Df.abs() > eps, Df, 1.0),
                     a + Kf * alpha)
    a_tmp = torch.where(alpha + beta * am < 0, am, af)
    Qui_eff = Qui + Qs * a_tmp
    Qii = torch.where(consolidated, _safe_div(-ICE_CONDUCTIVITY * (Tsi - Tb), h, h > 0), 0.0)
    dVdt = ((Qui_eff - Qii) / (RHO_ICE * _latent_heat(Tsi))
            + (Qii - bottom) / (RHO_ICE * _latent_heat(torch.full_like(Tsi, Tb))))
    h1, a1 = _ice_volume_update(dVdt, h, a, dt)
    hs1 = torch.where(a1 > 0, hs * a * _safe_div(one, a1, a1 > 0), 0.0)
    gain = torch.where(a1 > 0, torch.full_like(a1, snowfall / RHO_SNOW), 0.0)
    hs1 = torch.clamp(hs1 + dt * (gain - Gs_minus), min=0.0)
    # flooding: snow below the waterline turns to ice
    freeboard = h1 * (1 - RHO_ICE / LIQUID_DENSITY) - hs1 * RHO_SNOW / LIQUID_DENSITY
    flooded = torch.where(freeboard < 0, -freeboard * RHO_ICE / RHO_SNOW, 0.0)
    hs2 = torch.clamp(hs1 - flooded, min=0.0)
    h1 = h1 + (hs1 - hs2) * RHO_SNOW / RHO_ICE
    hs2 = torch.where(a1 <= 0, 0.0, hs2)
    return h1, a1, hs2, Tsi, Tus


def latitudes(cfg):
    """The grid's southernmost and transition latitudes."""
    return float(cfg["southernmost_latitude"]), float(cfg["transition_latitude"])


# --- the step -----------------------------------------------------------------------------------

def initial(cfg, traffic, fields, dtype=torch.float32):
    """The initial state's cuts from the input fields: no land ice, no
    velocity or stress, the largest relaxation parameter, both surfaces at 0 °C."""
    Nx, Ny = int(traffic["Nx"]), int(traffic["Ny"])
    h = fields["h"].to(dtype)
    dry = torch.as_tensor(land(Nx, Ny, *latitudes(cfg)), device=h.device)

    def wet(q):
        return torch.where(dry, 0.0, q.to(dtype))

    zero = torch.zeros_like(h)
    seam = h.new_zeros((Nx, Ny + 1))
    return dict(h=wet(h), a=wet(fields["a"]), hs=wet(fields["hs"]), u=zero, v=seam,
                sig11=zero, sig22=zero, sig12=seam, alpha=torch.full_like(h, ALPHA_MAX),
                Tu=zero, Tus=zero)


def step(cfg, traffic, state, dt, time=0.0):
    """One SplitRungeKutta3 step from the cuts ``state`` at clock ``time``:
    three stages from Ψ⁻ with Δτ = Δt/3, Δt/2, Δt, each advecting h, ℵ, hs
    with the stage's velocities, running the αEVP from Ψ⁻'s velocities,
    rebasing the tracers on Ψ⁻, running the column and masking and filling
    the state; the forcing at ``time`` throughout."""
    Nx, Ny = int(traffic["Nx"]), int(traffic["Ny"])
    dtype, device = state["h"].dtype, state["h"].device
    Hy = 2 * chunk(int(cfg["substeps"])) + 5
    g = geometry(Nx, Ny, Hy, dtype, device, *latitudes(cfg))
    psi = {n: embed(q.to(dtype), n, Hy) for n, q in state.items()}
    tau_u, tau_v = winds(cfg, g, time, dtype, Hy)
    f_cc = 2.0 * ROTATION * torch.sin(torch.deg2rad(g["lat_cc"]))
    sw_scale = torch.clamp(torch.cos(g["lat_cc"] * (math.pi / 180.0))
                           / math.cos(75.0 * math.pi / 180.0), 0.3, 1.6)
    s = dict(psi)
    for frac in RK3_FRACTIONS:
        dtau = dt * torch.tensor(frac, dtype=dtype, device=device)
        G = {n: -divergence(g, s[n], s["u"], s["v"]) for n in ("h", "a", "hs")}
        u, v, s11, s22, s12, alpha = momentum(cfg, g, s, psi["u"], psi["v"], tau_u, tau_v,
                                              f_cc, dtau, Hy)
        h = torch.clamp(psi["h"] + dtau * G["h"], min=0.0)
        a = torch.clamp(psi["a"] + dtau * G["a"], min=0.0)
        a = torch.where(h == 0, 0.0, a)
        h = torch.where(a == 0, 0.0, h)
        h, a = torch.where(a > 1, h * a, h), torch.where(a > 1, 1.0, a)
        hs = torch.clamp(psi["hs"] + dtau * G["hs"], min=0.0)
        hs = torch.where(a <= 0, 0.0, hs)
        h, a, hs, Tu, Tus = column(cfg, g, h, a, hs, s["Tus"], time, dtau, sw_scale)
        # update_state: land and peripheral nodes masked, every halo filled
        solid = g["solid"]
        s = {n: fill(torch.where(solid, 0.0, q), "cc", Hy)
             for n, q in (("h", h), ("a", a), ("hs", hs), ("Tu", Tu), ("Tus", Tus))}
        s.update(u=fill(torch.where(g["per_fc"], 0.0, u), "fc", Hy),
                 v=fill(torch.where(g["per_cf"], 0.0, v), "cf", Hy),
                 sig11=s11, sig22=s22, sig12=s12, alpha=alpha)
    return {n: s[n][:, Hy:Hy + Ny + _rows(n)] for n in FIELDS}
