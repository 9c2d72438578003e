"""Staggered C-grid with precomputed metric tensors.

Counterpart of `climaseaice_jl_tpu/grids.py` (``Grid``, ``RectilinearGrid``,
``LatitudeLongitudeGrid``, ``CurvilinearGrid``, ``TripolarGrid``,
``ImmersedBoundaryGrid`` and ``south_crop_grid``).  Every 2-D field is a
halo-inclusive tensor of shape ``(Nx + 2*Hx, Ny + 2*Hy)`` shared by all four
staggered locations (cc, fc, cf, ff); center ``i`` lives at index ``Hx + i``
and a face with the same index sits at the *left/south* edge of that center.
y is the contiguous axis.  Metrics broadcast against that shape: 0-d tensors
on uniform rectilinear grids, ``(1, nyp)`` rows on latitude-longitude grids
and ``(nxp, nyp)`` arrays on curvilinear ones.  The curvilinear metrics are
built in float64 numpy, as the JAX package builds them, and cast once to the
grid dtype, so the two packages' metric arrays are equal element for
element.

A ``north_fold`` grid (tripolar) folds its north edge onto itself with x
reversed (the Zipper fold, :mod:`.fields`); it needs periodic x, bounded y
and an even Nx.

Degenerate (``flat``) directions have size 1, halo 0 and unit metrics.

Every grid carries an explicit ``device`` and ``dtype``; ``device=None``
means the CUDA card.

A grid of one rank's shard (:mod:`.parallel.stepper`) names the mesh axes
split across ranks, the mesh shape and the rank's process mesh: its halo
fills along a split direction exchange strips with the neighbouring ranks,
and the physical boundaries apply only on the shards at the global edges.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import frozen_dataclass, numpy_dtype, resolve_device, torch_dtype

PERIODIC = "periodic"
BOUNDED = "bounded"
FLAT = "flat"

EARTH_RADIUS = 6371.0e3  # m


@frozen_dataclass
class Grid:
    Nx: int = None
    Ny: int = None
    Hx: int = None
    Hy: int = None
    topology: tuple = None  # (TX, TY) each in {periodic, bounded, flat}
    dtype: torch.dtype = None
    device: torch.device = None
    kind: str = "rectilinear"   # rectilinear | latlon | curvilinear
    north_fold: bool = False

    # distributed shard info (None on serial grids): the axis name of each
    # direction split across ranks ("x", "y" or None), the mesh shape
    # (Px, Py), and the rank's process mesh (its position (ix, iy), its row
    # and column groups and the transport of its exchanges)
    mesh_axes: tuple = None
    mesh_shape: tuple = None
    mesh: object = None

    # padded 1-D coordinates
    xc: object = None
    xf: object = None
    yc: object = None
    yf: object = None

    # metric terms, broadcastable against (nxp, nyp)
    dx_cc: object = None
    dx_fc: object = None
    dx_cf: object = None
    dx_ff: object = None
    dy_cc: object = None
    dy_fc: object = None
    dy_cf: object = None
    dy_ff: object = None
    az_cc: object = None
    az_fc: object = None
    az_cf: object = None
    az_ff: object = None

    # padded (nxp, nyp) cell-centre longitude/latitude in degrees on
    # curvilinear grids (None elsewhere): periodic in x, edge-clamped in y,
    # fold images north of a folded edge
    lon_cc: object = None
    lat_cc: object = None

    # immersed boundary: boolean (nxp, nyp) tensor on the grid device, True
    # where solid (land); None on grids without land
    solid_cc: object = None

    @property
    def nxp(self):
        return self.Nx + 2 * self.Hx

    @property
    def nyp(self):
        return self.Ny + 2 * self.Hy

    @property
    def shape(self):
        """Padded field shape."""
        return (self.nxp, self.nyp)

    @property
    def interior_shape(self):
        return (self.Nx, self.Ny)

    def interior(self, q):
        """View of the interior region of a padded field."""
        return q[self.Hx:self.Hx + self.Nx, self.Hy:self.Hy + self.Ny]

    def set_interior(self, q, values):
        """Copy of ``q`` whose interior is ``values`` (broadcast)."""
        values = torch.as_tensor(values, dtype=q.dtype, device=q.device)
        q = q.clone()
        q[self.Hx:self.Hx + self.Nx, self.Hy:self.Hy + self.Ny] = \
            values.broadcast_to(self.interior_shape)
        return q

    def new_field(self, fill=0.0):
        """Allocate a padded field (location is a usage convention)."""
        return torch.full(self.shape, fill, dtype=self.dtype, device=self.device)

    def scalar(self, value):
        """0-d tensor of ``value`` rounded to the grid dtype, on the grid
        device (the JAX package's ``jnp.asarray(x, dtype)``).  A Python
        number goes through ``torch.full``: no host-to-device copy, so no
        stream synchronisation."""
        if isinstance(value, torch.Tensor):
            return value.to(dtype=self.dtype, device=self.device)
        return torch.full((), value, dtype=self.dtype, device=self.device)

    def field_from(self, values):
        """Padded field whose interior equals ``values`` (scalar, array or
        callable).  Callables receive ``(x, y)`` broadcast tensors of
        cell-center coordinates on the grid device."""
        q = self.new_field()
        if callable(values):
            x = self.xc[self.Hx:self.Hx + self.Nx, None]
            y = self.yc[None, self.Hy:self.Hy + self.Ny]
            values = values(x, y)
        return self.set_interior(q, values)

    @property
    def is_immersed(self):
        return self.solid_cc is not None


def _topo(t):
    if t not in (PERIODIC, BOUNDED, FLAT):
        raise ValueError(f"unknown topology {t!r}")
    return t


def _pad_coords(N, H, lo, hi, dtype):
    """Padded center & face coordinate vectors for a uniform spacing."""
    if N == 0:
        N = 1
    d = (hi - lo) / N
    idx = np.arange(-H, N + H)
    xf = lo + idx * d
    xc = xf + 0.5 * d
    return xc.astype(dtype), xf.astype(dtype), d


def RectilinearGrid(size=None, x=(0.0, 1.0), y=(0.0, 1.0),
                    topology=None, halo=None, dtype="float64",
                    north_fold=False, device=None):
    """Uniform rectilinear grid.  ``size`` may be ``()`` (0-D column),
    ``(Nx,)`` (1-D) or ``(Nx, Ny)``; ``topology`` entries are 'periodic',
    'bounded' or 'flat' (flat directions are implied by missing sizes).
    ``device=None`` places the grid on the CUDA card and raises where there
    is none.  ``north_fold`` closes the north edge with the Zipper fold."""
    device = resolve_device(device)
    tdt = torch_dtype(dtype)
    npdt = numpy_dtype(tdt)

    size = tuple(size) if size is not None else ()
    if len(size) == 0:
        Nx, Ny = 1, 1
        topo = (FLAT, FLAT)
    elif len(size) == 1:
        Nx, Ny = size[0], 1
        topo = topology or (PERIODIC, FLAT)
    else:
        Nx, Ny = size
        topo = topology or (PERIODIC, PERIODIC)
    topo = (_topo(topo[0]), _topo(topo[1]))

    if halo is None:
        halo = 4
    Hx = 0 if topo[0] == FLAT else halo
    Hy = 0 if topo[1] == FLAT else halo

    xc, xf, dx = _pad_coords(Nx, Hx, *x, npdt) if topo[0] != FLAT else \
        (np.zeros(Nx, npdt) + 0.5, np.zeros(Nx, npdt), 1.0)
    yc, yf, dy = _pad_coords(Ny, Hy, *y, npdt) if topo[1] != FLAT else \
        (np.zeros(Ny, npdt) + 0.5, np.zeros(Ny, npdt), 1.0)

    # metrics rounded to the grid dtype first, area as their product in
    # that dtype (as the JAX package computes them)
    dx = np.asarray(dx, npdt)[()]
    dy = np.asarray(dy, npdt)[()]
    az = dx * dy

    if north_fold:
        _check_fold(topo, Nx)

    def mk(v):
        return torch.as_tensor(np.asarray(v, npdt), device=device)

    return Grid(
        Nx=Nx, Ny=Ny, Hx=Hx, Hy=Hy, topology=topo, dtype=tdt, device=device,
        kind="rectilinear", north_fold=north_fold,
        xc=mk(xc), xf=mk(xf), yc=mk(yc), yf=mk(yf),
        dx_cc=mk(dx), dx_fc=mk(dx), dx_cf=mk(dx), dx_ff=mk(dx),
        dy_cc=mk(dy), dy_fc=mk(dy), dy_cf=mk(dy), dy_ff=mk(dy),
        az_cc=mk(az), az_fc=mk(az), az_cf=mk(az), az_ff=mk(az),
        solid_cc=None,
    )


def _check_fold(topo, Nx):
    if topo != (PERIODIC, BOUNDED):
        raise ValueError("north_fold requires (periodic, bounded) topology")
    if Nx % 2:
        raise ValueError("north_fold requires even Nx (fold pairs i ↔ Nx-1-i)")


def LatitudeLongitudeGrid(size, longitude=(0.0, 360.0), latitude=(-80.0, 80.0),
                          topology=None, halo=None, dtype="float64",
                          radius=EARTH_RADIUS, device=None):
    """Uniform latitude-longitude spherical-shell grid with the exact
    spherical-cell metrics ``Δy = R Δφ``, ``Δx(φ) = R cos φ Δλ`` and
    ``Az = R² Δλ (sin φ₊ − sin φ₋)``; the x metrics and areas are (1, nyp)
    rows."""
    device = resolve_device(device)
    tdt = torch_dtype(dtype)
    npdt = numpy_dtype(tdt)
    Nx, Ny = size
    topo = topology or (PERIODIC, BOUNDED)
    topo = (_topo(topo[0]), _topo(topo[1]))
    if halo is None:
        halo = 4
    Hx = 0 if topo[0] == FLAT else halo
    Hy = 0 if topo[1] == FLAT else halo

    f64 = np.dtype("float64")
    lamc, lamf, dlam = _pad_coords(Nx, Hx, *longitude, f64)
    phic, phif, dphi = _pad_coords(Ny, Hy, *latitude, f64)
    deg = np.pi / 180.0
    dlam_r = dlam * deg
    dphi_r = dphi * deg

    dy = radius * dphi_r
    dx_at_c = radius * np.cos(phic * deg) * dlam_r   # (nyp,) at centre latitudes
    dx_at_f = radius * np.cos(phif * deg) * dlam_r   # (nyp,) at face latitudes
    sin_f = np.sin(phif * deg)
    sin_c = np.sin(phic * deg)
    az_at_c = np.empty_like(sin_c)
    az_at_c[:-1] = radius ** 2 * dlam_r * (sin_f[1:] - sin_f[:-1])
    az_at_c[-1] = az_at_c[-2]
    az_at_f = np.empty_like(sin_c)
    az_at_f[1:] = radius ** 2 * dlam_r * (sin_c[1:] - sin_c[:-1])
    az_at_f[0] = az_at_f[1]

    def mk(v):
        return torch.as_tensor(np.asarray(v, npdt), device=device)

    def row(v):   # (1, nyp) broadcast row
        return mk(v[None, :])

    return Grid(
        Nx=Nx, Ny=Ny, Hx=Hx, Hy=Hy, topology=topo, dtype=tdt, device=device,
        kind="latlon",
        xc=mk(lamc), xf=mk(lamf), yc=mk(phic), yf=mk(phif),
        dx_cc=row(dx_at_c), dx_fc=row(dx_at_c), dx_cf=row(dx_at_f), dx_ff=row(dx_at_f),
        dy_cc=mk(dy), dy_fc=mk(dy), dy_cf=mk(dy), dy_ff=mk(dy),
        az_cc=row(az_at_c), az_fc=row(az_at_c), az_cf=row(az_at_f), az_ff=row(az_at_f),
        solid_cc=None,
    )


def _gc_dist(lam1, phi1, lam2, phi2, radius):
    """Great-circle distance between (λ, φ) points in degrees."""
    d = np.pi / 180.0
    l1, p1, l2, p2 = lam1 * d, phi1 * d, lam2 * d, phi2 * d
    s = (np.sin((p2 - p1) / 2) ** 2
         + np.cos(p1) * np.cos(p2) * np.sin((l2 - l1) / 2) ** 2)
    return 2 * radius * np.arcsin(np.minimum(1.0, np.sqrt(s)))


def _fold_metric_halo(full, Nx, Hx, Ny, Hy, xface, yface):
    """Rewrite a padded float64 metric array's north y-halo with exact fold
    images (metrics keep their sign under the fold; the x-mirror follows the
    array's staggered location as in `fields._fill_y_fold`).  The y-face
    seam row is symmetrised, 0.5·(q + q_mirror)."""
    if Hy == 0:
        return full
    p = np.arange(full.shape[0])
    if xface:
        src = ((Nx - (p - Hx)) % Nx) + Hx
    else:
        src = ((Nx - 1 - (p - Hx)) % Nx) + Hx
    r = full[src, :]
    if not yface:
        for k in range(Hy):
            full[:, Hy + Ny + k] = r[:, Hy + Ny - 1 - k]
    else:
        full[:, Hy + Ny] = 0.5 * (full[:, Hy + Ny] + r[:, Hy + Ny])
        for k in range(1, Hy):
            full[:, Hy + Ny + k] = full[src, Hy + Ny - k]
    return full


# staggered location (xface, yface) of each metric field of a Grid
_METRIC_LOCS = {
    "dx_cc": (False, False), "dy_cc": (False, False), "az_cc": (False, False),
    "dx_fc": (True, False), "dy_fc": (True, False), "az_fc": (True, False),
    "dx_cf": (False, True), "dy_cf": (False, True), "az_cf": (False, True),
    "dx_ff": (True, True), "dy_ff": (True, True), "az_ff": (True, True),
}


def CurvilinearGrid(corner_longitude, corner_latitude,
                    topology=(PERIODIC, BOUNDED), halo=4, dtype="float64",
                    radius=EARTH_RADIUS, north_fold=False, device=None):
    """Orthogonal spherical-shell grid from (Nx+1, Ny+1) arrays of cell
    corner (f,f) coordinates in degrees; with periodic x, column Nx repeats
    column 0's position.  Δx, Δy are great-circle distances between the
    staggered midpoints (averaged as 3-D unit vectors), Az = Δx·Δy in the
    grid dtype; the SBP stress operators stay adjoint for any positive
    metric set.  x and y coordinates are index-space stand-ins; the physical
    ones are ``lon_cc``/``lat_cc``."""
    device = resolve_device(device)
    tdt = torch_dtype(dtype)
    npdt = numpy_dtype(tdt)
    lam = np.asarray(corner_longitude, float)
    phi = np.asarray(corner_latitude, float)
    Nx, Ny = lam.shape[0] - 1, lam.shape[1] - 1
    topo = (_topo(topology[0]), _topo(topology[1]))
    Hx = 0 if topo[0] == FLAT else halo
    Hy = 0 if topo[1] == FLAT else halo
    if north_fold:
        _check_fold(topo, Nx)

    def to_xyz(lam_d, phi_d):
        lr, pr = np.deg2rad(lam_d), np.deg2rad(phi_d)
        cp = np.cos(pr)
        return np.stack([cp * np.cos(lr), cp * np.sin(lr), np.sin(pr)])

    def to_ll(v):
        v = v / np.linalg.norm(v, axis=0, keepdims=True)
        return (np.rad2deg(np.arctan2(v[1], v[0])),
                np.rad2deg(np.arcsin(np.clip(v[2], -1.0, 1.0))))

    xyz = to_xyz(lam, phi)
    lam_xm, phi_xm = to_ll(xyz[:, :-1] + xyz[:, 1:])        # y-face midpoints (c,f)
    lam_ym, phi_ym = to_ll(xyz[:, :, :-1] + xyz[:, :, 1:])  # x-face midpoints (f,c)
    lam_c, phi_c = to_ll(xyz[:, :-1, :-1] + xyz[:, 1:, :-1]
                         + xyz[:, :-1, 1:] + xyz[:, 1:, 1:])

    dx_cc = _gc_dist(lam_ym[:-1], phi_ym[:-1], lam_ym[1:], phi_ym[1:], radius)
    dx_cf = _gc_dist(lam[:-1], phi[:-1], lam[1:], phi[1:], radius)
    cm = np.roll(lam_c, 1, 0), np.roll(phi_c, 1, 0)
    dx_fc = _gc_dist(cm[0], cm[1], lam_c, phi_c, radius)
    xm_m = np.roll(lam_xm, 1, 0), np.roll(phi_xm, 1, 0)
    dx_ff = _gc_dist(xm_m[0], xm_m[1], lam_xm, phi_xm, radius)

    dy_cc = _gc_dist(lam_xm[:, :-1], phi_xm[:, :-1], lam_xm[:, 1:], phi_xm[:, 1:], radius)
    dy_fc = _gc_dist(lam[:, :-1], phi[:, :-1], lam[:, 1:], phi[:, 1:], radius)
    dy_cf = np.empty((Nx, Ny + 1))
    dy_cf[:, 1:-1] = _gc_dist(lam_c[:, :-1], phi_c[:, :-1], lam_c[:, 1:], phi_c[:, 1:], radius)
    dy_cf[:, 0] = dy_cf[:, 1]
    dy_cf[:, -1] = dy_cf[:, -2]
    dy_ff = np.empty((Nx + 1, Ny + 1))
    dy_ff[:, 1:-1] = _gc_dist(lam_ym[:, :-1], phi_ym[:, :-1], lam_ym[:, 1:], phi_ym[:, 1:],
                              radius)
    dy_ff[:, 0] = dy_ff[:, 1]
    dy_ff[:, -1] = dy_ff[:, -2]

    def pad(q_int, xface=False, yface=False):
        """Periodic-wrap or edge-clamp an interior array into padded form,
        with exact fold images north of a folded edge, in the grid dtype."""
        q = q_int[:Nx, :Ny]
        full = np.empty((Nx + 2 * Hx, Ny + 2 * Hy))
        full[Hx:Hx + Nx, Hy:Hy + Ny] = q
        if Hx:
            if topo[0] == PERIODIC:
                full[:Hx, Hy:Hy + Ny] = q[Nx - Hx:, :]
                full[Hx + Nx:, Hy:Hy + Ny] = q[:Hx, :]
            else:
                full[:Hx, Hy:Hy + Ny] = q[:1, :]
                full[Hx + Nx:, Hy:Hy + Ny] = q[-1:, :]
        if Hy:
            full[:, :Hy] = full[:, Hy:Hy + 1]
            full[:, Hy + Ny:] = full[:, Hy + Ny - 1:Hy + Ny]
            if north_fold:
                full = _fold_metric_halo(full, Nx, Hx, Ny, Hy, xface, yface)
        return torch.as_tensor(np.asarray(full, npdt), device=device)

    dx = {"cc": pad(dx_cc), "fc": pad(dx_fc, True), "cf": pad(dx_cf, False, True),
          "ff": pad(dx_ff, True, True)}
    dy = {"cc": pad(dy_cc), "fc": pad(dy_fc, True), "cf": pad(dy_cf, False, True),
          "ff": pad(dy_ff, True, True)}

    def index_coords(N, H, offset):
        return torch.as_tensor(np.asarray(np.arange(-H, N + H, dtype=float) + offset, npdt),
                               device=device)

    return Grid(
        Nx=Nx, Ny=Ny, Hx=Hx, Hy=Hy, topology=topo, dtype=tdt, device=device,
        kind="curvilinear", north_fold=north_fold,
        xc=index_coords(Nx, Hx, 0.5), xf=index_coords(Nx, Hx, 0.0),
        yc=index_coords(Ny, Hy, 0.5), yf=index_coords(Ny, Hy, 0.0),
        **{f"dx_{loc}": q for loc, q in dx.items()},
        **{f"dy_{loc}": q for loc, q in dy.items()},
        **{f"az_{loc}": dx[loc] * dy[loc] for loc in dx},
        lon_cc=pad(lam_c), lat_cc=pad(phi_c),
        solid_cc=None,
    )


def TripolarGrid(size, southernmost_latitude=-80.0, transition_latitude=62.0,
                 cap_smoothness=2.5, poles_longitude=90.0,
                 halo=4, dtype="float64", radius=EARTH_RADIUS, device=None):
    """Tripolar-style global grid: latitude-longitude rows south of
    ``transition_latitude`` and a conformal bipolar cap north of it, whose
    two grid poles are joined by the Zipper fold.

    The cap uses elliptic conformal coordinates z = a·cosh(u + iv) on the
    north-polar stereographic plane (confocal ellipses around the poles at
    z = ±a, degenerating onto the fold seam at u = 0), with geometrically
    graded u-steps whose first matches the lat-lon row spacing.  ``size =
    (Nx, Ny)``: Nx even; about a quarter of the rows form the cap."""
    Nx, Ny = size
    if Nx % 2:
        raise ValueError("TripolarGrid requires even Nx")
    Ny_cap = max(4, Ny // 4)
    Ny_s = Ny - Ny_cap
    deg = np.pi / 180.0

    i = np.arange(Nx + 1)
    lam_1d = 360.0 * i / Nx
    phi_rows_s = southernmost_latitude + (transition_latitude
                                          - southernmost_latitude) * np.arange(Ny_s + 1) / Ny_s

    r_t = np.tan((90.0 - transition_latitude) / 2 * deg)
    u_t = float(cap_smoothness)
    a = r_t / np.cosh(u_t)

    lam_corners = np.empty((Nx + 1, Ny + 1))
    phi_corners = np.empty((Nx + 1, Ny + 1))
    lam_corners[:, :Ny_s + 1] = lam_1d[:, None]
    phi_corners[:, :Ny_s + 1] = phi_rows_s[None, :]

    v = lam_1d * deg
    dphi = (transition_latitude - southernmost_latitude) / Ny_s * deg

    def factor(u):
        w = np.sinh(u + 1j * v[:-1])
        r2 = np.abs(a * np.cosh(u + 1j * v[:-1])) ** 2
        return float(np.mean(np.abs(w) * 2.0 / (1.0 + r2)))

    du0 = dphi / (a * factor(u_t))
    if 0 < du0 < u_t:
        lo, hi = 1e-3, 100.0
        for _ in range(200):
            g = 0.5 * (lo + hi)
            with np.errstate(over="ignore"):
                tot = du0 * (Ny_cap if abs(g - 1) < 1e-12
                             else (np.power(g, float(Ny_cap)) - 1) / (g - 1))
            lo, hi = (g, hi) if tot < u_t else (lo, g)
        if g > 1.25:   # bound the grading: a modest junction kink instead
            g = 1.25
            du0 = u_t * (g - 1) / (g ** Ny_cap - 1)
        du = du0 * g ** np.arange(Ny_cap)
    else:
        du = np.full(Ny_cap, u_t / Ny_cap)
    u_rows = u_t - np.concatenate([np.cumsum(du)[:-1], [u_t]])

    for j in range(1, Ny_cap + 1):
        z = a * np.cosh(u_rows[j - 1] + 1j * v)
        lam_corners[:, Ny_s + j] = np.angle(z) / deg
        phi_corners[:, Ny_s + j] = 90.0 - 2.0 * np.arctan(np.abs(z)) / deg

    lam_corners = lam_corners + poles_longitude
    lam_corners[Nx, :Ny_s + 1] = lam_corners[0, :Ny_s + 1] + 360.0
    phi_corners[Nx, :] = phi_corners[0, :]
    lam_corners[Nx, Ny_s + 1:] = lam_corners[0, Ny_s + 1:]

    return CurvilinearGrid(lam_corners, phi_corners, topology=(PERIODIC, BOUNDED),
                           halo=halo, dtype=dtype, radius=radius, north_fold=True,
                           device=device)


def ImmersedBoundaryGrid(grid: Grid, solid_mask):
    """Attach a land mask to ``grid``.

    ``solid_mask``: interior-shaped boolean array or tensor (True = land), or
    a callable ``f(x, y) -> bool`` over cell centres, called with numpy
    arrays of shapes (Nx, 1) and (1, Ny) in the grid dtype.  The halos
    continue the mask as the topology says: periodic wrap, and solid beyond
    a bounded wall."""
    if callable(solid_mask):
        x = grid.xc.cpu().numpy()[grid.Hx:grid.Hx + grid.Nx, None]
        y = grid.yc.cpu().numpy()[None, grid.Hy:grid.Hy + grid.Ny]
        solid_mask = solid_mask(x, y)
    if isinstance(solid_mask, torch.Tensor):
        solid_mask = solid_mask.cpu().numpy()
    full = np.zeros(grid.shape, bool)
    full[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny] = np.asarray(solid_mask, bool)
    full = _extend_mask(full, grid)
    return grid.evolve(solid_cc=torch.as_tensor(full, device=grid.device))


def _extend_mask(mask, grid):
    """Fill the halos of a padded boolean mask in place and return it."""
    Hx, Hy, Nx, Ny = grid.Hx, grid.Hy, grid.Nx, grid.Ny
    if Hx > 0:
        if grid.topology[0] == PERIODIC:
            mask[:Hx] = mask[Nx:Nx + Hx]
            mask[Hx + Nx:] = mask[Hx:2 * Hx]
        else:   # bounded: outside the domain counts as solid
            mask[:Hx] = True
            mask[Hx + Nx:] = True
    if Hy > 0:
        if grid.topology[1] == PERIODIC:
            mask[:, :Hy] = mask[:, Ny:Ny + Hy]
            mask[:, Hy + Ny:] = mask[:, Hy:2 * Hy]
        else:
            mask[:, :Hy] = True
            if grid.north_fold:
                # the folded edge is connected, not a wall: the halo rows are
                # the fold images of the top interior rows (the cc fold fill)
                p = np.arange(mask.shape[0])
                src = ((Nx - 1 - (p - Hx)) % Nx) + Hx
                for k in range(Hy):
                    mask[:, Hy + Ny + k] = mask[src, Hy + Ny - 1 - k]
            else:
                mask[:, Hy + Ny:] = True
    return mask


def repad_metric(grid: Grid, m, Hy: int, xface: bool, yface: bool, Hx: int = None):
    """``m`` (a metric, or a centred plane such as ``lat_cc``) of ``grid``
    padded anew with ``Hy`` halo rows and ``Hx`` halo columns (default the
    grid's): the interior kept, x halos wrapped or edge-clamped, y halos
    edge-clamped, and on a folded grid the exact fold images north of the
    seam with the y-face seam row symmetrised (:func:`_fold_metric_halo`).
    Computed in the grid dtype, as `pallas_evp_tiled_curvilinear.py:399-433`
    computes it (`grids.py:748-781` computes the same values in float64 and
    rounds once: the seam's half-sum rounds alike); 0-d metrics pass
    through."""
    if m is None or m.dim() == 0:
        return m
    Nx, Ny = grid.Nx, grid.Ny
    Hx = grid.Hx if Hx is None else Hx
    q = grid.interior(m.broadcast_to(grid.shape)).cpu().numpy()
    if Hx == 0:
        left = right = q[:0]
    elif grid.topology[0] == PERIODIC:
        left, right = q[Nx - Hx:], q[:Hx]
    else:
        left, right = np.repeat(q[:1], Hx, 0), np.repeat(q[-1:], Hx, 0)
    q = np.concatenate([left, q, right], 0)
    full = np.concatenate([np.repeat(q[:, :1], Hy, 1), q, np.repeat(q[:, -1:], Hy, 1)], 1)
    if grid.north_fold:
        full = _fold_metric_halo(full, Nx, Hx, Ny, Hy, xface, yface)
    return torch.as_tensor(full, device=m.device)


def with_halo(grid: Grid, halo):
    """Copy of ``grid`` with new halo widths and the same interior
    (`grids.py:628-695`): ``halo`` is one width or an ``(Hx, Hy)`` pair.  The
    wide-halo distributed step widens only the directions split across
    ranks.  Rectilinear and latitude-longitude grids are built anew (uniform
    rectilinear metrics kept bit for bit), curvilinear ones repadded
    (:func:`_curvilinear_with_halo`); a land mask is attached again from its
    interior."""
    hx, hy = (int(halo), int(halo)) if np.ndim(halo) == 0 else map(int, halo)
    Hx = 0 if grid.topology[0] == FLAT else hx
    Hy = 0 if grid.topology[1] == FLAT else hy
    if (Hx, Hy) == (grid.Hx, grid.Hy):
        return grid
    halo = max(Hx, Hy)   # the constructors take one width; cut per direction below
    dtype = numpy_dtype(grid.dtype).name
    if grid.kind == "rectilinear":
        xf, yf = grid.xf.cpu().numpy(), grid.yf.cpu().numpy()
        x0 = float(xf[grid.Hx])
        x1 = float(xf[grid.Hx] + grid.Nx * (xf[1] - xf[0])) if grid.topology[0] != FLAT else 1.0
        y0 = float(yf[grid.Hy])
        y1 = float(yf[grid.Hy] + grid.Ny * (yf[1] - yf[0])) if grid.topology[1] != FLAT else 1.0
        g = RectilinearGrid((grid.Nx, grid.Ny), x=(x0, x1), y=(y0, y1),
                            topology=grid.topology, halo=halo, dtype=dtype,
                            north_fold=grid.north_fold, device=grid.device)
        # keep the uniform metrics bit for bit: the extent's round trip moves
        # Δx by an ulp, and serial ≡ distributed needs the same inputs
        g = g.evolve(**{f: getattr(grid, f) for f in _METRIC_LOCS
                        if getattr(grid, f) is not None and getattr(grid, f).dim() == 0})
    elif grid.kind == "latlon":
        xf, yf = grid.xf.cpu().numpy(), grid.yf.cpu().numpy()
        dlam = float(xf[1] - xf[0])
        dphi = float(yf[1] - yf[0])
        lon0, lat0 = float(xf[grid.Hx]), float(yf[grid.Hy])
        radius = float(grid.dy_cc.reshape(-1)[0]) / (dphi * np.pi / 180.0)
        g = LatitudeLongitudeGrid((grid.Nx, grid.Ny), longitude=(lon0, lon0 + grid.Nx * dlam),
                                  latitude=(lat0, lat0 + grid.Ny * dphi),
                                  topology=grid.topology, halo=halo, dtype=dtype,
                                  radius=radius, device=grid.device)
    else:
        g = _curvilinear_with_halo(grid, Hx, Hy)
    if (g.Hx, g.Hy) != (Hx, Hy):
        g = _shrink_dim_halos(g, Hx, Hy)
    if grid.solid_cc is not None:
        g = ImmersedBoundaryGrid(g, grid.interior(grid.solid_cc))
    return g


def _shrink_dim_halos(g: Grid, Hx, Hy):
    """A uniform-halo grid's coordinates and metrics cut down to the halos
    ``(Hx, Hy)`` (`grids.py:719-745`): views of the same values."""
    cx, cy = g.Hx - Hx, g.Hy - Hy
    if cx < 0 or cy < 0:
        raise ValueError(f"cannot shrink halos ({g.Hx}, {g.Hy}) to ({Hx}, {Hy})")
    nxp, nyp = g.Nx + 2 * Hx, g.Ny + 2 * Hy

    def cut1(c, k, n):
        return c if c is None or k == 0 else c[k:k + n]

    def cutm(m):
        if m is None or m.dim() == 0:
            return m
        if tuple(m.shape) == g.shape:
            return m[cx:cx + nxp, cy:cy + nyp]
        if m.shape[0] == 1:          # (1, nyp) latitude row
            return m[:, cy:cy + nyp]
        raise NotImplementedError(f"halo shrink of metric shape {tuple(m.shape)}")

    return g.evolve(Hx=Hx, Hy=Hy, xc=cut1(g.xc, cx, nxp), xf=cut1(g.xf, cx, nxp),
                    yc=cut1(g.yc, cy, nyp), yf=cut1(g.yf, cy, nyp),
                    **{f: cutm(getattr(g, f)) for f in _METRIC_LOCS},
                    lon_cc=cutm(g.lon_cc), lat_cc=cutm(g.lat_cc), solid_cc=None)


def _curvilinear_with_halo(grid: Grid, Hx, Hy):
    """A curvilinear grid with halos ``(Hx, Hy)`` (`grids.py:748-785`): every
    metric and ``lon_cc``/``lat_cc`` repadded (:func:`repad_metric`), index
    coordinates anew, no land mask."""
    npdt = numpy_dtype(grid.dtype)

    def index_coords(N, H, offset):
        return torch.as_tensor(np.asarray(np.arange(-H, N + H, dtype=float) + offset, npdt),
                               device=grid.device)

    return grid.evolve(
        Hx=Hx, Hy=Hy,
        xc=index_coords(grid.Nx, Hx, 0.5), xf=index_coords(grid.Nx, Hx, 0.0),
        yc=index_coords(grid.Ny, Hy, 0.5), yf=index_coords(grid.Ny, Hy, 0.0),
        **{f: repad_metric(grid, getattr(grid, f), Hy, *loc, Hx=Hx)
           for f, loc in _METRIC_LOCS.items()},
        lon_cc=repad_metric(grid, grid.lon_cc, Hy, False, False, Hx=Hx),
        lat_cc=repad_metric(grid, grid.lat_cc, Hy, False, False, Hx=Hx),
        solid_cc=None)


def south_crop_grid(g: Grid, cs: int):
    """View of ``g``'s padded rows [cs, nyp): the same halos and Ny − cs
    interior rows, metric tensors sliced (no copy).  Passes over the view
    give, on rows whose stencils stay ≥ Hy inside it, bitwise the values of
    the full pass; callers discard the view's first Hy output rows."""
    def cut(m):
        if m is None or m.dim() == 0:
            return m
        return m[:, cs:]

    return g.evolve(
        Ny=g.Ny - cs, yc=g.yc[cs:], yf=g.yf[cs:],
        **{f: cut(getattr(g, f)) for f in _METRIC_LOCS},
        lon_cc=cut(g.lon_cc), lat_cc=cut(g.lat_cc), solid_cc=cut(g.solid_cc))
