"""Staggered C-grid with uniform scalar metrics.

Counterpart of `climaseaice_jl_tpu/grids.py` (``Grid``, ``RectilinearGrid``
and ``ImmersedBoundaryGrid``).  Every 2-D field is a halo-inclusive tensor of shape
``(Nx + 2*Hx, Ny + 2*Hy)`` shared by all four staggered locations (cc, fc,
cf, ff); center ``i`` lives at index ``Hx + i`` and a face with the same
index sits at the *left/south* edge of that center.  y is the contiguous
axis.  Metrics are 0-d tensors of the grid dtype (uniform grids).

Degenerate (``flat``) directions have size 1, halo 0 and unit metrics.

Every grid carries an explicit ``device`` and ``dtype``; ``device=None``
means the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import frozen_dataclass, numpy_dtype, resolve_device, torch_dtype

PERIODIC = "periodic"
BOUNDED = "bounded"
FLAT = "flat"


@frozen_dataclass
class Grid:
    Nx: int = None
    Ny: int = None
    Hx: int = None
    Hy: int = None
    topology: tuple = None  # (TX, TY) each in {periodic, bounded, flat}
    dtype: torch.dtype = None
    device: torch.device = None
    kind: str = "rectilinear"

    # padded 1-D coordinates
    xc: object = None
    xf: object = None
    yc: object = None
    yf: object = None

    # metric terms (0-d tensors on uniform grids)
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
    is none."""
    if north_fold:
        raise NotImplementedError("north_fold grids belong to a later slice "
                                  "of the port (queue 8, curvilinear grids)")
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

    def mk(v):
        return torch.as_tensor(np.asarray(v, npdt), device=device)

    return Grid(
        Nx=Nx, Ny=Ny, Hx=Hx, Hy=Hy, topology=topo, dtype=tdt, device=device,
        kind="rectilinear",
        xc=mk(xc), xf=mk(xf), yc=mk(yc), yf=mk(yf),
        dx_cc=mk(dx), dx_fc=mk(dx), dx_cf=mk(dx), dx_ff=mk(dx),
        dy_cc=mk(dy), dy_fc=mk(dy), dy_cf=mk(dy), dy_ff=mk(dy),
        az_cc=mk(az), az_fc=mk(az), az_cf=mk(az), az_ff=mk(az),
        solid_cc=None,
    )


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
            mask[:, Hy + Ny:] = True
    return mask
