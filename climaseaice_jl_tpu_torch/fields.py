"""Halo filling and peripheral masks (serial).

Counterpart of the serial part of `climaseaice_jl_tpu/fields.py`.  All fills
are functional: ``q -> q_with_fresh_halos``.

* centered tracers (h, ℵ, σ₁₁, …): periodic wrap or zero-gradient at
  bounded walls;
* wall-normal velocity components: zero in the halo beyond a bounded wall;
* the Zipper fold on a ``north_fold`` grid: the north halo is the x-reversed
  image of the top interior rows, with u and v changing sign.

Distributed exchanges, and with them the meshed folds, belong to a later
slice (queue 9).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .grids import Grid, PERIODIC, BOUNDED, FLAT


def _fill_x(q, grid: Grid, face: bool):
    H, N = grid.Hx, grid.Nx
    topo = grid.topology[0]
    if topo == FLAT or H == 0:
        return q
    if topo == PERIODIC:
        return torch.cat([q[N:N + H], q[H:H + N], q[H:2 * H]], 0)
    if topo == BOUNDED:
        if face:
            return torch.cat([torch.zeros_like(q[:H]), q[H:H + N + 1],
                              torch.zeros_like(q[H + N + 1:])], 0)
        left = q[H:H + 1].expand(H, q.shape[1])
        right = q[H + N - 1:H + N].expand(H, q.shape[1])
        return torch.cat([left, q[H:H + N], right], 0)
    return q


def _fill_y(q, grid: Grid, face: bool):
    H, N = grid.Hy, grid.Ny
    topo = grid.topology[1]
    if topo == FLAT or H == 0:
        return q
    if topo == PERIODIC:
        return torch.cat([q[:, N:N + H], q[:, H:H + N], q[:, H:2 * H]], 1)
    if topo == BOUNDED:
        if face:
            return torch.cat([torch.zeros_like(q[:, :H]), q[:, H:H + N + 1],
                              torch.zeros_like(q[:, H + N + 1:])], 1)
        left = q[:, H:H + 1].expand(q.shape[0], H)
        right = q[:, H + N - 1:H + N].expand(q.shape[0], H)
        return torch.cat([left, q[:, H:H + N], right], 1)
    return q


# --- Zipper fold (tripolar north edge) -----------------------------------------
# Cell (i, Ny-1+k) pairs with cell (Nx-1-i, Ny-k).  u and v flip sign across
# the fold; scalars and σ₁₂ keep it (component and coordinate both flip).

def _fold_source(Nx, Hx, face):
    p = np.arange(Nx + 2 * Hx)
    if face:
        return ((Nx - (p - Hx)) % Nx) + Hx      # face i ↔ face (Nx − i) mod Nx
    return ((Nx - 1 - (p - Hx)) % Nx) + Hx      # centre i ↔ Nx − 1 − i


def _x_fold_indices(grid: Grid, face: bool):
    """Padded column whose value lands at each padded column under the fold;
    always an interior column."""
    return _fold_source(grid.Nx, grid.Hx, face)


@functools.lru_cache(maxsize=32)
def _fold_index_tensor(Nx, Hx, face, device):
    """:func:`_x_fold_indices` as an index tensor on ``device``, made once
    per grid layout so that a fill copies nothing from the host."""
    return torch.as_tensor(_fold_source(Nx, Hx, face), device=device)


def _fill_y_fold(q, grid: Grid, xface: bool, yface: bool, sign: float):
    """Overwrite the north halo (and, for y-face fields, project the seam row
    onto its fold symmetry) from the x-reversed top interior rows."""
    Hy, Ny = grid.Hy, grid.Ny
    r = sign * q[_fold_index_tensor(grid.Nx, grid.Hx, xface, q.device), :]
    q = q.clone()
    if not yface:
        q[:, Hy + Ny:] = r[:, Ny:Hy + Ny].flip(1)            # row Hy+Ny+k ← Hy+Ny-1-k
        return q
    q[:, Hy + Ny] = 0.5 * (q[:, Hy + Ny] + r[:, Hy + Ny])
    q[:, Hy + Ny + 1:] = r[:, Ny + 1:Hy + Ny].flip(1)        # row Hy+Ny+k ← Hy+Ny-k
    return q


def _maybe_fold(q, grid: Grid, xface: bool, yface: bool, sign: float):
    if not (grid.north_fold and grid.Hy > 0):
        return q
    return _fill_y_fold(q, grid, xface, yface, sign)


# fold sign per staggered location: u (fc) and v (cf) change sign across the
# fold, scalars (cc) and σ₁₂ (ff) keep it
_FOLD_SIGN = {"cc": 1.0, "fc": -1.0, "cf": -1.0, "ff": 1.0}


def _fill(q, grid: Grid, loc: str):
    xface, yface = loc[0] == "f", loc[1] == "f"
    q = _fill_y(_fill_x(q, grid, face=xface), grid, face=yface)
    return _maybe_fold(q, grid, xface, yface, _FOLD_SIGN[loc])


def fill_halos_cc(q, grid: Grid):
    return _fill(q, grid, "cc")


def fill_halos_fc(q, grid: Grid):
    """u-like fields: face in x, center in y."""
    return _fill(q, grid, "fc")


def fill_halos_cf(q, grid: Grid):
    """v-like fields: center in x, face in y."""
    return _fill(q, grid, "cf")


def fill_halos_ff(q, grid: Grid):
    return _fill(q, grid, "ff")


FILLERS = {
    ("c", "c"): fill_halos_cc,
    ("f", "c"): fill_halos_fc,
    ("c", "f"): fill_halos_cf,
    ("f", "f"): fill_halos_ff,
}


def fill_halos_many(qs, locs, grid: Grid):
    """Halo fill for several fields at once; ``locs`` is "cc"/"fc"/"cf"/"ff"
    per field.  Serially this is one fill per field, identical to
    ``FILLERS[loc](q, grid)``."""
    return [_fill(q, grid, loc) for q, loc in zip(qs, locs)]


# --- local-only fills ---------------------------------------------------------
# The JAX package's `fill_halos_*_local` (`fields.py:342-403`) refresh the
# physical boundaries of a shard without exchanging its mesh-split sides: the
# walls, and the Zipper fold where x is not split.  A grid of this package is
# never a shard, so they are the serial fills, the fold included; a sharded
# grid (one that names mesh axes) belongs to the distributed slice (queue 9).

def _fill_local(q, grid: Grid, loc: str):
    if getattr(grid, "mesh_axes", None) is not None:
        raise NotImplementedError("local fills of a sharded grid belong to the distributed "
                                  "slice of the port (queue 9)")
    return _fill(q, grid, loc)


def fill_halos_cc_local(q, grid: Grid):
    return _fill_local(q, grid, "cc")


def fill_halos_fc_local(q, grid: Grid):
    return _fill_local(q, grid, "fc")


def fill_halos_cf_local(q, grid: Grid):
    return _fill_local(q, grid, "cf")


def fill_halos_ff_local(q, grid: Grid):
    return _fill_local(q, grid, "ff")


# --- peripheral masks ---------------------------------------------------------

def _solid_base(grid: Grid):
    """Solid-cell mask including the implicit 'outside' of bounded walls."""
    if grid.solid_cc is not None:
        return grid.solid_cc.cpu().numpy()
    m = np.zeros(grid.shape, bool)
    if grid.topology[0] == BOUNDED and grid.Hx > 0:
        m[:grid.Hx] = True
        m[grid.Hx + grid.Nx:] = True
    if grid.topology[1] == BOUNDED and grid.Hy > 0:
        m[:, :grid.Hy] = True
        if not grid.north_fold:   # a folded north edge is connected, not a wall
            m[:, grid.Hy + grid.Ny:] = True
    return m


def peripheral_masks(grid: Grid):
    """Boolean masks at (f,c), (c,f) and (f,f), True wherever the node
    touches a solid cell or a bounded-domain wall (face nodes are peripheral
    when either adjacent cell is solid)."""
    s = _solid_base(grid)
    sx = np.roll(s, 1, 0)   # cell I-1
    sy = np.roll(s, 1, 1)
    sxy = np.roll(sx, 1, 1)

    def dev(m):
        return torch.as_tensor(m, device=grid.device)

    return dev(s | sx), dev(s | sy), dev(s | sx | sy | sxy)


def solid_cc_mask(grid: Grid):
    return torch.as_tensor(_solid_base(grid), device=grid.device)


def immersed_only_ff(grid: Grid):
    """(f,f) nodes peripheral because of an immersed cell but not because of
    a domain wall: the nodes whose faces carry immersed stress-divergence
    fluxes.  None on grids without land."""
    if grid.solid_cc is None:
        return None

    def per_ff(s):
        sx = np.roll(s, 1, 0)
        sy = np.roll(s, 1, 1)
        sxy = np.roll(sx, 1, 1)
        return s | sx | sy | sxy

    full = _solid_base(grid)
    wall = _solid_base(grid.evolve(solid_cc=None))
    return torch.as_tensor(per_ff(full) & ~per_ff(wall), device=grid.device)


def mask_immersed_cc(q, grid: Grid):
    """Zero a centred field over solid cells."""
    if grid.solid_cc is None:
        return q
    return torch.where(grid.solid_cc, 0.0, q)
