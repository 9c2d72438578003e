"""Halo filling and peripheral masks (serial).

Counterpart of the serial part of `climaseaice_jl_tpu/fields.py`.  All fills
are functional: ``q -> q_with_fresh_halos``.

* centered tracers (h, ℵ, σ₁₁, …): periodic wrap or zero-gradient at
  bounded walls;
* wall-normal velocity components: zero in the halo beyond a bounded wall.

Distributed exchanges and the Zipper fold belong to later slices (queues 8
and 9).
"""

from __future__ import annotations

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


def fill_halos_cc(q, grid: Grid):
    return _fill_y(_fill_x(q, grid, face=False), grid, face=False)


def fill_halos_fc(q, grid: Grid):
    """u-like fields: face in x, center in y."""
    return _fill_y(_fill_x(q, grid, face=True), grid, face=False)


def fill_halos_cf(q, grid: Grid):
    """v-like fields: center in x, face in y."""
    return _fill_y(_fill_x(q, grid, face=False), grid, face=True)


def fill_halos_ff(q, grid: Grid):
    return _fill_y(_fill_x(q, grid, face=True), grid, face=True)


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
    return [FILLERS[(loc[0], loc[1])](q, grid) for q, loc in zip(qs, locs)]


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
