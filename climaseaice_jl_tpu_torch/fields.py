"""Halo filling and peripheral masks.

Counterpart of `climaseaice_jl_tpu/fields.py`.  All fills are functional:
``q -> q_with_fresh_halos``.

* centered tracers (h, ℵ, σ₁₁, …): periodic wrap or zero-gradient at
  bounded walls;
* wall-normal velocity components: zero in the halo beyond a bounded wall;
* the Zipper fold on a ``north_fold`` grid: the north halo is the x-reversed
  image of the top interior rows, with u and v changing sign.

On a shard's grid (one that names mesh axes, :mod:`.parallel.stepper`) a
direction split across ranks is filled by a ring exchange with the
neighbouring ranks (the strips of all fields of a call in one message each
way), the walls apply only on the shards at the global edges, and the fold
only on the northernmost shards: from the shard's own top rows where x is
not split, from the top rows gathered over the row of ranks where it is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .grids import Grid, PERIODIC, BOUNDED, FLAT


def _meshed(grid: Grid, dim: int) -> bool:
    """True when ``grid`` is a shard and direction ``dim`` is split across
    ranks, so that its halo fills are exchanges (`fields.py:33-37`)."""
    return (grid.mesh_shape is not None and grid.mesh_shape[dim] > 1
            and grid.mesh_axes is not None and grid.mesh_axes[dim] is not None)


def _span(dim, a, b=None):
    """Index of the padded rows (``dim`` 0) or columns (1) a … b."""
    return (slice(a, b),) if dim == 0 else (slice(None), slice(a, b))


def _start_pair(qs, dim, grid: Grid):
    """Post the ring exchange along ``dim`` of same-shape fields
    (`fields.py:40-74`): the low halo takes the previous rank's last
    interior strip, the high halo the next rank's first; every field's strip
    travels in one stacked message each way.  Returns a function that waits
    for the strips and puts them in place."""
    H, N = (grid.Hx, grid.Nx) if dim == 0 else (grid.Hy, grid.Ny)
    to_next = torch.stack([q[_span(dim, N, N + H)] for q in qs])
    to_prev = torch.stack([q[_span(dim, H, 2 * H)] for q in qs])
    pending = grid.mesh.start_shift(dim, to_next, to_prev)

    def finish():
        from_prev, from_next = pending.wait()
        return [torch.cat([from_prev[k], q[_span(dim, H, H + N)], from_next[k]], dim)
                for k, q in enumerate(qs)]

    return finish


def _bc_meshed(q, grid: Grid, dim: int, face: bool, seam=None):
    """The wall boundary condition along a split bounded direction, on the
    shards at the global edges only (`fields.py:77-112`).  ``seam``: the
    wall face's value before an exchange overwrote it (the last shard gets
    it back); None after local fills."""
    H, N = (grid.Hx, grid.Nx) if dim == 0 else (grid.Hy, grid.Ny)
    i, P = grid.mesh.index[dim], grid.mesh_shape[dim]
    if i != 0 and i != P - 1:
        return q
    q = q.clone()
    if face:
        if i == 0:
            q[_span(dim, None, H)] = 0.0
        if i == P - 1:
            q[_span(dim, H + N + 1)] = 0.0
            if seam is not None:
                q[_span(dim, H + N, H + N + 1)] = seam
    else:
        if i == 0:
            q[_span(dim, None, H)] = q[_span(dim, H, H + 1)]
        if i == P - 1:
            q[_span(dim, H + N)] = q[_span(dim, H + N - 1, H + N)]
    return q


def _start_split(qs, faces, grid: Grid, dim: int):
    """Post the fill of direction ``dim``, split across ranks, of same-shape
    fields at x- or y-face locations ``faces``: one exchange of all their
    strips.  The returned function completes it: the strips in place, then
    the walls on the edge shards, each wall face given back its value."""
    H, N = (grid.Hx, grid.Nx) if dim == 0 else (grid.Hy, grid.Ny)
    seams = [q[_span(dim, H + N, H + N + 1)].clone() if f else None for q, f in zip(qs, faces)]
    exchanged = _start_pair(qs, dim, grid)

    def finish():
        out = exchanged()
        if grid.topology[dim] == BOUNDED:
            out = [_bc_meshed(q, grid, dim, f, seam=s) for q, f, s in zip(out, faces, seams)]
        return out

    return finish


def _fill_split(qs, faces, grid: Grid, dim: int):
    """:func:`_start_split` completed at once."""
    return _start_split(qs, faces, grid, dim)()


def _fill_x(q, grid: Grid, face: bool):
    H, N = grid.Hx, grid.Nx
    topo = grid.topology[0]
    if topo == FLAT or H == 0:
        return q
    if _meshed(grid, 0):
        return _fill_split([q], [face], grid, 0)[0]
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
    if _meshed(grid, 1):
        return _fill_split([q], [face], grid, 1)[0]
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


@functools.lru_cache(maxsize=64)
def _gathered_fold_index(nx, Px, ix, Hx, face, device):
    """Row of the gathered top rows (global interior columns, ranks in x
    order) that lands at each local padded column under the fold."""
    Nx = nx * Px
    g = ix * nx + (np.arange(nx + 2 * Hx) - Hx)        # global column of each local one
    src = (Nx - g) % Nx if face else (Nx - 1 - g) % Nx
    return torch.as_tensor(src, device=device)


def _fill_y_fold_xmeshed(q, grid: Grid, xface: bool, yface: bool, sign: float):
    """The fold where x is split across ranks (`fields.py:208-236`): the top
    Hy interior rows and the seam row of every rank of the row, gathered in
    x order, indexed by global column; the same arithmetic as the serial
    fold."""
    Hx, Hy, nx, Ny = grid.Hx, grid.Hy, grid.Nx, grid.Ny
    block = q[Hx:Hx + nx, Ny:Hy + Ny + 1]                  # (nx, Hy + 1)
    gathered = grid.mesh.all_gather(0, block)              # (Nx, Hy + 1)
    rows = sign * gathered[_gathered_fold_index(nx, grid.mesh_shape[0], grid.mesh.index[0], Hx,
                                                xface, q.device)]
    q = q.clone()
    if not yface:
        q[:, Hy + Ny:] = rows[:, :Hy].flip(1)               # row Hy+Ny+k ← Hy+Ny-1-k
        return q
    q[:, Hy + Ny] = 0.5 * (q[:, Hy + Ny] + rows[:, Hy])
    q[:, Hy + Ny + 1:] = rows[:, 1:Hy].flip(1)              # row Hy+Ny+k ← Hy+Ny-k
    return q


def _top_shard(grid: Grid):
    return not _meshed(grid, 1) or grid.mesh.index[1] == grid.mesh_shape[1] - 1


def _maybe_fold(q, grid: Grid, xface: bool, yface: bool, sign: float):
    """The Zipper fold of the north halo (`fields.py:239-254`): on the
    northernmost shards only, across the row of ranks where x is split."""
    if not (grid.north_fold and grid.Hy > 0) or not _top_shard(grid):
        return q
    if _meshed(grid, 0):
        return _fill_y_fold_xmeshed(q, grid, xface, yface, sign)
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


def _fill_dims(qs, locs, grid: Grid, dims):
    """Fill directions ``dims`` of fields at ``locs``, in order; a split
    direction in one exchange of all the fields' strips."""
    for dim in dims:
        faces = [loc[dim] == "f" for loc in locs]
        if _meshed(grid, dim):
            qs = _fill_split(qs, faces, grid, dim)
        else:
            fill = _fill_x if dim == 0 else _fill_y
            qs = [fill(q, grid, f) for q, f in zip(qs, faces)]
    return qs


def _fold_all(qs, locs, grid: Grid):
    return [_maybe_fold(q, grid, loc[0] == "f", loc[1] == "f", _FOLD_SIGN[loc])
            for q, loc in zip(qs, locs)]


def fill_halos_many(qs, locs, grid: Grid):
    """Halo fill for several fields at once; ``locs`` is "cc"/"fc"/"cf"/"ff"
    per field.  Each result equals ``FILLERS[loc](q, grid)``; on a shard
    every split direction's exchange carries all fields' strips in one
    message each way (`fields.py:296-329`)."""
    return _fold_all(_fill_dims(list(qs), locs, grid, (0, 1)), locs, grid)


def fill_halos_uv(u, v, grid: Grid):
    """``(fill_halos_fc(u), fill_halos_cf(v))`` with the exchanges of both in
    one message each way (`fields.py:332-339`)."""
    u, v = fill_halos_many((u, v), ("fc", "cf"), grid)
    return u, v


def start_fill_halos_uv(u, v, grid: Grid):
    """Begin :func:`fill_halos_uv`: post the exchange of the first split
    direction and return a pending fill for :func:`finish_fill_halos_uv`,
    so that work which needs no halo can run while the strips travel.  The
    second split direction's exchange, whose strips carry the corners the
    first brings, the walls and the fold run when it finishes.  Without a
    split direction the fill is done here."""
    locs = ("fc", "cf")
    split = [dim for dim in (0, 1) if _meshed(grid, dim)]
    if not split:
        done = fill_halos_uv(u, v, grid)
        return lambda: done
    first = split[0]
    qs = _fill_dims([u, v], locs, grid, range(first))
    exchanged = _start_split(qs, [loc[first] == "f" for loc in locs], grid, first)

    def finish():
        rest = _fill_dims(exchanged(), locs, grid, range(first + 1, 2))
        return tuple(_fold_all(rest, locs, grid))

    return finish


def finish_fill_halos_uv(pending):
    """``(u, v)`` of a fill begun by :func:`start_fill_halos_uv`, equal to
    :func:`fill_halos_uv`'s."""
    return pending()


# --- local-only fills ---------------------------------------------------------
# The physical boundaries of a field without its exchanges
# (`fields.py:342-403`): the directions split across ranks keep their halos
# (exchanged once, before an exchange-free substep loop), the walls on the
# shards at the global edges and the fold on the northernmost shards are
# filled again.  On a serial grid these are the serial fills.

def _fill_local(q, grid: Grid, loc: str):
    xface, yface = loc[0] == "f", loc[1] == "f"
    for dim, face, fill in ((0, xface, _fill_x), (1, yface, _fill_y)):
        if not _meshed(grid, dim):
            q = fill(q, grid, face)
        elif grid.topology[dim] == BOUNDED:
            q = _bc_meshed(q, grid, dim, face)
    if grid.north_fold and grid.Hy > 0 and _meshed(grid, 0):
        raise NotImplementedError("local-only fills cannot refresh a north fold split across "
                                  "the x mesh; use halo_exchange='per_substep'")
    return _maybe_fold(q, grid, xface, yface, _FOLD_SIGN[loc])


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
