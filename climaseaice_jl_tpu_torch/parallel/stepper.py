"""Distributed stepping over a 2-D mesh of ranks.

Counterpart of `climaseaice_jl_tpu/parallel/stepper.py`.  The JAX package
shards the global state over a device mesh inside ``shard_map``; here each
rank is one process of a ``torch.distributed`` world, holds its shard's
interior padded with halos on its own device, and runs the serial step code
on a *local* grid: a grid that names the mesh axes split across ranks, so
that every halo fill along a split direction is a ring exchange with the
neighbouring ranks (:mod:`..fields`), and the walls and the fold apply only
on the shards at the global edges.

:func:`make_distributed_step` returns ``dstep(state_interior, dt)``, which
steps the rank's interior-only shard (:func:`.multihost.shard_state` cuts
it from a global interior-only state, :func:`strip_halos` makes one from a
padded state).  Under the 'per_substep' and 'overlap' policies the loop
exchanges as :func:`..dynamics.momentum.loop_form` says (the deferred
form, the overlapped one, or an exchange a half-update), and every
dynamics the serial step takes runs on a shard.  With the 'wide' halo
policy the split directions' halos are
widened to 2·substeps+3 so that the substep loop needs no exchange, and
the loop runs on every shard in the kernel the JAX package runs there
(:func:`..model.meshed_momentum_route`): 2.7 on a folded or curvilinear
grid (its pinned plan with ``fixed_tiles``, else its unpinned one), on a
rectilinear grid 2.3 without ``fixed_tiles`` and 2.4 with 2.5 with it.
With ``fixed_tiles`` the result equals the serial step's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..grids import BOUNDED, _METRIC_LOCS, with_halo
from ..fields import fill_halos_cc, fill_halos_fc, fill_halos_cf, fill_halos_ff, fill_halos_many
from ..model import Masks, _step, meshed_momentum_route
from ..dynamics.fused_evp_tiled_curvilinear import tiled_curvilinear_envelope

# the staggered location of each named state field
_STATE_LOCS = {
    "h": "cc", "a": "cc", "hs": "cc", "S": "cc", "Tu": "cc", "Tus": "cc",
    "u": "fc", "un": "fc", "v": "cf", "vn": "cf",
    "sig11": "cc", "sig22": "cc", "sig12": "ff",
    "alpha": "cc", "P": "cc", "Delta": "cc", "zeta_cc": "cc", "zeta_ff": "ff",
    "mf_ice": "cc", "mf_snow": "cc", "mf_snowfall": "cc",
    "Qtop": "cc", "Qbot": "cc",
}

_FILLERS = {"cc": fill_halos_cc, "fc": fill_halos_fc, "cf": fill_halos_cf, "ff": fill_halos_ff}

# update_state's masked set: prognostic cc fields and tracers over solid cells
_MASKED_CC = {"h", "a", "hs", "S", "Tu", "Tus", "mf_ice", "mf_snow", "mf_snowfall"}


class ProcessMesh:
    """This rank's place in a (Px, Py) mesh of the ranks of a
    ``torch.distributed`` world: rank r sits at (r // Py, r % Py), as the JAX
    package's ``make_mesh`` orders its devices.  It carries the row group
    (the ranks that share its y index, along x) and the column group (along
    y), and moves the strips of the halo exchanges.

    Where the backend takes host tensors only (gloo), the strips are staged
    through host memory; on NCCL device tensors are sent as they are.
    ``bytes_sent`` counts the bytes this rank sends, ``rounds`` its ring
    exchanges (one a :meth:`shift` or :meth:`start_shift`)."""

    def __init__(self, shape, index, device, transport=True):
        self.shape = tuple(int(p) for p in shape)
        self.index = tuple(int(i) for i in index)
        self.device = torch.device(device)
        self.bytes_sent = 0
        self.rounds = 0
        self.groups = None
        self.stage = True
        if transport:
            Px, Py = self.shape
            # new_group is collective over the world: every rank makes every
            # group, in the same order
            rows = [dist.new_group([ix * Py + iy for ix in range(Px)]) for iy in range(Py)]
            cols = [dist.new_group([ix * Py + iy for iy in range(Py)]) for ix in range(Px)]
            self.groups = (rows[self.index[1]], cols[self.index[0]])
            self.stage = dist.get_backend() != "nccl"

    def _neighbour(self, dim, step):
        ix, iy = self.index
        Px, Py = self.shape
        if dim == 0:
            ix = (ix + step) % Px
        else:
            iy = (iy + step) % Py
        return ix * Py + iy

    def wire(self, t, copies=1):
        """``t`` as the backend sends it (on the host under gloo), counted
        in ``bytes_sent`` as sent ``copies`` times."""
        t = t.contiguous()
        self.bytes_sent += copies * t.numel() * t.element_size()
        return t.cpu() if self.stage else t

    def shift(self, dim, to_next, to_prev):
        """Ring shift along mesh direction ``dim``: ``to_next`` goes to the
        next rank and ``to_prev`` to the previous one (either may be None);
        returns ``(from_prev, from_next)``."""
        return self.start_shift(dim, to_next, to_prev).wait()

    def start_shift(self, dim, to_next, to_prev):
        """:meth:`shift` without waiting: posts the sends and receives
        (``dist.batch_isend_irecv``) and returns a handle whose ``wait()``
        gives back ``(from_prev, from_next)``.  The two directions carry
        their own tags, so that with two ranks, where both neighbours are
        the same rank, the messages stay apart."""
        if self.groups is None:
            raise RuntimeError("this ProcessMesh has no transport")
        self.rounds += 1
        nxt, prv = self._neighbour(dim, 1), self._neighbour(dim, -1)
        ops, recv = [], []
        for payload, dest, src, tag in ((to_next, nxt, prv, 2 * dim),
                                        (to_prev, prv, nxt, 2 * dim + 1)):
            if payload is None:
                recv.append(None)
                continue
            buf = torch.empty(payload.shape, dtype=payload.dtype,
                              device="cpu" if self.stage else payload.device)
            ops += [dist.P2POp(dist.isend, self.wire(payload), dest, tag=tag),
                    dist.P2POp(dist.irecv, buf, src, tag=tag)]
            recv.append(buf)
        device = (to_next if to_next is not None else to_prev).device
        return _PendingShift(dist.batch_isend_irecv(ops), recv, device)

    def all_gather(self, dim, block):
        """``block`` of every rank along mesh direction ``dim`` (the row
        group for x), concatenated along its first axis in mesh order."""
        if self.groups is None:
            raise RuntimeError("this ProcessMesh has no transport")
        n = self.shape[dim]
        t = self.wire(block, copies=n - 1)      # to each of the other ranks
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.groups[dim])
        return out.to(block.device)


class _PendingShift:
    """A posted ring shift: ``wait()`` completes it and returns
    ``(from_prev, from_next)`` on the device of its payloads."""

    def __init__(self, works, recv, device):
        self.works, self.recv, self.device = works, recv, device

    def wait(self):
        for work in self.works:
            work.wait()
        return tuple(None if b is None else b.to(self.device) for b in self.recv)


def make_mesh(mesh_shape, device=None):
    """This rank's :class:`ProcessMesh` over the initialised world, which
    must hold Px·Py ranks.  ``device``: the rank's device (default
    :func:`.multihost.default_device`)."""
    from .multihost import default_device
    Px, Py = mesh_shape
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "climaseaice_jl_tpu_torch.parallel.initialize first")
    if dist.get_world_size() != Px * Py:
        raise ValueError(f"mesh {tuple(mesh_shape)} needs {Px * Py} ranks, the world has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    return ProcessMesh(mesh_shape, (rank // Py, rank % Py),
                       default_device() if device is None else device)


def _local_grid(grid, nx, ny, ix, iy, axes, mesh_shape, mesh=None):
    """The grid of shard (ix, iy): its sizes, its windows of the padded
    coordinates and metrics (halo columns overlap the neighbours' interiors,
    as in the serial padded arrays), and the mesh it belongs to
    (`stepper.py:77-122`).  The land mask is attached by
    :func:`_local_masks`."""
    Hx, Hy = grid.Hx, grid.Hy
    x0, y0 = ix * nx, iy * ny
    nxp, nyp = nx + 2 * Hx, ny + 2 * Hy

    def window(m):
        if m is None or m.dim() == 0:
            return m
        if tuple(m.shape) == grid.shape:
            return m[x0:x0 + nxp, y0:y0 + nyp].contiguous()
        if m.dim() == 2 and m.shape[0] == 1:      # (1, nyp) latitude row
            return m[:, y0:y0 + nyp].contiguous()
        raise NotImplementedError(f"cannot shard metric array of shape {tuple(m.shape)} on "
                                  f"grid {grid.shape}")

    return grid.evolve(
        Nx=nx, Ny=ny, mesh_axes=axes, mesh_shape=tuple(mesh_shape), mesh=mesh,
        xc=grid.xc[x0:x0 + nxp], xf=grid.xf[x0:x0 + nxp],
        yc=grid.yc[y0:y0 + nyp], yf=grid.yf[y0:y0 + nyp],
        **{f: window(getattr(grid, f)) for f in _METRIC_LOCS},
        lon_cc=window(grid.lon_cc), lat_cc=window(grid.lat_cc), solid_cc=None)


def _local_wall(lgrid, ix, iy):
    """True in the halo bands beyond the bounded global edges that this
    shard touches; the folded north edge is connected, not a wall."""
    Hx, Hy, nx, ny = lgrid.Hx, lgrid.Hy, lgrid.Nx, lgrid.Ny
    Px, Py = lgrid.mesh_shape
    wall = torch.zeros(lgrid.shape, dtype=torch.bool, device=lgrid.device)
    if lgrid.topology[0] == BOUNDED and Hx > 0:
        if ix == 0:
            wall[:Hx] = True
        if ix == Px - 1:
            wall[Hx + nx:] = True
    if lgrid.topology[1] == BOUNDED and Hy > 0:
        if iy == 0:
            wall[:, :Hy] = True
        if iy == Py - 1 and not lgrid.north_fold:
            wall[:, Hy + ny:] = True
    return wall


def _local_solid(lgrid, solid_int, ix, iy):
    """The shard's padded solid mask: its land filled across shards (the cc
    fill: exchanges, fold, zero gradient at walls), joined with its walls."""
    wall = _local_wall(lgrid, ix, iy)
    if solid_int is None:
        return wall
    Hx, Hy = lgrid.Hx, lgrid.Hy
    s = torch.zeros(lgrid.shape, dtype=lgrid.dtype, device=lgrid.device)
    s[Hx:Hx + lgrid.Nx, Hy:Hy + lgrid.Ny] = solid_int.to(lgrid.dtype)
    return (fill_halos_cc(s, lgrid) > 0.5) | wall


def _per_masks(s):
    sx = torch.roll(s, 1, 0)
    sy = torch.roll(s, 1, 1)
    sxy = torch.roll(sx, 1, 1)
    return s | sx, s | sy, s | sx | sy | sxy


def _local_masks(lgrid, solid_int, ix, iy, immersed):
    """The shard's :class:`..model.Masks` (`stepper.py:160-177`)."""
    s = _local_solid(lgrid, solid_int, ix, iy)
    per_fc, per_cf, per_ff = _per_masks(s)
    imm_ff = None
    if immersed:
        imm_ff = per_ff & ~_per_masks(_local_wall(lgrid, ix, iy))[2]
    return Masks(solid_cc=s if immersed else None, per_fc=per_fc, per_cf=per_cf,
                 per_ff=per_ff, imm_ff=imm_ff, solid_full=s)


# On a folded grid the y-face seam row (global face Ny) is a degree of
# freedom, and the south wall face 0 is not: y-face fields keep rows 1 … Ny.
_Y_FACE_FIELDS = {"v", "vn", "sig12", "zeta_ff"}


def _shifted(name, grid):
    return grid.north_fold and name in _Y_FACE_FIELDS


def _strip_one(name, q, lgrid):
    if _shifted(name, lgrid):
        return q[lgrid.Hx:lgrid.Hx + lgrid.Nx, lgrid.Hy + 1:lgrid.Hy + lgrid.Ny + 1]
    return lgrid.interior(q)


def _embed(name, q, lgrid, mask=None):
    """An interior-only field in zeros of the padded shape, masked first."""
    Hx, Hy, Nx, Ny = lgrid.Hx, lgrid.Hy, lgrid.Nx, lgrid.Ny
    rows = slice(Hy + 1, Hy + Ny + 1) if _shifted(name, lgrid) else slice(Hy, Hy + Ny)
    if mask is not None:
        q = torch.where(mask[Hx:Hx + Nx, rows], 0.0, q)
    full = torch.zeros(lgrid.shape, dtype=q.dtype, device=q.device)
    full[Hx:Hx + Nx, rows] = q
    return full


def _pad_one(name, q, grid):
    """A serial interior-only field padded and filled."""
    return _FILLERS[_STATE_LOCS.get(name, "cc")](_embed(name, q, grid), grid)


def _pad_state(state, lgrid, masks=None):
    """Interior-only fields back to padded ones with every halo filled, all
    fields' exchanges in one message per direction, and one more for the
    shared south face rows of the y-face fields on a folded grid
    (`stepper.py:217-286`).  With ``masks``, update_state's masking applies
    to the interiors first."""
    from ..fields import _meshed
    Ny, Hy = lgrid.Ny, lgrid.Hy
    names = [n for n in _STATE_LOCS if getattr(state, n) is not None]
    tracers = list(state.tracers or {})

    def mask_of(name):
        if masks is None:
            return None
        if name in _MASKED_CC:
            return masks.solid_cc
        return {"u": masks.per_fc, "v": masks.per_cf}.get(name)

    fulls = ([_embed(n, getattr(state, n), lgrid, mask_of(n)) for n in names]
             + [_embed("h", state.tracers[k], lgrid, mask_of("h")) for k in tracers])
    locs = [_STATE_LOCS[n] for n in names] + ["cc"] * len(tracers)
    shifted = [i for i, n in enumerate(names) if _shifted(n, lgrid)]
    if _meshed(lgrid, 1) and shifted:
        # row Hy (the face shared with the south neighbour) ← its top face row
        rows = torch.stack([fulls[i][:, Hy + Ny] for i in shifted])
        from_south, _ = lgrid.mesh.shift(1, rows, None)
        if lgrid.mesh.index[1] == 0:
            from_south = torch.zeros_like(from_south)
        for k, i in enumerate(shifted):
            fulls[i][:, Hy] = from_south[k]
    filled = fill_halos_many(fulls, locs, lgrid)
    upd = dict(zip(names, filled[:len(names)]))
    if tracers:
        upd["tracers"] = dict(zip(tracers, filled[len(names):]))
    return state.evolve(**upd)


def _strip_state(state, lgrid):
    upd = {name: _strip_one(name, getattr(state, name), lgrid)
           for name in _STATE_LOCS if getattr(state, name) is not None}
    if state.tracers:
        upd["tracers"] = {k: lgrid.interior(v) for k, v in state.tracers.items()}
    return state.evolve(**upd)


def strip_halos(model, state):
    """Padded global state → interior-only state (the sharded form)."""
    return _strip_state(state, model.grid)


def unstrip_halos(model, state_int):
    """Interior-only global state → padded state with fresh halos."""
    grid = model.grid
    upd = {name: _pad_one(name, getattr(state_int, name), grid)
           for name in _STATE_LOCS if getattr(state_int, name) is not None}
    if state_int.tracers:
        upd["tracers"] = {k: _pad_one("h", v, grid) for k, v in state_int.tracers.items()}
    return state_int.evolve(**upd)


def _tensors(obj):
    """Every tensor and array reachable through dataclass fields, dicts,
    lists and tuples of ``obj``."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _check_model_shardable(model):
    """Refuse grid-shaped arrays in the model outside its grid and masks
    (`stepper.py:320-330`): a rank could not cut them."""
    shape = model.grid.shape
    for f in dataclasses.fields(model):
        if f.name in ("grid", "masks"):
            continue
        for leaf in _tensors(getattr(model, f.name)):
            if tuple(leaf.shape) == shape:
                raise NotImplementedError(
                    "distributed stepping currently requires scalar (or callable) model "
                    "inputs; got a grid-shaped model array — pass it via state.tracers or a "
                    "callable forcing instead")


def make_distributed_step(model, mesh_shape, device=None):
    """``(dstep, mesh)``: ``dstep(state_interior, dt)`` steps this rank's
    interior-only shard of ``model`` on a ``mesh_shape = (Px, Py)`` mesh of
    the ranks of the initialised world (`stepper.py:333-417`); ``mesh`` is
    this rank's :class:`ProcessMesh`.  Every rank calls it with the same
    global model, which lives on the rank's device.

    With the 'wide' halo policy the split directions' halos grow to
    2·substeps+3; a fold split across x then needs the tiled curvilinear
    route, which lets its halo evolve without refills.  Before any rank
    communicates, the momentum route of every shard is found
    (:func:`..model.meshed_momentum_route`), and shards whose routes differ
    raise ``ValueError``: every rank must run the same kernels.  Any
    dynamics the serial step takes runs on a shard (the JAX package's
    `stepper.py:333-417`), as long as the model holds no grid-shaped array
    outside its grid and masks."""
    grid = model.grid
    _check_model_shardable(model)
    Px, Py = mesh_shape
    if grid.Nx % Px or grid.Ny % Py:
        raise ValueError(f"grid {grid.Nx}x{grid.Ny} not divisible by mesh {tuple(mesh_shape)}")
    nx, ny = grid.Nx // Px, grid.Ny // Py
    axes = ("x" if Px > 1 else None, "y" if Py > 1 else None)

    dyn = model.dynamics
    solver = getattr(dyn, "solver", None)
    if getattr(solver, "halo_exchange", None) == "wide":
        H_needed = 2 * solver.substeps + 3
        # only the split directions widen: an unsplit one's fills stay local
        hx = max(H_needed, grid.Hx) if axes[0] else grid.Hx
        hy = max(H_needed, grid.Hy) if axes[1] else grid.Hy
        if (axes[0] and hx > nx) or (axes[1] and hy > ny):
            raise ValueError(f"wide-halo EVP needs halo {H_needed} ≤ tile size ({nx}, {ny}); "
                             f"reduce substeps or use halo_exchange='per_substep'")
        grid = with_halo(grid, (hx, hy))
        model = model.evolve(grid=grid)
    if dyn is not None:
        # every shard's route, before any rank communicates
        probes = [model.evolve(grid=_local_grid(grid, nx, ny, ix, iy, axes, mesh_shape))
                  for ix in range(Px) for iy in range(Py)]
        if (getattr(solver, "halo_exchange", None) == "wide" and grid.north_fold and Px > 1
                and not (solver.fused != "never" and tiled_curvilinear_envelope(probes[0]))):
            raise NotImplementedError(
                "wide-halo EVP with a north fold split across the x mesh requires the fused "
                "tiled curvilinear EVP path (set solver fused='always'/'auto' on TPU with an "
                "eligible configuration); otherwise use halo_exchange='per_substep' or a "
                "(1, Py) mesh")
        routes = [meshed_momentum_route(p) for p in probes]
        if len(set(routes)) > 1:
            raise ValueError(f"the shards of mesh {tuple(mesh_shape)} would take different "
                             f"momentum routes, in mesh order {routes}")

    mesh = make_mesh(mesh_shape, device)
    if grid.device != mesh.device:
        raise ValueError(f"the model lives on {grid.device}, this rank's device is "
                         f"{mesh.device}")
    ix, iy = mesh.index
    immersed = grid.solid_cc is not None
    solid_int = (grid.interior(grid.solid_cc)[ix * nx:(ix + 1) * nx, iy * ny:(iy + 1) * ny]
                 if immersed else None)
    lgrid = _local_grid(grid, nx, ny, ix, iy, axes, mesh_shape, mesh)
    lmasks = _local_masks(lgrid, solid_int, ix, iy, immersed)
    lgrid = lgrid.evolve(solid_cc=lmasks.solid_cc)
    lmodel = model.evolve(grid=lgrid, masks=lmasks)

    def dstep(state_int, dt):
        """One step of this rank's interior-only shard; ``dt`` as the
        serial step takes it.  ``dstep.local_model`` is the shard's model."""
        # update_state's masking and the pad-and-fill in one exchange round
        state = _pad_state(state_int, lgrid, masks=lmasks)
        return _strip_state(_step(lmodel, state, dt), lgrid)

    dstep.local_model = lmodel
    return dstep, mesh
