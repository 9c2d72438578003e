"""The tiled curvilinear αEVP route (``fixed_tiles`` on grids with array
metrics or a north fold, and such grids' shards under the 'wide' halo
policy): the gate, the pinned and the unpinned plan, the widening of serial
folded grids, the launcher, the CUDA kernels' wrappers and their plain
versions.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py`
under ``SplitExplicitSolver(fixed_tiles=(TX, TY))``: kernel 2.7
(``_tiled_curv_kernel`` under `_fixed_plan`) and kernel 2.8 (``_p_kernel``,
the ice strength the step returns).  The TPU kernel runs the curvilinear
substep loop in chunks of K substeps on halo-extended tiles, derives the EVP
coefficients inside the kernel from h, ℵ, the solid mask and the raw
metrics, and lets the Zipper fold halo evolve through a chunk: a fold-halo
point carries the exact (sign-flipped) values of its mirror, and one
substep maps exact mirrors to exact mirrors.  Serial folded grids whose y
halo is below 2K+5 rows are widened to 2K+5 for the call (metrics repadded
with fold images, masks rebuilt, stresses resolved on the original grid and
re-embedded) and cropped back after it; between chunks local fills refresh
u, v and σ.

Here the plain version (:func:`tiled_curvilinear_evp_substeps_reference`)
emulates the TPU kernel's tiles of the pinned plan: gathers with wrap into
the interior along a periodic direction and clamp along a bounded one,
circular shifts within a tile, the per-tile coefficient derivation and the
gated wall fills, all tiles of a chunk as one batch.  The CUDA kernel
(``csrc/evp_tiled_curvilinear.cu``) computes the same function on the whole
widened arrays in device memory: one launch derives the coefficients (the
0/1 masks as bits of a byte, the ocean velocity's transverse averages and
τ·drag formed once), one flags the settled blocks, three launches run each
substep, and one refills the fold halos before each chunk, on every block.
From substep ``FIRST_SKIPPED`` on a settled block does no work: every value
it writes is fixed by then (:func:`tiled_settled_blocks_reference`, the
flags' plain version).  A point's value depends only on its domain of
dependence, so the interiors agree whatever the tiles; built with
-fmad=false in the plain version's operation order, the kernel equals the
plain version bitwise there.  The ice-strength kernel
(``csrc/ice_strength_fixed.cu``) is one thread per point.

On a shard's grid (:mod:`..parallel.stepper`, the 'wide' halo policy, halos
of 2·substeps+3 along the split directions) the route runs unwidened: a
split direction does not wrap, the wall fills and the immersed drag's walls
apply only on the shards at the global edges, and a fold split across x is
never refilled: its halo evolves through every substep, and one joint
exchange of u and v follows the loop.

Without ``fixed_tiles`` a shard runs the unpinned plan (`_plan_tiles`,
what the JAX package runs on a shard under 'wide'): the same kernel with
the port's own plan (:func:`_unpinned_plan`) and the plain ice strength.
On one card the whole-array route (:mod:`.fused_evp_curvilinear`) takes
such a model, as the JAX package's whole-array tier does below its VMEM
limit.

A CUDA tensor goes to the kernels, a CPU tensor to the plain versions; a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import numpy as np
import torch

from .. import _build
from ..grids import PERIODIC, BOUNDED, _curvilinear_with_halo
from ..fields import (FILLERS, fill_halos_cc, fill_halos_ff, fill_halos_cc_local,
                      fill_halos_fc_local, fill_halos_cf_local, fill_halos_ff_local,
                      fill_halos_uv, _maybe_fold, _meshed)
from .coriolis import FPlane, LatitudeCoriolis, coriolis_f_cc
from .momentum import SplitExplicitSolver, ImmersedDrag
from .rheologies import ElastoViscoPlasticRheology, ice_strength
from .stresses import SemiImplicitStress, StressFunction, _value
from .fused_evp import (KernelCounter, _scalar, _P_DT, _P_F, _P_RC, _P_EINV2, _P_AMIN,
                        _P_AMAX, _P_CALPHA, _P_DMIN, _P_MASSMIN, _P_CONCMIN, _P_REPL,
                        N_PARAMS as _N_BASE, cuda_error_string, evp_params,
                        pick_chunk)

WY = 64           # the pinned y overlap (`pallas_evp_tiled_curvilinear.py:291`)
CHUNK_CAP = 24    # the TPU tier's own cap on K (`:102`)

# the raw planes (`:652-656`): 12 metrics, then h, ℵ, solid, uⁿ, vⁿ, τu, τv,
# uₑ, vₑ, and f at cell centres with LatitudeCoriolis
(C_DXCC, C_DXFC, C_DXCF, C_DXFF, C_DYCC, C_DYFC, C_DYCF, C_DYFF,
 C_IAZCC, C_IAZFC, C_IAZCF, C_IAZFF,
 C_H, C_A, C_SOLID, C_UN, C_VN, C_TAUU, C_TAUV, C_UE, C_VE, N_PLANES) = range(22)
C_FCOR = N_PLANES
# the extended params after the 18 of :mod:`.fused_evp` (`:659`)
PX_RHO, PX_PSTAR, PX_CHARD, PX_CDRAG = range(_N_BASE, _N_BASE + 4)
N_PARAMS = _N_BASE + 4
N_CARRY = 6
N_SCRATCH = 5     # csrc/evp_tiled_curvilinear.cu: u, v and σ's other buffers
N_WORK = 8 + 18   # its metric forms and derived planes
BLOCK = (8, 32)   # its blocks: rows along x, columns along y
FIRST_SKIPPED = 4   # the first substep a settled block skips

tiled_curvilinear_evp_counter = KernelCounter()
ice_strength_counter = KernelCounter()


# --- the pinned plan and the gate ---------------------------------------------------

def _wx(K):
    """The x overlap: 2K+4 rounded up to a multiple of 4 (`:84-95`)."""
    W = 2 * K + 4
    return W + (-W) % 4


def _walls_in_one_tile(grid, plan, Hy):
    """The gated wall fills' single-trigger-tile conditions (`:222-231`):
    along a bounded direction cut into several tiles, the first and the last
    interior row each lie in the interior of one tile only.  ``Hy``: the y
    halo the plan tiles (a serial folded grid's widened one).  The port
    crops no solid rows off a shard, so the south condition applies as it
    stands (the reference's crop drops it instead of shifting it by the
    cropped rows, ADVICE r5)."""
    _, TX, TY, Wx, Wy = plan
    ntx, nty = -(-grid.nxp // TX), -(-(grid.Ny + 2 * Hy) // TY)
    if grid.topology[0] == BOUNDED and ntx > 1 and (
            TX - Wx <= grid.Hx or (ntx - 1) * TX + Wx > grid.Hx + grid.Nx):
        return False
    return not (grid.topology[1] == BOUNDED and nty > 1 and (
        TY - Wy <= Hy or (not grid.north_fold and (nty - 1) * TY + Wy > Hy + grid.Ny)))


def _fixed_plan(grid, nsub, fixed, widen_fold=False):
    """The pinned plan (K, TX, TY, Wx, Wy) of `_fixed_plan` (`:271-307`), or
    None: K from :func:`.fused_evp.pick_chunk`, TX a multiple
    of 8 and TY of 128 (kept so that the same configurations take the route
    in both packages), and the wall fills' single-trigger-tile conditions.
    The TPU's VMEM budget is dropped: the CUDA kernel's state is in device
    memory."""
    K = pick_chunk(nsub)
    if K is None:
        return None
    TX, TY = fixed
    if TY is None or TX % 8 or TY % 128:
        return None
    plan = K, TX, TY, _wx(K), WY
    Hy = max(grid.Hy, 2 * K + 5) if widen_fold else grid.Hy
    return plan if _walls_in_one_tile(grid, plan, Hy) else None


def _unpinned_plan(grid, nsub, widen_fold=False):
    """The port's plan (K, TX, TY, Wx, Wy) without ``fixed_tiles``, the
    counterpart of `_plan_tiles` (`:112-226`), whose VMEM weights serve the
    TPU only.  The CUDA kernel runs whole arrays, so K only sets how often a
    fold whose x is not split is refilled: the largest divisor of the
    substeps up to the tier's cap of 24, for the fewest refill launches
    (without the immersed drag the refill does not change the result, the
    fold halo evolving as an exact mirror).  The plain version takes one
    tile along each direction, the padded extent rounded up to 8 points
    (with a serial folded grid's widened y halo), overlaps 2K+4 in x and in
    y 64 where y is not bounded."""
    K = max(k for k in range(2, min(CHUNK_CAP, nsub) + 1) if nsub % k == 0)
    Hy = max(grid.Hy, 2 * K + 5) if widen_fold else grid.Hy
    TX = -(-grid.nxp // 8) * 8
    TY = -(-(grid.Ny + 2 * Hy) // 8) * 8
    plan = K, TX, TY, _wx(K), 0 if grid.topology[1] == BOUNDED else WY
    if not _walls_in_one_tile(grid, plan, Hy):
        raise AssertionError(f"unpinned plan {plan} puts a wall row in two tiles")
    return plan


def tiled_curvilinear_envelope(model):
    """The physics conditions of the JAX gate (`:310-394`) without the tile
    plan: an αEVP split-explicit solver with a chunk length, a grid with
    array metrics or a fold, float32, periodic or bounded sides, ImmersedDrag
    or none, scalar, array or StressFunction stresses, an FPlane, a
    LatitudeCoriolis on a grid with latitudes or no Coriolis, no free drift,
    no user forcing; on a shard the 'wide' halo policy and, where the fold is
    split across x, a y halo of at least 2·substeps+3 rows.  Dropped: the
    TPU-only VMEM budget and 50 M-point cap."""
    grid = model.grid
    dyn = model.dynamics
    if dyn is None or not isinstance(dyn.rheology, ElastoViscoPlasticRheology):
        return False
    solver = dyn.solver
    if not isinstance(solver, SplitExplicitSolver):
        return False
    if not any(solver.substeps % K == 0 for K in range(2, min(CHUNK_CAP, solver.substeps) + 1)):
        return False
    if grid.kind == "rectilinear" and not grid.north_fold:
        return False
    if any(t not in (PERIODIC, BOUNDED) for t in grid.topology):
        return False
    if grid.north_fold and grid.topology[1] != BOUNDED:
        return False
    if grid.Hx == 0 or grid.Hy == 0 or grid.dtype != torch.float32:
        return False
    if grid.mesh_axes is not None:
        if solver.halo_exchange != "wide":
            return False
        if grid.north_fold and _meshed(grid, 0) and grid.Hy < 2 * solver.substeps + 3:
            return False
    if dyn.immersed_drag is not None and not isinstance(dyn.immersed_drag, ImmersedDrag):
        return False

    def ok_value(x):
        return (isinstance(x, StressFunction) or _scalar(x)
                or tuple(getattr(x, "shape", ())) == grid.shape)

    top = dyn.top_momentum_stress
    if isinstance(top, dict):
        if not (ok_value(top.get("u")) and ok_value(top.get("v"))):
            return False
    elif not ok_value(top):
        return False
    bottom = dyn.bottom_momentum_stress
    if bottom is not None and not isinstance(bottom, SemiImplicitStress):
        return False
    if isinstance(bottom, SemiImplicitStress) and not (ok_value(bottom.ue)
                                                       and ok_value(bottom.ve)):
        return False
    cor = dyn.coriolis
    if not (cor is None or isinstance(cor, FPlane)
            or (isinstance(cor, LatitudeCoriolis) and grid.lat_cc is not None)):
        return False
    if dyn.free_drift is not None or model.forcing:
        return False
    return True


def tiled_curvilinear_available(model):
    """True when the model takes this route: the physics conditions of
    :func:`tiled_curvilinear_envelope` and, with ``fixed_tiles``, a pinned
    plan (on a serial folded grid for its widening); without
    ``fixed_tiles`` on a shard only, under the unpinned plan.  On one card
    the whole-array route computes that function, so a serial model without
    ``fixed_tiles`` does not take this one."""
    if not tiled_curvilinear_envelope(model):
        return False
    solver = model.dynamics.solver
    grid = model.grid
    if solver.fixed_tiles is None:
        return grid.mesh_axes is not None
    return _fixed_plan(grid, solver.substeps, solver.fixed_tiles,
                       widen_fold=grid.north_fold and grid.mesh_axes is None) is not None


def _geometry(grid):
    """How the kernels see a grid that may be one rank's shard: per direction
    whether it wraps (periodic and not split across ranks) and whether it is
    bounded; the gates of the four wall fills (west, east, south, north), 1
    where the shard touches that global edge or the direction is not split
    (`:1133-1142`); and whether the fold halo is refilled between chunks (a
    folded grid whose x is not split, `:1199-1211`)."""
    meshed = (_meshed(grid, 0), _meshed(grid, 1))
    wrap = tuple(grid.topology[d] == PERIODIC and not meshed[d] for d in (0, 1))
    bounded = tuple(grid.topology[d] == BOUNDED for d in (0, 1))
    gates = []
    for d in (0, 1):
        for low in (True, False):
            gates.append(int(not meshed[d] or grid.mesh.index[d]
                             == (0 if low else grid.mesh_shape[d] - 1)))
    return SimpleNamespace(wrap=wrap, bounded=bounded, gates=tuple(gates),
                           refill=bool(grid.north_fold and not meshed[0]))


# --- the widening of serial folded grids ------------------------------------------------

@functools.lru_cache(maxsize=8)
def widened_grid(grid, Hw):
    """``(gw, solid)``: ``grid`` with ``Hw`` y-halo rows (`_widen_folded`,
    `:518-583`): metrics and ``lat_cc`` repadded with fold images
    (:func:`..grids._curvilinear_with_halo`), and the solid mask of
    `_widened_masks` (`:436-472`) as float32, the land's cc fill on the
    widened grid joined with the walls.  Made once per grid and halo."""
    Hx, Nx, Ny = grid.Hx, grid.Nx, grid.Ny
    gw = _curvilinear_with_halo(grid, Hx, Hw).evolve(lon_cc=None)
    wall = torch.zeros(gw.shape, dtype=torch.bool, device=grid.device)
    if gw.topology[0] == BOUNDED:
        wall[:Hx] = True
        wall[Hx + Nx:] = True
    if gw.topology[1] == BOUNDED:
        wall[:, :Hw] = True
        if not gw.north_fold:
            wall[:, Hw + Ny:] = True
    solid = wall
    if grid.solid_cc is not None:
        s = torch.zeros(gw.shape, dtype=grid.dtype, device=grid.device)
        s[Hx:Hx + Nx, Hw:Hw + Ny] = grid.interior(grid.solid_cc).to(grid.dtype)
        solid = (fill_halos_cc(s, gw) > 0.5) | wall
        gw = gw.evolve(solid_cc=solid)
    return gw, solid.to(torch.float32).contiguous()


def _embed(q, grid, gw, loc):
    """A field of ``grid`` on the widened ``gw``: its interior (with the
    seam row of a y-face field) in zeros, then the fill of its location."""
    Hx, Nx, Hy, Hw = grid.Hx, grid.Nx, grid.Hy, gw.Hy
    keep = grid.Ny + 1 if loc[1] == "f" else grid.Ny
    full = torch.zeros(gw.shape, dtype=q.dtype, device=q.device)
    full[Hx:Hx + Nx, Hw:Hw + keep] = q[Hx:Hx + Nx, Hy:Hy + keep]
    return FILLERS[tuple(loc)](full, gw)


def _crop(q, grid, gw, loc):
    """A widened field back on ``grid``'s padding, zero halos."""
    Hx, Nx, Hy, Hw = grid.Hx, grid.Nx, grid.Hy, gw.Hy
    keep = grid.Ny + 1 if loc[1] == "f" else grid.Ny
    full = torch.zeros(grid.shape, dtype=q.dtype, device=q.device)
    full[Hx:Hx + Nx, Hy:Hy + keep] = q[Hx:Hx + Nx, Hw:Hw + keep]
    return full


# --- the inputs -----------------------------------------------------------------------

def tiled_curvilinear_inputs(model, state, dt, u_start, v_start, Hw=None):
    """``(params, planes, carry, grid, flags)`` of the substep loop, as
    `_prepare_tiled_inputs` (`:981-1019`) assembles them, on ``model``'s
    grid or, with ``Hw``, on its widening to ``Hw`` y-halo rows.
    ``params``: float32[22] (the 18 of :mod:`.fused_evp`, then ρ, P★, C and
    the immersed-drag coefficient); ``planes``: the 21 raw planes (22 with
    f(φ)); ``carry``: fresh (u, v, σ₁₁, σ₂₂, σ₁₂, α); ``flags``: (immersed,
    has_drag) as the TPU kernel's static flags.  StressFunctions are
    evaluated on the original grid at the step-start clock; vector
    components carry the Zipper sign flip on their fold halo."""
    from ..model import make_fields

    grid = model.grid
    dyn = model.dynamics
    rheo = dyn.rheology
    f32 = grid.scalar
    masks = model.masks
    if Hw is None:
        target, solid = grid, masks.solid_full.to(torch.float32)
        immersed = masks.solid_cc is not None
        has_drag = dyn.immersed_drag is not None and masks.imm_ff is not None
    else:
        target, solid = widened_grid(grid, Hw)
        immersed = grid.solid_cc is not None
        has_drag = dyn.immersed_drag is not None and immersed

    def on_target(q, loc):
        return q if Hw is None else _embed(q, grid, target, loc)

    fields = make_fields(model, state)

    def vector(x, loc):   # a τ component or an ocean velocity, fold-signed
        v = _value(0.0 if x is None else x, grid, state.clock, fields).to(torch.float32)
        if tuple(v.shape) == grid.shape:
            v = on_target(v, loc)
        v = v.broadcast_to(target.shape)
        return _maybe_fold(v, target, loc[0] == "f", loc[1] == "f", -1.0)

    top = dyn.top_momentum_stress
    tops = (top.get("u"), top.get("v")) if isinstance(top, dict) else (top, top)
    tau_u, tau_v = vector(tops[0], "fc"), vector(tops[1], "cf")
    bottom = dyn.bottom_momentum_stress
    if isinstance(bottom, SemiImplicitStress):
        rC = f32(bottom.rho_e * bottom.Cd)
        ue, ve = vector(bottom.ue, "fc"), vector(bottom.ve, "cf")
    else:
        rC = f32(0.0)
        ue, ve = vector(None, "fc"), vector(None, "cf")

    def met(name):
        return f32(getattr(target, name)).broadcast_to(target.shape)

    metrics = [met(f"d{d}_{loc}") for d in "xy" for loc in ("cc", "fc", "cf", "ff")]
    metrics += [1.0 / met("az_" + loc) for loc in ("cc", "fc", "cf", "ff")]
    u0, v0 = on_target(u_start, "fc"), on_target(v_start, "cf")
    planes = metrics + [on_target(state.h, "cc"), on_target(state.a, "cc"), solid, u0, v0,
                        tau_u, tau_v, ue, ve]
    cor = dyn.coriolis
    if isinstance(cor, LatitudeCoriolis):
        planes.append(coriolis_f_cc(cor, target).to(torch.float32))
    zero = f32(0.0)
    params = torch.cat([
        evp_params(model, f32(dt), zero, zero, rC, zero, zero, dx=1.0, dy=1.0,
                   f=cor.f if isinstance(cor, FPlane) else 0.0),
        torch.stack([f32(model.sea_ice_density), f32(rheo.ice_compressive_strength),
                     f32(rheo.ice_compaction_hardening),
                     f32(dyn.immersed_drag.coefficient if has_drag else 0.0)])])
    carry = [u0, v0] + [on_target(q, loc) for q, loc in (
        (state.sig11, "cc"), (state.sig22, "cc"), (state.sig12, "ff"), (state.alpha, "cc"))]
    planes = tuple(q.to(torch.float32).contiguous() for q in planes)
    carry = tuple(q.to(torch.float32).clone(memory_format=torch.contiguous_format)
                  for q in carry)
    return params.contiguous(), planes, carry, target, (immersed, has_drag)


# --- the plain version -------------------------------------------------------------------

def _tile_indices(ext, n_int, H, n_tiles, T, W, wrap):
    """Gather indices and interior coordinates of every tile along one
    direction (`:1058-1071`): wrap into the interior where periodic and not
    split across ranks, clamp at the padded edge otherwise."""
    idx, coords = [], []
    for i in range(n_tiles):
        r = np.arange(i * T - W, i * T + T + W)
        coords.append(r - H)
        idx.append(H + (r - H) % n_int if wrap else np.clip(r, 0, ext - 1))
    return np.concatenate(idx), np.concatenate(coords)


class _Tiles:
    """A plan's tiles of a grid, all tiles of a chunk as one batch (tiles,
    bx, by)."""

    def __init__(self, grid, plan, device):
        _, TX, TY, Wx, Wy = plan
        self.grid, self.TX, self.TY, self.Wx, self.Wy = grid, TX, TY, Wx, Wy
        nxp, nyp = grid.nxp, grid.nyp
        self.ntx, self.nty = -(-nxp // TX), -(-nyp // TY)
        self.bx, self.by = TX + 2 * Wx, TY + 2 * Wy
        self.geo = geo = _geometry(grid)
        ix, cx = _tile_indices(nxp, grid.Nx, grid.Hx, self.ntx, TX, Wx, geo.wrap[0])
        iy, cy = _tile_indices(nyp, grid.Ny, grid.Hy, self.nty, TY, Wy, geo.wrap[1])
        self.ix = torch.as_tensor(ix, device=device)
        self.iy = torch.as_tensor(iy, device=device)
        n = self.ntx * self.nty
        self.gx = (torch.as_tensor(cx, dtype=torch.float32, device=device)
                   .reshape(self.ntx, 1, self.bx, 1).expand(-1, self.nty, -1, -1)
                   .reshape(n, self.bx, 1))
        self.gy = (torch.as_tensor(cy, dtype=torch.float32, device=device)
                   .reshape(1, self.nty, 1, self.by).expand(self.ntx, -1, -1, -1)
                   .reshape(n, 1, self.by))

    def gather(self, q):
        return (q[self.ix][:, self.iy].reshape(self.ntx, self.bx, self.nty, self.by)
                .permute(0, 2, 1, 3).reshape(-1, self.bx, self.by))

    def scatter(self, t):
        TX, TY = self.TX, self.TY
        q = t[:, self.Wx:self.Wx + TX, self.Wy:self.Wy + TY]
        q = q.reshape(self.ntx, self.nty, TX, TY).permute(0, 2, 1, 3)
        return q.reshape(self.ntx * TX, self.nty * TY)[:self.grid.nxp, :self.grid.nyp]


def _stencils():
    """Circular shifts within a tile (``pltpu.roll``) and the staggered
    averages built on them (`:705-742`), along axes 0 (x) and 1 (y) of a
    (tiles, bx, by) batch."""
    def sp(q, axis):   # q[I-1]
        return torch.roll(q, 1, axis + 1)

    def sm(q, axis):   # q[I+1]
        return torch.roll(q, -1, axis + 1)

    def ixyf_(q):
        t = q + sp(q, 1)
        return 0.25 * (t + sp(t, 0))

    def ixyc_(q):
        t = q + sm(q, 1)
        return 0.25 * (t + sm(t, 0))

    def ixf_yc_(q):
        t = q + sm(q, 1)
        return 0.25 * (t + sp(t, 0))

    def ixc_yf_(q):
        t = q + sp(q, 1)
        return 0.25 * (t + sm(t, 0))

    return SimpleNamespace(sp=sp, sm=sm, ixf_=lambda q: 0.5 * (q + sp(q, 0)),
                           iyf_=lambda q: 0.5 * (q + sp(q, 1)), ixyf_=ixyf_, ixyc_=ixyc_,
                           ixf_yc_=ixf_yc_, ixc_yf_=ixc_yf_)


def _coefficients(params, c, tiles, flags):
    """The TPU kernel's in-kernel coefficient block on tiles, in its order
    (`:744-834`): the metric forms, P, Pff, gcc, gff, the drags and 1/m, the
    activity and σ masks from the solid plane, the immersed-drag weights
    with the walls in coordinates (each gated on the shard touching it), f
    at the velocity points."""
    immersed, has_drag = flags
    grid = tiles.grid
    gx, gy = tiles.gx, tiles.gy
    st = _stencils()
    sp, sm, ixf_, iyf_, ixyf_ = st.sp, st.sm, st.ixf_, st.iyf_, st.ixyf_
    p = params
    dt = p[_P_DT]
    out = {}

    dx_ff, dy_ff = c[C_DXFF], c[C_DYFF]
    out.update(dy_cc2=c[C_DYCC] * c[C_DYCC], dx_cc2=c[C_DXCC] * c[C_DXCC],
               dx_ff2=dx_ff * dx_ff, dy_ff2=dy_ff * dy_ff,
               inv_dy_fc=1.0 / c[C_DYFC], inv_dx_cf=1.0 / c[C_DXCF],
               inv_dx_fc=1.0 / c[C_DXFC], inv_dy_cf=1.0 / c[C_DYCF])
    h, a, solid = c[C_H], c[C_A], c[C_SOLID]
    m_cc = h * a * p[PX_RHO]
    P = p[PX_PSTAR] * h * torch.exp(-p[PX_CHARD] * (1.0 - a))
    m_ff, m_fc, a_fc, m_cf, a_cf = ixyf_(m_cc), ixf_(m_cc), ixf_(a), iyf_(m_cc), iyf_(a)
    cadt = p[_P_CALPHA] * dt
    out["P"], out["Pff"] = P, ixyf_(P)
    out["gcc"] = torch.where(m_cc > 0, cadt * c[C_IAZCC] / torch.where(m_cc > 0, m_cc, 1.0),
                             -1.0)
    out["gff"] = torch.where(m_ff > 0, cadt * c[C_IAZFF] / torch.where(m_ff > 0, m_ff, 1.0),
                             -1.0)
    ok_u, ok_v = m_fc > 0, m_cf > 0
    out["invm_u"] = torch.where(ok_u, 1.0 / torch.where(ok_u, m_fc, 1.0), 0.0)
    out["invm_v"] = torch.where(ok_v, 1.0 / torch.where(ok_v, m_cf, 1.0), 0.0)
    out["drag_u"] = out["invm_u"] * a_fc
    out["drag_v"] = out["invm_v"] * a_cf
    per_fc = torch.maximum(solid, sp(solid, 0))
    per_cf = torch.maximum(solid, sp(solid, 1))
    per_ff = torch.maximum(per_fc, sp(per_fc, 1))
    out["act_u"] = torch.where((m_fc >= p[_P_MASSMIN]) & (a_fc >= p[_P_CONCMIN])
                               & (per_fc < 0.5), 1.0, 0.0)
    out["act_v"] = torch.where((m_cf >= p[_P_MASSMIN]) & (a_cf >= p[_P_CONCMIN])
                               & (per_cf < 0.5), 1.0, 0.0)
    out["msk_cc"] = (1.0 - solid) if immersed else torch.ones_like(solid)
    out["msk_ff"] = 1.0 - per_ff
    if has_drag:
        gw, ge, gs, gn = tiles.geo.gates
        wall = torch.zeros(per_ff.shape, dtype=torch.bool, device=per_ff.device)
        if grid.topology[0] == BOUNDED:
            wall = wall | ((gx <= 0) & bool(gw)) | ((gx >= grid.Nx) & bool(ge))
        if grid.topology[1] == BOUNDED:
            wall = wall | ((gy <= 0) & bool(gs))
            if not grid.north_fold:
                wall = wall | ((gy >= grid.Ny) & bool(gn))
        imm_ff = (per_ff > 0.5) & ~wall
        Cd = p[PX_CDRAG]
        wxd = torch.where(imm_ff, Cd * dx_ff, 0.0) * c[C_IAZFC]
        wyd = torch.where(imm_ff, Cd * dy_ff, 0.0) * c[C_IAZCF]
        out.update(imms_u=wxd, immn_u=sm(wxd, 1), immw_v=wyd, imme_v=sm(wyd, 0))
    if len(c) > C_FCOR:
        out["f_fc"], out["f_cf"] = ixf_(c[C_FCOR]), iyf_(c[C_FCOR])
    return out


def _substep_functions(params, c, k, tiles, flags):
    """The TPU kernel's ``one`` (`:843-966`) on tiles, with the wall fills of
    `_make_fillers` (`:588-644`; no fold branch), each gated on the shard
    touching that wall."""
    _, has_drag = flags
    grid = tiles.grid
    Hx, Hy, Nx, Ny = grid.Hx, grid.Hy, grid.Nx, grid.Ny
    bounded_x = grid.topology[0] == BOUNDED
    bounded_y = grid.topology[1] == BOUNDED
    fold = grid.north_fold
    gw, ge, gs, gn = (bool(g) for g in tiles.geo.gates)
    gx, gy = tiles.gx, tiles.gy
    wx_off = tiles.Wx + Hx
    ex_off = tiles.Wx + Hx + Nx - 1 - (tiles.ntx - 1) * tiles.TX
    sy_off = tiles.Wy + Hy
    ny_off = tiles.Wy + Hy + Ny - 1 - (tiles.nty - 1) * tiles.TY
    st = _stencils()
    sp, sm, ixf_, iyf_ = st.sp, st.sm, st.ixf_, st.iyf_
    ixyf_, ixyc_, ixf_yc_, ixc_yf_ = st.ixyf_, st.ixyc_, st.ixf_yc_, st.ixc_yf_
    p = params
    rC, e_inv2, a_min, a_max, d_min = p[_P_RC], p[_P_EINV2], p[_P_AMIN], p[_P_AMAX], p[_P_DMIN]
    repl_on = bool(p[_P_REPL] != 0)

    def fill_x(q, face):
        if not bounded_x:
            return q
        if face:
            q = torch.where((gx < 0) & gw, 0.0, q)
            return torch.where((gx > Nx) & ge, 0.0, q)
        q = torch.where((gx < 0) & gw, q[:, wx_off:wx_off + 1], q)
        return torch.where((gx >= Nx) & ge, q[:, ex_off:ex_off + 1], q)

    def fill_y(q, face):
        if not bounded_y:
            return q
        if face:
            q = torch.where((gy < 0) & gs, 0.0, q)
        else:
            q = torch.where((gy < 0) & gs, q[:, :, sy_off:sy_off + 1], q)
        if not fold:
            if face:
                q = torch.where((gy > Ny) & gn, 0.0, q)
            else:
                q = torch.where((gy >= Ny) & gn, q[:, :, ny_off:ny_off + 1], q)
        return q

    def fill_fc(q):
        return fill_y(fill_x(q, True), False)

    def fill_cf(q):
        return fill_y(fill_x(q, False), True)

    dy_fc, dx_cf = c[C_DYFC], c[C_DXCF]
    inv_az_cc, inv_az_fc, inv_az_cf, inv_az_ff = c[C_IAZCC], c[C_IAZFC], c[C_IAZCF], c[C_IAZFF]
    dy_cc2, dx_cc2, dx_ff2, dy_ff2 = k["dy_cc2"], k["dx_cc2"], k["dx_ff2"], k["dy_ff2"]
    inv_dy_fc, inv_dx_cf = k["inv_dy_fc"], k["inv_dx_cf"]
    inv_dx_fc, inv_dy_cf = k["inv_dx_fc"], k["inv_dy_cf"]
    P, Pff, gcc, gff = k["P"], k["Pff"], k["gcc"], k["gff"]
    invm_u, invm_v, drag_u, drag_v = k["invm_u"], k["invm_v"], k["drag_u"], k["drag_v"]
    act_u, act_v, msk_cc, msk_ff = k["act_u"], k["act_v"], k["msk_cc"], k["msk_ff"]
    un, vn = c[C_UN], c[C_VN]
    tau_u_top, tau_v_top, ue, ve = c[C_TAUU], c[C_TAUV], c[C_UE], c[C_VE]
    f_fc, f_cf = (k["f_fc"], k["f_cf"]) if "f_fc" in k else (p[_P_F], p[_P_F])
    ve_fc, ue_cf = ixf_yc_(ve), ixc_yf_(ue)
    inv_dt = 1.0 / p[_P_DT]
    inv_dmin = 1.0 / d_min
    amin2, amax2 = a_min * a_min, a_max * a_max

    def stresses(u, v, s11, s22, s12):
        u_dy = u * dy_fc
        v_dx = v * dx_cf
        eD = ((sm(u_dy, 0) - u_dy) + (sm(v_dx, 1) - v_dx)) * inv_az_cc
        u_ody = u * inv_dy_fc
        v_odx = v * inv_dx_cf
        eT = (dy_cc2 * (sm(u_ody, 0) - u_ody) - dx_cc2 * (sm(v_odx, 1) - v_odx)) * inv_az_cc
        u_odx = u * inv_dx_fc
        v_ody = v * inv_dy_cf
        eS = (dx_ff2 * (u_odx - sp(u_odx, 1)) + dy_ff2 * (v_ody - sp(v_ody, 0))) * inv_az_ff
        d_ff = ixyf_(eD)
        t_ff = ixyf_(eT)
        eSc = ixyc_(eS)
        dd_cc = eD * eD + (eT * eT + eSc * eSc) * e_inv2
        dd_ff = d_ff * d_ff + (t_ff * t_ff + eS * eS) * e_inv2
        rD_cc = torch.minimum(torch.rsqrt(dd_cc), inv_dmin)
        rD_ff = torch.minimum(torch.rsqrt(dd_ff), inv_dmin)
        zcc = 0.5 * P * rD_cc
        zff = 0.5 * Pff * rD_ff
        if repl_on:
            Dcc = torch.maximum(dd_cc * rD_cc, d_min)
            Pr = P * Dcc / (Dcc + d_min)
        else:
            Pr = P
        eta_cc = zcc * e_inv2
        eta_ff = zff * e_inv2
        iso = (zcc - eta_cc) * eD - Pr * 0.5
        s11_t = eta_cc * (eD + eT) + iso
        s22_t = eta_cc * (eD - eT) + iso
        s12_t = eta_ff * eS
        g2cc = torch.clamp(zcc * gcc, amin2, amax2)
        g2ff = torch.clamp(zff * gff, amin2, amax2)
        rg_cc = torch.rsqrt(g2cc)
        rg_ff = torch.rsqrt(g2ff)
        ok_g = gcc > 0
        gamma_cc = torch.where(ok_g, g2cc * rg_cc, a_max)
        s11 = s11 + torch.where(ok_g, (s11_t - s11) * rg_cc, 0.0)
        s22 = s22 + torch.where(ok_g, (s22_t - s22) * rg_cc, 0.0)
        s12 = s12 + torch.where(gff > 0, (s12_t - s12) * rg_ff, 0.0)
        return s11, s22, s12, gamma_cc

    def divergences(s11, s22, s12):
        s11m = s11 * msk_cc
        s22m = s22 * msk_cc
        s12m = s12 * msk_ff
        sD = s11m + s22m
        sT = s11m - s22m
        yT = dy_cc2 * sT
        xS = dx_ff2 * s12m
        div_x = (0.5 * (dy_fc * (sD - sp(sD, 0)) + (yT - sp(yT, 0)) * inv_dy_fc)
                 + (sm(xS, 1) - xS) * inv_dx_fc) * inv_az_fc
        xT = dx_cc2 * sT
        yS = dy_ff2 * s12m
        div_y = (0.5 * (dx_cf * (sD - sp(sD, 1)) - (xT - sp(xT, 1)) * inv_dx_cf)
                 + (sm(yS, 0) - yS) * inv_dy_cf) * inv_az_cf
        return div_x, div_y

    def u_update(u, v, div_x, alpha):
        v_fc = ixf_yc_(v)
        du = ue - u
        dv = ve_fc - v_fc
        speed = torch.sqrt(du * du + dv * dv)
        imm = (k["imms_u"] * u + k["immn_u"] * sm(u, 1)) * invm_u if has_drag else 0.0
        Gu = (f_fc * v_fc - tau_u_top * drag_u + rC * speed * ue * drag_u
              + div_x * invm_u - imm + (un - u) * inv_dt)
        Gu = torch.where(invm_u > 0, Gu, 0.0)
        idtau = ixf_(alpha) * inv_dt
        return fill_fc((u * idtau + Gu) / (idtau + rC * speed * drag_u) * act_u)

    def v_update(u, v, div_y, alpha):
        u_cf = ixc_yf_(u)
        dv = ve - v
        du = ue_cf - u_cf
        speed = torch.sqrt(du * du + dv * dv)
        imm = (k["immw_v"] * v + k["imme_v"] * sm(v, 0)) * invm_v if has_drag else 0.0
        Gv = (-f_cf * u_cf - tau_v_top * drag_v + rC * speed * ve * drag_v
              + div_y * invm_v - imm + (vn - v) * inv_dt)
        Gv = torch.where(invm_v > 0, Gv, 0.0)
        idtau = iyf_(alpha) * inv_dt
        return fill_cf((v * idtau + Gv) / (idtau + rC * speed * drag_v) * act_v)

    def one(carry, even):
        u, v, s11, s22, s12, alpha = carry
        s11, s22, s12, alpha = stresses(u, v, s11, s22, s12)
        div_x, div_y = divergences(s11, s22, s12)
        if even:
            u = u_update(u, v, div_x, alpha)
            v = v_update(u, v, div_y, alpha)
        else:
            v = v_update(u, v, div_y, alpha)
            u = u_update(u, v, div_x, alpha)
        return u, v, s11, s22, s12, alpha

    return one, fill_fc, fill_cf


def _refill(carry, grid):
    """The local fills between chunks on a folded grid whose x is not split
    across ranks (`:1199-1212`); α keeps its values."""
    u, v, s11, s22, s12, alpha = carry
    return (fill_halos_fc_local(u, grid), fill_halos_cf_local(v, grid),
            fill_halos_cc_local(s11, grid), fill_halos_cc_local(s22, grid),
            fill_halos_ff_local(s12, grid), alpha)


def tiled_curvilinear_evp_substeps_reference(params, planes, carry, nsub, grid, plan, flags,
                                             chunk=None):
    """Plain PyTorch version of the kernel: ``nsub`` substeps in chunks of
    ``chunk`` (default the plan's K) on the TPU kernel's tiles of ``plan``
    (`:1074-1228`), the coefficients derived per chunk, the fold halos
    refilled before each chunk on a folded grid unless its x is split across
    ranks (then the fold halo evolves through every substep).  Returns the
    new (u, v, σ₁₁, σ₂₂, σ₁₂, α) on the padded shape."""
    K = plan[0] if chunk is None else int(chunk)
    tiles = _Tiles(grid, plan, params.device)
    c = [tiles.gather(q) for q in planes]
    k = _coefficients(params, c, tiles, flags)
    one, fill_fc, fill_cf = _substep_functions(params, c, k, tiles, flags)
    carry = tuple(carry)
    for first in range(1, nsub + 1, K):
        if tiles.geo.refill:
            carry = _refill(carry, grid)
        u, v, s11, s22, s12, alpha = (tiles.gather(q) for q in carry)
        state = (fill_fc(u), fill_cf(v), s11, s22, s12, alpha)
        for s in range(first, min(first + K, nsub + 1)):
            state = one(state, s % 2 == 0)
        carry = tuple(tiles.scatter(q) for q in state)
    return carry


def curvilinear_consts(params, planes, grid, plan, flags):
    """``(params18, consts, f_planes)`` for the whole-array kernel
    (:func:`.fused_evp_curvilinear.curvilinear_evp_substeps`) that hold the
    coefficients this route derives (the plain version's, on the plan's
    tiles), so that both kernels run on the same input."""
    tiles = _Tiles(grid, plan, params.device)
    c = [tiles.gather(q) for q in planes]
    k = {name: tiles.scatter(q).contiguous()
         for name, q in _coefficients(params, c, tiles, flags).items()}
    consts = list(planes[:12]) + [k[n] for n in ("P", "Pff", "gcc", "gff", "drag_u",
                                                 "invm_u", "act_u")]
    consts += [planes[C_UN]] + [k[n] for n in ("drag_v", "invm_v", "act_v")]
    consts += [planes[C_VN], k["msk_cc"], k["msk_ff"]]
    if flags[1]:
        consts += [k[n] for n in ("imms_u", "immn_u", "immw_v", "imme_v")]
    consts += [planes[n] for n in (C_TAUU, C_TAUV, C_UE, C_VE)]
    f_planes = (k["f_fc"], k["f_cf"]) if "f_fc" in k else None
    return params[:_N_BASE].contiguous(), tuple(consts), f_planes


# --- the settled blocks ------------------------------------------------------------------

def _axis(ext, H, N, wrap):
    """Along one direction, the kernel's index rules as numpy functions of
    padded indices: a point's image (wrapped into the interior where the
    direction wraps) and its neighbour d away (from the image by wrap, or
    clamped at the padded edge)."""
    def image(i):
        return H + (i - H) % N if wrap else i

    def near(i, d):
        return H + (image(i) + d - H) % N if wrap else np.clip(i + d, 0, ext - 1)

    return image, near


def _local_source(i, H, N, wrap, bounded, g_lo, g_hi, face):
    """The source of padded index ``i`` in the local fill between chunks
    (the kernel's ``local_source``; −1 where it writes zero)."""
    if H == 0 or not (wrap or bounded):
        return i
    if wrap:
        return np.where(i < H, i + N, np.where(i >= H + N, i - N, i))
    if face:
        return np.where((g_lo & (i < H)) | (g_hi & (i > H + N)), -1, i)
    return np.where(g_lo & (i < H), H, np.where(g_hi & (i >= H + N), H + N - 1, i))


def _dead_points(params, planes, grid, plan, flags):
    """The points where the loop leaves σ, α and an update computed there at
    fixed values: gcc ≤ 0, gff ≤ 0, act_u = act_v = 0, 1/m ≤ 0 at (f,c) and
    (c,f), from the plain version's coefficients at every padded point.  The
    plan's tiles are given an overlap of at least 4 points each way, so that
    a point at the padded edge reads its clamped neighbours, as the kernel
    does, and not a tile's circular shift (the unpinned plan has none along
    a bounded y)."""
    K, TX, TY, Wx, Wy = plan
    tiles = _Tiles(grid, (K, TX, TY, max(Wx, 4), max(Wy, 4)), params.device)
    k = _coefficients(params, [tiles.gather(q) for q in planes], tiles, flags)
    k = {n: tiles.scatter(k[n]) for n in ("gcc", "gff", "act_u", "act_v", "invm_u", "invm_v")}
    return ((k["gcc"] <= 0) & (k["gff"] <= 0) & (k["act_u"] == 0) & (k["act_v"] == 0)
            & (k["invm_u"] <= 0) & (k["invm_v"] <= 0))


def tiled_settled_blocks_reference(params, planes, grid, plan, flags):
    """Plain version of the kernel's flag launch: for each block of its
    launch grid (``BLOCK`` points; ceil(nxp/8) × ceil(nyp/32)), True where,
    for each of its points, every point within one of it, within one of the
    source its u and its v update are computed at (the gated wall fills'
    clamp sources), and, where the fold is refilled between chunks, within
    one of its σ's refill source is dead (:func:`_dead_points`), by the
    kernel's indexing (wrap into the interior where a direction wraps,
    clamp at the padded edge otherwise); and, where the fold is refilled,
    where the block holds no fold row (the refill's negated mirror would
    turn a dead source's +0 into −0 there).  From substep ``FIRST_SKIPPED``
    on the kernel does no work in such a block: every value it writes there
    is fixed after substep 2, and the refill, on every block, copies into
    it what it holds (see csrc/evp_tiled_curvilinear.cu)."""
    dead = _dead_points(params, planes, grid, plan, flags).cpu().numpy()
    geo = _geometry(grid)
    Hx, Nx, Hy, Ny = grid.Hx, grid.Nx, grid.Hy, grid.Ny
    img_x, near_x = _axis(grid.nxp, Hx, Nx, geo.wrap[0])
    img_y, near_y = _axis(grid.nyp, Hy, Ny, geo.wrap[1])
    i, j = np.meshgrid(np.arange(grid.nxp), np.arange(grid.nyp), indexing="ij")

    def around(si, sj):   # every point within one of (si, sj) dead
        ok = np.ones(si.shape, bool)
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                ok &= dead[near_x(si, a), near_y(sj, b)]
        return ok

    bnd_x, bnd_y = geo.bounded
    gw, ge, gs, gn = (bool(g) for g in geo.gates)
    fold = grid.north_fold
    ok = around(i, j)
    # u: zero beyond a bounded x wall face, else computed at (i, clamped j)
    u_zero = bnd_x & ((gw & (i < Hx)) | (ge & (i > Hx + Nx)))
    uj = j
    if bnd_y:
        uj = np.where(gs & (j < Hy), Hy, np.where((not fold) & gn & (j >= Hy + Ny),
                                                  Hy + Ny - 1, j))
    ok &= u_zero | around(i, uj)
    # v: zero beyond a bounded y wall face, else computed at (clamped i, j)
    v_zero = bnd_y & ((gs & (j < Hy)) | ((not fold) & gn & (j > Hy + Ny)))
    vi = i
    if bnd_x:
        vi = np.where(gw & (i < Hx), Hx, np.where(ge & (i >= Hx + Nx), Hx + Nx - 1, i))
    ok &= v_zero | around(vi, j)
    if geo.refill:
        si = _local_source(i, Hx, Nx, geo.wrap[0], bnd_x, gw, ge, False)
        sj = _local_source(j, Hy, Ny, geo.wrap[1], bnd_y, gs, gn, False)
        ok &= around(si, sj)
        if fold and gn:
            ok &= j < Hy + Ny
    bx, by = BLOCK
    nbx, nby = -(-grid.nxp // bx), -(-grid.nyp // by)
    padded = np.ones((nbx * bx, nby * by), bool)
    padded[:grid.nxp, :grid.nyp] = ok
    flags_ = padded.reshape(nbx, bx, nby, by).all(axis=3).all(axis=1)
    return torch.as_tensor(flags_, device=params.device)


# --- the kernel's wrapper --------------------------------------------------------------

def _tiled_entry():
    fn = _build.load("evp_tiled_curvilinear").csi_evp_tiled_curvilinear_substeps
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 20
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(params, arrays, shape):
    if (params.dtype != torch.float32 or tuple(params.shape) != (N_PARAMS,)
            or not params.is_contiguous()):
        raise ValueError(f"params must be a contiguous float32[{N_PARAMS}] tensor")
    for q in arrays:
        if q.device != params.device:
            raise ValueError(f"EVP tensors span devices {params.device} and {q.device}")
        if q.dtype != torch.float32 or tuple(q.shape) != shape or not q.is_contiguous():
            raise ValueError(f"EVP arrays must be contiguous float32 {shape} tensors")


def tiled_curvilinear_evp_substeps(params, planes, carry, nsub, grid, plan, flags, chunk=None,
                                   settled=None):
    """Run ``nsub`` αEVP substeps of the tiled curvilinear route on arrays
    of ``grid``'s (widened) shape.  ``params``, ``planes``, ``carry`` and
    ``flags`` as :func:`tiled_curvilinear_inputs` makes them (the solid
    plane holding only 0 and 1); ``plan`` the pinned or the unpinned plan;
    ``chunk`` the substeps between fold refills (default the plan's K).  On
    a shard's grid the directions split across ranks do not wrap, the wall
    fills apply on the shards at the global edges, and a fold split across
    x is never refilled (:func:`_geometry`).  CUDA tensors go to the CUDA
    kernel (2 + refills + 3·nsub launches), which writes the results into
    the carry tensors and returns them; CPU tensors go to
    :func:`tiled_curvilinear_evp_substeps_reference`.  ``settled``: an int32
    CUDA tensor of ceil(nxp/8)·ceil(nyp/32) elements into which the kernel
    writes its settled flags (:func:`tiled_settled_blocks_reference`
    flattened), or None."""
    planes, carry = tuple(planes), tuple(carry)
    if len(planes) not in (N_PLANES, N_PLANES + 1) or len(carry) != N_CARRY:
        raise ValueError(f"expected {N_PLANES} planes (one more with f(φ)) and "
                         f"{N_CARRY} carries")
    device = params.device
    if device.type == "cpu":
        if any(q.device != device for q in planes + carry):
            raise ValueError("EVP tensors span devices")
        return tiled_curvilinear_evp_substeps_reference(params, planes, carry, nsub, grid,
                                                        plan, flags, chunk)
    if device.type != "cuda":
        raise ValueError(f"no EVP kernel for device {device}")
    _check(params, planes + carry, grid.shape)
    chunk = plan[0] if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    blocks = -(-grid.nxp // BLOCK[0]) * -(-grid.nyp // BLOCK[1])
    if settled is None:
        settled = torch.empty(blocks, dtype=torch.int32, device=device)
    elif (settled.dtype != torch.int32 or settled.device != device
          or settled.numel() != blocks or not settled.is_contiguous()):
        raise ValueError(f"settled must be a contiguous int32 tensor of {blocks} elements "
                         f"on {device}")
    immersed, has_drag = flags
    geo = _geometry(grid)
    ptrs = (ctypes.c_void_p * (N_PLANES + 1))(*[q.data_ptr() for q in planes],
                                              *([None] if len(planes) == N_PLANES else []))
    scratch = torch.empty((N_SCRATCH,) + grid.shape, dtype=torch.float32, device=device)
    work = torch.empty((N_WORK,) + grid.shape, dtype=torch.float32, device=device)
    bits = torch.empty(grid.shape, dtype=torch.uint8, device=device)
    launches = ctypes.c_int(0)
    fn = _tiled_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(params.data_ptr(), ctypes.addressof(ptrs), *[q.data_ptr() for q in carry],
                 scratch.data_ptr(), work.data_ptr(), bits.data_ptr(), settled.data_ptr(),
                 grid.nxp, grid.nyp, grid.Hx, grid.Nx, grid.Hy, grid.Ny,
                 *(int(w) for w in geo.wrap), *(int(b) for b in geo.bounded),
                 int(grid.north_fold), *geo.gates, int(geo.refill), int(immersed),
                 int(has_drag), int(nsub), chunk, ctypes.byref(launches), stream)
    if err != 0:
        raise RuntimeError(f"tiled curvilinear EVP kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('evp_tiled_curvilinear', err)})")
    tiled_curvilinear_evp_counter.calls += 1
    tiled_curvilinear_evp_counter.launches += launches.value
    return carry


# --- 2.8: the ice strength on pinned tiles -------------------------------------------------

def ice_strength_params(model):
    """float32[2]: (P★, C) of the model's rheology on its device."""
    rheo = model.dynamics.rheology
    f32 = model.grid.scalar
    return torch.stack([f32(rheo.ice_compressive_strength), f32(rheo.ice_compaction_hardening)])


def fixed_tile_P_reference(params, h, a):
    """Plain PyTorch version of the kernel: P★·h·exp(−C(1 − ℵ)) (`:1022-1024`)."""
    return params[0] * h * torch.exp(-params[1] * (1.0 - a))


def _strength_entry():
    fn = _build.load("ice_strength_fixed").csi_ice_strength_fixed
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fixed_tile_P(params, h, a):
    """The ice strength of the fixed-tile route (`_fixed_tile_P`,
    `:1027-1055`).  CUDA tensors go to the kernel (one launch), CPU tensors to
    :func:`fixed_tile_P_reference`."""
    device = h.device
    if device.type == "cpu":
        return fixed_tile_P_reference(params, h, a)
    if device.type != "cuda":
        raise ValueError(f"no ice-strength kernel for device {device}")
    for q in (params, h, a):
        if q.device != device or q.dtype != torch.float32 or not q.is_contiguous():
            raise ValueError("the ice-strength kernel takes contiguous float32 tensors on "
                             "one device")
    if tuple(params.shape) != (2,) or h.shape != a.shape:
        raise ValueError("the ice-strength kernel takes params (P★, C) and same-shape h, ℵ")
    P = torch.empty_like(h)
    fn = _strength_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(params.data_ptr(), h.data_ptr(), a.data_ptr(), P.data_ptr(), h.numel(),
                 stream)
    if err != 0:
        raise RuntimeError(f"ice-strength kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('ice_strength_fixed', err)})")
    ice_strength_counter.calls += 1
    ice_strength_counter.launches += 1
    return P


# --- the launcher ------------------------------------------------------------------------

def tiled_curvilinear_momentum_step(model, state, dt, u_start, v_start):
    """The tiled curvilinear momentum step (`tiled_curvilinear_momentum_step`,
    `:1074-1270`) under the pinned plan with ``fixed_tiles``, else the
    unpinned one: widen a serial folded grid whose y halo is below 2K+5,
    run the substep loop (:func:`tiled_curvilinear_evp_substeps`) and, with
    ``fixed_tiles``, the ice strength (:func:`fixed_tile_P`) on the widened
    arrays, crop back, and refill: u and v with the local fills (on a shard
    whose fold is split across x with one joint exchange, `:1254-1259`), σ
    with the fills, α and P with the local cc fill where widened.  Without
    ``fixed_tiles`` P is the plain ice strength on the original padding
    (`:1234-1237`).  A shard's grid is not widened: its halos are the wide
    ones of the distributed step.  Returns the general
    `split_explicit_momentum_step`'s update dict; uⁿ, vⁿ are the start
    velocities, Delta and ζ the incoming state's."""
    grid = model.grid
    solver = model.dynamics.solver
    nsub = solver.substeps
    fixed = solver.fixed_tiles
    serial_fold = grid.north_fold and grid.mesh_axes is None
    if fixed is None:
        plan = _unpinned_plan(grid, nsub, widen_fold=serial_fold)
    else:
        plan = _fixed_plan(grid, nsub, fixed, widen_fold=serial_fold)
    if plan is None:
        raise ValueError("tiled curvilinear EVP: no pinned plan fits this grid")
    K = plan[0]
    Hw = 2 * K + 5 if serial_fold and grid.Hy < 2 * K + 5 else None
    params, planes, carry, target, flags = tiled_curvilinear_inputs(model, state, dt, u_start,
                                                                    v_start, Hw)
    u, v, s11, s22, s12, alpha = tiled_curvilinear_evp_substeps(params, planes, carry, nsub,
                                                                target, plan, flags)
    if fixed is None:
        P = ice_strength(model.dynamics.rheology, state.h, state.a)
    else:
        P = fixed_tile_P(ice_strength_params(model), planes[C_H], planes[C_A])
    if Hw is not None:
        u, v = _crop(u, grid, target, "fc"), _crop(v, grid, target, "cf")
        s11, s22 = _crop(s11, grid, target, "cc"), _crop(s22, grid, target, "cc")
        s12 = _crop(s12, grid, target, "ff")
        alpha = fill_halos_cc_local(_crop(alpha, grid, target, "cc"), grid)
        if fixed is not None:
            P = fill_halos_cc_local(_crop(P, grid, target, "cc"), grid)
    if grid.north_fold and _meshed(grid, 0):
        u, v = fill_halos_uv(u, v, grid)
    else:
        u, v = fill_halos_fc_local(u, grid), fill_halos_cf_local(v, grid)
    return dict(u=u, v=v, sig11=fill_halos_cc(s11, grid), sig22=fill_halos_cc(s22, grid),
                sig12=fill_halos_ff(s12, grid), alpha=alpha, P=P, un=u_start, vn=v_start,
                Delta=state.Delta, zeta_cc=state.zeta_cc, zeta_ff=state.zeta_ff)
