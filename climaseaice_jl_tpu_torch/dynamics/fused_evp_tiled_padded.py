"""Substep-chunked tiled padded αEVP loop, the fixed-tile (decomposition-
invariant) EVP route: the gate, the launcher, the CUDA kernel's wrapper and
its plain version.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_evp_tiled_padded.py` in
its ``fixed_tiles`` mode.  The carried fields are cut to the interior; each
chunk of K substeps gathers halo-extended tiles of them (wrap along a
periodic direction, clamp along a bounded one) and of the padded constants
(true halo values, clamped beyond the padded edge), runs the padded kernel's
substeps on every tile with the velocities' wall fills gated by the tile
points' interior coordinates, and keeps the tiles' interiors.  After the
last chunk all six fields are re-padded with zeros and their halos refilled
(α's too, unlike the whole-array padded route).  A point's value depends on
nothing but the points within its domain of dependence, so the interiors do
not depend on the tile plan or K.

σ₁₂'s bounded-x halo is a clamped duplicate inside a tile where the general
path has zero there; every σ₁₂ read is masked by msk_ff, which is zero on
peripheral and halo nodes (`pallas_evp_tiled_padded.py:25-26`).

:func:`tiled_padded_evp_substeps` picks by the tensors' device: CUDA tensors
go to the kernel (``csrc/evp_tiled_padded.cu``, whose own tile plan is
chosen for the card), CPU tensors to
:func:`tiled_padded_evp_substeps_reference`, which emulates the TPU kernel's
tiles of ``fixed_tiles``.  A CUDA tensor never reaches the plain version; a
kernel that fails to build or launch raises.

On one rank's shard of the distributed step (the 'wide' halo policy) a
direction split across ranks is carried over its whole padded extent
(`pallas_evp_tiled_padded.py:496-530, 664-683`): its halo points are real
points that evolve in place, going stale from the outside in by two points
a substep.  Along it the TPU kernel ceil-tiles the padded extent,
clamp-gathers the overhang beyond the padded edge and drops it, applies no
wall fill (`:212-217`), and keeps the padded values of the split direction
when it re-pads; the plain version emulates that.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..grids import PERIODIC
from ..fields import fill_halos_cc, fill_halos_fc, fill_halos_cf, fill_halos_ff, _meshed
from .fused_evp import (KernelCounter, check_kernel_args, cuda_error_string, describe_kernel,
                        pick_chunk)
from .fused_evp_padded import (N_CONSTS, N_DRAG, N_STRESS, N_CARRY,
                               direction_kinds, padded_evp_inputs, padded_fused_available,
                               padded_loop_functions, run_substeps)

WY = 64               # y overlap of 2-D tiles (`pallas_evp_tiled_padded.py:61`)
_TX_CHOICES = (1024, 768, 512, 384, 256, 192, 128, 96, 64, 32, 16, 8)

tiled_padded_evp_counter = KernelCounter()


# --- the gate -----------------------------------------------------------------

def tiled_padded_available(model):
    """True when the model matches the tiled padded EVP configuration.

    The conditions of the JAX gate (`pallas_evp_tiled_padded.py:114-202`):
    the padded route's physics (:func:`.fused_evp_padded.
    padded_fused_available`), substeps with a chunk length
    (:func:`pick_chunk`), and with ``fixed_tiles = (TX, TY)`` Nx divisible by
    TX and Ny by TY, with TY + 128 a multiple of 128 (kept so that the same
    configurations take the route in both packages).  Without
    ``fixed_tiles`` an x tile has to divide Nx.  The TPU-only conditions
    (the VMEM budget of a tile and the device-memory cap) are dropped: the
    CUDA kernel's tiles are its own and its state lives in device memory.
    On a shard the padded route's meshed conditions apply, and a direction
    split across ranks need not be divisible by the tile (`:135-175`)."""
    if not padded_fused_available(model):
        return False
    grid = model.grid
    solver = model.dynamics.solver
    if pick_chunk(solver.substeps) is None:
        return False
    if solver.fixed_tiles is None:
        return any(grid.Nx % TX == 0 for TX in _TX_CHOICES)
    TX, TY = solver.fixed_tiles
    if grid.Nx % TX and not _meshed(grid, 0):
        return False
    return TY is None or ((grid.Ny % TY == 0 or _meshed(grid, 1))
                          and (TY + 2 * WY) % 128 == 0)


# --- the plain version ----------------------------------------------------------

def _slab_index(N, n_tiles, T, W, periodic, H=0, ext=None):
    """Tile gather indices along one direction (`pallas_evp_tiled_padded.py:
    480-493`): into the interior-cut carry, or with ``ext`` into the padded
    constants (true halo values, clamped beyond the padded edge)."""
    rows = []
    for i in range(n_tiles):
        r = np.arange(i * T - W, i * T + T + W)
        if periodic:
            rows.append(H + r % N)
        elif ext is None:
            rows.append(np.clip(r, 0, N - 1))
        else:
            rows.append(np.clip(r + H, 0, ext - 1))
    return np.concatenate(rows)


def tiled_padded_evp_substeps_reference(params, consts, carry, nsub, grid, fixed_tiles,
                                        K=None):
    """Plain PyTorch version of the kernel: ``nsub`` substeps in chunks of
    ``K`` (default :func:`pick_chunk`) on the TPU kernel's tiles of
    ``fixed_tiles = (TX, TY)`` (`pallas_evp_tiled_padded.py:496-734`), all
    tiles of a chunk as one batch.  ``carry`` holds padded arrays.  Returns
    the six fields on the padded shape as the TPU launcher re-pads them
    before its fills: zero halos along the cut directions, the carried y
    halos of y-spanning slabs and the halos of split directions kept."""
    K = pick_chunk(nsub) if K is None else K
    Hx, Nx, Hy, Ny, nyp = grid.Hx, grid.Nx, grid.Hy, grid.Ny, grid.nyp
    mx, my = _meshed(grid, 0), _meshed(grid, 1)
    periodic_x = grid.topology[0] == PERIODIC and not mx
    periodic_y = grid.topology[1] == PERIODIC and not my
    TX, TY = fixed_tiles
    x_ext = grid.nxp if mx else Nx          # the carried x extent
    n_tiles = -(-x_ext // TX)               # ceil tiles where split, else TX divides Nx
    if TY is None:
        TY, Wy, nty, y_ext = nyp, 0, 1, nyp
    else:
        y_ext = nyp if my else Ny
        Wy, nty = WY, -(-y_ext // TY)
    W = 3 * K + 3          # the fixed mode's overlap, rounded to the TPU's sublanes
    while (TX + 2 * W) % 8:
        W += 1
    bx, by = TX + 2 * W, TY + 2 * Wy
    device = params.device

    def index(a):
        return torch.as_tensor(a, device=device)

    def along(ext, n, T, Wd, H, periodic, split):
        """(carry gather, constant gather, interior coordinates) of the
        tiles along one direction: a split one carries its padded extent,
        clamp-gathered at its edge."""
        coords = np.arange(-Wd, T + Wd)[None, :] + T * np.arange(n)[:, None]
        if split:
            idx = index(_slab_index(ext, n, T, Wd, False))
            return idx, idx, index(coords - H)
        N = ext
        return (index(_slab_index(N, n, T, Wd, periodic)),
                index(_slab_index(N, n, T, Wd, periodic, H=H, ext=N + 2 * H)), index(coords))

    idx, idx_pad, gx = along(x_ext, n_tiles, TX, W, Hx, periodic_x, mx)
    if Wy:
        idy, idy_pad, gy = along(y_ext, nty, TY, Wy, Hy, periodic_y, my)
    else:
        idy = idy_pad = gy = None

    def tiles(q, ix, iy):   # (rows, cols) → (n_tiles·nty, bx, by)
        q = q[ix] if iy is None else q[ix][:, iy]
        return q.reshape(n_tiles, bx, nty, by).permute(0, 2, 1, 3).reshape(-1, bx, by)

    def untile(q):          # tile interiors → the carried layout, overhang dropped
        oy = TY if Wy else nyp
        q = q[:, W:W + TX, Wy:Wy + oy] if Wy else q[:, W:W + TX]
        q = q.reshape(n_tiles, nty, TX, oy).permute(0, 2, 1, 3).reshape(n_tiles * TX,
                                                                         nty * oy)
        return q[:x_ext, :y_ext]

    # per-tile interior coordinates, broadcast against (tiles, bx, by)
    gx_t = gx.repeat_interleave(nty, 0)[:, :, None]
    gy_t = gy.repeat(n_tiles, 1)[:, None, :] if Wy else None

    def fill_x(q, face):
        if Hx == 0 or periodic_x or mx:
            return q
        if face:
            return torch.where((gx_t < 0) | (gx_t >= Nx), 0.0, q)
        q = torch.where(gx_t < 0, q[:, W:W + 1], q)
        return torch.where(gx_t >= Nx, q[:, W + TX - 1:W + TX], q)

    def fill_y(q, face):
        if Hy == 0 or my or (Wy and periodic_y):
            return q
        if Wy:
            if face:
                return torch.where((gy_t < 0) | (gy_t >= Ny), 0.0, q)
            q = torch.where(gy_t < 0, q[:, :, Wy:Wy + 1], q)
            return torch.where(gy_t >= Ny, q[:, :, Wy + TY - 1:Wy + TY], q)
        # y-spanning slabs: the whole-array fills along the padded y
        if periodic_y:
            return torch.cat([q[:, :, Ny:Ny + Hy], q[:, :, Hy:Hy + Ny], q[:, :, Hy:2 * Hy]], 2)
        if face:
            return torch.cat([torch.zeros_like(q[:, :, :Hy]), q[:, :, Hy:Hy + Ny + 1],
                              torch.zeros_like(q[:, :, Hy + Ny + 1:])], 2)
        return torch.cat([q[:, :, Hy:Hy + 1].expand(-1, -1, Hy), q[:, :, Hy:Hy + Ny],
                          q[:, :, Hy + Ny - 1:Hy + Ny].expand(-1, -1, Hy)], 2)

    def fill_fc(q):
        return fill_y(fill_x(q, True), False)

    def fill_cf(q):
        return fill_y(fill_x(q, False), True)

    functions = padded_loop_functions(params, [tiles(q, idx_pad, idy_pad) for q in consts],
                                      fill_fc, fill_cf, ax=1)
    # the carried layout: the interior along a cut direction, the padded
    # extent along a split one or a y-spanning slab's
    keep_x = slice(None) if mx else slice(Hx, Hx + Nx)
    keep_y = slice(Hy, Hy + Ny) if Wy and not my else slice(None)
    state = [q[keep_x, keep_y] for q in carry]
    for first in range(1, nsub + 1, K):
        u, v, s11, s22, s12, al = (tiles(q, idx, idy) for q in state)
        out = run_substeps(functions, (fill_fc(u), fill_cf(v), s11, s22, s12, al),
                           first, min(K, nsub + 1 - first))
        state = [untile(q) for q in out]

    def repad(q):           # the carried layout → padded, zero where cut
        out = torch.zeros(grid.shape, dtype=q.dtype, device=q.device)
        out[keep_x, keep_y] = q
        return out

    return tuple(repad(q) for q in state)


# --- the kernel's wrapper -------------------------------------------------------

def _tiled_entry():
    lib = _build.load("evp_tiled_padded")
    fn = lib.csi_evp_tiled_padded_substeps
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (1 + N_CONSTS + N_DRAG + N_STRESS + 2 * N_CARRY)
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.csi_evp_tiled_chunk_substeps.restype = ctypes.c_int
    return fn, lib.csi_evp_tiled_chunk_substeps()


def describe():
    """The built kernel on the current card (:func:`.fused_evp.describe_kernel`)."""
    return describe_kernel(_build.load("evp_tiled_padded"), "csi_evp_tiled_padded_describe",
                           "evp_tiled_padded")


def tiled_padded_evp_substeps(params, consts, carry, nsub, grid, fixed_tiles, chunk=None):
    """Run ``nsub`` αEVP substeps on the interiors of padded arrays.

    ``params``, ``consts`` and ``carry`` as :func:`.fused_evp_padded.
    padded_evp_substeps` takes them.  CUDA tensors go to the CUDA kernel,
    which runs its own tile plan, ``chunk`` substeps a launch (at most, and
    by default, the kernel's K), writes the carry tensors' interiors (and
    their halos along a direction split across ranks) in place and returns
    them (their other halos are then undefined); CPU tensors go
    to :func:`tiled_padded_evp_substeps_reference` with the tiles of
    ``fixed_tiles`` and chunks of ``chunk`` (default :func:`pick_chunk`)."""
    consts, carry = tuple(consts), tuple(carry)
    if (len(consts) not in (N_CONSTS + N_STRESS, N_CONSTS + N_DRAG + N_STRESS)
            or len(carry) != N_CARRY):
        raise ValueError(f"expected {N_CONSTS} constants, optionally {N_DRAG} drag "
                         f"arrays, {N_STRESS} stress arrays and {N_CARRY} carries")
    device = params.device
    if device.type == "cpu":
        if any(q.device != device for q in consts + carry):
            raise ValueError("EVP tensors span devices")
        return tiled_padded_evp_substeps_reference(params, consts, carry, nsub, grid,
                                                   fixed_tiles, K=chunk)
    if device.type != "cuda":
        raise ValueError(f"no EVP kernel for device {device}")
    shape = check_kernel_args(params, consts + carry)
    if shape != grid.shape:
        raise ValueError(f"EVP arrays are {shape}, the grid's fields {grid.shape}")
    has_drag = len(consts) == N_CONSTS + N_DRAG + N_STRESS
    drag = consts[N_CONSTS:N_CONSTS + N_DRAG] if has_drag else (None,) * N_DRAG
    scratch = tuple(torch.empty_like(q) for q in carry)
    ptrs = [params.data_ptr()]
    ptrs += [q.data_ptr() for q in consts[:N_CONSTS]]
    ptrs += [None if q is None else q.data_ptr() for q in drag]
    ptrs += [q.data_ptr() for q in consts[-N_STRESS:] + carry + scratch]
    fn, kmax = _tiled_entry()
    chunk = kmax if chunk is None else min(int(chunk), kmax)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, grid.nxp, grid.nyp, grid.Hx, grid.Nx, grid.Hy, grid.Ny,
                 *direction_kinds(grid), int(has_drag), int(nsub), chunk, stream)
    if err != 0:
        raise RuntimeError(f"tiled padded EVP kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('evp_tiled_padded', err)})")
    tiled_padded_evp_counter.calls += 1
    tiled_padded_evp_counter.launches += -(-int(nsub) // chunk)
    return carry


# --- the launcher ---------------------------------------------------------------

def tiled_padded_momentum_step(model, state, dt, u_start, v_start):
    """Run the substep loop through :func:`tiled_padded_evp_substeps` on the
    inputs of :func:`.fused_evp_padded.padded_evp_inputs` (with the
    fixed-tile coefficients); returns the same update dict as the general
    `split_explicit_momentum_step`.  The six fields are re-padded with zero
    halos, and all their halos refilled, as `pallas_evp_tiled_padded.py:
    720-734` does; Delta, zeta_cc and zeta_ff stay as they were."""
    grid = model.grid
    params, consts, carry, P = padded_evp_inputs(model, state, dt, u_start, v_start)
    out = tiled_padded_evp_substeps(params, consts, carry, model.dynamics.solver.substeps,
                                    grid, model.dynamics.solver.fixed_tiles)
    if params.device.type == "cuda":
        def repad(q):
            return grid.set_interior(torch.zeros_like(q), grid.interior(q))
        out = [repad(q) for q in out]
    u, v, s11, s22, s12, alpha = out
    return dict(u=fill_halos_fc(u, grid), v=fill_halos_cf(v, grid),
                sig11=fill_halos_cc(s11, grid), sig22=fill_halos_cc(s22, grid),
                sig12=fill_halos_ff(s12, grid), alpha=fill_halos_cc(alpha, grid),
                P=P, un=u_start, vn=v_start,
                Delta=state.Delta, zeta_cc=state.zeta_cc, zeta_ff=state.zeta_ff)
