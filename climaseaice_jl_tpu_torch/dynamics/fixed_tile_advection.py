"""Fixed-tile tracer advection, the decomposition-invariant ∇·(U c): the
gate, :func:`make_fixed_tile_div`, the CUDA kernel's wrapper and its plain
version; and the whole-grid route, which runs the same kernel for a model
without ``fixed_tiles`` (:func:`whole_grid_advection_available`,
:func:`make_whole_grid_div`).

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_advection.py`.  The TPU
kernel (``_adv_kernel``) runs the flux-form reconstruction of
:mod:`..advection` on (TX+16, TY+128) tiles of the padded arrays, gathered
with wrap into the interior along a periodic direction and clamp at the
padded edge along a bounded one; every output reads its stencil within the
overlap, so a point's neighbour at offset k is the gathered image of its
padded index + k.  Both versions here take those images: the kernel
(``csrc/advection_fixed.cu``, one launch per tracer) and the plain version,
which gathers the images into arrays extended by 8 points on each side and
runs the general path's reconstructions on them.  The kernel has two
entries, chosen by :func:`kernel_for`: the tile kernel, compiled for each
scheme of :data:`TILE_SCHEMES` used in both directions, which loads a tile of
c widened by the stencil radius into shared memory and computes each face
once; and the runtime-scheme kernel, one thread per padded point, for a
FluxFormAdvection whose x and y schemes differ.  On one rank's shard of the
distributed step a direction split across ranks does not wrap
(`pallas_advection.py:217-218`): its halos hold the neighbouring ranks'
values, and the images clamp.

Schemes: WENO 5/7/9, UpwindBiased 1/3/5/7, Centered 2/4, and
FluxFormAdvection with separate x and y schemes.  Fluxes through peripheral
faces are zeroed.  On uniform grids the divergence is δx(u ĉ)·(1/Δx) +
δy(v ĉ)·(1/Δy); with array metrics [δx(Δy_fc u ĉ) + δy(Δx_cf v ĉ)]/Az_cc, the
general path's order (`pallas_advection.py:169-185`).  Interiors equal the
general path's values up to that reordering; in the halos the outputs come
from the clamped or wrapped images instead of the general path's circular
shifts over the padded extent, and the step refills them anyway.

The whole-grid route passes Δy_fc, Δx_cf and Az_cc on every grid: as 0-d
tensors on uniform grids (the kernel's third metric mode), so that its
interiors are bitwise those of :func:`..advection.horizontal_div_Uc`.

A CUDA tensor goes to the kernel, a CPU tensor to
:func:`fixed_tile_div_reference`; a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..grids import PERIODIC
from ..fields import _meshed
from ..advection import (WENO, UpwindBiased, Centered, FluxFormAdvection, required_halo,
                         reconstruct_face, _upwind_select, _weno_tables_cached)
from .fused_evp import KernelCounter, cuda_error_string

_EXT = 8   # points by which the plain version extends its image arrays
_KINDS = {Centered: 0, UpwindBiased: 1, WENO: 2}
# the schemes the tile kernel is compiled for, each in both directions
# (csrc/advection_fixed.cu's CSI_TILE_SCHEMES)
TILE_SCHEMES = ((WENO, 5), (WENO, 7), (WENO, 9), (UpwindBiased, 1), (UpwindBiased, 3),
                (UpwindBiased, 5), (UpwindBiased, 7), (Centered, 2), (Centered, 4))
TILE_ENTRY, RUNTIME_ENTRY = "csi_fixed_tile_div_tiles", "csi_fixed_tile_div"

fixed_tile_advection_counter = KernelCounter()        # both entries, fixed-tile route
whole_grid_advection_counter = KernelCounter()        # both entries, whole-grid route
fixed_tile_advection_runtime_counter = KernelCounter()  # the runtime-scheme entry's, both routes


def _schemes(adv):
    return (adv.x, adv.y) if isinstance(adv, FluxFormAdvection) else (adv, adv)


def _fixed_tiles(model):
    return getattr(getattr(model.dynamics, "solver", None), "fixed_tiles", None)


def _kernel_computes(model):
    """True when the kernel computes the model's tracer advection: a float32
    grid, each direction's scheme one of :data:`TILE_SCHEMES` (a
    FluxFormAdvection of two different ones takes the runtime-scheme
    entry), and halos at least the stencil radius."""
    grid = model.grid
    adv = model.advection
    return (adv is not None and grid.dtype == torch.float32
            and all((type(s), getattr(s, "order", None)) in TILE_SCHEMES for s in _schemes(adv))
            and min(grid.Hx, grid.Hy) >= required_halo(adv))


def fixed_tile_advection_available(model):
    """True when tracer advection takes the kernel on the fixed-tile route
    (`pallas_advection.py:50-79`): ``fixed_tiles`` set, with TX a multiple
    of 8 and TY of 128, and :func:`_kernel_computes`."""
    fixed = _fixed_tiles(model)
    return (fixed is not None and fixed[1] is not None and fixed[0] % 8 == 0
            and fixed[1] % 128 == 0 and _kernel_computes(model))


def whole_grid_advection_available(model):
    """True when tracer advection takes the kernel on the whole-grid route:
    no ``fixed_tiles``, a grid on a CUDA device that is not a shard (on a
    shard a split direction clamps where the general path reads the
    exchanged halo), and :func:`_kernel_computes`.  Everything else,
    including CPU and float64 models, keeps the general path."""
    grid = model.grid
    return (_fixed_tiles(model) is None and grid.device.type == "cuda"
            and grid.mesh_axes is None and _kernel_computes(model))


def _check_scheme(s):
    if isinstance(s, UpwindBiased) and s.order not in (1, 3, 5, 7):
        raise ValueError(f"unsupported UpwindBiased order {s.order} in the fixed-tile "
                         "advection (`pallas_advection.py:89-115`)")
    if isinstance(s, Centered) and s.order not in (2, 4):
        raise ValueError(f"unsupported Centered order {s.order}")
    if isinstance(s, WENO) and s.order not in (5, 7, 9):
        raise ValueError(f"unsupported WENO order {s.order}")


def _wraps(grid, dim):
    """True where direction ``dim`` is periodic and not split across ranks."""
    return grid.topology[dim] == PERIODIC and not _meshed(grid, dim)


def _images(ext, n_int, H, wrap, device):
    """Padded images of padded indices −_EXT … ext + _EXT − 1: wrap into the
    interior where the direction wraps, clamp at the padded edge otherwise
    (`_tile_indices`)."""
    k = torch.arange(-_EXT, ext + _EXT, device=device)
    return H + torch.remainder(k - H, n_int) if wrap else torch.clamp(k, 0, ext - 1)


def _array_metrics(grid):
    return any(getattr(m, "dim", lambda: np.ndim(m))() != 0 for m in (grid.dx_cc, grid.dy_cc))


def fixed_tile_div_reference(grid, schemes, u, v, c, masks, metrics):
    """Plain PyTorch version of the kernel: ∇·(U c) on the padded shape.
    ``masks``: (peripheral_fc, peripheral_cf) booleans; ``metrics``: (Δy_fc,
    Δx_cf, Az_cc), padded arrays on grids with array metrics or 0-d tensors
    (the whole-grid route's uniform grids), else the 0-d (1/Δx, 1/Δy)."""
    sx, sy = schemes
    for s in schemes:
        _check_scheme(s)
    ex = _images(grid.nxp, grid.Nx, grid.Hx, _wraps(grid, 0), c.device)
    ey = _images(grid.nyp, grid.Ny, grid.Hy, _wraps(grid, 1), c.device)

    def ext(q):
        return q[ex][:, ey]

    ue, ve, ce = ext(u), ext(v), ext(c)
    lx, rx = reconstruct_face(sx, ce, 0)
    cx = _upwind_select(ue, lx, rx)
    ly, ry = reconstruct_face(sy, ce, 1)
    cy = _upwind_select(ve, ly, ry)
    arr = len(metrics) == 3
    if arr:
        dy_fc, dx_cf, az_cc = (m if m.dim() == 0 else ext(m) for m in metrics)
        fx = dy_fc * ue * cx
        fy = dx_cf * ve * cy
    else:
        fx = ue * cx
        fy = ve * cy
    fx = torch.where(ext(masks[0]), 0.0, fx)
    fy = torch.where(ext(masks[1]), 0.0, fy)
    dfx = torch.roll(fx, -1, 0) - fx
    dfy = torch.roll(fy, -1, 1) - fy
    if arr:
        div = (dfx + dfy) / az_cc
    else:
        inv_dx, inv_dy = metrics
        div = dfx * inv_dx + dfy * inv_dy
    return div[_EXT:_EXT + grid.nxp, _EXT:_EXT + grid.nyp]


# --- the kernel's wrapper -------------------------------------------------------

def kernel_for(sx, sy):
    """The C entry that computes ∇·(U c) with x scheme ``sx`` and y scheme
    ``sy``: the tile kernel where both are the same scheme of
    :data:`TILE_SCHEMES`, else the runtime-scheme kernel."""
    for s in (sx, sy):
        _check_scheme(s)
    same = (type(sx), sx.order) == (type(sy), sy.order)
    return TILE_ENTRY if same and (type(sx), sx.order) in TILE_SCHEMES else RUNTIME_ENTRY


_tables: dict = {}


def _scheme_table(scheme, device):
    """(kind, order, float32 table on ``device``, the same table as a host
    array) of a scheme for the kernel: WENO's ε, C[r][r], G[r] and
    B[r][r][r], each rounded to float32 as the plain version's Python
    floats are where they meet a float32 tensor.  The tile kernel adds every
    smoothness term, so a table with a zero B coefficient (a term the plain
    version skips) is refused."""
    _check_scheme(scheme)
    key = (type(scheme), scheme.order, getattr(scheme, "epsilon", None), str(device))
    if key not in _tables:
        values = [0.0]
        if isinstance(scheme, WENO):
            C, G, B = _weno_tables_cached((scheme.order + 1) // 2)
            if any(x == 0.0 for Bk in B for row in Bk for x in row):
                raise ValueError(f"WENO({scheme.order}) has a zero smoothness coefficient")
            values = ([scheme.epsilon] + [x for row in C for x in row] + list(G)
                      + [x for Bk in B for row in Bk for x in row])
        table = torch.tensor(values, dtype=torch.float32)
        _tables[key] = (_KINDS[type(scheme)], scheme.order, table.to(device),
                        (ctypes.c_float * len(values))(*table.tolist()))
    return _tables[key]


def _div_entry(name):
    fn = getattr(_build.load("advection_fixed"), name)
    if fn.argtypes is None:
        tables = ([ctypes.c_void_p, ctypes.c_int] * 2 if name == TILE_ENTRY
                  else [ctypes.c_void_p] * 2)
        fn.argtypes = ([ctypes.c_void_p] * 10 + tables + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fixed_tile_div(grid, schemes, u, v, c, masks, metrics,
                   counter=fixed_tile_advection_counter):
    """∇·(U c) of tracer ``c`` on ``grid``'s padded shape (arguments as
    :func:`fixed_tile_div_reference` takes them).  CUDA tensors go to the
    kernel that :func:`kernel_for` names, one launch, counted in
    ``counter``; CPU tensors to the plain version."""
    device = c.device
    if device.type == "cpu":
        return fixed_tile_div_reference(grid, schemes, u, v, c, masks, metrics)
    if device.type != "cuda":
        raise ValueError(f"no advection kernel for device {device}")
    arr = len(metrics) == 3
    m0 = arr and all(m.dim() == 0 for m in metrics)
    fields = (u, v, c) + (tuple(metrics) if arr and not m0 else ())
    for q in fields:
        if (q.device != device or q.dtype != torch.float32 or tuple(q.shape) != grid.shape
                or not q.is_contiguous()):
            raise ValueError(f"advection arrays must be contiguous float32 {grid.shape} "
                             f"tensors on {device}")
    if (not arr or m0) and any(m.device != device or m.dtype != torch.float32
                               for m in metrics):
        raise ValueError(f"0-d metrics must be float32 tensors on {device}")
    if not arr and any(m.dim() != 0 for m in metrics):
        raise ValueError("1/Δx and 1/Δy must be 0-d tensors")
    for m in masks:
        if m.device != device or m.dtype != torch.bool or tuple(m.shape) != grid.shape \
                or not m.is_contiguous():
            raise ValueError(f"advection masks must be contiguous bool {grid.shape} tensors")
    entry = kernel_for(*schemes)
    (kx, ox, tx, hx), (ky, oy, ty, hy) = (_scheme_table(s, device) for s in schemes)
    out = torch.empty(grid.shape, dtype=torch.float32, device=device)
    ptrs = [u.data_ptr(), v.data_ptr(), c.data_ptr(), masks[0].data_ptr(),
            masks[1].data_ptr()]
    ptrs += ([m.data_ptr() for m in metrics] + [None] * 2 if arr
             else [None] * 3 + [m.data_ptr() for m in metrics])
    if entry == TILE_ENTRY:
        tables = [ctypes.addressof(hx), len(hx), ctypes.addressof(hy), len(hy)]
    else:
        tables = [tx.data_ptr(), ty.data_ptr()]
    fn = _div_entry(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *tables, kx, ox, ky, oy, out.data_ptr(), grid.nxp, grid.nyp, grid.Hx,
                 grid.Nx, grid.Hy, grid.Ny, int(_wraps(grid, 0)), int(_wraps(grid, 1)), int(m0),
                 stream)
    if err != 0:
        raise RuntimeError(f"fixed-tile advection kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('advection_fixed', err)})")
    counter.calls += 1
    counter.launches += 1
    if entry == RUNTIME_ENTRY:
        fixed_tile_advection_runtime_counter.calls += 1
        fixed_tile_advection_runtime_counter.launches += 1
    return out


def _face_metrics(grid):
    """(Δy_fc, Δx_cf, Az_cc) as the kernel takes them: padded arrays where
    any of them is one, else the three 0-d tensors."""
    metrics = tuple(grid.scalar(getattr(grid, name)) for name in ("dy_fc", "dx_cf", "az_cc"))
    if all(m.dim() == 0 for m in metrics):
        return metrics
    return tuple(m.expand(grid.shape).contiguous() for m in metrics)


def _make_div(model, u, v, metrics, counter):
    grid = model.grid
    schemes = _schemes(model.advection)
    masks = tuple(m.contiguous() for m in (model.masks.per_fc, model.masks.per_cf))
    u, v = u.contiguous(), v.contiguous()

    def div(c):
        return fixed_tile_div(grid, schemes, u, v, c.contiguous(), masks, metrics, counter)

    return div


def make_fixed_tile_div(model, u, v):
    """``div(c) -> ∇·(U c)`` on the fixed-tile route
    (`pallas_advection.py:194-265`); the velocities, masks and metrics are
    shared by every tracer's call."""
    grid = model.grid
    if _array_metrics(grid):
        metrics = _face_metrics(grid)
    else:
        metrics = (1.0 / grid.scalar(grid.dx_cc), 1.0 / grid.scalar(grid.dy_cc))
    return _make_div(model, u, v, metrics, fixed_tile_advection_counter)


def make_whole_grid_div(model, u, v):
    """``div(c) -> ∇·(U c)`` on the whole-grid route, where
    :func:`whole_grid_advection_available` holds: one launch of the kernel
    per tracer, in :func:`..advection.horizontal_div_Uc`'s operation order,
    so every interior point has its bits.  Halo points hold the images' values
    instead of the circular shifts', and the step refills them; on rows of
    land every face is peripheral and the divergence is exactly 0, so no
    crop is needed."""
    return _make_div(model, u, v, _face_metrics(model.grid), whole_grid_advection_counter)
