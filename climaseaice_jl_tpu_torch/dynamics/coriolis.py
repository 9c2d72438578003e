"""Coriolis terms: f-plane and latitude-dependent f.

Counterpart of `climaseaice_jl_tpu/dynamics/coriolis.py` for ``FPlane`` and
``LatitudeCoriolis``: ``x_f_cross_U`` at (f,c) and ``y_f_cross_U`` at (c,f)
with 4-point C-grid averages of the transverse velocity.  ``BetaPlane``
belongs to a later slice (queue 7).
"""

from __future__ import annotations

import math

import torch

from ..utils import frozen_dataclass
from ..ops import ixf, iyf, ixy_fc_of_cf, ixy_cf_of_fc


@frozen_dataclass
class FPlane:
    f: object = 1e-4  # s⁻¹


EARTH_ROTATION_RATE = 7.292115e-5  # rad s⁻¹


@frozen_dataclass
class LatitudeCoriolis:
    """f = 2Ω sin(φ) from the grid's cell-centre latitudes (``lat_cc``),
    interpolated to the (f,c)/(c,f) velocity points with ℑx/ℑy."""
    rotation_rate: object = EARTH_ROTATION_RATE


def coriolis_f_cc(coriolis, grid):
    """f at cell centres (padded; halos follow the grid's ``lat_cc``)."""
    if grid.lat_cc is None:
        raise ValueError("LatitudeCoriolis needs a grid with stored lat_cc")
    lat = grid.lat_cc.broadcast_to(grid.shape)
    return (2.0 * coriolis.rotation_rate
            * torch.sin(lat * (math.pi / 180.0))).to(grid.dtype)


def _f(coriolis):
    if isinstance(coriolis, FPlane):
        return coriolis.f
    raise NotImplementedError(f"{type(coriolis).__name__} is not ported yet; "
                              "FPlane and LatitudeCoriolis are (BetaPlane: queue 7)")


def x_f_cross_U(coriolis, grid, u, v):
    """(f ẑ × U)·x̂ at (f,c): −f · v̄ (the tendency subtracts this)."""
    if coriolis is None:
        return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    if isinstance(coriolis, LatitudeCoriolis):
        return -ixf(coriolis_f_cc(coriolis, grid)) * ixy_fc_of_cf(v)
    return -_f(coriolis) * ixy_fc_of_cf(v)


def y_f_cross_U(coriolis, grid, u, v):
    """(f ẑ × U)·ŷ at (c,f): +f · ū."""
    if coriolis is None:
        return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    if isinstance(coriolis, LatitudeCoriolis):
        return iyf(coriolis_f_cc(coriolis, grid)) * ixy_cf_of_fc(u)
    return _f(coriolis) * ixy_cf_of_fc(u)
