"""External (atmosphere / ocean) momentum stresses.

Counterpart of `climaseaice_jl_tpu/dynamics/stresses.py`.  Each stress
exposes an explicit part ``explicit_tau_{x,y}`` and an implicit coefficient
``implicit_tau_{x,y}_coefficient`` for the semi-implicit update
``u = (u⁻ + Δt G)/(1 + Δt τᵢ)``.

A stress ingredient is ``None``, a scalar, a padded array or tensor, a
:class:`StressFunction`, a dict ``{"u": ..., "v": ...}`` of those, or a
:class:`SemiImplicitStress` whose ``ue``/``ve`` are any of those.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import frozen_dataclass
from ..ops import ixy_fc_of_cf, ixy_cf_of_fc
from ..fields import _maybe_fold


@frozen_dataclass
class StressFunction:
    """A time-dependent stress ``func(grid, clock, fields[, parameters])``
    returning a tensor of the grid's padded shape (or one that broadcasts to
    it), evaluated on the grid device from ``clock.time`` inside the step."""
    func: object = None
    parameters: object = None


@frozen_dataclass
class SemiImplicitStress:
    """τ = ρₑ Cᴰ |Δuⁿ| (uₑ − uⁿ⁺¹): quadratic drag, semi-implicit in uᵢ.
    ``ue``/``ve`` are the external velocities at (f,c)/(c,f): scalars or
    padded arrays with filled halos."""
    ue: object = 0.0
    ve: object = 0.0
    rho_e: object = 1026.0
    Cd: object = 5.5e-3


def _component(stress, comp):
    if isinstance(stress, dict):
        return stress.get(comp)
    return stress


def _value(x, grid, clock, fields):
    """Resolve a stress ingredient to a value on the grid device."""
    if isinstance(x, StressFunction):
        if x.parameters is None:
            return x.func(grid, clock, fields)
        return x.func(grid, clock, fields, x.parameters)
    if isinstance(x, torch.Tensor):
        return x.to(dtype=grid.dtype, device=grid.device)
    if hasattr(x, "shape"):
        return torch.as_tensor(x, dtype=grid.dtype, device=grid.device)
    return grid.scalar(x)


def _vec_value(x, grid, clock, fields, comp):
    """Resolve a vector-component ingredient (a τ component or an external
    velocity).  On a north-folded grid its north halo carries the Zipper
    sign flip, as the reference's stress Fields do, so that stencils across
    the seam see the mirrored, sign-flipped component."""
    v = _value(x, grid, clock, fields)
    if grid.north_fold and grid.Hy > 0:
        xface = comp == "u"
        v = _maybe_fold(v.broadcast_to(grid.shape), grid, xface, not xface, -1.0)
    return v


def _full(x, grid):
    return x.broadcast_to(grid.shape)


def _drag_speed_x(grid, stress, clock, fields):
    """(|Δu| at (f,c), uₑ) of a SemiImplicitStress."""
    ue = _vec_value(stress.ue, grid, clock, fields, "u")
    ve = _vec_value(stress.ve, grid, clock, fields, "v")
    du = ue - fields.u
    dv = ixy_fc_of_cf(_full(ve, grid)) - ixy_fc_of_cf(fields.v)
    return torch.sqrt(du ** 2 + dv ** 2), ue


def _drag_speed_y(grid, stress, clock, fields):
    """(|Δu| at (c,f), vₑ) of a SemiImplicitStress."""
    ue = _vec_value(stress.ue, grid, clock, fields, "u")
    ve = _vec_value(stress.ve, grid, clock, fields, "v")
    dv = ve - fields.v
    du = ixy_cf_of_fc(_full(ue, grid)) - ixy_cf_of_fc(fields.u)
    return torch.sqrt(du ** 2 + dv ** 2), ve


def explicit_tau_x(grid, stress, clock, fields):
    stress = _component(stress, "u")
    if stress is None:
        return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    if isinstance(stress, SemiImplicitStress):
        speed, ue = _drag_speed_x(grid, stress, clock, fields)
        return stress.rho_e * stress.Cd * speed * ue
    return _vec_value(stress, grid, clock, fields, "u")


def explicit_tau_y(grid, stress, clock, fields):
    stress = _component(stress, "v")
    if stress is None:
        return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    if isinstance(stress, SemiImplicitStress):
        speed, ve = _drag_speed_y(grid, stress, clock, fields)
        return stress.rho_e * stress.Cd * speed * ve
    return _vec_value(stress, grid, clock, fields, "v")


def implicit_tau_x_coefficient(grid, stress, clock, fields):
    stress = _component(stress, "u")
    if isinstance(stress, SemiImplicitStress):
        speed, _ = _drag_speed_x(grid, stress, clock, fields)
        return stress.rho_e * stress.Cd * speed
    return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)


def implicit_tau_y_coefficient(grid, stress, clock, fields):
    stress = _component(stress, "v")
    if isinstance(stress, SemiImplicitStress):
        speed, _ = _drag_speed_y(grid, stress, clock, fields)
        return stress.rho_e * stress.Cd * speed
    return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)


def place_stress(stress, grid):
    """``stress`` with every array-valued ingredient (a numpy array, or a
    tensor of another dtype or device) turned into a tensor of the grid's
    dtype on the grid device, once, so that the step never copies it from
    the host.  Scalars and StressFunctions stay as they are."""
    def place(x):
        if isinstance(x, torch.Tensor) or hasattr(x, "shape"):
            return torch.as_tensor(x, dtype=grid.dtype, device=grid.device)
        return x

    if isinstance(stress, dict):
        return {k: place(x) for k, x in stress.items()}
    if isinstance(stress, SemiImplicitStress):
        return dataclasses.replace(stress, ue=place(stress.ue), ve=place(stress.ve))
    return place(stress)
