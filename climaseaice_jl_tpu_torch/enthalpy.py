"""Enthalpy-method vertical column sea-ice model.

Counterpart of `climaseaice_jl_tpu/enthalpy.py`: a standalone 1-D(z) model
with prognostic enthalpy H, diagnostic temperature T = H/c, phase mask ϕ,
phase-dependent molecular diffusivity κ = κ_ice (1 − ϕ) + κ_water ϕ, and
tendency ∂t H = ∂z(κ ∂z T), stepped with forward Euler.  Fields have the
shape ``columns + (Nz + 2,)``: one halo cell at each end of the last axis,
any leading (x, y) batch of independent columns.

The reference behaviours of the JAX package are kept:

* ϕ = 1 where T < 0 (`EnthalpyMethodSeaIceModel.jl:120-130`);
* T = H/c without the ℒϕ term (`:132-144`);
* Dirichlet ghost cells 2·T_bc − T₁, zero gradient otherwise;
* the face fluxes by a last-axis ``roll``;
* a prescribed flux overrides the tendency G at cells 1 and Nz.

A boundary value given as ``f(t)`` receives the clock's 0-d time tensor
and returns a tensor or a number; an initial profile ``T(z)`` receives the
cell centres :meth:`ZGrid.zc` as a float64 tensor on the grid's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import frozen_dataclass, resolve_device, torch_dtype
from .state import Clock

REFERENCE_DENSITY = 999.8  # kg m⁻³ (`EnthalpyMethodSeaIceModel.jl:38`)


@frozen_dataclass
class ZGrid:
    """Uniform 1-D vertical grid with one halo cell per side.  Cell centres
    at z0 + (k+1/2)Δz, k = 0..Nz-1 (k = 0 is the bottom).  ``device=None``
    means the CUDA card and raises where there is none."""
    Nz: int = None
    dtype: object = "float64"
    z0: object = -1.0
    z1: object = 0.0
    device: object = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def dz(self):
        return (self.z1 - self.z0) / self.Nz

    @property
    def shape(self):
        return (self.Nz + 2,)

    def interior(self, q):
        return q[..., 1:self.Nz + 1]

    def zc(self):
        """Cell centres, computed in float64 as the JAX package computes
        them (numpy), on the grid's device."""
        k = np.arange(self.Nz)
        return torch.as_tensor(self.z0 + (k + 0.5) * self.dz, device=self.device)


@frozen_dataclass
class MolecularDiffusivity:
    kappa_ice: object = 1e-5
    kappa_water: object = 1e-6


@frozen_dataclass
class ValueBoundaryCondition:
    """Dirichlet temperature at a z-face; ``value`` is a number or ``f(t)``."""
    value: object = 0.0

    def at(self, t):
        if callable(self.value):
            return self.value(t)
        return self.value


@frozen_dataclass
class FluxBoundaryCondition:
    """Prescribed diffusive flux through a z-face (number or ``f(t)``)."""
    value: object = 0.0

    def at(self, t):
        if callable(self.value):
            return self.value(t)
        return self.value


@frozen_dataclass
class EnthalpyMethodSeaIceModel:
    grid: ZGrid = None
    closure: MolecularDiffusivity = None
    ice_heat_capacity: object = 2090.0 / REFERENCE_DENSITY
    water_heat_capacity: object = 3991.0 / REFERENCE_DENSITY
    fusion_enthalpy: object = 3.3e5 / REFERENCE_DENSITY
    top_T_bc: object = None     # Value/Flux BC at z = z1
    bottom_T_bc: object = None  # Value/Flux BC at z = z0

    def __post_init__(self):
        if self.closure is None:
            object.__setattr__(self, "closure", MolecularDiffusivity())


@frozen_dataclass
class EnthalpyState:
    H: object = None     # enthalpy (padded, Nz+2)
    T: object = None     # temperature diagnostic
    phi: object = None   # phase mask
    kappa: object = None
    clock: Clock = None


def initial_state(model: EnthalpyMethodSeaIceModel, T=None, H=None, time=0.0,
                  columns=()):
    """``set!(model; T=...)`` or ``set!(model; H=...)`` (`:80-98`).
    ``columns``: optional leading (x, y) batch shape of independent
    columns."""
    grid = model.grid
    z = torch.zeros(tuple(columns) + grid.shape, dtype=grid.dtype, device=grid.device)
    if T is not None and H is not None:
        raise ValueError("cannot set both temperature and enthalpy")
    state = EnthalpyState(H=z, T=z, phi=z, kappa=z,
                          clock=Clock(time=torch.full((), time, dtype=grid.dtype,
                                                      device=grid.device),
                                      iteration=torch.zeros((), dtype=torch.int32,
                                                            device=grid.device)))
    if T is not None:
        # H = cT + ℒϕ with T kept as set; the first step recomputes T = H/c
        # (the reference's behaviour, consistent for T ≥ 0 where ϕ = 0)
        Tv = _set_interior(grid, z, T)
        Tv = _apply_T_bcs(model, Tv, state.clock.time)
        phi = _porosity(Tv)
        kappa = (model.closure.kappa_ice * (1 - phi)
                 + model.closure.kappa_water * phi)
        H = model.ice_heat_capacity * Tv + model.fusion_enthalpy * phi
        return state.evolve(T=Tv, H=H, phi=phi, kappa=kappa)
    if H is not None:
        state = state.evolve(H=_set_interior(grid, z, H))
    return update_state(model, state)


def _set_interior(grid, q, values):
    if callable(values):
        values = values(grid.zc())
    values = torch.as_tensor(values, dtype=q.dtype, device=grid.device)
    q = q.clone()
    q[..., 1:grid.Nz + 1] = values
    return q


def _porosity(T):
    # ϕ = 1 where T < Tₘ (= 0 °C), the reference's behaviour (`:120-130`)
    return (T < 0).to(T.dtype)


def _face_value(value, like):
    """A boundary value (number or tensor) as a tensor of ``like``'s dtype
    on its device; a number is written there without a host copy."""
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype)
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _apply_T_bcs(model, T, t):
    """Ghost cells imposing Dirichlet face values (or zero gradient),
    written into ``T`` (a tensor of the caller's own)."""
    Nz = model.grid.Nz
    bot, top = model.bottom_T_bc, model.top_T_bc
    if isinstance(bot, ValueBoundaryCondition):
        T[..., 0] = 2 * _face_value(bot.at(t), T) - T[..., 1]
    else:
        T[..., 0] = T[..., 1]
    if isinstance(top, ValueBoundaryCondition):
        T[..., Nz + 1] = 2 * _face_value(top.at(t), T) - T[..., Nz]
    else:
        T[..., Nz + 1] = T[..., Nz]
    return T


def update_state(model, state):
    """T = H/c, ϕ(T), κ(ϕ), the boundary ghost cells (`:161-166`)."""
    c = model.ice_heat_capacity
    T = state.H / c
    T = _apply_T_bcs(model, T, state.clock.time)
    phi = _porosity(T)
    kappa = model.closure.kappa_ice * (1 - phi) + model.closure.kappa_water * phi
    return state.evolve(T=T, phi=phi, kappa=kappa)


def step(model, state, dt):
    """∂t H = ∂z(κ ∂z T), forward Euler (`:168-201`)."""
    grid = model.grid
    Nz, dz = grid.Nz, grid.dz
    T, kappa = state.T, state.kappa

    # diffusive flux at z-faces k-1/2 for k = 1..Nz+1: κ̄ (T[k] − T[k−1]) / Δz
    kappa_face = 0.5 * (kappa + torch.roll(kappa, 1, -1))
    grad = (T - torch.roll(T, 1, -1)) / dz
    flux = kappa_face * grad  # flux[k] at the face below cell k

    G = (torch.roll(flux, -1, -1) - flux) / dz

    # prescribed-flux BCs override the face flux at the boundaries
    t = state.clock.time
    if isinstance(model.bottom_T_bc, FluxBoundaryCondition):
        G[..., 1] = (flux[..., 2] - _face_value(model.bottom_T_bc.at(t), flux)) / dz
    if isinstance(model.top_T_bc, FluxBoundaryCondition):
        G[..., Nz] = (_face_value(model.top_T_bc.at(t), flux) - flux[..., Nz]) / dz

    H = state.H.clone()
    H[..., 1:Nz + 1] += dt * G[..., 1:Nz + 1]
    state = state.evolve(H=H, clock=Clock(time=state.clock.time + dt,
                                          iteration=state.clock.iteration + 1))
    return update_state(model, state)

