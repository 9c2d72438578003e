"""Diffusive ice column: the 1-D vertical enthalpy-method model under
time-varying Dirichlet temperatures (`examples/diffusive_ice_column_model.py`
in the port): 20 cells over 1 m, a daily oscillating and cooling top
temperature, a linearly cooling bottom temperature.

The boundary callables receive the clock's 0-d time tensor on the grid's
device; the run reads nothing back from the device until it ends.
"""

import math

import numpy as np
import torch

from climaseaice_jl_tpu_torch import enthalpy as em

minute, day = 60.0, 86400.0


def air_ice_temperature(t):
    return -0.5 / day * t + 5 * torch.sin(2 * math.pi * t / day) + (-5.0)


def ice_ocean_temperature(t):
    return -0.1 / day * t + 1.1


def build(device=None):
    grid = em.ZGrid(Nz=20, z0=-1.0, z1=0.0, device=device)
    closure = em.MolecularDiffusivity(kappa_ice=1e-5, kappa_water=1e-6)
    model = em.EnthalpyMethodSeaIceModel(
        grid=grid, closure=closure,
        top_T_bc=em.ValueBoundaryCondition(air_ice_temperature),
        bottom_T_bc=em.ValueBoundaryCondition(ice_ocean_temperature))
    state = em.initial_state(model, T=lambda z: 1.1 + 0.0 * z)
    return model, state


def run(model, state, dt=100.0, nsteps=int(10 * day / 100.0), every=216):
    """``nsteps`` steps of ``dt``; the time and interior temperature after
    every step n with n % every == 0 (n from 0), as numpy arrays."""
    times, profiles = [], []
    for n in range(nsteps):
        state = em.step(model, state, dt)
        if n % every == 0:
            times.append(state.clock.time)
            profiles.append(model.grid.interior(state.T).clone())
    return state, torch.stack(times).cpu().numpy(), torch.stack(profiles).cpu().numpy()


def main(device=None):
    model, state = build(device)
    # κ Δt/Δz² ≤ 0.4: explicit-Euler diffusion stability
    _, times, T = run(model, state)
    np.savez("diffusive_ice_column.npz", t=times, T=T, z=model.grid.zc().cpu().numpy())
    frozen = (T[-1] < 0).sum()
    print(f"final: {frozen}/{model.grid.Nz} cells below freezing; "
          f"T_top = {T[-1, -1]:.2f} °C, T_bottom = {T[-1, 0]:.2f} °C")
    return times, T


if __name__ == "__main__":
    main()
