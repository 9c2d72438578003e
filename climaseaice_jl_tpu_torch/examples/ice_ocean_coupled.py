"""Coupled ice-ocean seasonal demo (`examples/ice_ocean_coupled.py` in the
port): a slab mixed-layer ocean under seasonal insolation grows and melts
ice through frazil formation, basal melt and brine rejection.

The seasonal insolation is formed on the device from the clock each step,
and the records stay there until the run ends.
"""

import math

import numpy as np
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import coupled as cp

day, year = 86400.0, 360 * 86400.0


def build(device=None):
    grid = cst.RectilinearGrid(size=(8, 8), device=device)
    ice = cst.sea_ice_model(grid, top_heat_flux=(cst.RadiativeEmission(),),
                            bottom_heat_flux=0.0, ice_salinity=5.0,
                            timestepper="ForwardEuler")
    ocean = cp.SlabOcean(mixed_layer_depth=30.0,
                         temperature_restoring_rate=1.0 / (30 * day),
                         temperature_restoring_target=-1.0)
    iom = cp.IceOceanModel(ice=ice, ocean=ocean)
    state = cp.initial_state(iom, T_ocean=-2.5, S_ocean=30.0)
    return iom, state


def insolation(t):
    """Seasonal insolation over open water (W m⁻², negative = heating):
    summer heating, none in winter."""
    return -150.0 * torch.clamp(torch.sin(2 * math.pi * t / year), min=0.0)


def run(iom, state, nsteps, dt=6 * 3600.0, every=40):
    """``nsteps`` coupled steps of ``dt``; after every step k with
    k % every == 0, a record (t at the step's start in days, mean h, mean
    SST, mean salinity), as a numpy array of shape (records, 4)."""
    g = iom.ice.grid
    series = []
    for k in range(nsteps):
        t = state.clock.time
        iom = iom.evolve(ocean=iom.ocean.evolve(solar_insolation=insolation(t)))
        state = cp.coupled_step(iom, state, dt)
        if k % every == 0:
            series.append(torch.stack((t / day, g.interior(state.ice.h).mean(),
                                       g.interior(state.T_ocean).mean(),
                                       g.interior(state.S_ocean).mean())))
    return state, torch.stack(series).cpu().numpy()


def main(years=2.0, device=None):
    iom, state = build(device)
    dt = 6 * 3600.0
    _, series = run(iom, state, int(years * year / dt), dt)
    t, h, T, S = series.T
    np.savez("ice_ocean_coupled.npz", t=t, h=h, T=T, S=S)
    print(f"h range over run: [{h.min():.3f}, {h.max():.3f}] m; "
          f"SST range: [{T.min():.2f}, {T.max():.2f}] °C; final S = {S[-1]:.2f}")
    return t, h, T, S


if __name__ == "__main__":
    main()
