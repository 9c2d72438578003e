"""Ice melting over a dynamical (shallow-water) ocean
(`examples/melting_over_dynamic_ocean.py` in the port): an ice pack over an
ocean with prognostic currents in a periodic × bounded channel, a warm strip
melting the ice from below, brine and meltwater salinity coupling, and
wind-driven ice drift dragging the ocean into motion.

In float32 on the card the ice's αEVP loop runs in the padded kernel
(``csrc/evp_padded.cu``): the refreshed ocean drag has array ``ue``/``ve``.
The example builds float64, as the JAX example does, which the fused gates
leave to the general path.

At the default N = 128 the ocean's gravity waves cross 1.42 cells a
substep, past what its forward-backward substeps hold, and the run blows up
in the first step, as the JAX example does; at N = 32 (0.35 cells a
substep) it runs.
"""

import numpy as np

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import coupled as cp
from climaseaice_jl_tpu_torch.ocean import ShallowWaterOcean

km, day, hour = 1000.0, 86400.0, 3600.0


def build(N=128, device=None):
    grid = cst.RectilinearGrid(size=(N, N), x=(-50 * km, 50 * km),
                               y=(-50 * km, 50 * km),
                               topology=("periodic", "bounded"), device=device)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(),
        coriolis=cst.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.05, "v": 0.0},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=120))
    ice = cst.sea_ice_model(
        grid, dynamics=dynamics,
        top_heat_flux=(cst.RadiativeEmission(),), bottom_heat_flux=0.0,
        ice_salinity=5.0, advection=cst.WENO(order=7),
        timestepper="SplitRungeKutta3")
    ocean = ShallowWaterOcean(depth=50.0, coriolis=cst.FPlane(f=1.4e-4),
                              wind_stress_x=0.05, substeps=24,
                              tracer_diffusivity=20.0)
    iom = cp.IceOceanModel(ice=ice, ocean=ocean)

    # warm strip in the channel centre (the melting anomaly), cold elsewhere
    x = (np.arange(N) + 0.5) * (100 * km / N) - 50 * km
    xc, yc = np.meshgrid(x, x, indexing="ij")
    T0 = -1.5 + 2.5 * np.exp(-(yc / (15 * km)) ** 2)
    state = cp.initial_state(iom, T_ocean=T0, S_ocean=30.0, h=1.0, a=1.0)
    return iom, state


def main(days=10.0, N=128, device=None):
    iom, state = build(N, device)
    g = iom.ice.grid
    dt = 20 * 60.0
    n = int(days * day / dt)
    for _ in range(n):
        state = cp.coupled_step(iom, state, dt)

    def interior(q):
        return g.interior(q).cpu().numpy()

    h, T, S = interior(state.ice.h), interior(state.T_ocean), interior(state.S_ocean)
    uo, ui = interior(state.u_ocean), interior(state.ice.u)
    np.savez("melting_over_dynamic_ocean.npz", h=h, T=T, S=S, uo=uo, ui=ui)
    print(f"after {days:.0f} days: h in [{h.min():.3f}, {h.max():.3f}] m "
          f"(warm strip melts); S in [{S.min():.2f}, {S.max():.2f}] "
          f"(meltwater freshening); |u_ice|max {np.abs(ui).max():.3f} m/s, "
          f"|u_ocean|max {np.abs(uo).max():.3f} m/s")
    assert np.isfinite(h).all() and np.isfinite(uo).all()
    return state


if __name__ == "__main__":
    main()
