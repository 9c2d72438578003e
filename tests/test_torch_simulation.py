"""The port's Simulation: the coastline configuration
(`examples/ice_advected_on_coastline.py:18-44`, float32, cut to 64×32 and
10 substeps) through `Simulation.run`, its callbacks and schedules, the stop
conditions, and the NaN check."""

import os

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch.dynamics.fused_evp_padded import padded_fused_available

km, minute = 1000.0, 60.0


def coastline(Nx=64, Ny=32, substeps=10, device="cpu"):
    """The coastline example in the port: periodic-x channel, bounded in y,
    a diagonal coastline of land, constant eastward wind, ocean drag and
    ImmersedDrag(3e-3), float32."""
    Lx, Ly = 512 * km, 256 * km
    grid = cst.RectilinearGrid(size=(Nx, Ny), x=(-Lx / 2, Lx / 2), y=(0, Ly), halo=4,
                               topology=("periodic", "bounded"), dtype="float32",
                               device=device)

    def land(x, y):
        ocean = (y <= Ly / 2) & (np.abs(x / Lx) * Nx + y / Ly * Ny > 24)
        return ~ocean

    grid = cst.ImmersedBoundaryGrid(grid, land)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(),
        top_momentum_stress={"u": -1.3 * 1.2e-3 * 10.0 ** 2, "v": 0.0},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        immersed_drag=cst.ImmersedDrag(coefficient=3e-3),
        solver=cst.SplitExplicitSolver(substeps=substeps))
    model = cst.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=cst.WENO(order=7), timestepper="SplitRungeKutta3")
    return model, cst.initial_state(model, h=1.0, a=1.0)


def test_simulation_equals_step_loop_and_fires_callbacks():
    """Simulation.run through the padded route equals a loop of cst.step
    exactly; IterationInterval and TimeInterval callbacks fire at the start
    and on schedule; stop_time and stop_iteration stop where they should."""
    model, state = coastline()
    assert padded_fused_available(model)
    sim = cst.Simulation(model, state, dt=5 * minute, stop_iteration=4)
    fired = {"it": [], "time": []}
    sim.callbacks["it"] = cst.Callback(lambda s: fired["it"].append(s.iteration),
                                       schedule=cst.IterationInterval(2))
    sim.callbacks["time"] = cst.Callback(lambda s: fired["time"].append(s.time),
                                         schedule=cst.TimeInterval(10 * minute))
    final = sim.run()
    assert fired == {"it": [0, 2, 4], "time": [0.0, 600.0, 1200.0]}
    assert sim.iteration == 4 and sim.time == 1200.0 and sim.points_per_second > 0

    loop = cst.time_step(model, state, 5 * minute, steps=4)
    for name in ("h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha"):
        assert torch.equal(getattr(final, name), getattr(loop, name)), name
    assert final.h.isfinite().all() and final.u.abs().max() > 0

    by_time = cst.Simulation(model, state, dt=5 * minute, stop_time=15 * minute)
    by_time.run()
    assert by_time.iteration == 3


def _still_water(h):
    """A 4×4 grid without dynamics or thermodynamics: a step only ticks the
    clock and keeps h."""
    grid = cst.RectilinearGrid(size=(4, 4), dtype="float32", device="cpu")
    model = cst.sea_ice_model(grid, ice_thermodynamics=None)
    return model, cst.initial_state(model, h=h, a=1.0)


def test_nan_check_raises_at_iteration_100():
    """A NaN thickness stops the run at the check of iteration 100, and only
    there; check_nans=False runs through."""
    h = np.ones((4, 4))
    h[1, 2] = np.nan
    model, state = _still_water(h)
    sim = cst.Simulation(model, state, dt=60.0, stop_iteration=150)
    with pytest.raises(FloatingPointError, match="iteration 100"):
        sim.run()
    assert sim.iteration == 100
    quiet = cst.Simulation(model, state, dt=60.0, stop_iteration=150, check_nans=False)
    quiet.run()
    assert quiet.iteration == 150


def test_options_of_later_slices_raise(tmp_path):
    """Checkpoint pickup and device traces are ported: a pickup that cannot
    be met raises the JAX package's ValueError before a step (no
    Checkpointer for True or a number; True with no checkpoint written), a
    path picks up, and a profiled run writes its trace and steps as an
    unprofiled one does."""
    model, state = _still_water(1.0)
    sim = cst.Simulation(model, state, dt=60.0, stop_iteration=1)
    for pickup in (True, 3):
        with pytest.raises(ValueError, match="requires a Checkpointer"):
            sim.run(pickup=pickup)
    sim.output_writers["ckp"] = cst.io.Checkpointer(str(tmp_path / "chk"),
                                                    cst.IterationInterval(1))
    with pytest.raises(ValueError, match="requires existing checkpoints"):
        sim.run(pickup=True)
    assert sim.iteration == 0
    sim.run(profile_dir=str(tmp_path / "trace"))
    assert sim.iteration == 1 and os.path.exists(sim.trace_file)
    again = cst.Simulation(model, state, dt=60.0, stop_iteration=1)
    again.run(pickup=str(tmp_path / "chk_iteration1.npz"))
    assert again.iteration == 1
    for name in ("h", "a", "u", "v"):
        assert torch.equal(getattr(again.state, name), getattr(sim.state, name)), name