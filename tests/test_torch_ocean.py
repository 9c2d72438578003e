"""The shallow-water ocean of the port (`climaseaice_jl_tpu_torch/ocean.py`)
against the JAX package's (`climaseaice_jl_tpu/ocean.py`).

* `tests/test_ocean.py`'s five tests on the port, with their assertions;
  the last (free-drift ice coupled to the ocean) also held to the JAX
  package's coupled run within 1e-10 of each field's largest value.
* Parity with the JAX package within 1e-12 of each output's largest value
  for ``shallow_water_substeps`` (with and without lateral viscosity),
  ``advect_tracer`` (with and without masks and diffusion),
  ``surface_stresses`` and the three Laplacians, on a bounded grid with an
  island and on a doubly periodic one, with ``FPlane``, ``BetaPlane`` and
  no Coriolis; seeded inputs carried across as numpy arrays.

Both packages run in float64 on the CPU; the JAX package is imported inside
the tests."""

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import coupled as cp
from climaseaice_jl_tpu_torch import ocean as to
from climaseaice_jl_tpu_torch.convert import coupled_state_from_numpy, coupled_state_to_numpy
from climaseaice_jl_tpu_torch.fields import peripheral_masks
from climaseaice_jl_tpu_torch.ocean import (ShallowWaterOcean, advect_tracer,
                                            shallow_water_substeps, surface_stresses)

km = 1000.0
PARITY = 1e-12
# the ice-bath flux is ρcH/Δt ≈ 1.0e5 W m⁻² K⁻¹ times T − Tₘ, a difference of
# nearly equal temperatures: the SST's 1e-12 after 20 steps becomes 1e-9 of
# it, and of the ice's bottom flux and mass flux that it sets
FLUX_BARS = {"Q_bottom": 1e-8, "ice/Qbot": 1e-8, "ice/mf_ice": 1e-8}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as the fixed-tile files run (six test workers share
    the machine's cores in the tier-1 run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(ref, x):
    ref, x = np.asarray(ref), np.asarray(x)
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)


def _ice(lib, grid, **kw):
    return lib.sea_ice_model(grid, top_heat_flux=0.0, bottom_heat_flux=0.0,
                             ice_salinity=5.0, timestepper="ForwardEuler", **kw)


# --- tests/test_ocean.py on the port ---------------------------------------------------------

def test_lake_at_rest_is_exactly_steady():
    """Flat η, no wind, bounded walls and an immersed island: the discrete
    state is an exact fixed point."""
    grid = cst.RectilinearGrid(size=(16, 16), x=(0, 100 * km), y=(0, 100 * km),
                               topology=("bounded", "bounded"), device="cpu")
    solid = np.zeros((16, 16), bool)
    solid[6:9, 6:9] = True
    grid = cst.ImmersedBoundaryGrid(grid, solid)
    ocean = ShallowWaterOcean(depth=50.0, coriolis=cst.FPlane(f=1e-4), bottom_drag=1e-3,
                              substeps=8)
    u, v, eta = grid.new_field(), grid.new_field(), grid.new_field()
    u2, v2, eta2 = shallow_water_substeps(grid, ocean, u, v, eta, grid.new_field(),
                                          grid.new_field(), 1800.0)
    assert torch.equal(u2, u) and torch.equal(v2, v) and torch.equal(eta2, eta)


def test_gravity_wave_volume_conservation():
    """A periodic η bump: ∑η·Az conserved to roundoff over 5 × 64 substeps,
    the adjustment bounded."""
    N = 32
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 200 * km), y=(0, 200 * km), device="cpu")
    ocean = ShallowWaterOcean(depth=100.0, coriolis=cst.FPlane(f=1e-4), bottom_drag=0.0,
                              substeps=64)
    x = (np.arange(N) + 0.5) * (200 * km / N)
    xc, yc = np.meshgrid(x, x, indexing="ij")
    eta = grid.field_from(0.1 * np.exp(-((xc - 100 * km) ** 2 + (yc - 100 * km) ** 2)
                                       / (30 * km) ** 2))
    u, v = grid.new_field(), grid.new_field()
    vol0 = float(grid.interior(eta).sum())
    for _ in range(5):
        u, v, eta = shallow_water_substeps(grid, ocean, u, v, eta, grid.new_field(),
                                           grid.new_field(), 1800.0)
    e = grid.interior(eta)
    assert torch.isfinite(e).all()
    assert abs(float(e.sum()) - vol0) < 1e-9 * max(abs(vol0), 1.0)
    assert e.abs().max() < 0.2 and grid.interior(u).abs().max() < 1.0


def test_wind_driven_drag_balance():
    """Constant wind over open water spins the layer up to the quadratic
    bottom-drag balance u* = sqrt(τ/(ρ C_d)) within 5 % (f = 0, periodic)."""
    N = 8
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 100 * km), y=(0, 100 * km), device="cpu")
    tau = 0.1
    ocean = ShallowWaterOcean(depth=20.0, coriolis=None, bottom_drag=2e-3, wind_stress_x=tau,
                              substeps=4)
    u, v, eta = grid.new_field(), grid.new_field(), grid.new_field()
    a = grid.new_field()
    for _ in range(400):
        tu, tv = surface_stresses(grid, ocean, grid.new_field(), grid.new_field(), a, u, v)
        u, v, eta = shallow_water_substeps(grid, ocean, u, v, eta, tu, tv, 1800.0)
    u_star = np.sqrt(tau / (ocean.density * ocean.bottom_drag))
    u_end = float(grid.interior(u).mean())
    assert abs(u_end - u_star) / u_star < 0.05, (u_end, u_star)


def test_tracer_advection_monotone_and_compensated():
    """Advective-form WENO transport under a divergent flow: the tracer
    stays within its initial bounds (to 5e-3)."""
    N = 32
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 200 * km), y=(0, 200 * km), device="cpu")
    ocean = ShallowWaterOcean(depth=100.0, substeps=32, bottom_drag=0.0)
    x = (np.arange(N) + 0.5) * (200 * km / N)
    xc, yc = np.meshgrid(x, x, indexing="ij")
    eta = grid.field_from(0.2 * np.sin(2 * np.pi * xc / (200 * km)))
    T = grid.field_from(1.0 + np.cos(2 * np.pi * yc / (200 * km)))
    u, v = grid.new_field(), grid.new_field()
    for _ in range(10):
        u, v, eta = shallow_water_substeps(grid, ocean, u, v, eta, grid.new_field(),
                                           grid.new_field(), 1800.0)
        T = advect_tracer(grid, ocean, u, v, T, 1800.0)
    Ti = grid.interior(T)
    assert torch.isfinite(Ti).all()
    assert Ti.min() > -5e-3 and Ti.max() < 2.0 + 5e-3


def _free_drift(lib, cp_, SW, **grid_kw):
    grid = lib.RectilinearGrid(size=(16, 16), x=(0, 100 * km), y=(0, 100 * km), **grid_kw)
    dynamics = lib.StressBalanceFreeDrift(top_momentum_stress={"u": 0.1, "v": 0.0},
                                          bottom_momentum_stress=lib.SemiImplicitStress())
    ice = _ice(lib, grid, dynamics=dynamics)
    iom = cp_.IceOceanModel(ice=ice, ocean=SW(depth=30.0, coriolis=lib.FPlane(f=1.2e-4),
                                              substeps=8))
    return iom, grid


def test_coupled_dynamic_ocean_ice_drag_drives_currents():
    """Wind-driven ice in free drift (no advection, as the JAX test has it)
    over a quiescent ocean drags it into motion, 20 steps of 1200 s: finite,
    the ocean responds but lags the ice, icy cells pinned near Tₘ(S); every
    field of the coupled state within 1e-10 of the JAX package's run (η of
    the layer's depth; the ice-bath fluxes within ``FLUX_BARS``)."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu import coupled as cpj
    from climaseaice_jl_tpu.ocean import ShallowWaterOcean as SWj
    iom, g = _free_drift(cst, cp, ShallowWaterOcean, device="cpu")
    state = cp.initial_state(iom, T_ocean=-1.0, S_ocean=30.0, h=1.0, a=1.0)
    iomj, _ = _free_drift(csi, cpj, SWj)
    sj = cpj.initial_state(iomj, T_ocean=-1.0, S_ocean=30.0, h=1.0, a=1.0)
    for _ in range(20):
        state = cp.coupled_step(iom, state, 1200.0)
        sj = cpj.coupled_step(iomj, sj, 1200.0)
    uo, ui = g.interior(state.u_ocean), g.interior(state.ice.u)
    assert torch.isfinite(uo).all() and torch.isfinite(ui).all()
    assert ui.abs().max() > 1e-3 and uo.abs().max() > 1e-5
    assert uo.abs().max() < ui.abs().max()
    Tm = cst.melting_temperature(iom.ice.phase_transitions.liquidus, g.interior(state.S_ocean))
    np.testing.assert_allclose(g.interior(state.T_ocean).numpy(), Tm.numpy(), atol=1e-2)
    aj, at = coupled_state_to_numpy(sj), coupled_state_to_numpy(state)
    assert sorted(aj) == sorted(at)
    for key in aj:
        if key == "eta":   # roundoff-sized (1e-8 m) under a uniform wind: against the depth
            err = np.abs(at[key] - aj[key]).max() / iom.ocean.depth
        else:
            err = _rel(aj[key], at[key])
        assert err <= FLUX_BARS.get(key, 1e-10), (key, err)


# --- the ocean's functions against the JAX package -------------------------------------------

def _grids(kind):
    import climaseaice_jl_tpu as csi
    kw = dict(size=(20, 16), x=(0, 160 * km), y=(0, 120 * km), halo=4)
    if kind == "periodic":
        return (csi.RectilinearGrid(**kw),
                cst.RectilinearGrid(**kw, device="cpu"))
    kw["topology"] = ("bounded", "bounded")
    x = (np.arange(20) + 0.5) * 8 * km
    y = (np.arange(16) + 0.5) * 7.5 * km
    island = (x[:, None] - 70 * km) ** 2 + (y[None, :] - 60 * km) ** 2 < (25 * km) ** 2
    return (csi.ImmersedBoundaryGrid(csi.RectilinearGrid(**kw), island),
            cst.ImmersedBoundaryGrid(cst.RectilinearGrid(**kw, device="cpu"), island))


def _coriolis(lib, kind):
    return {"fplane": lambda: lib.FPlane(f=1.2e-4),
            "betaplane": lambda: lib.BetaPlane(f0=1e-4, beta=1.5e-11, y0=60 * km),
            "none": lambda: None}[kind]()


def _oceans(kind, **kw):
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.ocean import ShallowWaterOcean as SWj
    return (SWj(coriolis=_coriolis(csi, kind), **kw),
            ShallowWaterOcean(coriolis=_coriolis(cst, kind), **kw))


def _inputs(shape, seed):
    """Seeded fields: velocities (m/s), elevation (m), an ice concentration
    in [0, 1], a temperature, ice velocities."""
    rng = np.random.default_rng(seed)
    return {"u": 0.2 * rng.standard_normal(shape), "v": 0.2 * rng.standard_normal(shape),
            "eta": 0.3 * rng.standard_normal(shape), "a": rng.uniform(0.0, 1.0, shape),
            "T": rng.uniform(-1.8, 2.0, shape), "ui": 0.3 * rng.standard_normal(shape),
            "vi": 0.3 * rng.standard_normal(shape)}


@pytest.mark.parametrize("coriolis", ["fplane", "betaplane", "none"])
@pytest.mark.parametrize("grid_kind", ["bounded_island", "periodic"])
def test_ocean_functions_match_jax(grid_kind, coriolis):
    """Seeded inputs through both packages: ``surface_stresses``,
    ``shallow_water_substeps`` (24 substeps of a 1800 s step, without and
    with lateral viscosity, the stresses as forcing), ``advect_tracer``
    (WENO-5, then WENO-7 with the peripheral masks and diffusion) and the
    three Laplacians, each output within 1e-12 of its largest value."""
    import jax.numpy as jnp
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu import fields as jfields
    from climaseaice_jl_tpu import ocean as jo
    gj, gt = _grids(grid_kind)
    q = _inputs(gt.shape, seed=len(grid_kind) * 7 + len(coriolis))
    J = {k: jnp.asarray(x) for k, x in q.items()}
    T_ = {k: torch.from_numpy(x) for k, x in q.items()}

    def close(name, xj, xt):
        assert _rel(np.asarray(xj), xt.numpy()) <= PARITY, (name, _rel(np.asarray(xj), xt.numpy()))

    oj, ot = _oceans(coriolis, depth=40.0, bottom_drag=2e-3, wind_stress_x=0.08,
                     wind_stress_y=-0.03, substeps=24)
    tj = jo.surface_stresses(gj, oj, J["ui"], J["vi"], J["a"], J["u"], J["v"])
    tt = surface_stresses(gt, ot, T_["ui"], T_["vi"], T_["a"], T_["u"], T_["v"])
    for name, xj, xt in zip(("tau_u", "tau_v"), tj, tt):
        close(name, xj, xt)

    for visc in (None, 500.0):
        oj2, ot2 = oj.evolve(lateral_viscosity=visc), ot.evolve(lateral_viscosity=visc)
        outj = jo.shallow_water_substeps(gj, oj2, J["u"], J["v"], J["eta"], *tj, 1800.0)
        outt = shallow_water_substeps(gt, ot2, T_["u"], T_["v"], T_["eta"], *tt, 1800.0)
        for name, xj, xt in zip(("u", "v", "eta"), outj, outt):
            close(f"{name} (viscosity {visc})", xj, xt)

    u_j, v_j, _ = outj
    u_t, v_t, _ = outt
    close("advect_tracer", jo.advect_tracer(gj, oj, u_j, v_j, J["T"], 1800.0),
          advect_tracer(gt, ot, u_t, v_t, T_["T"], 1800.0))
    mj = jfields.peripheral_masks(gj)[:2]
    mt = peripheral_masks(gt)[:2]
    wj = oj.evolve(tracer_diffusivity=20.0, advection=csi.WENO(order=7))
    wt = ot.evolve(tracer_diffusivity=20.0, advection=cst.WENO(order=7))
    close("advect_tracer (masks, diffusion)",
          jo.advect_tracer(gj, wj, u_j, v_j, J["T"], 1800.0, masks=mj),
          advect_tracer(gt, wt, u_t, v_t, T_["T"], 1800.0, masks=mt))

    for name in ("_laplacian_fc", "_laplacian_cf", "_laplacian_cc"):
        close(name, getattr(jo, name)(gj, J["u"]), getattr(to, name)(gt, T_["u"]))


def test_dynamic_ocean_state_carries_across():
    """``coupled_state_to_numpy`` / ``coupled_state_from_numpy`` round-trip
    a dynamical-ocean state with every field and the clock, on the ice
    model's grid and dtype."""
    iom, g = _free_drift(cst, cp, ShallowWaterOcean, device="cpu")
    state = cp.coupled_step(iom, cp.initial_state(iom, T_ocean=-1.0, h=1.0, a=1.0,
                                                  u_ocean=0.01, eta=0.05), 1200.0)
    arrays = coupled_state_to_numpy(state)
    assert {"u_ocean", "v_ocean", "eta", "Q_bottom", "ice/h", "time"} <= set(arrays)
    back = coupled_state_from_numpy(iom, arrays)
    again = coupled_state_to_numpy(back)
    assert sorted(again) == sorted(arrays)
    for key in arrays:
        assert np.array_equal(again[key], arrays[key]) and again[key].dtype == arrays[key].dtype
    assert back.ice.clock is back.clock and int(back.clock.iteration) == 1
    with pytest.raises(ValueError):
        coupled_state_from_numpy(iom, {**arrays, "sst": arrays["T_ocean"]})
