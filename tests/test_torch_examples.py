"""The port's eleven examples (`climaseaice_jl_tpu_torch/examples/`), its
JAX-free oracles and the golden runs of `validation/`.

* Each example's short run of `tests/test_examples.py`, with its
  assertions, through ``cst.step`` or ``Simulation.run``, against the JAX
  example's run over the same steps: 1e-10 of each field's largest value for
  the columns, `ROADMAP.md`'s default-P★ bars (h, ℵ ≤ 1e-6; u, v ≤ 5e-2)
  for the two αEVP examples.
* The NumPy oracles of `tests/test_reference_parity_oracles.py` (melting in
  spring, bare and with snow; EVP; EVP + WENO-5) and
  `tests/test_reference_parity.py` (the freezing-bucket recurrence and the
  Stefan law; `tests/data/anticyclone_golden.npz`), at those tests'
  tolerances.  The golden anticyclone was written by the JAX package's
  eager step, whose square roots are IEEE's; a CPU build of torch (2.13,
  AVX-512) rounds its float64 ``sqrt`` otherwise in about 0.7 % of
  elements, and over 20 steps at the default P★ that seed grows in u and v
  past the golden's rtol 1e-9, so that test runs the port with a correctly
  rounded ``sqrt`` (:func:`ieee_sqrt`).
* The goldens `validation/freezing_bucket.npz` (its 1440 steps),
  `melting_in_spring_{bare,snow}.npz` (their first 15 days) and
  `arctic_basin_seasonal_cycle.npz` (its first 360 records) in tier-1, at the
  oracles' tolerances; their full lengths in ``slow`` tests.
* The side models' three examples: the short runs of
  `tests/test_examples.py:46,102` (and 30 days of ``ice_ocean_coupled``)
  against the JAX examples, at 1e-10 for the column and the slab ocean; the
  goldens `validation/diffusive_ice_column.npz` (all 40 records) and
  `validation/ice_ocean_coupled.npz` (12 records in tier-1, all 72 in a
  ``slow`` test) at rtol 1e-9.

Both packages run in float64 on the CPU."""

import os
import sys

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch.convert import state_to_numpy
from climaseaice_jl_tpu_torch import coupled as cp
from climaseaice_jl_tpu_torch import enthalpy as et
from climaseaice_jl_tpu_torch.convert import coupled_state_to_numpy, enthalpy_state_to_numpy
from climaseaice_jl_tpu_torch.examples import (arctic_basin_seasonal_cycle,
                                               diffusive_ice_column_model, freezing_bucket,
                                               freezing_of_a_lake, ice_advected_by_anticyclone,
                                               ice_advected_on_coastline, ice_ocean_coupled,
                                               melting_in_spring, melting_over_dynamic_ocean,
                                               perpetual_night, simple_freezing_bucket)

REPO = os.path.join(os.path.dirname(__file__), "..")
VALIDATION = os.path.join(REPO, "validation")
minute, hour, day = 60.0, 3600.0, 86400.0
TIGHT = 1e-10
DEFAULT_P_STAR_BARS = {"h": 1e-6, "a": 1e-6, "u": 5e-2, "v": 5e-2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as the fixed-tile files run (six test workers share
    the machine's cores in the tier-1 run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example(name):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    scale = np.abs(x).max()
    return np.abs(y - x).max() / scale if scale else np.abs(y - x).max()


def _assert_close(sj, st, bars):
    aj, at = state_to_numpy(sj), state_to_numpy(st)
    for name, bar in bars.items():
        assert np.isfinite(at[name]).all(), name
        rel = _rel(aj[name], at[name])
        assert rel <= bar, f"{name}: {rel:.3e} > {bar:.0e}"


def _column_bars(state, extra=()):
    names = ("h", "a", "Tu") + tuple(extra)
    return {k: TIGHT for k in names if getattr(state, k, None) is not None}


def _loop(step, model, state, dt, n):
    for _ in range(n):
        state = step(model, state, dt)
    return state


# --- the eight examples' short runs against the JAX examples -------------------------------

def test_freezing_bucket_short():
    """One day through ``Simulation.run``: h > 0, 0 < ℵ ≤ 1; the JAX run's
    state."""
    import climaseaice_jl_tpu as csi
    model, state = freezing_bucket.build(device="cpu")
    sim = cst.Simulation(model, state, dt=600.0, stop_time=86400.0)
    sim.run()
    assert float(sim.state.h[0, 0]) > 0.0 and 0 < float(sim.state.a[0, 0]) <= 1.0
    mj, sj = _jax_example("freezing_bucket").build()
    simj = csi.simulation.Simulation(mj, sj, dt=600.0, stop_time=86400.0)
    simj.run()
    assert sim.iteration == int(simj.state.clock.iteration) == 144
    _assert_close(simj.state, sim.state, _column_bars(sim.state))


def test_simple_freezing_bucket_short():
    """One day of `examples/simple_freezing_bucket.py` (prescribed −10 °C lid,
    equilibrium top flux): the ice grows; the JAX run's state."""
    import climaseaice_jl_tpu as csi
    model, state = simple_freezing_bucket.build(device="cpu")
    state = _loop(cst.step, model, state, 10 * minute, 144)
    assert float(state.h[0, 0]) > 0.01
    grid = csi.RectilinearGrid(size=())
    thermo = csi.SlabThermodynamics(top_heat_bc=csi.PrescribedTemperature(-10.0),
                                    internal_heat_flux=csi.ConductiveFlux(conductivity=2.0))
    mj = csi.sea_ice_model(grid, ice_thermodynamics=thermo)
    sj = _loop(csi.step, mj, csi.initial_state(mj, h=0.01, a=1.0), 10 * minute, 144)
    _assert_close(sj, state, _column_bars(state))


def test_perpetual_night_short():
    """48 hourly steps under −200 W m⁻² and radiative emission: strong
    cooling grows the ice; the JAX run's state."""
    import climaseaice_jl_tpu as csi
    model, state = perpetual_night.build(device="cpu")
    state = _loop(cst.step, model, state, hour, 48)
    assert float(state.h[0, 0]) > 0.01
    grid = csi.RectilinearGrid(size=())
    thermo = csi.SlabThermodynamics(top_heat_bc=csi.MeltingConstrainedFluxBalance())
    mj = csi.sea_ice_model(grid, ice_thermodynamics=thermo,
                           top_heat_flux=(csi.RadiativeEmission(), -200.0))
    sj = _loop(csi.step, mj, csi.initial_state(mj, h=0.01, a=1.0), hour, 48)
    _assert_close(sj, state, _column_bars(state))


@pytest.mark.parametrize("snow", [False, True], ids=["bare", "snow"])
def test_melting_in_spring_short(snow):
    """20 steps of 600 s: finite, stronger insolation melts more; the JAX
    run's state."""
    import climaseaice_jl_tpu as csi
    model, state = melting_in_spring.build(snow=snow, device="cpu")
    state = _loop(cst.step, model, state, 600.0, 20)
    h = model.grid.interior(state.h)[:, 0]
    assert h.isfinite().all() and h[0] >= h[-1]
    mj, sj = _jax_example("melting_in_spring").build(snow=snow)
    sj = _loop(csi.step, mj, sj, 600.0, 20)
    _assert_close(sj, state, _column_bars(state, ("hs", "Tus")))


def test_freezing_of_a_lake_short():
    """100 steps of the lake budget and the ice step: finite, the coldest
    column cools the lake fastest; the JAX run's state, lake temperature
    included."""
    import climaseaice_jl_tpu as csi
    model, state = freezing_of_a_lake.build(device="cpu")
    jex = _jax_example("freezing_of_a_lake")
    mj, sj = jex.build()
    for _ in range(100):
        state = cst.step(model, freezing_of_a_lake.advance_lake(model, state, 600.0), 600.0)
        sj = csi.step(mj, jex.advance_lake(mj, sj, 600.0), 600.0)
    g = model.grid
    h = g.interior(state.h)[:, 0]
    TL = g.interior(state.tracers["T_lake"])[:, 0]
    assert h.isfinite().all() and TL[0] <= TL[-1]
    _assert_close(sj, state, {**_column_bars(state), "tracers/T_lake": TIGHT})


def test_anticyclone_short():
    """32², 10 substeps, 5 steps of 120 s: finite, the ice moves; the JAX
    run at the default-P★ bars."""
    import climaseaice_jl_tpu as csi
    model, state = ice_advected_by_anticyclone.build(N=32, substeps=10, device="cpu")
    mj, sj = _jax_example("ice_advected_by_anticyclone").build(N=32, substeps=10)
    state = _loop(cst.step, model, state, 120.0, 5)
    sj = _loop(csi.step, mj, sj, 120.0, 5)
    I = model.grid.interior
    assert I(state.h).isfinite().all() and I(state.u).abs().max() > 0
    _assert_close(sj, state, DEFAULT_P_STAR_BARS)


def test_coastline_short():
    """64×32, 10 substeps, 5 steps of 300 s through ``Simulation.run``:
    finite, the land stays empty; the JAX run at the default-P★ bars."""
    import climaseaice_jl_tpu as csi
    model, state = ice_advected_on_coastline.build(Nx=64, Ny=32, substeps=10, device="cpu")
    sim = cst.Simulation(model, state, dt=300.0, stop_iteration=5)
    sim.run()
    I = model.grid.interior
    h = I(sim.state.h)
    assert h.isfinite().all() and (h[I(model.grid.solid_cc)] == 0).all()
    mj, sj = _jax_example("ice_advected_on_coastline").build(Nx=64, Ny=32, substeps=10)
    sj = _loop(csi.step, mj, sj, 300.0, 5)
    _assert_close(sj, sim.state, DEFAULT_P_STAR_BARS)


def test_arctic_basin_short():
    """90 steps of 8 h (30 days): h finite and positive; the JAX run's
    state."""
    import climaseaice_jl_tpu as csi
    model, state = arctic_basin_seasonal_cycle.build(device="cpu")
    state = _loop(cst.step, model, state, 8 * hour, 90)
    assert np.isfinite(float(state.h[0, 0])) and float(state.h[0, 0]) > 0
    mj, sj = _jax_example("arctic_basin_seasonal_cycle").build()
    sj = _loop(csi.step, mj, sj, 8 * hour, 90)
    _assert_close(sj, state, _column_bars(state))


# --- the oracles and goldens of the column examples ------------------------------------------

_RUNS = {}


def _cached(key, run):
    if key not in _RUNS:
        _RUNS[key] = run()
    return _RUNS[key]


def _bucket_run(n):
    """(h, ℵ) of the freezing bucket after each of ``n`` steps of 10 min, from
    the start."""
    def run():
        model, state = freezing_bucket.build(device="cpu")
        h, a = [float(state.h[0, 0])], [float(state.a[0, 0])]
        for _ in range(n):
            state = cst.step(model, state, 10 * minute)
            h.append(float(state.h[0, 0]))
            a.append(float(state.a[0, 0]))
        return np.array(h), np.array(a)
    return _cached(("bucket", n), run)


def test_freezing_bucket_matches_reference_recurrence():
    """`test_reference_parity.py:102-118`: the port's trajectory equals the
    transcribed reference recurrence at every step of 10 days (rtol 1e-10,
    atol 1e-12)."""
    import test_reference_parity as parity
    n = int(10 * day / (10 * minute))
    h, a = _bucket_run(n)
    h_ref, a_ref = parity.freezing_bucket_oracle(n, 10 * minute)
    np.testing.assert_allclose(h, h_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a, a_ref, rtol=1e-10, atol=1e-12)


def test_freezing_bucket_stefan_law():
    """`test_reference_parity.py:121-142` on the port's trajectory: once
    consolidated with ℵ ≈ 1, h² grows linearly, at 0.9–1.1 of 2kΔT/(ρℒ)."""
    from test_reference_parity import latent_heat_ref
    dt = 10 * minute
    n = int(10 * day / dt)
    h, a = _bucket_run(n)
    t = np.arange(n + 1) * dt
    sel = (a > 0.99) & (h > 0.1)
    ts, hs = t[sel], h[sel]
    coef = np.polyfit(ts, hs ** 2, 1)
    resid = hs ** 2 - np.polyval(coef, ts)
    assert np.max(np.abs(resid)) < 5e-3 * (hs.max() ** 2 - hs.min() ** 2)
    expected = 2 * 2.0 * 10.0 / (900.0 * latent_heat_ref(0.0, c_i=2100.0))
    assert 0.9 * expected < coef[0] < 1.1 * expected


def test_freezing_bucket_golden():
    """`validation/freezing_bucket.npz` (the JAX example's 10 days, 1440
    steps): h and ℵ at every step within rtol 1e-8, atol 1e-12."""
    ref = np.load(os.path.join(VALIDATION, "freezing_bucket.npz"))
    h, a = _bucket_run(len(ref["t"]) - 1)
    np.testing.assert_allclose(h, ref["h"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(a, ref["a"], rtol=1e-8, atol=1e-12)


SPRING_FIELDS = {False: ("h", "a", "Tu"), True: ("h", "a", "hs", "Tus")}


def _spring_run(snow, n):
    """The four columns' fields (``SPRING_FIELDS``) after each of ``n`` steps
    of 10 min, from the start: shape (n + 1, fields, 4)."""
    def run():
        model, state = melting_in_spring.build(snow=snow, device="cpu")
        I = model.grid.interior

        def snap(s):
            return [I(getattr(s, f))[:, 0].numpy().copy() for f in SPRING_FIELDS[snow]]

        traj = [snap(state)]
        for _ in range(n):
            state = cst.step(model, state, 10 * minute)
            traj.append(snap(state))
        return np.array(traj)
    return _cached(("spring", snow, n), run)


INSOLATIONS = [-600.0, -800.0, -1000.0, -1200.0]
SPRING_TOLERANCES = {False: ((1e-8, 1e-12), (1e-8, 1e-12), (1e-7, 1e-9)),
                     True: ((1e-8, 1e-10), (1e-8, 1e-10), (1e-7, 1e-10), (1e-6, 1e-10))}


@pytest.mark.parametrize("snow", [False, True], ids=["bare", "snow"])
def test_melting_in_spring_matches_oracle(snow):
    """`test_reference_parity_oracles.py:250-280`: every step of 15 days, all
    four insolation columns, against the transcribed bare-ice or layered
    snow + ice recurrence, at that test's tolerances."""
    import test_reference_parity_oracles as oracles
    n = int(15 * day / (10 * minute))
    got = _spring_run(snow, n)
    oracle = (oracles.melting_in_spring_snow_oracle if snow
              else oracles.melting_in_spring_bare_oracle)
    for col, insolation in enumerate(INSOLATIONS):
        ref = oracle(n, 10 * minute, insolation)
        for k, (rtol, atol) in enumerate(SPRING_TOLERANCES[snow]):
            np.testing.assert_allclose(got[:, k, col], ref[:, k], rtol=rtol, atol=atol,
                                       err_msg=f"{SPRING_FIELDS[snow][k]} col {col}")


def _spring_golden(snow, n):
    ref = np.load(os.path.join(VALIDATION, f"melting_in_spring_{'snow' if snow else 'bare'}.npz"))
    got = _spring_run(snow, n)
    top = SPRING_FIELDS[snow].index("Tus" if snow else "Tu")
    for k, name, (rtol, atol) in ((0, "h", (1e-8, 1e-10)), (1, "a", (1e-8, 1e-10)),
                                  (top, "T", (1e-6, 1e-9))):
        np.testing.assert_allclose(got[:, k], ref[name][:n + 1], rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("snow", [False, True], ids=["bare", "snow"])
def test_melting_in_spring_golden(snow):
    """`validation/melting_in_spring_{bare,snow}.npz`: the JAX example's
    records over their first 15 days (h, ℵ within rtol 1e-8; the top
    temperature within rtol 1e-6, the oracle's bar for Tus)."""
    _spring_golden(snow, int(15 * day / (10 * minute)))


@pytest.mark.slow
@pytest.mark.parametrize("snow", [False, True], ids=["bare", "snow"])
def test_melting_in_spring_golden_full(snow):
    """The same over the goldens' whole 30 days."""
    ref = np.load(os.path.join(VALIDATION, f"melting_in_spring_{'snow' if snow else 'bare'}.npz"))
    _spring_golden(snow, len(ref["t"]) - 1)


def _arctic_records(n_records):
    """(t, h, Tu, ℵ) every third step of the seasonal-cycle column through
    ``Simulation.run``, from the start."""
    def run():
        model, state = arctic_basin_seasonal_cycle.build(device="cpu")
        sim = cst.Simulation(model, state, dt=8 * hour, stop_iteration=3 * (n_records - 1))
        series = []
        sim.callbacks["save"] = cst.Callback(
            lambda s: series.append((s.time, float(s.state.h[0, 0]), float(s.state.Tu[0, 0]),
                                     float(s.state.a[0, 0]))),
            schedule=cst.IterationInterval(3))
        sim.run()
        return np.array(series)
    return _cached(("arctic", n_records), run)


def _arctic_golden(n_records):
    ref = np.load(os.path.join(VALIDATION, "arctic_basin_seasonal_cycle.npz"))
    got = _arctic_records(n_records)
    assert got.shape == (n_records, 4)
    for k, name, (rtol, atol) in ((0, "t", (0, 0)), (1, "h", (1e-8, 1e-10)),
                                  (2, "T", (1e-6, 1e-9)), (3, "a", (1e-8, 1e-10))):
        np.testing.assert_allclose(got[:, k], ref[name][:n_records], rtol=rtol, atol=atol,
                                   err_msg=name)


def test_arctic_basin_golden():
    """`validation/arctic_basin_seasonal_cycle.npz`: its first 360 records
    (every third 8-hour step, almost a year), h and ℵ within rtol 1e-8, the
    surface temperature within rtol 1e-6."""
    _arctic_golden(360)


@pytest.mark.slow
def test_arctic_basin_golden_full():
    """The same over the golden's 30 years (10,801 records, 32,400 steps)."""
    _arctic_golden(len(np.load(os.path.join(VALIDATION, "arctic_basin_seasonal_cycle.npz"))["t"]))


# --- the dynamics oracles -----------------------------------------------------------------

def _evp_oracle_model(N, L, advection):
    grid = cst.RectilinearGrid(size=(N, N), x=(0, L), y=(0, L), halo=5,
                               topology=("periodic", "periodic"), device="cpu")
    dyn = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=cst.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.05, "v": 0.02},
        bottom_momentum_stress=cst.SemiImplicitStress(ue=0.08, ve=-0.04),
        solver=cst.SplitExplicitSolver(substeps=10, fused="never"))
    return cst.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                             advection=advection, timestepper="ForwardEuler")


@pytest.mark.parametrize("case", ["EVP", "EVP+WENO5"])
def test_evp_matches_oracle(case):
    """`test_reference_parity_oracles.py:537-605`: the port's αEVP step
    (8×8, 2 steps; with WENO-5 advection 16×16, 3 steps; 10 substeps, soft
    ice) against the transcribed reference recurrence at every step, rtol
    1e-8, atol 1e-12."""
    import test_reference_parity_oracles as oracles
    if case == "EVP":
        N, L, n, dt = 8, 8e3, 2, 60.0
        h0 = 0.5 + 0.1 * np.random.default_rng(11).random((N, N))
        a0, names, adv = 1.0, ("u", "v", "sig11", "sig12", "alpha"), None
        ref = oracles.evp_oracle(n, dt, 10, N=N, L=L, h0=h0)
    else:
        N, L, n, dt = 16, 16e3, 3, 120.0
        x = np.arange(N) + 0.5
        h0 = 1.0 + 0.3 * np.sin(2 * np.pi * x[:, None] / N) * np.cos(2 * np.pi * x[None, :] / N)
        a0 = 0.85 + 0.15 * np.cos(2 * np.pi * x[:, None] / N) * np.ones((1, N))
        names, adv = ("u", "v", "h", "a", "sig11", "sig12", "alpha"), cst.WENO(order=5)
        ref = oracles.evp_oracle(n, dt, 10, N=N, L=L, h0=h0, a0=a0, weno5_advection=True)
    model = _evp_oracle_model(N, L, adv)
    state = cst.initial_state(model, h=h0, a=a0, u=0.05)
    I = model.grid.interior
    for k in range(n):
        state = cst.step(model, state, dt)
        for name in names:
            np.testing.assert_allclose(I(getattr(state, name)).numpy(), ref[k][name],
                                       rtol=1e-8, atol=1e-12, err_msg=f"{name} at step {k}")


@pytest.fixture
def ieee_sqrt(monkeypatch):
    """``torch.sqrt`` correctly rounded on CPU float64 tensors (numpy's),
    as the golden's JAX step computed it."""
    sqrt = torch.sqrt

    def correctly_rounded(x, *args, **kw):
        if (isinstance(x, torch.Tensor) and x.device.type == "cpu"
                and x.dtype == torch.float64 and not args and not kw):
            return torch.from_numpy(np.sqrt(x.numpy()))
        return sqrt(x, *args, **kw)

    monkeypatch.setattr(torch, "sqrt", correctly_rounded)


def test_anticyclone_golden_trajectory(ieee_sqrt):
    """`test_reference_parity.py:145-188`: 20 Forward-Euler steps of the
    32² periodic αEVP + WENO-5 + slab configuration at the default P★
    against `tests/data/anticyclone_golden.npz` (u, v, h, ℵ padded), rtol
    1e-9, atol 1e-11."""
    grid = cst.RectilinearGrid(size=(32, 32), x=(0, 256e3), y=(0, 256e3), halo=5,
                               topology=("periodic", "periodic"), device="cpu")
    dyn = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(), coriolis=cst.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.1, "v": -0.1},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=24))
    model = cst.sea_ice_model(grid, dynamics=dyn, advection=cst.WENO(order=5),
                              timestepper="ForwardEuler")

    def h0(x, y):   # numpy's sin and cos, as the golden's initial state took them
        x, y = x.numpy(), y.numpy()
        return torch.from_numpy(1.0 + 0.3 * np.sin(2 * np.pi * x / 256e3)
                                * np.cos(2 * np.pi * y / 256e3))

    state = _loop(cst.step, model, cst.initial_state(model, h=h0, a=1.0), 120.0, 20)
    ref = np.load(os.path.join(REPO, "tests", "data", "anticyclone_golden.npz"))
    for k in ("u", "v", "h", "a"):
        np.testing.assert_allclose(getattr(state, k).numpy(), ref[k], rtol=1e-9, atol=1e-11,
                                   err_msg=f"field {k} diverged from golden")


# --- the side models' examples ------------------------------------------------------------

def test_diffusive_column_short():
    """`tests/test_examples.py:46`: 50 steps of 600 s (past the explicit
    scheme's stability limit, as there): finite; H, T, ϕ, κ within 1e-10 of
    the JAX run's largest values."""
    jex = _jax_example("diffusive_ice_column_model")
    from climaseaice_jl_tpu import enthalpy as em
    model, state = diffusive_ice_column_model.build(device="cpu")
    state = _loop(et.step, model, state, 600.0, 50)
    assert torch.isfinite(state.T).all()
    mj, sj = jex.build()
    sj = _loop(em.step, mj, sj, 600.0, 50)
    aj, at = enthalpy_state_to_numpy(sj), enthalpy_state_to_numpy(state)
    for name in ("H", "T", "phi", "kappa"):
        assert _rel(aj[name], at[name]) <= TIGHT, name


def test_ice_ocean_coupled_short():
    """30 days (120 coupled steps of 6 h) of the slab-ocean example through
    its ``run`` (insolation formed on the device from the clock) against the
    JAX example's loop over the same steps: the three records and every
    field of the coupled state within 1e-10."""
    jex = _jax_example("ice_ocean_coupled")
    iom, state = ice_ocean_coupled.build(device="cpu")
    state, series = ice_ocean_coupled.run(iom, state, 120)
    iom_j, sj = jex.build()
    dt, ref = 6 * 3600.0, []
    for k in range(120):
        t = float(sj.clock.time)
        insol = -150.0 * max(0.0, np.sin(2 * np.pi * t / jex.year))
        iom_j = iom_j.evolve(ocean=iom_j.ocean.evolve(solar_insolation=insol))
        sj = jex.cp.coupled_step(iom_j, sj, dt)
        if k % 40 == 0:
            I = iom_j.ice.grid.interior
            ref.append((t / day, float(np.asarray(I(sj.ice.h)).mean()),
                        float(np.asarray(I(sj.T_ocean)).mean()),
                        float(np.asarray(I(sj.S_ocean)).mean())))
    assert series.shape == (3, 4)
    np.testing.assert_allclose(series, np.array(ref), rtol=TIGHT, atol=0)
    aj, at = coupled_state_to_numpy(sj), coupled_state_to_numpy(state)
    assert sorted(aj) == sorted(at)
    for key in aj:
        assert _rel(aj[key], at[key]) <= TIGHT, key


MELTING_FIELDS = ("ice/h", "ice/a", "ice/u", "ice/v", "T_ocean", "S_ocean", "u_ocean", "v_ocean",
                  "eta")


def test_melting_over_dynamic_ocean_short():
    """`tests/test_examples.py:102`: 32², 12 coupled steps of 20 min at the
    default P★ (float64, the general path): finite, the warm strip melts
    and thins below the channel's edge, the ocean moves.  Against the JAX
    example over the same steps: the default-P★ bars (h, ℵ ≤ 1e-6; u, v ≤
    5e-2; 1e-6 for the ocean's fields) or four times the JAX example's own
    distance from itself with h perturbed by one part in 1e15, whichever is
    larger.  The bars alone cannot hold here: packed ice (ℵ = 1) in the
    plastic regime carries that perturbation to 2.7e-3 in h and 0.19 in v
    after 12 steps of the JAX example itself (the port: 4.0e-3 and 0.13)."""
    jex = _jax_example("melting_over_dynamic_ocean")
    iom, state = melting_over_dynamic_ocean.build(N=32, device="cpu")
    g = iom.ice.grid
    h0 = g.interior(state.ice.h).clone()
    state = _loop(cp.coupled_step, iom, state, 1200.0, 12)
    h, uo = g.interior(state.ice.h), g.interior(state.u_ocean)
    assert torch.isfinite(h).all() and torch.isfinite(uo).all()
    mid, edge = h[:, h.shape[1] // 2].mean(), h[:, 2].mean()
    assert mid < h0[:, h0.shape[1] // 2].mean() and mid < edge
    assert uo.abs().max() > 1e-5

    iom_j, sj = jex.build(N=32)
    perturbed = sj.evolve(ice=sj.ice.evolve(h=sj.ice.h * (1 + 1e-15)))
    sj = _loop(jex.cp.coupled_step, iom_j, sj, 1200.0, 12)
    perturbed = _loop(jex.cp.coupled_step, iom_j, perturbed, 1200.0, 12)
    aj, ap, at = (coupled_state_to_numpy(x) for x in (sj, perturbed, state))
    for key in MELTING_FIELDS:
        bar = max(DEFAULT_P_STAR_BARS.get(key.removeprefix("ice/"), 1e-6),
                  4 * _rel(aj[key], ap[key]))
        assert _rel(aj[key], at[key]) <= bar, (key, _rel(aj[key], at[key]), bar)


def test_diffusive_ice_column_golden():
    """`validation/diffusive_ice_column.npz`: the JAX example's 40 records
    of 10 days (8,640 steps of 100 s), times exact, temperatures within rtol
    1e-9, atol 1e-11 (the oracle's bars)."""
    ref = np.load(os.path.join(VALIDATION, "diffusive_ice_column.npz"))
    model, state = diffusive_ice_column_model.build(device="cpu")
    _, t, T = diffusive_ice_column_model.run(model, state)
    np.testing.assert_array_equal(t, ref["t"])
    np.testing.assert_allclose(T, ref["T"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(model.grid.zc().numpy(), ref["z"], rtol=0, atol=0)


def _coupled_golden(n_records):
    ref = np.load(os.path.join(VALIDATION, "ice_ocean_coupled.npz"))
    iom, state = ice_ocean_coupled.build(device="cpu")
    _, series = ice_ocean_coupled.run(iom, state, 40 * (n_records - 1) + 1)
    assert series.shape == (n_records, 4)
    for k, name in enumerate(("t", "h", "T", "S")):
        np.testing.assert_allclose(series[:, k], ref[name][:n_records], rtol=1e-9, atol=0,
                                   err_msg=name)


def test_ice_ocean_coupled_golden():
    """`validation/ice_ocean_coupled.npz`: the first 12 of its 72 records
    (every 40th step of 6 h: 441 steps, 110 days) of mean h, SST and
    salinity within rtol 1e-9."""
    _coupled_golden(12)


@pytest.mark.slow
def test_ice_ocean_coupled_golden_full():
    """The same over the golden's two years (72 records, 2,880 steps)."""
    _coupled_golden(len(np.load(os.path.join(VALIDATION, "ice_ocean_coupled.npz"))["t"]))
