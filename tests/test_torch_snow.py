"""Snow on ice and time-dependent forcing in the port vs the JAX package,
float64: FieldTimeSeries (scalar and field series, clamped and cyclical),
the snow-ice conduction pieces, snowfall and flooding, the layered snow +
ice column step, and a seasonal snow column through the normal entry
points.  Same expressions in the same order: ≤ 1e-12 relative to each
field's largest value."""

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import arctic_basin
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch.model import make_fields as tmake_fields
from climaseaice_jl_tpu_torch.thermodynamics import slab as tslab

DAY = 86400.0


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.abs(y - x).max() / max(np.abs(x).max(), 1e-30)


# --- FieldTimeSeries ---------------------------------------------------------------

@pytest.mark.parametrize("cyclical", [True, False])
@pytest.mark.parametrize("kind", ["scalar", "field"])
def test_field_time_series_matches_jax(kind, cyclical):
    """`at_time` and the flux call at times before, inside, on and beyond
    the samples (and several periods on, when cyclical): ≤ 1e-12 relative
    to JAX in float64 (measured 0); a float32 clock gives a float32 value."""
    import jax.numpy as jnp
    from climaseaice_jl_tpu.forcing_utils import FieldTimeSeries as JFTS
    from climaseaice_jl_tpu.state import Clock as JClock

    rng = np.random.default_rng(0)
    times = arctic_basin.TIMES
    data = (arctic_basin.TAB_LONGWAVE if kind == "scalar"
            else rng.standard_normal((len(times), 5, 4)))
    fj = JFTS(times=times, data=data, cyclical=cyclical)
    ft = cst.FieldTimeSeries(times=times, data=data, cyclical=cyclical)
    probes = [0.0, 5 * DAY, times[0], times[3], 100.3 * DAY, times[-1], 350 * DAY,
              359.9 * DAY, 365 * DAY, 1000.7 * DAY]
    for t in probes:
        a = np.asarray(fj.at_time(jnp.asarray(t)))
        b = ft.at_time(torch.tensor(t, dtype=torch.float64))
        assert b.dtype == torch.float64 and tuple(b.shape) == a.shape
        assert _rel(a, b.numpy()) <= 1e-12, t
        clock = cst.Clock(time=torch.tensor(t, dtype=torch.float64), iteration=torch.tensor(0))
        flux = ft(None, None, clock, None)
        assert torch.equal(flux, b)
        jflux = fj(None, None, JClock(time=jnp.asarray(t), iteration=0), None)
        assert _rel(jflux, flux.numpy()) <= 1e-12
    assert ft.at_time(torch.tensor(100 * DAY, dtype=torch.float32)).dtype == torch.float32


def test_field_time_series_reuses_a_lookup_only_for_the_same_unchanged_time():
    """A lookup is reused for the very clock tensor it was made at; a new
    tensor with the same value, or the same tensor written in place, is
    looked up afresh and gives the value at its time exactly."""
    ft = cst.FieldTimeSeries(times=arctic_basin.TIMES, data=arctic_basin.TAB_LONGWAVE,
                             cyclical=True)
    t = torch.tensor(100 * DAY, dtype=torch.float64)
    first = ft.at_time(t)
    assert ft.at_time(t) is first
    assert torch.equal(ft.at_time(torch.tensor(100 * DAY, dtype=torch.float64)), first)
    t += 50 * DAY
    fresh = cst.FieldTimeSeries(times=arctic_basin.TIMES, data=arctic_basin.TAB_LONGWAVE,
                                cyclical=True)
    moved = ft.at_time(t)
    assert not torch.equal(moved, first)
    assert torch.equal(moved, fresh.at_time(torch.tensor(150 * DAY, dtype=torch.float64)))


# --- the snow pieces -----------------------------------------------------------------

def test_snow_pieces_match_jax():
    """Snow-ice conduction, the interface temperature, snow accumulation and
    negative-freeboard flooding on random columns (zero snow and zero ice
    included): ≤ 1e-12 relative to JAX in float64 (measured 0)."""
    import jax.numpy as jnp
    from climaseaice_jl_tpu.thermodynamics import slab as jslab

    rng = np.random.default_rng(1)
    n = 64
    hi = np.where(rng.random(n) < 0.2, 0.0, 2 * rng.random(n))
    hs = np.where(rng.random(n) < 0.2, 0.0, rng.random(n))
    Tu, Tb = -20 * rng.random(n), -1.8 + 0 * hi
    a = np.where(rng.random(n) < 0.2, 0.0, rng.random(n))
    fj = jslab.IceSnowConductiveFlux(snow_conductivity=0.31, ice_conductivity=2.0)
    ft = cst.IceSnowConductiveFlux(snow_conductivity=0.31, ice_conductivity=2.0)
    J = [jnp.asarray(q) for q in (Tu, Tb, hi, hs)]
    T = [torch.tensor(q) for q in (Tu, Tb, hi, hs)]
    pairs = [(jslab.ice_snow_conductive_flux_value(fj, *J), tslab.ice_snow_conductive_flux_value(ft, *T)),
             (jslab.interface_temperature(fj, *J), tslab.interface_temperature(ft, *T)),
             (jslab.snow_accumulation(3.2e-6, 330.0, jnp.asarray(a)),
              tslab.snow_accumulation(3.2e-6, 330.0, torch.tensor(a)))]
    pairs += list(zip(jslab.snow_ice_formation(J[2], J[3], 900.0, 330.0, 1026.0),
                      tslab.snow_ice_formation(T[2], T[3], 900.0, 330.0, 1026.0)))
    for a_j, a_t in pairs:
        assert _rel(a_j, a_t.numpy()) <= 1e-12
    # flooding moves snow into ice where the freeboard is negative
    flooded = tslab.snow_ice_formation(torch.tensor([0.2]), torch.tensor([1.0]), 900.0, 330.0,
                                       1026.0)
    assert flooded[0].item() > 0.2 and flooded[1].item() < 1.0


# --- the layered column step ---------------------------------------------------------

def _snow_models(snowfall_kind, top_kind):
    """A 12×9 float64 grid with slab ice and snow.  Snowfall: a number, a
    FieldTimeSeries or none; top flux: the Semtner series with emission
    (the secant does real work) or a prescribed snow-surface temperature."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.forcing_utils import FieldTimeSeries as JFTS

    out = []
    for lib, fts, kw in ((csi, JFTS, {}), (cst, cst.FieldTimeSeries, {"device": "cpu"})):
        grid = lib.RectilinearGrid(size=(12, 9), halo=3, dtype="float64", **kw)
        snowfall = {"number": 3.2e-6, "none": 0.0,
                    "series": fts(times=arctic_basin.TIMES,
                                  data=3e-6 * (1 + np.cos(np.arange(12))), cyclical=True)
                    }[snowfall_kind]
        if top_kind == "seasonal":
            top = (fts(times=arctic_basin.TIMES, data=arctic_basin.TAB_SHORTWAVE, cyclical=True),
                   fts(times=arctic_basin.TIMES, data=arctic_basin.TAB_LONGWAVE, cyclical=True),
                   lib.RadiativeEmission(emissivity=1.0, stefan_boltzmann_constant=5.67e-8 * 1.02))
            snow = lib.snow_slab_thermodynamics()
        else:
            top = -30.0
            snow = lib.snow_slab_thermodynamics(top_heat_bc=lib.PrescribedTemperature(-12.0))
        out.append(lib.sea_ice_model(grid, ice_thermodynamics=lib.sea_ice_slab_thermodynamics(),
                                     snow_thermodynamics=snow, snowfall=snowfall,
                                     top_heat_flux=top, bottom_heat_flux=-2.0))
    return out


def _columns(csi, model, seed):
    """Random columns: thin, thick and absent ice, with and without snow."""
    rng = np.random.default_rng(seed)
    shape = model.grid.interior_shape
    h = np.where(rng.random(shape) < 0.15, 0.0, 0.01 + 2 * rng.random(shape))
    a = np.where(h > 0, 0.1 + 0.9 * rng.random(shape), 0.0)
    hs = np.where(rng.random(shape) < 0.3, 0.0, 0.4 * rng.random(shape))
    return csi.initial_state(model, h=h, a=a, hs=hs, time=40 * DAY)


@pytest.mark.parametrize("snowfall_kind,top_kind", [("number", "seasonal"),
                                                    ("series", "seasonal"),
                                                    ("none", "prescribed")])
def test_layered_step_matches_jax(snowfall_kind, top_kind):
    """layered_thermodynamic_step on random columns, with the snow-surface
    temperature from the secant balance or prescribed: h, ℵ, hs, both top
    temperatures and the diagnostics ≤ 1e-12 relative to JAX in float64
    (measured ≤ 4e-15)."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.model import make_fields as jmake_fields
    from climaseaice_jl_tpu.thermodynamics.slab import layered_thermodynamic_step as jstep

    mj, mt = _snow_models(snowfall_kind, top_kind)
    sj = _columns(csi, mj, seed=2)
    st = state_from_numpy(mt, state_to_numpy(sj))
    out_j = jstep(mj, sj, jmake_fields(mj, sj), 3600.0)
    out_t = tslab.layered_thermodynamic_step(mt, st, tmake_fields(mt, st), 3600.0)
    for name, a, b in zip(("h", "a", "hs", "Tu", "Tus"), out_j[:5], out_t[:5]):
        assert _rel(np.broadcast_to(a, mt.grid.shape), b.numpy()) <= 1e-12, name
    for name in ("mf_ice", "mf_snowfall", "Qtop", "Qbot"):
        assert _rel(out_j[5][name], out_t[5][name].numpy()) <= 1e-12, name
    assert (out_t[2].numpy() >= 0).all()


def test_snow_column_through_entry_points_matches_jax():
    """The seasonal snow column (the Semtner series, temperature-dependent
    albedo, emission, snowfall) on a 4×3 grid: 60 steps of 8 h through
    `cst.step` and then `cst.Simulation(...).run()` to 90 steps, against
    `csi.step`; h, ℵ, hs, Tu and Tus ≤ 1e-12 relative in float64 (measured
    ≤ 2e-15), snow accumulates, and the state carries across `convert`."""
    import jax.numpy as jnp
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.forcing_utils import FieldTimeSeries as JFTS

    def build(lib, fts, mod, **kw):
        grid = lib.RectilinearGrid(size=(4, 3), halo=3, dtype="float64", **kw)
        series = [fts(times=arctic_basin.TIMES, data=tab, cyclical=True)
                  for tab in (arctic_basin.TAB_SHORTWAVE, arctic_basin.TAB_LONGWAVE,
                              arctic_basin.TAB_SENSIBLE, arctic_basin.TAB_LATENT)]

        def solar(grid_, Tu, clock, fields, f):
            if mod is torch:
                albedo = torch.full_like(Tu, 0.64).masked_fill_(Tu < -0.1, 0.75)
            else:
                albedo = mod.where(Tu < -0.1, 0.75, 0.64)
            return f.at_time(clock.time) * (1 - albedo)

        top = (lib.FluxFunction(func=solar, parameters=series[0], top_temperature_dependent=True),
               *series[1:], lib.RadiativeEmission(stefan_boltzmann_constant=5.67e-8 * 1.02))
        return lib.sea_ice_model(grid, snow_thermodynamics=lib.snow_slab_thermodynamics(),
                                 snowfall=3.2e-6, top_heat_flux=top, bottom_heat_flux=-2.0)

    mj = build(csi, JFTS, jnp)
    mt = build(cst, cst.FieldTimeSeries, torch, device="cpu")
    sj = csi.initial_state(mj, h=1.5, a=0.95, hs=0.05)
    st = state_from_numpy(mt, state_to_numpy(sj))
    dt = 8 * 3600.0
    for _ in range(60):
        sj = csi.step(mj, sj, dt)
        st = cst.step(mt, st, dt)
    sim = cst.Simulation(mt, st, dt=dt, stop_iteration=90)
    sim.run()
    for _ in range(30):
        sj = csi.step(mj, sj, dt)
    aj, at = state_to_numpy(sj), state_to_numpy(sim.state)
    for name in ("h", "a", "hs", "Tu", "Tus"):
        assert _rel(aj[name], at[name]) <= 1e-12, (name, _rel(aj[name], at[name]))
    assert at["hs"].max() > 0.05 and int(at["iteration"]) == 90
    back = state_to_numpy(state_from_numpy(mt, at))
    for name in ("hs", "Tus"):
        np.testing.assert_array_equal(back[name], at[name])
