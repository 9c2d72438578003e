"""The ice-ocean coupling of the port (`climaseaice_jl_tpu_torch/coupled.py`)
against the JAX package's (`climaseaice_jl_tpu/coupled.py`).

* `tests/test_coupled.py`'s four tests on the port, with their assertions.
* ``coupled_step`` held to the JAX package's over a few steps within 1e-10
  of each field's largest value, both started from the same numpy arrays
  (:mod:`climaseaice_jl_tpu_torch.convert`): over a ``SlabOcean`` with
  seasonal-style insolation and restoring; over a ``ShallowWaterOcean``
  with αEVP ice in soft ice (P★ = 27.5) on the general path
  (``fused="never"``) in the channel of `examples/melting_over_dynamic_ocean.py`;
  with free drift as the ice's dynamics.
* float32: the port's padded route (the plain version of kernel 2.3)
  against the JAX package's ``fused="always"`` (the Pallas kernel in
  interpret mode) at the kernel bars (u, v ≤ 1e-4; σ, α ≤ 4e-3; h, ℵ, T,
  S, η ≤ 1e-5 of each field's largest value).
* Routing: a float32 αEVP ice model over a shallow-water ocean takes 2.3 in
  the port as in the JAX package, and 2.1's gate refuses it (array
  ``ue``/``ve``), while the same ice model before the drag's refresh
  passes 2.1's gate.
* Checkpoints: an ``IceOceanState`` written by either package's
  ``save_checkpoint`` restores into the other's bit for bit.

The JAX package is imported inside the tests."""

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import coupled as cp
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch.convert import coupled_state_from_numpy, coupled_state_to_numpy
from climaseaice_jl_tpu_torch.dynamics.fused_evp import fused_available
from climaseaice_jl_tpu_torch.dynamics.fused_evp_padded import padded_fused_available
from climaseaice_jl_tpu_torch.ocean import ShallowWaterOcean

km, day = 1000.0, 86400.0
TIGHT = 1e-10
KERNEL_BARS = {"ice/u": 1e-4, "ice/v": 1e-4, "ice/sig11": 4e-3, "ice/sig22": 4e-3,
               "ice/sig12": 4e-3, "ice/alpha": 4e-3, "ice/h": 1e-5, "ice/a": 1e-5,
               "T_ocean": 1e-5, "S_ocean": 1e-5, "eta": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as the fixed-tile files run (six test workers share
    the machine's cores in the tier-1 run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax():
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu import coupled as cpj
    from climaseaice_jl_tpu.ocean import ShallowWaterOcean as SWj
    return csi, cpj, SWj


def _rel(ref, x):
    ref, x = np.asarray(ref, np.float64), np.asarray(x, np.float64)
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)


def _assert_close(sj, st, bars, default=None):
    """Every field of the two coupled states within its bar (``bars`` by
    key, else ``default``) relative to the JAX field's largest value."""
    aj, at = coupled_state_to_numpy(sj), coupled_state_to_numpy(st)
    assert sorted(aj) == sorted(at)
    for key in aj:
        bar = bars.get(key, default)
        if bar is None:
            continue
        assert np.isfinite(at[key]).all(), key
        assert _rel(aj[key], at[key]) <= bar, (key, _rel(aj[key], at[key]), bar)


# --- tests/test_coupled.py on the port ---------------------------------------------------------

def _build(T0, S0=30.0, insolation=0.0, h0=0.0, a0=0.0):
    grid = cst.RectilinearGrid(size=(4, 4), device="cpu")
    ice = cst.sea_ice_model(grid, top_heat_flux=0.0, bottom_heat_flux=0.0,
                            ice_salinity=5.0, timestepper="ForwardEuler")
    iom = cp.IceOceanModel(ice=ice, ocean=cp.SlabOcean(mixed_layer_depth=20.0,
                                                       solar_insolation=insolation))
    return iom, cp.initial_state(iom, T_ocean=T0, S_ocean=S0, h=h0, a=a0)


def _steps(iom, state, dt, n):
    for _ in range(n):
        state = cp.coupled_step(iom, state, dt)
    return state


def test_supercooled_ocean_forms_frazil_ice():
    """Ocean below Tₘ(S): frazil heat into the ice, the ice grows, the ocean
    is reset to Tₘ (up to the open water's radiative cooling after it)."""
    iom, state = _build(T0=-3.0, S0=30.0)
    state = _steps(iom, state, 600.0, 10)
    g = iom.ice.grid
    h, T, S = g.interior(state.ice.h), g.interior(state.T_ocean), g.interior(state.S_ocean)
    Tm = cst.melting_temperature(iom.ice.phase_transitions.liquidus, S)
    assert (h > 0).all()
    np.testing.assert_allclose(T.numpy(), Tm.numpy(), atol=1e-3)
    assert (T <= Tm + 1e-9).all()
    assert state.u_ocean is None and state.eta is None


def test_warm_ocean_melts_ice():
    iom, state = _build(T0=2.0, S0=30.0, h0=1.0, a0=1.0)
    g = iom.ice.grid
    h_start = float(state.ice.h[g.Hx, g.Hy])
    state = _steps(iom, state, 600.0, 20)
    assert g.interior(state.ice.h).max() < h_start


def test_brine_rejection_raises_salinity():
    """Freezing rejects brine (Sᵢ < Sₒ): the ocean's salinity rises."""
    iom, state = _build(T0=-3.0, S0=30.0)
    g = iom.ice.grid
    S0 = float(state.S_ocean[g.Hx, g.Hy])
    state = _steps(iom, state, 600.0, 10)
    assert float(state.S_ocean[g.Hx, g.Hy]) > S0


def test_open_water_radiative_cooling():
    """An ice-free warm ocean cools through the air-sea flux."""
    iom, state = _build(T0=5.0, S0=30.0)
    g = iom.ice.grid
    state = _steps(iom, state, 600.0, 10)
    assert float(state.T_ocean[g.Hx, g.Hy]) < 5.0


@pytest.mark.parametrize("snow", [False, True], ids=["bare", "snow"])
def test_bottom_heat_flux_reaches_the_ice_unchanged(snow):
    """Last step's padded ``Q_bottom`` is the ice step's bottom heat flux as
    it is, bit for bit (the ice's ``Qbot``), through the bare-ice and the
    layered snow-on-ice column."""
    grid = cst.RectilinearGrid(size=(4, 4), device="cpu")
    ice = cst.sea_ice_model(grid, top_heat_flux=(cst.RadiativeEmission(),),
                            bottom_heat_flux=0.0, ice_salinity=5.0, timestepper="ForwardEuler",
                            snow_thermodynamics=cst.snow_slab_thermodynamics() if snow else None)
    iom = cp.IceOceanModel(ice=ice, ocean=cp.SlabOcean())
    rng = np.random.default_rng(4)
    state = cp.initial_state(iom, T_ocean=rng.uniform(-3.0, 1.0, (4, 4)), h=0.8, a=0.9,
                             **({"hs": 0.1} if snow else {}))
    for k in range(3):
        nxt = cp.coupled_step(iom, state, 3600.0)
        assert torch.equal(nxt.ice.Qbot, state.Q_bottom), k
        state = nxt
    assert state.ice.Qbot.abs().max() > 0


# --- coupled_step against the JAX package -----------------------------------------------------

def _slab(lib, cp_, **grid_kw):
    grid = lib.RectilinearGrid(size=(8, 6), **grid_kw)
    ice = lib.sea_ice_model(grid, top_heat_flux=(lib.RadiativeEmission(), -30.0),
                            bottom_heat_flux=0.0, ice_salinity=5.0, timestepper="ForwardEuler")
    ocean = cp_.SlabOcean(mixed_layer_depth=30.0, solar_insolation=-120.0,
                          temperature_restoring_rate=1.0 / (30 * day),
                          temperature_restoring_target=-1.0)
    return cp_.IceOceanModel(ice=ice, ocean=ocean)


# the ice-bath flux is ρcH/Δt (≈ 5.7e3 to 1.0e5 W m⁻² K⁻¹ here) times T − Tₘ,
# a difference of nearly equal temperatures, and the mass flux a difference
# of volumes over Δt: the roundoff of T and h comes out amplified in them
FLUX_KEYS = ("Q_bottom", "ice/Qbot", "ice/Qtop", "ice/mf_ice", "ice/mf_snow", "ice/mf_snowfall")
FLUX_BAR = 1e-8


def _parity_bars(bar=TIGHT):
    return {key: FLUX_BAR for key in FLUX_KEYS}, bar


SLAB_CASES = {"frazil": dict(T0=-3.0), "melt": dict(T0=2.0, h0=1.0, a0=1.0),
              "radiative": dict(T0=5.0), "insolation": dict(T0=-3.0, insolation=-200.0)}


def _slab_case(lib, cp_, T0, S0=30.0, insolation=0.0, h0=0.0, a0=0.0, **grid_kw):
    grid = lib.RectilinearGrid(size=(4, 4), **grid_kw)
    ice = lib.sea_ice_model(grid, top_heat_flux=0.0, bottom_heat_flux=0.0,
                            ice_salinity=5.0, timestepper="ForwardEuler")
    iom = cp_.IceOceanModel(ice=ice, ocean=cp_.SlabOcean(mixed_layer_depth=20.0,
                                                         solar_insolation=insolation))
    return iom, cp_.initial_state(iom, T_ocean=T0, S_ocean=S0, h=h0, a=a0)


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_slab_coupled_step_matches_jax(case):
    """`tests/test_coupled.py`'s four configurations (and the frazil one
    under −200 W m⁻² of insolation), 40 steps of 600 s: the state within
    1e-10 of the JAX run at every step, the ice-bath and mass fluxes within
    ``FLUX_BAR``."""
    csi, cpj, _ = _jax()
    iom_j, sj = _slab_case(csi, cpj, **SLAB_CASES[case])
    iom_t, _ = _slab_case(cst, cp, device="cpu", **SLAB_CASES[case])
    st = coupled_state_from_numpy(iom_t, coupled_state_to_numpy(sj))
    for _ in range(40):
        sj = cpj.coupled_step(iom_j, sj, 600.0)
        st = cp.coupled_step(iom_t, st, 600.0)
        _assert_close(sj, st, *_parity_bars())


def _slab(lib, cp_, **grid_kw):
    grid = lib.RectilinearGrid(size=(8, 6), **grid_kw)
    ice = lib.sea_ice_model(grid, top_heat_flux=(lib.RadiativeEmission(), -30.0),
                            bottom_heat_flux=0.0, ice_salinity=5.0, timestepper="ForwardEuler")
    ocean = cp_.SlabOcean(mixed_layer_depth=30.0, solar_insolation=-120.0,
                          temperature_restoring_rate=1.0 / (30 * day),
                          temperature_restoring_target=-1.0)
    return cp_.IceOceanModel(ice=ice, ocean=ocean)


def test_seeded_slab_parts_from_jax_at_the_consolidation_threshold():
    """A known divergence (`ROADMAP.md` §3): seeded h, ℵ and SST over a
    SlabOcean with radiative emission, insolation and restoring, steps of
    6 h.  Frazil ice forms at exactly h = hc, and the consolidation switch
    h ≥ hc of the column step turns a one-ulp difference of h there into a
    different step.  The port and the JAX package agree within the parity
    bars at every step before the first cell whose h lies on the two sides
    of hc in the two runs, and part after it."""
    csi, cpj, _ = _jax()
    iom_j = _slab(csi, cpj)
    iom_t = _slab(cst, cp, device="cpu")
    rng = np.random.default_rng(3)
    shape = (8, 6)
    sj = cpj.initial_state(iom_j, T_ocean=rng.uniform(-3.0, 1.0, shape), S_ocean=30.0,
                           h=rng.uniform(0.0, 1.5, shape), a=rng.uniform(0.0, 1.0, shape))
    st = coupled_state_from_numpy(iom_t, coupled_state_to_numpy(sj))
    hc = iom_t.ice.ice_consolidation_thickness
    for k in range(10):
        hj, ht = np.asarray(sj.ice.h), st.ice.h.numpy()
        if ((hj < hc) != (ht < hc)).any():
            break
        sj = cpj.coupled_step(iom_j, sj, 6 * 3600.0)
        st = cp.coupled_step(iom_t, st, 6 * 3600.0)
        _assert_close(sj, st, *_parity_bars())
    else:
        pytest.fail("no cell straddled hc in 10 steps: the divergence of ROADMAP.md §3 is gone")
    assert k >= 2
    straddle = (hj < hc) != (ht < hc)
    assert np.abs(hj[straddle] - hc).max() <= 4 * np.spacing(hc)
    sj = cpj.coupled_step(iom_j, sj, 6 * 3600.0)
    st = cp.coupled_step(iom_t, st, 6 * 3600.0)
    assert _rel(np.asarray(sj.ice.h), st.ice.h.numpy()) > 1e-6


def _channel(lib, cp_, SW, dynamics="evp", N=16, dtype="float64", fused="never", substeps=10,
             topology=("periodic", "bounded"), size=None, **grid_kw):
    """`examples/melting_over_dynamic_ocean.py:build`'s channel at N² (or
    ``size``), soft ice (P★ = 27.5), ``substeps`` EVP substeps and 12 ocean
    substeps, WENO-5, RK3; with ``dynamics="free_drift"`` free drift and no
    advection."""
    grid = lib.RectilinearGrid(size=size or (N, N), x=(-50 * km, 50 * km),
                               y=(-50 * km, 50 * km),
                               topology=topology, dtype=dtype, halo=4, **grid_kw)
    if dynamics == "evp":
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
            coriolis=lib.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.05, "v": 0.0},
            bottom_momentum_stress=lib.SemiImplicitStress(),
            solver=lib.SplitExplicitSolver(substeps=substeps, fused=fused))
        kw = dict(advection=lib.WENO(order=5), timestepper="SplitRungeKutta3")
    else:
        dyn = lib.StressBalanceFreeDrift(top_momentum_stress={"u": 0.05, "v": 0.02},
                                         bottom_momentum_stress=lib.SemiImplicitStress())
        kw = dict(timestepper="ForwardEuler")
    ice = lib.sea_ice_model(grid, dynamics=dyn, top_heat_flux=(lib.RadiativeEmission(),),
                            bottom_heat_flux=0.0, ice_salinity=5.0, **kw)
    ocean = SW(depth=50.0, coriolis=lib.FPlane(f=1.4e-4), wind_stress_x=0.05, substeps=12,
               tracer_diffusivity=20.0)
    return cp_.IceOceanModel(ice=ice, ocean=ocean)


def _channel_state(iom_j, cpj, seed, ice_velocity=True):
    """The example's warm strip with seeded ice, ice velocities and ocean
    velocities and elevation."""
    g = iom_j.ice.grid
    rng = np.random.default_rng(seed)
    shape = (g.Nx, g.Ny)
    y = (np.arange(g.Ny) + 0.5) * (100 * km / g.Ny) - 50 * km
    T0 = -1.5 + 2.5 * np.exp(-(y[None, :] / (15 * km)) ** 2) * np.ones(shape)
    ice = dict(h=rng.uniform(0.5, 1.5, shape), a=rng.uniform(0.7, 1.0, shape))
    if ice_velocity:
        ice.update(u=0.03 * rng.standard_normal(shape), v=0.03 * rng.standard_normal(shape))
    return cpj.initial_state(iom_j, T_ocean=T0, S_ocean=30.0,
                             u_ocean=0.02 * rng.standard_normal(shape),
                             v_ocean=0.02 * rng.standard_normal(shape),
                             eta=0.05 * rng.standard_normal(shape), **ice)


@pytest.fixture(scope="module")
def evp_channel_run():
    """3 coupled steps of 20 min of the soft-ice αEVP channel in both
    packages, from the same seeded state: (JAX model, JAX state, port model,
    port state)."""
    csi, cpj, SWj = _jax()
    iom_j = _channel(csi, cpj, SWj)
    iom_t = _channel(cst, cp, ShallowWaterOcean, device="cpu")
    sj = _channel_state(iom_j, cpj, seed=5)
    st = coupled_state_from_numpy(iom_t, coupled_state_to_numpy(sj))
    for _ in range(3):
        sj = cpj.coupled_step(iom_j, sj, 1200.0)
        st = cp.coupled_step(iom_t, st, 1200.0)
    return iom_j, sj, iom_t, st


def test_dynamic_ocean_coupled_step_matches_jax(evp_channel_run):
    """Over a ShallowWaterOcean: soft-ice αEVP on the general path
    (``fused="never"``) in the periodic × bounded channel, 16², 10 EVP and
    12 ocean substeps, 3 RK3 steps: every field within 1e-10 of the JAX
    run; the ice and the ocean still at rest on the walls."""
    _, sj, iom_t, st = evp_channel_run
    _assert_close(sj, st, *_parity_bars())
    g, masks = iom_t.ice.grid, iom_t.ice.masks
    for vel, per in ((st.ice.u, masks.per_fc), (st.ice.v, masks.per_cf),
                     (st.u_ocean, masks.per_fc), (st.v_ocean, masks.per_cf)):
        assert (g.interior(vel)[g.interior(per)] == 0).all()


def test_free_drift_coupled_step_matches_jax():
    """Free drift as the ice's dynamics (without advection: the JAX package
    cannot step free drift with an advection scheme, `ROADMAP.md` §3) over
    the channel's shallow-water ocean, 3 steps of 20 min: every field within
    1e-10 of the JAX run, the fluxes within ``FLUX_BAR``.  (On the fourth the
    warm strip melts a cell through hc: the divergence of
    :func:`test_seeded_slab_parts_from_jax_at_the_consolidation_threshold`.)"""
    csi, cpj, SWj = _jax()
    iom_j = _channel(csi, cpj, SWj, dynamics="free_drift")
    iom_t = _channel(cst, cp, ShallowWaterOcean, dynamics="free_drift", device="cpu")
    sj = _channel_state(iom_j, cpj, seed=8, ice_velocity=False)
    st = coupled_state_from_numpy(iom_t, coupled_state_to_numpy(sj))
    for _ in range(3):
        sj = cpj.coupled_step(iom_j, sj, 1200.0)
        st = cp.coupled_step(iom_t, st, 1200.0)
        _assert_close(sj, st, *_parity_bars())
    assert st.ice.u.abs().max() > 1e-3


def test_float32_padded_route_matches_pallas(monkeypatch):
    """float32, 32² channel, 10 EVP substeps, soft ice with seeded
    velocities, 2 coupled steps: the port's padded route (the plain version
    of kernel 2.3, 3 calls a step) against the JAX package's
    ``fused="always"`` (the Pallas kernel in interpret mode) at the kernel
    bars.  The JAX step runs uncompiled (``_coupled_step``): XLA's compiled
    float32 step parts from it by 8.8e-6 in the SST and 7.1e-6 in the
    salinity after one step (the port: 7.4e-8 and 6.4e-8), and two compiled
    steps put the SST 1.3e-5 from the port, past the kernel bar."""
    csi, cpj, SWj = _jax()
    iom_j = _channel(csi, cpj, SWj, N=32, dtype="float32", fused="always")
    iom_t = _channel(cst, cp, ShallowWaterOcean, N=32, dtype="float32", fused="always",
                     device="cpu")
    sj = _channel_state(iom_j, cpj, seed=11)
    st = coupled_state_from_numpy(iom_t, coupled_state_to_numpy(sj))
    routes = []
    padded = tmodel.padded_fused_momentum_step

    def spy(*args):
        routes.append("padded")
        return padded(*args)

    monkeypatch.setattr(tmodel, "padded_fused_momentum_step", spy)
    for _ in range(2):
        sj = cpj._coupled_step(iom_j, sj, 1200.0)
        st = cp.coupled_step(iom_t, st, 1200.0)
    assert routes == ["padded"] * 6
    assert st.ice.u.dtype == torch.float32
    _assert_close(sj, st, KERNEL_BARS)


@pytest.mark.parametrize("topology", [("periodic", "periodic"), ("periodic", "bounded")],
                         ids=["periodic", "channel"])
def test_dynamic_ocean_routes_to_padded_kernel(topology):
    """float32 αEVP ice over a shallow-water ocean: the ice model each
    coupled step runs (its drag refreshed with the ocean's u, v arrays) is
    refused by 2.1's gate and taken by 2.3's, in the port as in the JAX
    package; on the doubly periodic grid the model before the refresh
    (scalar uₑ, vₑ) passes 2.1's gate in both.  16×128: the JAX gate of
    2.1 needs Nx % 8 = Ny % 128 = 0."""
    csi, cpj, SWj = _jax()
    from climaseaice_jl_tpu.dynamics import pallas_evp, pallas_evp_padded
    kw = dict(size=(16, 128), dtype="float32", fused="auto", topology=topology)
    iom_j = _channel(csi, cpj, SWj, **kw)
    iom_t = _channel(cst, cp, ShallowWaterOcean, **kw, device="cpu")
    sj = _channel_state(iom_j, cpj, seed=2)
    st = coupled_state_from_numpy(iom_t, coupled_state_to_numpy(sj))
    # the drag's refresh of `climaseaice_jl_tpu/coupled.py:517-526`
    dyn_j = iom_j.ice.dynamics
    refreshed_j = iom_j.ice.evolve(bottom_heat_flux=sj.Q_bottom, dynamics=dyn_j.evolve(
        bottom_momentum_stress=dyn_j.bottom_momentum_stress.evolve(
            ue=sj.u_ocean, ve=sj.v_ocean, rho_e=iom_j.ocean.density,
            Cd=iom_j.ocean.ice_ocean_drag)))
    refreshed_t = cp.ice_model_for_step(iom_t, st)
    stress = refreshed_t.dynamics.bottom_momentum_stress
    assert stress.ue is st.u_ocean and stress.ve is st.v_ocean
    assert stress.rho_e == 1024.0 and stress.Cd == 5.5e-3
    assert not pallas_evp.fused_available(refreshed_j) and not fused_available(refreshed_t)
    assert pallas_evp_padded.padded_fused_available(refreshed_j)
    assert padded_fused_available(refreshed_t)
    periodic = topology == ("periodic", "periodic")
    assert pallas_evp.fused_available(iom_j.ice) == periodic == fused_available(iom_t.ice)


def test_coupled_checkpoints_move_both_ways_between_the_packages(evp_channel_run, tmp_path):
    """The channel's coupled state after 3 steps: the JAX package's
    ``save_checkpoint`` and the port's write the same keys (the JAX
    package's pytree paths: ``ice/h``, ``ice/clock/time``, ``T_ocean``,
    ``eta``, ``clock/time``, ...), dtypes and bits; each file restores into
    the other package's template state bit for bit."""
    from climaseaice_jl_tpu.io import (save_checkpoint as jax_save,
                                       restore_state as jax_restore)
    from climaseaice_jl_tpu_torch.io import load_checkpoint, restore_state, save_checkpoint
    _, cpj, _ = _jax()
    iom_j, sj, iom_t, _ = evp_channel_run
    st = coupled_state_from_numpy(iom_t, coupled_state_to_numpy(sj))
    jax_file = jax_save(str(tmp_path / "jax.npz"), sj)
    port_file = save_checkpoint(str(tmp_path / "port.npz"), st)
    a, b = load_checkpoint(jax_file), load_checkpoint(port_file)
    assert sorted(a) == sorted(b)
    assert {"ice/h", "ice/sig12", "ice/clock/time", "T_ocean", "Q_bottom", "u_ocean", "eta",
            "clock/time", "clock/iteration"} <= set(a)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key

    into_port = restore_state(cp.initial_state(iom_t, h=0.5, a=0.5), jax_file)
    into_jax = jax_restore(cpj.initial_state(iom_j, h=0.5, a=0.5), port_file)
    ref = coupled_state_to_numpy(sj)
    for restored in (into_port, into_jax):
        got = coupled_state_to_numpy(restored)
        assert sorted(got) == sorted(ref)
        for key, q in got.items():
            assert q.dtype == ref[key].dtype and np.array_equal(q, ref[key]), key
    # and the restored port state steps on as the original does
    step_a = cp.coupled_step(iom_t, into_port, 1200.0)
    step_b = cp.coupled_step(iom_t, st, 1200.0)
    for key, q in coupled_state_to_numpy(step_a).items():
        assert np.array_equal(q, coupled_state_to_numpy(step_b)[key]), key
