"""The momentum physics beyond the αEVP split-explicit step, in the port vs
the JAX package: ``ViscousRheology`` (scalar, field and ν(x, y, t)),
``ExplicitSolver``, ``BetaPlane``, free drift, user forcing, the public
API (``set_fields``, ``cell_advection_timescale``, ``ice_mass_cc``), and the
fused gates that refuse all of these.

Inputs come from numpy with a seed and both packages run in float64 on the
CPU; the port's state is compared with the JAX state through
``convert.state_to_numpy``.  Bars: 1e-10 of each field's largest value for
the explicit, viscous and column cases; at the default P★ the αEVP
split-explicit cases take `ROADMAP.md`'s default-P★ bars (h, ℵ ≤ 1e-6;
u, v ≤ 5e-2), since a relative perturbation of 1e-14 grows there by orders
of magnitude.  The JAX package's own assertions are kept beside each
comparison (`tests/test_time_stepping.py:35-130`,
`tests/test_immersed_bcs.py:118-166`,
`tests/test_forcing_and_pickup.py:10-45`).

The ``cuda`` tests hold the card against the CPU on the three builds of
``chip_smoke.py`` phase 33 (the viscous explicit beta-plane, the forced
αEVP flagship and free drift as the whole dynamics, at 128²)."""

import types
import warnings

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch.dynamics import (fused_evp, fused_evp_curvilinear,
                                               fused_evp_padded, fused_evp_tiled_curvilinear,
                                               fused_evp_tiled_padded)
from climaseaice_jl_tpu_torch.dynamics.fixed_tile_advection import \
    fixed_tile_advection_available
from climaseaice_jl_tpu_torch.parallel.stepper import _local_grid

km = 1000.0
TIGHT = 1e-10
DEFAULT_P_STAR_BARS = {"h": 1e-6, "a": 1e-6, "u": 5e-2, "v": 5e-2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as the fixed-tile files run: the tier-1 run puts
    six test workers on the machine's cores, where PyTorch's OpenMP pool
    spins."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _csi():
    import climaseaice_jl_tpu as csi
    return csi


def _dev(lib, device="cpu"):
    return {"device": device} if lib is cst else {}


def _rel(x, y):
    """max |y − x| over the largest |x| (the absolute distance where x is 0)."""
    x, y = np.asarray(x), np.asarray(y)
    scale = np.abs(x).max()
    return np.abs(y - x).max() / scale if scale else np.abs(y - x).max()


def _assert_close(sj, st, bars):
    """Each named field of the two states within its bar; all finite."""
    aj, at = state_to_numpy(sj), state_to_numpy(st)
    for name, bar in bars.items():
        assert np.isfinite(at[name]).all(), name
        rel = _rel(aj[name], at[name])
        assert rel <= bar, f"{name}: {rel:.3e} > {bar:.0e}"


def _seeded(grid_shape, seed):
    rng = np.random.default_rng(seed)
    return dict(h=1.0 + 0.1 * rng.random(grid_shape), a=0.9 + 0.1 * rng.random(grid_shape),
                u=0.05 * rng.standard_normal(grid_shape),
                v=0.05 * rng.standard_normal(grid_shape))


def _pair(build, state_kw):
    """(JAX model, JAX state, port model, port state) from ``build(lib,
    **grid_kw)``; the port's state is the JAX state carried across."""
    csi = _csi()
    mj = build(csi)
    mt = build(cst, **_dev(cst))
    sj = csi.initial_state(mj, **state_kw)
    return mj, sj, mt, state_from_numpy(mt, state_to_numpy(sj))


def _steps(mj, sj, mt, st, dt, n):
    csi = _csi()
    for _ in range(n):
        sj = csi.step(mj, sj, dt)
        st = cst.step(mt, st, dt)
    return sj, st


# --- the rheology × advection × Coriolis × solver matrix -----------------------------

def _rheology(lib, name):
    return lib.ElastoViscoPlasticRheology() if name == "EVP" else lib.ViscousRheology(nu=1000.0)


def _advection(lib, name):
    return lib.WENO(order=5) if name == "WENO5" else lib.UpwindBiased(order=5)


def _coriolis(lib, name):
    return {"noF": None, "FPlane": lib.FPlane(f=1e-4),
            "BetaPlane": lib.BetaPlane(f0=1e-4, beta=1e-11)}[name]


def _solver(lib, name):
    return lib.ExplicitSolver() if name == "Explicit" else lib.SplitExplicitSolver(substeps=10)


@pytest.mark.parametrize("rheology", ["EVP", "Viscous"])
@pytest.mark.parametrize("advection", ["WENO5", "UB5"])
@pytest.mark.parametrize("coriolis", ["noF", "FPlane", "BetaPlane"])
@pytest.mark.parametrize("solver", ["Explicit", "SplitExplicit"])
def test_stepping_matrix(rheology, advection, coriolis, solver):
    """`test_time_stepping.py:45-54` with seeded h, ℵ, u, v and a top
    stress: one RK3 step of 1.1 s on a bounded 10×10 grid with slab
    thermodynamics advances the clock, stays finite, and equals the JAX
    step (1e-10; the αEVP split-explicit cases at the default-P★ bars)."""
    def build(lib, **kw):
        grid = lib.RectilinearGrid(size=(10, 10), x=(0, 20 * km), y=(0, 20 * km),
                                   topology=("bounded", "bounded"), **kw)
        dyn = lib.SeaIceMomentumEquation(
            rheology=_rheology(lib, rheology), coriolis=_coriolis(lib, coriolis),
            top_momentum_stress={"u": 0.05, "v": 0.02}, solver=_solver(lib, solver))
        return lib.sea_ice_model(grid, dynamics=dyn,
                                 ice_thermodynamics=lib.sea_ice_slab_thermodynamics(),
                                 advection=_advection(lib, advection))

    mj, sj, mt, st = _pair(build, _seeded((10, 10), 0))
    sj, st = _steps(mj, sj, mt, st, 1.1, 1)
    assert int(st.clock.iteration) == 1 and float(st.clock.time) == pytest.approx(1.1)
    assert st.h.isfinite().all() and st.u.isfinite().all()
    chaotic = rheology == "EVP" and solver == "SplitExplicit"
    _assert_close(sj, st, DEFAULT_P_STAR_BARS if chaotic
                  else {"h": TIGHT, "a": TIGHT, "u": TIGHT, "v": TIGHT})


@pytest.mark.parametrize("solver", ["Explicit", "SplitExplicit"])
def test_semi_implicit_ocean_drag(solver):
    """`test_time_stepping.py:70-90`: ocean drag accelerates resting ice
    toward uₒ monotonically without overshoot, 20 steps; and the JAX run's
    velocities (1e-10: uniform ice stays uniform, so σ stays 0 and the
    αEVP loop is not chaotic here)."""
    def build(lib, **kw):
        grid = lib.RectilinearGrid(size=(8, 8), x=(0, 10_000), y=(0, 10_000),
                                   topology=("periodic", "periodic"), **kw)
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ElastoViscoPlasticRheology(),
            bottom_momentum_stress=lib.SemiImplicitStress(ue=0.1),
            solver=_solver(lib, solver))
        return lib.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None)

    mj, sj, mt, st = _pair(build, dict(h=1, a=1, u=0, v=0))
    sj, st = _steps(mj, sj, mt, st, 60.0, 20)
    u = mt.grid.interior(st.u)
    assert u.isfinite().all() and u.max() > 0 and u.max() <= 0.1 + 1e-12
    _assert_close(sj, st, {"u": TIGHT, "v": TIGHT, "h": TIGHT})


def test_free_drift_only_dynamics():
    """`test_time_stepping.py:93-103`: free drift as the whole dynamics with
    zero top stress moves the ice with the ocean, u = 0.2; as in JAX."""
    def build(lib, **kw):
        grid = lib.RectilinearGrid(size=(8, 8), **kw)
        fd = lib.StressBalanceFreeDrift(top_momentum_stress=0.0,
                                        bottom_momentum_stress=lib.SemiImplicitStress(ue=0.2))
        return lib.sea_ice_model(grid, dynamics=fd, ice_thermodynamics=None)

    mj, sj, mt, st = _pair(build, dict(h=1, a=1))
    sj, st = _steps(mj, sj, mt, st, 60.0, 1)
    np.testing.assert_allclose(mt.grid.interior(st.u).numpy(), 0.2)
    _assert_close(sj, st, {"u": TIGHT, "v": TIGHT, "h": TIGHT, "a": TIGHT})


@pytest.mark.parametrize("solver", ["Explicit", "SplitExplicit"])
def test_free_drift_of_marginal_ice(solver):
    """A ``StressBalanceFreeDrift`` inside ``SeaIceMomentumEquation``: thin
    ice (mass below the dynamics' minimum) takes the closed-form velocity
    under a wind and ocean drag, thick ice the dynamic one; as in JAX
    (1e-10, viscous rheology)."""
    def build(lib, **kw):
        grid = lib.RectilinearGrid(size=(12, 12), x=(0, 24 * km), y=(0, 24 * km),
                                   topology=("periodic", "bounded"), **kw)
        fd = lib.StressBalanceFreeDrift(top_momentum_stress={"u": 0.05, "v": -0.02},
                                        bottom_momentum_stress=lib.SemiImplicitStress())
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ViscousRheology(nu=500.0), coriolis=lib.FPlane(f=1.4e-4),
            top_momentum_stress={"u": 0.05, "v": -0.02},
            bottom_momentum_stress=lib.SemiImplicitStress(), free_drift=fd,
            minimum_mass=200.0, solver=_solver(lib, solver))
        return lib.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                                 advection=lib.WENO(order=5))

    rng = np.random.default_rng(1)
    h = np.where(rng.random((12, 12)) < 0.5, 0.1, 1.0)
    mj, sj, mt, st = _pair(build, dict(h=h, a=1.0))
    sj, st = _steps(mj, sj, mt, st, 300.0, 3)
    assert mt.grid.interior(st.u).abs().max() > 0
    _assert_close(sj, st, {"u": TIGHT, "v": TIGHT, "h": TIGHT, "a": TIGHT})


def test_beta_plane_on_latitude_longitude_grid():
    """`test_time_stepping.py:106-130`: EVP + WENO-5 + slab thermodynamics
    with a BetaPlane on the 24×16 latitude-longitude grid, 5 steps of 300 s:
    finite and physical, and the JAX run at the default-P★ bars."""
    def build(lib, **kw):
        grid = lib.LatitudeLongitudeGrid(size=(24, 16), longitude=(0, 360),
                                         latitude=(60, 84), topology=("periodic", "bounded"),
                                         halo=4, **kw)
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ElastoViscoPlasticRheology(),
            coriolis=lib.BetaPlane(f0=1.4e-4, beta=1e-11),
            top_momentum_stress={"u": 0.05, "v": 0.0},
            bottom_momentum_stress=lib.SemiImplicitStress(),
            solver=lib.SplitExplicitSolver(substeps=10))
        return lib.sea_ice_model(grid, dynamics=dyn,
                                 ice_thermodynamics=lib.sea_ice_slab_thermodynamics(),
                                 top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                                 advection=lib.WENO(order=5))

    mj, sj, mt, st = _pair(build, dict(h=1.0, a=1.0))
    sj, st = _steps(mj, sj, mt, st, 300.0, 5)
    I = mt.grid.interior
    for name in ("u", "v", "h", "a", "Tu"):
        assert I(getattr(st, name)).isfinite().all(), name
    assert I(st.u).abs().max() < 1.0
    _assert_close(sj, st, DEFAULT_P_STAR_BARS)


def test_beta_plane_coriolis_terms():
    """x_f_cross_U and y_f_cross_U of a BetaPlane with y₀ ≠ 0 on seeded
    velocities: f = f₀ + β (y − y₀) along each row, as in JAX (1e-14)."""
    from climaseaice_jl_tpu.dynamics import coriolis as jcor
    from climaseaice_jl_tpu_torch.dynamics import coriolis as tcor
    csi = _csi()
    gj = csi.RectilinearGrid(size=(12, 20), x=(0, 1e5), y=(-4e5, 4e5))
    gt = cst.RectilinearGrid(size=(12, 20), x=(0, 1e5), y=(-4e5, 4e5), device="cpu")
    rng = np.random.default_rng(2)
    u, v = (rng.standard_normal(gj.shape) for _ in range(2))
    for j_fn, t_fn in ((jcor.x_f_cross_U, tcor.x_f_cross_U), (jcor.y_f_cross_U, tcor.y_f_cross_U)):
        rj = j_fn(csi.BetaPlane(f0=1.3e-4, beta=2e-11, y0=1e5), gj, u, v)
        rt = t_fn(cst.BetaPlane(f0=1.3e-4, beta=2e-11, y0=1e5), gt,
                  torch.tensor(u), torch.tensor(v))
        assert _rel(rj, rt.numpy()) <= 1e-14


# --- ν(x, y, t), a viscosity field, and the viscous explicit step -----------------------

def _viscous_box(nu, advection=True):
    def build(lib, **kw):
        grid = lib.RectilinearGrid(size=(24, 24), x=(0, 48 * km), y=(0, 48 * km), halo=4, **kw)
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ViscousRheology(nu=nu(lib) if callable(nu) else nu),
            top_momentum_stress={"u": 0.05, "v": 0.02},
            bottom_momentum_stress=lib.SemiImplicitStress(),
            solver=lib.ExplicitSolver())
        return lib.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                                 advection=lib.WENO(order=5) if advection else None,
                                 timestepper="ForwardEuler")
    return build


def _exp(lib):
    return torch.exp if lib is cst else _csi_jnp().exp


def _csi_jnp():
    import jax.numpy as jnp
    return jnp


def test_function_viscosity_matches_field_viscosity():
    """`test_immersed_bcs.py:118-140`: ν(x, y, t) = 500 equals the constant
    500 (rtol 1e-12), and the function run equals JAX's (1e-10)."""
    def nu_const_fn(lib):
        return lambda x, y, t: 500.0 + 0.0 * x + 0.0 * y

    _, _, m_ct, s_ct = _pair(_viscous_box(500.0), dict(h=1.0, a=1.0))
    mj, sj, mt, st = _pair(_viscous_box(nu_const_fn), dict(h=1.0, a=1.0))
    sj, st = _steps(mj, sj, mt, st, 300.0, 5)
    for _ in range(5):
        s_ct = cst.step(m_ct, s_ct, 300.0)
    I = mt.grid.interior
    np.testing.assert_allclose(I(st.u).numpy(), I(s_ct.u).numpy(), rtol=1e-12, atol=1e-15)
    _assert_close(sj, st, {"u": TIGHT, "v": TIGHT, "h": TIGHT})


@pytest.mark.parametrize("kind", ["gaussian", "gaussian-in-time", "field"])
def test_spatially_varying_viscosity(kind):
    """`test_immersed_bcs.py:143-166`: a Gaussian ν(x, y), one that also
    grows with t, and a seeded centred viscosity field (faces take its
    4-point average), 5 explicit steps: finite, |u| < 1 m/s, and the JAX
    run's state (1e-10)."""
    def nu_fn(lib):
        exp = _exp(lib)
        grow = kind == "gaussian-in-time"
        return lambda x, y, t: ((200.0 + 300.0 * exp(-((x - 24 * km) ** 2 + (y - 24 * km) ** 2)
                                                      / (12 * km) ** 2))
                                * (1.0 + t / 3000.0 if grow else 1.0))

    if kind == "field":
        rng = np.random.default_rng(3)
        nu = 200.0 + 300.0 * rng.random((32, 32))   # padded: 24 + 2·4
    else:
        nu = nu_fn
    mj, sj, mt, st = _pair(_viscous_box(nu), dict(h=1.0, a=1.0))
    sj, st = _steps(mj, sj, mt, st, 300.0, 5)
    I = mt.grid.interior
    assert I(st.u).isfinite().all() and I(st.u).abs().max() < 1.0
    _assert_close(sj, st, {"u": TIGHT, "v": TIGHT, "h": TIGHT})


# --- user forcing ------------------------------------------------------------------------

def test_thickness_forcing():
    """`test_forcing_and_pickup.py:10-25`: a constant h forcing grows the ice
    linearly (no thermodynamics, centred advection, Forward Euler), rel
    1e-12; as in JAX."""
    rate = 1e-6

    def build(lib, **kw):
        return lib.sea_ice_model(lib.RectilinearGrid(size=(4, 4), **kw),
                                 ice_thermodynamics=None, advection=lib.Centered(order=2),
                                 timestepper="ForwardEuler",
                                 forcing={"h": lambda g, clock, fields: rate})

    mj, sj, mt, st = _pair(build, dict(h=1.0, a=1.0))
    sj, st = _steps(mj, sj, mt, st, 100.0, 10)
    g = mt.grid
    assert float(st.h[g.Hx, g.Hy]) == pytest.approx(1.0 + rate * 100.0 * 10, rel=1e-12)
    _assert_close(sj, st, {"h": TIGHT, "a": TIGHT})


def test_velocity_forcing():
    """`test_forcing_and_pickup.py:28-45`: a body force accelerates the ice
    (ViscousRheology(ν = 0), ExplicitSolver), u = 5·10·accel (rtol 1e-10);
    as in JAX."""
    accel = 1e-6

    def build(lib, **kw):
        dyn = lib.SeaIceMomentumEquation(rheology=lib.ViscousRheology(nu=0.0),
                                         solver=lib.ExplicitSolver())
        return lib.sea_ice_model(lib.RectilinearGrid(size=(8, 8), **kw),
                                 ice_thermodynamics=None, dynamics=dyn,
                                 timestepper="ForwardEuler",
                                 forcing={"u": lambda g, clock, fields: accel})

    mj, sj, mt, st = _pair(build, dict(h=1.0, a=1.0))
    sj, st = _steps(mj, sj, mt, st, 10.0, 5)
    np.testing.assert_allclose(mt.grid.interior(st.u).numpy(), 5 * 10.0 * accel, rtol=1e-10)
    _assert_close(sj, st, {"u": TIGHT, "v": TIGHT})


def test_forcing_of_fields_tracers_and_velocities():
    """Forcing that reads the fields and the clock, on h, ℵ, hs, a tracer
    and v, under RK3 with WENO-5, EVP in soft ice and snow: the JAX run's
    state (1e-10); a key that names no prognostic warns in both packages."""
    def build(lib, **kw):
        grid = lib.RectilinearGrid(size=(12, 12), x=(0, 24 * km), y=(0, 24 * km),
                                   topology=("periodic", "bounded"), **kw)
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
            coriolis=lib.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.05, "v": 0.02},
            bottom_momentum_stress=lib.SemiImplicitStress(),
            solver=lib.SplitExplicitSolver(substeps=8))
        forcing = {"h": lambda g, c, f: -1e-6 * f.h * f.a,
                   "a": lambda g, c, f: 1e-7 * (1 - f.a),
                   "hs": lambda g, c, f: 1e-8 + 0.0 * f.h,
                   "T": lambda g, c, f: -1e-4 * f.tracers["T"],
                   "v": lambda g, c, f: 1e-6 * c.time / 600.0}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model = lib.sea_ice_model(grid, dynamics=dyn,
                                      ice_thermodynamics=lib.sea_ice_slab_thermodynamics(),
                                      snow_thermodynamics=lib.snow_slab_thermodynamics(),
                                      top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                                      advection=lib.WENO(order=5), forcing=forcing)
        assert any("forcing keys ['T']" in str(w.message) for w in caught)
        return model

    state_kw = _seeded((12, 12), 4)
    state_kw.update(hs=0.1, tracers={"T": np.random.default_rng(5).random((12, 12))})
    mj, sj, mt, st = _pair(build, state_kw)
    sj, st = _steps(mj, sj, mt, st, 600.0, 2)
    bars = {k: TIGHT for k in ("h", "a", "hs", "u", "v", "tracers/T")}
    _assert_close(sj, st, bars)


# --- the public API ------------------------------------------------------------------------

def test_set_fields_timescale_and_mass():
    """``set_fields`` (interiors set, land masked, halos filled),
    ``cell_advection_timescale`` and ``ice_mass_cc`` against JAX's."""
    csi = _csi()

    def build(lib, **kw):
        grid = lib.RectilinearGrid(size=(10, 8), x=(0, 30 * km), y=(0, 16 * km),
                                   topology=("periodic", "bounded"), halo=3, **kw)
        land = np.zeros((10, 8), bool)
        land[2:4, :2] = True
        return lib.sea_ice_model(lib.ImmersedBoundaryGrid(grid, land), ice_thermodynamics=None)

    mj, sj, mt, st = _pair(build, dict(h=0.5, a=0.5))
    kw = _seeded((10, 8), 6)
    sj = csi.set_fields(mj, sj, **kw)
    st = cst.set_fields(mt, st, **kw)
    _assert_close(sj, st, {k: 0.0 for k in ("h", "a", "u", "v")})
    assert float(cst.cell_advection_timescale(mt, st)) == pytest.approx(
        float(csi.cell_advection_timescale(mj, sj)), rel=1e-14)
    mass = tmodel.ice_mass_cc(st.h, st.a, 900.0)
    from climaseaice_jl_tpu.model import ice_mass_cc
    assert _rel(ice_mass_cc(sj.h, sj.a, 900.0), mass.numpy()) == 0.0


def test_exports_match_the_jax_package():
    """Every public name that the JAX package's ``__init__.py`` exports (its
    submodules aside, which other tests may have imported) is the port's;
    ``step_unjitted`` is ``step`` there (the port has no jit)."""
    csi = _csi()
    missing = sorted(n for n in dir(csi) if not n.startswith("_") and not hasattr(cst, n)
                     and not isinstance(getattr(csi, n), types.ModuleType))
    assert missing == [], missing
    assert cst.step_unjitted is cst.step
    assert cst.with_halo is cst.grids.with_halo


# --- the gates ----------------------------------------------------------------------------

def _gate_models():
    """(gate, model it accepts) for each fused EVP gate, float32 on the CPU."""
    from climaseaice_jl_tpu_torch import distributed_basin

    def rect(topology, fixed=None, size=(16, 128)):
        grid = cst.RectilinearGrid(size=size, x=(0, 32 * km), y=(0, 256 * km), halo=5,
                                   topology=topology, dtype="float32", device="cpu")
        dyn = cst.SeaIceMomentumEquation(
            coriolis=cst.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.1, "v": 0.05},
            bottom_momentum_stress=cst.SemiImplicitStress(),
            solver=cst.SplitExplicitSolver(substeps=8, fixed_tiles=fixed))
        return cst.sea_ice_model(grid, dynamics=dyn, advection=cst.WENO(order=7))

    latlon = cst.LatitudeLongitudeGrid(size=(24, 16), latitude=(60, 84), halo=5,
                                       topology=("periodic", "bounded"), dtype="float32",
                                       device="cpu")
    curv = rect(("periodic", "bounded")).evolve(grid=latlon)
    basin, _ = distributed_basin.build(32, 64, fixed_tiles=(8, 128), device="cpu")
    return [(fused_evp.fused_available, rect(("periodic", "periodic"))),
            (fused_evp_padded.padded_fused_available, rect(("bounded", "bounded"))),
            (fused_evp_curvilinear.curvilinear_fused_available, curv),
            (fused_evp_tiled_padded.tiled_padded_available,
             rect(("bounded", "bounded"), fixed=(8, 128))),
            (fused_evp_tiled_curvilinear.tiled_curvilinear_available, basin)]


def _variants(model):
    dyn = model.dynamics
    fd = cst.StressBalanceFreeDrift(top_momentum_stress={"u": 0.1, "v": 0.05},
                                    bottom_momentum_stress=cst.SemiImplicitStress())
    return {
        "forcing": model.evolve(forcing=(("h", lambda g, c, f: 1e-7),)),
        "free drift in the dynamics": model.evolve(dynamics=dyn.evolve(free_drift=fd)),
        "free drift as the dynamics": model.evolve(dynamics=fd),
        "BetaPlane": model.evolve(dynamics=dyn.evolve(
            coriolis=cst.BetaPlane(f0=1.4e-4, beta=1e-11))),
        "ViscousRheology": model.evolve(dynamics=dyn.evolve(
            rheology=cst.ViscousRheology(nu=1000.0))),
        "ExplicitSolver": model.evolve(dynamics=dyn.evolve(solver=cst.ExplicitSolver())),
    }


def test_fused_gates_refuse_the_general_physics():
    """Each fused EVP gate accepts its base model and refuses forcing, free
    drift (inside the dynamics or as the dynamics), a BetaPlane, the
    viscous rheology and the explicit solver, as the JAX gates do
    (`pallas_evp.py:93-134`, `pallas_evp_padded.py:49-114`,
    `pallas_evp_curvilinear.py:112`, `pallas_evp_tiled_padded.py:200`,
    `pallas_evp_tiled_curvilinear.py:392`); the fixed-tile advection takes a
    forced model (`pallas_advection.py:50-75` does not test for it); and a
    forced float32 model steps through the general momentum path."""
    models = _gate_models()
    for gate, model in models:
        assert gate(model), gate.__name__
        for what, variant in _variants(model).items():
            assert not gate(variant), (gate.__name__, what)
    forced = _variants(models[3][1])["forcing"]
    assert fixed_tile_advection_available(forced)

    model = models[0][1]
    forced = cst.sea_ice_model(model.grid, dynamics=model.dynamics, advection=model.advection,
                               forcing={"h": lambda g, c, f: 1e-7})
    routes = []
    general = tmodel.split_explicit_momentum_step
    tmodel.split_explicit_momentum_step = lambda *a: routes.append("general") or general(*a)
    try:
        st = cst.step(forced, cst.initial_state(forced, h=1.0, a=1.0), 60.0)
    finally:
        tmodel.split_explicit_momentum_step = general
    assert routes == ["general"] * 3 and st.h.isfinite().all()


def _with_grid_array(model, dynamics):
    """``model`` with a grid-shaped array in its dynamics: a field
    viscosity for the explicit solver, an array ocean velocity for free
    drift."""
    field = np.full(model.grid.shape, 0.1)
    if dynamics == "ExplicitSolver":
        return model.evolve(dynamics=model.dynamics.evolve(
            rheology=cst.ViscousRheology(nu=1e4 * field)))
    return model.evolve(dynamics=model.dynamics.evolve(
        bottom_momentum_stress=cst.SemiImplicitStress(ue=field)))


@pytest.mark.parametrize("dynamics", ["ExplicitSolver", "free drift as the dynamics"])
def test_shard_refuses_the_general_physics(dynamics):
    """The explicit solver and free drift as the whole dynamics run on a
    shard (a grid that names mesh axes): its route is the general path, and
    make_distributed_step passes every shard's route and stops only at the
    missing process group.  A shard refuses them where the model holds a
    grid-shaped array (a field viscosity, an array ocean velocity), which a
    rank could not cut, with the JAX package's error (`stepper.py:320-330`),
    as the JAX package refuses the same model."""
    from climaseaice_jl_tpu_torch.parallel import make_distributed_step
    from climaseaice_jl_tpu.parallel import make_distributed_step as jax_dstep
    csi = _csi()
    model = _variants(_gate_models()[1][1])[dynamics]
    grid = model.grid
    probe = model.evolve(grid=_local_grid(grid, grid.Nx // 2, grid.Ny, 0, 0,
                                          ("x", None), (2, 1)))
    assert tmodel.meshed_momentum_route(probe) == "general"
    with pytest.raises(RuntimeError, match="torch.distributed is not initialised"):
        make_distributed_step(model, (2, 1))
    with pytest.raises(NotImplementedError, match="grid-shaped model array"):
        make_distributed_step(_with_grid_array(model, dynamics), (2, 1))

    gj = csi.RectilinearGrid(size=(16, 128), x=(0, 32 * km), y=(0, 256 * km), halo=5,
                             topology=("bounded", "bounded"), dtype="float32")
    field = np.full(gj.shape, 0.1)
    if dynamics == "ExplicitSolver":
        dj = csi.SeaIceMomentumEquation(rheology=csi.ViscousRheology(nu=1e4 * field),
                                        solver=csi.ExplicitSolver())
    else:
        dj = csi.StressBalanceFreeDrift(top_momentum_stress={"u": 0.1, "v": 0.05},
                                        bottom_momentum_stress=csi.SemiImplicitStress(ue=field))
    with pytest.raises(NotImplementedError, match="grid-shaped model array"):
        jax_dstep(csi.sea_ice_model(gj, dynamics=dj), (2, 1))


# --- the module-level helpers: strain rates, div_Uah, the SBP identity ----------------------

def test_strain_rate_helpers_and_div_Uah_match_jax():
    """``strain_rate_xx``, ``strain_rate_yy``, ``strain_rate_xy``
    (`rheologies.py:58-68`) and ``div_Uah`` (`advection.py:310`, WENO-5,
    with the peripheral masks) on a bounded latitude-longitude grid with
    seeded fields, against the JAX package's: within 1e-12 of each field's
    largest value (the same operations in the same order)."""
    csi = _csi()
    import climaseaice_jl_tpu.dynamics.rheologies as jrheo
    import climaseaice_jl_tpu.advection as jadv
    from climaseaice_jl_tpu_torch.dynamics import rheologies as trheo
    from climaseaice_jl_tpu_torch import advection as tadv

    def grid(lib, **kw):
        return lib.LatitudeLongitudeGrid(size=(12, 10), longitude=(0, 60), latitude=(20, 70),
                                         topology=("bounded", "bounded"), halo=4, **kw)

    gj, gt = grid(csi), grid(cst, device="cpu")
    rng = np.random.default_rng(8)
    u, v, a, h = (rng.standard_normal(gt.shape) * s + o
                  for s, o in ((0.05, 0.0), (0.05, 0.0), (0.05, 0.9), (0.2, 1.0)))
    u[:, :6] = 0.0                                     # faces at rest: the ratio form's branch
    mt = cst.sea_ice_model(gt)
    masks_t = (mt.masks.per_fc, mt.masks.per_cf)
    masks_j = tuple(m.numpy() for m in masks_t)
    T = [torch.as_tensor(q) for q in (u, v, a, h)]
    for name in ("strain_rate_xx", "strain_rate_yy", "strain_rate_xy"):
        ref = np.asarray(getattr(jrheo, name)(gj, u, v))
        got = getattr(trheo, name)(gt, T[0], T[1]).numpy()
        assert _rel(gj.interior(ref), gt.interior(got)) <= 1e-12, name
    for scheme, masks in ((lambda lib: lib.WENO(order=5), True),
                          (lambda lib: lib.UpwindBiased(order=3), False)):
        ref = np.asarray(jadv.div_Uah(gj, scheme(csi), u, v, a, h,
                                      masks=masks_j if masks else None))
        got = tadv.div_Uah(gt, scheme(cst), *T, masks=masks_t if masks else None).numpy()
        assert np.isfinite(got).all()
        assert _rel(gj.interior(ref), gt.interior(got)) <= 1e-12


def _set_smooth(grid, xloc, yloc, func, margin=2):
    """A zero field with ``func(λ, φ)`` on the interior but a margin, at the
    staggered location ``xloc``, ``yloc`` ('c' or 'f' each)."""
    lam = (grid.xc if xloc == "c" else grid.xf).numpy()
    phi = (grid.yc if yloc == "c" else grid.yf).numpy()
    q = np.zeros(grid.shape)
    Hx, Hy = grid.Hx, grid.Hy
    i = np.arange(margin, grid.Nx - margin)[:, None]
    j = np.arange(margin, grid.Ny - margin)[None, :]
    q[Hx + i, Hy + j] = func(lam[Hx + i], phi[Hy + j])
    return torch.as_tensor(q)


@pytest.mark.parametrize("N", [40, 80])
def test_sbp_adjointness(N):
    """`tests/test_rheology_energy_budget.py::test_sbp_adjointness` on the
    port: on a bounded latitude-longitude grid the port's metric-aware
    stress divergence satisfies Σ [u ∂ⱼσ₁ⱼ + v ∂ⱼσ₂ⱼ] Az = −Σ [σ₁₁ϵ̇₁₁ +
    σ₂₂ϵ̇₂₂ + 2σ₁₂ϵ̇₁₂] Az (the strain rates from ``strain_rate_*``) to
    below 1e-10 of the larger side, where the naive flux form misses by more
    than 1e-3."""
    from climaseaice_jl_tpu_torch.ops import dxf, dxc, dyf, dyc
    from climaseaice_jl_tpu_torch.state import ModelFields
    from climaseaice_jl_tpu_torch.dynamics.rheologies import (
        stress_divergence, strain_rate_xx, strain_rate_yy, strain_rate_xy)
    grid = cst.LatitudeLongitudeGrid(size=(N, N), longitude=(0, 60), latitude=(20, 70),
                                     topology=("bounded", "bounded"), halo=4, device="cpu")
    lh = lambda lam: lam / 60 * 2 * np.pi                   # noqa: E731
    ph = lambda phi: (phi - 20) / 50 * 2 * np.pi            # noqa: E731
    u = _set_smooth(grid, "f", "c", lambda l, p: np.sin(2 * lh(l)) * np.cos(3 * ph(p)))
    v = _set_smooth(grid, "c", "f", lambda l, p: np.cos(3 * lh(l)) * np.sin(2 * ph(p)))
    s11 = _set_smooth(grid, "c", "c", lambda l, p: np.sin(lh(l)) * np.sin(2 * ph(p)))
    s22 = _set_smooth(grid, "c", "c", lambda l, p: np.cos(2 * lh(l)) * np.cos(ph(p)))
    s12 = _set_smooth(grid, "f", "f", lambda l, p: np.sin(3 * lh(l)) * np.cos(2 * ph(p)))
    fields = ModelFields(u=u, v=v, sig11=s11, sig22=s22, sig12=s12)
    div_x, div_y = stress_divergence(cst.ElastoViscoPlasticRheology(), grid, fields)
    old_x = (dxf(grid.dy_cc * s11) + dyc(grid.dx_ff * s12)) / grid.az_fc
    old_y = (dxc(grid.dy_ff * s12) + dyf(grid.dx_cc * s22)) / grid.az_cf

    I = grid.interior                                        # noqa: E741

    def az(name):
        return getattr(grid, name).broadcast_to(grid.shape)

    W_new = float((I(u * div_x * az("az_fc"))).sum() + (I(v * div_y * az("az_cf"))).sum())
    W_old = float((I(u * old_x * az("az_fc"))).sum() + (I(v * old_y * az("az_cf"))).sum())
    D = float(I(s11 * strain_rate_xx(grid, u, v) * az("az_cc")).sum()
              + I(s22 * strain_rate_yy(grid, u, v) * az("az_cc")).sum()
              + 2 * I(s12 * strain_rate_xy(grid, u, v) * az("az_ff")).sum())
    new, old = (abs(W + D) / max(abs(W), abs(D)) for W in (W_new, W_old))
    assert new < 1e-10, new
    assert old > 1e-3, old
    assert new < 1e-6 * old


PORTED_MODULES = ["advection", "dynamics.coriolis", "dynamics.free_drift", "dynamics.momentum",
                  "dynamics.rheologies", "dynamics.stresses", "fields", "forcing_utils", "grids",
                  "io.checkpoint", "io.writers", "model", "ops", "parallel.multihost",
                  "simulation", "state", "thermodynamics.heat_bcs", "thermodynamics.slab"]


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_module_names_match_the_jax_package(module):
    """Every public function and class that a ported module of the JAX
    package defines is in the port's module of the same name."""
    import importlib
    import inspect
    jax_mod = importlib.import_module("climaseaice_jl_tpu." + module)
    port_mod = importlib.import_module("climaseaice_jl_tpu_torch." + module)
    names = [n for n, v in vars(jax_mod).items()
             if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == jax_mod.__name__]
    assert names
    assert [n for n in names if not hasattr(port_mod, n)] == []


# --- the card against the CPU: chip_smoke.py phase 33 ----------------------------------------

def phase33_model(variant, N=128, P_star=27500.0, device=None):
    """`bench.py:build(N, 120)` in the port with ``variant``: "viscous"
    (ViscousRheology(ν = 1000) + ExplicitSolver + BetaPlane(1.4e-4, 1e-11)),
    "forced" (the αEVP flagship with constant h and u forcing rates) or
    "free_drift" (StressBalanceFreeDrift as the whole dynamics, the flagship's
    scalar top stress over SemiImplicitStress)."""
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 512 * km), y=(0, 512 * km), halo=5,
                               dtype="float32", topology=("periodic", "periodic"), device=device)
    top = {"u": 0.1, "v": 0.05}
    forcing = None
    if variant == "free_drift":
        dynamics = cst.StressBalanceFreeDrift(top_momentum_stress=top,
                                              bottom_momentum_stress=cst.SemiImplicitStress())
    else:
        viscous = variant == "viscous"
        dynamics = cst.SeaIceMomentumEquation(
            rheology=(cst.ViscousRheology(nu=1000.0) if viscous
                      else cst.ElastoViscoPlasticRheology(ice_compressive_strength=P_star)),
            coriolis=(cst.BetaPlane(f0=1.4e-4, beta=1e-11) if viscous
                      else cst.FPlane(f=1.4e-4)),
            top_momentum_stress=top, bottom_momentum_stress=cst.SemiImplicitStress(),
            solver=cst.ExplicitSolver() if viscous else cst.SplitExplicitSolver(substeps=120))
        if variant == "forced":
            forcing = {"h": lambda g, c, f: 1e-7, "u": lambda g, c, f: 2e-6}
    return cst.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                             top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                             advection=cst.WENO(order=7), timestepper="SplitRungeKutta3",
                             forcing=forcing)


def phase33_state(model, seed=9):
    rng = np.random.default_rng(seed)
    shape = model.grid.interior_shape
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    h = 1.0 + 0.25 * np.sin(2 * np.pi * x)[:, None] * np.sin(2 * np.pi * x)[None, :]
    return cst.initial_state(model, h=h, a=1.0, u=0.05 * rng.standard_normal(shape),
                             v=0.05 * rng.standard_normal(shape))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card against the CPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["viscous", "forced", "free_drift"])
def test_cuda_card_matches_cpu(cuda_device, variant):
    """Phase 33: 128², 2 RK3 steps of 120 s on the card and on the CPU: the
    viscous explicit beta-plane and free drift within 1e-5 of each field's
    largest value in h, ℵ, u, v; the forced αEVP flagship at P★ = 27.5 in
    phase 5's bars (u, v ≤ 1e-4, σ, α ≤ 4e-3, h, ℵ ≤ 1e-5)."""
    finals = {}
    for device in (cuda_device, "cpu"):
        model = phase33_model(variant, P_star=27.5, device=device)
        state = phase33_state(model)
        for _ in range(2):
            state = cst.step(model, state, 120.0)
        finals[str(device)] = state_to_numpy(state)
    bars = {k: 1e-5 for k in ("h", "a", "u", "v")}
    if variant == "forced":
        bars.update(u=1e-4, v=1e-4, sig11=4e-3, sig22=4e-3, sig12=4e-3, alpha=4e-3)
    for name, bar in bars.items():
        assert np.isfinite(finals["cuda"][name]).all(), name
        assert _rel(finals["cpu"][name], finals["cuda"][name]) <= bar, name
