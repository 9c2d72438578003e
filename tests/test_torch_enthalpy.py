"""The enthalpy-method column of the port (`climaseaice_jl_tpu_torch/enthalpy.py`)
against the JAX package's (`climaseaice_jl_tpu/enthalpy.py`).

* `tests/test_enthalpy.py`'s five tests, each with its assertions on the
  port and its run also held to JAX's ``em.step`` within 1e-12 of the
  largest value of each field.
* A prescribed-flux case (``FluxBoundaryCondition`` callables at both
  faces, an enthalpy given at the start, a seeded profile carried across
  through :mod:`climaseaice_jl_tpu_torch.convert`).
* The transcribed reference recurrence
  (`tests/test_reference_parity_oracles.py:282`), at its rtol 1e-9,
  atol 1e-11.

Both packages run in float64 on the CPU; the JAX package is imported inside
the tests."""

import numpy as np
import pytest
import torch

from climaseaice_jl_tpu_torch import enthalpy as et
from climaseaice_jl_tpu_torch.convert import enthalpy_state_from_numpy, enthalpy_state_to_numpy

day = 86400.0
PARITY = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as the fixed-tile files run (six test workers share
    the machine's cores in the tier-1 run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _em():
    from climaseaice_jl_tpu import enthalpy as em
    return em


def _rel(ref, x):
    ref, x = np.asarray(ref), np.asarray(x)
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)


def _assert_parity(sj, st):
    aj, at = enthalpy_state_to_numpy(sj), enthalpy_state_to_numpy(st)
    assert sorted(aj) == sorted(at)
    assert int(at["iteration"]) == int(aj["iteration"]) and at["time"] == aj["time"]
    for name in ("H", "T", "phi", "kappa"):
        assert at[name].shape == aj[name].shape, name
        assert _rel(aj[name], at[name]) <= PARITY, (name, _rel(aj[name], at[name]))


def _models(Nz, top, bottom, **grid_kw):
    """The JAX and the port's model for boundary conditions given as
    ``(kind, jax value, port value)``."""
    em = _em()

    def bc(lib, spec, k):
        if spec is None:
            return None
        kind = {"value": "ValueBoundaryCondition", "flux": "FluxBoundaryCondition"}[spec[0]]
        return getattr(lib, kind)(spec[k])

    mj = em.EnthalpyMethodSeaIceModel(grid=em.ZGrid(Nz=Nz, **grid_kw),
                                      top_T_bc=bc(em, top, 1), bottom_T_bc=bc(em, bottom, 1))
    mt = et.EnthalpyMethodSeaIceModel(grid=et.ZGrid(Nz=Nz, device="cpu", **grid_kw),
                                      top_T_bc=bc(et, top, 2), bottom_T_bc=bc(et, bottom, 2))
    return mj, mt


def _run(step, model, state, dt, n):
    for _ in range(n):
        state = step(model, state, dt)
    return state


def test_construction_and_set():
    """A −5 °C profile set through a callable of z: T = −5 and ϕ = 1 in the
    interior (ϕ = 1 where T < 0); the JAX state."""
    em = _em()
    grid = et.ZGrid(Nz=20, z0=-1.0, z1=0.0, device="cpu")
    model = et.EnthalpyMethodSeaIceModel(grid=grid)
    state = et.initial_state(model, T=lambda z: -5.0 + 0 * z)
    assert state.T.dtype == torch.float64 and state.T.shape == (22,)
    np.testing.assert_allclose(grid.interior(state.T).numpy(), -5.0)
    np.testing.assert_allclose(grid.interior(state.phi).numpy(), 1.0)
    mj = em.EnthalpyMethodSeaIceModel(grid=em.ZGrid(Nz=20, z0=-1.0, z1=0.0))
    _assert_parity(em.initial_state(mj, T=lambda z: -5.0 + 0 * z), state)
    with pytest.raises(ValueError):
        et.initial_state(model, T=0.0, H=0.0)


def test_diffusion_conserves_enthalpy_no_flux():
    """Zero-flux BCs at both faces, a step profile: total enthalpy conserved
    over 500 steps of 60 s; the JAX run's state."""
    em = _em()
    mj, mt = _models(16, ("flux", 0.0, 0.0), ("flux", 0.0, 0.0))
    st = et.initial_state(mt, T=lambda z: torch.where(z > -0.5, 2.0, -3.0).to(z.dtype))
    H0 = float(mt.grid.interior(st.H).sum())
    st = _run(et.step, mt, st, 60.0, 500)
    H1 = float(mt.grid.interior(st.H).sum())
    assert abs(H1 - H0) < 1e-10 * max(1.0, abs(H0))
    sj = _run(em.step, mj, em.initial_state(mj, T=lambda z: np.where(z > -0.5, 2.0, -3.0)),
              60.0, 500)
    _assert_parity(sj, st)


def test_dirichlet_cooling_freezes_column():
    """A −10 °C lid over a 1 °C bottom, 2000 steps: the top cell froze, the
    bottom is still warm, the profile is monotone; the JAX run's state."""
    em = _em()
    mj, mt = _models(20, ("value", -10.0, -10.0), ("value", 1.0, 1.0))
    st = _run(et.step, mt, et.initial_state(mt, T=lambda z: 1.0 + 0 * z), 60.0, 2000)
    T = mt.grid.interior(st.T).numpy()
    assert T[-1] < 0 and T[0] > 0
    assert np.all(np.diff(T) <= 1e-9)
    sj = _run(em.step, mj, em.initial_state(mj, T=lambda z: 1.0 + 0 * z), 60.0, 2000)
    _assert_parity(sj, st)


def test_time_varying_bc():
    """A daily oscillating top temperature ``f(t)`` (called with the clock's
    0-d tensor), 100 steps: finite, 100 iterations; the JAX run's state."""
    em = _em()
    import jax.numpy as jnp
    mj, mt = _models(10, ("value", lambda t: -5.0 + 5 * jnp.sin(2 * np.pi * t / day),
                          lambda t: -5.0 + 5 * torch.sin(2 * np.pi * t / day)),
                     ("value", 1.1, 1.1))
    st = _run(et.step, mt, et.initial_state(mt, T=lambda z: 1.1 + 0 * z), 60.0, 100)
    assert torch.isfinite(st.T).all() and int(st.clock.iteration) == 100
    sj = _run(em.step, mj, em.initial_state(mj, T=lambda z: 1.1 + 0 * z), 60.0, 100)
    _assert_parity(sj, st)


def test_batched_columns_xyz():
    """Batched (3, 2) columns evolve as independent 1-D runs (rtol 1e-12),
    200 steps; the JAX package's batched run."""
    em = _em()
    mj, mt = _models(12, ("value", -8.0, -8.0), ("value", 1.0, 1.0))
    batched = et.initial_state(mt, T=lambda z: 1.0 + 0 * z, columns=(3, 2))
    single = et.initial_state(mt, T=lambda z: 1.0 + 0 * z)
    assert batched.T.shape == (3, 2, 14)
    batched = _run(et.step, mt, batched, 60.0, 200)
    single = _run(et.step, mt, single, 60.0, 200)
    Tb, Ts = mt.grid.interior(batched.T).numpy(), mt.grid.interior(single.T).numpy()
    for i in range(3):
        for j in range(2):
            np.testing.assert_allclose(Tb[i, j], Ts, rtol=1e-12)
    sj = _run(em.step, mj, em.initial_state(mj, T=lambda z: 1.0 + 0 * z, columns=(3, 2)),
              60.0, 200)
    _assert_parity(sj, batched)


def test_flux_boundary_conditions_match_jax():
    """Prescribed fluxes at both faces (a time-dependent callable at the
    top, a number at the bottom), a seeded enthalpy set at the start
    (``initial_state(H=...)``, a (2, 3) batch), carried into the port
    through ``enthalpy_state_from_numpy``: 300 steps of 120 s within 1e-12
    of the JAX run; the flux BCs change the total enthalpy by the time
    integral of the fluxes."""
    em = _em()
    import jax.numpy as jnp
    mj, mt = _models(16, ("flux", lambda t: -2e-5 * (1 + jnp.cos(2 * np.pi * t / day)),
                          lambda t: -2e-5 * (1 + torch.cos(2 * np.pi * t / day))),
                     ("flux", 1e-5, 1e-5))
    rng = np.random.default_rng(17)
    H0 = 2090.0 / 999.8 * rng.uniform(-4.0, 3.0, (2, 3, 16))
    sj = em.initial_state(mj, H=H0, columns=(2, 3))
    st = enthalpy_state_from_numpy(mt, enthalpy_state_to_numpy(sj))
    _assert_parity(sj, st)
    total0 = mt.grid.interior(st.H).sum(-1)
    st = _run(et.step, mt, st, 120.0, 300)
    sj = _run(em.step, mj, sj, 120.0, 300)
    _assert_parity(sj, st)
    # ∂t ΣH Δz = F_top − F_bottom: ∫ −2e-5 (1 + cos) dt − 1e-5 · t over 10 h
    t = 120.0 * np.arange(300)
    expected = 120.0 * np.sum(-2e-5 * (1 + np.cos(2 * np.pi * t / day)) - 1e-5) / mt.grid.dz
    got = (mt.grid.interior(st.H).sum(-1) - total0).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-9)


def test_diffusive_ice_column_matches_oracle():
    """`test_reference_parity_oracles.py:320-349`: every step of 2.5 days of
    the diffusive column against the transcribed reference recurrence, rtol
    1e-9, atol 1e-11."""
    import test_reference_parity_oracles as oracles
    from climaseaice_jl_tpu_torch.examples import diffusive_ice_column_model as ex
    model, state = ex.build(device="cpu")
    dt = 100.0
    n = int(2.5 * day / dt)
    got = [model.grid.interior(state.T).clone()]
    for _ in range(n):
        state = et.step(model, state, dt)
        got.append(model.grid.interior(state.T).clone())
    np.testing.assert_allclose(torch.stack(got).numpy(), oracles.enthalpy_column_oracle(n, dt),
                               rtol=1e-9, atol=1e-11)
