"""Bounded and immersed sea ice in the port vs the JAX package: land masks,
StressFunction stresses, the immersed drag on the general path, the padded
fused route (the CUDA kernel's plain version) against the Pallas kernel in
interpret mode, the gate and dispatch, and the slice's main configuration
as a whole.

The JAX package is imported inside the tests that compare with it, so that
the CUDA test runs on a machine without JAX (``pytest --noconftest -m cuda
tests/test_torch_immersed.py``)."""

import math

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch.dynamics import stresses as tstresses
from climaseaice_jl_tpu_torch.dynamics.fused_evp import (
    evp_counter, fused_split_explicit_momentum_step)
from climaseaice_jl_tpu_torch.dynamics.fused_evp_padded import (
    KIND_PERIODIC, KIND_SPLIT, chunk_substeps, direction_kinds, padded_evp_counter,
    padded_evp_inputs, padded_evp_substeps, padded_evp_substeps_reference,
    padded_fused_available, padded_fused_momentum_step, padded_loop_functions)
from climaseaice_jl_tpu_torch.dynamics.momentum import split_explicit_momentum_step
from climaseaice_jl_tpu_torch.fields import (immersed_only_ff, mask_immersed_cc,
                                             peripheral_masks, solid_cc_mask)

km = 1000.0
L = 100 * km
TOPOLOGIES = {"bounded": ("bounded", "bounded"), "periodic": ("periodic", "periodic"),
              "mixed": ("periodic", "bounded")}


def island(x, y):
    """A disc of land, off centre so that x and y are not symmetric."""
    return (x - 0.45 * L) ** 2 + (y - 0.55 * L) ** 2 < (0.2 * L) ** 2


def coast(x, y):
    """A wedge of land along the south wall (the coastline example's shape)."""
    return y < 0.3 * L * (1 - np.abs(2 * x / L - 1))


def _grid(lib, topology, dtype, land=None, size=(24, 20), **kw):
    grid = lib.RectilinearGrid(size=size, x=(0, L), y=(0, L), halo=5, dtype=dtype,
                               topology=TOPOLOGIES[topology], **kw)
    return grid if land is None else lib.ImmersedBoundaryGrid(grid, land)


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.abs(y - x).max() / max(np.abs(x).max(), 1e-30)


# --- masks ----------------------------------------------------------------------

@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_masks_equal_jax(topology):
    """ImmersedBoundaryGrid (callable and array masks), peripheral_masks,
    solid_cc_mask and immersed_only_ff equal the JAX ones exactly, and
    mask_immersed_cc zeroes exactly the land cells."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu import fields as jfields

    gj = _grid(csi, topology, "float64", island)
    gt = _grid(cst, topology, "float64", island, device="cpu")
    interior = np.asarray(gj.interior(gj.solid_cc))
    ga = cst.ImmersedBoundaryGrid(_grid(cst, topology, "float64", device="cpu"), interior)
    assert 0 < interior.sum() < interior.size
    for g in (gt, ga):
        assert g.is_immersed and g.solid_cc.dtype == torch.bool
        np.testing.assert_array_equal(g.solid_cc.numpy(), np.asarray(gj.solid_cc))
        for a, b in zip(peripheral_masks(g), jfields.peripheral_masks(gj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(solid_cc_mask(g).numpy(),
                                      np.asarray(jfields.solid_cc_mask(gj)))
        np.testing.assert_array_equal(immersed_only_ff(g).numpy(),
                                      np.asarray(jfields.immersed_only_ff(gj)))
    q = np.random.default_rng(0).standard_normal(gt.shape)
    np.testing.assert_array_equal(mask_immersed_cc(torch.tensor(q), gt).numpy(),
                                  np.asarray(jfields.mask_immersed_cc(q, gj)))
    assert immersed_only_ff(_grid(cst, topology, "float64", device="cpu")) is None


# --- StressFunction ---------------------------------------------------------------

def _wind(mod):
    """The same StressFunction callables written for jnp and for torch."""
    def wind_u(grid, clock, fields, p):
        x = mod.asarray(grid.xf)[:, None]
        y = mod.asarray(grid.yc)[None, :]
        r = mod.sqrt((x - 0.5 * L) ** 2 + (y - 0.4 * L) ** 2 + clock.time * p)
        return (0.1 * mod.exp(-r / L) * y / L) * mod.ones_like(x * y)

    def ocean_u(grid, clock, fields):
        return 0.02 + 0.01 * fields.h * clock.time / 3600.0

    return wind_u, ocean_u


def test_stress_function_equals_jax_float64():
    """explicit and implicit τ with a StressFunction as a dict component
    (with parameters) and as a SemiImplicitStress ``ue``: ≤ 1e-15 relative
    to JAX in float64 (measured 3.2e-16)."""
    import jax.numpy as jnp
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics import stresses as jstresses
    from climaseaice_jl_tpu.state import Clock as JClock, ModelFields as JFields

    gj = _grid(csi, "bounded", "float64")
    gt = _grid(cst, "bounded", "float64", device="cpu")
    rng = np.random.default_rng(1)
    h, u, v = (rng.random(gj.shape) + 0.5, 0.1 * rng.standard_normal(gj.shape),
               0.1 * rng.standard_normal(gj.shape))
    fj = JFields(h=jnp.asarray(h), u=jnp.asarray(u), v=jnp.asarray(v))
    ft = cst.ModelFields(h=torch.tensor(h), u=torch.tensor(u), v=torch.tensor(v))
    cj = JClock(time=jnp.asarray(5400.0), iteration=jnp.asarray(3))
    ct = cst.Clock(time=torch.tensor(5400.0, dtype=torch.float64),
                   iteration=torch.tensor(3))

    def stresses(lib, mod):
        wind_u, ocean_u = _wind(mod)
        top = {"u": lib.StressFunction(func=wind_u, parameters=2e6), "v": 0.03}
        bottom = lib.SemiImplicitStress(ue=lib.StressFunction(func=ocean_u), ve=0.01)
        return top, bottom

    (tj, bj), (tt, bt) = stresses(csi, jnp), stresses(cst, torch)
    worst = 0.0
    for name in ("explicit_tau_x", "explicit_tau_y", "implicit_tau_x_coefficient",
                 "implicit_tau_y_coefficient"):
        for sj, st in ((tj, tt), (bj, bt)):
            a = np.broadcast_to(getattr(jstresses, name)(gj, sj, cj, fj), gj.shape)
            b = getattr(tstresses, name)(gt, st, ct, ft).broadcast_to(gt.shape).numpy()
            if np.abs(a).max() > 0:
                worst = max(worst, _rel(a, b))
            else:
                assert np.abs(b).max() == 0, name
    assert worst <= 1e-15, worst


# --- general path with immersed drag, float64 ---------------------------------------

def _dynamics(lib, dtype, substeps, fused, drag=None, top=None, bottom=None):
    return lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=lib.FPlane(f=1e-4),
        top_momentum_stress=top if top is not None else {"u": 0.05, "v": 0.02},
        bottom_momentum_stress=(bottom if bottom is not None
                                else lib.SemiImplicitStress(ue=0.1, ve=-0.05)),
        immersed_drag=drag,
        solver=lib.SplitExplicitSolver(substeps=substeps, fused=fused))


# (topology, land, immersed-drag coefficient); a large coefficient so that
# the drag term moves u and v well above the bars
CASES = {"walls": ("bounded", None, None),
         "immersed": ("bounded", island, 2e4),
         "channel": ("mixed", coast, 2e4)}


def _case_model(lib, case, dtype, substeps=10, fused="always", **grid_kw):
    topology, land, C = CASES[case]
    drag = None if C is None else lib.ImmersedDrag(coefficient=C)
    return lib.sea_ice_model(_grid(lib, topology, dtype, land, **grid_kw),
                             dynamics=_dynamics(lib, dtype, substeps, fused, drag),
                             ice_thermodynamics=None, advection=lib.WENO(order=5),
                             timestepper="ForwardEuler")


def _jax_state(csi, model, seed=0):
    g = model.grid
    rng = np.random.default_rng(seed)
    x = np.asarray(g.xc)[g.Hx:g.Hx + g.Nx, None]
    y = np.asarray(g.yc)[None, g.Hy:g.Hy + g.Ny]
    h = 0.5 + 0.2 * np.sin(2 * np.pi * x / L) * np.cos(np.pi * y / L)
    return csi.initial_state(model, h=h, a=1.0,
                             u=0.02 + 0.01 * rng.standard_normal(g.interior_shape),
                             v=0.01 * rng.standard_normal(g.interior_shape))


@pytest.mark.parametrize("case", sorted(CASES))
def test_general_path_matches_jax_float64(case):
    """The general split-explicit path with walls, land and ImmersedDrag vs
    JAX `split_explicit_momentum_step`, float64, soft ice: ≤ 1e-11 (measured
    ≤ 1e-15)."""
    import jax
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.momentum import \
        split_explicit_momentum_step as jsplit

    mj = _case_model(csi, case, "float64", fused="never")
    mt = _case_model(cst, case, "float64", fused="never", device="cpu")
    sj = _jax_state(csi, mj, seed=1)
    st = state_from_numpy(mt, state_to_numpy(sj))
    upd_j = jax.jit(lambda s: jsplit(mj, s, 60.0, s.u, s.v))(sj)
    upd_t = split_explicit_momentum_step(mt, st, 60.0, st.u, st.v)
    assert set(upd_j) == set(upd_t)
    for name in upd_j:
        assert _rel(upd_j[name], upd_t[name].numpy()) <= 1e-11, name


def test_immersed_stress_bc_equals_immersed_drag():
    """A user flux BC −C·u, −C·v reproduces ImmersedDrag exactly over three
    steps (tests/test_immersed_bcs.py:37 for the port), and the drag moves
    the state."""
    C = 2e4
    runs = []
    for drag in (cst.ImmersedDrag(coefficient=C),
                 cst.ImmersedStressBC(u_flux=lambda g, c, f, p: -p * f.u,
                                      v_flux=lambda g, c, f, p: -p * f.v,
                                      parameters=C),
                 None):
        m = cst.sea_ice_model(_grid(cst, "mixed", "float64", coast, device="cpu"),
                              dynamics=_dynamics(cst, "float64", 8, "never", drag),
                              ice_thermodynamics=None, advection=cst.WENO(order=5),
                              timestepper="ForwardEuler")
        s = cst.initial_state(m, h=1.0, a=1.0)
        for _ in range(3):
            s = cst.step(m, s, 120.0)
        runs.append(s)
    for name in ("u", "v", "h", "sig11", "sig12"):
        np.testing.assert_array_equal(getattr(runs[0], name).numpy(),
                                      getattr(runs[1], name).numpy(), err_msg=name)
    assert not torch.equal(runs[0].u, runs[2].u)


# --- the padded route's plain version vs the Pallas kernel in interpret mode ---------

def _array_stresses(lib, grid_shape):
    """Array wind and ocean velocity (tests/test_pallas_evp.py:268)."""
    rng = np.random.default_rng(5)
    tau_u, tau_v, ue, ve = (np.asarray(s * rng.standard_normal(grid_shape), np.float32)
                            for s in (0.05, 0.05, 0.1, 0.1))
    return {"u": tau_u, "v": tau_v}, lib.SemiImplicitStress(ue=ue, ve=ve)


def _stress_function(lib):
    """A clock-dependent StressFunction wind (tests/test_pallas_evp.py:442),
    written for each package."""
    if lib is cst:
        def wind_u(grid, clock, fields):
            x = torch.arange(grid.nxp, dtype=grid.dtype, device=grid.device)[:, None]
            return 0.05 * torch.sin(2 * math.pi * x / grid.Nx + clock.time / 3600.0) \
                * torch.ones(grid.shape, dtype=grid.dtype, device=grid.device)
    else:
        import jax.numpy as jnp

        def wind_u(grid, clock, fields):
            x = jnp.arange(grid.nxp, dtype=grid.np_dtype)[:, None]
            return 0.05 * jnp.sin(2 * math.pi * x / grid.Nx + clock.time / 3600.0) \
                * jnp.ones(grid.shape, grid.np_dtype)

    return {"u": lib.StressFunction(func=wind_u), "v": 0.02}, None


def _padded_model(lib, case, **grid_kw):
    if case in CASES:
        return _case_model(lib, case, "float32", **grid_kw)
    grid = _grid(lib, "bounded", "float32", **grid_kw)
    top, bottom = (_array_stresses(lib, grid.shape) if case == "arrays"
                   else _stress_function(lib))
    return lib.sea_ice_model(grid, dynamics=_dynamics(lib, "float32", 10, "always",
                                                      top=top, bottom=bottom),
                             ice_thermodynamics=None, advection=lib.WENO(order=5),
                             timestepper="ForwardEuler")


PADDED_CASES = sorted(CASES) + ["arrays", "stress_function"]


@pytest.mark.parametrize("case", PADDED_CASES)
def test_padded_plain_version_matches_pallas_interpret(case):
    """The padded route on CPU tensors (the kernel's plain version) vs JAX
    `padded_fused_momentum_step` with the Pallas kernel in interpret mode,
    float32, soft ice, 10 substeps, two successive calls.  Bars of
    tests/test_pallas_evp.py:59-60: u/v ≤ 1e-4, σ/α ≤ 4e-3, and P ≤ 1e-6
    (measured: u/v ≤ 4.4e-7, σ ≤ 2.4e-6, α and P 0).  α is compared over
    the whole padded array (its halos come from the loop), the rest over
    interiors.  No kernel is launched on CPU tensors."""
    import jax
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.pallas_evp_padded import (
        padded_fused_available as jgate, padded_fused_momentum_step as jpadded)

    mj = _padded_model(csi, case)
    mt = _padded_model(cst, case, device="cpu")
    assert jgate(mj) and padded_fused_available(mt)
    sj = _jax_state(csi, mj, seed=2)
    st = state_from_numpy(mt, state_to_numpy(sj))
    step_j = jax.jit(lambda s: jpadded(mj, s, 60.0, s.u, s.v, interpret=True))

    padded_evp_counter.reset()
    for _ in range(2):
        sj = sj.evolve(**step_j(sj))
        st = st.evolve(**padded_fused_momentum_step(mt, st, 60.0, st.u, st.v))
        st = st.evolve(clock=cst.Clock(time=st.clock.time + 3600.0,
                                       iteration=st.clock.iteration))
        sj = sj.evolve(clock=sj.clock.evolve(time=sj.clock.time + 3600.0))
    assert padded_evp_counter.calls == 0

    aj, at = state_to_numpy(sj), state_to_numpy(st)
    g = mt.grid
    I = (slice(g.Hx, g.Hx + g.Nx), slice(g.Hy, g.Hy + g.Ny))
    for name, tol in (("u", 1e-4), ("v", 1e-4), ("sig11", 4e-3), ("sig22", 4e-3),
                      ("sig12", 4e-3), ("P", 1e-6), ("un", 1e-4), ("vn", 1e-4)):
        assert _rel(aj[name][I], at[name][I]) <= tol, name
    assert _rel(aj["alpha"], at["alpha"]) <= 4e-3
    assert np.abs(at["u"]).max() > 0 and np.abs(at["v"]).max() > 0


# --- gate and dispatch ----------------------------------------------------------

def _gate_models(lib):
    kw = {"device": "cpu"} if lib is cst else {}
    models = {case: _padded_model(lib, case, **kw) for case in PADDED_CASES}
    models["periodic"] = lib.sea_ice_model(
        _grid(lib, "periodic", "float32", **kw),
        dynamics=_dynamics(lib, "float32", 10, "always"), ice_thermodynamics=None)
    models["periodic_land"] = lib.sea_ice_model(
        _grid(lib, "periodic", "float32", island, **kw),
        dynamics=_dynamics(lib, "float32", 10, "always", lib.ImmersedDrag(1e-3)),
        ice_thermodynamics=None)
    models["float64"] = _case_model(lib, "immersed", "float64", **kw)
    models["stress_bc"] = lib.sea_ice_model(
        _grid(lib, "bounded", "float32", island, **kw),
        dynamics=_dynamics(lib, "float32", 10, "always",
                           lib.ImmersedStressBC(u_flux=lambda g, c, f: -f.u)),
        ice_thermodynamics=None)
    return models


def test_gate_agrees_with_jax_and_dispatch(monkeypatch):
    """padded_fused_available agrees with the JAX gate (whose VMEM budget
    all these small grids meet); momentum_step sends periodic grids without
    land to the periodic route, bounded or immersed float32 grids to the
    padded route, and float64 or fused='never' to the general path, with no
    kernel launch on CPU tensors."""
    from climaseaice_jl_tpu.dynamics.pallas_evp_padded import \
        padded_fused_available as jgate
    import climaseaice_jl_tpu as csi

    mj, mt = _gate_models(csi), _gate_models(cst)
    for name in mj:
        assert padded_fused_available(mt[name]) == jgate(mj[name]), name
    assert not padded_fused_available(mt["float64"])
    assert not padded_fused_available(mt["stress_bc"])

    routes = []
    for name, fn in (("fused", fused_split_explicit_momentum_step),
                     ("padded", padded_fused_momentum_step),
                     ("general", split_explicit_momentum_step)):
        attr = {"fused": "fused_split_explicit_momentum_step",
                "padded": "padded_fused_momentum_step",
                "general": "split_explicit_momentum_step"}[name]
        monkeypatch.setattr(tmodel, attr,
                            lambda *a, name=name, fn=fn: routes.append(name) or fn(*a))
    evp_counter.reset()
    padded_evp_counter.reset()
    expected = {"periodic": "fused", "walls": "padded", "immersed": "padded",
                "channel": "padded", "periodic_land": "padded", "arrays": "padded",
                "stress_function": "padded", "float64": "general", "stress_bc": "general"}
    for name, route in expected.items():
        m = mt[name]
        routes.clear()
        tmodel.momentum_step(m, tmodel.initial_state(m, h=0.5, a=1.0), 60.0)
        assert routes == [route], name
    never = _case_model(cst, "immersed", "float32", fused="never", device="cpu")
    routes.clear()
    tmodel.momentum_step(never, tmodel.initial_state(never, h=0.5, a=1.0), 60.0)
    assert routes == ["general"]
    assert evp_counter.launches == padded_evp_counter.launches == 0


# --- the slice as a whole: the 512² bounded configuration at 32² -------------------

def _slice_model(lib, dtype, fused, P_star=27.5, N=32, substeps=10, **grid_kw):
    """`validation/perf_sweep.py:build(N, bounded=True)` with P★ and the
    substeps set."""
    grid = lib.RectilinearGrid(size=(N, N), x=(0, 512 * km), y=(0, 512 * km), halo=5,
                               dtype=dtype, topology=("bounded", "bounded"), **grid_kw)
    x = (np.arange(N) + 0.5) * (512 * km / N)
    xc, yc = np.meshgrid(x, x, indexing="ij")
    grid = lib.ImmersedBoundaryGrid(grid, (xc - 256 * km) ** 2 + (yc - 256 * km) ** 2
                                    < (60 * km) ** 2)
    dynamics = lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=lib.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=lib.SemiImplicitStress(),
        immersed_drag=lib.ImmersedDrag(coefficient=1e-3),
        solver=lib.SplitExplicitSolver(substeps=substeps, fused=fused))
    return lib.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=lib.sea_ice_slab_thermodynamics(),
                             top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                             advection=lib.WENO(order=7), timestepper="SplitRungeKutta3")


def _h0(x, y):
    return 1.0 + 0.25 * np.sin(2 * np.pi * x / (512 * km)) * np.sin(2 * np.pi * y / (512 * km))


def _run_slice(dtype, fused, steps):
    import climaseaice_jl_tpu as csi
    mj = _slice_model(csi, dtype, fused)
    mt = _slice_model(cst, dtype, fused, device="cpu")
    sj = csi.initial_state(mj, h=_h0, a=1.0)
    st = state_from_numpy(mt, state_to_numpy(sj))
    for _ in range(steps):
        sj = csi.step(mj, sj, 120.0)
        st = cst.step(mt, st, 120.0)
    return mt, state_to_numpy(sj), state_to_numpy(st)


def _land_stays_empty(model, arrays):
    """h = ℵ = 0 on land cells, u = 0 on peripheral (f,c) and v = 0 on
    peripheral (c,f) nodes, over the interior."""
    g = model.grid
    I = (slice(g.Hx, g.Hx + g.Nx), slice(g.Hy, g.Hy + g.Ny))
    solid = g.solid_cc.numpy()[I]
    per_fc, per_cf, _ = (m.numpy()[I] for m in peripheral_masks(g))
    h, a, u, v = (arrays[n][I] for n in ("h", "a", "u", "v"))
    assert solid.any() and np.all(h[solid] == 0) and np.all(a[solid] == 0)
    assert np.all(u[per_fc] == 0) and np.all(v[per_cf] == 0)


def test_slice_float64_matches_jax():
    """The 32², 10-substep bounded and immersed main configuration, general
    path, float64 soft ice, 3 RK3 steps: every prognostic field ≤ 1e-11
    relative to JAX `fused="never"` (measured ≤ 1.9e-14); land stays empty."""
    mt, aj, at = _run_slice("float64", "never", 3)
    for name in ("h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu"):
        assert _rel(aj[name], at[name]) <= 1e-11, name
    _land_stays_empty(mt, at)


def test_slice_float32_padded_matches_pallas():
    """The same in float32 through the padded route (the kernel's plain
    version) vs JAX `fused="always"` (interpret mode), 2 RK3 steps; the bars
    of tests/test_pallas_evp.py:259: u/v ≤ 2e-4 of the larger velocity
    scale, h/ℵ ≤ 1e-5 (measured: u/v 4.3e-7, h/ℵ 4.8e-8); land stays
    empty."""
    mt, aj, at = _run_slice("float32", "always", 2)
    g = mt.grid
    I = (slice(g.Hx, g.Hx + g.Nx), slice(g.Hy, g.Hy + g.Ny))
    vel = max(np.abs(aj[n][I]).max() for n in ("u", "v"))
    for name in ("u", "v"):
        assert np.abs(at[name][I] - aj[name][I]).max() / vel <= 2e-4, name
    for name in ("h", "a"):
        assert _rel(aj[name][I], at[name][I]) <= 1e-5, name
    _land_stays_empty(mt, at)


# --- the CUDA kernel's schedule, emulated with the plain version ---------------------
#
# csrc/evp_padded_tile.cuh runs K substeps a launch on tiles held with an
# overlap of 2K positions; substep t computes σ and its first half-update on
# the output tile grown by 2(K − t) + 1 and its second half-update on the tile
# grown by 2(K − t); a velocity at a position is the update at its fill
# source (or zero); α is not loaded.  What a tile position stands for comes
# from a geometry: 2.3's tiles lie on the padded torus with one tile centred
# on the padded edge along a filled direction (csrc/evp_padded.cu's
# TorusGeometry), 2.5's in interior coordinates (tests/test_torch_fixed_tiles.py).

# csrc/evp_padded.cu's plan: (K substeps a launch, TX rows, TY columns of a
# tile's output)
KERNEL_PLAN_23 = (2, 22, 24)


def _fill_source(q, H, N, kind, face):
    """csrc/evp_padded.cu's fill_source over an index array: the padded
    index a fill copies from, −1 where it writes zero."""
    if H == 0 or kind == KIND_SPLIT:
        return q
    if kind == KIND_PERIODIC:
        return np.where(q < H, q + N, np.where(q >= H + N, q - N, q))
    if face:
        return np.where((q < H) | (q > H + N), -1, q)
    return np.clip(q, H, H + N - 1)


def _torus_tiles(ext, H, N, kind, T, O):
    """csrc/evp_padded.cu's TorusGeometry along one direction: per tile, the
    positions' carried, source and constant indices, the displacements to
    their fill sources (``zero`` where the face fill writes 0) and their
    output indices (−1: not written)."""
    seam = H > 0 and kind != KIND_SPLIT
    tiles = []
    for b in range(-(-ext // T)):
        if seam:
            o0 = -(T // 2) if b == 0 else T // 2 + (b - 1) * T
            end = o0 + T if b == 0 else min(o0 + T, ext - T // 2)
        else:
            o0, end = b * T, min(b * T + T, ext)
        p = np.arange(o0 - O, o0 + T + O)
        q = p % ext
        f, c = _fill_source(q, H, N, kind, True), _fill_source(q, H, N, kind, False)

        def step(src):   # to the source on the torus, across the edge where periodic
            d = src - q
            return np.where(d > 0, d - ext, np.where(d < 0, d + ext, d)) \
                if kind == KIND_PERIODIC else d

        tiles.append(dict(ld=q, ldF=f, ldC=c, cs=q, zero=f < 0,
                          dF=np.where(f < 0, 0, step(f)), dC=step(c),
                          out=np.where((p >= o0) & (p < end), q, -1)))
    return tiles


def _tile_schedule(params, consts, carry, nsub, K, O, tiles_x, tiles_y):
    """The tile engine's schedule on padded arrays, with the plain version's
    phase functions (:func:`padded_loop_functions` on the batch of tiles,
    its circular shifts wrapping inside a tile): each chunk gathers every
    tile (velocities at their fill sources, σ at the position, constants at
    theirs, α unknown: NaN), merges each phase's values into its region
    only, and writes the output positions back; a position whose source
    lies outside the tile's inner positions computes at itself, as the
    kernel's tables have it."""
    SX, SY = len(tiles_x[0]["ld"]), len(tiles_y[0]["ld"])
    TX, TY = SX - 2 * O, SY - 2 * O
    pairs = [(tx, ty) for tx in tiles_x for ty in tiles_y]
    B = len(pairs)

    def per_tile(key, axis):
        return torch.as_tensor(np.stack([t[axis][key] for t in pairs]))

    def stacked(key):
        return per_tile(key, 0)[:, :, None], per_tile(key, 1)[:, None, :]

    def gather(q, rows, cols):
        return q[rows.clamp(min=0), cols.clamp(min=0)]

    def source(d, S):    # tile positions of the sources, kept inside the tile
        at = torch.arange(S)[None, :] + d
        return torch.where((at >= 1) & (at <= S - 2), at, torch.arange(S)[None, :])

    ld_x, ld_y = stacked("ld")
    cs_x, cs_y = stacked("cs")
    zero_x, zero_y = stacked("zero")
    ldF_x, ldF_y = stacked("ldF")
    ldC_x, ldC_y = stacked("ldC")
    sF_x = source(per_tile("dF", 0), SX)[:, :, None]
    sC_x = source(per_tile("dC", 0), SX)[:, :, None]
    sF_y = source(per_tile("dF", 1), SY)[:, None, :]
    sC_y = source(per_tile("dC", 1), SY)[:, None, :]
    out_x, out_y = stacked("out")
    b = torch.arange(B)[:, None, None]

    def fill_fc(q):      # u: face along x, centre along y
        return torch.where(zero_x, 0.0, q[b, sF_x, sC_y])

    def fill_cf(q):
        return torch.where(zero_y, 0.0, q[b, sC_x, sF_y])

    functions = padded_loop_functions(params, [gather(q, cs_x, cs_y) for q in consts],
                                      fill_fc, fill_cf, ax=1)
    stresses, u_update, v_update = functions

    def region(R):
        m = torch.zeros(SX, SY, dtype=torch.bool)
        m[max(O - R, 0):O + TX + R, max(O - R, 0):O + TY + R] = True
        return m

    written = (out_x >= 0) & (out_y >= 0)
    flat = (out_x * carry[0].shape[1] + out_y)[written.expand(B, SX, SY)]
    state = [q.clone() for q in carry]
    for k0 in range(0, nsub, K):
        u = torch.where(zero_x, 0.0, gather(state[0], ldF_x, ldC_y))
        v = torch.where(zero_y, 0.0, gather(state[1], ldC_x, ldF_y))
        s11, s22, s12 = (gather(q, ld_x, ld_y) for q in state[2:5])
        al = torch.full_like(u, float("nan"))
        for t in range(1, min(K, nsub - k0) + 1):
            R = 2 * (K - t)
            inner, outer = region(R), region(R + 1)
            new = stresses(u, v, s11, s22, s12)
            s11, s22, s12, al = (torch.where(outer, n, o)
                                 for n, o in zip(new, (s11, s22, s12, al)))
            if (k0 + t) % 2 == 0:
                u = torch.where(outer, u_update(u, v, s11, s12, al), u)
                v = torch.where(inner, v_update(u, v, s22, s12, al), v)
            else:
                v = torch.where(outer, v_update(u, v, s22, s12, al), v)
                u = torch.where(inner, u_update(u, v, s11, s12, al), u)
        for q, tile in zip(state, (u, v, s11, s22, s12, al)):
            q.view(-1)[flat] = tile[written.expand(B, SX, SY)]
    return state


def _shard_model(model, state, shard, H):
    """Shard ``shard`` of a (2, 2) mesh of a global model whose halos are
    ``H`` wide (chip_smoke.py's shard_model): a grid naming the mesh axes,
    windows of the masks and of the state's EVP fields."""
    from climaseaice_jl_tpu_torch.parallel.stepper import ProcessMesh, _local_grid
    g = model.grid
    nx, ny = g.Nx // 2, g.Ny // 2
    lgrid = _local_grid(g, nx, ny, *shard, ("x", "y"), (2, 2),
                        ProcessMesh((2, 2), shard, g.device, transport=False))

    def cut(q):
        if not isinstance(q, torch.Tensor):
            return q
        ix, iy = shard
        return q[ix * nx:ix * nx + nx + 2 * H, iy * ny:iy * ny + ny + 2 * H].contiguous()

    masks = model.masks
    lmasks = masks.evolve(**{f: cut(getattr(masks, f)) for f in (
        "solid_cc", "per_fc", "per_cf", "per_ff", "imm_ff", "solid_full")})
    lstate = state.evolve(**{f: cut(getattr(state, f)) for f in (
        "h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha")})
    return model.evolve(grid=lgrid.evolve(solid_cc=lmasks.solid_cc), masks=lmasks), lstate


def _padded_case_inputs(case, nsub):
    """The loop's inputs at the default P★ (stiff ice, where every
    dependency shows in the bits; in soft ice the far ones round away) on
    the CUDA test's 70×45 grids, or on shard (1, 1) of a (2, 2) mesh of a
    40×40 periodic island with the wide halo 2·nsub + 3 ("split")."""
    stiff = cst.ElastoViscoPlasticRheology()
    if case == "split":
        H = 2 * nsub + 3
        grid = cst.ImmersedBoundaryGrid(
            cst.RectilinearGrid(size=(40, 40), x=(0, L), y=(0, L), halo=H, dtype="float32",
                                topology=("periodic", "periodic"), device="cpu"), island)
        dyn = _dynamics(cst, "float32", nsub, "always", drag=cst.ImmersedDrag(coefficient=2e4))
        dyn = dyn.evolve(rheology=stiff,
                         solver=cst.SplitExplicitSolver(substeps=nsub, halo_exchange="wide"))
        m = cst.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=cst.WENO(order=5), timestepper="ForwardEuler")
    else:
        m = _case_model(cst, case, "float32", substeps=nsub, size=(70, 45), device="cpu")
        m = m.evolve(dynamics=m.dynamics.evolve(rheology=stiff))
    rng = np.random.default_rng(2)
    s = tmodel.initial_state(m, h=0.5 + 0.1 * rng.random(m.grid.interior_shape), a=1.0,
                             u=0.02 + 0.01 * rng.standard_normal(m.grid.interior_shape),
                             v=0.01 * rng.standard_normal(m.grid.interior_shape))
    if case == "split":
        m, s = _shard_model(m, s, (1, 1), 2 * nsub + 3)
    return m, padded_evp_inputs(m, s, 60.0, s.u, s.v)[:3]


@pytest.mark.parametrize("case, nsub", [("walls", 5), ("immersed", 6), ("channel", 5),
                                        ("split", 5)])
def test_kernel_schedule_matches_plain_version(case, nsub):
    """2.3's schedule (csrc/evp_padded.cu's plan on the padded torus, one
    tile centred on the padded edge along a filled direction), emulated
    with the plain version, equals padded_evp_substeps_reference bitwise
    over the whole padded arrays, the outermost ring's σ and α included: on
    the CUDA test's 70×45 grids (walls; island with drag; periodic x with a
    coast), ragged last tiles, odd and even substep counts, and on a shard
    whose two directions are split (no fill, the padded torus's own
    neighbours); stiff ice, where every dependency shows."""
    m, (params, consts, carry) = _padded_case_inputs(case, nsub)
    K, TX, TY = KERNEL_PLAN_23
    g = m.grid
    kx, ky = direction_kinds(g)
    tiles_x = _torus_tiles(g.nxp, g.Hx, g.Nx, kx, TX, 2 * K)
    tiles_y = _torus_tiles(g.nyp, g.Hy, g.Ny, ky, TY, 2 * K)
    assert g.nxp % TX and g.nyp % TY      # ragged last tiles
    ref = padded_evp_substeps_reference(params, consts, carry, nsub, g)
    out = _tile_schedule(params, consts, carry, nsub, K, 2 * K, tiles_x, tiles_y)
    for name, r, o in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), ref, out):
        assert torch.equal(r, o), (case, name)


@pytest.mark.parametrize("case", ["channel", "split"])
def test_kernel_schedule_needs_its_overlap(case):
    """With tiles held one position short of the overlap 2K (the first
    substep's σ region then reaching the tile's edge, whose neighbours wrap
    inside the tile), the same schedule parts from the plain version: the
    overlap is no wider than the function needs."""
    nsub = 5
    m, (params, consts, carry) = _padded_case_inputs(case, nsub)
    K, TX, TY = KERNEL_PLAN_23
    g = m.grid
    kx, ky = direction_kinds(g)
    O = 2 * K - 1
    out = _tile_schedule(params, consts, carry, nsub, K, O,
                         _torus_tiles(g.nxp, g.Hx, g.Nx, kx, TX, O),
                         _torus_tiles(g.nyp, g.Hy, g.Ny, ky, TY, O))
    ref = padded_evp_substeps_reference(params, consts, carry, nsub, g)
    assert not all(torch.equal(r, o) for r, o in zip(ref, out))


# --- the CUDA kernel ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walls", "immersed", "channel"])
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    """The padded CUDA kernel vs padded_evp_substeps_reference on the same
    CUDA tensors, soft ice, 120 and 121 substeps (both parities of the
    ping-pong buffers), drag off (walls) and on, on a grid whose sides are
    not multiples of the kernel's block: bitwise over the whole padded
    arrays (the outermost ring's σ and α from its torus neighbours
    included), so within chip_smoke.py phase 6's bars, u/v ≤ 1e-4, σ/α ≤
    4e-3 relative to the field's largest value; one launch a chunk of the
    kernel's K substeps."""
    m = _case_model(cst, case, "float32", substeps=120, size=(70, 45), device=cuda_device)
    rng = np.random.default_rng(2)
    s = tmodel.initial_state(m, h=0.5 + 0.1 * rng.random(m.grid.interior_shape), a=1.0,
                             u=0.02 + 0.01 * rng.standard_normal(m.grid.interior_shape))
    params, consts, carry, _ = padded_evp_inputs(m, s, 60.0, s.u, s.v)
    assert (len(consts) == 22) == (case != "walls")
    K = chunk_substeps()
    assert K == KERNEL_PLAN_23[0]          # the plan the CPU emulation holds
    for nsub in (120, 121):
        ref = padded_evp_substeps_reference(params, consts, carry, nsub, m.grid)
        padded_evp_counter.reset()
        out = padded_evp_substeps(params, consts, [q.clone() for q in carry], nsub, m.grid)
        torch.cuda.synchronize()
        assert (padded_evp_counter.calls, padded_evp_counter.launches) == (1, -(-nsub // K))
        for name, a, b, tol in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"),
                                   out, ref, (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
            assert torch.isfinite(a).all(), name
            assert _rel(b.cpu().numpy(), a.cpu().numpy()) <= tol, (nsub, name)
            assert torch.equal(a, b), (nsub, name)
