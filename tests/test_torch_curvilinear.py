"""Curvilinear and tripolar sea ice in the port vs the JAX package: the
grids' metric arrays, the Zipper fold fills, masks and stresses on a folded
grid, LatitudeCoriolis, the curvilinear fused route (the CUDA kernel's plain
version) against the Pallas kernels 2.6 and 2.7 in interpret mode, the gates
and dispatch, the solid-row crop, and the tripolar Arctic basin as a whole.

The JAX package is imported inside the tests that compare with it, so that
the CUDA test runs on a machine without JAX (``pytest --noconftest -m cuda
tests/test_torch_curvilinear.py``)."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import arctic_basin, model as tmodel
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch.dynamics import coriolis as tcoriolis, stresses as tstresses
from climaseaice_jl_tpu_torch.dynamics import fused_evp_curvilinear as fec
from climaseaice_jl_tpu_torch.dynamics.fused_evp import evp_counter
from climaseaice_jl_tpu_torch.dynamics.fused_evp_curvilinear import (
    curvilinear_evp_counter, curvilinear_evp_inputs, curvilinear_evp_substeps,
    curvilinear_evp_substeps_reference, curvilinear_fused_available)
from climaseaice_jl_tpu_torch.dynamics.fused_evp_padded import (
    padded_evp_counter, padded_fused_available)
from climaseaice_jl_tpu_torch.fields import (FILLERS, _x_fold_indices, fill_halos_many,
                                             immersed_only_ff, peripheral_masks, solid_cc_mask)
from climaseaice_jl_tpu_torch.grids import _METRIC_LOCS

km = 1000.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.abs(y - x).max() / max(np.abs(x).max(), 1e-30)


# --- grids ----------------------------------------------------------------------

def _make_grid(lib, kind, dtype, **kw):
    if kind == "latlon":
        return lib.LatitudeLongitudeGrid((24, 16), latitude=(55.0, 75.0), halo=5,
                                         dtype=dtype, **kw)
    if kind == "curvilinear":   # a warped grid (tests/test_pallas_evp_tiled_curvilinear.py:53)
        N = 24
        i = np.arange(N + 1)[:, None]
        j = np.arange(N + 1)[None, :]
        lam = 360.0 * i / N + 4.0 * np.sin(2 * np.pi * j / N)
        phi = 20.0 + 40.0 * j / N + 3.0 * np.sin(2 * np.pi * i / N) * (j / N)
        lam[-1] = lam[0] + 360.0
        phi[-1] = phi[0]
        return lib.CurvilinearGrid(lam, phi, halo=5, dtype=dtype, **kw)
    if kind == "tripolar":
        return lib.TripolarGrid((32, 24), southernmost_latitude=40.0,
                                transition_latitude=62.0, halo=5, dtype=dtype, **kw)
    return lib.RectilinearGrid(size=(32, 24), x=(0, 100 * km), y=(0, 80 * km), halo=5,
                               dtype=dtype, topology=("periodic", "bounded"),
                               north_fold=True, **kw)


GRID_KINDS = ("latlon", "curvilinear", "tripolar", "rect_fold")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", GRID_KINDS)
def test_grid_metrics_equal_jax(kind, dtype):
    """Every metric array, coordinate and lon_cc/lat_cc equals JAX's element
    for element, in shape and dtype too (both build in float64 numpy and
    cast once)."""
    import climaseaice_jl_tpu as csi

    gj = _make_grid(csi, kind, dtype)
    gt = _make_grid(cst, kind, dtype, device="cpu")
    assert (gt.kind, gt.north_fold, gt.shape) == (gj.kind, gj.north_fold, gj.shape)
    for name in list(_METRIC_LOCS) + ["xc", "xf", "yc", "yf", "lon_cc", "lat_cc"]:
        a, b = getattr(gj, name), getattr(gt, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        assert b.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.parametrize("kind", ["tripolar", "rect_fold"])
def test_fold_fills_and_masks_equal_jax(kind):
    """The four fills with the Zipper fold (u and v change sign, the v seam
    row is projected) and fill_halos_many equal JAX's exactly on random
    fields; so do the folded grid's land mask halos, peripheral masks and
    immersed-only ff nodes."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu import fields as jfields

    gj = _make_grid(csi, kind, "float64")
    gt = _make_grid(cst, kind, "float64", device="cpu")
    rng = np.random.default_rng(0)
    locs = ("cc", "fc", "cf", "ff")
    qs = [rng.standard_normal(gj.shape) for _ in locs]
    for loc, q in zip(locs, qs):
        key = (loc[0], loc[1])
        np.testing.assert_array_equal(FILLERS[key](torch.tensor(q), gt).numpy(),
                                      np.asarray(jfields.FILLERS[key](q, gj)), err_msg=loc)
    for a, b in zip(fill_halos_many([torch.tensor(q) for q in qs], locs, gt),
                    jfields.fill_halos_many(qs, locs, gj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    mask = np.zeros(gj.interior_shape, bool)
    mask[:, :2] = True
    mask[5:9, -4:] = True                     # land reaching into the fold
    gji, gti = csi.ImmersedBoundaryGrid(gj, mask), cst.ImmersedBoundaryGrid(gt, mask)
    np.testing.assert_array_equal(gti.solid_cc.numpy(), np.asarray(gji.solid_cc))
    for g_t, g_j in ((gt, gj), (gti, gji)):
        for a, b in zip(peripheral_masks(g_t), jfields.peripheral_masks(g_j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(solid_cc_mask(g_t).numpy(),
                                      np.asarray(jfields.solid_cc_mask(g_j)))
    np.testing.assert_array_equal(immersed_only_ff(gti).numpy(),
                                  np.asarray(jfields.immersed_only_ff(gji)))


def test_latitude_coriolis_and_folded_stresses_equal_jax():
    """coriolis_f_cc, x_f_cross_U and y_f_cross_U of LatitudeCoriolis, and
    the explicit and implicit stresses with the Zipper sign flip on a
    tripolar grid, ≤ 1e-15 relative to JAX in float64 (measured ≤ 2e-16)."""
    import jax.numpy as jnp
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics import coriolis as jcoriolis, stresses as jstresses
    from climaseaice_jl_tpu.state import Clock as JClock, ModelFields as JFields

    gj = _make_grid(csi, "tripolar", "float64")
    gt = _make_grid(cst, "tripolar", "float64", device="cpu")
    rng = np.random.default_rng(1)
    h, u, v = (rng.random(gj.shape) + 0.5, 0.1 * rng.standard_normal(gj.shape),
               0.1 * rng.standard_normal(gj.shape))
    fj = JFields(h=jnp.asarray(h), u=jnp.asarray(u), v=jnp.asarray(v))
    ft = cst.ModelFields(h=torch.tensor(h), u=torch.tensor(u), v=torch.tensor(v))
    cj = JClock(time=jnp.asarray(5400.0), iteration=jnp.asarray(3))
    ct = cst.Clock(time=torch.tensor(5400.0, dtype=torch.float64), iteration=torch.tensor(3))

    corj, cort = csi.LatitudeCoriolis(), cst.LatitudeCoriolis()
    pairs = [(jcoriolis.coriolis_f_cc(corj, gj), tcoriolis.coriolis_f_cc(cort, gt))]
    for name in ("x_f_cross_U", "y_f_cross_U"):
        pairs.append((getattr(jcoriolis, name)(corj, gj, fj.u, fj.v),
                      getattr(tcoriolis, name)(cort, gt, ft.u, ft.v)))

    ue = 0.05 * rng.standard_normal(gj.shape)

    def stresses(lib):
        return ({"u": 0.05, "v": lib.StressFunction(func=lambda g, c, f: 0.02 * f.h)},
                lib.SemiImplicitStress(ue=ue, ve=-0.03))

    (tj, bj), (tt, bt) = stresses(csi), stresses(cst)
    bt = tstresses.place_stress(bt, gt)
    for name in ("explicit_tau_x", "explicit_tau_y", "implicit_tau_x_coefficient",
                 "implicit_tau_y_coefficient"):
        for sj, st in ((tj, tt), (bj, bt)):
            pairs.append((getattr(jstresses, name)(gj, sj, cj, fj),
                          getattr(tstresses, name)(gt, st, ct, ft)))
    for a, b in pairs:
        a = np.broadcast_to(np.asarray(a), gj.shape)
        b = b.broadcast_to(gt.shape).numpy()
        if np.abs(a).max() == 0:
            assert np.abs(b).max() == 0
        else:
            assert _rel(a, b) <= 1e-15
    # the fold flips a constant τ on the north halo
    tau = tstresses.explicit_tau_x(gt, 0.05, ct, ft).numpy()
    assert tau[gt.Hx, gt.Hy] == 0.05 and tau[gt.Hx, -1] == -0.05


# --- the curvilinear route's plain version vs the Pallas kernels ---------------------

def _dynamics(lib, coriolis, substeps=10, fused="always", drag=None, P_star=27.5):
    """The soft-ice dynamics of tests/test_pallas_evp_curvilinear.py:19-28."""
    return lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=coriolis,
        top_momentum_stress={"u": 0.05, "v": 0.02},
        bottom_momentum_stress=lib.SemiImplicitStress(ue=0.08, ve=-0.04),
        immersed_drag=drag,
        solver=lib.SplitExplicitSolver(substeps=substeps, fused=fused))


def _kernel_model(lib, case, substeps=10, fused="always", **grid_kw):
    """latlon: FPlane, no land, no drag (kernel 2.6); tripolar: masked poles,
    a coastal block and ImmersedDrag, FPlane (kernel 2.6); tripolar_lat: the
    same with a fully solid southern band and LatitudeCoriolis (kernel 2.7,
    whose solid-row crop is then on)."""
    if case == "latlon":
        grid = lib.LatitudeLongitudeGrid((24, 16), latitude=(55.0, 75.0), halo=5,
                                         dtype="float32", topology=("periodic", "bounded"),
                                         **grid_kw)
        return lib.sea_ice_model(grid, dynamics=_dynamics(lib, lib.FPlane(f=1.2e-4), substeps,
                                                          fused),
                                 ice_thermodynamics=None, advection=lib.WENO(order=5),
                                 timestepper="ForwardEuler")
    Nx, Ny = grid_kw.pop("size", (32, 24))
    grid = lib.TripolarGrid((Nx, Ny), southernmost_latitude=40.0, transition_latitude=62.0,
                            halo=5, dtype="float32", **grid_kw)
    mask = np.zeros((Nx, Ny), bool)
    mask[[0, 1, Nx - 1], Ny - 1] = True
    mask[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True
    mask[5:9, 3:7] = True
    if case == "tripolar_lat":
        mask[:, :2] = True
    cor = lib.FPlane(f=1.2e-4) if case == "tripolar" else lib.LatitudeCoriolis()
    return lib.sea_ice_model(lib.ImmersedBoundaryGrid(grid, mask),
                             dynamics=_dynamics(lib, cor, substeps, fused,
                                                drag=lib.ImmersedDrag(3e-3)),
                             ice_thermodynamics=None, advection=lib.WENO(order=5),
                             timestepper="ForwardEuler")


def _seeded_state(lib, model, seed=3):
    g = model.grid
    rng = np.random.default_rng(seed)
    return lib.initial_state(model, h=0.5 + 0.1 * rng.random(g.interior_shape), a=1.0,
                             u=0.05 * rng.standard_normal(g.interior_shape),
                             v=0.05 * rng.standard_normal(g.interior_shape))


KERNEL_CASES = ("latlon", "tripolar", "tripolar_lat")


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_curvilinear_plain_version_matches_pallas_interpret(case):
    """The curvilinear route on CPU tensors (the kernel's plain version) vs
    the JAX Pallas kernels in interpret mode, reached as
    `SplitExplicitSolver(fused="always")` reaches them: 2.6 with FPlane
    (latlon; tripolar with land and drag), 2.7 with LatitudeCoriolis (its
    solid-row crop on), float32, soft ice, 10 substeps, two successive calls.
    Bars of tests/test_pallas_evp.py:59-60 over the whole padded arrays:
    u/v ≤ 1e-4, σ/α ≤ 4e-3, P ≤ 1e-6 (measured u/v ≤ 4e-7, σ ≤ 1.5e-6, α and
    P 0).  No kernel is launched on CPU tensors."""
    import jax
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu import model as jmodel
    from climaseaice_jl_tpu.dynamics.pallas_evp_curvilinear import \
        curvilinear_fused_available as jgate26
    from climaseaice_jl_tpu.dynamics.pallas_evp_tiled_curvilinear import (
        _solid_crop_rows, tiled_curvilinear_available as jgate27)

    mj = _kernel_model(csi, case)
    mt = _kernel_model(cst, case, device="cpu")
    assert curvilinear_fused_available(mt)
    if case == "tripolar_lat":
        assert not jgate26(mj) and jgate27(mj) and _solid_crop_rows(mj) == 2
    else:
        assert jgate26(mj)
    sj = _seeded_state(csi, mj)
    st = state_from_numpy(mt, state_to_numpy(sj))
    step_j = jax.jit(lambda s: jmodel.momentum_step(mj, s, 60.0))

    curvilinear_evp_counter.reset()
    for _ in range(2):
        sj = step_j(sj)
        st = tmodel.momentum_step(mt, st, 60.0)
    assert curvilinear_evp_counter.calls == 0
    aj, at = state_to_numpy(sj), state_to_numpy(st)
    for name, tol in (("u", 1e-4), ("v", 1e-4), ("sig11", 4e-3), ("sig22", 4e-3),
                      ("sig12", 4e-3), ("alpha", 4e-3), ("P", 1e-6)):
        assert _rel(aj[name], at[name]) <= tol, (name, _rel(aj[name], at[name]))
    assert np.abs(at["u"]).max() > 0 and np.abs(at["v"]).max() > 0


def test_curvilinear_plain_version_computes_the_padded_function():
    """On a bounded rectilinear grid with an island and ImmersedDrag
    (uniform metrics, no fold) the curvilinear route's plain version equals
    the padded route's over the whole padded arrays, float32, soft ice, 12
    substeps: u/v ≤ 1e-4, σ/α ≤ 4e-3 (measured u 0, v 5.5e-9, σ ≤ 1.4e-7,
    α 0).  The gate still sends such grids to the padded route, whose
    kernel is the faster of the two there (chip_smoke.py phase 6)."""
    from climaseaice_jl_tpu_torch.dynamics import fused_evp_padded as tpadded
    from climaseaice_jl_tpu_torch.dynamics import fused_evp_curvilinear as tcurv
    N = 40
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 4e5), y=(0, 4e5), halo=5, dtype="float32",
                               topology=("bounded", "bounded"), device="cpu")
    xc = (np.arange(N) + 0.5) * (4e5 / N)
    X, Y = np.meshgrid(xc, xc, indexing="ij")
    grid = cst.ImmersedBoundaryGrid(grid, (X - 2e5) ** 2 + (Y - 2e5) ** 2 < 6e4 ** 2)
    m = cst.sea_ice_model(grid, dynamics=_dynamics(cst, cst.FPlane(f=1.2e-4), 12, "auto",
                                                   drag=cst.ImmersedDrag(3e-3)),
                          ice_thermodynamics=None, advection=cst.WENO(order=5),
                          timestepper="ForwardEuler")
    assert tpadded.padded_fused_available(m) and not tcurv.curvilinear_fused_available(m)
    s = _seeded_state(cst, m)
    p_params, p_consts, p_carry, _ = tpadded.padded_evp_inputs(m, s, 60.0, s.u, s.v)
    c_params, c_consts, c_carry, _, planes = tcurv.curvilinear_evp_inputs(m, s, 60.0, s.u, s.v)
    assert planes is None and len(c_consts) == 34
    ref = tpadded.padded_evp_substeps_reference(p_params, p_consts, p_carry, 12, m.grid)
    out = tcurv.curvilinear_evp_substeps_reference(c_params, c_consts, c_carry, 12, m.grid)
    for name, r, o, tol in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), ref, out,
                               (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        assert _rel(r.numpy(), o.numpy()) <= tol, (name, _rel(r.numpy(), o.numpy()))
    assert ref[0].abs().max() > 0 and ref[1].abs().max() > 0


# --- gates and dispatch --------------------------------------------------------------

def _gate_models(lib):
    kw = {"device": "cpu"} if lib is cst else {}
    models = {case: _kernel_model(lib, case, **kw) for case in KERNEL_CASES}
    rect = _make_grid(lib, "rect_fold", "float32", **kw)
    models["rect_fold"] = lib.sea_ice_model(rect, dynamics=_dynamics(lib, lib.FPlane(1e-4)),
                                            ice_thermodynamics=None)
    plain = lib.RectilinearGrid(size=(16, 16), x=(0, 1e5), y=(0, 1e5), halo=5,
                                dtype="float32", topology=("periodic", "bounded"), **kw)
    models["rect"] = lib.sea_ice_model(plain, dynamics=_dynamics(lib, lib.FPlane(1e-4)),
                                       ice_thermodynamics=None)
    models["float64"] = lib.sea_ice_model(_make_grid(lib, "tripolar", "float64", **kw),
                                          dynamics=_dynamics(lib, lib.FPlane(1e-4)),
                                          ice_thermodynamics=None)
    return models


def test_gates_and_dispatch(monkeypatch):
    """curvilinear_fused_available takes what JAX's 2.6 or 2.7 gate takes
    (these small grids meet their VMEM budgets) and refuses plain rectilinear
    grids and float64.  A RectilinearGrid with a north fold goes to the
    curvilinear route and never to the padded one, whose gate refuses it as
    `pallas_evp_padded.py:60` does.  momentum_step dispatches in the JAX
    order; fused='never' keeps the general path; nothing is launched on CPU
    tensors."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.pallas_evp_curvilinear import \
        curvilinear_fused_available as jgate26
    from climaseaice_jl_tpu.dynamics.pallas_evp_padded import \
        padded_fused_available as jpadded
    from climaseaice_jl_tpu.dynamics.pallas_evp_tiled_curvilinear import \
        tiled_curvilinear_available as jgate27

    mj, mt = _gate_models(csi), _gate_models(cst)
    for name in mj:
        assert curvilinear_fused_available(mt[name]) == (jgate26(mj[name])
                                                         or jgate27(mj[name])), name
        assert padded_fused_available(mt[name]) == jpadded(mj[name]), name
    assert curvilinear_fused_available(mt["rect_fold"])
    assert not padded_fused_available(mt["rect_fold"])
    assert not curvilinear_fused_available(mt["float64"])

    routes = []
    for attr, name in (("curvilinear_fused_momentum_step", "curvilinear"),
                       ("fused_split_explicit_momentum_step", "fused"),
                       ("padded_fused_momentum_step", "padded"),
                       ("split_explicit_momentum_step", "general")):
        fn = getattr(tmodel, attr)
        monkeypatch.setattr(tmodel, attr,
                            lambda *a, name=name, fn=fn: routes.append(name) or fn(*a))
    for counter in (evp_counter, padded_evp_counter, curvilinear_evp_counter):
        counter.reset()
    expected = {"latlon": "curvilinear", "tripolar": "curvilinear",
                "tripolar_lat": "curvilinear", "rect_fold": "curvilinear",
                "rect": "padded", "float64": "general"}
    for name, route in expected.items():
        routes.clear()
        m = mt[name]
        tmodel.momentum_step(m, tmodel.initial_state(m, h=0.5, a=1.0), 60.0)
        assert routes == [route], name
    never = _kernel_model(cst, "tripolar", fused="never", device="cpu")
    routes.clear()
    tmodel.momentum_step(never, tmodel.initial_state(never, h=0.5, a=1.0), 60.0)
    assert routes == ["general"]
    assert evp_counter.launches == padded_evp_counter.launches == 0
    assert curvilinear_evp_counter.launches == 0


# --- the solid-row crop ------------------------------------------------------------

def test_solid_row_crop_changes_no_number():
    """The tracer tendencies of a basin whose ≥ 32 southern rows are land
    equal, bit for bit, those computed without the crop, and the crop count
    equals JAX's `_solid_crop_rows`."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.pallas_evp_tiled_curvilinear import _solid_crop_rows

    m = arctic_basin.basin_model(96, 80, substeps=4, device="cpu")
    assert m.masks.solid_rows >= 32
    grid_j = csi.ImmersedBoundaryGrid(
        csi.TripolarGrid((96, 80), southernmost_latitude=45.0, transition_latitude=65.0,
                         halo=5, dtype="float32"),
        m.grid.interior(m.grid.solid_cc).numpy())
    mj = csi.sea_ice_model(grid_j, dynamics=_dynamics(csi, csi.LatitudeCoriolis()),
                           advection=csi.WENO(order=7))
    assert _solid_crop_rows(mj) == m.masks.solid_rows
    rng = np.random.default_rng(4)
    s = arctic_basin.basin_state(m)
    s = s.evolve(u=s.u + 0.1 * torch.tensor(rng.standard_normal(m.grid.shape), dtype=torch.float32),
                 v=s.v + 0.1 * torch.tensor(rng.standard_normal(m.grid.shape), dtype=torch.float32))
    s = tmodel.update_state(m, s)
    cropped = tmodel.tracer_tendencies(m, s)
    full = tmodel.tracer_tendencies(m.evolve(masks=m.masks.evolve(solid_rows=0)), s)
    for a, b in zip(cropped[:3], full[:3]):
        assert torch.equal(a, b)


# --- the tripolar Arctic basin -----------------------------------------------------

def _jax_basin(Nx, Ny, substeps, P_star, dtype):
    """`validation/run_tripolar_basin.py:build(Nx, Ny)` with the dtype, P★
    and substeps set, its arrays in the grid dtype."""
    import jax.numpy as jnp
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.forcing_utils import FieldTimeSeries

    deg = np.pi / 180.0
    grid = csi.TripolarGrid((Nx, Ny), southernmost_latitude=45.0, transition_latitude=65.0,
                            halo=5, dtype=dtype)
    lon = (np.asarray(grid.lon_cc) + 180.0) % 360.0 - 180.0
    lat = np.asarray(grid.lat_cc)
    I = grid.interior
    lonI, latI = I(lon), I(lat)
    land = latI < 58.0
    land |= (lonI > 20) & (lonI < 180) & (latI < 73.0)
    land |= (lonI > -170) & (lonI < -60) & (latI < 72.0)
    land |= (lonI > -60) & (lonI < -20) & (latI < 80.0)
    land[[0, 1, Nx - 1], Ny - 1] = True
    land[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True
    dmin = np.minimum(I(np.asarray(grid.dx_cc)), I(np.asarray(grid.dy_cc)))
    land |= dmin < 0.2 * np.median(dmin)
    grid = csi.ImmersedBoundaryGrid(grid, land)

    lon_r, lat_r = jnp.asarray(lon * deg), jnp.asarray(lat * deg)

    def stereo(lon0, lat0):
        x = jnp.cos(lat_r) * jnp.sin(lon_r - lon0 * deg)
        y = (np.cos(lat0 * deg) * jnp.sin(lat_r)
             - np.sin(lat0 * deg) * jnp.cos(lat_r) * jnp.cos(lon_r - lon0 * deg))
        return x, y

    gx, gy = stereo(-150.0, 80.0)
    fx, fy = stereo(0.0, 78.0)
    r2 = gx * gx + gy * gy
    gyre_amp = jnp.exp(-r2 / (2 * 0.25 ** 2))
    tau_gx = gyre_amp * gy / jnp.sqrt(r2 + 1e-6)
    tau_gy = -gyre_amp * gx / jnp.sqrt(r2 + 1e-6)
    drift = jnp.exp(-(fx * fx + fy * fy) / (2 * 0.6 ** 2))

    def seasonal(clock):
        return 1.0 + 0.4 * jnp.cos(2 * jnp.pi * clock.time / (360 * 86400.0))

    def wind_u(grid_, clock, fields):
        return 0.12 * seasonal(clock) * (0.7 * tau_gx + 0.5 * (-drift * fx))

    def wind_v(grid_, clock, fields):
        return 0.12 * seasonal(clock) * (0.7 * tau_gy + 0.5 * (-drift * fy))

    series = [FieldTimeSeries(times=arctic_basin.TIMES, data=tab, cyclical=True)
              for tab in (arctic_basin.TAB_SHORTWAVE, arctic_basin.TAB_LONGWAVE,
                          arctic_basin.TAB_SENSIBLE, arctic_basin.TAB_LATENT)]
    sw_scale = jnp.asarray(np.clip(np.cos(lat * deg) / math.cos(75.0 * deg), 0.3, 1.6))

    def solar_flux(grid_, Tu, clock, fields, fts):
        albedo = jnp.where(Tu < -0.1, 0.75, 0.64)
        return fts.at_time(clock.time) * sw_scale * (1 - albedo)

    top_heat_flux = (csi.FluxFunction(func=solar_flux, parameters=series[0],
                                      top_temperature_dependent=True),
                     *series[1:],
                     csi.RadiativeEmission(emissivity=1.0,
                                           stefan_boltzmann_constant=5.67e-8 * 1.02))
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=csi.LatitudeCoriolis(),
        top_momentum_stress={"u": csi.StressFunction(func=wind_u),
                             "v": csi.StressFunction(func=wind_v)},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        immersed_drag=csi.ImmersedDrag(coefficient=1e-3),
        solver=csi.SplitExplicitSolver(substeps=substeps, fused="never"))
    return csi.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=csi.sea_ice_slab_thermodynamics(),
                             snow_thermodynamics=csi.snow_slab_thermodynamics(),
                             snowfall=3.2e-6, top_heat_flux=top_heat_flux,
                             bottom_heat_flux=-2.0, advection=csi.WENO(order=7),
                             timestepper="SplitRungeKutta3")


def test_basin_recipe_matches_validation_script():
    """The port's basin (land mask, winds, heat flux, initial state) at
    96×80 float32 against `validation/run_tripolar_basin.py:build(96, 80)`:
    the land masks are equal, the winds and the fluxes agree to float32
    rounding (≤ 1e-6 relative), the initial states exactly."""
    import importlib.util
    import jax.numpy as jnp
    from climaseaice_jl_tpu.state import Clock as JClock
    from climaseaice_jl_tpu.model import make_fields as jfields
    from climaseaice_jl_tpu.thermodynamics.heat_bcs import getflux as jgetflux

    spec = importlib.util.spec_from_file_location(
        "run_tripolar_basin", os.path.join(REPO, "validation", "run_tripolar_basin.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
        mj, sj = mod.build(96, 80, substeps=4)
    finally:
        sys.path[:] = saved
    mt = arctic_basin.basin_model(96, 80, substeps=4, device="cpu")
    st = arctic_basin.basin_state(mt)
    np.testing.assert_array_equal(mt.grid.solid_cc.numpy(), np.asarray(mj.grid.solid_cc))
    aj, at = state_to_numpy(sj), state_to_numpy(st)
    for name in ("h", "a", "hs", "u", "v", "Tu", "Tus"):
        np.testing.assert_array_equal(at[name], aj[name], err_msg=name)

    t = 200 * 86400.0
    cj = JClock(time=jnp.asarray(t, jnp.float32), iteration=jnp.asarray(0))
    ct = cst.Clock(time=torch.tensor(t, dtype=torch.float32), iteration=torch.tensor(0))
    for comp in ("u", "v"):
        a = mj.dynamics.top_momentum_stress[comp].func(mj.grid, cj, None)
        b = mt.dynamics.top_momentum_stress[comp].func(mt.grid, ct, None)
        assert _rel(a, b.numpy()) <= 1e-6, comp
    Tu = np.full(mt.grid.shape, -5.0, np.float32)
    qj = jgetflux(mj.top_heat_flux, mj.grid, jnp.asarray(Tu), cj, jfields(mj, sj))
    qt = cst.getflux(mt.top_heat_flux, mt.grid, torch.tensor(Tu), ct,
                     tmodel.make_fields(mt, st))
    assert _rel(np.broadcast_to(qj, mt.grid.shape), qt.numpy()) <= 1e-6


def test_basin_float64_general_path_matches_jax():
    """The basin at 48×40 (2,900 padded points), float64, soft ice (P★ =
    27.5), 8 substeps, through the general path (`fused="never"`): snow,
    FieldTimeSeries fluxes, LatitudeCoriolis, StressFunction winds, drag,
    fold, land and the solid-row crop; 3 RK3 steps of 300 s.  Every field
    ≤ 1e-11 relative to `csi.step` (measured: prognostic fields ≤ 9.1e-14,
    the mf_ice diagnostic 1.5e-12; mf_snow, a difference of nearly equal
    snow volumes, is left out); land stays empty."""
    import climaseaice_jl_tpu as csi

    mj = _jax_basin(48, 40, 8, 27.5, "float64")
    mt = arctic_basin.basin_model(48, 40, substeps=8, P_star=27.5, dtype="float64",
                                  device="cpu", fused="never")
    g = mt.grid
    np.testing.assert_array_equal(g.solid_cc.numpy(), np.asarray(mj.grid.solid_cc))
    # ice on every ocean cell: open water that freezes makes new ice of
    # exactly the consolidation thickness, where `h ≥ hc` is decided by the
    # last bit of transcendental functions that XLA and libm round apart
    lat = g.interior(g.lat_cc).numpy()
    ocean = ~g.interior(g.solid_cc).numpy()
    h0 = np.where(ocean, 0.4 + 1.6 * np.clip((lat - 58.0) / 30.0, 0.0, 1.0), 0.0)
    a0 = np.where(ocean, 0.7 + 0.3 * np.clip((lat - 58.0) / 20.0, 0.0, 1.0), 0.0)
    sj = csi.initial_state(mj, h=h0, a=a0, hs=0.0)
    st = state_from_numpy(mt, state_to_numpy(sj))
    for _ in range(3):
        sj = csi.step(mj, sj, 300.0)
        st = cst.step(mt, st, 300.0)
    aj, at = state_to_numpy(sj), state_to_numpy(st)
    for name in ("h", "a", "hs", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu", "Tus",
                 "mf_ice", "Qtop"):
        assert _rel(aj[name], at[name]) <= 1e-11, (name, _rel(aj[name], at[name]))
    assert at["hs"].max() > 0 and np.abs(at["u"]).max() > 0
    solid = mt.grid.solid_cc.numpy()
    assert (at["h"][solid] == 0).all() and (at["hs"][solid] == 0).all()


def test_basin_float32_runs_through_entry_points():
    """The basin at 96×80 in float32, 20 substeps, through `cst.step` and
    `cst.Simulation(...).run()` on CPU tensors (the curvilinear route's plain
    version): finite everywhere, halos included; h, hs ≥ 0, 0 ≤ ℵ ≤ 1; no
    ice or snow on land; the fold halo of u is minus its mirror."""
    m = arctic_basin.basin_model(96, 80, substeps=20, device="cpu")
    assert curvilinear_fused_available(m)
    s = arctic_basin.basin_state(m)
    for _ in range(2):
        s = cst.step(m, s, 300.0)
    sim = cst.Simulation(m, s, dt=300.0, stop_iteration=4)
    sim.run()
    s = sim.state
    g = m.grid
    for name in ("h", "a", "hs", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu", "Tus"):
        assert torch.isfinite(getattr(s, name)).all(), name
    assert s.h.min() >= 0 and s.hs.min() >= 0 and s.a.min() >= 0 and s.a.max() <= 1
    solid = g.solid_cc
    assert (s.h[solid] == 0).all() and (s.a[solid] == 0).all() and (s.hs[solid] == 0).all()
    assert s.hs.max() > 0 and s.u.abs().max() > 0
    src = torch.as_tensor(_x_fold_indices(g, True))
    north = s.u[:, g.Hy + g.Ny:]
    mirror = s.u[src][:, g.Ny:g.Hy + g.Ny].flip(1)   # rows Hy+Ny-1-k
    assert torch.equal(north, -mirror)


# --- the settled blocks of the CUDA kernel (2.6) ------------------------------------

def _settled_case(case):
    """(params, consts, carry, grid, f_planes) of the curvilinear kernel on
    the 96×80 basin (``basin``, LatitudeCoriolis) or the 32×64 folded basin
    without fixed_tiles (``folded``, FPlane), 8 substeps, with seeded
    velocities everywhere, land included, so that the sign of the zeros
    that land points settle to is exercised."""
    from climaseaice_jl_tpu_torch import distributed_basin
    if case == "basin":
        m = arctic_basin.basin_model(96, 80, substeps=8, device="cpu")
        s, dt = arctic_basin.basin_state(m), 300.0
    else:
        m, s = distributed_basin.build(32, 64, substeps=8, device="cpu")
        dt = 600.0
    rng = np.random.default_rng(21)
    noise = [0.05 * torch.tensor(rng.standard_normal(m.grid.shape), dtype=torch.float32)
             for _ in range(2)]
    params, consts, carry, _, planes = curvilinear_evp_inputs(m, s, dt, s.u + noise[0],
                                                              s.v + noise[1])
    return params, consts, carry, m.grid, planes


def _kill(consts, grid, where):
    """``consts`` with every point of the boolean (nxp, nyp) ``where`` made
    dead: no mass at cc, ff, (f,c) and (c,f) (γ² coefficients −1, 1/m 0)
    and inactive; the drag, masks and stresses as they were."""
    out = list(consts)
    for idx, value in ((2, -1.0), (3, -1.0), (5, 0.0), (6, 0.0), (9, 0.0), (10, 0.0)):
        q = out[fec.N_METRICS + idx]
        out[fec.N_METRICS + idx] = torch.where(where, torch.tensor(value, dtype=q.dtype), q)
    return tuple(out)


def _folded_dead_zone(grid):
    """The southern 40 rows and 12 columns at each x edge of the padded
    folded grid: with them dead, blocks settle at the south, along both x
    edges and in the northern halo, whose fold sources lie at the other
    x edge."""
    i, j = torch.meshgrid(torch.arange(grid.nxp), torch.arange(grid.nyp), indexing="ij")
    return (j < grid.Hy + 40) | (i < 12) | (i >= grid.nxp - 12)


def _substeps_from(monkeypatch, first, params, consts, carry, grid, planes):
    """One substep of the plain version numbered ``first`` (only its parity
    matters): the plain loop's counter shifted."""
    import builtins
    monkeypatch.setattr(fec, "range", lambda a, b: builtins.range(a + first - 1, b + first - 1),
                        raising=False)
    try:
        return fec.curvilinear_evp_substeps_reference(params, consts, carry, 1, grid, planes)
    finally:
        monkeypatch.delattr(fec, "range")


def _bits(q):
    return q.contiguous().view(torch.int32)


@pytest.mark.parametrize("route", ["basin", "folded", "fixed_tiles"])
def test_kernel_masks_are_zero_or_one(route):
    """The CUDA kernel keeps act_u, act_v, msk_cc and msk_ff as one bit a
    point, where its plain version multiplies by their values, so every
    launcher that feeds it builds them from boolean masks: the basin and
    the folded basin through :func:`curvilinear_evp_inputs`, and the
    tripolar fixed-tile route's coefficients handed to the whole-array
    kernel (`fused_evp_tiled_curvilinear.curvilinear_consts`)."""
    if route == "fixed_tiles":
        from climaseaice_jl_tpu_torch import distributed_basin
        from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_curvilinear as ttc
        m, s = distributed_basin.build(32, 64, substeps=8, fixed_tiles=(8, 128), device="cpu")
        plan = ttc._fixed_plan(m.grid, 8, (8, 128), widen_fold=True)
        params, planes, _, grid, flags = ttc.tiled_curvilinear_inputs(
            m, s, 600.0, s.u, s.v, Hw=2 * plan[0] + 5)
        _, consts, _ = ttc.curvilinear_consts(params, planes, grid, plan, flags)
    else:
        _, consts, _, _, _ = _settled_case(route)
    core = consts[fec.N_METRICS:fec.N_METRICS + fec.N_CONSTS]
    for name, idx in (("act_u", 6), ("act_v", 10), ("msk_cc", 12), ("msk_ff", 13)):
        q = core[idx]
        assert bool(((q == 0) | (q == 1)).all()), (route, name)
        assert bool((q == 1).any()), (route, name)


@pytest.mark.parametrize("case", ["basin", "folded"])
def test_settled_flags_are_conservative(case):
    """The plain version of the kernel's flag launch: some blocks settled
    and some not; one icy point (gcc > 0) in a settled block, or next to
    it, unsettles it; on the folded grid a block of the northern halo whose
    every point and neighbour is dead stays unsettled while one fold source
    its threads compute at is active, and settles when that source dies."""
    params, consts, carry, grid, planes = _settled_case(case)
    flags = fec.settled_blocks_reference(consts, grid)
    bx, by = fec.BLOCK
    assert flags.shape == (-(-grid.nxp // bx), -(-grid.nyp // by))
    if case == "basin":
        assert flags.any() and not flags.all()
        bi, bj = (int(q) for q in flags.nonzero()[0])
        for di, dj in ((3, 5), (-1, 7), (bx, by)):   # inside, and one point outside
            icy = list(consts)
            gcc = icy[fec.N_METRICS + 2].clone()
            gcc[(bi * bx + di) % grid.nxp, (bj * by + dj) % grid.nyp] = 1.0
            icy[fec.N_METRICS + 2] = gcc
            assert not fec.settled_blocks_reference(icy, grid)[bi, bj], (di, dj)
    # every point dead: every block settled
    base = fec.N_METRICS
    core = _kill(consts, grid, torch.ones(grid.shape, dtype=torch.bool))
    assert fec.settled_blocks_reference(core, grid).all()
    if case == "folded":
        # the halo point (Hx + 1, seam + 2) of block (0, top) takes u from the
        # fold column Nx − 1 + Hx, far from the block's rows
        i, j = grid.Hx + 1, grid.Hy + grid.Ny + 2
        src = fec.fill_sources(grid)
        si, sj = int(src["u"][0][i, j]), int(src["u"][1][i, j])
        assert abs(si - i) > bx and j // by == sj // by
        live = list(core)   # one active point at the fold source
        gcc = live[base + 2].clone()
        gcc[si, sj] = 1.0
        live[base + 2] = gcc
        flags = fec.settled_blocks_reference(live, grid)
        assert not flags[0, j // by]
        assert flags[0, 0]


@pytest.mark.parametrize("drag", [True, False])
@pytest.mark.parametrize("case", ["basin", "folded"])
def test_settled_blocks_frozen_equal_plain_version(monkeypatch, case, drag):
    """The kernel's skip emulated with its plain version: substeps one by
    one, and from substep FIRST_SKIPPED on every point of a settled block
    keeps what the kernel leaves there (σ and α from substep 3; u and v
    from the buffer of that parity: substep 3's after odd substeps, 2's
    after even ones).  Equal to the plain version over 9 substeps bit for
    bit (signs of zero included), with and without the immersed drag
    (its four arrays left out).  The 32×64 folded basin has no settled
    block of its own, so there the points of ``_folded_dead_zone`` are
    made dead, which settles blocks in the northern halo too."""
    params, consts, carry, grid, planes = _settled_case(case)
    if case == "folded":
        consts = _kill(consts, grid, _folded_dead_zone(grid))
    if not drag:
        consts = consts[:fec.N_METRICS + fec.N_CONSTS] + consts[-fec.N_STRESS:]
    assert (len(consts) == 34) == drag
    nsub = 9   # odd: the result is the buffer of the odd substeps
    full = fec.curvilinear_evp_substeps_reference(params, consts, carry, nsub, grid, planes)
    bx, by = fec.BLOCK
    flags = fec.settled_blocks_reference(consts, grid)
    frozen = flags.repeat_interleave(bx, 0).repeat_interleave(by, 1)[:grid.nxp, :grid.nyp]
    assert frozen.any()
    if case == "folded":
        assert flags[:, -1].any()   # blocks of the northern halo
    first = fec.FIRST_SKIPPED
    state, kept = tuple(carry), {}
    for k in range(1, nsub + 1):
        state = _substeps_from(monkeypatch, k, params, consts, state, grid, planes)
        kept[k] = state
        if k >= first:
            # the last substep that wrote the u and v buffer read after substep k
            last = first - 1 if (k - first + 1) % 2 == 0 else first - 2
            held = list(kept[last][:2]) + list(kept[first - 1][2:])
            state = tuple(torch.where(frozen, h, q) for h, q in zip(held, state))
    for name, a, b in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), full, state):
        assert torch.equal(_bits(a), _bits(b)), (case, drag, name)


# --- the CUDA kernel ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    """The curvilinear CUDA kernel vs curvilinear_evp_substeps_reference on
    the same CUDA tensors, soft ice, 120 and 121 substeps (both parities of
    the ping-pong buffers), on grids whose sides are not multiples of the
    kernel's block.  Bars of chip_smoke.py phase 10: u/v ≤ 1e-4, σ/α ≤ 4e-3
    relative to the field's largest value, over the whole padded arrays."""
    kw = {} if case == "latlon" else {"size": (70, 46)}
    m = _kernel_model(cst, case, substeps=120, device=cuda_device, **kw)
    s = _seeded_state(cst, m)
    params, consts, carry, _, f_planes = curvilinear_evp_inputs(m, s, 60.0, s.u, s.v)
    for nsub in (120, 121):
        ref = curvilinear_evp_substeps_reference(params, consts, carry, nsub, m.grid, f_planes)
        curvilinear_evp_counter.reset()
        out = curvilinear_evp_substeps(params, consts, [q.clone() for q in carry], nsub,
                                       m.grid, f_planes)
        torch.cuda.synchronize()
        assert (curvilinear_evp_counter.calls, curvilinear_evp_counter.launches) == \
            (1, 3 * nsub + 3)
        for name, a, b, tol in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"),
                                   out, ref, (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
            assert torch.isfinite(a).all(), name
            assert _rel(b.cpu().numpy(), a.cpu().numpy()) <= tol, (nsub, name)


@pytest.mark.cuda
@pytest.mark.parametrize("drag", [True, False])
@pytest.mark.parametrize("case", ["basin", "folded"])
def test_cuda_settled_blocks_match_plain_version(cuda_device, case, drag):
    """The kernel on the inputs of test_settled_blocks_frozen_equal_plain_version
    moved to the card (the 96×80 basin; the 32×64 folded basin with its dead
    zone), 9 and 10 substeps: its settled flags equal the plain version's
    (:func:`settled_blocks_reference`), and its results equal the plain
    version's on the same CUDA tensors bit for bit."""
    params, consts, carry, grid, planes = _settled_case(case)
    if case == "folded":
        consts = _kill(consts, grid, _folded_dead_zone(grid))
    if not drag:
        consts = consts[:fec.N_METRICS + fec.N_CONSTS] + consts[-fec.N_STRESS:]
    dev = cuda_device
    params, consts, carry = (params.to(dev), tuple(q.to(dev) for q in consts),
                             tuple(q.to(dev) for q in carry))
    planes = None if planes is None else tuple(q.to(dev) for q in planes)
    flags = fec.settled_blocks_reference(consts, grid)
    assert flags.any()
    for nsub in (9, 10):
        settled = torch.full((flags.numel(),), -1, dtype=torch.int32, device=dev)
        out = curvilinear_evp_substeps(params, consts, [q.clone() for q in carry], nsub, grid,
                                       planes, settled=settled)
        ref = curvilinear_evp_substeps_reference(params, consts, carry, nsub, grid, planes)
        torch.cuda.synchronize()
        assert torch.equal(settled.view(flags.shape) != 0, flags)
        for name, a, b in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), out, ref):
            assert torch.equal(a, b), (nsub, name, (a - b).abs().max().item())


@pytest.mark.cuda
def test_cuda_fplane_planes_equal_scalar(cuda_device):
    """An FPlane f given as two planes gives the scalar form's result bit
    for bit."""
    m = _kernel_model(cst, "tripolar", substeps=30, device=cuda_device)
    s = _seeded_state(cst, m)
    params, consts, carry, _, f_planes = curvilinear_evp_inputs(m, s, 60.0, s.u, s.v)
    assert f_planes is None
    f = torch.full(m.grid.shape, 1.2e-4, dtype=torch.float32, device=cuda_device)
    a = curvilinear_evp_substeps(params, consts, [q.clone() for q in carry], 30, m.grid)
    b = curvilinear_evp_substeps(params, consts, [q.clone() for q in carry], 30, m.grid,
                                 (f, f.clone()))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
