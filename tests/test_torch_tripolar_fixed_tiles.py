"""The tripolar fixed-tile basin in the port vs the JAX package:
``validation/run_distributed_basin.py:build(Nx, Ny, fixed_tiles=(8, 128))``
and its four kernels, the pinned curvilinear EVP loop (2.7), the ice
strength (2.8), the pointwise winds (2.10) and the column physics with a
``FluxFunction`` (2.11), with the gate, the widening, the whole step and the
halo-5 against halo-19 bitwise contract.

The JAX package is imported inside the tests that compare with it, so that
the CUDA tests run on a machine without JAX (``pytest --noconftest -m cuda
tests/test_torch_tripolar_fixed_tiles.py``).  The JAX reference runs with
x64 off (``jax.enable_x64(False)``): under x64 its fixed-tile
thermodynamics mixes float32 and float64 in the secant's carry."""

import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch import distributed_basin as db
from climaseaice_jl_tpu_torch.convert import state_from_numpy, _FIELDS
from climaseaice_jl_tpu_torch.grids import repad_metric, _METRIC_LOCS
from climaseaice_jl_tpu_torch import fields as tfields
from climaseaice_jl_tpu_torch.dynamics import fixed_tile_advection as tadv
from climaseaice_jl_tpu_torch.dynamics import fixed_tile_codegen as codegen
from climaseaice_jl_tpu_torch.dynamics import fixed_tile_pointwise as fp
from climaseaice_jl_tpu_torch.dynamics import fused_evp_curvilinear as tcurv
from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_curvilinear as ttc
from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_padded as ttiled
from climaseaice_jl_tpu_torch.thermodynamics import fixed_tile_thermo as tthermo

REPO = Path(__file__).resolve().parents[1]
SIZE = (32, 64)
FIXED = (8, 128)
DT = 600.0
DAY = 86400.0
DYNAMICS = ("u", "v", "sig11", "sig22", "sig12", "alpha")
BARS = dict(u=1e-4, v=1e-4, sig11=4e-3, sig22=4e-3, sig12=4e-3, alpha=4e-3, h=1e-5, a=1e-5,
            hs=2e-4, Tu=1e-5)


# --- helpers --------------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's PyTorch CPU work on one intra-op thread.  The tier-1
    run puts six test workers on the machine's cores, and PyTorch's OpenMP
    pool spins while it waits for threads that are not scheduled: under
    that load the plain tile emulation ran hundreds of times slower with
    the default pool than with one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x32():
    import jax
    return jax.enable_x64(False)


def _script():
    """validation/run_distributed_basin.py as a module."""
    spec = importlib.util.spec_from_file_location("run_distributed_basin",
                                                  REPO / "validation" / "run_distributed_basin.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _soft(model):
    """The model with P★ = 27.5 (soft ice, where float32 formulations agree)."""
    dyn = model.dynamics
    rheo = dataclasses.replace(dyn.rheology, ice_compressive_strength=27.5)
    return dataclasses.replace(model, dynamics=dataclasses.replace(dyn, rheology=rheo))


def _to_port(mt, sj):
    arrays = {n: np.asarray(getattr(sj, n)) for n in _FIELDS if getattr(sj, n, None) is not None}
    arrays["time"] = np.asarray(sj.clock.time)
    arrays["iteration"] = np.asarray(sj.clock.iteration)
    return state_from_numpy(mt, arrays)


def _interior(grid, q):
    q = q.detach().cpu().numpy() if isinstance(q, torch.Tensor) else np.asarray(q)
    return q[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(b - a).max() / max(np.abs(a).max(), 1e-30)


def _seeded(csi, mj, sj, seed=0):
    """The basin state of ``sj`` with seeded velocities (JAX)."""
    g = mj.grid
    rng = np.random.default_rng(seed)
    u, v = (0.05 * rng.standard_normal(g.interior_shape).astype(np.float32) for _ in range(2))
    return csi.initial_state(mj, h=_interior(g, sj.h), a=_interior(g, sj.a),
                             hs=_interior(g, sj.hs), u=u, v=v, time=150 * DAY)


@pytest.fixture(scope="module")
def basin():
    """The 32×64 basin in both packages, soft ice, seeded velocities:
    (csi, script, JAX model, JAX state, port model, port state)."""
    import climaseaice_jl_tpu as csi
    script = _script()
    with _x32():
        mj, sj = script.build(*SIZE, fixed_tiles=FIXED)
        mj = _soft(mj)
        sj = _seeded(csi, mj, sj)
    mt = _soft(db.build(*SIZE, fixed_tiles=FIXED, device="cpu")[0])
    return csi, script, mj, sj, mt, _to_port(mt, sj)


# --- construction, gate and plan ---------------------------------------------------------

def test_build_matches_script():
    """The port's build gives the script's land, initial fields and
    configuration, bit for bit where it sets arrays."""
    script = _script()
    with _x32():
        mj, sj = script.build(*SIZE, fixed_tiles=FIXED)
    mt, st = db.build(*SIZE, fixed_tiles=FIXED, device="cpu")
    assert np.array_equal(np.asarray(mj.grid.solid_cc), mt.grid.solid_cc.numpy())
    for name in ("h", "a", "hs", "u", "v", "Tu", "alpha"):
        assert np.array_equal(np.asarray(getattr(sj, name)), getattr(st, name).numpy()), name
    solver = mt.dynamics.solver
    assert (solver.substeps, solver.fixed_tiles, solver.halo_exchange, solver.fused) == (
        24, FIXED, "wide", "always")
    assert mt.timestepper == "ForwardEuler"
    eager = db.build(*SIZE, device="cpu")[0].dynamics.solver
    assert (eager.fixed_tiles, eager.halo_exchange, eager.fused) == (None, "per_substep", "auto")


def _grid_case(lib, case, **kw):
    if case == "folded-rect":
        return lib.RectilinearGrid(size=SIZE, x=(0, 64e3), y=(0, 128e3), halo=5,
                                   dtype="float32", topology=("periodic", "bounded"),
                                   north_fold=True, **kw)
    Ny = 64 if case == "latlon" else 128
    return lib.LatitudeLongitudeGrid((48, Ny), latitude=(50.0, 80.0), halo=5, dtype="float32",
                                     topology=("periodic", "bounded"), **kw)


def _gate_model(lib, case, fixed=FIXED, substeps=24):
    if case.startswith("basin"):
        if lib is cst:
            return db.build(*SIZE, substeps=substeps, fixed_tiles=fixed, device="cpu")[0]
        with _x32():
            return _script().build(*SIZE, substeps=substeps, fixed_tiles=fixed)[0]
    g = _grid_case(lib, case, **({"device": "cpu"} if lib is cst else {}))
    dyn = lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(), coriolis=lib.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.1, "v": 0.05}, bottom_momentum_stress=lib.SemiImplicitStress(),
        solver=lib.SplitExplicitSolver(substeps=substeps, fixed_tiles=fixed, fused="always",
                                       halo_exchange="wide"))
    return lib.sea_ice_model(g, dynamics=dyn, advection=lib.WENO(order=7),
                             ice_thermodynamics=None)


GATE_CASES = {
    "basin": dict(), "basin-tx12": dict(fixed=(12, 128)), "basin-ty64": dict(fixed=(8, 64)),
    "basin-prime-substeps": dict(substeps=17), "basin-8-substeps": dict(substeps=8),
    "folded-rect": dict(), "latlon": dict(), "latlon-north-wall-refused": dict(),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_and_plan_match_jax(case):
    """tiled_curvilinear_available and the pinned plan decide as the JAX
    gate and `_fixed_plan` do (the JAX VMEM budget is far from binding
    here): the basin, a folded rectilinear grid, latitude-longitude bands
    with one y tile and with two (refused: the north wall would trigger in
    two tiles), and refusals for TX, TY and prime substeps."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics import pallas_evp_tiled_curvilinear as jtc
    mj = _gate_model(csi, case, **GATE_CASES[case])
    mt = _gate_model(cst, case, **GATE_CASES[case])
    assert ttc.tiled_curvilinear_available(mt) == jtc.tiled_curvilinear_available(mj)
    solver = mt.dynamics.solver
    mult = jtc._MULT_DRAG if jtc._drag_on(mj) else jtc._MULT
    assert ttc._fixed_plan(mt.grid, solver.substeps, solver.fixed_tiles,
                           widen_fold=mt.grid.north_fold) == jtc._fixed_plan(
        mj.grid, solver.substeps, solver.fixed_tiles, mult, widen_fold=mj.grid.north_fold)
    expect = case in ("basin", "basin-8-substeps", "folded-rect", "latlon")
    assert ttc.tiled_curvilinear_available(mt) == expect


def test_route_needs_fixed_tiles_and_a_serial_grid():
    """Without fixed_tiles the whole-array route computes the function on one
    card, so the pinned route is not taken; fixed_tiles no longer raises on
    folds and array metrics, nor on a sharded grid, where the route needs
    the wide y halo: with the fold split across x and the serial halo it is
    not taken, and the local fills raise (the JAX package's message)."""
    from climaseaice_jl_tpu_torch.parallel.stepper import _local_grid
    m = db.build(*SIZE, device="cpu")[0]
    assert not ttc.tiled_curvilinear_available(m) and tcurv.curvilinear_fused_available(m)
    m = db.build(*SIZE, fixed_tiles=FIXED, device="cpu")[0]
    assert tmodel.fixed_tiles(m.grid, m.dynamics) == FIXED
    assert not tcurv.curvilinear_fused_available(m) and not ttiled.tiled_padded_available(m)
    sharded = _local_grid(m.grid, SIZE[0] // 2, SIZE[1], 0, 0, ("x", None), (2, 1))
    assert tmodel.fixed_tiles(sharded, m.dynamics) == FIXED
    assert not ttc.tiled_curvilinear_available(m.evolve(grid=sharded))
    with pytest.raises(NotImplementedError, match="split across the x mesh"):
        tfields.fill_halos_cc_local(torch.zeros(sharded.shape), sharded)


def test_repad_metric_and_local_fills_match_jax():
    """The widened metrics equal `_jnp_repad_metric`'s bit for bit (seam
    symmetrisation in float32 included), and the local fills equal the
    JAX package's on a serial folded grid."""
    import jax.numpy as jnp
    from climaseaice_jl_tpu import fields as jfields
    from climaseaice_jl_tpu.dynamics.pallas_evp_tiled_curvilinear import _jnp_repad_metric
    g = _port_grid()
    with _x32():
        gj = _script().build(*SIZE, fixed_tiles=FIXED, thermo=False)[0].grid
        for name, loc in list(_METRIC_LOCS.items()) + [("lat_cc", (False, False))]:
            ref = np.asarray(_jnp_repad_metric(gj, getattr(gj, name), gj.Hx, 29, *loc))
            got = repad_metric(g, getattr(g, name), 29, *loc).numpy()
            assert np.array_equal(ref, got), name
        q = np.random.default_rng(3).standard_normal(gj.shape).astype(np.float32)
        for loc in ("cc", "fc", "cf", "ff"):
            ref = np.asarray(getattr(jfields, f"fill_halos_{loc}_local")(jnp.asarray(q), gj))
            got = getattr(tfields, f"fill_halos_{loc}_local")(torch.from_numpy(q), g)
            assert np.array_equal(ref, got.numpy()), loc


def _port_grid():
    return db.build(*SIZE, thermo=False, device="cpu")[0].grid


# --- 2.7 and 2.8 -------------------------------------------------------------------------

def test_tiled_evp_matches_jax(basin):
    """The plain version of the pinned tiled kernel, through its launcher,
    against `tiled_curvilinear_momentum_step` in interpret mode on the
    32×64 basin (widened to a 29-row y halo, two chunks of 12 substeps), soft
    ice: u/v ≤ 1e-4, σ/α ≤ 4e-3 of the field's largest value over the
    interior; and the returned P within 2 ulp."""
    from climaseaice_jl_tpu.dynamics.pallas_evp_tiled_curvilinear import (
        tiled_curvilinear_momentum_step)
    csi, _, mj, sj, mt, st = basin
    with _x32():
        ref = tiled_curvilinear_momentum_step(mj, sj, DT, sj.u, sj.v, interpret=True)
    out = ttc.tiled_curvilinear_momentum_step(mt, st, DT, st.u, st.v)
    for name in DYNAMICS:
        a, b = _interior(mt.grid, ref[name]), _interior(mt.grid, out[name])
        assert np.isfinite(b).all(), name
        assert _rel(a, b) <= BARS[name], (name, _rel(a, b))
    np.testing.assert_array_max_ulp(np.asarray(ref["P"]), out["P"].numpy(), maxulp=2)
    assert torch.equal(out["un"], st.u) and torch.equal(out["Delta"], st.Delta)


def test_ice_strength_matches_jax(basin):
    """2.8's plain version against `_fixed_tile_P` (interpret mode) on the
    widened h, ℵ: within 2 ulp."""
    from climaseaice_jl_tpu.dynamics.pallas_evp_tiled_curvilinear import _fixed_tile_P
    _, _, mj, sj, mt, st = basin
    with _x32():
        ref = np.asarray(_fixed_tile_P(mj, sj.h, sj.a, FIXED, True))
    out = ttc.fixed_tile_P(ttc.ice_strength_params(mt), st.h, st.a)
    np.testing.assert_array_max_ulp(ref, out.numpy(), maxulp=2)


def test_tiled_evp_plan_and_chunk_invariant(basin):
    """The plain version gives bitwise-equal interiors with chunks of 12, 4
    and 2 substeps (the fold refilled more often) and with (16, 256) tiles."""
    _, _, _, _, mt, st = basin
    K = 12
    params, planes, carry, grid, flags = ttc.tiled_curvilinear_inputs(mt, st, DT, st.u, st.v,
                                                                      Hw=2 * K + 5)
    plan = ttc._fixed_plan(mt.grid, 24, FIXED, widen_fold=True)
    runs = [ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, 24, grid, p,
                                                         flags, chunk=c)
            for p, c in ((plan, None), (plan, 4), (plan, 2),
                         (ttc._fixed_plan(mt.grid, 24, (16, 256), widen_fold=True), None))]
    for name, *qs in zip(DYNAMICS, *runs):
        for q in qs[1:]:
            assert np.array_equal(_interior(grid, qs[0]), _interior(grid, q)), name


@pytest.mark.parametrize("drag", [None, 1e3])
def test_fold_halo_evolves_exactly_but_for_the_immersed_drag(basin, drag):
    """Chunks of 12 against chunks of 2 with the immersed drag off and a
    million times stronger than the basin's.  The drag samples each face's
    flux at that face's own index (JAX `momentum.py:183-196`): beyond the
    seam north and south swap, so a fold-halo point next to land drags
    another velocity than its mirror, and the evolved halo departs from the
    exact mirror there.  Without the drag the interiors are bitwise equal;
    with it they part only in the top interior row."""
    _, _, _, _, mt, st = basin
    dyn = mt.dynamics
    m = dataclasses.replace(mt, dynamics=dataclasses.replace(
        dyn, immersed_drag=None if drag is None else cst.ImmersedDrag(coefficient=drag)))
    params, planes, carry, grid, flags = ttc.tiled_curvilinear_inputs(m, st, DT, st.u, st.v,
                                                                      Hw=29)
    assert flags[1] is (drag is not None)
    plan = ttc._fixed_plan(m.grid, 24, FIXED, widen_fold=True)
    runs = [ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, 24, grid, plan,
                                                         flags, chunk=c) for c in (None, 2)]
    rows = set()
    for name, a, b in zip(DYNAMICS, *runs):
        differ = _interior(grid, a) != _interior(grid, b)
        rows |= set(np.nonzero(differ)[1].tolist())
    assert rows == (set() if drag is None else {grid.Ny - 1})


def test_tiled_evp_equals_whole_array_route_on_same_input(basin):
    """Fed the coefficients this route derives, the whole-array kernel's
    plain version (which refills the fold after every half-update) gives
    the interiors of the pinned route's (whose fold halo evolves between
    refills): within 1e-6 of each field's largest value on the CPU, where
    each operation rounds on its own."""
    _, _, _, _, mt, st = basin
    params, planes, carry, grid, flags = ttc.tiled_curvilinear_inputs(mt, st, DT, st.u, st.v,
                                                                      Hw=29)
    plan = ttc._fixed_plan(mt.grid, 24, FIXED, widen_fold=True)
    tiled = ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, 24, grid, plan,
                                                         flags)
    p18, consts, f_planes = ttc.curvilinear_consts(params, planes, grid, plan, flags)
    whole = tcurv.curvilinear_evp_substeps_reference(p18, consts, carry, 24, grid, f_planes)
    for name, a, b in zip(DYNAMICS, tiled, whole):
        assert _rel(_interior(grid, a), _interior(grid, b)) <= 1e-6, name


# --- 2.7's settled blocks ------------------------------------------------------------------

def _bits(q):
    return q.contiguous().view(torch.int32)


def _settled_case(case, device="cpu", nsub=9):
    """(params, planes, carry, grid, plan, flags) of 2.7 on the 32×64 basin in
    soft ice with seeded velocities: ``serial`` widened to the plan's 2K+5
    y-halo rows (the fold refilled between chunks), ``no-drag`` the same
    without the immersed drag, ``dead-band`` the serial case with no ice in
    interior rows 0-52, which settles launch-block row 1 (y 32-63) whole
    where the seeded velocities are not zero (the first substep leaves −0
    where u or v was negative, the second +0), ``shard`` the pinned plan on
    shard (1, 1) of a (2, 2) mesh with halos 2·nsub+3 (x and y split, the
    fold split across x and never refilled)."""
    from climaseaice_jl_tpu_torch.parallel.stepper import ProcessMesh, _local_grid
    if case != "shard":
        m, s = _card_basin(device)
        if case == "no-drag":
            m = dataclasses.replace(m, dynamics=dataclasses.replace(m.dynamics,
                                                                    immersed_drag=None))
        plan = ttc._fixed_plan(m.grid, nsub, FIXED, widen_fold=True)
        params, planes, carry, grid, flags = ttc.tiled_curvilinear_inputs(
            m, s, DT, s.u, s.v, Hw=2 * plan[0] + 5)
        if case == "dead-band":
            planes = list(planes)
            planes[ttc.C_H] = planes[ttc.C_H].clone()
            planes[ttc.C_H][:, grid.Hy:grid.Hy + 53] = 0
            planes = tuple(planes)
        return params, planes, carry, grid, plan, flags
    H = 2 * nsub + 3
    m, s = _card_basin(device, halo=H)
    g = m.grid
    params, planes, carry, _, flags = ttc.tiled_curvilinear_inputs(m, s, DT, s.u, s.v)
    mesh, (ix, iy) = (2, 2), (1, 1)
    nx, ny = g.Nx // 2, g.Ny // 2
    grid = _local_grid(g, nx, ny, ix, iy, ("x", "y"), mesh,
                       ProcessMesh(mesh, (ix, iy), g.device, transport=False))

    def window(q):
        return q[ix * nx:ix * nx + nx + 2 * H, iy * ny:iy * ny + ny + 2 * H].contiguous()

    return (params, tuple(window(q) for q in planes), tuple(window(q) for q in carry), grid,
            ttc._fixed_plan(grid, nsub, FIXED), flags)


def _frozen(flags, grid):
    bx, by = ttc.BLOCK
    return flags.repeat_interleave(bx, 0).repeat_interleave(by, 1)[:grid.nxp, :grid.nyp]


def _sweeps(params, planes, carry, nsub, grid, plan, flags, chunk, frozen=None):
    """The plain version one substep at a time, as the kernel runs them: the
    fold refilled before each chunk of ``chunk`` substeps where it is
    refilled, every substep gathered onto the plan's tiles and scattered
    back.  With ``frozen`` (padded points), the kernel's skip: from substep
    FIRST_SKIPPED on those points keep what they held after the substep
    before it, and each refill must leave them as they are, signed zeros
    included.  The kernel ping-pongs u and v between two buffers, so a
    skipped point's neighbours read, on alternate substeps, what it held
    after substep FIRST_SKIPPED − 2 and after FIRST_SKIPPED − 1: the two
    must be the same bits, and so must what each skipped substep would have
    written there, which is asserted."""
    tiles = ttc._Tiles(grid, plan, params.device)
    c = [tiles.gather(q) for q in planes]
    k = ttc._coefficients(params, c, tiles, flags)
    one, fill_fc, fill_cf = ttc._substep_functions(params, c, k, tiles, flags)
    state, kept, before = tuple(carry), None, tuple(carry)
    for s in range(1, nsub + 1):
        if tiles.geo.refill and (s - 1) % chunk == 0:
            refilled = ttc._refill(state, grid)
            if kept is not None:
                for name, a, b in zip(DYNAMICS, state, refilled):
                    assert torch.equal(_bits(a)[frozen], _bits(b)[frozen]), (s, name)
            state = refilled
        u, v, s11, s22, s12, alpha = (tiles.gather(q) for q in state)
        state = tuple(tiles.scatter(q) for q in one((fill_fc(u), fill_cf(v), s11, s22, s12,
                                                     alpha), s % 2 == 0))
        if frozen is None:
            continue
        if s == ttc.FIRST_SKIPPED - 2:
            before = state
        elif s >= ttc.FIRST_SKIPPED - 1:
            for name, a, b in zip(DYNAMICS, before if kept is None else kept, state):
                assert torch.equal(_bits(a)[frozen], _bits(b)[frozen]), (s, name)
            if kept is None:
                kept = state
            state = tuple(torch.where(frozen, h, q) for h, q in zip(kept, state))
    return state


def test_tiled_settled_flags_are_conservative():
    """The plain version of 2.7's flag launch on the widened 32×64 basin:
    some blocks settled and some not; one icy point in a settled block, or
    next to it, unsettles it.  With every point dead every block settles but
    those that hold fold rows: from a dead state the refill writes −0 into
    the fold rows (the negated mirror of +0), which the skipped updates
    would not turn back.  A block of halo columns stays unsettled while the
    interior image its points compute at, at the far x edge, is active."""
    params, planes, carry, grid, plan, flags = _settled_case("serial")
    settled = ttc.tiled_settled_blocks_reference(params, planes, grid, plan, flags)
    bx, by = ttc.BLOCK
    assert settled.shape == (-(-grid.nxp // bx), -(-grid.nyp // by))
    assert settled.any() and not settled.all()
    # a settled block whose rows and the rows next to it lie in the interior
    # (a halo column's coefficients are its interior image's)
    bi, bj = next((int(a), int(b)) for a, b in settled.nonzero()
                  if grid.Hx < a * bx and (a + 1) * bx < grid.Hx + grid.Nx)
    for di, dj in ((3, 5), (-1, 7), (bx, by)):   # inside, and one point outside
        icy = list(planes)
        for c in (ttc.C_H, ttc.C_A):
            icy[c] = icy[c].clone()
            icy[c][(bi * bx + di) % grid.nxp, (bj * by + dj) % grid.nyp] = 1.0
        assert not ttc.tiled_settled_blocks_reference(params, icy, grid, plan, flags)[bi, bj]
    # every point dead: every block but those holding fold rows settled
    dead = list(planes)
    dead[ttc.C_H] = torch.zeros_like(planes[ttc.C_H])
    seam = grid.Hy + grid.Ny
    settled = ttc.tiled_settled_blocks_reference(params, dead, grid, plan, flags)
    holds_fold = (torch.arange(settled.shape[1]) + 1) * by > seam
    assert bool(settled[:, ~holds_fold].all()) and not settled[:, holds_fold].any()
    state = ttc.tiled_curvilinear_evp_substeps_reference(params, dead, carry, 3, grid, plan,
                                                         flags)
    refilled = ttc._refill(state, grid)
    for name, a, b in zip(DYNAMICS[:2], state, refilled):
        moved = (_bits(a) != _bits(b)).nonzero()
        assert len(moved) and bool((moved[:, 1] >= seam).all()), name
        assert bool((a[_bits(a) != _bits(b)] == 0).all()), name
    # the halo column Hx − 2 computes at its image Nx + Hx − 2
    live = list(dead)
    j = grid.Hy + 10
    for c in (ttc.C_H, ttc.C_A):
        live[c] = live[c].clone()
        live[c][grid.Nx + grid.Hx - 2, j] = 1.0
    settled = ttc.tiled_settled_blocks_reference(params, live, grid, plan, flags)
    assert (grid.Nx + grid.Hx - 2) // bx > 1
    assert not settled[0, j // by] and settled[1, j // by]


def test_tiled_settled_flags_do_not_depend_on_the_plan():
    """The flags are the kernel's, which runs whole arrays: the pinned plan
    and the unpinned one (no y overlap along the bounded y, where a tile's
    circular shift would read the far edge) give the same flags."""
    params, planes, carry, grid, plan, flags = _settled_case("serial")
    unpinned = ttc._unpinned_plan(grid, 9)
    assert unpinned[4] == 0
    assert torch.equal(ttc.tiled_settled_blocks_reference(params, planes, grid, plan, flags),
                       ttc.tiled_settled_blocks_reference(params, planes, grid, unpinned, flags))


@pytest.mark.parametrize("case", ["serial", "no-drag", "dead-band", "shard"])
def test_tiled_settled_blocks_frozen_equal_plain_version(case):
    """2.7's skip emulated with the plain version (:func:`_sweeps`): the
    points of settled blocks frozen from substep FIRST_SKIPPED on give the
    whole padded arrays of the unfrozen run bit for bit, signed zeros
    included, over 9 substeps in chunks of 4 on the widened serial basin
    (two refills after the skip starts, each leaving the frozen points as
    they are), with and without the immersed drag, with a dead band whose
    velocities settle over two substeps (so both of the kernel's u and v
    buffers must be past them when the skip starts), and over 8 substeps
    on a shard whose split fold is never refilled; and the unfrozen run
    gives the plain version's interiors."""
    source = (REPO / "climaseaice_jl_tpu_torch/csrc/evp_tiled_curvilinear.cu").read_text()
    assert f"constexpr int FIRST_SKIPPED = {ttc.FIRST_SKIPPED};" in source
    nsub = 8 if case == "shard" else 9
    params, planes, carry, grid, plan, flags = _settled_case(case, nsub=nsub)
    assert flags[1] is (case != "no-drag")
    chunk = plan[0] if case == "shard" else 4
    frozen = _frozen(ttc.tiled_settled_blocks_reference(params, planes, grid, plan, flags),
                     grid)
    assert frozen.any() and not frozen.all()
    free = _sweeps(params, planes, carry, nsub, grid, plan, flags, chunk)
    held = _sweeps(params, planes, carry, nsub, grid, plan, flags, chunk, frozen)
    ref = ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, nsub, grid, plan,
                                                       flags, chunk=chunk)
    for name, f, h, r in zip(DYNAMICS, free, held, ref):
        assert torch.equal(_bits(f), _bits(h)), (case, name)
        assert torch.equal(grid.interior(f), grid.interior(r)), (case, name)


# --- 2.10: the pointwise winds --------------------------------------------------------------

_UNARY = {fp.OP_NEG: torch.neg, fp.OP_RECIP: torch.reciprocal, fp.OP_SIN: torch.sin,
          fp.OP_COS: torch.cos, fp.OP_EXP: torch.exp, fp.OP_SQRT: torch.sqrt,
          fp.OP_ABS: torch.abs, fp.OP_NOT: lambda x: (x == 0).float()}
_BINARY = {fp.OP_ADD: torch.add, fp.OP_SUB: torch.sub, fp.OP_MUL: torch.mul,
           fp.OP_DIV: torch.div, fp.OP_REM: torch.remainder, fp.OP_MIN: torch.minimum,
           fp.OP_MAX: torch.maximum, fp.OP_LT: lambda x, y: (x < y).float(),
           fp.OP_LE: lambda x, y: (x <= y).float(), fp.OP_GT: lambda x, y: (x > y).float(),
           fp.OP_GE: lambda x, y: (x >= y).float(), fp.OP_EQ: lambda x, y: (x == y).float(),
           fp.OP_NE: lambda x, y: (x != y).float(),
           fp.OP_AND: lambda x, y: ((x != 0) & (y != 0)).float(),
           fp.OP_OR: lambda x, y: ((x != 0) | (y != 0)).float()}


def _run_program(rec, inputs, T=None):
    """A recording run as csrc/pointwise_program.cuh runs it, with torch's
    float32 operations on the CPU (x / c as x·(1/c))."""
    st, regs = [], {}
    for op, a, b in rec.ops:
        if op == fp.OP_CONST:
            st.append(torch.tensor(a, dtype=torch.float32))
        elif op == fp.OP_ARRAY:
            st.append(T if rec.slots[a] == ("temp",) else inputs[rec.slots[a]])
        elif op == fp.OP_SCALAR:
            st.append(rec.captured[a].cpu())
        elif op == fp.OP_LOAD:
            st.append(regs[a])
        elif op == fp.OP_STORE:
            regs[a] = st[-1]
        elif op == fp.OP_DIVC:
            st[-1] = st[-1] * torch.tensor(np.float32(1) / np.float32(a))
        elif op == fp.OP_CLAMP:
            st[-1] = torch.clamp(st[-1], a, b)
        elif op == fp.OP_WHERE:
            y, x = st.pop(), st.pop()
            st[-1] = torch.where(st[-1] != 0, x, y)
        elif op in _UNARY:
            st[-1] = _UNARY[op](st[-1])
        else:
            y = st.pop()
            st[-1] = _BINARY[op](st[-1], y)
    assert len(st) == 1
    return st[0]


def _twin(values, k, tensors, divc=lambda x, c: x / c):
    """A flux's SSA values (fixed_tile_codegen.ssa) evaluated in the
    generated unit's order with the plain version's float32 operations on
    the CPU (x / c as ``divc`` forms it: by default it divides, as the
    column's plain version does): the T-independent values once, as the
    unit's prologue; ``flux(T)`` the rest.  ``k`` and ``tensors`` are the
    plan's constants and the tensors behind its pointers."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731

    def value(v, operand, T):
        x = [operand(i) for i in v.args]
        if v.op == fp.OP_CONST:
            return f32(k[v.a])
        if v.op in (fp.OP_ARRAY, fp.OP_SCALAR):
            return tensors[v.a]
        if v.op == fp.OP_TEMP:
            return T
        if v.op == fp.OP_EMISSION:
            return k[v.a] * (T + k[v.b]) ** 4
        if v.op == fp.OP_DIVC:
            return divc(x[0], f32(k[v.a]))
        if v.op == fp.OP_CLAMP:
            return torch.clamp(x[0], None if v.a < 0 else k[v.a], None if v.b < 0 else k[v.b])
        if v.op == fp.OP_WHERE:
            return torch.where(x[0] != 0, x[1], x[2])
        if v.op in _UNARY:
            return _UNARY[v.op](x[0])
        return _BINARY[v.op](x[0], x[1])

    prologue = {}
    for i, v in enumerate(values):
        if not v.t_dep:
            prologue[i] = value(v, prologue.__getitem__, None)

    def flux(T):
        got = dict(prologue)
        for i, v in enumerate(values):
            if v.t_dep:
                got[i] = value(v, got.__getitem__, T)
        return got[len(values) - 1]

    return flux


def _twin_fluxes(model, state, dt):
    """The twins of the (top, bottom, snowfall) programs of ``model``'s
    column-kernel plan, on ``state``'s inputs."""
    plan = tthermo.plan(model, state.clock)
    tensors = plan.inputs(state, dt)
    return [_twin(codegen.ssa(ops), plan.k, tensors) for ops in plan.programs]


def check_twin_column(model, state, dt, temperatures):
    """The twins equal the plain fluxes bitwise at ``temperatures``, the
    snowfall program the plain snowfall rate, and the plain column step with
    the model's fluxes replaced by the twins equals thermo_column_reference
    bitwise in every output."""
    from climaseaice_jl_tpu_torch.model import make_fields
    from climaseaice_jl_tpu_torch.thermodynamics.heat_bcs import getflux
    from climaseaice_jl_tpu_torch.thermodynamics.slab import _snowfall_rate
    g = model.grid
    top, bottom, snow = _twin_fluxes(model, state, dt)
    fields = make_fields(model, state)
    for T in temperatures:
        for twin, spec in ((top, model.top_heat_flux), (bottom, model.bottom_heat_flux)):
            plain = getflux(spec, g, T, state.clock, fields)
            assert torch.equal(_bits(twin(T).broadcast_to(g.shape)),
                               _bits(plain.broadcast_to(g.shape)))
    rate = torch.as_tensor(_snowfall_rate(model, state.clock), dtype=torch.float32)
    assert torch.equal(_bits(snow(None).broadcast_to(g.shape)), _bits(rate.broadcast_to(g.shape)))
    twinned = model.evolve(
        top_heat_flux=cst.FluxFunction(func=lambda grid, Tu, clock, f: top(Tu)),
        bottom_heat_flux=cst.FluxFunction(func=lambda grid, Tu, clock, f: bottom(Tu)))
    ref = tthermo.thermo_column_reference(model, state, dt)
    out = tthermo.thermo_column_reference(twinned, state, dt)
    for name, r in ref.items():
        assert torch.equal(_bits(r.broadcast_to(g.shape)), _bits(out[name].broadcast_to(g.shape))), name


def test_pointwise_winds_match_jax():
    """Both wind components through `fixed_tile_pointwise` of the port (the
    callable eagerly on the CPU) against the JAX package's
    `fixed_tile_pointwise` (interpret mode) on the basin's coordinates:
    within 4e-6 of the largest value (the JAX reference forms cos(φ₀) in
    float32, the port in double); the recorded program, run as the kernel
    runs it, within 2e-7 of the plain version; the counter counts no CPU
    call."""
    import jax.numpy as jnp
    from climaseaice_jl_tpu.dynamics.pallas_pointwise import fixed_tile_pointwise
    script = _script()
    g = _port_grid()
    lon, lat = g.lon_cc.float(), g.lat_cc.float()
    t = g.scalar(37 * DAY)
    fp.fixed_tile_pointwise_counter.reset()
    for comp, fn in enumerate(db.WINDS):
        with _x32():
            ref = np.asarray(fixed_tile_pointwise(
                lambda lo, la, tt, c=comp: script._wind_expr(lo, la, tt, c), FIXED,
                (jnp.asarray(lon.numpy()), jnp.asarray(lat.numpy())),
                scalars=(jnp.asarray(37 * DAY, jnp.float32),)))
        out = fp.fixed_tile_pointwise(fn, FIXED, (lon, lat), scalars=(t,))
        assert out.dtype == torch.float32 and tuple(out.shape) == g.shape
        assert _rel(ref, out.numpy()) <= 4e-6, (comp, _rel(ref, out.numpy()))
        rec = fp.pointwise_recording(fn, 2, 1, torch.device("cpu"))
        prog = _run_program(rec, {("array", 0): lon, ("array", 1): lat, ("scalar", 0): t})
        assert _rel(out.numpy(), prog.numpy()) <= 2e-7, comp
        plan = fp.plan(fn, 2, 1, "cpu", g.shape)
        assert len(plan.k) <= fp.MAX_K and len(plan.tensors) <= fp.MAX_PTRS
    assert fp.fixed_tile_pointwise_counter.calls == 0
    assert torch.equal(db.wind_component(g, SimpleNamespace(time=t), 0, FIXED),
                       db.wind_component(g, SimpleNamespace(time=t), 0))


def _many_constants(a):
    for i in range(fp.MAX_K + 1):
        a = a + (i + 0.5)
    return a


def _unit_twin(plan, arrays, scalars):
    """The plan's generated unit evaluated on the CPU: its SSA values
    (fixed_tile_codegen.ssa of the bound program) in order, on float32
    tensors, x / c as the unit forms it, x·(1/c) with the reciprocal
    rounded to float32."""
    values = codegen.ssa(plan.ops)
    twin = _twin(values, plan.k, plan.inputs(arrays, scalars),
                 divc=lambda x, c: x * (torch.tensor(1.0, dtype=torch.float32) / c))
    return twin(None)


def test_pointwise_unit_twin_equals_program():
    """Both winds' generated units, evaluated by a CPU twin in their SSA
    order on the basin's coordinates (constants bound once each, inputs by
    pointer index), equal the recorded program run as the earlier
    interpreter ran it (`_run_program`) bitwise."""
    g = _port_grid()
    lon, lat = g.lon_cc.float().contiguous(), g.lat_cc.float().contiguous()
    for t in (37 * DAY, 211.5 * DAY):
        t = g.scalar(t)
        for fn in db.WINDS:
            plan = fp.plan(fn, 2, 1, "cpu", g.shape)
            rec = fp.pointwise_recording(fn, 2, 1, torch.device("cpu"))
            prog = _run_program(rec, {("array", 0): lon, ("array", 1): lat, ("scalar", 0): t})
            twin = _unit_twin(plan, (lon, lat), (t,))
            assert torch.equal(_bits(prog.broadcast_to(g.shape)), _bits(twin)), fn.__name__


def test_pointwise_unit_text_is_the_callable_s_alone():
    """A unit's text holds the program's operations and the indices of its
    constants and pointers, not their values: the same at every time and
    for callables that differ in a constant only; straight-line code, no
    interpreter; a program with the column kernel's temperature is
    refused."""
    g = _port_grid()
    lon, lat = g.lon_cc.float().contiguous(), g.lat_cc.float().contiguous()
    texts = set()
    for scale in (1.37, 2.91):
        fn = lambda lo, la, t, c=scale: db.wind_x(lo, la, t) * c   # noqa: E731
        for t in (0.0, 37 * DAY):
            fp.fixed_tile_pointwise(fn, FIXED, (lon, lat), scalars=(t,))
        plan = fp.plan(fn, 2, 1, "cpu", g.shape)
        texts.add(plan.text)
        assert fp._f32(scale) in plan.k
    (text,) = texts
    assert "run(" not in text and "switch" not in text and "stack" not in text
    assert text.count("const float v") == sum(v.op != fp.OP_CONST
                                              for v in codegen.ssa(plan.ops))
    assert fp.plan(db.wind_x, 2, 1, "cpu", g.shape).name.startswith("pointwise_unit_")
    with pytest.raises(ValueError, match="temperature"):
        codegen.pointwise_unit_source([(fp.OP_TEMP, 0, 0)])


def test_pointwise_plan_records_and_binds_once():
    """A second call through a plan neither records the callable nor binds
    its program again; another shape makes a second plan from the same
    recording."""
    g = _port_grid()
    lon, lat = g.lon_cc.float().contiguous(), g.lat_cc.float().contiguous()
    fn = lambda lo, la, t: db.wind_y(lo, la, t)   # noqa: E731
    fp.plan_counter.reset()
    first = fp.fixed_tile_pointwise(fn, FIXED, (lon, lat), scalars=(g.scalar(DAY),))
    assert (fp.plan_counter.records, fp.plan_counter.binds) == (1, 1)
    second = fp.fixed_tile_pointwise(fn, FIXED, (lon, lat), scalars=(g.scalar(DAY),))
    assert (fp.plan_counter.records, fp.plan_counter.binds) == (1, 1)
    assert torch.equal(first, second)
    assert fp.plan(fn, 2, 1, "cpu", g.shape) is fp.plan(fn, 2, 1, "cpu", g.shape)
    fp.fixed_tile_pointwise(fn, FIXED, (lon[:4], lat[:4]), scalars=(0.0,))
    assert (fp.plan_counter.records, fp.plan_counter.binds) == (1, 2)


@pytest.mark.parametrize("case", ["tanh", "pow", "captured-array", "python-branch",
                                  "float64", "too-many-constants"])
def test_pointwise_refuses_what_it_cannot_record(case):
    """A callable outside the op set raises NotImplementedError naming what
    it did, on the CPU as on the card, and before anything is evaluated."""
    x = torch.linspace(0.1, 1.0, 7)
    big = torch.ones(7)
    fns = {"tanh": (lambda a: torch.tanh(a), "tanh"),
           "pow": (lambda a: a ** 3, "pow"),
           "captured-array": (lambda a: a * big, "captured"),
           "python-branch": (lambda a: a if a > 0.5 else -a, "__bool__"),
           "float64": (lambda a: a.to(torch.float64), "float64"),
           "too-many-constants": (_many_constants, "constants")}
    fn, what = fns[case]
    with pytest.raises(NotImplementedError, match=what):
        fp.fixed_tile_pointwise(fn, FIXED, (x,))


def test_cpu_transcendentals_do_not_depend_on_length():
    """On the CPU torch's sin, cos and exp give the same bits in the
    vectorised loop, its scalar tail and a one-element call, for lengths
    that differ by one: the plain versions' values do not depend on the
    array shape."""
    rng = np.random.default_rng(5)
    for fn in (torch.sin, torch.cos, torch.exp):
        for n in (37, 1000, 4099):
            x = torch.from_numpy(rng.uniform(-3.0, 3.0, n + 1).astype(np.float32))
            a = fn(x[:n])
            assert torch.equal(a, fn(x)[:n]), (fn.__name__, n)
            assert torch.equal(a[-9:], torch.stack([fn(x[i:i + 1])[0]
                                                    for i in range(n - 9, n)])), fn.__name__


# --- 2.11: the column physics with the solar FluxFunction ------------------------------------

def _thermo_state(csi, mj, sj):
    g = mj.grid
    rng = np.random.default_rng(11)
    hs = np.where(_interior(g, sj.a) > 0, 0.05 + 0.1 * rng.random(g.interior_shape), 0.0)
    s = csi.initial_state(mj, h=_interior(g, sj.h), a=_interior(g, sj.a),
                          hs=hs.astype(np.float32), time=150 * DAY)
    Tu = np.where(rng.random(g.shape) < 0.5, -0.05, -8.0 * rng.random(g.shape))
    return s.evolve(Tu=np.asarray(Tu, np.float32), Tus=np.asarray(Tu, np.float32))


def test_solar_flux_thermo_matches_jax(basin):
    """The column kernel's plain version with the basin's top flux (the
    solar FluxFunction, three series, radiative emission) and snow against
    `fixed_tile_thermo_step` (interpret mode): within 3e-5 of each output's
    largest value (1.6e-4 K in Tu at most: the float32 secant meets the
    albedo's jump at −0.1 °C at a few points, where an ulp of flux moves an
    iterate); the recorded solar flux, run as the kernel runs it, within
    1e-6 of the callable's value."""
    import jax.numpy as jnp
    from climaseaice_jl_tpu.thermodynamics.pallas_thermo import fixed_tile_thermo_step
    csi, _, mj, sj, mt, _ = basin
    with _x32():
        sj = _thermo_state(csi, mj, sj)
        sj = sj.evolve(Tu=jnp.asarray(sj.Tu), Tus=jnp.asarray(sj.Tus))
        ref = fixed_tile_thermo_step(mj, sj, DT, FIXED)
    st = _to_port(mt, sj)
    tthermo.fixed_tile_thermo_counter.reset()
    out = tthermo.thermo_column(mt, st, DT)
    assert tthermo.fixed_tile_thermo_counter.calls == 0
    for name in tthermo.LAYERED_OUTPUTS:
        got = out[name].broadcast_to(mt.grid.shape).numpy()
        assert np.isfinite(got).all(), name
        assert _rel(np.asarray(getattr(ref, name)), got) <= 3e-5, name
    flux = mt.top_heat_flux[0]
    rec = tthermo.flux_recording(flux, mt.grid, tthermo._present(mt))
    series = flux.parameters.at_time(st.clock.time)
    inputs = {("grid", "lat_cc"): mt.grid.lat_cc, ("time",): st.clock.time,
              ("series", flux.parameters): series}
    T = st.Tus
    plain = flux.func(mt.grid, T, st.clock, None, flux.parameters)
    assert _rel(plain.numpy(), _run_program(rec, inputs, T=T).numpy()) <= 1e-6


def _solar_case():
    """The 32×64 basin with snow on part of the ice and top temperatures on
    both sides of the albedo's jump at −0.1 °C, on the CPU."""
    m, s = db.build(*SIZE, fixed_tiles=FIXED, device="cpu")
    g = m.grid
    rng = np.random.default_rng(11)
    Tu = torch.tensor(np.where(rng.random(g.shape) < 0.5, -0.05, -8.0 * rng.random(g.shape)),
                      dtype=torch.float32)
    hs = torch.tensor(np.where(rng.random(g.shape) < 0.5, 0.0, 0.1 * rng.random(g.shape)),
                      dtype=torch.float32)
    return m, s.evolve(Tu=Tu, Tus=Tu, hs=hs, clock=s.clock.evolve(time=g.scalar(150 * DAY)))


def test_codegen_twin_matches_plain_solar_column():
    """The basin's flux programs in the generated unit's SSA form (the solar
    FluxFunction, three series and emission summed; bottom and snowfall
    numbers), evaluated by a twin with the prologue once and the rest at
    every T, equal the plain fluxes and the plain column step bitwise."""
    m, s = _solar_case()
    check_twin_column(m, s, DT, (s.Tus, s.Tus - 0.07, s.Tus + 1.0, torch.zeros_like(s.Tus)))


def test_codegen_hoists_what_does_not_depend_on_T():
    """The solar flux's cosine, its scaling and clamp and the series value
    are computed once per point (the unit's flux(T) reads none of them);
    a callable whose every operation depends on T hoists nothing."""
    m, s = _solar_case()
    plan = tthermo.plan(m, s.clock)
    values = codegen.ssa(plan.programs[0])
    fixed_ops = {v.op for v in values if not v.t_dep}
    assert {fp.OP_COS, fp.OP_CLAMP, fp.OP_DIVC, fp.OP_SCALAR} <= fixed_ops
    assert not {fp.OP_COS, fp.OP_CLAMP} & {v.op for v in values if v.t_dep}
    flux_body = plan.text.split("float flux(")[1].split("struct Bottom")[0]
    assert "OP_COS" not in flux_body and "clamp(" not in flux_body and "powf" in flux_body
    steep = cst.FluxFunction(func=lambda grid, Tu, clock, fields: torch.exp(Tu * 0.01) * Tu - Tu,
                             top_temperature_dependent=True)
    values = codegen.ssa(tthermo.plan(m.evolve(top_heat_flux=steep), s.clock).programs[0])
    assert codegen.hoisted(values) == []
    assert all(v.t_dep for v in values if v.op != fp.OP_CONST)


def test_equilibrium_top_flux_under_fixed_tiles():
    """The default top flux of a prescribed-temperature slab without snow
    (the slab's conductive flux, a FluxFunction reading fields.h and Tb) is
    inside the op set: the fixed-tile column physics against JAX's."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.thermodynamics.pallas_thermo import fixed_tile_thermo_step

    def build(lib, **kw):
        g = lib.RectilinearGrid(size=(24, 16), x=(0, 48e3), y=(0, 32e3), halo=5,
                                dtype="float32", topology=("bounded", "bounded"), **kw)
        dyn = lib.SeaIceMomentumEquation(solver=lib.SplitExplicitSolver(8, fixed_tiles=FIXED))
        thermo = lib.sea_ice_slab_thermodynamics(top_heat_bc=lib.PrescribedTemperature(-10.0))
        return lib.sea_ice_model(g, dynamics=dyn, ice_thermodynamics=thermo,
                                 advection=lib.WENO(order=7))

    with _x32():
        mj = build(csi)
        rng = np.random.default_rng(2)
        sj = csi.initial_state(mj, h=np.where(rng.random((24, 16)) < 0.2, 0.0,
                                              0.2 + rng.random((24, 16))), a=0.9)
        ref = fixed_tile_thermo_step(mj, sj, DT, FIXED)
    mt = build(cst, device="cpu")
    assert isinstance(mt.top_heat_flux, cst.FluxFunction)
    out = tthermo.thermo_column(mt, _to_port(mt, sj), DT)
    for name in tthermo.BARE_OUTPUTS:
        np.testing.assert_allclose(out[name].broadcast_to(mt.grid.shape).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


# --- the slice as a whole ----------------------------------------------------------------

def _spy(monkeypatch):
    """Count the calls of the slice's routes and of the other EVP routes."""
    calls = dict(evp=0, P=0, wind=0, adv=0, thermo=0, curvilinear=0, tiled_padded=0)

    def wrap(module, name, key):
        fn = getattr(module, name)

        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)

    wrap(ttc, "tiled_curvilinear_evp_substeps", "evp")
    wrap(ttc, "fixed_tile_P", "P")
    wrap(db, "fixed_tile_pointwise", "wind")
    wrap(tadv, "fixed_tile_div", "adv")
    wrap(tthermo, "thermo_column", "thermo")
    wrap(tmodel, "curvilinear_fused_momentum_step", "curvilinear")
    wrap(tmodel, "tiled_padded_momentum_step", "tiled_padded")
    return calls


def test_basin_step_matches_jax(monkeypatch):
    """The whole fixed-tile basin step (the script's configuration at its
    default P★) against `csi.step`, twice, each from the JAX package's
    state: u/v ≤ 1e-4, σ/α ≤ 4e-3, h/ℵ/Tu ≤ 1e-5 of the largest value over
    the interior, hs ≤ 2e-4 (1.2e-5 m of fresh snow at most, where the
    rebasing of snow on the new ℵ carries ℵ's float32 noise: 8.4e-5); per step one pinned EVP call, one P call, two wind
    calls, three advection calls and one column call, and no other EVP
    route.  (Two steps in a row part at one thin-ice point whose thickness
    crosses the consolidation threshold on float32 noise.)"""
    import climaseaice_jl_tpu as csi
    script = _script()
    with _x32():
        mj, sj = script.build(*SIZE, fixed_tiles=FIXED)
    mt = db.build(*SIZE, fixed_tiles=FIXED, device="cpu")[0]
    calls = _spy(monkeypatch)
    for _ in range(2):
        st = cst.step(mt, _to_port(mt, sj), DT)
        with _x32():
            sj = csi.step(mj, sj, DT)
        for name, bar in BARS.items():
            a, b = _interior(mt.grid, getattr(sj, name)), _interior(mt.grid, getattr(st, name))
            assert np.isfinite(b).all(), name
            assert _rel(a, b) <= bar, (name, _rel(a, b))
    assert calls == dict(evp=2, P=2, wind=4, adv=6, thermo=2, curvilinear=0, tiled_padded=0)


def test_halo5_vs_halo19_bitwise():
    """Halo 5 and halo 19 give bitwise-equal interiors of u, v, h, ℵ, hs, σ
    and α after 3 steps of the basin at its default P★ on the CPU."""
    finals = []
    for halo in (5, 19):
        m, s = db.build(*SIZE, fixed_tiles=FIXED, halo=halo, device="cpu")
        for _ in range(3):
            s = cst.step(m, s, DT)
        finals.append({n: _interior(m.grid, getattr(s, n))
                       for n in ("u", "v", "h", "a", "hs") + DYNAMICS[2:]})
    for name in finals[0]:
        assert np.isfinite(finals[0][name]).all(), name
        assert np.array_equal(finals[0][name], finals[1][name]), name


def test_simulation_run_takes_the_slice_routes(monkeypatch):
    """Simulation.run of the basin goes through the slice's routes, keeps
    land empty and the fold halo of u equal to minus its mirror."""
    m, s = db.build(*SIZE, fixed_tiles=FIXED, device="cpu")
    calls = _spy(monkeypatch)
    sim = cst.Simulation(m, s, dt=DT, stop_iteration=2)
    sim.run()
    assert calls == dict(evp=2, P=2, wind=4, adv=6, thermo=2, curvilinear=0, tiled_padded=0)
    g, st = m.grid, sim.state
    for name in ("u", "v", "h", "a", "hs", "sig11", "sig12", "alpha", "Tu"):
        assert torch.isfinite(getattr(st, name)).all(), name
    for q in (st.h, st.a, st.hs):
        assert q[g.solid_cc].abs().max() == 0
    src = torch.as_tensor(tfields._x_fold_indices(g, True))
    assert torch.equal(st.u[:, g.Hy + g.Ny:], -st.u[src][:, g.Ny:g.Hy + g.Ny].flip(1))


# --- the CUDA kernels ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _card_basin(device, seed=0, halo=5):
    m = _soft(db.build(*SIZE, fixed_tiles=FIXED, halo=halo, device=device)[0])
    s = db.build(*SIZE, fixed_tiles=FIXED, halo=halo, device=device)[1]
    g = m.grid
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(0.05 * rng.standard_normal(g.interior_shape), dtype=torch.float32,
                            device=device) for _ in range(2))
    s = cst.initial_state(m, h=g.interior(s.h), a=g.interior(s.a), hs=g.interior(s.hs), u=u, v=v,
                          time=150 * DAY)
    return m, s


@pytest.mark.cuda
def test_cuda_tiled_evp_matches_plain(cuda_device):
    """The pinned curvilinear kernel against its plain version on the card
    (24 substeps, soft ice): interiors within phase 2's bars, bitwise
    across chunks of 12, 4 and 2."""
    m, s = _card_basin(cuda_device)
    params, planes, carry, grid, flags = ttc.tiled_curvilinear_inputs(m, s, DT, s.u, s.v, Hw=29)
    plan = ttc._fixed_plan(m.grid, 24, FIXED, widen_fold=True)
    ref = ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, 24, grid, plan,
                                                       flags)
    outs = [ttc.tiled_curvilinear_evp_substeps(params, planes, [q.clone() for q in carry], 24,
                                               grid, plan, flags, chunk=c) for c in (12, 4, 2)]
    torch.cuda.synchronize()
    for name, r, *os in zip(DYNAMICS, ref, *outs):
        assert _rel(_interior(grid, r), _interior(grid, os[0])) <= BARS[name], name
        for o in os[1:]:
            assert torch.equal(grid.interior(os[0]), grid.interior(o)), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["serial", "no-drag", "dead-band", "shard"])
def test_cuda_tiled_settled_blocks_match_plain(cuda_device, case):
    """The pinned curvilinear kernel on the inputs of
    test_tiled_settled_blocks_frozen_equal_plain_version moved to the card,
    24 substeps (on the shard 8), the serial basin in chunks of 12 and 4:
    its settled flags equal their plain version's, some set; its interiors
    are the plain version's bits, signed zeros included; 2 + refills +
    3·nsub launches."""
    nsub = 8 if case == "shard" else 24
    params, planes, carry, grid, plan, flags = _settled_case(case, cuda_device, nsub=nsub)
    want = ttc.tiled_settled_blocks_reference(params, planes, grid, plan, flags)
    assert want.any()
    for chunk in ((plan[0],) if case == "shard" else (12, 4)):
        ref = ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, nsub, grid,
                                                           plan, flags, chunk=chunk)
        settled = torch.empty(want.numel(), dtype=torch.int32, device=cuda_device)
        ttc.tiled_curvilinear_evp_counter.reset()
        out = ttc.tiled_curvilinear_evp_substeps(params, planes, [q.clone() for q in carry],
                                                 nsub, grid, plan, flags, chunk=chunk,
                                                 settled=settled)
        torch.cuda.synchronize()
        refills = -(-nsub // chunk) if ttc._geometry(grid).refill else 0
        assert ttc.tiled_curvilinear_evp_counter.launches == 2 + refills + 3 * nsub
        assert torch.equal(settled.reshape(want.shape).bool(), want), (case, chunk)
        for name, r, o in zip(DYNAMICS, ref, out):
            assert torch.equal(_bits(grid.interior(r)), _bits(grid.interior(o))), (case, chunk,
                                                                                   name)


@pytest.mark.cuda
def test_cuda_strength_winds_and_flux_match_plain(cuda_device):
    """The ice-strength, pointwise and column kernels against their plain
    versions on the card: P within 2 ulp, both winds within 2 ulp, the
    column physics with the solar FluxFunction the plain version's bits,
    signed zeros included, so within 1e-5."""
    m, s = _card_basin(cuda_device)
    prm = ttc.ice_strength_params(m)
    np.testing.assert_array_max_ulp(ttc.fixed_tile_P_reference(prm, s.h, s.a).cpu().numpy(),
                                    ttc.fixed_tile_P(prm, s.h, s.a).cpu().numpy(), maxulp=2)
    g = m.grid
    lon, lat = g.lon_cc.contiguous(), g.lat_cc.contiguous()
    for fn in db.WINDS:
        ref = fp.fixed_tile_pointwise_reference(fn, (lon, lat), (s.clock.time,))
        out = fp.fixed_tile_pointwise(fn, FIXED, (lon, lat), scalars=(s.clock.time,))
        np.testing.assert_array_max_ulp(ref.cpu().numpy(), out.cpu().numpy(), maxulp=2)
    dt = g.scalar(DT)
    ref = tthermo.thermo_column_reference(m, s, dt)
    out = tthermo.thermo_column(m, s, dt)
    torch.cuda.synchronize()
    for name, q in out.items():
        r = ref[name].broadcast_to(g.shape)
        assert _rel(r.cpu().numpy(), q.cpu().numpy()) <= 1e-5, name
        assert torch.equal(_bits(r), _bits(q)), name
