"""The whole-grid route of the tracer advection: a float32 model without
``fixed_tiles`` on the card takes the fixed-tile advection kernel (2.9) for
each tracer's ∇·(U c) instead of the general path's eager operations.

On the CPU: the gate's decisions (read from the model alone, so a model
whose grid names a CUDA device stands for one on the card), the kernel's
plain version in the route's metric mode against
``advection.horizontal_div_Uc`` bitwise, and whole steps with the route
forced onto the plain version against the general path, every field
bitwise.  The CUDA tests hold the kernel itself to the general path run on
the card (``pytest --noconftest -m cuda tests/test_torch_whole_grid_advection.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch import distributed_basin as db
from climaseaice_jl_tpu_torch.advection import horizontal_div_Uc
from climaseaice_jl_tpu_torch.dynamics import fixed_tile_advection as tadv

km = 1000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread, as in the other tile-emulating test files:
    the tier-1 run's six workers make PyTorch's OpenMP pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _periodic(N=32, dtype="float32", device="cpu", substeps=8, advection=None, **kw):
    """The benchmark's periodic αEVP box (`bench.py:build(N, substeps)`) at
    N² on a 512 km domain."""
    L = 512 * km
    grid = cst.RectilinearGrid(size=(N, N), x=(0, L), y=(0, L), halo=5, dtype=dtype,
                               topology=("periodic", "periodic"), device=device)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=27500.0),
        coriolis=cst.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=substeps))
    return cst.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                             top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                             advection=advection or cst.WENO(order=7), **kw)


def _bounded(N=(48, 64), dtype="float32", device="cpu", substeps=8):
    """A bounded box with an immersed island (the fixed-tile slice's land)
    without ``fixed_tiles``."""
    Nx, Ny = N
    grid = cst.RectilinearGrid(size=N, x=(0, 2 * km * Nx), y=(0, 2 * km * Ny), halo=5,
                               dtype=dtype, topology=("bounded", "bounded"), device=device)
    xc, yc = np.meshgrid((np.arange(Nx) + 0.5) * 2 * km, (np.arange(Ny) + 0.5) * 2 * km,
                         indexing="ij")
    grid = cst.ImmersedBoundaryGrid(grid, (xc - 0.45 * Nx * 2 * km) ** 2
                                    + (yc - 0.55 * Ny * 2 * km) ** 2 < (0.2 * Nx * 2 * km) ** 2)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=cst.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=substeps))
    return cst.sea_ice_model(grid, dynamics=dynamics, advection=cst.WENO(order=7),
                             ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                             top_heat_flux=-20.0, bottom_heat_flux=-5.0)


# 32×66 is the smallest basin of 32 columns whose ≥ 32 southern rows are all
# land, so that the general path crops them (32×64 has 31)
BASIN = (32, 66)


def _basin_grid(dtype="float32", device="cpu"):
    grid = cst.TripolarGrid(BASIN, southernmost_latitude=45.0, transition_latitude=65.0,
                            halo=5, dtype=dtype, device=device)
    return cst.ImmersedBoundaryGrid(grid, db.basin_land(grid))


def _latlon(dtype="float32", device="cpu"):
    """A latitude-longitude band, periodic in longitude with walls at 50° N
    and 80° N: 1-D metrics, which the route expands to arrays."""
    grid = cst.LatitudeLongitudeGrid((48, 32), latitude=(50.0, 80.0), halo=5, dtype=dtype,
                                     device=device)
    return cst.sea_ice_model(grid, advection=cst.WENO(order=7), ice_thermodynamics=None)


FLUX_FORM = cst.FluxFormAdvection(x=cst.UpwindBiased(order=5), y=cst.Centered(order=2))


def _model(case, dtype="float32", device="cpu"):
    if case == "periodic":
        return _periodic(dtype=dtype, device=device)
    if case == "flux-form":
        return _periodic(dtype=dtype, device=device, advection=FLUX_FORM)
    if case == "bounded-island":
        return _bounded(dtype=dtype, device=device)
    if case == "latlon":
        return _latlon(dtype, device)
    return cst.sea_ice_model(_basin_grid(dtype, device), advection=cst.WENO(order=7),
                             ice_thermodynamics=None)


def _state(model, seed=0):
    """A seeded state: thickness about 1 m with noise, ℵ below and at 1,
    velocities of 5 cm/s; halos filled and land masked by the state's
    update."""
    g = model.grid
    rng = np.random.default_rng(seed)

    def t(q):
        return torch.tensor(q, dtype=g.dtype, device=g.device)

    shape = g.interior_shape
    return cst.initial_state(model, h=t(1.0 + 0.25 * rng.random(shape)),
                             a=t(np.minimum(1.0, 0.9 + 0.15 * rng.random(shape))),
                             u=t(0.05 * rng.standard_normal(shape)),
                             v=t(0.05 * rng.standard_normal(shape)))


def _bits(q):
    q = q.detach().cpu().contiguous()
    return q.view(torch.int32 if q.dtype == torch.float32 else torch.int64)


def _interior(grid, q):
    return _bits(grid.interior(q))


def _on_card(model):
    """``model`` as its gate sees it on a card: its grid names a CUDA
    device (nothing is moved)."""
    return model.evolve(grid=model.grid.evolve(device=torch.device("cuda")))


# --- the gate ------------------------------------------------------------------------------

def _short_halo():
    grid = cst.RectilinearGrid(size=(16, 16), halo=3, dtype="float32", device="cpu")
    m = cst.sea_ice_model(grid, advection=cst.UpwindBiased(order=5), ice_thermodynamics=None)
    return _on_card(m.evolve(advection=cst.WENO(order=7)))


def _shard():
    m = _on_card(_periodic())
    return m.evolve(grid=m.grid.evolve(mesh_axes=("x", "y"), mesh_shape=(2, 2)))


GATE_CASES = {
    "card": (lambda: _on_card(_periodic()), True),
    "forced": (lambda: _on_card(_periodic(forcing={"h": lambda g, c, f: 1e-7 * f.a})), True),
    "flux-form": (lambda: _on_card(_model("flux-form")), True),
    "basin": (lambda: _on_card(_model("basin")), True),
    "latlon": (lambda: _on_card(_model("latlon")), True),
    "cpu": (lambda: _periodic(), False),
    "float64": (lambda: _on_card(_periodic(dtype="float64")), False),
    "upwind9": (lambda: _on_card(_periodic(advection=cst.UpwindBiased(order=9))), False),
    "short-halo": (_short_halo, False),
    "shard": (_shard, False),
    "no-advection": (lambda: _on_card(_periodic()).evolve(advection=None), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_whole_grid_gate(case):
    """The route is taken on the card for float32 models whose schemes the
    kernel computes, with halos of the stencil radius, and not on a shard;
    a user forcing does not stop it."""
    build, expected = GATE_CASES[case]
    assert tadv.whole_grid_advection_available(build()) is expected


# --- the plain version in the route's metric mode --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["periodic", "flux-form", "bounded-island", "latlon", "basin"])
def test_plain_version_matches_general_path(case, dtype):
    """The kernel's plain version with the route's metrics (0-d Δy_fc, Δx_cf
    and Az_cc on the uniform grids, arrays on the latitude-longitude band and
    the tripolar basin) gives `horizontal_div_Uc`'s bits at every interior
    point, for h and ℵ, with one scheme and with two."""
    m = _model(case, dtype)
    s = _state(m)
    g = m.grid
    metrics = tadv._face_metrics(g)
    assert all(q.dim() == (2 if case in ("latlon", "basin") else 0) for q in metrics)
    masks = (m.masks.per_fc, m.masks.per_cf)
    schemes = tadv._schemes(m.advection)
    for c in (s.h, s.a):
        ref = horizontal_div_Uc(g, m.advection, s.u, s.v, c, masks=masks)
        out = tadv.fixed_tile_div_reference(g, schemes, s.u, s.v, c, masks, metrics)
        assert torch.equal(_interior(g, ref), _interior(g, out))


# --- whole steps through the route -------------------------------------------------------------

def _routes(monkeypatch, take):
    """Force the whole-grid gate to ``take`` (on the CPU the route runs the
    kernel's plain version) and count the route's and the general path's
    calls."""
    calls = dict(route=0, general=0)

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tmodel, "whole_grid_advection_available", lambda model: take)
    monkeypatch.setattr(tadv, "fixed_tile_div", counted("route", tadv.fixed_tile_div))
    monkeypatch.setattr(tmodel, "horizontal_div_Uc",
                        counted("general", tmodel.horizontal_div_Uc))
    return calls


def _with_state(model):
    return model, _state(model)


STEP_CASES = {   # (model and state, dt); the basin steps Forward Euler, the rest RK3
    "periodic": (lambda: _with_state(_periodic()), 120.0),
    "forced": (lambda: _with_state(_periodic(forcing={"h": lambda g, c, f: 1e-7 * f.a})),
               120.0),
    "bounded-island": (lambda: _with_state(_bounded()), 120.0),
    "basin": (lambda: db.build(*BASIN, substeps=8, device="cpu"), 600.0),
}


def _assert_same_state(a, b):
    """Every tensor of two states, tracers and clock included, bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.isfinite(y).all(), f.name
            assert torch.equal(_bits(x), _bits(y)), f.name
    assert a.tracers.keys() == b.tracers.keys()
    for k in a.tracers:
        assert torch.equal(_bits(a.tracers[k]), _bits(b.tracers[k])), k
    assert torch.equal(a.clock.time, b.clock.time)
    assert torch.equal(a.clock.iteration, b.clock.iteration)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_route_step_matches_general_path(case, monkeypatch):
    """One step with the divergence from the route (the kernel's plain
    version on the CPU) equals the general path's step in every field,
    halos included: the halos the route leaves differ, and the state's
    update refills them before any reader.  One call a tracer and stage
    (h and ℵ; the basin's snow besides); the basin's general path crops its
    32 rows of land, the route does not."""
    build, dt = STEP_CASES[case]
    m, s = build()
    assert (m.masks.solid_rows >= 32) == (case == "basin")
    stages = 3 if m.timestepper == "SplitRungeKutta3" else 1
    n = stages * (2 + (s.hs is not None) + len(s.tracers or {}))
    assert n == (3 if case == "basin" else 6)
    finals = {}
    for take in (False, True):
        calls = _routes(monkeypatch, take)
        finals[take] = cst.step(m, s, dt)
        assert calls == (dict(route=n, general=0) if take else dict(route=0, general=n))
        monkeypatch.undo()
    _assert_same_state(finals[False], finals[True])


# --- the CUDA kernel ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _card_model(case, device):
    if case.startswith("periodic-"):
        return _periodic(N=int(case.split("-")[1]), device=device)
    if case == "flux-form":
        return _periodic(N=512, device=device, advection=FLUX_FORM)
    return _model(case, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["periodic-512", "periodic-2048", "flux-form", "bounded-island",
                                  "latlon", "basin"])
def test_cuda_route_matches_general_path(cuda_device, case):
    """The kernel on the route gives the general path's bits on the card at
    every interior point, for h and ℵ: on the periodic box at 512² and
    2048², the same at 512² with UpwindBiased(5) in x and Centered(2) in y
    (the runtime-scheme entry), the bounded box with an island, the
    latitude-longitude band, and the tripolar basin, whose general path
    crops its rows of land (the kernel gives exact zeros there).  One
    launch a tracer, counted on the route's counter only."""
    m = _card_model(case, cuda_device)
    s = _state(m)
    g = m.grid
    assert tadv.whole_grid_advection_available(m)
    assert (m.masks.solid_rows >= 32) == (case == "basin")
    counters = (tadv.whole_grid_advection_counter, tadv.fixed_tile_advection_counter,
                 tadv.fixed_tile_advection_runtime_counter)
    for c in counters:
        c.reset()
    route = tmodel.tracer_tendencies(m, s)
    torch.cuda.synchronize()
    runtime = 2 if case == "flux-form" else 0
    assert [(c.calls, c.launches) for c in counters] == [(2, 2), (0, 0), (runtime, runtime)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodel, "whole_grid_advection_available", lambda model: False)
        general = tmodel.tracer_tendencies(m, s)
    torch.cuda.synchronize()
    assert tadv.whole_grid_advection_counter.calls == 2
    for r, e in zip(route[:2], general[:2]):
        assert torch.equal(_interior(g, e), _interior(g, r))


@pytest.mark.cuda
def test_cuda_route_step_matches_general_path(cuda_device):
    """One RK3 step of the periodic box at 512² through the route equals the
    general path's step on the card in every field, halos included; the
    route's counter reads 6 calls and 6 launches a step."""
    m = _periodic(N=512, device=cuda_device, substeps=120)
    s = _state(m)
    tadv.whole_grid_advection_counter.reset()
    route = cst.step(m, s, 120.0)
    torch.cuda.synchronize()
    counter = tadv.whole_grid_advection_counter
    assert (counter.calls, counter.launches) == (6, 6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodel, "whole_grid_advection_available", lambda model: False)
        general = cst.step(m, s, 120.0)
    torch.cuda.synchronize()
    assert (counter.calls, counter.launches) == (6, 6)
    _assert_same_state(general, route)


@pytest.mark.cuda
def test_cuda_fixed_tile_route_unchanged(cuda_device):
    """A model under ``fixed_tiles`` keeps its route: two RK3 steps of the
    fixed-tile slice count 12 calls on the fixed-tile counter and none on
    the whole-grid route's, and each divergence keeps the plain version's
    bits in the fixed-tile metric mode (1/Δx, 1/Δy)."""
    grid = cst.RectilinearGrid(size=(48, 128), x=(0, 96 * km), y=(0, 256 * km), halo=5,
                               dtype="float32", topology=("periodic", "bounded"),
                               device=cuda_device)
    dyn = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=cst.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=8, fused="always", halo_exchange="wide",
                                       fixed_tiles=(8, 128)))
    m = cst.sea_ice_model(grid, dynamics=dyn, advection=cst.WENO(order=7),
                          ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                          top_heat_flux=-20.0, bottom_heat_flux=-5.0)
    s = _state(m)
    for c in (tadv.fixed_tile_advection_counter, tadv.whole_grid_advection_counter):
        c.reset()
    for _ in range(2):
        s = cst.step(m, s, 120.0)
    torch.cuda.synchronize()
    assert tadv.fixed_tile_advection_counter.calls == 12
    assert tadv.whole_grid_advection_counter.calls == 0
    metrics = (1.0 / grid.scalar(grid.dx_cc), 1.0 / grid.scalar(grid.dy_cc))
    masks = (m.masks.per_fc, m.masks.per_cf)
    ref = tadv.fixed_tile_div_reference(grid, tadv._schemes(m.advection), s.u, s.v, s.h,
                                        masks, metrics)
    out = tadv.make_fixed_tile_div(m, s.u, s.v)(s.h)
    torch.cuda.synchronize()
    assert torch.equal(_bits(ref), _bits(out))
