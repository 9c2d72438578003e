"""The port's distributed step (``climaseaice_jl_tpu_torch.parallel``) vs its
serial step and vs the JAX package.

Ranks are spawned over gloo on the CPU, one PyTorch thread each; one spawn
of two ranks and one of four run all the cases (``parallel.launch.run_cases``):

* the immersed 48×96 tripolar grid of
  `tests/test_distributed_curvilinear.py:279-322` (soft ice, 8 substeps, the
  'wide' halo policy, ``fixed_tiles=(8, 128)``, WENO-7, Forward Euler, 3
  steps), whose fold is split across x on (2, 2): bitwise the port's serial
  step, and within ``BARS`` of the JAX package's serial step;
* the tripolar basin of ``distributed_basin.build(48, 96, substeps=8,
  fixed_tiles=(8, 128))`` with its winds, immersed drag and snow
  thermodynamics, 2 steps: bitwise the serial step (8 substeps are one
  chunk, so the serial step refills the fold only where the distributed one
  does);
* on (2, 1), a 72×48 tripolar case with its fold split across x and 16
  substeps, with and without an immersed drag: the drag seeds a parting in
  the top rows, and the result lies within ``BARS`` of the JAX package's
  distributed step;
* on (2, 2), a doubly periodic rectilinear float64 run under the
  'per_substep' policy (`tests/test_distributed.py:81`'s contract):
  within rtol 1e-7, atol 1e-9 of the serial run;
* the wide-halo step without the tripolar fixed-tile mode, at the sizes of
  the JAX package's tests, soft ice, ``NSUB`` substeps: on (2, 2) the 48²
  doubly periodic case of `tests/test_distributed.py:211` (kernel 2.3 on
  every shard), bitwise the port's serial step through the padded route and
  within that test's bars of the JAX package's serial step; on (2, 2) and
  (1, 4) the 48×128 ``fixed_tiles`` case of `:291` with WENO-7 (2.4, 2.5),
  bitwise the port's serial step; on (1, 2) and (2, 2) the x-meshed-fold
  case without ``fixed_tiles`` (2.7's unpinned plan), bitwise the serial
  step whose momentum runs the same plan, and within ``BARS`` of the
  default serial step (the whole-array kernel 2.6).

In this process: the strip/unstrip round trip against the JAX package's,
the shards' routes and the refusals, and the plain versions of kernels 2.3,
2.4, 2.5, 2.7 (both plans) and 2.9 on one shard's padded arrays against the
JAX kernels in interpret mode inside ``shard_map``."""

import contextlib
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import distributed_basin as db
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch.grids import with_halo
from climaseaice_jl_tpu_torch.model import meshed_momentum_route
from climaseaice_jl_tpu_torch.parallel import launch, make_distributed_step
from climaseaice_jl_tpu_torch.parallel import stepper as tstep
from climaseaice_jl_tpu_torch.dynamics import fused_evp_padded as tpad
from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_padded as ttp
from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_curvilinear as ttc
from climaseaice_jl_tpu_torch.dynamics import fixed_tile_advection as tadv
from climaseaice_jl_tpu_torch.dynamics import momentum as tmomentum

SIZE = (48, 96)
FIXED = (8, 128)
NSUB = 8
DT = 60.0
STEPS = 3
MESHES = [(1, 2), (2, 2)]
COMPARED = ("u", "v", "sig11", "sig12", "alpha", "h", "a")
BARS = dict(u=1e-4, v=1e-4, sig11=4e-3, sig22=4e-3, sig12=4e-3, alpha=4e-3, h=1e-5, a=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here too (the spawned ranks set their own): the
    tier-1 run puts six test workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x32():
    import jax
    return jax.enable_x64(False)


def _land(Nx, Ny):
    land = np.zeros((Nx, Ny), bool)
    land[:, :3] = True
    land[18:30, 80:] = True   # a landmass straddling the x seam and the fold
    return land


def _jax_case(halo_exchange="wide", fixed_tiles=FIXED):
    """The JAX package's x-meshed-fold configuration and its initial state."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.grids import TripolarGrid
    grid = TripolarGrid(SIZE, southernmost_latitude=-70.0, halo=5, dtype="float32")
    grid = csi.ImmersedBoundaryGrid(grid, _land(*SIZE))
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=NSUB, halo_exchange=halo_exchange,
                                       fused="always", fixed_tiles=fixed_tiles))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=7), timestepper="ForwardEuler")
    rng = np.random.default_rng(13)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random(SIZE), a=1.0, u=0.05)
    return model, state


def _port_case(halo_exchange="wide", fixed_tiles=FIXED, size=SIZE):
    """The same configuration in the port, on the CPU."""
    grid = cst.TripolarGrid(size, southernmost_latitude=-70.0, halo=5, dtype="float32",
                            device="cpu")
    grid = cst.ImmersedBoundaryGrid(grid, _land(*size))
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=NSUB, halo_exchange=halo_exchange,
                                       fused="always", fixed_tiles=fixed_tiles))
    return cst.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                             advection=cst.WENO(order=7), timestepper="ForwardEuler")


def _rectilinear(halo_exchange="per_substep"):
    """`tests/test_distributed.py:_build`'s periodic contractive run, float64."""
    km = 1000.0
    grid = cst.RectilinearGrid(size=(48, 48), x=(-10 * km, 10 * km), y=(-10 * km, 10 * km),
                               halo=5, topology=("periodic", "periodic"), device="cpu")
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        coriolis=cst.FPlane(f=1e-4), top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=10, halo_exchange=halo_exchange))
    model = cst.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=cst.WENO(order=7), timestepper="ForwardEuler")

    def h0(x, y):
        return 0.3 + 0.005 * (torch.sin(60 * x / (20 * km)) + torch.sin(30 * y / (20 * km)))

    return model, cst.initial_state(model, h=h0, a=1.0, u=0.1)


def _rect_case(m, fixed_tiles=None, P_star=27.5, topology=("periodic", "periodic"), halo=5,
               **device):
    """`tests/test_distributed.py:211`'s doubly periodic float32 case (48²,
    WENO-5) or, with ``fixed_tiles``, `:291`'s (48×128, WENO-7), both under
    the wide halo policy with ``NSUB`` substeps; the JAX package's or the
    port's by its module ``m``."""
    km = 1000.0
    Ny, ly = (48, 10 * km) if fixed_tiles is None else (128, 20 * km)
    grid = m.RectilinearGrid(size=(48, Ny), x=(-10 * km, 10 * km), y=(-ly, ly), halo=halo,
                             dtype="float32", topology=topology, **device)
    dynamics = m.SeaIceMomentumEquation(
        rheology=m.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=m.FPlane(f=1e-4), top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=m.SemiImplicitStress(),
        solver=m.SplitExplicitSolver(substeps=NSUB, halo_exchange="wide", fused="always",
                                     fixed_tiles=fixed_tiles))
    return m.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                           advection=m.WENO(order=5 if fixed_tiles is None else 7),
                           timestepper="ForwardEuler")


def _rect_h0(fixed_tiles=None):
    km = 1000.0
    ly = 10 * km if fixed_tiles is None else 20 * km

    def h0(x, y):
        return 0.3 + 0.005 * (np.sin(60 * x / (20 * km)) + np.sin(30 * y / (2 * ly)))

    return h0


RECT_STEPS = 3


@contextlib.contextmanager
def _momentum_through(step_fn):
    """The port's serial step with its momentum routed through ``step_fn``
    (a launcher taking ``(model, state, dt, u_start, v_start)``)."""
    def momentum(model, state, dt, u_prev=None, v_prev=None):
        u0 = state.u if u_prev is None else u_prev
        v0 = state.v if v_prev is None else v_prev
        return state.evolve(**step_fn(model, state, dt, u0, v0))

    original = tmodel.momentum_step
    tmodel.momentum_step = momentum
    try:
        yield
    finally:
        tmodel.momentum_step = original


def _serial(model, state, steps, dt, momentum=None):
    with _momentum_through(momentum) if momentum else contextlib.nullcontext():
        for _ in range(steps):
            state = cst.step(model, state, dt)
    return {k: v for k, v in state_to_numpy(tstep.strip_halos(model, state)).items()}


@pytest.fixture(scope="module")
def rect():
    """Paths A (no ``fixed_tiles``) and B (``FIXED``) at test size: the port's
    model and state of each, the JAX package's model and state, and A's JAX
    serial result after ``RECT_STEPS`` steps (interior-only)."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.parallel.stepper import strip_halos as jax_strip
    out = {}
    for path, fixed in (("A", None), ("B", FIXED)):
        with _x32():
            mj = _rect_case(csi, fixed)
            sj = csi.initial_state(mj, h=_rect_h0(fixed), a=1.0, u=0.05)
            if path == "A":
                ser = sj
                for _ in range(RECT_STEPS):
                    ser = csi.step(mj, ser, DT)
                out["A_jax_serial"] = {n: np.asarray(getattr(jax_strip(mj, ser), n))
                                       for n in ("u", "v", "h", "a")}
        mt = _rect_case(cst, fixed, device="cpu")
        out[path] = (mj, sj, mt, state_from_numpy(mt, state_to_numpy(sj)))
    return out


@pytest.fixture(scope="module")
def case():
    """The x-meshed-fold case: (JAX model, JAX state, port model, port
    state, the port's serial result, the JAX package's serial result), both
    results interior-only (the y-face fields' seam row kept)."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.parallel.stepper import strip_halos as jax_strip
    with _x32():
        mj, sj = _jax_case()
        ser = sj
        for _ in range(STEPS):
            ser = csi.step(mj, ser, DT)
        jax_ref = {n: np.asarray(getattr(jax_strip(mj, ser), n)) for n in COMPARED}
    mt = _port_case()
    st = state_from_numpy(mt, {k: v for k, v in state_to_numpy(sj).items()})
    return mj, sj, mt, st, _serial(mt, st, STEPS, DT), jax_ref


@contextlib.contextmanager
def exchange_every_half_update():
    """The gate of the loop's local fills turned off: a shard's loop then
    exchanges after each half-update, as 'per_substep' did before the
    deferred form.  Module-level, so that a spawned rank can run a case in
    it."""
    gate = tmomentum.local_loop_ok
    tmomentum.local_loop_ok = lambda model, h_min: False
    try:
        yield
    finally:
        tmomentum.local_loop_ok = gate


_RUNS = {}


@pytest.fixture(scope="module")
def io_dir(tmp_path_factory):
    """Where the ranks of the (2, 2) rectilinear run write their snapshots
    and sharded checkpoints."""
    return str(tmp_path_factory.mktemp("rank_io"))


@pytest.fixture(scope="module")
def runs(case, drag_case, rect, physics, overlap, io_dir):
    """One spawn per number of ranks, run on first use, its results by
    label: on (1, 2) and (2, 2) the x-meshed-fold case ("fold") and the
    basin ("basin"); on two ranks also the 72×48 case with and without its
    drag on (2, 1) ("drag", "no-drag"); on four paths A and B (B on (1, 4)
    too); on each the rectilinear 'per_substep' run in the deferred form
    ("rect", on four with its rank snapshots and sharded checkpoint) and in
    the per-half-update form ("rect-half"), the overlap cases of this mesh,
    the general physics on it, and the x-meshed-fold case without
    ``fixed_tiles`` ("unpinned")."""
    _, _, mt, st, _, _ = case

    def run(mesh):
        if mesh not in _RUNS:
            mr, sr = _rectilinear()
            cases = {"fold": dict(model=mt, state=st, mesh=mesh, steps=STEPS, dt=DT),
                     "basin": dict(build=db.build, kwargs=dict(Nx=48, Ny=96, substeps=NSUB,
                                                               fixed_tiles=FIXED),
                                   mesh=mesh, steps=2, dt=600.0),
                     "rect": dict(model=mr, state=sr, mesh=mesh, steps=5, dt=60.0,
                                  io=io_dir if mesh == (2, 2) else None),
                     "rect-half": dict(model=mr, state=sr, mesh=mesh, steps=5, dt=60.0,
                                       context=exchange_every_half_update)}
            if mesh == (1, 2):
                for label, model in (("drag", drag_case["port"]),
                                     ("no-drag", drag_case["port_no_drag"])):
                    cases[label] = dict(model=model, state=drag_case["state"], mesh=(2, 1),
                                        steps=1, dt=600.0, names=DRAG_NAMES)
            if mesh == (2, 2):
                cases.update({p + "-" + "x".join(map(str, m)): dict(
                    model=rect[p][2], state=rect[p][3], mesh=m, steps=RECT_STEPS, dt=DT)
                    for p, m in (("A", (2, 2)), ("B", (2, 2)), ("B", (1, 4)))})
            cases.update({label: dict(model=o["port"], state=o["state"], mesh=o["mesh"],
                                      steps=o["steps"], dt=60.0)
                          for label, o in overlap.items() if o["ranks"] == mesh[0] * mesh[1]})
            cases.update({f"{name}-{mesh}": dict(model=p["port"], state=p["state"], mesh=mesh,
                                                 steps=PHYSICS_STEPS, dt=PHYSICS_DT)
                          for name, p in physics.items()})
            cases["unpinned"] = dict(model=_port_case(fixed_tiles=None), state=st, mesh=mesh,
                                     steps=STEPS, dt=DT)
            results = launch.run_cases([dict(c, device="cpu") for c in cases.values()],
                                       mesh[0] * mesh[1], timeout=600)
            _RUNS[mesh] = dict(zip(cases, results))
        return _RUNS[mesh]

    return run


# --- the spawned runs ------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_xmeshed_fold_case_equals_serial_bitwise(case, runs, mesh):
    """Distributed ≡ serial bit for bit on u, v, σ₁₁, σ₁₂, α, h and ℵ: the
    fold split across x on (2, 2), across y on (1, 2); every rank sent
    strips, and the same count of bytes on ranks of the same row."""
    serial = case[4]
    result = runs(mesh)["fold"]
    for name in COMPARED:
        got = result["fields"][name]
        assert np.isfinite(got).all(), name
        assert np.array_equal(got, serial[name]), (name, np.abs(got - serial[name]).max())
    assert all(r["bytes_per_step"] > 0 and r["stage"] for r in result["records"])


@pytest.mark.parametrize("mesh", MESHES)
def test_xmeshed_fold_case_within_bars_of_jax(case, runs, mesh):
    """The port's distributed result against the JAX package's serial step
    (which its own suite holds bitwise equal to its distributed one)."""
    jax_ref = case[5]
    result = runs(mesh)["fold"]
    for name in COMPARED:
        a, b = jax_ref[name].astype(np.float64), result["fields"][name].astype(np.float64)
        rel = np.abs(b - a).max() / max(np.abs(a).max(), 1e-30)
        assert rel <= BARS[name], (name, rel)


@pytest.mark.parametrize("mesh", MESHES)
def test_basin_equals_serial_bitwise(runs, mesh):
    """The full-physics basin (land, fold, winds through the pointwise
    route, immersed drag, snow column physics), 2 steps: every compared
    field bit for bit."""
    m, s = db.build(48, 96, substeps=NSUB, fixed_tiles=FIXED, device="cpu")
    serial = _serial(m, s, 2, 600.0)
    result = runs(mesh)["basin"]
    for name, got in result["fields"].items():
        assert np.isfinite(got).all(), name
        assert np.array_equal(got, serial[name]), (name, np.abs(got - serial[name]).max())


def test_per_substep_rectilinear_within_contract(runs):
    """The doubly periodic float64 run on (2, 2) under 'per_substep' (an
    exchange every half-update): u, v, h, ℵ within rtol 1e-7, atol 1e-9 of
    the serial run after 5 steps."""
    m, s = _rectilinear()
    serial = _serial(m, s, 5, 60.0)
    result = runs((2, 2))["rect"]
    for name in ("u", "v", "h", "a"):
        np.testing.assert_allclose(result["fields"][name], serial[name], rtol=1e-7, atol=1e-9,
                                   err_msg=name)


def test_wide_padded_case_equals_serial_padded_bitwise(rect, runs):
    """Path A at test size on (2, 2): every shard runs kernel 2.3's meshed
    branch (no fill along the split directions, whose halo points evolve in
    place).  The result equals, bit for bit, the port's serial step whose
    momentum goes through the padded route."""
    mt, st = rect["A"][2:]
    serial = _serial(mt, st, RECT_STEPS, DT, tpad.padded_fused_momentum_step)
    result = runs((2, 2))["A-2x2"]["fields"]
    for name, got in result.items():
        assert np.isfinite(got).all(), name
        assert np.array_equal(got, serial[name]), (name, np.abs(got - serial[name]).max())


def test_wide_padded_case_within_jax_bars(rect, runs):
    """Path A on (2, 2) against the JAX package's serial step, with
    `tests/test_distributed.py:238-248`'s bars: u, v within 2e-2 of the
    velocity scale, h and ℵ within 1e-4 of their largest values."""
    ref = rect["A_jax_serial"]
    result = runs((2, 2))["A-2x2"]["fields"]
    vel = max(np.abs(ref["u"]).max(), np.abs(ref["v"]).max(), 1e-8)
    for name, bar in (("u", 2e-2), ("v", 2e-2), ("h", 1e-4), ("a", 1e-4)):
        scale = vel if name in ("u", "v") else max(np.abs(ref[name]).max(), 1e-8)
        rel = np.abs(result[name].astype(np.float64) - ref[name]).max() / scale
        assert rel < bar, (name, rel)


@pytest.mark.parametrize("mesh, index", [((2, 2), "B-2x2"), ((1, 4), "B-1x4")],
                         ids=["2x2", "1x4"])
def test_fixed_tile_rectilinear_case_equals_serial_bitwise(rect, runs, mesh, index):
    """Path B at test size (`tests/test_distributed.py:291`'s contract):
    2.4 and 2.5 meshed (the split directions' padded extent carried, ceil
    tiles, the overhang clamp-gathered), 2.9 and the general column, bit for
    bit the port's serial fixed-tile step on u, v, h, ℵ, σ and α."""
    mt, st = rect["B"][2:]
    serial = _serial(mt, st, RECT_STEPS, DT)
    result = runs((2, 2))[index]
    assert tuple(result["records"][-1]["index"]) == (mesh[0] - 1, mesh[1] - 1)
    for name, got in result["fields"].items():
        assert np.isfinite(got).all(), name
        assert np.array_equal(got, serial[name]), (name, np.abs(got - serial[name]).max())


@pytest.fixture(scope="module")
def unpinned_serial(case):
    """The x-meshed-fold case without ``fixed_tiles``: the serial step whose
    momentum runs 2.7's unpinned plan, and the default serial step (2.6)."""
    mt, st = _port_case(fixed_tiles=None), case[3]
    return (_serial(mt, st, STEPS, DT, ttc.tiled_curvilinear_momentum_step),
            _serial(mt, st, STEPS, DT))


@pytest.mark.parametrize("mesh", MESHES)
def test_wide_unpinned_case_equals_serial_bitwise(unpinned_serial, runs, mesh):
    """The x-meshed-fold case without ``fixed_tiles`` and without the drag
    (2.7's unpinned plan on every shard; the fold split across x on (2, 2),
    refilled on the top shard on (1, 2)): bit for bit the serial step whose
    momentum runs the same plan, and within ``BARS`` of the default serial
    step, whose whole-array kernel 2.6 forms its coefficients otherwise
    (γ² as c·Δt/(m·Az), where 2.7 has c·Δt·(1/Az)/m)."""
    serial, default = unpinned_serial
    result = runs(mesh)["unpinned"]["fields"]
    for name in COMPARED:
        got = result[name]
        assert np.isfinite(got).all(), name
        assert np.array_equal(got, serial[name]), (name, np.abs(got - serial[name]).max())
        ref = default[name].astype(np.float64)
        rel = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert rel <= BARS[name], (name, rel)


# --- the deferred form, the overlap policy and the general physics on shards ----------------

def _exchange_dims(mesh):
    return (mesh[0] > 1) + (mesh[1] > 1)


@pytest.mark.parametrize("mesh", MESHES)
def test_deferred_exchange_equals_half_update_form_with_half_the_rounds(runs, mesh):
    """The rectilinear 'per_substep' run (αEVP, no free drift, halos 5) takes
    the deferred form on every rank: local fills in both half-updates and
    one joint u, v exchange a substep and before the loop
    (`momentum.py:489-511`).  Its interiors equal, bit for bit, those of the
    per-half-update form (the gate turned off), and its substep loop makes
    half the exchange rounds: (substeps + 1) a split direction a step, where
    the other form makes twice that, and sends the same bytes (u and v in
    one payload where the other sends two)."""
    deferred, half = runs(mesh)["rect"], runs(mesh)["rect-half"]
    for name, got in deferred["fields"].items():
        assert np.array_equal(got, half["fields"][name]), name
    loop_rounds = (10 + 1) * _exchange_dims(mesh)          # 10 substeps, one call a step
    for rd, rh in zip(deferred["records"], half["records"]):
        assert (rd["loop"], rh["loop"]) == ("deferred", "exchanging")
        assert rh["rounds_per_step"] - rd["rounds_per_step"] == loop_rounds
        assert rd["bytes_per_step"] == rh["bytes_per_step"]        # u, v in one payload


def test_rank_snapshots_and_sharded_checkpoints_round_trip(runs, io_dir):
    """After the (2, 2) rectilinear run every rank wrote its snapshot and
    its sharded checkpoint with the JAX package's names and keys
    (``snapshot_rank<P>_<iteration>.npz`` with ``u@<i0>_<j0>``,
    ``checkpoint.rank<P>.npz``); each rank's checkpoint restored onto the
    mesh bit for bit, the reassembled snapshot equals the gathered state,
    and the JAX package's reassembly of the port's files equals the
    port's."""
    from climaseaice_jl_tpu.parallel.multihost import (
        reassemble_rank_snapshots as jax_reassemble)
    from climaseaice_jl_tpu_torch.parallel import reassemble_rank_snapshots
    result = runs((2, 2))["rect"]
    assert all(r["checkpoint_bitwise"] for r in result["records"])
    for name, got in result["fields"].items():
        assert np.array_equal(result["snapshot"][name], got), name
    files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(io_dir, "*.npz")))
    assert files == ([f"checkpoint.rank{r:03d}.npz" for r in range(4)]
                     + [f"snapshot_rank{r:03d}_00000005.npz" for r in range(4)])
    with np.load(os.path.join(io_dir, "snapshot_rank003_00000005.npz")) as d:
        assert "u@24_24" in d.files and "time" in d.files
    prefix = os.path.join(io_dir, "snapshot")
    ours, theirs = (f(prefix, 5, (48, 48)) for f in (reassemble_rank_snapshots, jax_reassemble))
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert np.array_equal(ours[name], theirs[name]), name


def _overlap_model(lib, kind, policy="overlap", halo=5, **device):
    """`tests/test_distributed.py`'s overlap configurations in float64:
    "periodic" and "bounded" (`_build`: 48², αEVP with α⁺ = 1e4, 10
    substeps, WENO-7), "island" (the periodic one with its island) and
    "fold" (`:402-418`: 32², a folded north edge, WENO-5)."""
    km = 1000.0
    if kind == "fold":
        grid = lib.RectilinearGrid(size=(32, 32), x=(0, 20 * km), y=(0, 20 * km), halo=halo,
                                   topology=("periodic", "bounded"), north_fold=True, **device)
        top, adv = {"u": 0.01, "v": 0.005}, lib.WENO(order=5)
    else:
        topology = ("bounded",) * 2 if kind == "bounded" else ("periodic",) * 2
        grid = lib.RectilinearGrid(size=(48, 48), x=(-10 * km, 10 * km), y=(-10 * km, 10 * km),
                                   halo=halo, topology=topology, **device)
        if kind == "island":
            xc = np.asarray(grid.xc)[grid.Hx:grid.Hx + 48, None]
            yc = np.asarray(grid.yc)[None, grid.Hy:grid.Hy + 48]
            grid = lib.ImmersedBoundaryGrid(grid, (xc ** 2 + yc ** 2) < (4 * km) ** 2)
        top, adv = {"u": 0.01, "v": 0.01}, lib.WENO(order=7)
    dynamics = lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        coriolis=lib.FPlane(f=1e-4), top_momentum_stress=top,
        bottom_momentum_stress=lib.SemiImplicitStress(),
        solver=lib.SplitExplicitSolver(substeps=10, halo_exchange=policy))
    return lib.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None, advection=adv,
                             timestepper="ForwardEuler")


def _overlap_state(csi, mj, kind):
    km = 1000.0
    if kind == "fold":
        rng = np.random.default_rng(11)
        return csi.initial_state(mj, h=0.4 + 0.05 * rng.random((32, 32)), a=1.0, u=0.05)

    def h0(x, y):
        return 0.3 + 0.005 * (np.sin(60 * x / (20 * km)) + np.sin(30 * y / (20 * km)))

    return csi.initial_state(mj, h=h0, a=1.0, u=0.1)


# label: (configuration, mesh, steps, halo); the last one's halo of 4 fails
# the overlap gate (5), which then falls through to the exchanging fills
OVERLAP = {
    "overlap-periodic-1x2": ("periodic", (1, 2), 3, 5),
    "overlap-periodic-2x2": ("periodic", (2, 2), 3, 5),
    "overlap-bounded-1x2": ("bounded", (1, 2), 3, 5),
    "overlap-bounded-2x2": ("bounded", (2, 2), 3, 5),
    "overlap-island-2x2": ("island", (2, 2), 3, 5),
    "overlap-fold-1x2": ("fold", (1, 2), 3, 5),
    "overlap-halo4-1x2": ("periodic", (1, 2), 2, 4),
}


def _jax_distributed(mj, sj, mesh, steps, dt):
    """The JAX package's make_distributed_step on the 8 virtual CPU devices:
    ``steps`` steps, interior-only fields as numpy arrays."""
    from climaseaice_jl_tpu.parallel import make_distributed_step as jax_dstep
    from climaseaice_jl_tpu.parallel.stepper import strip_halos as jax_strip
    dstep, _ = jax_dstep(mj, mesh)
    s = jax_strip(mj, sj)
    for _ in range(steps):
        s = dstep(s, dt)
    return {n: np.asarray(getattr(s, n)) for n in ("u", "v", "h", "a")}


@pytest.fixture(scope="module")
def overlap():
    """Per label of ``OVERLAP``: the port's model and state (the JAX initial
    state carried across), its mesh, steps and number of ranks, and the JAX
    model and state."""
    import climaseaice_jl_tpu as csi
    out = {}
    for label, (kind, mesh, steps, halo) in OVERLAP.items():
        mj = _overlap_model(csi, kind, halo=halo)
        sj = _overlap_state(csi, mj, kind)
        mt = _overlap_model(cst, kind, halo=halo, device="cpu")
        out[label] = dict(port=mt, state=state_from_numpy(mt, state_to_numpy(sj)), mesh=mesh,
                          steps=steps, ranks=mesh[0] * mesh[1], jax=(mj, sj))
    return out


def _assert_within(ref, got, rtol, atol, what):
    for name in ("u", "v", "h", "a"):
        np.testing.assert_allclose(got[name], ref[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("label", list(OVERLAP))
def test_overlap_equals_serial_and_jax(label, overlap, runs):
    """halo_exchange='overlap' (`tests/test_distributed.py:355-422`): each
    substep posts the joint u, v exchange, runs the whole shard on the
    arrays from before it, waits, and recomputes a (2H+8)-wide band at each
    split edge.  Where JAX's gate admits it (halos ≥ 5, shards ≥ 8 points
    along split directions, αEVP, no free drift, no fold split across x)
    every rank runs that form; with halo 4 it falls through to the
    exchanging fills, as JAX's does.  Either way u, v, h, ℵ are within that
    test's rtol 1e-7, atol 1e-9 of the port's serial run and of the JAX
    package's make_distributed_step on the same mesh.  The overlap form
    makes the deferred form's exchange rounds: one a substep and one after
    the loop, where the deferred form makes one before it."""
    o = overlap[label]
    result = runs(o["mesh"])[label]
    want = "exchanging" if label.startswith("overlap-halo4") else "overlap"
    assert all(r["loop"] == want for r in result["records"])
    serial = _serial(o["port"], o["state"], o["steps"], 60.0)
    _assert_within(serial, result["fields"], 1e-7, 1e-9, "serial")
    if want == "overlap":
        mj, sj = o["jax"]
        _assert_within(_jax_distributed(mj, sj, o["mesh"], o["steps"], 60.0), result["fields"],
                       1e-7, 1e-9, "jax")
    if label.startswith("overlap-periodic"):      # the configuration of "rect"
        deferred = runs(o["mesh"])["rect"]["records"]
        assert [r["rounds_per_step"] for r in result["records"]] == \
            [r["rounds_per_step"] for r in deferred]


def _viscosity(x, y, t):
    """ν(x, y, t) of the viscous variant, arithmetic only, so that the same
    function serves both packages."""
    return 800.0 + 400.0 * (x / 32e3) * (y / 32e3) + 0.1 * t


def _h_forcing(grid, clock, fields):
    """A thickness forcing from the shard's x coordinates and the clock."""
    return 1e-7 * fields.a * (1.0 + grid.xc[:, None] / 32e3) * (1.0 + clock.time / 600.0)


def _u_forcing(grid, clock, fields):
    """A velocity forcing from the shard's y coordinates."""
    return 1e-6 * fields.a * (1.0 + grid.yc[None, :] / 32e3)


def _physics_model(lib, name, **device):
    """The general-path physics at 16×16 in float64 (periodic x, bounded y, WENO-5,
    Forward Euler): "explicit" (ViscousRheology with ν(x, y, t) +
    ExplicitSolver + BetaPlane, slab thermodynamics), "free_drift"
    (StressBalanceFreeDrift as the whole dynamics, slab thermodynamics, no
    advection) and "forced" (soft-ice αEVP, 10 substeps, with BetaPlane,
    free drift of marginal ice and forcing of h and u: the general
    split-explicit path, its fills exchanging)."""
    km = 1000.0
    grid = lib.RectilinearGrid(size=(16, 16), x=(0, 32 * km), y=(0, 32 * km), halo=5,
                               topology=("periodic", "bounded"), **device)
    top = {"u": 0.05, "v": -0.02}
    kw = dict(ice_thermodynamics=None)
    if name == "explicit":
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ViscousRheology(nu=_viscosity),
            coriolis=lib.BetaPlane(f0=1e-4, beta=1e-11),
            top_momentum_stress=top, bottom_momentum_stress=lib.SemiImplicitStress(),
            solver=lib.ExplicitSolver())
        kw = dict(ice_thermodynamics=lib.sea_ice_slab_thermodynamics())
    elif name == "free_drift":
        # no advection: the JAX package's tracer tendencies read the
        # solver of the dynamics, which free drift has not
        dyn = lib.StressBalanceFreeDrift(top_momentum_stress=top,
                                         bottom_momentum_stress=lib.SemiImplicitStress(ue=0.1))
        kw = dict(ice_thermodynamics=lib.sea_ice_slab_thermodynamics(), advection=None)
    else:
        fd = lib.StressBalanceFreeDrift(top_momentum_stress=top,
                                        bottom_momentum_stress=lib.SemiImplicitStress())
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
            coriolis=lib.BetaPlane(f0=1.4e-4, beta=1e-11), top_momentum_stress=top,
            bottom_momentum_stress=lib.SemiImplicitStress(), free_drift=fd, minimum_mass=200.0,
            solver=lib.SplitExplicitSolver(substeps=10))
        kw["forcing"] = {"h": _h_forcing, "u": _u_forcing}
    kw.setdefault("advection", lib.WENO(order=5))
    return lib.sea_ice_model(grid, dynamics=dyn, timestepper="ForwardEuler", **kw)


PHYSICS = ("explicit", "free_drift", "forced")
PHYSICS_STEPS, PHYSICS_DT = 2, 300.0


@pytest.fixture(scope="module")
def physics():
    """Per variant of ``PHYSICS``: the port's model and the JAX package's,
    with a seeded state (thin ice at a third of the points) carried across."""
    import climaseaice_jl_tpu as csi
    rng = np.random.default_rng(17)
    h = np.where(rng.random((16, 16)) < 0.3, 0.1, 1.0 + 0.2 * rng.random((16, 16)))
    a = 0.9 + 0.1 * rng.random((16, 16))
    u, v = (0.05 * rng.standard_normal((16, 16)) for _ in range(2))
    out = {}
    for name in PHYSICS:
        mj = _physics_model(csi, name)
        sj = csi.initial_state(mj, h=h, a=a, u=u, v=v)
        mt = _physics_model(cst, name, device="cpu")
        out[name] = dict(port=mt, state=state_from_numpy(mt, state_to_numpy(sj)), jax=(mj, sj))
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", PHYSICS)
def test_general_physics_on_shards_matches_jax(name, mesh, physics, runs):
    """ExplicitSolver with a viscosity function and a beta-plane, free drift
    as the dynamics, and the forced soft-ice αEVP general path with a
    beta-plane and marginal-ice free drift run on every shard (each reading
    its own coordinates and the clock), and hold, within 1e-10 of each
    field's largest value, to the JAX package's make_distributed_step on
    the same mesh and to the port's serial run."""
    p = physics[name]
    got = runs(mesh)[f"{name}-{mesh}"]["fields"]
    mj, sj = p["jax"]
    refs = (_jax_distributed(mj, sj, mesh, PHYSICS_STEPS, PHYSICS_DT),
            _serial(p["port"], p["state"], PHYSICS_STEPS, PHYSICS_DT))
    for what, ref in zip(("jax", "serial"), refs):
        for field in ("u", "v", "h", "a"):
            assert np.isfinite(got[field]).all(), field
            scale = max(np.abs(ref[field]).max(), 1e-30)
            rel = np.abs(got[field] - ref[field]).max() / scale
            assert rel <= 1e-10, (what, field, rel)
    assert np.abs(got["u"]).max() > 0


def test_overlap_posts_before_the_interior_and_waits_before_the_bands(monkeypatch):
    """On a shard of a (2, 2) mesh (no transport: the exchange is stood in
    for by the local fills), each substep of the overlap form posts the
    exchange, runs the whole shard, waits, then runs the four edge bands,
    in that order; the bands' grids are (2H + 8) wide across their edge."""
    from climaseaice_jl_tpu_torch.dynamics import momentum as tmom
    from climaseaice_jl_tpu_torch.fields import fill_halos_fc_local, fill_halos_cf_local
    model = _overlap_model(cst, "periodic", device="cpu")
    g = model.grid
    lgrid = tstep._local_grid(g, 24, 24, 0, 1, ("x", "y"), (2, 2),
                              tstep.ProcessMesh((2, 2), (0, 1), "cpu", transport=False))
    lmasks = tstep._local_masks(lgrid, None, 0, 1, False)
    lmodel = model.evolve(grid=lgrid, masks=lmasks)
    assert tmom.loop_form(lmodel) == "overlap"
    from climaseaice_jl_tpu_torch.parallel.multihost import _map_fields
    state = _map_fields(cst.initial_state(model, h=0.3, a=1.0, u=0.1),
                        lambda q: q[:34, 24:58])          # the shard's window
    events, grids = [], []

    def local_uv(u, v, grid):
        return fill_halos_fc_local(u, grid), fill_halos_cf_local(v, grid)

    def start(u, v, grid):
        events.append("post")

        def finish():
            events.append("wait")
            return local_uv(u, v, grid)

        return finish

    made = tmom._make_evp_substep

    def spy(m, *args):
        one = made(m, *args)
        tag = "interior" if not grids else "band"
        grids.append(m.grid)

        def run(*a):
            events.append(tag)
            return one(*a)

        return run

    monkeypatch.setattr(tmom, "start_fill_halos_uv", start)
    monkeypatch.setattr(tmom, "fill_halos_uv", local_uv)
    monkeypatch.setattr(tmom, "fill_halos_many", lambda qs, locs, grid: list(qs))
    monkeypatch.setattr(tmom, "_make_evp_substep", spy)
    tmom.split_explicit_momentum_step(lmodel, state, 60.0, state.u, state.v)
    assert events == (["post", "interior", "wait"] + ["band"] * 4) * 10
    assert [gr.shape for gr in grids[1:]] == [(18, 34)] * 2 + [(34, 18)] * 2


# --- in this process ------------------------------------------------------------------------

def test_strip_unstrip_round_trip_matches_jax(case):
    """strip_halos and unstrip_halos give the JAX package's arrays bit for
    bit (the y-face fields keep the seam row on the folded grid), and
    unstrip ∘ strip gives back the padded state."""
    from climaseaice_jl_tpu.parallel.stepper import strip_halos as jax_strip
    from climaseaice_jl_tpu.parallel.stepper import unstrip_halos as jax_unstrip
    mj, sj, mt, st = case[:4]
    port_int = tstep.strip_halos(mt, st)
    with _x32():
        jax_int = jax_strip(mj, sj)
        jax_full = jax_unstrip(mj, jax_int)
    port_full = tstep.unstrip_halos(mt, port_int)
    for name in tstep._STATE_LOCS:
        q = getattr(port_int, name)
        if q is None:
            continue
        assert np.array_equal(q.numpy(), np.asarray(getattr(jax_int, name))), name
        assert np.array_equal(getattr(port_full, name).numpy(),
                              np.asarray(getattr(jax_full, name))), name
    for name in ("h", "a", "u", "v"):
        assert torch.equal(getattr(port_full, name), getattr(st, name)), name


def _refusal_models():
    return {
        "overlap": (_port_case(halo_exchange="overlap", fixed_tiles=None), (2, 2), RuntimeError,
                    "torch.distributed is not initialised"),
        "xfold-narrow-halo": (_port_case(), (2, 1), NotImplementedError,
                              "north fold split across the x mesh"),
    }


@pytest.mark.parametrize("name", ["overlap", "xfold-narrow-halo"])
def test_refusals_before_any_exchange(name):
    """make_distributed_step settles what it runs before it needs a process
    group: a fold split across x whose y halo is below 2·substeps+3 raises
    NotImplementedError (the JAX package's message), while the 'overlap'
    policy, which the port now runs, passes every shard's route and stops
    only at the missing process group."""
    model, mesh, error, match = _refusal_models()[name]
    with pytest.raises(error, match=match):
        make_distributed_step(model, mesh)


def test_shards_whose_routes_differ_raise(monkeypatch):
    """make_distributed_step finds every shard's momentum route before any
    rank communicates, and raises where they differ (here a route made to
    depend on the shard's position)."""
    model = _rect_case(cst, device="cpu")

    def route(m):
        return "padded" if float(m.grid.xc[m.grid.Hx]) < 0 else "general"

    monkeypatch.setattr(tstep, "meshed_momentum_route", route)
    with pytest.raises(ValueError, match="different momentum routes"):
        make_distributed_step(model, (2, 2))


def test_default_device_is_a_card_or_raises(monkeypatch):
    """A rank's default device is ``cuda:{local rank mod cards}``; on a host
    without a card it raises instead of running the rank on the CPU."""
    from climaseaice_jl_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.default_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.default_device() == torch.device("cuda", 1)


ROUTES = {
    # name: (model, mesh, the shard's momentum route)
    "A": (lambda: _rect_case(cst, device="cpu"), (2, 2), "padded"),
    "B": (lambda: _rect_case(cst, FIXED, device="cpu"), (2, 2), "tiled_padded"),
    "B-1x4": (lambda: _rect_case(cst, FIXED, device="cpu"), (1, 4), "tiled_padded"),
    "C": (lambda: _port_case(fixed_tiles=None), (2, 2), "tiled_curvilinear"),
    "tripolar-fixed": (_port_case, (2, 2), "tiled_curvilinear"),
    "per_substep": (lambda: _port_case(halo_exchange="per_substep"), (2, 2), "general"),
    "split-bounded": (lambda: _rect_case(cst, topology=("periodic", "bounded"), device="cpu"),
                      (1, 2), "general"),
    "overlap": (lambda: _port_case(halo_exchange="overlap", fixed_tiles=None), (2, 2), "general"),
    "ExplicitSolver": (lambda: _physics_model(cst, "explicit", device="cpu"), (2, 2), "general"),
    "free-drift": (lambda: _physics_model(cst, "free_drift", device="cpu"), (1, 2), "general"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_shard_route(name):
    """Every shard's momentum route under the wide halo policy, as the JAX
    package dispatches it (`model.py:401-445`): path A to 2.3 meshed, path B
    to 2.4 and 2.5 meshed, the tripolar case to 2.7 (its unpinned plan
    without ``fixed_tiles``, its pinned plan with them); the general path
    under 'per_substep' and 'overlap', where a bounded direction is split
    (2.3's meshed gate, `pallas_evp_padded.py:66-74`), and for free drift as
    the dynamics and the explicit solver."""
    build, mesh, route = ROUTES[name]
    model = build()
    grid = model.grid
    solver = getattr(model.dynamics, "solver", None)
    axes = ("x" if mesh[0] > 1 else None, "y" if mesh[1] > 1 else None)
    if getattr(solver, "halo_exchange", None) == "wide":
        H = 2 * solver.substeps + 3
        grid = with_halo(grid, (H if axes[0] else grid.Hx, H if axes[1] else grid.Hy))
    nx, ny = grid.Nx // mesh[0], grid.Ny // mesh[1]
    for ix in range(mesh[0]):
        for iy in range(mesh[1]):
            probe = tstep._local_grid(grid, nx, ny, ix, iy, axes, mesh)
            assert meshed_momentum_route(model.evolve(grid=probe)) == route, (ix, iy)


# --- kernels 2.3, 2.4, 2.5, 2.7 and 2.9 on one shard against the JAX kernels ----------------------

OUT6 = ("u", "v", "sig11", "sig22", "sig12", "alpha")


def _on_jax_shards(mj, sj, local, n):
    """Inside the JAX package's shard_map on a (2, 2) mesh with wide halos
    (2·NSUB+3): ``local(lmodel, lstate, lmasks)``'s parameter vector and
    ``n`` lists of 2-D arrays on each shard, each list stacked and laid out
    as the mesh lays out its shards; and the padded shard shape."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from climaseaice_jl_tpu.grids import with_halo as jax_with_halo
    from climaseaice_jl_tpu.parallel import stepper as js

    mesh_shape = (2, 2)
    H = 2 * NSUB + 3
    grid = jax_with_halo(mj.grid, (H, H))
    model = mj.evolve(grid=grid)
    nx, ny = grid.Nx // 2, grid.Ny // 2
    state_int = js.strip_halos(mj, sj)
    immersed = grid.solid_cc is not None
    solid_int = (np.asarray(grid.interior(grid.solid_cc)) if immersed
                 else np.zeros(grid.interior_shape, bool))

    def shard(state_int, solid_int):
        ix, iy = lax.axis_index("x"), lax.axis_index("y")
        lgrid = js._local_grid(grid, nx, ny, ix, iy, ("x", "y"), mesh_shape)
        lmasks = js._local_masks(lgrid, solid_int, ix, iy, immersed)
        lgrid = lgrid.evolve(solid_cc=lmasks.solid_cc)
        lmodel = model.evolve(grid=lgrid, masks=lmasks)
        ls = js._pad_state(state_int, lgrid, masks=lmasks)
        params, lists = local(lmodel, ls, lmasks)
        return (params,) + tuple(jnp.stack(q) for q in lists)

    spec = jax.tree_util.tree_map(
        lambda l: P("x", "y") if getattr(l, "ndim", 0) == 2 else P(), state_int)
    f = js.shard_map(shard, js.make_mesh(mesh_shape), in_specs=(spec, P("x", "y")),
                     out_specs=(P(),) + (P(None, "x", "y"),) * n)
    return [np.array(x) for x in jax.jit(f)(state_int, solid_int)], (nx + 2 * H, ny + 2 * H)


def _jax_shard_kernels(mj, sj):
    """Per shard of the tripolar case the inputs of 2.7 and its outputs,
    and the inputs and output of 2.9 on h."""
    import jax.numpy as jnp
    from climaseaice_jl_tpu.dynamics import pallas_evp_tiled_curvilinear as jtc
    from climaseaice_jl_tpu.dynamics.pallas_advection import make_fixed_tile_div

    def local(lmodel, ls, lmasks):
        params, planes, carry, _, _ = jtc._prepare_tiled_inputs(lmodel, ls, DT, ls.u, ls.v)
        upd = jtc.tiled_curvilinear_momentum_step(lmodel, ls, DT, ls.u, ls.v, interpret=True)
        out = [upd[n] for n in OUT6]
        if lmodel.dynamics.solver.fixed_tiles is None:
            return params, (planes, carry, out)
        div = make_fixed_tile_div(lmodel, ls.u, ls.v)(ls.h)
        adv = [ls.u, ls.v, ls.h, lmasks.per_fc.astype(jnp.float32),
               lmasks.per_cf.astype(jnp.float32), div]
        return params, (planes, carry, out, adv)

    return _on_jax_shards(mj, sj, local, 3 if mj.dynamics.solver.fixed_tiles is None else 4)


def _seeded(mj, sj, seed=21):
    """The JAX state ``sj``'s thickness with seeded velocities."""
    import climaseaice_jl_tpu as csi
    g = mj.grid
    rng = np.random.default_rng(seed)
    u, v = (0.05 * rng.standard_normal(g.interior_shape).astype(np.float32) for _ in range(2))
    return csi.initial_state(mj, h=np.asarray(g.interior(sj.h)), a=1.0, u=u, v=v)


def _shard_cut(stack, shard, shape):
    (ix, iy), (nxp, nyp) = shard, shape
    return stack[:, ix * nxp:(ix + 1) * nxp, iy * nyp:(iy + 1) * nyp]


def _port_shard_grid(model, shard):
    """The port's grid of ``shard`` of a (2, 2) mesh with wide halos."""
    H = 2 * NSUB + 3
    g = with_halo(model.grid, (H, H))
    return tstep._local_grid(g, g.Nx // 2, g.Ny // 2, *shard, ("x", "y"), (2, 2),
                             tstep.ProcessMesh((2, 2), shard, "cpu", transport=False))


def _assert_interiors_within_bars(grid, ref, res):
    for name, r, o in zip(OUT6, ref, res):
        a, b = grid.interior(torch.as_tensor(r)).double(), grid.interior(o).double()
        assert torch.isfinite(b).all(), name
        rel = ((b - a).abs().max() / a.abs().max().clamp_min(1e-30)).item()
        assert rel <= BARS[name], (name, rel)


@pytest.fixture(scope="module")
def rect_shard_kernels(rect):
    """Paths A and B's JAX shard kernels in interpret mode, seeded
    velocities: per shard the padded route's parameters, constants (on B
    2.4's coefficients among them), carries, the route's outputs (2.3 on A,
    2.5 on B), and h, ℵ and the peripheral masks."""
    import jax.numpy as jnp
    from climaseaice_jl_tpu.dynamics import pallas_evp_padded as jpad
    from climaseaice_jl_tpu.dynamics import pallas_evp_tiled_padded as jtp
    out = {}
    for path, step in (("A", jpad.padded_fused_momentum_step),
                       ("B", jtp.tiled_padded_momentum_step)):
        def local(lmodel, ls, lmasks):
            params, consts, carry, _, _ = jpad._prepare_inputs(lmodel, ls, DT, ls.u, ls.v)
            upd = step(lmodel, ls, DT, ls.u, ls.v, interpret=True)
            masks = [lmasks.per_fc.astype(jnp.float32), lmasks.per_cf.astype(jnp.float32)]
            return params, (consts, carry, [upd[n] for n in OUT6], [ls.h, ls.a] + masks)

        mj, sj = rect[path][:2]
        with _x32():
            out[path] = _on_jax_shards(mj, _seeded(mj, sj), local, 4)
    return out


SHARDS = [(1, 1), (0, 0)]


@pytest.mark.parametrize("shard", SHARDS)
def test_kernel_23_meshed_plain_on_a_shard_matches_jax(rect, rect_shard_kernels, shard):
    """2.3's plain version on shard ``shard`` of path A's (2, 2) mesh (both
    directions split: no fills, the halo points evolving in place), fed the
    JAX shard's inputs, against the JAX kernel in interpret mode: interiors
    within BARS after NSUB substeps, where filling the split directions as
    periodic ones moves them further."""
    mt = rect["A"][2]
    (params, consts, carry, out, _), shape = rect_shard_kernels["A"]
    grid = _port_shard_grid(mt, shard)
    assert tpad.direction_kinds(grid) == (tpad.KIND_SPLIT,) * 2
    consts, carry = (tuple(torch.as_tensor(q) for q in _shard_cut(x, shard, shape))
                     for x in (consts, carry))
    ref = _shard_cut(out, shard, shape)
    res = tpad.padded_evp_substeps_reference(torch.as_tensor(params), consts, carry, NSUB, grid)
    _assert_interiors_within_bars(grid, ref, res)
    filled = tpad.padded_evp_substeps_reference(
        torch.as_tensor(params), consts, carry, NSUB,
        dataclasses.replace(grid, mesh_axes=None, mesh_shape=None))
    a, b = grid.interior(torch.as_tensor(ref[0])), grid.interior(filled[0])
    assert ((b - a).abs().max() / a.abs().max()).item() > BARS["u"]


@pytest.mark.parametrize("shard", SHARDS)
def test_kernel_24_meshed_plain_on_a_shard_matches_jax(rect, rect_shard_kernels, shard):
    """2.4's plain version on shard ``shard`` of path B's (2, 2) mesh (the
    images clamp at the padded edge along the split directions, where the
    serial grid wraps them), on the JAX shard's h and ℵ, against
    `_fixed_tile_prepare` in interpret mode at every padded point: the
    activity masks equal (the peripheral ones applied, as the launcher
    does), the other eight arrays within 4e-4
    (`test_torch_fixed_tiles.py::test_prep_matches_jax`)."""
    mt = rect["B"][2]
    (_, consts, _, _, fields), shape = rect_shard_kernels["B"]
    grid = _port_shard_grid(mt, shard)
    consts = _shard_cut(consts, shard, shape)
    h, a, per_fc, per_cf = (torch.as_tensor(q) for q in _shard_cut(fields, shard, shape))
    prm = tpad.evp_prep_params(mt, mt.grid.scalar(DT))
    out = tpad.evp_prep_reference(prm, h, a, grid)
    names = ("P", "Pff", "gcc", "gff", "drag_u", "invm_u", "act_u", "drag_v", "invm_v", "act_v")
    for name, k, q in zip(names, (0, 1, 2, 3, 4, 5, 6, 8, 9, 10), out):
        if name.startswith("act"):
            per = per_fc if name == "act_u" else per_cf
            np.testing.assert_array_equal((q * (1 - per)).numpy(), consts[k], err_msg=name)
        else:
            np.testing.assert_allclose(q.numpy(), consts[k], rtol=4e-4, atol=0, err_msg=name)


@pytest.mark.parametrize("shard", SHARDS)
def test_kernel_25_meshed_plain_on_a_shard_matches_jax(rect, rect_shard_kernels, shard):
    """2.5's plain version on shard ``shard`` of path B's (2, 2) mesh (the
    split directions' padded extent carried in ceil tiles, the overhang
    clamp-gathered and dropped, no wall fills), fed the JAX shard's inputs,
    against the JAX kernel in interpret mode: interiors within BARS after
    NSUB substeps (one chunk)."""
    mt = rect["B"][2]
    (params, consts, carry, out, _), shape = rect_shard_kernels["B"]
    grid = _port_shard_grid(mt, shard)
    consts, carry = (tuple(torch.as_tensor(q) for q in _shard_cut(x, shard, shape))
                     for x in (consts, carry))
    res = ttp.tiled_padded_evp_substeps_reference(torch.as_tensor(params), consts, carry, NSUB,
                                                  grid, FIXED)
    _assert_interiors_within_bars(grid, _shard_cut(out, shard, shape), res)


@pytest.fixture(scope="module")
def unpinned_shard_kernels(case):
    """The JAX shard kernel 2.7 of the tripolar case without
    ``fixed_tiles`` (its unpinned plan, from the JAX package's planner),
    seeded velocities: per shard its inputs and outputs."""
    sj = case[1]
    with _x32():
        mj, _ = _jax_case(fixed_tiles=None)
        return _jax_shard_kernels(mj, _seeded(mj, sj))


@pytest.mark.parametrize("shard", SHARDS)
def test_kernel_27_unpinned_plain_on_a_shard_matches_jax(unpinned_shard_kernels, shard):
    """2.7's plain version under the port's unpinned plan on shard
    ``shard`` of (2, 2) (the fold split across x, no refill), fed the JAX
    shard's inputs, against the JAX kernel under its own unpinned plan in
    interpret mode: interiors within BARS after NSUB substeps.  Without the
    immersed drag the function does not depend on the chunk length, which
    the two plans choose apart."""
    (params, planes, carry, out), shape = unpinned_shard_kernels
    grid = _port_shard_grid(_port_case(fixed_tiles=None), shard)
    plan = ttc._unpinned_plan(grid, NSUB)
    assert ttc._geometry(grid).refill is False
    res = ttc.tiled_curvilinear_evp_substeps_reference(
        torch.as_tensor(params), tuple(torch.as_tensor(q) for q in _shard_cut(planes, shard, shape)),
        tuple(torch.as_tensor(q) for q in _shard_cut(carry, shard, shape)), NSUB, grid, plan,
        (True, False))
    _assert_interiors_within_bars(grid, _shard_cut(out, shard, shape), res)


@pytest.fixture(scope="module")
def shard_kernels(case):
    """The JAX shard kernels on the case's thickness with seeded velocities."""
    mj, sj = case[:2]
    with _x32():
        return _jax_shard_kernels(mj, _seeded(mj, sj))


@pytest.mark.parametrize("shard", SHARDS)
def test_kernel_27_plain_on_a_shard_matches_jax(case, shard_kernels, shard):
    """2.7's plain version on shard ``shard`` of (2, 2) (no wrap along the
    split directions, gated walls, no refill of the fold split across x),
    fed the JAX shard's inputs, against the JAX kernel in interpret mode:
    interiors within BARS after 8 substeps."""
    (params, planes, carry, out, _), shape = shard_kernels
    grid = _port_shard_grid(case[2], shard)
    plan = ttc._fixed_plan(grid, NSUB, FIXED)
    assert ttc._geometry(grid).refill is False
    res = ttc.tiled_curvilinear_evp_substeps_reference(
        torch.as_tensor(params), tuple(torch.as_tensor(q) for q in _shard_cut(planes, shard, shape)),
        tuple(torch.as_tensor(q) for q in _shard_cut(carry, shard, shape)), NSUB, grid, plan,
        (True, False))
    _assert_interiors_within_bars(grid, _shard_cut(out, shard, shape), res)


@pytest.mark.parametrize("shard", SHARDS)
def test_kernel_29_plain_on_a_shard_matches_jax(case, shard_kernels, shard):
    """2.9's plain version on shard ``shard`` of (2, 2), seeded velocities,
    against the JAX kernel in interpret mode over the whole padded arrays:
    within 1e-4 of the largest value (the interpret-mode kernel's own
    rounding of the WENO weights, `test_torch_fixed_tiles.py:271-277`),
    where wrapping the split x direction instead of clamping it moves the
    halo outputs by more than 1e-2."""
    mt = case[2]
    (_, _, _, _, adv), (nxp, nyp) = shard_kernels
    ix, iy = shard
    u, v, h, per_fc, per_cf, div = (torch.as_tensor(q) for q in
                                    adv[:, ix * nxp:(ix + 1) * nxp, iy * nyp:(iy + 1) * nyp])
    H = 2 * NSUB + 3
    grid = tstep._local_grid(with_halo(mt.grid, (H, H)), 24, 48, ix, iy, ("x", "y"), (2, 2))
    metrics = tuple(grid.scalar(getattr(grid, n)).expand(grid.shape).contiguous()
                    for n in ("dy_fc", "dx_cf", "az_cc"))
    got = tadv.fixed_tile_div_reference(grid, (mt.advection, mt.advection), u, v, h,
                                        (per_fc > 0.5, per_cf > 0.5), metrics)
    rel = ((got.double() - div.double()).abs().max() / div.double().abs().max()).item()
    wrapped = dataclasses.replace(grid, mesh_axes=None, mesh_shape=None)
    moved = tadv.fixed_tile_div_reference(wrapped, (mt.advection, mt.advection), u, v, h,
                                          (per_fc > 0.5, per_cf > 0.5), metrics)
    rel_moved = ((moved.double() - div.double()).abs().max() / div.double().abs().max()).item()
    assert rel <= 1e-4, rel
    assert rel_moved > 1e-2, rel_moved


DRAG_NAMES, DRAG_HY = ("u", "v", "sig11", "sig12"), 35


def _drag_case(m, tripolar, Hy, drag=1e3, **device):
    """A 72×48 immersed tripolar grid with halo ``Hy``, land reaching the
    fold, ``ImmersedDrag(drag)`` (none for ``drag=None``), 16 substeps (two
    chunks of 8 in a serial step), the wide policy with fixed_tiles; the
    JAX package's or the port's by its module ``m`` and grid constructor
    ``tripolar``."""
    land = np.zeros((72, 48), bool)
    land[:, :3] = True
    land[26:46, 36:] = True
    grid = m.ImmersedBoundaryGrid(tripolar((72, 48), southernmost_latitude=-70.0, halo=Hy,
                                           dtype="float32", **device), land)
    dynamics = m.SeaIceMomentumEquation(
        rheology=m.ElastoViscoPlasticRheology(), top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=m.SemiImplicitStress(),
        immersed_drag=None if drag is None else m.ImmersedDrag(drag),
        solver=m.SplitExplicitSolver(substeps=16, halo_exchange="wide", fused="always",
                                     fixed_tiles=FIXED))
    return m.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                           advection=m.WENO(order=7), timestepper="ForwardEuler")


@pytest.fixture(scope="module")
def drag_case():
    """The 72×48 case: the JAX package's serial and (2, 1) results after one
    step, and the port's models with and without the drag and its state."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.grids import TripolarGrid
    from climaseaice_jl_tpu.parallel import make_distributed_step as jax_dstep
    from climaseaice_jl_tpu.parallel.stepper import strip_halos as jax_strip
    rng = np.random.default_rng(13)
    h0 = 0.5 + 0.5 * rng.random((72, 48))
    with _x32():
        mj = _drag_case(csi, TripolarGrid, DRAG_HY)
        sj = csi.initial_state(mj, h=h0, a=1.0, u=0.05)
        serial_j = jax_strip(mj, csi.step(mj, sj, 600.0))
        dstep, _ = jax_dstep(mj, (2, 1))
        dist_j = dstep(jax_strip(mj, sj), 600.0)
    mt = _drag_case(cst, cst.TripolarGrid, DRAG_HY, device="cpu")
    return dict(serial_jax={n: np.asarray(getattr(serial_j, n)) for n in DRAG_NAMES},
                dist_jax={n: np.asarray(getattr(dist_j, n)) for n in DRAG_NAMES},
                port=mt, state=state_from_numpy(mt, state_to_numpy(sj)),
                port_no_drag=_drag_case(cst, cst.TripolarGrid, DRAG_HY, drag=None,
                                        device="cpu"))


def test_xsplit_fold_with_drag_parts_from_serial_as_jax_does(drag_case, runs):
    """With an immersed drag next to a fold split across x, the fold halo
    that evolves without refills (the JAX package's design) is not an exact
    mirror: the drag samples each face at its own index.  The serial step
    refills it between its two chunks, so after one step on (2, 1) the
    port's distributed result parts from its serial one, only in the top
    2·16+3 rows; without the drag it equals it bit for bit, so the drag is
    the seed.  The JAX package's distributed step parts from its serial
    step too (on the CPU it does so with or without the drag), and the
    port's distributed result lies within ``BARS`` of it.  The drag is
    1e3, not the basin's 1e-3, so that the seed shows at this size."""
    serial_t = _serial(drag_case["port"], drag_case["state"], 1, 600.0)
    dist_t, dist_t_no_drag = (runs((1, 2))[k]["fields"] for k in ("drag", "no-drag"))
    serial_t_no_drag = _serial(drag_case["port_no_drag"], drag_case["state"], 1, 600.0)
    serial_j, dist_j = drag_case["serial_jax"], drag_case["dist_jax"]
    for name in DRAG_NAMES:
        for pkg, a, b in (("jax", dist_j[name], serial_j[name]),
                          ("port", dist_t[name], serial_t[name])):
            where = np.argwhere(a != b)
            assert len(where) and where[:, 1].min() >= 48 - DRAG_HY, (pkg, name, where)
        assert np.array_equal(dist_t_no_drag[name], serial_t_no_drag[name]), name
        ref = dist_j[name].astype(np.float64)
        rel = np.abs(dist_t[name] - ref).max() / np.abs(ref).max()
        assert rel <= BARS[name], (name, rel)


@pytest.mark.parametrize("row, amount, inside", [
    (None, 0.0, True),          # bitwise
    (0, 0.5, True),             # in the top CAP rows: reported, not barred
    (20, 1e-2, True),           # below them, within run_distributed_basin.py's u bar
    (20, 3e-2, False),          # below them, beyond it
    (40, 1e-6, False),          # deeper than the fold halo's rows
])
def test_xsplit_drag_band(row, amount, inside):
    """distributed_basin.compare counts, bounds and locates the parting of
    u from a serial field (rows counted down from the top), and
    xsplit_drag_band holds it to the top 35 rows and to the script's bars
    below the CAP rows."""
    rng = np.random.default_rng(5)
    serial = {n: (1.0 + rng.random((16, 48))).astype(np.float32) for n in ("u", "h")}
    dist = {n: q.copy() for n, q in serial.items()}
    if row is not None:
        dist["u"][3, 47 - row] += amount * np.abs(serial["u"]).max()
    cmp = db.compare(serial, dist)
    assert cmp["h"] == dict(points=0, rel_err=0.0, cap_rel_err=0.0, deepest_row=-1)
    assert cmp["u"]["points"] == (row is not None)
    assert cmp["u"]["deepest_row"] == (-1 if row is None else row)
    assert db.xsplit_drag_band(cmp, 35, 300.0) is inside


@pytest.mark.parametrize("kind", ["tripolar", "latlon", "rectilinear"])
def test_with_halo_matches_jax(kind):
    """grids.with_halo (through _curvilinear_with_halo or the constructors,
    and _shrink_dim_halos) gives the JAX package's coordinates, metrics and
    land mask bit for bit, with the x and y halos widened apart."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.grids import TripolarGrid, with_halo as jax_with_halo
    from climaseaice_jl_tpu_torch.grids import _METRIC_LOCS
    land = np.zeros((16, 24), bool)
    land[3:6, 20:] = True
    with _x32():
        if kind == "tripolar":
            gj = TripolarGrid((16, 24), halo=5, dtype="float32")
        elif kind == "latlon":
            gj = csi.LatitudeLongitudeGrid((16, 24), latitude=(50.0, 80.0), halo=5,
                                           dtype="float32")
        else:
            gj = csi.RectilinearGrid((16, 24), x=(0, 3e5), y=(0, 2e5), halo=5,
                                     topology=("periodic", "bounded"), dtype="float32")
        gj = jax_with_halo(csi.ImmersedBoundaryGrid(gj, land), (11, 7))
    if kind == "tripolar":
        gt = cst.TripolarGrid((16, 24), halo=5, dtype="float32", device="cpu")
    elif kind == "latlon":
        gt = cst.LatitudeLongitudeGrid((16, 24), latitude=(50.0, 80.0), halo=5,
                                       dtype="float32", device="cpu")
    else:
        gt = cst.RectilinearGrid((16, 24), x=(0, 3e5), y=(0, 2e5), halo=5,
                                 topology=("periodic", "bounded"), dtype="float32", device="cpu")
    gt = with_halo(cst.ImmersedBoundaryGrid(gt, land), (11, 7))
    assert (gt.Hx, gt.Hy) == (gj.Hx, gj.Hy) == (11, 7)
    for name in ("xc", "xf", "yc", "yf", "lon_cc", "lat_cc", "solid_cc", *_METRIC_LOCS):
        a, b = getattr(gj, name), getattr(gt, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert np.array_equal(np.broadcast_to(np.asarray(a), b.shape), b.numpy()), name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_meshed_kernels_match_plain(cuda_device):
    """On the card, 2.7 and 2.9 on shard (1, 1) of a (2, 2) mesh of the
    48×96 basin (halos 19, 8 substeps, seeded velocities) equal their plain
    versions bitwise (2.7 over the interiors, with 2 + 3·8 launches a call:
    the prep, the settled flags and three a substep;
    2.9 over the padded arrays)."""
    H = 2 * NSUB + 3
    m, s = db.build(48, 96, substeps=NSUB, fixed_tiles=FIXED, halo=H, device=cuda_device)
    g = m.grid
    rng = np.random.default_rng(3)
    u, v = (torch.as_tensor(0.05 * rng.standard_normal(g.interior_shape), dtype=torch.float32,
                            device=cuda_device) for _ in range(2))
    s = cst.initial_state(m, h=g.interior(s.h), a=g.interior(s.a), hs=g.interior(s.hs), u=u,
                          v=v)
    shard, nx, ny = (1, 1), 24, 48
    lg = tstep._local_grid(g, nx, ny, *shard, ("x", "y"), (2, 2),
                           tstep.ProcessMesh((2, 2), shard, cuda_device, transport=False))

    def cut(q):
        return q[nx:nx + nx + 2 * H, ny:ny + ny + 2 * H].contiguous()

    params, planes, carry, _, flags = ttc.tiled_curvilinear_inputs(m, s, DT, s.u, s.v)
    planes, carry = tuple(cut(q) for q in planes), tuple(cut(q) for q in carry)
    plan = ttc._fixed_plan(lg, NSUB, FIXED)
    ttc.tiled_curvilinear_evp_counter.reset()
    out = ttc.tiled_curvilinear_evp_substeps(params, planes, [q.clone() for q in carry], NSUB,
                                             lg, plan, flags)
    assert ttc.tiled_curvilinear_evp_counter.launches == 2 + 3 * NSUB
    ref = ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, NSUB, lg, plan,
                                                       flags)
    for o, r in zip(out, ref):
        assert torch.equal(lg.interior(o), lg.interior(r))
    masks = tuple(cut(q) for q in (m.masks.per_fc, m.masks.per_cf))
    metrics = tuple(lg.scalar(getattr(lg, n)).expand(lg.shape).contiguous()
                    for n in ("dy_fc", "dx_cf", "az_cc"))
    args = (lg, (m.advection, m.advection), cut(s.u), cut(s.v), cut(s.h), masks, metrics)
    assert torch.equal(tadv.fixed_tile_div(*args), tadv.fixed_tile_div_reference(*args))


@pytest.mark.cuda
def test_cuda_wide_halo_kernels_match_plain(cuda_device):
    """On the card, on shard (1, 1) of (2, 2) meshes with halos 2·NSUB+3,
    seeded velocities: 2.3 meshed (path A's case) and 2.5 meshed (path B's)
    equal their plain versions bitwise over the interiors, 2.4 meshed over
    the padded arrays; 2.7's unpinned plan (the tripolar basin without
    ``fixed_tiles``) over the interiors, with 2 + 3·NSUB launches a call
    (the fold split across x is not refilled)."""
    H, shard = 2 * NSUB + 3, (1, 1)
    rng = np.random.default_rng(4)
    for fixed in (None, FIXED):
        m = _rect_case(cst, fixed, halo=H, device=cuda_device)
        g = m.grid
        u, v = (torch.as_tensor(0.05 * rng.standard_normal(g.interior_shape),
                                dtype=torch.float32, device=cuda_device) for _ in range(2))
        h = torch.as_tensor(0.3 + 0.01 * rng.random(g.interior_shape), dtype=torch.float32,
                            device=cuda_device)
        s = cst.initial_state(m, h=h, a=1.0, u=u, v=v)
        nx, ny = g.Nx // 2, g.Ny // 2
        lg = tstep._local_grid(g, nx, ny, *shard, ("x", "y"), (2, 2),
                               tstep.ProcessMesh((2, 2), shard, cuda_device, transport=False))

        def cut(q):
            return q[nx:nx + nx + 2 * H, ny:ny + ny + 2 * H].contiguous()

        params, consts, carry, _ = tpad.padded_evp_inputs(m, s, DT, s.u, s.v)
        consts, carry = tuple(cut(q) for q in consts), tuple(cut(q) for q in carry)
        if fixed is None:
            out = tpad.padded_evp_substeps(params, consts, [q.clone() for q in carry], NSUB, lg)
            ref = tpad.padded_evp_substeps_reference(params, consts, carry, NSUB, lg)
        else:
            dt = g.scalar(DT)
            prm = tpad.evp_prep_params(m, dt)
            h, a = cut(s.h), cut(s.a)
            assert all(torch.equal(o, r) for o, r in zip(tpad.evp_prep(m, dt, h, a, lg),
                                                         tpad.evp_prep_reference(prm, h, a, lg)))
            out = ttp.tiled_padded_evp_substeps(params, consts, [q.clone() for q in carry],
                                                NSUB, lg, fixed)
            ref = ttp.tiled_padded_evp_substeps_reference(params, consts, carry, NSUB, lg,
                                                          fixed)
        for o, r in zip(out, ref):
            assert torch.equal(lg.interior(o), lg.interior(r))
    m, s = db.build(48, 96, substeps=NSUB, halo=H, device=cuda_device)
    g = m.grid
    lg = tstep._local_grid(g, 24, 48, *shard, ("x", "y"), (2, 2),
                           tstep.ProcessMesh((2, 2), shard, cuda_device, transport=False))

    def cut(q):
        return q[24:24 + 24 + 2 * H, 48:48 + 48 + 2 * H].contiguous()

    params, planes, carry, _, flags = ttc.tiled_curvilinear_inputs(m, s, DT, s.u, s.v)
    planes, carry = tuple(cut(q) for q in planes), tuple(cut(q) for q in carry)
    plan = ttc._unpinned_plan(lg, NSUB)
    ttc.tiled_curvilinear_evp_counter.reset()
    out = ttc.tiled_curvilinear_evp_substeps(params, planes, [q.clone() for q in carry], NSUB,
                                             lg, plan, flags)
    assert ttc.tiled_curvilinear_evp_counter.launches == 2 + 3 * NSUB
    ref = ttc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, NSUB, lg, plan,
                                                       flags)
    for o, r in zip(out, ref):
        assert torch.equal(lg.interior(o), lg.interior(r))
