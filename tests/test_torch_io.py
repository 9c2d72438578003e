"""The port's run-loop I/O (``climaseaice_jl_tpu_torch.io`` and
``Simulation.run``'s ``pickup`` and ``profile_dir``) against the JAX
package's.

* checkpoints: the same ``.npz`` keys as the JAX package writes for the same
  state, a JAX-written checkpoint restored into the port bit for bit and the
  reverse; the bit-equality of a restored run (`tests/test_checkpointing.py`)
  and the pickup modes of `tests/test_checkpointing.py:78` and
  `tests/test_forcing_and_pickup.py:75`;
* writers: the port's NPZ and NetCDF files equal the JAX writer's for the
  same states (variables, coordinates, attributes, appended records) on a
  rectilinear, a latitude-longitude and a tripolar grid, and the
  accumulator's series (`tests/test_writers.py`);
* a profiled run writes a Chrome trace and leaves the state as an unprofiled
  run does.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch.io import (save_checkpoint, load_checkpoint, restore_state,
                                         Checkpointer, NPZWriter, NetCDFWriter,
                                         FieldTimeSeriesAccumulator, default_output_attributes)

COMPARED = ("h", "a", "u", "v", "hs", "Tu", "sig11", "sig12")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the tier-1 run puts six test workers on the
    machine's cores, where PyTorch's OpenMP pool spins."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _csi():
    import climaseaice_jl_tpu as csi
    return csi


def _dev(lib):
    return {"device": "cpu"} if lib is cst else {}


def _config(lib, name, timestepper="SplitRungeKutta3"):
    """(model, dt) of `tests/test_checkpointing.py:_configs`: a thermodynamic
    column, a snow column, and EVP dynamics with WENO-5 on 8×8."""
    if name == "thermo":
        grid = lib.RectilinearGrid(size=(), **_dev(lib))
        model = lib.sea_ice_model(grid, top_heat_flux=100.0, bottom_heat_flux=-5.0)
        dt = 600.0
    elif name == "snow":
        grid = lib.RectilinearGrid(size=(), **_dev(lib))
        model = lib.sea_ice_model(grid, top_heat_flux=-50.0, bottom_heat_flux=-5.0,
                                  snow_thermodynamics=lib.snow_slab_thermodynamics(),
                                  snowfall=1e-5)
        dt = 600.0
    else:
        grid = lib.RectilinearGrid(size=(8, 8), x=(0, 10_000), y=(0, 10_000), **_dev(lib))
        dyn = lib.SeaIceMomentumEquation(
            rheology=lib.ElastoViscoPlasticRheology(),
            bottom_momentum_stress=lib.SemiImplicitStress(ue=0.1, ve=0.05),
            solver=lib.SplitExplicitSolver(substeps=8))
        model = lib.sea_ice_model(grid, dynamics=dyn, advection=lib.WENO(order=5))
        dt = 60.0
    return model.evolve(timestepper=timestepper), dt


def _initial(lib, model, name):
    return lib.initial_state(model, h=1, a=1, **({"hs": 0.1} if name == "snow" else {}))


def _equal(a, b):
    """Same fields (None where None), every array equal bit for bit."""
    for name in COMPARED:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name
    assert torch.equal(a.clock.time, b.clock.time)
    assert torch.equal(a.clock.iteration, b.clock.iteration)


# --- checkpoints ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["thermo", "snow", "dynamics"])
@pytest.mark.parametrize("timestepper", ["ForwardEuler", "SplitRungeKutta3"])
def test_checkpoint_bit_equality(name, timestepper, tmp_path):
    """`tests/test_checkpointing.py::test_checkpoint_bit_equality`: 10 steps
    in one go equal 5 steps, a checkpoint, a restore into a fresh state and
    5 more, bit for bit, clock included."""
    model, dt = _config(cst, name, timestepper)
    state = _initial(cst, model, name)
    cont = cst.time_step(model, state, dt, steps=10)
    half = cst.time_step(model, state, dt, steps=5)
    path = save_checkpoint(str(tmp_path / "checkpoint.npz"), half)
    fresh = restore_state(_initial(cst, model, name), path)
    _equal(cont, cst.time_step(model, fresh, dt, steps=5))


@pytest.mark.parametrize("name", ["thermo", "snow", "dynamics"])
def test_checkpoints_move_both_ways_between_the_packages(name, tmp_path):
    """After 3 JAX steps, the JAX package's checkpoint and the port's of the
    same state (carried across) hold the same keys, dtypes and bits; the
    JAX-written file restores into the port's template bit for bit, and the
    port-written one into the JAX template."""
    csi = _csi()
    from climaseaice_jl_tpu.io import save_checkpoint as jax_save, restore_state as jax_restore
    mj, dt = _config(csi, name)
    sj = _initial(csi, mj, name)
    for _ in range(3):
        sj = csi.step(mj, sj, dt)
    mt, _ = _config(cst, name)
    st = state_from_numpy(mt, state_to_numpy(sj))
    jax_file = jax_save(str(tmp_path / "jax.npz"), sj)
    port_file = save_checkpoint(str(tmp_path / "port.npz"), st)
    a, b = load_checkpoint(jax_file), load_checkpoint(port_file)
    assert sorted(a) == sorted(b) and "clock/time" in a and "h" in a
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key

    into_port = restore_state(_initial(cst, mt, name), jax_file)
    into_jax = jax_restore(_initial(csi, mj, name), port_file)
    ref = state_to_numpy(sj)
    for key, q in state_to_numpy(into_port).items():
        assert np.array_equal(q, ref[key]) and q.dtype == ref[key].dtype, key
    for key, q in state_to_numpy(into_jax).items():
        assert np.array_equal(q, ref[key]) and q.dtype == ref[key].dtype, key


@pytest.mark.parametrize("pickup", [True, 4, "path"])
def test_simulation_pickup_modes(pickup, tmp_path):
    """`tests/test_checkpointing.py::test_simulation_pickup_modes`: a run of
    8 iterations with a Checkpointer every 2, then a fresh run picked up
    from iteration 4 (by path, by number, or as the latest written before
    it) reaches iteration 8 with the same bits."""
    model, dt = _config(cst, "dynamics")
    sim = cst.Simulation(model, _initial(cst, model, "dynamics"), dt, stop_iteration=8)
    prefix = str(tmp_path / "chk")
    sim.output_writers["ckp"] = Checkpointer(prefix, cst.IterationInterval(2))
    sim.run()
    if pickup is True:            # the latest file is then iteration 4's
        for it in (6, 8):
            os.remove(f"{prefix}_iteration{it}.npz")
    sim2 = cst.Simulation(model, _initial(cst, model, "dynamics"), dt, stop_iteration=8)
    sim2.output_writers["ckp"] = Checkpointer(prefix, cst.IterationInterval(10 ** 9))
    sim2.run(pickup={"path": f"{prefix}_iteration4.npz", True: True, 4: 4}[pickup])
    assert sim2.iteration == 8
    _equal(sim.state, sim2.state)


def test_simulation_pickup(tmp_path):
    """`tests/test_forcing_and_pickup.py::test_simulation_pickup`: a column
    picked up from its iteration-5 checkpoint reaches iteration 10 with the
    straight run's thickness; pickup=True resumes from the latest one."""
    model, _ = _config(cst, "thermo")
    prefix = str(tmp_path / "chk")
    sim = cst.Simulation(model, _initial(cst, model, "thermo"), dt=600.0, stop_iteration=10)
    sim.output_writers["ckpt"] = Checkpointer(prefix, cst.IterationInterval(5))
    sim.run()
    sim2 = cst.Simulation(model, _initial(cst, model, "thermo"), dt=600.0, stop_iteration=10)
    sim2.output_writers["ckpt"] = Checkpointer(prefix, cst.IterationInterval(5))
    sim2.run(pickup=f"{prefix}_iteration5.npz")
    assert sim2.iteration == 10 and torch.equal(sim2.state.h, sim.state.h)
    sim3 = cst.Simulation(model, _initial(cst, model, "thermo"), dt=600.0, stop_iteration=12)
    sim3.output_writers["ckpt"] = Checkpointer(prefix, cst.IterationInterval(5))
    sim3.run(pickup=True)
    assert sim3.iteration == 12


def test_checkpoint_roundtrip_exact(tmp_path):
    """`tests/test_checkpointing.py::test_checkpoint_roundtrip_exact`, with a
    tracer: digits beyond float32 survive the round trip."""
    model = cst.sea_ice_model(cst.RectilinearGrid(size=(4, 4), device="cpu"))
    state = cst.initial_state(model, h=1.2345678901234567, a=0.987654321,
                              tracers={"age": 3.25})
    path = save_checkpoint(str(tmp_path / "c.npz"), state)
    assert "tracers/age" in load_checkpoint(path)
    back = restore_state(cst.initial_state(model, tracers={"age": 0.0}), path)
    _equal(state, back)
    assert torch.equal(back.tracers["age"], state.tracers["age"])


# --- writers ------------------------------------------------------------------------------

def _writer_model(lib, kind):
    """A snow-on-ice column model on 8×8 of ``kind``: rectilinear, latitude-
    longitude (`tests/test_writers.py:138-147`) or tripolar (16×16)."""
    if kind == "rectilinear":
        grid = lib.RectilinearGrid(size=(8, 8), **_dev(lib))
    elif kind == "latlon":
        grid = lib.LatitudeLongitudeGrid(size=(8, 8), longitude=(0, 8), latitude=(60, 68),
                                         halo=4, **_dev(lib))
    else:
        grid = lib.TripolarGrid((16, 16), southernmost_latitude=50.0, halo=4, **_dev(lib))
    return lib.sea_ice_model(grid, top_heat_flux=10.0,
                             snow_thermodynamics=lib.snow_slab_thermodynamics())


OUTPUTS = ["h", "a", "hs", "u", "v", "Tu"]


def _write_series(lib, model, states, tmp_path, tag):
    """The NetCDF, NPZ and accumulator outputs of a Simulation whose state
    is set to each of ``states`` in turn; returns (netcdf file, npz
    prefix, accumulator)."""
    sim = lib.Simulation(model, states[0], dt=600.0)
    nc = str(tmp_path / f"{tag}.nc")
    prefix = str(tmp_path / f"{tag}_snap")
    every = lib.IterationInterval(1)
    writers = [NetCDFWriter if lib is cst else _jax_io().NetCDFWriter,
               NPZWriter if lib is cst else _jax_io().NPZWriter,
               FieldTimeSeriesAccumulator if lib is cst else _jax_io().FieldTimeSeriesAccumulator]
    nc_w = writers[0](OUTPUTS, nc, every, global_attributes={"title": "writer check"})
    npz_w = writers[1](["h", "u"], prefix, every)
    acc = writers[2](["h", "v"], every)
    for s in states:
        sim.state = s
        for w in (nc_w, npz_w, acc):
            w.maybe_write(sim)
    return nc, prefix, acc


def _jax_io():
    import climaseaice_jl_tpu.io.writers as w
    return w


@pytest.mark.parametrize("kind", ["rectilinear", "latlon", "tripolar"])
def test_writers_match_the_jax_writers(kind, tmp_path):
    """Three states of a JAX run (iterations 0-2), written by both packages'
    NetCDF, NPZ and accumulator writers: the NetCDF files hold the same
    dimensions, variables, attributes (global, coordinate and per field, by
    grid kind), coordinates and three appended records, bit for bit; the
    NPZ files the same keys and arrays; the accumulators the same times and
    series."""
    from scipy.io import netcdf_file
    csi = _csi()
    mj, mt = _writer_model(csi, kind), _writer_model(cst, kind)
    rng = np.random.default_rng(2)
    h = 1.0 + 0.1 * rng.random(mj.grid.interior_shape)
    sj = csi.initial_state(mj, h=h, a=1.0, hs=0.1, u=0.02, v=-0.01)
    states_j = [sj]
    for _ in range(2):
        states_j.append(csi.step(mj, states_j[-1], 600.0))
    states_t = [state_from_numpy(mt, state_to_numpy(s)) for s in states_j]
    nc_j, pre_j, acc_j = _write_series(csi, mj, states_j, tmp_path, "jax")
    nc_t, pre_t, acc_t = _write_series(cst, mt, states_t, tmp_path, "port")
    assert default_output_attributes(mt.grid) == _jax_io().default_output_attributes(mj.grid)

    with netcdf_file(nc_j, "r", mmap=False) as fj, netcdf_file(nc_t, "r", mmap=False) as ft:
        assert fj.dimensions == ft.dimensions
        assert fj._attributes == ft._attributes == {"title": b"writer check"}
        assert sorted(fj.variables) == sorted(ft.variables)
        for name, vj in fj.variables.items():
            vt = ft.variables[name]
            assert vj.dimensions == vt.dimensions and vj._attributes == vt._attributes, name
            assert vj.data.dtype == vt.data.dtype and np.array_equal(vj.data, vt.data), name
        assert ft.variables["time"].shape == (3,)

    files_j, files_t = (sorted(glob.glob(p + "_*.npz")) for p in (pre_j, pre_t))
    assert [os.path.basename(f).replace("jax", "port") for f in files_j] == \
        [os.path.basename(f) for f in files_t] and len(files_t) == 3
    for fj, ft in zip(files_j, files_t):
        with np.load(fj) as a, np.load(ft) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert np.array_equal(a[key], b[key]), key

    assert acc_j.times == acc_t.times == [0.0, 600.0, 1200.0]
    for name in ("h", "v"):
        assert all(np.array_equal(a, b) for a, b in zip(acc_j.series[name], acc_t.series[name]))


def test_netcdf_streaming_appends_and_picks_up(tmp_path):
    """`tests/test_writers.py::test_netcdf_streaming_appends_incrementally`:
    one record a write through Simulation.run, the file growing with each;
    a writer that finds its file at its first write without ``overwrite``
    (a picked-up run) appends to it."""
    from scipy.io import netcdf_file
    model, _ = _config(cst, "dynamics")
    sim = cst.Simulation(model, _initial(cst, model, "dynamics"), dt=600.0, stop_iteration=4)
    fn = str(tmp_path / "stream.nc")
    w = NetCDFWriter(["h", "a"], fn, cst.IterationInterval(1))
    sizes = []
    write = w.maybe_write

    def tracking(s):
        write(s)
        sizes.append(os.path.getsize(fn))

    w.maybe_write = tracking
    sim.output_writers["nc"] = w
    sim.run()
    assert len(sizes) == 5 and sizes == sorted(sizes) and sizes[-1] > sizes[0]
    more = cst.Simulation(model, sim.state, dt=600.0, stop_iteration=6)
    more.output_writers["nc"] = NetCDFWriter(["h", "a"], fn, cst.IterationInterval(1),
                                             overwrite=False)
    more.run()
    with netcdf_file(fn, "r", mmap=False) as f:
        assert list(f.variables["time"][:]) == [600.0 * i for i in (0, 1, 2, 3, 4, 4, 5, 6)]
        assert f.variables["h"].shape == (8, 8, 8)
        assert f.variables["x"].units == b"m"


# --- device traces ------------------------------------------------------------------------

def test_profile_dir_writes_a_trace_and_leaves_the_state(tmp_path):
    """run(profile_dir=…) writes a Chrome trace of the loop into the
    directory (CPU activity here; the card's kernels where the model is on
    one), and the state equals an unprofiled run's bit for bit."""
    model, dt = _config(cst, "dynamics")
    plain = cst.Simulation(model, _initial(cst, model, "dynamics"), dt, stop_iteration=2)
    plain.run()
    sim = cst.Simulation(model, _initial(cst, model, "dynamics"), dt, stop_iteration=2)
    sim.run(profile_dir=str(tmp_path / "trace"))
    assert os.path.dirname(sim.trace_file) == str(tmp_path / "trace")
    assert sim.trace_file.endswith(".pt.trace.json")
    with open(sim.trace_file) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    _equal(plain.state, sim.state)


def test_distributed_basin_writes_its_netcdf(tmp_path):
    """distributed_basin.write_netcdf (the ``--output`` file of
    `run_distributed_basin.py:252-258`): the basin's interior-only fields,
    as a reassembly of rank snapshots gives them, padded and written as one
    NetCDF record of h, ℵ, u, v on the basin's index coordinates; the record
    holds the state's interiors (the y-face fields' seam row kept) and the
    state's time."""
    from scipy.io import netcdf_file
    from climaseaice_jl_tpu_torch import distributed_basin as db
    model, state = db.build(32, 64, substeps=8, fixed_tiles=(8, 128), device="cpu")
    state = cst.step(model, state, 600.0)
    stripped = cst.strip_halos(model, state)
    snapshot = {n: getattr(stripped, n).numpy() for n in ("u", "v", "h", "a", "hs")}
    snapshot["time"] = np.asarray(600.0)
    path = db.write_netcdf(model, stripped, snapshot, str(tmp_path / "dist_basin.nc"), 600.0)
    g = model.grid
    with netcdf_file(path, "r", mmap=False) as f:
        assert sorted(f.variables) == ["a", "h", "i", "j", "time", "u", "v"]
        assert list(f.variables["time"][:]) == [600.0]
        for name in ("h", "a", "u", "v"):
            want = g.interior(getattr(state, name)).numpy()
            assert np.array_equal(f.variables[name][0], want), name
