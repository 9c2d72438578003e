"""The tripolar basin's plain reference and the comparison's clock and field
names, on the CPU at small sizes: the reference's grid, land and fills
against the port's, its step against the port's fixed-tile step, the time
it is handed, and the faults a run of ``arctic_fixed.serial`` must refuse.
The port is imported here only to hold the reference to it; the reference
itself imports nothing of it (``test_bench_yardstick.py``)."""

import time

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
import climaseaice_jl_tpu_torch.fields as program_fields
from seaice_bench import harness, registry
from seaice_bench.faults import fold_sign_flipped, fold_sign_flipped_inside, forcing_a_month_late
from seaice_bench.reference import compare

WORKLOAD = "arctic_fixed.serial"
SMALL = {"Nx": 48, "Ny": 40, "warmup_steps": 1, "steps_per_run": 1, "trace_steps": 1}
DAY = 86400.0


def cell(Nx=48, Ny=40):
    c = registry.load_cell(WORKLOAD)
    c["traffic_params"] = dict(c["traffic_params"], Nx=Nx, Ny=Ny)
    return c


def program(Nx, Ny, seed=2 ** 31 + 3):
    c = cell(Nx, Ny)
    cfg, tp, conf = c["cfg"], c["traffic_params"], c["module"]
    model, dt = conf.build(cst, cfg, tp, "cpu")
    fields = conf.inputs(model, cfg, tp, seed, torch.device("cpu"))
    return c, model, dt, fields, conf.initial_state(cst, model, fields)


def run(seed=2 ** 32 + 11):
    code, result = harness.run_cell(WORKLOAD, seed, 0.3, False, time.perf_counter(),
                                    device="cpu", traffic=SMALL, chips_check=False)
    assert code == 0
    return result


@pytest.mark.parametrize("size", [(48, 40), (96, 80)])
def test_grid_and_land_equal_the_programs(size):
    Nx, Ny = size
    ref = cell(Nx, Ny)["reference"]
    grid = cst.TripolarGrid((Nx, Ny), southernmost_latitude=45.0, transition_latitude=65.0,
                            halo=5, dtype="float64", device="cpu")
    Hy = 5
    mine = ref.tripolar(Nx, Ny, Hy)
    for name, q in mine.items():
        theirs = getattr(grid, name)[grid.Hx:grid.Hx + Nx].numpy()
        np.testing.assert_allclose(q, np.broadcast_to(theirs, q.shape), rtol=1e-12, atol=0,
                                   err_msg=name)
    c, model, *_ = program(Nx, Ny)
    land = model.grid.interior(model.grid.solid_cc).numpy()
    assert (ref.land(Nx, Ny) == land).all()
    assert 0.5 < land.mean() < 0.95


@pytest.mark.parametrize("loc", ["cc", "fc", "cf", "ff"])
def test_halo_images_equal_the_programs_fills_bitwise(loc):
    ref = cell()["reference"]
    grid = program(48, 40)[1].grid
    name = {"cc": "h", "fc": "u", "cf": "v", "ff": "sig12"}[loc]
    q = torch.randn(grid.shape, generator=torch.Generator().manual_seed(5), dtype=torch.float32)
    filled = program_fields.FILLERS[tuple(loc)](q, grid)
    image = ref.halo_image(ref.interior(filled, grid.Hx, name), grid.Hx, name)
    assert torch.equal(image.view(torch.int32), filled.view(torch.int32))


def test_reference_step_follows_the_fixed_tile_step():
    c, model, dt, fields, state = program(48, 40)
    ref, cfg, tp = c["reference"], c["cfg"], c["traffic_params"]
    for _ in range(2):
        state = cst.step(model, state, dt)
    pre = state
    post = cst.step(model, pre, dt)
    start = compare.interiors(pre, ref.FIELDS, 5, ref)
    expected = compare.step(ref, cfg, tp, start, dt, pre)
    numbers = compare.compared(ref, expected, compare.interiors(post, ref.FIELDS, 5, ref))
    # float32 rounding of two different orders of the same operations,
    # a few steps from rest: far below the cell's limits
    assert all(v < 1e-4 for v in numbers.values()), numbers
    assert all(v < c["limits"][k] / 10 for k, v in numbers.items()), numbers


def test_a_month_later_the_forcing_differs():
    c, model, dt, fields, state = program(48, 40)
    ref, cfg, tp = c["reference"], c["cfg"], c["traffic_params"]
    state = cst.step(model, state, dt)
    start = compare.interiors(state, ref.FIELDS, 5, ref)
    now = ref.step(cfg, tp, start, dt, time=float(state.clock.time))
    later = ref.step(cfg, tp, start, dt, time=float(state.clock.time) + 30 * DAY)
    numbers = compare.compared(ref, now, later)
    assert any(v > c["limits"][k] for k, v in numbers.items()), numbers


def test_the_periodic_box_is_judged_as_before():
    """A reference that does not declare CLOCK_AND_NAMES is handed its
    interiors, no time, and periodic halo images: the parent's judgement."""
    c = registry.load_cell("periodic_box.n2048")
    ref = c["reference"]
    assert not hasattr(ref, "CLOCK_AND_NAMES")
    tp = dict(c["traffic_params"], N=24)
    model, dt = c["module"].build(cst, c["cfg"], tp, "cpu")
    fields = c["module"].inputs(model, c["cfg"], tp, 9, "cpu")
    s0 = c["module"].initial_state(cst, model, fields)
    pre = cst.step(model, s0, dt)
    post = cst.step(model, pre, dt)
    _, numbers = compare.judge(ref, c["cfg"], tp, c["limits"], dt, fields, s0, pre, post, 2, 5)
    plain = {n: getattr(pre, n)[5:-5, 5:-5] for n in ref.FIELDS}
    expected = ref.step(c["cfg"], tp, plain, dt)
    want = {name: max(compare.field_error(expected[f], getattr(post, f)[5:-5, 5:-5], norm)
                      for f in fields_)
            for name, (fields_, norm) in ref.COMPARED.items()}
    assert {k: numbers[k]["value"] for k in want} == want
    halo = sum(int((getattr(post, n) != ref.halo_image(getattr(post, n)[5:-5, 5:-5], 5)).sum())
               for n in ref.FILLED)
    assert numbers["halo_bits"]["value"] == halo == 0


@pytest.mark.parametrize("fault", [fold_sign_flipped, fold_sign_flipped_inside,
                                   forcing_a_month_late])
def test_basin_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch.setattr)
    result = run()
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["compared"].values())
