"""The harness's arithmetic and files: finding cells and metrics by name,
the end-to-end metrics over all steps, the union of device intervals, the
roofline's bounds, and the check on loaded modules."""

import json
import shutil
import statistics

import numpy as np
import pytest

from seaice_bench import devtrace, harness, modcheck, registry, roofline

BENCHMARK = registry.ROOT.parent / "BENCHMARK.json"


def test_every_benchmark_entry_has_its_files():
    bench = json.loads(BENCHMARK.read_text())
    assert bench["paths"] == ["seaice_bench"]
    cells = set(registry.cell_names())
    readers = registry.metric_readers()
    for w in bench["workloads"]:
        assert w["name"] in cells
        cell = registry.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert hasattr(cell["module"], "build") and hasattr(cell["module"], "work")
        assert set(cell["limits"]) == {"start_bits", "halo_bits", "steps_lost",
                                       "unphysical"} | set(cell["reference"].COMPARED)
        assert {"initial", "step", "halo_image", "FIELDS", "FILLED", "COMPARED"} <= set(dir(cell["reference"]))
    for m in bench["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
    for c in bench["configs"]:
        cfg = json.loads((registry.ROOT.parent / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    root = tmp_path / "seaice_bench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "n64.json").write_text(json.dumps(
        {"N": 64, "warmup_steps": 1, "steps_per_run": 2, "trace_steps": 1}))
    (root / "cells" / "periodic_box.n64.json").write_text(json.dumps(
        {"config": "periodic_box", "traffic": "n64", "chips": 1, "why": "a test cell"}))
    (root / "metrics" / "steps_traced.py").write_text(
        'UNIT = "steps"\n\n\ndef read(record):\n    return record["steps"]\n')
    assert "periodic_box.n64" in registry.cell_names(root)
    cell = registry.load_cell("periodic_box.n64", root)
    assert cell["traffic_params"]["N"] == 64 and cell["cfg"]["name"] == "periodic_box"
    readers = registry.metric_readers(root)
    assert readers["steps_traced"].read({"steps": 3}) == 3
    assert set(registry.metric_readers()) < set(readers)


def test_sypd_and_p95_take_every_step():
    # 720 steps of 120 s in 10 s of wall time: a day of simulated time in
    # 10 s, 8640 simulated days a day
    assert harness.sypd(720, 120.0, 10.0) == pytest.approx(8640 / 365.0)
    p95 = registry.metric_readers()["step_ms_p95"].read
    times = [10.0] * 189 + [100.0] * 11
    assert p95({"step_ms": times}) == pytest.approx(float(np.percentile(times, 95)))
    assert p95({"step_ms": times}) > statistics.median(times)
    assert p95({"step_ms": times[:-2]}) < p95({"step_ms": times})


def test_step_recorder_times_every_step_across_runs():
    import torch

    class Sim:
        state = None

    rec = harness.StepRecorder(torch.device("cpu"))
    for run in range(3):
        rec.begin()
        for k in range(5):
            Sim.state = (run, k)
            rec(Sim)
    # each run's first firing precedes its first step: 4 steps a run
    assert rec.steps == 12 and len(rec.step_ms()) == 12
    assert (rec.prev, rec.cur) == ((2, 3), (2, 4))
    rec.reset()
    assert rec.steps == 0 and rec.step_ms() == [] and rec.cur == (2, 4)


def test_union_of_device_intervals():
    spans = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0)]
    assert devtrace.intervals_union_us(spans) == 17.0
    assert devtrace.gaps(spans, -3.0, 30.0) == [(-3.0, 0.0), (12.0, 20.0), (25.0, 30.0)]
    ops = [("periodic_chunk<2>", 0.0, 10.0), ("add", 5.0, 12.0), ("mul", 20.0, 25.0)]
    host = [("aten::add", 11.0, 21.0), ("step", 0.0, 30.0)]
    b = devtrace.breakdown(ops, host, 0.0, 30.0)
    assert b["device_ops"][0] == ["periodic_chunk<2>", pytest.approx(1e-5)]
    assert b["idle_gaps"][0] == ["aten::add", pytest.approx(8e-6)]


def test_roofline_bounds_match_the_recorded_ones():
    # PERF.md's kernel table: 2.2 at 2048² 1.0682 ms, 2.1 at 512² 0.0667 ms,
    # both bound by their operations
    assert roofline.least_ms(*roofline.periodic_evp(2048 ** 2, 120, True)) == \
        pytest.approx(1.0682, abs=5e-5)
    assert roofline.least_ms(*roofline.periodic_evp(512 ** 2, 120, False)) == \
        pytest.approx(0.0667, abs=5e-5)
    cell = registry.load_cell("periodic_box.n2048")
    work = cell["module"].work(cell["cfg"], cell["traffic_params"])
    assert roofline.least_ms(*work["evp"]) == pytest.approx(3 * 1.0682, abs=2e-4)
    cell = registry.load_cell("periodic_box.n512")
    work = cell["module"].work(cell["cfg"], cell["traffic_params"])
    assert roofline.least_ms(*work["evp"]) == pytest.approx(3 * 0.0667, abs=2e-4)


def test_roofline_readers():
    readers = registry.metric_readers()
    record = {"steps": 2, "device_ops": [("void periodic_chunk<K>", 0.0, 2000.0),
                                         ("add", 1500.0, 3000.0), ("fill", 4000.0, 5000.0)],
              "host_ops": [], "host_waits": 5, "lo_us": 0.0, "hi_us": 10000.0,
              "step_ms": [4.0, 5.0, 6.0], "work_ms": {"evp": 0.1, "advection": 0.05},
              "evp_kernels": r"\bperiodic_chunk\b"}
    assert readers["evp_roofline_pct"].read(record) == pytest.approx(10.0)
    assert readers["non_evp_device_ms"].read(record) == pytest.approx(1.0)
    assert readers["device_idle_pct"].read(record) == pytest.approx(60.0)
    assert readers["host_waits_per_step"].read(record) == 2.5
    assert readers["device_ops_per_step"].read(record) == 1.5
    assert readers["step_mfu_pct"].read(record) == pytest.approx(3.0)
    record["evp_kernels"] = r"\bno_such_kernel\b"
    assert readers["evp_roofline_pct"].read(record) is None


def test_basin_roofline_bounds_match_the_recorded_ones():
    # PERF.md's kernel table at the basin's 1162×970 padded and 1162×1018
    # widened grids (24 substeps, FPlane): 2.7 0.0793 ms, 2.8 0.0042, 2.9 with
    # array metrics 0.0172, 2.10 (x wind) 0.0040, 2.11 with the flux 0.0229
    padded, widened = 1162 * 970, 1162 * 1018
    assert roofline.least_ms(*roofline.tiled_curvilinear_evp(widened, 24)) == \
        pytest.approx(0.0793, abs=2e-4)
    assert roofline.least_ms(*roofline.advection_metrics(padded, 1)) == \
        pytest.approx(0.0172, abs=5e-5)
    assert roofline.least_ms(*roofline.layered_column(padded)) == pytest.approx(0.0229, abs=5e-5)
    flops, nbytes = roofline.strength_and_winds(widened, padded, 0)
    assert roofline.least_ms(flops, nbytes) == pytest.approx(0.0042, abs=5e-5)
    flops, nbytes = roofline.strength_and_winds(0, padded, 1)
    assert roofline.least_ms(flops, nbytes - 2 * roofline.F32) == pytest.approx(0.0040, abs=5e-5)


def test_kernel_roofline_readers():
    readers = registry.metric_readers()
    record = {"steps": 2, "device_ops": [("void tile_div<2, 7, 2, 7>(TileArgs)", 0.0, 400.0),
                                         ("void fixed_tile_div(float*)", 300.0, 500.0),
                                         ("thermo_column(Args)", 600.0, 800.0)],
              "host_ops": [], "work_ms": {"advection": 0.1, "column": 0.05, "pointwise": 0.01},
              "kernels": {"advection": r"\b(tile_div|fixed_tile_div)\b",
                          "column": r"\bthermo_column\b",
                          "pointwise": r"\b(ice_strength|pointwise_unit)\b"}}
    # the union of 2.9's launches is 0.5 ms in two steps
    assert readers["advection_roofline_pct"].read(record) == pytest.approx(40.0)
    assert readers["column_roofline_pct"].read(record) == pytest.approx(50.0)
    assert readers["pointwise_roofline_pct"].read(record) is None
    assert readers["column_roofline_pct"].read(dict(record, kernels={})) is None


def test_module_check_compares_whole_top_level_names():
    assert modcheck.forbidden_modules(["climaseaice_jl_tpu_torch", "climaseaice_jl_tpu_torch.model",
                                       "torch", "jaxtyping", "numpy"]) == []
    assert modcheck.forbidden_modules(["climaseaice_jl_tpu", "torch"]) == ["climaseaice_jl_tpu"]
    assert modcheck.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_nothing_the_benchmark_runs_imports_jax():
    import subprocess
    import sys
    code = ("import sys, seaice_bench.run, seaice_bench.harness, seaice_bench.control, "
            "seaice_bench.reference.compare, climaseaice_jl_tpu_torch\n"
            "from seaice_bench import registry\n"
            "[registry.load_cell(n) for n in registry.cell_names()]\n"
            "registry.metric_readers()\n"
            "from seaice_bench.modcheck import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=registry.ROOT.parent, check=True).stdout.splitlines()
    assert out == ["[]"]


def test_the_references_import_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys\n"
            "from seaice_bench import registry\n"
            "for name in registry.cell_names():\n"
            "    config = registry._json(registry.ROOT, 'cells', name)['config']\n"
            "    registry._module(registry.ROOT, 'reference', config)\n"
            "import seaice_bench.reference.compare\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'climaseaice_jl_tpu_torch', 'climaseaice_jl_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=registry.ROOT.parent, check=True).stdout.splitlines()
    assert out == ["[]"]
