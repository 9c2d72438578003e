"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a small size (the look for a card skipped): a sound run
is correct, and a run whose timed path is broken underneath is not; the
bfloat16 control fails the limit that sound runs meet."""

import json
import time

import pytest

from seaice_bench import harness, registry
from seaice_bench.control import readings
from seaice_bench.faults import half_left_out, one_answer_altered, thickness_altered, unchanged

SMALL = {"periodic_box.n512": {"N": 32, "warmup_steps": 1, "steps_per_run": 2, "trace_steps": 2},
         "periodic_box.n2048": {"N": 24, "warmup_steps": 1, "steps_per_run": 1, "trace_steps": 1},
         "arctic_fixed.serial": {"Nx": 48, "Ny": 40, "warmup_steps": 1, "steps_per_run": 1,
                                 "trace_steps": 1}}


def run(workload, trace=False, seed=2 ** 32 + 7):
    code, result = harness.run_cell(workload, seed, 0.3, trace, time.perf_counter(),
                                    device="cpu", traffic=SMALL[workload], chips_check=False)
    assert code == 0
    return result


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct_and_prints_the_contract_line(workload, capsys):
    result = run(workload)
    harness.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"sypd", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["compared"]["start_bits"]["value"] == 0
    assert line["compared"]["halo_bits"]["value"] == 0
    assert err.strip().splitlines()[-1].startswith("compared unphysical")


def test_traced_run_reports_per_layer_metrics():
    result = run("periodic_box.n512", trace=True)
    assert result["correct"] is True
    assert {"host_waits_per_step", "step_mfu_pct", "step_ms_p95"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


FAULTS = [(w, f) for w in sorted(SMALL) for f in (unchanged, half_left_out)]
FAULTS += [(w, one_answer_altered) for w in sorted(SMALL) if w.startswith("periodic_box")]
FAULTS += [("arctic_fixed.serial", thickness_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch.setattr)
    result = run(workload)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for k, v in result["compared"].items()
               if k in registry.load_cell(workload)["reference"].COMPARED)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_bfloat16_control_fails_the_limit(workload):
    limits = registry.load_cell(workload)["limits"]
    rows, summary = readings(workload, [11, 12], {11, 12}, 1, device="cpu",
                             traffic=SMALL[workload])
    assert all(summary["lower"][k] <= limits[k] for k in summary["lower"])
    assert any(summary["upper"][k] > limits[k] for k in summary["upper"])


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    code, result = harness.run_cell("periodic_box.n512", 5, 2.0, False, time.perf_counter(),
                                    device=card)
    assert code == 0 and result["correct"] is True
    assert result["device"]["platform"] == "gpu"
