"""The readers of the program's spans (``seaice_bench/spans.py`` and the six
metrics on it): pairing each device operation with the host call that
enqueued it, attributing it to the innermost span, refusing a pairing whose
counts or kinds differ but for calls at the start whose operations the
trace missed; a traced CPU run through the harness; and, on the card, the
pairing and the coverage of the cells' whole traces."""

import importlib
import time

import pytest

from seaice_bench import devtrace, harness, registry, spans

DEVICE_METRICS = ("tracers_device_ms", "momentum_eager_device_ms", "column_device_ms",
                  "fill_device_ms")
HOST_METRICS = ("step_host_ms", "run_loop_wait_ms")


def hand_built(steps=2):
    """Two steps' worth of a trace, µs: a step holding the momentum step
    (whose EVP call launches two chunks, the second as a programmatic
    dependent that starts inside the first, and whose fill makes a copy),
    the tracers, a stop test with its read of the clock, and one read of
    the clock outside any span."""
    host = [
        ("seaice.step", 0.0, 100.0),
        ("seaice.momentum", 10.0, 60.0),
        ("aten::mul", 11.0, 14.0),
        ("cudaLaunchKernel", 12.0, 13.0),
        ("seaice.evp", 20.0, 30.0),
        ("cudaLaunchKernelExC", 21.0, 22.0),
        ("cudaLaunchKernelExC", 23.0, 24.0),
        ("seaice.fill", 40.0, 50.0),
        ("cudaMemcpyAsync", 41.0, 42.0),
        ("seaice.tracers", 70.0, 80.0),
        ("cudaLaunchKernel", 71.0, 72.0),
        ("seaice.run.stop_test", 101.0, 105.0),
        ("aten::_local_scalar_dense", 101.5, 104.5),
        ("cudaMemcpyAsync", 102.0, 103.0),
        ("cudaMemcpyAsync", 106.0, 107.0),
        ("Activity Buffer Request", 108.0, 109.0),
    ]
    device = [
        ("void at::native::vectorized_elementwise_kernel<mul>", 100.0, 110.0),
        ("void periodic_chunk<2>", 111.0, 150.0),
        ("void periodic_chunk<2>", 140.0, 180.0),
        ("Memcpy DtoD (Device -> Device)", 181.0, 185.0),
        ("void weno_kernel", 186.0, 200.0),
        ("Memcpy DtoH (Device -> Pageable)", 201.0, 202.0),
        ("Memcpy DtoH (Device -> Pageable)", 203.0, 204.0),
    ]
    # the device's operations are listed out of order, as a trace may
    return {"steps": steps, "host_ops": host, "device_ops": device[::-1], "host_waits": 1,
            "lo_us": 0.0, "hi_us": 204.0, "evp_kernels": r"\bperiodic_chunk\b"}


def test_pairing_follows_the_order_of_calls_and_operations():
    pairs = spans.pair(hand_built())
    assert [(span, op[0][:12]) for span, op in pairs] == [
        ("seaice.momentum", "void at::nat"), ("seaice.evp", "void periodi"),
        ("seaice.evp", "void periodi"), ("seaice.fill", "Memcpy DtoD "),
        ("seaice.tracers", "void weno_ke"), ("seaice.run.stop_test", "Memcpy DtoH "),
        (None, "Memcpy DtoH ")]


def test_innermost_span_of_nested_and_disjoint_spans():
    nested = [("a", 0.0, 10.0), ("b", 1.0, 5.0), ("c", 2.0, 3.0), ("d", 6.0, 9.0)]
    times = [0.5, 2.5, 3.5, 5.5, 7.0, 9.5, 11.0]
    assert spans.innermost(nested, times) == ["a", "c", "b", "a", "d", "a", None]


def test_readers_split_device_time_by_the_innermost_span():
    readers = registry.metric_readers()
    record = hand_built(steps=2)
    # the momentum step's own work leaves out its EVP call and its fill
    assert readers["momentum_eager_device_ms"].read(record) == pytest.approx(10.0e-3 / 2)
    assert readers["fill_device_ms"].read(record) == pytest.approx(4.0e-3 / 2)
    assert readers["tracers_device_ms"].read(record) == pytest.approx(14.0e-3 / 2)
    assert readers["column_device_ms"].read(record) == 0.0
    # the two EVP chunks overlap: their union, not their sum
    assert spans.device_ms(record, ("seaice.evp",)) == pytest.approx(69.0e-3 / 2)
    assert readers["step_host_ms"].read(record) == pytest.approx(100.0e-3 / 2)
    assert readers["run_loop_wait_ms"].read(record) == pytest.approx(4.0e-3 / 2)


def test_a_pairing_whose_counts_or_kinds_differ_is_refused():
    readers = registry.metric_readers()
    # an operation lost in the middle: the counts differ and a copy would
    # pair with a kernel
    record = hand_built()
    record["device_ops"] = [op for op in record["device_ops"] if "weno" not in op[0]]
    assert spans.pair(record) is None
    assert all(readers[m].read(record) is None for m in DEVICE_METRICS)
    # the host's spans are read all the same
    assert all(readers[m].read(record) is not None for m in HOST_METRICS)
    # more operations than calls
    record = hand_built()
    record["device_ops"].append(("void extra", 300.0, 301.0))
    assert spans.pair(record) is None
    # more operations lost than the start of a stretch may lose
    record = hand_built()
    record["host_ops"] = [("cudaLaunchKernel", -100.0 + k, -99.5 + k)
                          for k in range(spans.LOST_AT_START + 1)] + record["host_ops"]
    assert spans.pair(record) is None


def test_calls_at_the_start_whose_operations_the_trace_missed_are_left_out():
    record = hand_built()
    record["host_ops"] = [("cudaMemcpyAsync", -20.0, -19.0),
                          ("seaice.run.stop_test", -30.0, -10.0),
                          ("cudaMemcpyAsync", -12.0, -11.0)] + record["host_ops"]
    assert spans.pair(record) == spans.pair(hand_built())
    # one call more at the start, but the operation lost is the fill's copy
    # in the middle: leaving out the first calls pairs a copy with a kernel
    record = hand_built()
    record["host_ops"] = [("cudaLaunchKernel", -12.0, -11.0)] + record["host_ops"]
    record["device_ops"] = [op for op in record["device_ops"] if "DtoD" not in op[0]]
    assert spans.pair(record) is None


def test_a_record_without_spans_or_device_operations_gives_none():
    readers = registry.metric_readers()
    record = hand_built()
    record["device_ops"] = []
    assert all(readers[m].read(record) is None for m in DEVICE_METRICS)
    # a trace of a program without spans, as the parent commit's
    record = hand_built()
    record["host_ops"] = [op for op in record["host_ops"] if not op[0].startswith("seaice.")]
    assert all(readers[m].read(record) is None for m in DEVICE_METRICS + HOST_METRICS)


def test_traced_cpu_run_reads_the_host_spans_and_no_device_time():
    small = {"N": 24, "warmup_steps": 1, "steps_per_run": 1, "trace_steps": 1}
    code, result = harness.run_cell("periodic_box.n2048", 2 ** 32 + 11, 0.3, True,
                                    time.perf_counter(), device="cpu", traffic=small,
                                    chips_check=False)
    assert code == 0 and result["correct"] is True
    metrics = result["metrics"]
    assert all(metrics[m]["value"] > 0 and metrics[m]["unit"] == "ms/step"
               for m in HOST_METRICS)
    assert not set(DEVICE_METRICS) & set(metrics)
    assert metrics["step_host_ms"]["value"] > metrics["run_loop_wait_ms"]["value"]


def traced_on_card(workload, device, steps, seed=2 ** 31 + 3):
    """The harness's traced record of ``steps`` steps of ``workload`` after
    its warm-up, on ``device``."""
    cell = registry.load_cell(workload)
    cfg, tp, conf = cell["cfg"], cell["traffic_params"], cell["module"]
    cst = importlib.import_module(harness.PROGRAM)
    model, dt = conf.build(cst, cfg, tp, device)
    sim = cst.Simulation(model, conf.initial_state(cst, model, conf.inputs(
        model, cfg, tp, seed, device)), dt, stop_iteration=0)
    rec = harness.StepRecorder(device)
    sim.callbacks["seaice_bench"] = cst.Callback(rec, schedule=harness.always)
    harness.drive(sim, rec, int(tp["warmup_steps"]), steps=int(tp["warmup_steps"]))
    record = harness.traced_record(sim, rec, device, int(tp["steps_per_run"]), steps)
    record["evp_kernels"] = conf.EVP_KERNELS
    return record


def union_ms(ops, steps):
    return devtrace.intervals_union_us([(s, e) for _, s, e in ops]) * 1e-3 / steps


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["periodic_box.n2048", "periodic_box.n512"])
def test_the_cells_traces_pair_and_their_spans_cover_the_device(card, workload):
    record = traced_on_card(workload, card, steps=3)
    pairs = spans.pair(record)
    assert pairs is not None, "launch calls and device operations do not pair"
    # at most the first few calls' operations are missing from the trace
    calls = sum(1 for op in record["host_ops"] if spans.ENQUEUE.match(op[0]))
    assert len(pairs) == len(record["device_ops"]) >= calls - spans.LOST_AT_START
    every = union_ms(record["device_ops"], record["steps"])
    outside = union_ms([op for span, op in pairs if span is None], record["steps"])
    assert outside < 0.01 * every
    # the EVP kernels, by the name evp_roofline_pct reads, are exactly what
    # the EVP span enqueued
    evp = [op for span, op in pairs if span == "seaice.evp"]
    assert sorted(evp) == sorted(devtrace.matching(record["device_ops"], record["evp_kernels"]))
    # the layers, the EVP launches and the run loop's own reads add up to
    # the device's busy time
    layers = [spans.device_ms(record, (f"seaice.{name}",))
              for name in ("tracers", "momentum", "column", "fill", "evp", "step")]
    loop = spans.device_ms(record, ("seaice.run.stop_test", "seaice.run.nan_check",
                                    "seaice.run.callbacks"))
    assert sum(layers) + loop + outside == pytest.approx(every, rel=0.02)
