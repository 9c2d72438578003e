"""The port's layer spans (`climaseaice_jl_tpu_torch/tracing.py`): off
without a profiler, on under one, opened where the step and the run loop
open them, nested as the calls are, and without any effect on the
operations the step runs or on its result.  The box is the benchmark's
periodic αEVP configuration (`seaice_bench/configs/periodic_box.py`), cut
to 24² and 8 substeps: it takes the periodic fused route, whose EVP loop
runs on the CPU through `evp_substeps`'s plain version."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import tracing
from climaseaice_jl_tpu_torch.dynamics.fused_evp import fused_available
from seaice_bench import registry

FIELDS = ("h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu")
# spans a SplitRungeKutta3 step of the periodic fused route opens, a stage:
# the fill in update_state and one a field in the EVP route's re-padding
PER_STAGE = {"seaice.tracers": 2, "seaice.momentum": 1, "seaice.evp": 1,
             "seaice.column": 1, "seaice.fill": 7}
PARENT = {"seaice.tracers": "seaice.step", "seaice.momentum": "seaice.step",
          "seaice.column": "seaice.step", "seaice.evp": "seaice.momentum"}


def box(N=24, substeps=8):
    cell = registry.load_cell("periodic_box.n2048")
    conf, cfg = cell["module"], dict(cell["cfg"], substeps=substeps)
    device = torch.device("cpu")
    model, dt = conf.build(cst, cfg, {"N": N}, device)
    state = conf.initial_state(cst, model, conf.inputs(model, cfg, {"N": N}, 2 ** 33 + 5,
                                                       device))
    return model, state, dt


@pytest.fixture(scope="module")
def stepped():
    """One step of the box without a profiler and one under it, from the
    same state, with the profiled step's events."""
    model, state, dt = box()
    assert fused_available(model) and model.timestepper == "SplitRungeKutta3"
    plain = cst.step(model, state, dt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = cst.step(model, state, dt)
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    return model, state, dt, plain, traced, events


class Counting:
    calls = 0

    def __init__(self, name):
        Counting.calls += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_a_span_without_a_profiler_is_one_flag_check(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    Counting.calls = 0
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = tracing.span("seaice.step"), tracing.span("seaice.fill")
    assert first is second
    with first:
        pass
    model, state, dt = box(N=16, substeps=2)
    sim = cst.Simulation(model, state, dt, stop_iteration=2)
    sim.run()
    assert Counting.calls == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("seaice.step"):
            pass
    assert Counting.calls == 1


def test_spanned_keeps_the_function():
    @tracing.spanned("seaice.test")
    def f(a, b=2):
        """doc"""
        return a + b

    assert (f(1), f(1, b=5), f.__name__, f.__doc__) == (3, 6, "f", "doc")


def test_a_step_under_a_profiler_is_bitwise_the_step_without(stepped):
    _, _, _, plain, traced, _ = stepped
    for name in FIELDS:
        a, b = getattr(plain, name), getattr(traced, name)
        assert torch.equal(a, b), name
    assert int(plain.clock.iteration) == int(traced.clock.iteration) == 1


def test_a_step_opens_the_spans_of_each_layer(stepped):
    *_, events = stepped
    count = collections.Counter(n for n, _, _ in events if n.startswith("seaice."))
    assert count == {"seaice.step": 1, **{k: 3 * v for k, v in PER_STAGE.items()}}


@pytest.mark.parametrize("child", sorted(PARENT) + ["seaice.fill"])
def test_each_span_lies_inside_its_parent(stepped, child):
    *_, events = stepped
    spans = [e for e in events if e[0].startswith("seaice.")]
    step = [e for e in spans if e[0] == "seaice.step"][0]
    mine = [e for e in spans if e[0] == child]
    assert mine
    for _, s, e in mine:
        assert step[1] <= s <= e <= step[2]
        if child in PARENT:
            parents = [p for p in spans if p[0] == PARENT[child] and p[1] <= s and e <= p[2]]
            assert len(parents) == 1
    if child == "seaice.fill":
        # one fill in update_state (under the step itself), six in the EVP
        # route's re-padding (under the momentum step), none inside another
        inside = collections.Counter(
            max((p for p in spans if p[1] <= s and e <= p[2] and p != (child, s, e)),
                key=lambda p: p[1])[0] for _, s, e in mine)
        assert inside == {"seaice.step": 3, "seaice.momentum": 18}


def test_spans_add_no_operation_and_no_device_read(stepped, monkeypatch):
    model, state, dt, _, _, events = stepped
    with_spans = collections.Counter(n for n, _, _ in events if not n.startswith("seaice."))
    # the same step under the profiler with the spans turned off
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", False)
        cst.step(model, state, dt)
    without = collections.Counter(e.name for e in prof.events())
    assert not any(n.startswith("seaice.") for n in without)
    assert with_spans == without
    assert with_spans["aten::_local_scalar_dense"] == without["aten::_local_scalar_dense"]


def test_the_run_loop_opens_its_spans_and_holds_its_device_reads():
    """Simulation.run: a stop test a step and one more, a NaN check a
    step, the callbacks before the first step and after each; every read of
    the clock's iteration lies inside one of these spans but run()'s own
    three, and the step reads none."""
    model, state, dt = box(N=16, substeps=2)
    sim = cst.Simulation(model, state, dt, stop_iteration=1)
    sim.callbacks["noop"] = cst.Callback(lambda s: None)
    sim.run()
    sim.stop_iteration = 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run()
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    count = collections.Counter(n for n, _, _ in events if n.startswith("seaice.run"))
    assert count == {"seaice.run.stop_test": 4, "seaice.run.nan_check": 3,
                     "seaice.run.callbacks": 4}
    spans = [e for e in events if e[0].startswith("seaice.")]
    where = collections.Counter()
    for name, s, e in events:
        if name == "aten::_local_scalar_dense":
            inner = [p for p in spans if p[1] <= s and e <= p[2]]
            where[max(inner, key=lambda p: p[1])[0] if inner else None] += 1
    # the callback's IterationInterval reads the clock at each firing; the
    # rest are run()'s own reads for its rate: at its start, after the first
    # step and at its end
    assert where == {"seaice.run.stop_test": 4, "seaice.run.nan_check": 3,
                     "seaice.run.callbacks": 4, None: 3}
    assert not hasattr(sim, "wall_seconds")
