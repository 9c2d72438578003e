"""One run of one cell: set-up, the measured window or the traced stretch,
the comparison with the reference, and the result line.

The window drives the users' entry point, ``Simulation.run``, in runs of
``steps_per_run`` steps until ``--seconds`` are spent.  A callback records
a CUDA event at every step boundary without synchronising; the events are
read after the window.  The run never writes a file of its own.
"""

from __future__ import annotations

import gc
import importlib
import json
import statistics
import sys
import time

import torch

from . import devtrace, registry, roofline
from .reference import compare
from .modcheck import forbidden_modules

PROGRAM = "climaseaice_jl_tpu_torch"
YEAR_S = 365.0 * 86400.0


class StepRecorder:
    """Callback of a Simulation: an event at each step boundary (a host
    clock reading on the CPU), and the states before and after the last
    step.  :meth:`begin` marks the start of a ``run()``, whose first firing
    precedes its first step; :meth:`reset` forgets the times.  It holds two
    states, as a user's loop does, so that the memory pool the warm-up
    grew serves the window."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.prev = self.cur = None
        self._fresh = False
        self.reset()

    def reset(self):
        self.runs = []
        self.steps = 0

    def begin(self):
        self._fresh = True

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __call__(self, sim):
        mark = self._mark()
        if self._fresh:
            self.runs.append([mark])
            self._fresh = False
            self.cur = sim.state
            return
        self.runs[-1].append(mark)
        self.prev, self.cur = self.cur, sim.state
        self.steps += 1

    def step_ms(self):
        """Every recorded step's time (ms), in order."""
        out = []
        for marks in self.runs:
            for a, b in zip(marks, marks[1:]):
                out.append(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out


def always(_sim):
    return True


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(sim, rec, steps_per_run, until=None, steps=None):
    """Run ``sim`` in runs of ``steps_per_run`` steps, until ``until``
    (perf_counter seconds) has passed at the end of a run, or for
    ``steps`` steps."""
    done = 0
    while True:
        n = steps_per_run if steps is None else min(steps_per_run, steps - done)
        rec.begin()
        sim.stop_iteration += n
        sim.run()
        done += n
        if (until is not None and time.perf_counter() >= until) or (
                steps is not None and done >= steps):
            return done


def sypd(steps, dt, wall_s):
    """Simulated years a wall-clock day."""
    return steps * dt / YEAR_S / (wall_s / 86400.0)


def device_info(device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def traced_record(sim, rec, device, steps_per_run, steps):
    """Drive ``steps`` steps under ``torch.profiler`` and read the trace."""
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        drive(sim, rec, steps_per_run, steps=steps)
        _sync(device)
    out = devtrace.record_from_profile(prof)
    del prof
    spans = out["device_ops"] + out["host_ops"]
    out.update(steps=steps, lo_us=min(s for _, s, _ in spans), hi_us=max(e for _, _, e in spans))
    return out


def per_layer(record):
    """Each per-layer metric whose reader finds something to read."""
    metrics = {}
    for name, mod in registry.metric_readers().items():
        value = mod.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    return metrics


def run_cell(workload, seed, seconds, trace, t0, device=None, traffic=None, chips_check=True):
    """One run of cell ``workload``; returns ``(exit code, result or None)``.

    ``t0``: perf_counter at process start.  ``device``, ``traffic`` (entries
    that replace the cell's traffic) and ``chips_check=False`` serve the CPU
    tests."""
    cell = registry.load_cell(workload)
    if traffic:
        cell["traffic_params"] = dict(cell["traffic_params"], **traffic)
    chips = int(cell["chips"])
    if chips_check:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"seaice_bench: the cell needs {chips} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2, None
        if chips != 1:
            print("seaice_bench: cells of more than one card are not run by this harness",
                  file=sys.stderr)
            return 2, None
    device = torch.device(device or "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cst = importlib.import_module(PROGRAM)
    cfg, tp, conf = cell["cfg"], cell["traffic_params"], cell["module"]

    # set-up: the model, the inputs from the seed, the warm-up of this cell's shapes
    model, dt = conf.build(cst, cfg, tp, device)
    fields = conf.inputs(model, cfg, tp, seed, device)
    state0 = conf.initial_state(cst, model, fields)
    sim = cst.Simulation(model, state0, dt, stop_iteration=0)
    rec = StepRecorder(device)
    sim.callbacks["seaice_bench"] = cst.Callback(rec, schedule=always)
    driven = drive(sim, rec, int(tp["warmup_steps"]), steps=int(tp["warmup_steps"]))
    # Simulation.run's NaN check fires every 100 iterations, first inside the
    # window: its kernels are loaded here (simulation.py:115-118)
    bool(torch.isnan(model.grid.interior(sim.state.h)).any())
    _sync(device)
    # what set-up made is old: the collector no longer walks it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    rec.reset()
    per_run = int(tp["steps_per_run"])
    result = {}
    start = time.perf_counter()
    driven += drive(sim, rec, per_run, until=start + seconds)
    _sync(device)
    wall = time.perf_counter() - start
    times = rec.step_ms()
    window = {"steps": rec.steps, "window_s": wall, "step_ms_median": statistics.median(times)}
    if not trace:
        result["metrics"] = {
            "sypd": {"value": sypd(rec.steps, dt, wall), "unit": "sim_yr/day"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        # after the untraced window, as a --trace 0 run has it, a stretch under the profiler
        n = int(tp["trace_steps"])
        rec.reset()
        record = traced_record(sim, rec, device, per_run, n)
        driven += n
        record.update(step_ms=times,
                      work_ms={k: roofline.least_ms(f, b)
                               for k, (f, b) in conf.work(cfg, tp).items()},
                      evp_kernels=conf.EVP_KERNELS,
                      kernels=getattr(conf, "KERNELS", {}))
        result["metrics"] = per_layer(record)
        busy = devtrace.intervals_union_us([(s, e) for _, s, e in record["device_ops"]])
        result["breakdown"] = devtrace.breakdown(record["device_ops"], record["host_ops"],
                                                 record["lo_us"], record["hi_us"])
        traced = {"busy_s": busy * 1e-6, "window_s": (record["hi_us"] - record["lo_us"]) * 1e-6}
        del record
    result["device"] = device_info(device, chips)
    if trace:
        result["device"].update(traced)

    # the program's state is dropped but for the states compared
    pre, post, steps = rec.prev, rec.cur, driven - int(tp["warmup_steps"])
    halo = model.grid.Hx
    del sim, rec, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    correct, numbers = compare.judge(cell["reference"], cfg, tp, cell["limits"], dt, fields,
                                     state0, pre, post, driven, halo)
    del pre, post, state0

    bad = forbidden_modules()
    if bad:
        print(f"seaice_bench: modules of the JAX package loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3, None
    result.update(correct=bool(correct), attempted=steps, failed=0 if correct else steps,
                  window=window, compared=numbers)
    order = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "window",
             "compared")
    return 0, {k: result[k] for k in order if k in result}


def report(result):
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output."""
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
