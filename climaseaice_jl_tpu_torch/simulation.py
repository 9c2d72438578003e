"""The run loop: Simulation, callbacks, schedules, NaN check.

Counterpart of `climaseaice_jl_tpu/simulation.py`.  A Simulation owns the
(model, state) pair, calls :func:`~.model.step` and fires host callbacks and
output writers (:mod:`.io`) on schedule; it picks up from a checkpoint and
writes a device trace of its loop where asked.
"""

from __future__ import annotations

import os
import socket
import time as _time

import numpy as np
import torch

from .model import step as _step
from .tracing import span, spanned
from .io.checkpoint import Checkpointer, restore_state


class IterationInterval:
    def __init__(self, n):
        self.n = n

    def __call__(self, sim):
        return sim.iteration % self.n == 0


class TimeInterval:
    def __init__(self, interval):
        self.interval = interval
        self._next = 0.0

    def __call__(self, sim):
        if sim.time + 1e-12 >= self._next:
            self._next = (np.floor(sim.time / self.interval) + 1) * self.interval
            return True
        return False


class Callback:
    def __init__(self, func, schedule=None):
        self.func = func
        self.schedule = schedule or IterationInterval(1)

    def maybe_fire(self, sim):
        if self.schedule(sim):
            self.func(sim)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    """Drive a model forward: ``Simulation(model, state, dt, stop_time=...)``.

    ``sim.run()`` loops the step, firing callbacks; the state after each
    step is ``sim.state``.  The stop test reads the state's clock every
    iteration, in the grid dtype, as the JAX package's Simulation does."""

    def __init__(self, model, state, dt, stop_time=None, stop_iteration=None,
                 check_nans=True):
        self.model = model
        self.state = state
        self.dt = float(dt)
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.callbacks = {}
        self.output_writers = {}
        self.check_nans = check_nans

    @property
    def time(self):
        return float(self.state.clock.time)

    @property
    def iteration(self):
        return int(self.state.clock.iteration)

    @spanned("seaice.run.stop_test")
    def should_stop(self):
        if self.stop_time is not None and self.time >= self.stop_time - 1e-9:
            return True
        if self.stop_iteration is not None and self.iteration >= self.stop_iteration:
            return True
        return False

    @spanned("seaice.run.callbacks")
    def _fire(self):
        for cb in self.callbacks.values():
            cb.maybe_fire(self)
        for w in self.output_writers.values():
            w.maybe_write(self)

    def run(self, pickup=None, profile_dir=None):
        """Run to the stop condition.

        ``pickup``: a checkpoint path, True to resume from the latest
        checkpoint of a registered :class:`.io.Checkpointer`, or an
        iteration number to resume from that one (`simulation.py:89-120`);
        the state is restored bit for bit on the model's device.
        ``profile_dir``: run the loop under ``torch.profiler`` (the card's
        kernels too where the model is on one) and write its Chrome trace
        into that directory, as ``<host>_<pid>.<ms>.pt.trace.json``
        (``self.trace_file``)."""
        if profile_dir is not None:
            return self._run_profiled(pickup, profile_dir)
        if pickup is not None and pickup is not False:
            self.state = restore_state(self.state, self._pickup_path(pickup))
        device = self.model.grid.device
        t0 = _time.perf_counter()
        steps0 = self.iteration
        first_step_done = False
        self._fire()
        while not self.should_stop():
            self.state = _step(self.model, self.state, self.dt)
            if not first_step_done:
                # the rate leaves out the first step (kernel builds)
                _synchronize(device)
                t0 = _time.perf_counter()
                steps0 = self.iteration
                first_step_done = True
            if self.check_nans:
                with span("seaice.run.nan_check"):
                    if (self.iteration % 100 == 0
                            and torch.isnan(self.model.grid.interior(self.state.h)).any()):
                        raise FloatingPointError(
                            f"NaN ice thickness at iteration {self.iteration}")
            self._fire()
        _synchronize(device)
        elapsed = _time.perf_counter() - t0
        steps = self.iteration - steps0
        if steps > 0 and elapsed > 0:
            g = self.model.grid
            self.points_per_second = g.Nx * g.Ny * steps / elapsed
        return self.state

    def _pickup_path(self, pickup):
        if pickup is not True and not isinstance(pickup, int):
            return pickup
        ckp = next((w for w in self.output_writers.values() if isinstance(w, Checkpointer)),
                   None)
        if ckp is None:
            raise ValueError(f"pickup={pickup!r} requires a Checkpointer output writer")
        if pickup is True:
            path = ckp.latest()
            if path is None:
                raise ValueError("pickup=True requires existing checkpoints")
            return path
        return f"{ckp.prefix}_iteration{int(pickup)}.npz"

    def _run_profiled(self, pickup, profile_dir):
        from torch.profiler import profile, ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if self.model.grid.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            state = self.run(pickup=pickup)
        self.trace_file = os.path.join(
            profile_dir, f"{socket.gethostname()}_{os.getpid()}.{int(_time.time() * 1e3)}"
                         ".pt.trace.json")
        prof.export_chrome_trace(self.trace_file)
        return state


def time_step(model, state, dt, steps=1):
    """Advance ``steps`` steps."""
    for _ in range(steps):
        state = _step(model, state, dt)
    return state
