"""Named spans of the step and the run loop, for a profiler's trace.

``with span("seaice.momentum"): ...`` marks the block as one operation of
that name in a ``torch.profiler`` trace, on the clock of the operations
the block launches, and as their parent.  The span is on exactly while a
profiler records (``Simulation.run(profile_dir=...)``, a benchmark's
traced stretch); otherwise it is one flag check and a shared no-op
object: no dispatcher call, no allocation, no device read.  A span reads
no device value and launches no device operation, so a step under a
profiler is bitwise the step without one.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _profiler

# the span while no profiler records
_OFF = contextlib.nullcontext()


def span(name):
    """A context manager that marks its block as ``name`` while a
    ``torch.profiler`` records, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def spanned(name):
    """Decorator: each call of the function is one :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
