"""Time-dependent forcing: FieldTimeSeries with linear time interpolation.

Counterpart of `climaseaice_jl_tpu/forcing_utils.py`.  A series is sampled
at the clock's time in the clock's dtype and on its device; the samples are
copied to that dtype and device once and kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils import frozen_dataclass, numpy_dtype


@frozen_dataclass
class FieldTimeSeries:
    """A (time, value) series with linear interpolation in time.

    ``times``: (Nt,) increasing sample times; ``data``: (Nt,) scalars or
    (Nt, ...) field snapshots.  Outside the sampled span the end values hold,
    as in ``numpy.interp``.  With ``cyclical=True`` lookups wrap with period
    ``times[-1] − times[0] + Δt_last`` unless ``period`` is given.  Called as
    a flux, ``(grid, Tu, clock, fields)``, it returns its value at
    ``clock.time``.

    A series keeps its last lookup: the flux of a FluxFunction that takes
    the series as its parameters is evaluated in every surface-temperature
    iteration at one clock time, and each lookup costs a dozen small device
    operations.  The lookup is reused only for the very tensor it was made
    at, unmodified since (its in-place version counter unchanged); the
    step functions make a new clock tensor every step and never write one
    in place."""
    times: object = None
    data: object = None
    period: object = None
    cyclical: bool = False
    _samples: dict = dataclasses.field(default_factory=dict, repr=False)
    # the last lookup: [time tensor, its version counter, value]
    _last: list = dataclasses.field(default_factory=lambda: [None, None, None], repr=False)

    def __post_init__(self):
        times = np.asarray(self.times.cpu() if isinstance(self.times, torch.Tensor)
                           else self.times, np.float64)
        data = self.data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data, np.float64))
        object.__setattr__(self, "times", torch.as_tensor(times))
        object.__setattr__(self, "data", data)
        if self.cyclical and self.period is None:
            object.__setattr__(self, "period", float(times[-1] - times[0]
                                                     + (times[-1] - times[-2])))

    def _on(self, t):
        """(times, data) in ``t``'s dtype and on its device."""
        key = (t.dtype, t.device)
        if key not in self._samples:
            self._samples[key] = (self.times.to(t.device, t.dtype),
                                  self.data.to(t.device, t.dtype))
        return self._samples[key]

    def at_time(self, t):
        """The series at time ``t`` (a tensor, or a number taken as float64).
        Samples are picked with index tensors, never Python integers, so a
        lookup does not wait for the device."""
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t, dtype=torch.float64)
        last_t, last_version, value = self._last
        if t is last_t and t._version == last_version:
            return value
        value = self._interpolate(t)
        self._last[:] = [t, t._version, value]
        return value

    def _interpolate(self, t):
        times, data = self._on(t)
        if self.cyclical:
            t = times[0] + torch.remainder(t - times[0], self.period)
        n = times.shape[0]
        i = torch.searchsorted(times, t.reshape(1), right=True)   # (1,)

        def at(q, k):   # q[k] for a (1,) index tensor k, keeping q's trailing shape
            return q.index_select(0, k)[0]

        if data.dim() == 1:
            # jnp.interp with the end values held
            i = torch.clamp(i, 1, n - 1)
            i0 = i - 1
            d0, t0 = at(data, i0), at(times, i0)
            df = at(data, i) - d0
            dx = at(times, i) - t0
            delta = t - t0
            tiny = np.spacing(np.finfo(numpy_dtype(times.dtype)).eps)
            dx0 = dx.abs() <= tiny
            f = torch.where(dx0, d0, d0 + (delta / torch.where(dx0, 1.0, dx)) * df)
            f = torch.where(t < times[0], data[0], f)
            return torch.where(t > times[-1], data[-1], f)
        # field series: lerp over the leading axis
        i = torch.clamp(i - 1, 0, n - 2)
        t0, t1 = at(times, i), at(times, i + 1)
        w = torch.where(t1 > t0, (t - t0) / torch.where(t1 > t0, t1 - t0, 1.0), 0.0)
        w = torch.clamp(w, 0.0, 1.0)
        return (1 - w) * at(data, i) + w * at(data, i + 1)

    def __call__(self, grid, Tu, clock, fields):
        return self.at_time(clock.time)
