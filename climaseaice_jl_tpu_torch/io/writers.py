"""Output writers: scheduled snapshots of model fields to NPZ or NetCDF.

Counterpart of `climaseaice_jl_tpu/io/writers.py`, with its files: the same
variables, coordinates and attributes.  Data moves from the device to the
host once a scheduled write.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Default output attributes per field (`writers.py:16-22`)
DEFAULT_ATTRIBUTES = {
    "h": {"long_name": "Sea ice thickness.", "units": "m"},
    "a": {"long_name": "Sea ice concentration.", "units": "-"},
    "hs": {"long_name": "snow thickness", "units": "m"},
    "S": {"long_name": "sea ice salinity", "units": "psu"},
    "Tu": {"long_name": "sea ice top surface temperature", "units": "degrees_Celsius"},
}

# Velocity attributes per grid kind (`writers.py:24-37`)
_VELOCITY_ATTRIBUTES = {
    "rectilinear": {
        "u": {"long_name": "Velocity in the +x-direction.", "units": "m/s"},
        "v": {"long_name": "Velocity in the +y-direction.", "units": "m/s"}},
    "latlon": {
        "u": {"long_name": "Velocity in the zonal direction (+ = east).", "units": "m/s"},
        "v": {"long_name": "Velocity in the meridional direction (+ = north).", "units": "m/s"}},
    "curvilinear": {
        "u": {"long_name": "Velocity in the i-direction (+ = increasing i).", "units": "m/s"},
        "v": {"long_name": "Velocity in the j-direction (+ = increasing j).", "units": "m/s"}},
}

# Coordinate variables' names and attributes per grid kind
_COORDINATES = {
    "rectilinear": (("x", {"long_name": "x", "units": "m"}),
                    ("y", {"long_name": "y", "units": "m"})),
    "latlon": (("lon", {"long_name": "longitude", "units": "degrees_east"}),
               ("lat", {"long_name": "latitude", "units": "degrees_north"})),
    "curvilinear": (("i", {"long_name": "cell index i", "units": "1"}),
                    ("j", {"long_name": "cell index j", "units": "1"})),
}


def default_output_attributes(grid):
    """The field attributes of a model on ``grid`` (`writers.py:49-55`)."""
    kind = getattr(grid, "kind", "rectilinear")
    attrs = dict(DEFAULT_ATTRIBUTES)
    attrs.update(_VELOCITY_ATTRIBUTES.get(kind, _VELOCITY_ATTRIBUTES["curvilinear"]))
    return attrs


def _host(q):
    return q.detach().cpu().numpy() if isinstance(q, torch.Tensor) else np.asarray(q)


def _gather_fields(sim, outputs):
    """The interiors of the named state fields and tracers, on the host."""
    grid = sim.model.grid
    out = {}
    for name in outputs:
        q = getattr(sim.state, name, None)
        if q is None and sim.state.tracers:
            q = sim.state.tracers.get(name)
        if q is not None:
            out[name] = _host(grid.interior(q))
    return out


class NPZWriter:
    """One ``<prefix>_<iteration>.npz`` a write, with the fields, ``time``
    and ``iteration``; ``overwrite`` first removes the prefix's files."""

    def __init__(self, outputs, prefix, schedule, overwrite=True):
        self.outputs = outputs
        self.prefix = prefix
        self.schedule = schedule
        self.times = []
        if overwrite:
            d = os.path.dirname(prefix) or "."
            base = os.path.basename(prefix)
            if os.path.isdir(d):
                for f in os.listdir(d):
                    if f.startswith(base) and f.endswith(".npz"):
                        os.remove(os.path.join(d, f))

    def maybe_write(self, sim):
        if not self.schedule(sim):
            return
        data = _gather_fields(sim, self.outputs)
        data["time"] = np.asarray(sim.time)
        data["iteration"] = np.asarray(sim.iteration)
        np.savez(f"{self.prefix}_{sim.iteration:08d}.npz", **data)
        self.times.append(sim.time)


class NetCDFWriter:
    """A NetCDF3 time series through ``scipy.io.netcdf_file``: the file is
    made at the first write (an unlimited ``time`` dimension, the grid
    kind's coordinate variables, the fields' attributes, float64
    variables), and every write appends one record along ``time``.  A file
    that already exists at the first write without ``overwrite`` (a run
    picked up from a checkpoint) is appended to."""

    def __init__(self, outputs, filename, schedule, overwrite=True, global_attributes=None):
        self.outputs = outputs
        self.filename = filename
        self.schedule = schedule
        self.global_attributes = dict(global_attributes or {})
        self._initialized = False
        if overwrite and os.path.exists(filename):
            os.remove(filename)

    @staticmethod
    def _coord_values(grid, axis):
        """Interior 1-D coordinate values along ``axis`` (0 x, 1 y)."""
        c = grid.xc if axis == 0 else grid.yc
        n = grid.Nx if axis == 0 else grid.Ny
        H = grid.Hx if axis == 0 else grid.Hy
        if c is None:
            return np.arange(n, dtype=float)
        c = _host(c).astype(float)
        if c.size == n + 2 * H:
            c = c[H:H + n]
        return c

    def _create(self, sim, data):
        from scipy.io import netcdf_file
        grid = sim.model.grid
        kind = getattr(grid, "kind", "rectilinear")
        (xname, xattrs), (yname, yattrs) = _COORDINATES.get(kind, _COORDINATES["curvilinear"])
        attrs = default_output_attributes(grid)
        with netcdf_file(self.filename, "w") as f:
            for k, v in self.global_attributes.items():
                setattr(f, k, v)
            f.createDimension("time", None)
            f.createDimension(xname, grid.Nx)
            f.createDimension(yname, grid.Ny)
            tvar = f.createVariable("time", "d", ("time",))
            tvar.units = "seconds"
            for name, ax, a in ((xname, 0, xattrs), (yname, 1, yattrs)):
                cv = f.createVariable(name, "d", (name,))
                cv[:] = self._coord_values(grid, ax)
                for k, v in a.items():
                    setattr(cv, k, v)
            for name in data:
                var = f.createVariable(name, "d", ("time", xname, yname))
                for k, v in attrs.get(name, {}).items():
                    setattr(var, k, v)
        self._initialized = True

    def maybe_write(self, sim):
        if not self.schedule(sim):
            return
        from scipy.io import netcdf_file
        data = _gather_fields(sim, self.outputs)
        if not self._initialized:
            if os.path.exists(self.filename):
                self._initialized = True
            else:
                self._create(sim, data)
        with netcdf_file(self.filename, "a") as f:
            tvar = f.variables["time"]
            n = tvar.shape[0] if tvar.shape and tvar.shape[0] else 0
            tvar[n] = float(sim.time)
            for name, arr in data.items():
                f.variables[name][n] = arr


class FieldTimeSeriesAccumulator:
    """An in-memory series of (time, fields) on schedule."""

    def __init__(self, outputs, schedule):
        self.outputs = outputs
        self.schedule = schedule
        self.times = []
        self.series = {name: [] for name in outputs}

    def maybe_write(self, sim):
        if not self.schedule(sim):
            return
        self.times.append(sim.time)
        for name, arr in _gather_fields(sim, self.outputs).items():
            self.series[name].append(arr)
