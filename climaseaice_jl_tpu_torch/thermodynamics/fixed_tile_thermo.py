"""Fixed-tile slab and snow thermodynamics: the column step of the
decomposition-invariant mode as one CUDA kernel.

Counterpart of `climaseaice_jl_tpu/thermodynamics/pallas_thermo.py`
together with `dynamics/pallas_pointwise.py:fixed_tile_pointwise_multi`,
which re-trace the whole column step on pinned tiles.  Here one CUDA
kernel (``csrc/thermo_column.cuh``, instantiated by a unit generated for the
model's flux programs) computes at every padded point, in one launch per
call, what :func:`.slab.bare_ice_thermodynamic_step` or
:func:`.slab.layered_thermodynamic_step` computes: the surface temperature
from the fixed-iteration secant (with its freeze where the flux difference
vanishes), the snow-ice interface temperature, the volume and concentration
updates, snowfall and flooding, and the diagnostics mf_*, Qtop, Qbot.  The
plain version is those slab functions themselves
(:func:`thermo_column_reference`).

The kernel takes flux specifications that are numbers, arrays, 0-d
tensors, FieldTimeSeries, RadiativeEmission, FluxFunctions and plain flux
callables, and tuples of them (summed in their order, as
:func:`.heat_bcs.getflux` sums them); the top conditions
MeltingConstrainedFluxBalance and PrescribedTemperature, the bottom ones
IceWaterThermalEquilibrium and PrescribedTemperature, snowfall as a number,
an array or a series.  A series is resolved once per call at the clock's
time into a 0-d device tensor that the kernel reads through its pointer, so
nothing is read back to the host.  A FluxFunction's callable is recorded
once (:mod:`..dynamics.fixed_tile_pointwise`, as `pallas_thermo.py:120-123,
154-157` re-traces it) on placeholders for the surface temperature, the
grid's ``lat_cc``/``lon_cc``, ``fields.h``, ``a``, ``hs``, ``S``, ``Tu``,
``Tus``, the clock's time and each series value at that time; its program
joins the flux programs and is evaluated at every secant iterate, as
emission is.  A callable outside the op set raises NotImplementedError on
either device.

The programs are compiled, not interpreted: :mod:`..dynamics.fixed_tile_codegen`
writes them as straight-line code, the values that do not depend on the
surface temperature computed once per point, into a unit that ``_build``
compiles and names by a hash of its text.  Everything a call does not
change is made at the model's first call on the card and kept with the model
(:class:`_Plan`): the programs, the unit and its C entry, the constants, the
float32 grid planes and Tb.  A call then passes the state's pointers, dt,
and the clock's time and series values at it.

The configuration's numbers enter as the plain version forms them: a
product of two Python numbers (ρs·ℒ₀, ρi·ℒ₀, ε·σ, 1 − ρi/ρw, the latent
heat's slope) in double precision, rounded to float32 where it meets a
tensor.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import _build
from ..dynamics.fused_evp import KernelCounter
from ..dynamics.fixed_tile_codegen import unit_source
from ..dynamics.fixed_tile_pointwise import (OP_CONST, OP_ARRAY, OP_SCALAR, OP_EMISSION, OP_ADD,
                                             OP_TEMP, PLACEHOLDER_SHAPE, record)
from .heat_bcs import (FluxFunction, RadiativeEmission, PrescribedTemperature,
                       MeltingConstrainedFluxBalance, IceWaterThermalEquilibrium,
                       bottom_temperature, _as_grid_value)
from .slab import (ConductiveFlux, ProportionalEvolution, bare_ice_thermodynamic_step,
                   layered_thermodynamic_step)

BARE_OUTPUTS = ("h", "a", "Tu", "mf_ice", "mf_snow", "mf_snowfall", "Qtop", "Qbot")
LAYERED_OUTPUTS = ("h", "a", "hs", "Tu", "Tus", "mf_ice", "mf_snow", "mf_snowfall",
                   "Qtop", "Qbot")

# the kernel's constants, in csrc/thermo_column.cuh's order (enum K)
_K_NAMES = ("hc", "rho_i", "neg_k_ice", "T0", "slope", "L0", "kL", "Tref", "k_snow",
            "k_ice", "rho_s", "rho_s_L0", "rho_i_L0", "flood", "rho_w")
# pointer slots before the flux programs' own (enum P)
_P_NAMES = ("h", "a", "hs", "S", "Tu", "Tus", "dt", "Tb")
_MAX_K, _MAX_PTRS = 64, 32   # csrc/thermo_column.cuh's limits

fixed_tile_thermo_counter = KernelCounter()


def _number(x, what):
    if isinstance(x, (bool, np.bool_)) or not isinstance(x, (int, float, np.number)):
        raise NotImplementedError(f"the fixed-tile thermodynamics kernel takes {what} as a "
                                  f"number, got {type(x).__name__}")
    return float(x)


# --- recorded flux callables -------------------------------------------------------

_STATE_NAMES = ("h", "a", "hs", "S", "Tu", "Tus")
_recordings = weakref.WeakKeyDictionary()


class _Standin:
    """An argument of a recorded flux callable: the attributes in ``slots``
    are placeholders (made at first read), the others come from ``base`` or,
    without one, raise NotImplementedError."""

    def __init__(self, rec, what, slots, base=None, **fixed):
        self._rec, self._what, self._slots, self._base = rec, what, slots, base
        self._made = {}
        self.__dict__.update(fixed)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._slots:
            if name not in self._made:
                slot, shape = self._slots[name]
                self._made[name] = self._rec.placeholder(slot, shape)
            return self._made[name]
        if self._base is not None:
            return getattr(self._base, name)
        raise NotImplementedError(f"a fixed-tile flux reads {self._what}.{name}")


class _SeriesStandin:
    """A FieldTimeSeries in a recorded flux: its value at the clock's time."""

    def __init__(self, rec, series, clock):
        self._rec, self._series, self._clock = rec, series, clock
        self._value = None

    def at_time(self, t):
        if t is not self._clock.time:
            raise NotImplementedError("a fixed-tile flux reads a series at another time "
                                      "than the clock's")
        if self._value is None:
            self._value = self._rec.placeholder(("series", self._series), ())
        return self._value

    def __call__(self, grid, Tu, clock, fields):
        return self.at_time(clock.time)


def _parameters_standin(p, rec, clock):
    if hasattr(p, "at_time"):
        return _SeriesStandin(rec, p, clock)
    if isinstance(p, (tuple, list)):
        return type(p)(_parameters_standin(q, rec, clock) for q in p)
    return p


def flux_recording(spec, grid, present):
    """The program of a FluxFunction (or a plain flux callable) on ``grid``
    with the state fields ``present``, recorded once per flux and layout.
    Raises NotImplementedError where it leaves the op set."""
    func, params = ((spec.func, spec.parameters) if isinstance(spec, FluxFunction)
                    else (spec, None))
    planes = tuple(n for n in ("lat_cc", "lon_cc") if getattr(grid, n, None) is not None)

    def make(rec):
        arr = PLACEHOLDER_SHAPE
        g = _Standin(rec, "grid", {n: (("grid", n), arr) for n in planes}, base=grid,
                     shape=arr, interior_shape=arr)
        clock = _Standin(rec, "clock", {"time": (("time",), ())})
        fields = _Standin(rec, "fields", {n: (("field", n), arr) for n in present})
        args = [g, rec.placeholder(("temp",), arr), clock, fields]
        if params is not None:
            args.append(_parameters_standin(params, rec, clock))
        return args

    key = (str(grid.device), planes, present)
    per_spec = _recordings.setdefault(spec, {})
    if key not in per_spec:
        per_spec[key] = record(func, make, grid.device)
    return per_spec[key]


def _present(model):
    layered = model.snow_thermodynamics is not None
    return tuple(n for n in _STATE_NAMES if layered or n not in ("hs", "Tus"))


def _recorded(spec):
    return isinstance(spec, FluxFunction) or (callable(spec) and not hasattr(spec, "at_time"))


def _check_flux(spec, model):
    """Record every flux callable (raising where one leaves the op set)."""
    if isinstance(spec, tuple):
        for s in spec:
            _check_flux(s, model)
    elif _recorded(spec):
        flux_recording(spec, model.grid, _present(model))


def check_fixed_tile_thermo(model):
    """Raise NotImplementedError where the model's column physics is
    outside what the fixed-tile kernel takes (checked on either device)."""
    _check_flux(model.top_heat_flux, model)
    _check_flux(model.bottom_heat_flux, model)
    for thermo in (model.ice_thermodynamics, model.snow_thermodynamics):
        if thermo is None:
            continue
        if not isinstance(thermo.internal_heat_flux, ConductiveFlux):
            raise NotImplementedError("the fixed-tile thermodynamics kernel takes a "
                                      "ConductiveFlux as the internal heat flux")
        if not isinstance(thermo.top_heat_bc, (MeltingConstrainedFluxBalance,
                                               PrescribedTemperature)):
            raise NotImplementedError(f"unsupported top heat boundary condition "
                                      f"{thermo.top_heat_bc!r}")
        if not isinstance(thermo.concentration_evolution, ProportionalEvolution):
            raise NotImplementedError("the fixed-tile thermodynamics kernel takes "
                                      "ProportionalEvolution")
    if not isinstance(model.ice_thermodynamics.bottom_heat_bc,
                      (IceWaterThermalEquilibrium, PrescribedTemperature)):
        raise NotImplementedError(f"unsupported bottom heat boundary condition "
                                  f"{model.ice_thermodynamics.bottom_heat_bc!r}")
    sf = model.snowfall
    if callable(sf) and not hasattr(sf, "at_time"):
        raise NotImplementedError("snowfall as a callable is not taken by the fixed-tile "
                                  "thermodynamics kernel")


# --- the plain version ----------------------------------------------------------

def thermo_column_reference(model, state, dt):
    """Plain PyTorch version of the kernel: the slab functions of
    :mod:`.slab` on the whole arrays.  Returns the outputs by name
    (:data:`BARE_OUTPUTS` or :data:`LAYERED_OUTPUTS`)."""
    from ..model import make_fields
    fields = make_fields(model, state)
    if model.snow_thermodynamics is None:
        h1, a1, Tu, diags = bare_ice_thermodynamic_step(model, state, fields, dt)
        return dict(h=h1, a=a1, Tu=Tu, **diags)
    h1, a1, hs1, Tu, Tus, diags = layered_thermodynamic_step(model, state, fields, dt)
    return dict(h=h1, a=a1, hs=hs1, Tu=Tu, Tus=Tus, **diags)


# --- the kernel's wrapper -------------------------------------------------------

class _Program:
    """The kernel's arguments as a model's flux programs bind them: the
    programs' (op, a, b) triples, float32 constants, and the tensors behind
    the device pointers: those fixed for the model (the cast grid planes, Tb,
    flux arrays) in ``tensors``, those made anew every call in ``per_call``
    (pointer index → a function of the clock giving the tensor: the clock's
    time, each series value at it).  The state fields and dt take the
    pointer slots of ``_P_NAMES``."""

    def __init__(self, model, clock):
        self.grid = model.grid
        self.clock = clock
        self.present = _present(model)
        self.k = [0.0] * len(_K_NAMES)
        self.tensors = [None] * len(_P_NAMES)
        self.per_call = {}

    def const(self, value):
        self.k.append(float(value))
        return len(self.k) - 1

    def pointer(self, tensor):
        self.tensors.append(tensor)
        return len(self.tensors) - 1

    def call_value(self, fn, kind=None):
        """An operation reading ``fn(clock)``, a 0-d value or a grid array
        made anew every call (its kind, unless ``kind`` is given, from this
        clock's value)."""
        grid = self.grid

        def make(clock):
            return _as_grid_value(fn(clock), grid).to(torch.float32).contiguous()

        t = make(self.clock)
        if kind is None:
            if t.dim() and tuple(t.shape) != grid.shape:
                raise NotImplementedError(f"a flux array of shape {tuple(t.shape)} on a grid "
                                          f"of {grid.shape}")
            kind = OP_SCALAR if t.dim() == 0 else OP_ARRAY
        self.tensors.append(None)
        self.per_call[len(self.tensors) - 1] = make
        return (kind, len(self.tensors) - 1, 0)

    def flux(self, spec):
        """Postfix operations of a flux specification: (op, a, b) triples."""
        if spec is None:
            return [(OP_CONST, self.const(0.0), 0)]
        if isinstance(spec, tuple):        # 0 + f₁ + f₂ + … in order
            ops = [(OP_CONST, self.const(0.0), 0)]
            for s in spec:
                ops += self.flux(s) + [(OP_ADD, 0, 0)]
            return ops
        if isinstance(spec, RadiativeEmission):
            c1 = (_number(spec.emissivity, "an emissivity")
                  * _number(spec.stefan_boltzmann_constant, "the Stefan-Boltzmann constant"))
            Tr = _number(spec.reference_temperature, "a reference temperature")
            return [(OP_EMISSION, self.const(c1), self.const(Tr))]
        if hasattr(spec, "at_time"):
            return [self.call_value(lambda clock: spec.at_time(clock.time))]
        if _recorded(spec):
            return self.recorded(spec)
        return [self.value(spec)]

    def recorded(self, spec):
        """A recorded flux's operations, its inputs bound to the state, the
        grid planes, the clock's time and the series values at it."""
        grid = self.grid
        rec = flux_recording(spec, grid, self.present)

        def slot(s):
            kind = s[0]
            if kind == "temp":
                return (OP_TEMP, 0)
            if kind == "field":
                return (OP_ARRAY, _P_NAMES.index(s[1]))
            if kind == "grid":
                plane = getattr(grid, s[1]).to(torch.float32).broadcast_to(grid.shape)
                return (OP_ARRAY, self.pointer(plane.contiguous()))
            if kind == "time":
                return self.call_value(lambda clock: clock.time, OP_SCALAR)[:2]
            return self.call_value(lambda clock: s[1].at_time(clock.time), OP_SCALAR)[:2]

        return rec.bind(self.const, slot, self.pointer)

    def value(self, x):
        """One operation pushing a number, a 0-d tensor or an array."""
        grid = self.grid
        if not isinstance(x, torch.Tensor) and not hasattr(x, "shape"):
            return (OP_CONST, self.const(_number(x, "a flux value")), 0)
        t = _as_grid_value(x, grid)
        if t.dim() == 0:
            return (OP_SCALAR, self.pointer(t.to(torch.float32).contiguous()), 0)
        if tuple(t.shape) != grid.shape:
            raise NotImplementedError(f"a flux array of shape {tuple(t.shape)} on a grid of "
                                      f"{grid.shape}")
        return (OP_ARRAY, self.pointer(t.to(torch.float32).contiguous()), 0)


class _Plan:
    """What every call of the column kernel on one model shares: the flux
    programs and their generated unit (:mod:`..dynamics.fixed_tile_codegen`),
    its C entry (loaded at the first launch), the constants, the pointers
    fixed for the model and how to make the others.  Made at the model's
    first call, from that call's clock (which fixes whether a series value
    is 0-d or an array)."""

    def __init__(self, model, clock):
        check_fixed_tile_thermo(model)
        grid = model.grid
        pt = model.phase_transitions
        ice, snow = model.ice_thermodynamics, model.snow_thermodynamics
        self.layered = snow is not None
        self.shape = grid.shape
        prog = _Program(model, clock)
        L0 = _number(pt.reference_latent_heat, "the latent heat")
        rho_i = _number(model.sea_ice_density, "the ice density")
        values = dict(
            hc=_number(model.ice_consolidation_thickness, "the consolidation thickness"),
            rho_i=rho_i,
            neg_k_ice=-_number(ice.internal_heat_flux.conductivity, "a conductivity"),
            T0=_number(pt.liquidus.freshwater_melting_temperature, "the melting temperature"),
            slope=_number(pt.liquidus.slope, "the liquidus slope"),
            L0=L0,
            kL=(_number(pt.liquid_density, "the water density")
                * _number(pt.liquid_heat_capacity, "a heat capacity")
                / _number(pt.density, "the ice density") - _number(pt.heat_capacity,
                                                                    "a heat capacity")),
            Tref=_number(pt.reference_temperature, "the reference temperature"),
            k_ice=_number(ice.internal_heat_flux.conductivity, "a conductivity"))
        if self.layered:
            rho_s = _number(model.snow_density, "the snow density")
            rho_w = _number(pt.liquid_density, "the water density")
            values.update(k_snow=_number(snow.internal_heat_flux.conductivity,
                                         "a conductivity"),
                          rho_s=rho_s, rho_s_L0=rho_s * L0, rho_i_L0=rho_i * L0,
                          flood=1 - rho_i / rho_w, rho_w=rho_w)
        for name, v in values.items():
            prog.k[_K_NAMES.index(name)] = v
        Tb = bottom_temperature(ice.bottom_heat_bc, grid, pt.liquidus, None)
        Tb = Tb.to(torch.float32).broadcast_to(grid.shape).contiguous() if Tb.dim() \
            else Tb.to(torch.float32)
        prog.tensors[_P_NAMES.index("Tb")] = Tb

        top_bc = (snow if self.layered else ice).top_heat_bc
        prescribed = isinstance(top_bc, PrescribedTemperature)
        sf = model.snowfall
        self.programs = (prog.flux(model.top_heat_flux), prog.flux(model.bottom_heat_flux),
                         [prog.call_value(lambda clock: sf.at_time(clock.time))
                          if hasattr(sf, "at_time") else prog.value(0.0 if sf is None else sf)])
        if len(prog.k) > _MAX_K or len(prog.tensors) > _MAX_PTRS:
            raise NotImplementedError("too many flux terms for the fixed-tile thermodynamics "
                                      "kernel")
        # ints but dt_number, which each call sets: layered, n, prescribed,
        # iterations, dt is a number, hc > 0, Tb is an array
        self.ints = [int(self.layered), grid.nxp * grid.nyp, int(prescribed),
                     0 if prescribed else int(top_bc.iterations), 0, int(values["hc"] > 0),
                     int(Tb.dim() == 2)]
        self.k = prog.k
        self.k_arr = (ctypes.c_float * len(prog.k))(*prog.k)
        self.tensors, self.per_call = prog.tensors, prog.per_call
        self.text = unit_source(self.programs)
        self.name = _build.generated_name("thermo_unit", self.text)
        self.scalar = grid.scalar
        self.dts = {}           # dt numbers → their 0-d tensors
        self.entry = None

    def dt_tensor(self, dt):
        if not isinstance(dt, torch.Tensor):
            if dt not in self.dts:
                if len(self.dts) >= 8:
                    self.dts.clear()
                self.dts[dt] = self.scalar(dt)
            return self.dts[dt]
        dt = dt.to(torch.float32).contiguous()
        if dt.dim() != 0:
            raise ValueError("dt must be a number or a 0-d tensor")
        return dt

    def inputs(self, state, dt):
        """The tensors behind the kernel's pointers for a call on ``state``
        with time step ``dt``, by pointer index."""
        tensors = list(self.tensors)
        fields = {"h": state.h, "a": state.a, "hs": state.hs if self.layered else state.h,
                  "S": state.S, "Tu": state.Tu, "Tus": state.Tus if self.layered else state.Tu}
        for name, q in fields.items():
            if q.dtype != torch.float32 or tuple(q.shape) != self.shape:
                raise ValueError(f"{name} must be a float32 {self.shape} tensor")
            tensors[_P_NAMES.index(name)] = q.contiguous()
        tensors[_P_NAMES.index("dt")] = self.dt_tensor(dt)
        for i, make in self.per_call.items():
            tensors[i] = make(state.clock)
        return tensors

    def launch(self, state, dt):
        if self.entry is None:
            lib = _build.load(self.name, self.text)
            fn = lib.csi_thermo_unit
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.csi_cuda_error_string
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self.entry = (fn, err)
        tensors = self.inputs(state, dt)
        ints = list(self.ints)
        ints[4] = int(not isinstance(dt, torch.Tensor))
        device = state.h.device
        out = torch.empty((10 if self.layered else 8,) + self.shape, dtype=torch.float32,
                          device=device)
        i_arr = (ctypes.c_int * len(ints))(*ints)
        p_arr = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
        fn, err_string = self.entry
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(ctypes.addressof(i_arr), len(ints), ctypes.addressof(self.k_arr),
                     len(self.k), ctypes.addressof(p_arr), len(tensors), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"fixed-tile thermodynamics kernel launch failed: CUDA error "
                               f"{err} ({err_string(err).decode()})")
        return out


_plans = weakref.WeakKeyDictionary()


def plan(model, clock):
    """``model``'s :class:`_Plan`, made with ``clock`` at its first call;
    ``plan(...).name`` and ``.text`` are its generated unit's."""
    if model not in _plans:
        _plans[model] = _Plan(model, clock)
    return _plans[model]


def thermo_column(model, state, dt):
    """The column step's outputs by name.  CUDA tensors go to the kernel
    (one launch), CPU tensors to :func:`thermo_column_reference`."""
    device = state.h.device
    if device.type == "cpu":
        check_fixed_tile_thermo(model)
        return thermo_column_reference(model, state, dt)
    if device.type != "cuda":
        raise ValueError(f"no thermodynamics kernel for device {device}")
    out = plan(model, state.clock).launch(state, dt)
    fixed_tile_thermo_counter.calls += 1
    fixed_tile_thermo_counter.launches += 1
    names = LAYERED_OUTPUTS if model.snow_thermodynamics is not None else BARE_OUTPUTS
    return dict(zip(names, out.unbind(0)))


def fixed_tile_thermo_step(model, state, dt):
    """The thermodynamic step of the fixed-tile mode (`pallas_thermo.py:
    169-249`): the updated state."""
    return state.evolve(**thermo_column(model, state, dt))
