"""Fixed-tile slab and snow thermodynamics: the column step of the
decomposition-invariant mode as one CUDA kernel.

Counterpart of `climaseaice_jl_tpu/thermodynamics/pallas_thermo.py`
together with `dynamics/pallas_pointwise.py:fixed_tile_pointwise_multi`,
which re-trace the whole column step on pinned tiles.  Here
``csrc/thermo_fixed.cu`` computes at every padded point, in one launch per
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
from ..dynamics.fused_evp import KernelCounter, cuda_error_string
from ..dynamics.fixed_tile_pointwise import (OP_CONST, OP_ARRAY, OP_SCALAR, OP_EMISSION, OP_ADD,
                                             OP_TEMP, MAX_REGS, PLACEHOLDER_SHAPE, record)
from .heat_bcs import (FluxFunction, RadiativeEmission, PrescribedTemperature,
                       MeltingConstrainedFluxBalance, IceWaterThermalEquilibrium,
                       bottom_temperature, _as_grid_value)
from .slab import (ConductiveFlux, ProportionalEvolution, bare_ice_thermodynamic_step,
                   layered_thermodynamic_step)

BARE_OUTPUTS = ("h", "a", "Tu", "mf_ice", "mf_snow", "mf_snowfall", "Qtop", "Qbot")
LAYERED_OUTPUTS = ("h", "a", "hs", "Tu", "Tus", "mf_ice", "mf_snow", "mf_snowfall",
                   "Qtop", "Qbot")

# the kernel's constants, in csrc/thermo_fixed.cu's order (enum K)
_K_NAMES = ("hc", "rho_i", "neg_k_ice", "T0", "slope", "L0", "kL", "Tref", "k_snow",
            "k_ice", "rho_s", "rho_s_L0", "rho_i_L0", "flood", "rho_w")
# pointer slots before the flux programs' own (enum P)
_P_NAMES = ("h", "a", "hs", "S", "Tu", "Tus", "dt", "Tb")
_MAX_OPS, _MAX_K, _MAX_PTRS = 48, 64, 32   # csrc/thermo_fixed.cu's limits

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
    """The kernel's arguments: integer header and flux programs, float32
    constants and device pointers."""

    def __init__(self, model):
        self.model = model
        self.k = [0.0] * len(_K_NAMES)
        self.ptrs = [None] * len(_P_NAMES)
        self.keep = []          # tensors whose pointers the launch uses
        self.n_regs = 0         # registers of the recorded fluxes

    def const(self, value):
        self.k.append(float(value))
        return len(self.k) - 1

    def pointer(self, tensor):
        self.keep.append(tensor)
        self.ptrs.append(tensor.data_ptr())
        return len(self.ptrs) - 1

    def flux(self, spec, grid, clock):
        """Postfix operations of a flux specification: (op, a, b) triples."""
        if spec is None:
            return [(OP_CONST, self.const(0.0), 0)]
        if isinstance(spec, tuple):        # 0 + f₁ + f₂ + … in order
            ops = [(OP_CONST, self.const(0.0), 0)]
            for s in spec:
                ops += self.flux(s, grid, clock) + [(OP_ADD, 0, 0)]
            return ops
        if isinstance(spec, RadiativeEmission):
            c1 = (_number(spec.emissivity, "an emissivity")
                  * _number(spec.stefan_boltzmann_constant, "the Stefan-Boltzmann constant"))
            Tr = _number(spec.reference_temperature, "a reference temperature")
            return [(OP_EMISSION, self.const(c1), self.const(Tr))]
        if hasattr(spec, "at_time"):
            return [self.value(spec.at_time(clock.time), grid)]
        if _recorded(spec):
            return self.recorded(spec, grid, clock)
        return [self.value(spec, grid)]

    def recorded(self, spec, grid, clock):
        """A recorded flux's operations, its inputs bound to this call's
        state, grid planes, clock time and series values."""
        rec = flux_recording(spec, grid, _present(self.model))

        def slot(s):
            kind = s[0]
            if kind == "temp":
                return (OP_TEMP, 0)
            if kind == "field":
                return (OP_ARRAY, _P_NAMES.index(s[1]))
            if kind == "grid":
                plane = getattr(grid, s[1]).to(torch.float32).broadcast_to(grid.shape)
                return (OP_ARRAY, self.pointer(plane.contiguous()))
            t = clock.time if kind == "time" else s[1].at_time(clock.time)
            return (OP_SCALAR, self.pointer(t.to(torch.float32).contiguous()))

        ops = rec.bind(self.const, slot, self.pointer, reg_base=self.n_regs)
        self.n_regs += rec.n_regs
        if self.n_regs > MAX_REGS:
            raise NotImplementedError(f"flux callables needing more than {MAX_REGS} registers "
                                      "in all")
        return ops

    def value(self, x, grid):
        """One operation pushing a number, a 0-d tensor or an array."""
        if not isinstance(x, torch.Tensor) and not hasattr(x, "shape"):
            return (OP_CONST, self.const(_number(x, "a flux value")), 0)
        t = _as_grid_value(x, grid)
        if t.dim() == 0:
            return (OP_SCALAR, self.pointer(t.to(torch.float32).contiguous()), 0)
        if tuple(t.shape) != grid.shape:
            raise NotImplementedError(f"a flux array of shape {tuple(t.shape)} on a grid of "
                                      f"{grid.shape}")
        return (OP_ARRAY, self.pointer(t.contiguous()), 0)


def _program(model, state, dt):
    grid = model.grid
    pt = model.phase_transitions
    ice, snow = model.ice_thermodynamics, model.snow_thermodynamics
    layered = snow is not None
    prog = _Program(model)
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
    if layered:
        rho_s = _number(model.snow_density, "the snow density")
        rho_w = _number(pt.liquid_density, "the water density")
        values.update(k_snow=_number(snow.internal_heat_flux.conductivity, "a conductivity"),
                      rho_s=rho_s, rho_s_L0=rho_s * L0, rho_i_L0=rho_i * L0,
                      flood=1 - rho_i / rho_w, rho_w=rho_w)
    for name, v in values.items():
        prog.k[_K_NAMES.index(name)] = v

    f32 = torch.float32
    fields = {"h": state.h, "a": state.a, "hs": state.hs if layered else state.h,
              "S": state.S, "Tu": state.Tu, "Tus": state.Tus if layered else state.Tu}
    for name, q in fields.items():
        if q.dtype != f32 or tuple(q.shape) != grid.shape:
            raise ValueError(f"{name} must be a float32 {grid.shape} tensor")
        q = q.contiguous()
        prog.keep.append(q)
        prog.ptrs[_P_NAMES.index(name)] = q.data_ptr()
    dt_number = not isinstance(dt, torch.Tensor)
    dt_t = grid.scalar(dt) if dt_number else dt.to(f32).contiguous()
    if dt_t.dim() != 0:
        raise ValueError("dt must be a number or a 0-d tensor")
    Tb = bottom_temperature(ice.bottom_heat_bc, grid, pt.liquidus, None)
    Tb = Tb.to(f32).broadcast_to(grid.shape).contiguous() if Tb.dim() else Tb.to(f32)
    for name, t in (("dt", dt_t), ("Tb", Tb)):
        prog.keep.append(t)
        prog.ptrs[_P_NAMES.index(name)] = t.data_ptr()

    top_bc = (snow if layered else ice).top_heat_bc
    prescribed = isinstance(top_bc, PrescribedTemperature)
    sf = model.snowfall
    programs = [prog.flux(model.top_heat_flux, grid, state.clock),
                prog.flux(model.bottom_heat_flux, grid, state.clock),
                [prog.value(sf.at_time(state.clock.time), grid) if hasattr(sf, "at_time")
                 else prog.value(0.0 if sf is None else sf, grid)]]
    ints = [int(layered), grid.nxp * grid.nyp, int(prescribed),
            0 if prescribed else int(top_bc.iterations), int(dt_number),
            int(values["hc"] > 0), int(Tb.dim() == 2)]
    for ops in programs:
        if len(ops) > _MAX_OPS:
            raise NotImplementedError(f"a flux of more than {_MAX_OPS} terms")
        ints.append(len(ops))
        for op in ops:
            ints.extend(op)
    if len(prog.k) > _MAX_K or len(prog.ptrs) > _MAX_PTRS:
        raise NotImplementedError("too many flux terms for the fixed-tile thermodynamics "
                                  "kernel")
    return ints, prog


def _thermo_entry():
    fn = _build.load("thermo_fixed").csi_thermo_fixed
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def thermo_column(model, state, dt):
    """The column step's outputs by name.  CUDA tensors go to the kernel
    (one launch), CPU tensors to :func:`thermo_column_reference`."""
    check_fixed_tile_thermo(model)
    device = state.h.device
    if device.type == "cpu":
        return thermo_column_reference(model, state, dt)
    if device.type != "cuda":
        raise ValueError(f"no thermodynamics kernel for device {device}")
    grid = model.grid
    names = LAYERED_OUTPUTS if model.snow_thermodynamics is not None else BARE_OUTPUTS
    ints, prog = _program(model, state, dt)
    out = torch.empty((len(names),) + grid.shape, dtype=torch.float32, device=device)
    i_arr = (ctypes.c_int * len(ints))(*ints)
    k_arr = (ctypes.c_float * len(prog.k))(*prog.k)
    p_arr = (ctypes.c_void_p * len(prog.ptrs))(*prog.ptrs)
    fn = _thermo_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(i_arr), len(ints), ctypes.addressof(k_arr), len(prog.k),
                 ctypes.addressof(p_arr), len(prog.ptrs), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fixed-tile thermodynamics kernel launch failed: CUDA error "
                           f"{err} ({cuda_error_string('thermo_fixed', err)})")
    fixed_tile_thermo_counter.calls += 1
    fixed_tile_thermo_counter.launches += 1
    return dict(zip(names, out.unbind(0)))


def fixed_tile_thermo_step(model, state, dt):
    """The thermodynamic step of the fixed-tile mode (`pallas_thermo.py:
    169-249`): the updated state."""
    return state.evolve(**thermo_column(model, state, dt))
