"""Fixed-tile pointwise evaluation of an elementwise callable: the recorder
that turns the callable into a program, the plan that compiles the program
into a CUDA unit and launches it, and the plain version.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_pointwise.py:
fixed_tile_pointwise`, which re-traces any elementwise callable of arrays
and scalars inside a Pallas kernel on pinned (TX, TY) tiles, so that every
decomposition computes the same bits at a point (its caller is the basin's
winds, `validation/run_distributed_basin.py:76-94`).  A Python callable
cannot enter a hand-written CUDA kernel, so here the callable is *recorded*:
it runs once on small placeholder tensors under a
``torch.overrides.TorchFunctionMode`` that notes every operation applied to
them, and the record is compiled into a postfix program (constants, inputs,
operations, and registers for values used more than once).  A program is
recorded once per callable and kept, as a jitted JAX caller traces its
closure once.

The program is compiled, not interpreted: :class:`_Plan` binds it to
constant and pointer indices and :mod:`.fixed_tile_codegen` writes it as
straight-line CUDA code, one SSA value per operation in the program's own
order, each a call of ``csrc/pointwise_program.cuh``'s helpers with a
constant op code.  The unit's kernel evaluates it at one point a thread,
one launch per call; it is built by ``_build`` into ``_build/`` at its first
launch, named by a hash of its text.  Constants, pointers and 0-d values are
launch arguments, so the text depends on the callable's operations alone.
A plan is made once per callable, device, shape and count of inputs; a
call fills in its arrays' and scalars' pointers and launches.

The operations are those the repo's callables use: ``+ − × ÷``,
``remainder``, negation, reciprocal, ``sin``, ``cos``, ``exp``, ``sqrt``,
``abs``, ``clamp``/``clip``, ``minimum``/``maximum``, comparisons and
logical ``& | ~`` of them, ``where``/``masked_fill``, ``full_like``/
``zeros_like``/``ones_like``, dtype no-ops, and constants: Python numbers,
0-d tensors on the CPU (read once as numbers) and 0-d float32 tensors on the
card (read through their pointers).  Anything else raises
NotImplementedError naming the operation, on either device and before
anything is evaluated: an operation outside the set, a captured array, a
value read back to Python (data-dependent control flow), a float64
intermediate, more constants or inputs than a unit's launch arguments hold
(``MAX_K``, ``MAX_PTRS``).

Each operation is the one PyTorch computes on the card in float32, with its
forms: ``x / c`` for a Python number ``c`` is ``x·(1/c)`` with the
reciprocal rounded to float32, ``c / x`` is ``reciprocal(x)·c``, ``c − x`` is
``rsub``.  Python-number arithmetic inside the callable (``math.cos(φ₀)``)
happens in double and meets the tensors as one float32 constant.

:func:`fixed_tile_pointwise` picks by the tensors' device: CUDA tensors go to
the kernel, CPU tensors to :func:`fixed_tile_pointwise_reference`, which is
the callable called eagerly on the arrays.  A CUDA tensor never reaches the
plain version; a unit that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .. import _build
from .fused_evp import KernelCounter

# operations (csrc/pointwise_program.cuh, enum Op)
(OP_CONST, OP_ARRAY, OP_SCALAR, OP_EMISSION, OP_ADD, OP_TEMP, OP_LOAD, OP_STORE,
 OP_SUB, OP_MUL, OP_DIV, OP_DIVC, OP_REM, OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE,
 OP_EQ, OP_NE, OP_AND, OP_OR, OP_NEG, OP_RECIP, OP_SIN, OP_COS, OP_EXP, OP_SQRT, OP_ABS,
 OP_NOT, OP_CLAMP, OP_WHERE) = range(33)
MAX_K, MAX_PTRS = 64, 16   # constants and pointers a unit's launch arguments hold

_BINARY = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV, "rem": OP_REM,
           "minimum": OP_MIN, "maximum": OP_MAX, "lt": OP_LT, "le": OP_LE, "gt": OP_GT,
           "ge": OP_GE, "eq": OP_EQ, "ne": OP_NE, "and": OP_AND, "or": OP_OR}
_UNARY = {"neg": OP_NEG, "recip": OP_RECIP, "sin": OP_SIN, "cos": OP_COS, "exp": OP_EXP,
          "sqrt": OP_SQRT, "abs": OP_ABS, "not": OP_NOT}
# torch function names → the recorder's operation (in-place forms map to the same)
_ALIASES = {
    "add": "add", "__add__": "add", "__radd__": "add", "__iadd__": "add",
    "sub": "sub", "subtract": "sub", "__sub__": "sub", "__isub__": "sub",
    "rsub": "rsub", "__rsub__": "rsub",
    "mul": "mul", "multiply": "mul", "__mul__": "mul", "__rmul__": "mul", "__imul__": "mul",
    "div": "div", "divide": "div", "true_divide": "div", "__truediv__": "div",
    "__itruediv__": "div", "__rtruediv__": "rdiv",
    "remainder": "rem", "__mod__": "rem", "__rmod__": "rrem",
    "neg": "neg", "negative": "neg", "__neg__": "neg", "reciprocal": "recip",
    "sin": "sin", "cos": "cos", "exp": "exp", "sqrt": "sqrt", "abs": "abs", "__abs__": "abs",
    "clamp": "clamp", "clip": "clamp", "clamp_min": "clamp_min", "clamp_max": "clamp_max",
    "minimum": "minimum", "maximum": "maximum",
    "lt": "lt", "less": "lt", "__lt__": "lt", "le": "le", "less_equal": "le", "__le__": "le",
    "gt": "gt", "greater": "gt", "__gt__": "gt", "ge": "ge", "greater_equal": "ge",
    "__ge__": "ge", "eq": "eq", "__eq__": "eq", "ne": "ne", "not_equal": "ne", "__ne__": "ne",
    "logical_and": "and", "bitwise_and": "and", "__and__": "and", "__iand__": "and",
    "logical_or": "or", "bitwise_or": "or", "__or__": "or", "__ior__": "or",
    "logical_not": "not", "bitwise_not": "not", "__invert__": "not",
    "where": "where", "masked_fill": "masked_fill",
    "full_like": "full_like", "zeros_like": "zeros_like", "ones_like": "ones_like",
    "to": "same", "float": "same", "contiguous": "same", "clone": "same", "detach": "same",
    "broadcast_to": "same", "expand": "same", "expand_as": "same", "type_as": "same",
}
# queries of a tensor's metadata, answered without recording anything
_QUERIES = {"__get__", "dim", "ndimension", "size", "numel", "is_floating_point",
            "is_complex", "get_device", "__len__", "element_size"}
_LEAVES = ("const", "in", "cap")

fixed_tile_pointwise_counter = KernelCounter()


@dataclasses.dataclass
class PlanCounter:
    """Callables recorded and programs bound (each once per plan)."""
    records: int = 0
    binds: int = 0

    def reset(self):
        self.records = 0
        self.binds = 0


plan_counter = PlanCounter()


def _f32(x):
    return float(np.float32(x))


@dataclasses.dataclass
class Recording:
    """A callable's postfix program, before its inputs are bound to
    pointers.  ``ops`` are ``(op, a, b)``: ``OP_CONST`` carries the float32
    value in ``a``, ``OP_ARRAY`` an input slot's index (bound by the caller
    to an array, a scalar or the temperature argument), ``OP_SCALAR`` a
    captured 0-d device tensor's index in ``captured``, ``OP_CLAMP`` its
    bounds' values (None where absent), ``OP_LOAD``/``OP_STORE`` a register.
    ``slots`` describe the inputs, in the order the caller made them."""
    ops: list
    slots: list
    captured: list

    def bind(self, const, slot, pointer):
        """The unit's (op, a, b) triples: ``const(value)`` gives a constant's
        index, ``slot(s)`` an input's (op, a), ``pointer(t)`` a captured
        tensor's pointer index."""
        out = []
        for op, a, b in self.ops:
            if op == OP_CONST:
                out.append((OP_CONST, const(a), 0))
            elif op == OP_ARRAY:
                out.append((*slot(self.slots[a]), 0))
            elif op == OP_SCALAR:
                out.append((OP_SCALAR, pointer(self.captured[a]), 0))
            elif op == OP_CLAMP:
                out.append((OP_CLAMP, -1 if a is None else const(a),
                            -1 if b is None else const(b)))
            elif op == OP_DIVC:
                out.append((OP_DIVC, const(a), 0))
            elif op in (OP_LOAD, OP_STORE):
                out.append((op, a, 0))
            else:
                out.append((op, 0, 0))
        return out


class _Recorder(TorchFunctionMode):
    """Notes the operations applied to placeholder tensors as a DAG."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self.nodes = []        # (kind, *operands)
        self.index = {}        # node → its position (one node per distinct value)
        self.of = {}           # id(tensor) → (tensor, node)
        self.slots = []
        self.captured = []

    # -- nodes and operands --------------------------------------------------------
    def node(self, *key):
        if key not in self.index:
            self.index[key] = len(self.nodes)
            self.nodes.append(key)
        return self.index[key]

    def placeholder(self, slot, shape):
        t = torch.ones(shape, dtype=torch.float32, device=self.device)
        self.of[id(t)] = (t, self.node("in", len(self.slots)))
        self.slots.append(slot)
        return t

    def tracked(self, x):
        return isinstance(x, torch.Tensor) and self.of.get(id(x), (None,))[0] is x

    def operand(self, x):
        """The node of a tensor, number or captured 0-d tensor."""
        if self.tracked(x):
            return self.of[id(x)][1]
        if isinstance(x, (bool, int, float, np.number)):
            return self.node("const", _f32(x))
        if isinstance(x, torch.Tensor) and x.dim() == 0:
            if x.device.type == "cpu":
                return self.node("const", _f32(x.item()))
            if x.dtype != torch.float32:
                raise NotImplementedError(f"a captured {x.dtype} 0-d tensor in a fixed-tile "
                                          "program (float32 only)")
            for k, t in enumerate(self.captured):
                if t is x:
                    return self.node("cap", k)
            self.captured.append(x)
            return self.node("cap", len(self.captured) - 1)
        raise NotImplementedError(f"a captured {type(x).__name__}"
                                  f"{tuple(getattr(x, 'shape', ()))} in a fixed-tile program: "
                                  "arrays enter as inputs")

    def number(self, x, what):
        if x is None:
            return None
        if isinstance(x, torch.Tensor) and x.dim() == 0 and x.device.type == "cpu":
            return _f32(x.item())
        if isinstance(x, (bool, int, float, np.number)):
            return _f32(x)
        raise NotImplementedError(f"{what} of a fixed-tile program must be a number")

    # -- the mode ----------------------------------------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = list(args) + list(kwargs.values())
        flat += [y for x in flat if isinstance(x, (list, tuple)) for y in x]
        if not any(self.tracked(x) for x in flat):
            return func(*args, **kwargs)          # constant: evaluated as it stands
        name = getattr(func, "__name__", "")
        if name in _QUERIES:
            return func(*args, **kwargs)
        op = _ALIASES.get(name)
        if op is None and name.endswith("_") and not name.startswith("_"):
            op = _ALIASES.get(name[:-1])          # in-place form
        if op is None:
            raise NotImplementedError(f"operation {name or func!r} is outside the op set of "
                                      "the fixed-tile programs")
        node = self.build(op, func, args, kwargs)
        result = func(*args, **kwargs)
        if not isinstance(result, torch.Tensor):
            raise NotImplementedError(f"{name} reads a value back to Python in a fixed-tile "
                                      "program")
        if result.dtype not in (torch.float32, torch.bool):
            raise NotImplementedError(f"{name} gives a {result.dtype} value in a fixed-tile "
                                      "program (float32 only)")
        self.of[id(result)] = (result, node)
        return result

    def build(self, op, func, args, kwargs):
        arg = list(args)

        def get(i, key, default=None):
            return arg[i] if len(arg) > i else kwargs.get(key, default)

        o = self.operand
        if op == "same":
            return o(arg[0])
        if op in ("full_like", "zeros_like", "ones_like"):
            value = {"zeros_like": 0.0, "ones_like": 1.0}.get(op)
            return self.node("const", _f32(get(1, "fill_value") if value is None else value))
        if op in _UNARY:
            return self.node(op, o(arg[0]))
        if op in ("add", "sub") and kwargs.get("alpha", 1) != 1:
            raise NotImplementedError(f"{op} with alpha in a fixed-tile program")
        if op == "div":
            if kwargs.get("rounding_mode") is not None:
                raise NotImplementedError("div with a rounding mode in a fixed-tile program")
            b = get(1, "other")
            if not self.tracked(b) and not (isinstance(b, torch.Tensor)
                                            and b.device.type != "cpu"):
                # a Python number or CPU 0-d divisor: PyTorch's CUDA division
                # multiplies by its float32 reciprocal
                return self.node("divc", o(arg[0]), self.number(b, "a divisor"))
            return self.node("div", o(arg[0]), o(b))
        if op == "rdiv":
            return self.node("mul", self.node("recip", o(arg[0])), o(arg[1]))
        if op == "rsub":
            return self.node("sub", o(get(1, "other")), o(arg[0]))
        if op == "rrem":
            return self.node("rem", o(arg[1]), o(arg[0]))
        if op in _BINARY:
            return self.node(op, o(arg[0]), o(get(1, "other")))
        if op in ("clamp", "clamp_min", "clamp_max"):
            lo = get(1, "min") if op != "clamp_max" else None
            hi = get(2, "max") if op == "clamp" else (get(1, "max") if op == "clamp_max"
                                                       else None)
            return self.node("clamp", o(arg[0]), self.number(lo, "a clamp bound"),
                             self.number(hi, "a clamp bound"))
        if op == "where":
            if func is torch.Tensor.where:        # x.where(condition, y)
                return self.node("where", o(get(1, "condition")), o(arg[0]),
                                 o(get(2, "other")))
            return self.node("where", o(get(0, "condition")), o(get(1, "input")),
                             o(get(2, "other")))
        if op == "masked_fill":
            return self.node("where", o(get(1, "mask")), o(get(2, "value")), o(arg[0]))
        raise NotImplementedError(f"operation {op} in a fixed-tile program")

    # -- compilation -----------------------------------------------------------------
    def compile(self, out) -> Recording:
        root = self.operand(out)

        def children(n):   # node operands; constants' values are floats, not nodes
            kind, *rest = self.nodes[n]
            return [] if kind in _LEAVES else [c for c in rest if type(c) is int]

        uses = {}
        stack = [root]
        while stack:
            n = stack.pop()
            uses[n] = uses.get(n, 0) + 1
            if uses[n] == 1:
                stack.extend(children(n))
        regs = {}
        ops = []

        def emit(n):
            kind, *rest = self.nodes[n]
            if n in regs:
                ops.append((OP_LOAD, regs[n], None))
                return
            if kind == "const":
                ops.append((OP_CONST, rest[0], None))
            elif kind == "in":
                ops.append((OP_ARRAY, rest[0], None))
            elif kind == "cap":
                ops.append((OP_SCALAR, rest[0], None))
            elif kind == "divc":
                emit(rest[0])
                ops.append((OP_DIVC, rest[1], None))
            elif kind == "clamp":
                emit(rest[0])
                ops.append((OP_CLAMP, rest[1], rest[2]))
            elif kind == "where":
                for c in rest:
                    emit(c)
                ops.append((OP_WHERE, None, None))
            elif kind in _UNARY:
                emit(rest[0])
                ops.append((_UNARY[kind], None, None))
            else:
                emit(rest[0])
                emit(rest[1])
                ops.append((_BINARY[kind], None, None))
            if uses[n] > 1 and kind not in _LEAVES:
                regs[n] = len(regs)
                ops.append((OP_STORE, regs[n], None))

        emit(root)
        top = 0
        for op, _, _ in ops:
            if op in (OP_CONST, OP_ARRAY, OP_SCALAR, OP_TEMP, OP_LOAD, OP_EMISSION):
                top += 1
            elif op == OP_WHERE:
                top -= 2
            elif op in _BINARY.values():
                top -= 1
        if top != 1:
            raise AssertionError("fixed-tile program does not leave one value")
        return Recording(ops=ops, slots=list(self.slots), captured=list(self.captured))


PLACEHOLDER_SHAPE = (2,)


def record(fn, make_args, device) -> Recording:
    """Run ``fn(*make_args(recorder))`` on placeholders on ``device`` and
    compile what it did.  ``make_args`` makes the arguments with
    ``recorder.placeholder(slot, shape)``: shape ``PLACEHOLDER_SHAPE`` for an
    array, ``()`` for a 0-d value."""
    rec = _Recorder(torch.device(device))
    args = make_args(rec)
    with rec:
        out = fn(*args)
    plan_counter.records += 1
    return rec.compile(out)


# --- the recordings of pointwise callables ---------------------------------------------

_recordings = weakref.WeakKeyDictionary()


def pointwise_recording(fn, n_arrays, n_scalars, device) -> Recording:
    """The program of ``fn(*arrays, *scalars)``, recorded once per callable,
    count of inputs and device.  Raises NotImplementedError where ``fn``
    leaves the op set."""
    def make(rec):
        return ([rec.placeholder(("array", i), PLACEHOLDER_SHAPE) for i in range(n_arrays)]
                + [rec.placeholder(("scalar", i), ()) for i in range(n_scalars)])

    key = (n_arrays, n_scalars, str(device))
    try:
        per_fn = _recordings.setdefault(fn, {})
    except TypeError:        # not weakly referable: record every time
        return record(fn, make, device)
    if key not in per_fn:
        per_fn[key] = record(fn, make, device)
    return per_fn[key]


def _check_fixed(fixed):
    if (len(tuple(fixed)) != 2 or not all(isinstance(t, int) and t > 0 for t in fixed)):
        raise ValueError(f"fixed must be (TX, TY) with positive integers, got {fixed!r}")


def _scalar_tensor(s, device):
    if isinstance(s, torch.Tensor):
        if s.dim() != 0:
            raise ValueError("a fixed-tile scalar must be a number or a 0-d tensor")
        return s.to(device=device, dtype=torch.float32)
    return torch.full((), float(s), dtype=torch.float32, device=device)


# --- the plain version ------------------------------------------------------------------

def fixed_tile_pointwise_reference(fn, arrays, scalars=()):
    """Plain PyTorch version of the kernel: ``fn`` called eagerly on the
    arrays and scalars, as float32 of the arrays' shape."""
    shape = tuple(arrays[0].shape)
    out = fn(*arrays, *scalars)
    if not isinstance(out, torch.Tensor):
        return torch.full(shape, float(out), dtype=torch.float32, device=arrays[0].device)
    return out.to(torch.float32).broadcast_to(shape).contiguous()


# --- the kernel's wrapper -------------------------------------------------------------

class _Plan:
    """What every call of one callable on one device, shape and count of
    arrays and scalars shares: the recording, its program bound to constant
    and pointer indices (inputs first: the arrays, then the scalars, then the
    captured 0-d tensors), the constants (each float32 value once), the
    generated unit (:func:`.fixed_tile_codegen.pointwise_unit_source`) and
    its C entry (loaded at the first launch), and the ctypes argument
    arrays.  A call writes its arrays' and scalars' pointers into the
    pointer array and launches.  ``text`` and ``name`` work on the CPU too."""

    def __init__(self, fn, n_arrays, n_scalars, device, shape):
        from .fixed_tile_codegen import pointwise_unit_source
        self.rec = pointwise_recording(fn, n_arrays, n_scalars, device)
        self.k, self.tensors, index = [], [], {}

        def const(value):
            key = np.float32(value).tobytes()
            if key not in index:
                index[key] = len(self.k)
                self.k.append(_f32(value))
            return index[key]

        def pointer(t):
            self.tensors.append(t)
            return len(self.tensors) - 1

        inputs = {("array", i): (OP_ARRAY, pointer(None)) for i in range(n_arrays)}
        inputs.update({("scalar", i): (OP_SCALAR, pointer(None)) for i in range(n_scalars)})
        self.ops = self.rec.bind(const, inputs.__getitem__, pointer)
        plan_counter.binds += 1
        if len(self.k) > MAX_K or len(self.tensors) > MAX_PTRS:
            raise NotImplementedError(f"a pointwise program of {len(self.k)} constants and "
                                      f"{len(self.tensors)} inputs (a unit takes {MAX_K} and "
                                      f"{MAX_PTRS})")
        self.n_inputs = n_arrays + n_scalars
        self.shape, self.device = shape, device
        self.numel = int(np.prod(shape, dtype=np.int64))
        self.text = pointwise_unit_source(self.ops)
        self.name = _build.generated_name("pointwise_unit", self.text)
        self.k_arr = (ctypes.c_float * max(len(self.k), 1))(*self.k)
        self.p_arr = (ctypes.c_void_p * len(self.tensors))(
            *(0 if t is None else t.data_ptr() for t in self.tensors))
        self.entry = None

    def inputs(self, arrays, scalars):
        """The tensors behind the unit's pointers for a call, by pointer index."""
        return list(arrays) + list(scalars) + self.tensors[self.n_inputs:]

    def launch(self, arrays, scalars):
        """The unit at every point into a new array: one launch, on the
        current stream of the plan's device, counted in
        ``fixed_tile_pointwise_counter``."""
        if self.entry is None:
            lib = _build.load(self.name, self.text)
            fn = lib.csi_pointwise_unit
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.csi_cuda_error_string
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self.entry = (fn, err, ctypes.addressof(self.k_arr), ctypes.addressof(self.p_arr))
        fn, err_string, k_addr, p_addr = self.entry
        p = self.p_arr
        for i, t in enumerate(arrays):
            p[i] = t.data_ptr()
        for i, t in enumerate(scalars, len(arrays)):
            p[i] = t.data_ptr()
        out = torch.empty(self.shape, dtype=torch.float32, device=self.device)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = fn(k_addr, len(self.k), p_addr, len(self.tensors), out.data_ptr(),
                     self.numel, stream)
        if err != 0:
            why = err_string(err).decode() if err > 0 else "arguments the unit cannot take"
            raise RuntimeError(f"fixed-tile pointwise unit {self.name} launch failed: error "
                               f"{err} ({why})")
        fixed_tile_pointwise_counter.calls += 1
        fixed_tile_pointwise_counter.launches += 1
        return out


_plans = weakref.WeakKeyDictionary()


def plan(fn, n_arrays, n_scalars, device, shape) -> _Plan:
    """The :class:`_Plan` of ``fn`` with ``n_arrays`` arrays of ``shape`` and
    ``n_scalars`` scalars on ``device``, made at its first call and kept per
    callable (made anew every call for a callable that is not weakly
    referable)."""
    device = torch.device(device)
    key = (n_arrays, n_scalars, str(device), tuple(shape))
    try:
        per_fn = _plans.setdefault(fn, {})
    except TypeError:
        return _Plan(fn, n_arrays, n_scalars, device, tuple(shape))
    if key not in per_fn:
        per_fn[key] = _Plan(fn, n_arrays, n_scalars, device, tuple(shape))
    return per_fn[key]


def fixed_tile_pointwise(fn, fixed, arrays, scalars=()):
    """Evaluate the elementwise callable ``fn(*arrays, *scalars)`` (the
    contract of `pallas_pointwise.py:28`): ``arrays`` are same-shape arrays
    taken as float32, ``scalars`` numbers or 0-d tensors taken as float32,
    ``fixed = (TX, TY)`` the pinned tiles of the mode (the kernel's
    per-point arithmetic depends on neither).  Returns a new float32 array of
    the arrays' shape.  CUDA tensors go to the callable's generated unit (one
    launch), CPU tensors to :func:`fixed_tile_pointwise_reference`; on both
    devices the callable's plan is made first, so that an operation outside
    the op set raises NotImplementedError."""
    _check_fixed(fixed)
    arrays = [torch.as_tensor(a) for a in arrays]
    if not arrays:
        raise ValueError("fixed_tile_pointwise needs at least one array")
    device, shape = arrays[0].device, tuple(arrays[0].shape)
    if any(a.device != device or tuple(a.shape) != shape for a in arrays):
        raise ValueError("fixed_tile_pointwise arrays must share one shape and device")
    arrays = [a.to(torch.float32).contiguous() for a in arrays]
    scalars = [_scalar_tensor(s, device) for s in scalars]
    p = plan(fn, len(arrays), len(scalars), device, shape)
    if device.type == "cpu":
        return fixed_tile_pointwise_reference(fn, arrays, scalars)
    if device.type != "cuda":
        raise ValueError(f"no pointwise kernel for device {device}")
    return p.launch(arrays, scalars)
