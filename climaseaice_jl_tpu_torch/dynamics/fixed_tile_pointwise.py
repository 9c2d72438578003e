"""Fixed-tile pointwise evaluation of an elementwise callable: the recorder
that turns the callable into a program, the CUDA kernel's wrapper and its
plain version.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_pointwise.py:
fixed_tile_pointwise`, which re-traces any elementwise callable of arrays
and scalars inside a Pallas kernel on pinned (TX, TY) tiles, so that every
decomposition computes the same bits at a point (its caller is the basin's
winds, `validation/run_distributed_basin.py:76-94`).  A Python callable
cannot enter a hand-written CUDA kernel, so here the callable is *recorded*:
it runs once on small placeholder tensors under a
``torch.overrides.TorchFunctionMode`` that notes every operation applied to
them, and the record is compiled into a postfix program (constants, inputs,
operations, and registers for values used more than once).  The CUDA kernel
(``csrc/pointwise_fixed.cu``, one thread per point, one launch per call)
runs that program at every point with a small stack.  A program is recorded
once per callable and kept, as a jitted JAX caller traces its closure once.

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
intermediate.

Each operation is the one PyTorch computes on the card in float32, with its
forms: ``x / c`` for a Python number ``c`` is ``x·(1/c)`` with the
reciprocal rounded to float32, ``c / x`` is ``reciprocal(x)·c``, ``c − x`` is
``rsub``.  Python-number arithmetic inside the callable (``math.cos(φ₀)``)
happens in double and meets the tensors as one float32 constant.

:func:`fixed_tile_pointwise` picks by the tensors' device: CUDA tensors go to
the kernel, CPU tensors to :func:`fixed_tile_pointwise_reference`, which is
the callable called eagerly on the arrays.  A CUDA tensor never reaches the
plain version; a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .. import _build
from .fused_evp import KernelCounter, cuda_error_string

# operations (csrc/pointwise_program.cuh, enum Op)
(OP_CONST, OP_ARRAY, OP_SCALAR, OP_EMISSION, OP_ADD, OP_TEMP, OP_LOAD, OP_STORE,
 OP_SUB, OP_MUL, OP_DIV, OP_DIVC, OP_REM, OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE,
 OP_EQ, OP_NE, OP_AND, OP_OR, OP_NEG, OP_RECIP, OP_SIN, OP_COS, OP_EXP, OP_SQRT, OP_ABS,
 OP_NOT, OP_CLAMP, OP_WHERE) = range(33)
MAX_STACK, MAX_REGS = 16, 24            # the kernels' per-thread stack and registers
MAX_OPS, MAX_K, MAX_PTRS = 192, 64, 16  # csrc/pointwise_fixed.cu's limits

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
    n_regs: int
    depth: int

    def bind(self, const, slot, pointer, reg_base=0):
        """The kernel's (op, a, b) triples: ``const(value)`` gives a constant's
        index, ``slot(s)`` an input's (op, a), ``pointer(t)`` a captured
        tensor's pointer index; registers start at ``reg_base``."""
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
                out.append((op, a + reg_base, 0))
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
        depth = top = 0
        for op, _, _ in ops:
            if op in (OP_CONST, OP_ARRAY, OP_SCALAR, OP_TEMP, OP_LOAD, OP_EMISSION):
                top += 1
            elif op == OP_WHERE:
                top -= 2
            elif op in _BINARY.values():
                top -= 1
            depth = max(depth, top)
        if top != 1:
            raise AssertionError("fixed-tile program does not leave one value")
        if depth > MAX_STACK or len(regs) > MAX_REGS:
            raise NotImplementedError(f"a fixed-tile program needs a stack of {depth} and "
                                      f"{len(regs)} registers (the kernels have {MAX_STACK} "
                                      f"and {MAX_REGS})")
        return Recording(ops=ops, slots=list(self.slots), captured=list(self.captured),
                         n_regs=len(regs), depth=depth)


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

def _pointwise_entry():
    fn = _build.load("pointwise_fixed").csi_pointwise_fixed
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fixed_tile_pointwise(fn, fixed, arrays, scalars=()):
    """Evaluate the elementwise callable ``fn(*arrays, *scalars)`` (the
    contract of `pallas_pointwise.py:28`): ``arrays`` are same-shape arrays
    taken as float32, ``scalars`` numbers or 0-d tensors taken as float32,
    ``fixed = (TX, TY)`` the pinned tiles of the mode (the kernel's
    per-point arithmetic depends on neither).  Returns a new float32 array of
    the arrays' shape.  CUDA tensors go to the kernel (one launch), CPU
    tensors to :func:`fixed_tile_pointwise_reference`; on both devices ``fn``
    is recorded first, so that an operation outside the op set raises
    NotImplementedError."""
    _check_fixed(fixed)
    arrays = [torch.as_tensor(a) for a in arrays]
    if not arrays:
        raise ValueError("fixed_tile_pointwise needs at least one array")
    device, shape = arrays[0].device, tuple(arrays[0].shape)
    if any(a.device != device or tuple(a.shape) != shape for a in arrays):
        raise ValueError("fixed_tile_pointwise arrays must share one shape and device")
    arrays = [a.to(torch.float32) for a in arrays]
    scalars = [_scalar_tensor(s, device) for s in scalars]
    rec = pointwise_recording(fn, len(arrays), len(scalars), device)
    if device.type == "cpu":
        return fixed_tile_pointwise_reference(fn, arrays, scalars)
    if device.type != "cuda":
        raise ValueError(f"no pointwise kernel for device {device}")
    consts, ptrs, keep = [], [], []

    def const(value):
        consts.append(value)
        return len(consts) - 1

    def pointer(t):
        keep.append(t)
        ptrs.append(t.data_ptr())
        return len(ptrs) - 1

    inputs = {("array", i): (OP_ARRAY, pointer(a.contiguous())) for i, a in enumerate(arrays)}
    inputs.update({("scalar", i): (OP_SCALAR, pointer(s)) for i, s in enumerate(scalars)})
    ops = rec.bind(const, inputs.__getitem__, pointer)
    if len(ops) > MAX_OPS or len(consts) > MAX_K or len(ptrs) > MAX_PTRS:
        raise NotImplementedError(f"a pointwise program of {len(ops)} operations, "
                                  f"{len(consts)} constants and {len(ptrs)} inputs (the "
                                  f"kernel takes {MAX_OPS}, {MAX_K} and {MAX_PTRS})")
    ints = [len(ops)] + [x for op in ops for x in op]
    out = torch.empty(shape, dtype=torch.float32, device=device)
    i_arr = (ctypes.c_int * len(ints))(*ints)
    k_arr = (ctypes.c_float * max(len(consts), 1))(*consts)
    p_arr = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
    entry = _pointwise_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(ctypes.addressof(i_arr), len(ints), ctypes.addressof(k_arr), len(consts),
                    ctypes.addressof(p_arr), len(ptrs), out.data_ptr(), out.numel(), stream)
    if err != 0:
        raise RuntimeError(f"fixed-tile pointwise kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('pointwise_fixed', err)})")
    fixed_tile_pointwise_counter.calls += 1
    fixed_tile_pointwise_counter.launches += 1
    return out
