"""Straight-line CUDA code from recorded programs: the flux programs of the
fixed-tile column thermodynamics (kernel 2.11) and the elementwise callables
of the fixed-tile pointwise kernel (2.10).

A pointwise program (:mod:`.fixed_tile_pointwise`) becomes one function that
computes its SSA values in the program's order at a point, and a kernel that
calls it at every point (:func:`pointwise_unit_source`).

The column kernel evaluates its top heat flux at every iterate of the
surface-temperature secant, 22 times a point.  A flux is a postfix program
(:mod:`.fixed_tile_pointwise`'s op codes, bound by
:mod:`..thermodynamics.fixed_tile_thermo`).  Here each program becomes a list
of SSA values in the program's own order, and each value is marked
*T-dependent* when it is the surface temperature (``OP_TEMP``), radiative
emission (``OP_EMISSION``) or reads a T-dependent value.  The generated
functor computes the T-independent values once per point in ``prologue`` and
the T-dependent ones in ``flux(T)``: every operation of the program is kept,
with its operands, so no sum is reassociated and no constant is folded
across a rounding, and each value has the bits of the program's operation
on its operands (``csrc/pointwise_program.cuh``'s helpers), as the earlier
interpreter of the programs computed them.

:func:`unit_source` writes one CUDA unit for the three programs of a
configuration (top flux, bottom flux, snowfall): the functors, and a C entry
that instantiates ``csrc/thermo_column.cuh``'s column kernel with them.
Constants, pointers and 0-d values stay launch arguments (their indices are
part of the program), so the clock's time and the series values never
change the unit.
"""

from __future__ import annotations

import dataclasses

from . import fixed_tile_pointwise as _fp
from .fixed_tile_pointwise import (OP_CONST, OP_ARRAY, OP_SCALAR, OP_EMISSION, OP_TEMP,
                                   OP_LOAD, OP_STORE, OP_DIVC, OP_CLAMP, OP_WHERE, _BINARY,
                                   _UNARY)

_LEAVES = (OP_CONST, OP_ARRAY, OP_SCALAR, OP_TEMP, OP_EMISSION)
# op code → its name in csrc/pointwise_program.cuh's enum Op (the same names)
_C_NAME = {v: k for k, v in vars(_fp).items() if k.startswith("OP_")}
FLUXES = ("Top", "Bottom", "Snow")      # the functors, in the column kernel's order


@dataclasses.dataclass(frozen=True)
class Value:
    """One SSA value: the program's operation ``op`` with its immediate
    ``a``, ``b`` (constant or pointer indices, as in the program's triple)
    on the values ``args``; ``t_dep`` where it depends on the surface
    temperature."""
    op: int
    a: int
    b: int
    args: tuple
    t_dep: bool


def ssa(ops) -> list[Value]:
    """The SSA values of a postfix program of ``(op, a, b)`` triples, in the
    program's order; registers (``OP_LOAD``/``OP_STORE``) become references to
    the stored value.  The last value is the program's result."""
    values, stack, regs = [], [], {}

    def push(op, a, b, args):
        t_dep = op in (OP_TEMP, OP_EMISSION) or any(values[i].t_dep for i in args)
        values.append(Value(op, a, b, tuple(args), t_dep))
        stack.append(len(values) - 1)

    for op, a, b in ops:
        if op == OP_STORE:
            regs[a] = stack[-1]
        elif op == OP_LOAD:
            stack.append(regs[a])
        elif op in _LEAVES:
            push(op, a, b, ())
        elif op == OP_WHERE:
            y, x, c = stack.pop(), stack.pop(), stack.pop()
            push(op, a, b, (c, x, y))
        elif op in _UNARY.values() or op in (OP_DIVC, OP_CLAMP):
            push(op, a, b, (stack.pop(),))
        elif op in _BINARY.values():
            y, x = stack.pop(), stack.pop()
            push(op, a, b, (x, y))
        else:
            raise ValueError(f"unknown program operation {op}")
    if stack != [len(values) - 1]:
        raise ValueError("a flux program must leave one value, its last operation's")
    return values


def hoisted(values) -> list[int]:
    """The T-independent values that ``flux(T)`` reads, computed once per
    point by ``prologue``: those a T-dependent value takes as an operand, and
    the result where it does not depend on T.  Constants are read where they
    are used."""
    read = {i for v in values if v.t_dep for i in v.args}
    read.add(len(values) - 1)
    return sorted(i for i in read if not values[i].t_dep and values[i].op != OP_CONST)


def _expr(v, name):
    """The C++ expression of value ``v`` whose operands are named by ``name``."""
    x = [name(i) for i in v.args]
    if v.op == OP_CONST:
        return f"A.k[{v.a}]"
    if v.op == OP_ARRAY:
        return f"A.p[{v.a}][pt]"
    if v.op == OP_SCALAR:
        return f"A.p[{v.a}][0]"
    if v.op == OP_TEMP:
        return "T"
    if v.op == OP_EMISSION:
        return f"A.k[{v.a}] * powf(T + A.k[{v.b}], 4.0f)"
    if v.op == OP_DIVC:
        return f"{x[0]} * (1.0f / A.k[{v.a}])"
    if v.op == OP_CLAMP:
        lo = "true" if v.a >= 0 else "false"
        hi = "true" if v.b >= 0 else "false"
        return (f"clamp({x[0]}, {lo}, A.k[{max(v.a, 0)}], {hi}, A.k[{max(v.b, 0)}])")
    if v.op == OP_WHERE:
        return f"{x[0]} != 0.0f ? {x[1]} : {x[2]}"
    if v.op in _UNARY.values():
        return f"unary({_C_NAME[v.op]}, {x[0]})"
    return f"binary({_C_NAME[v.op]}, {x[0]}, {x[1]})"


def functor_source(struct, values) -> str:
    """A functor ``struct`` of the column kernel: ``prologue(A, pt)`` keeps
    the hoisted values, ``flux(A, T)`` returns the program's value at T."""
    keep = hoisted(values)

    def local(j):          # an operand in prologue: a constant where it is used
        return _expr(values[j], None) if values[j].op == OP_CONST else f"v{j}"

    def operand(j):        # an operand in flux: a hoisted value as its member
        if values[j].t_dep or values[j].op == OP_CONST:
            return local(j)
        return f"h{j}"

    pro = [f"    const float v{i} = {_expr(v, local)};\n" for i, v in enumerate(values)
           if not v.t_dep and v.op != OP_CONST]
    pro += [f"    h{i} = v{i};\n" for i in keep]
    flux = [f"    const float v{i} = {_expr(v, operand)};\n" for i, v in enumerate(values)
            if v.t_dep]
    flux.append(f"    return {operand(len(values) - 1)};\n")
    members = "".join(f"  float h{i};\n" for i in keep)
    return (f"struct {struct} {{\n{members}"
            "  __device__ __forceinline__ void prologue(const Args& A, int pt) {\n"
            f"{''.join(pro)}  }}\n"
            "  __device__ __forceinline__ float flux(const Args& A, float T) const {\n"
            f"{''.join(flux)}  }}\n}};\n")


def unit_source(programs) -> str:
    """The CUDA unit of a configuration's (top, bottom, snowfall) flux
    programs: three functors and the C entry ``csi_thermo_unit``."""
    functors = "\n".join(functor_source(name, ssa(ops)) for name, ops in zip(FLUXES, programs))
    return ("// Generated by climaseaice_jl_tpu_torch/dynamics/fixed_tile_codegen.py from the\n"
            "// flux programs of one configuration; built by _build.py.\n"
            '#include "thermo_column.cuh"\n\n'
            "namespace {\n\nusing namespace csi_prog;\nusing csi_thermo::Args;\n\n"
            f"{functors}\n}}  // namespace\n\n"
            'extern "C" int csi_thermo_unit(const int* ints, int n_ints, const float* consts,\n'
            "                               int n_k, const void* const* ptrs, int n_p,\n"
            "                               float* out, void* stream) {\n"
            f"  return csi_thermo::launch<{', '.join(FLUXES)}>(ints, n_ints, consts, n_k, ptrs,\n"
            "                                               n_p, out, stream);\n}\n\n"
            'extern "C" const char* csi_cuda_error_string(int code) {\n'
            "  return cudaGetErrorString(static_cast<cudaError_t>(code));\n}\n")


POINTWISE_BLOCK = 256     # threads a block of a pointwise unit


def pointwise_unit_source(ops) -> str:
    """The CUDA unit of a bound pointwise program: ``value(A, pt)`` computes
    its SSA values in order at point ``pt`` (constants read where they are
    used), the kernel ``pointwise_unit`` writes it at one point a thread, a
    block's points contiguous and its threads' loads coalesced, and the C
    entry ``csi_pointwise_unit`` launches it.  A program with the column
    kernel's surface temperature or emission is refused."""
    values = ssa(ops)
    if any(v.op in (OP_TEMP, OP_EMISSION) for v in values):
        raise ValueError("a pointwise program reads no surface temperature or emission")

    def name(j):
        return _expr(values[j], name) if values[j].op == OP_CONST else f"v{j}"

    body = "".join(f"  const float v{i} = {_expr(v, name)};\n" for i, v in enumerate(values)
                   if v.op != OP_CONST)
    return ("// Generated by climaseaice_jl_tpu_torch/dynamics/fixed_tile_codegen.py from the\n"
            "// recorded program of one elementwise callable; built by _build.py.\n"
            '#include "pointwise_program.cuh"\n\n'
            "namespace {\n\nusing namespace csi_prog;\n\n"
            f"constexpr int MAX_K = {_fp.MAX_K}, MAX_PTRS = {_fp.MAX_PTRS}, "
            f"BLOCK = {POINTWISE_BLOCK};\n\n"
            "struct Args {\n  float k[MAX_K];\n  const float* p[MAX_PTRS];\n};\n\n"
            "__device__ __forceinline__ float value(const Args& A, long long pt) {\n"
            f"{body}  return {name(len(values) - 1)};\n}}\n\n"
            "__global__ void __launch_bounds__(BLOCK) pointwise_unit(const __grid_constant__ Args A,\n"
            "                                                      float* __restrict__ out,\n"
            "                                                      long long n) {\n"
            "  const long long pt = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;\n"
            "  if (pt < n) out[pt] = value(A, pt);\n}\n\n}  // namespace\n\n"
            "// The program at each of the n points into `out` on `stream`, one point a\n"
            "// thread; `consts` and `ptrs` are host arrays of its constants and device\n"
            "// pointers.  Returns 0, a CUDA error, or -1 for arguments it cannot take.\n"
            'extern "C" int csi_pointwise_unit(const float* consts, int n_k, const void* const* ptrs,\n'
            "                                  int n_p, float* out, long long n, void* stream) {\n"
            "  if (n_k > MAX_K || n_p > MAX_PTRS) return -1;\n"
            "  Args A{};\n"
            "  for (int q = 0; q < n_k; ++q) A.k[q] = consts[q];\n"
            "  for (int q = 0; q < n_p; ++q) A.p[q] = static_cast<const float*>(ptrs[q]);\n"
            "  if (n <= 0) return 0;\n"
            "  const unsigned blocks = static_cast<unsigned>((n + BLOCK - 1) / BLOCK);\n"
            "  pointwise_unit<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(A, out, n);\n"
            "  return static_cast<int>(cudaGetLastError());\n}\n\n"
            'extern "C" const char* csi_cuda_error_string(int code) {\n'
            "  return cudaGetErrorString(static_cast<cudaError_t>(code));\n}\n")
