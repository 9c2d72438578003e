// Per-point operations of the programs that dynamics/fixed_tile_pointwise.py
// records from elementwise callables: the helpers that the units generated
// by dynamics/fixed_tile_codegen.py call with constant op codes, for the
// pointwise units of kernel 2.10 and the flux functors of the column kernel
// 2.11 (thermo_column.cuh).
//
// The operations are the float32 ones PyTorch computes on the card, in its
// forms: x / c for a Python number c is x·(1/c) (OP_DIVC, written out by the
// generator), remainder is fmod with the sign of the divisor, clamp and
// minimum/maximum pass NaN through, a comparison gives 1 or 0, where selects
// on a nonzero condition.  Sources that include this header are built with
// -fmad=false, so no multiply and add are contracted across two operations.

#pragma once

#include <cuda_runtime.h>

namespace csi_prog {

enum Op {
  OP_CONST, OP_ARRAY, OP_SCALAR, OP_EMISSION, OP_ADD, OP_TEMP, OP_LOAD, OP_STORE,
  OP_SUB, OP_MUL, OP_DIV, OP_DIVC, OP_REM, OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE,
  OP_EQ, OP_NE, OP_AND, OP_OR, OP_NEG, OP_RECIP, OP_SIN, OP_COS, OP_EXP, OP_SQRT, OP_ABS,
  OP_NOT, OP_CLAMP, OP_WHERE, N_OPS
};

__device__ __forceinline__ float binary(int op, float x, float y) {
  switch (op) {
    case OP_ADD: return x + y;
    case OP_SUB: return x - y;
    case OP_MUL: return x * y;
    case OP_DIV: return x / y;
    case OP_REM: {            // torch.remainder: fmod, moved to the divisor's sign
      float m = fmodf(x, y);
      if (m != 0.0f && ((y < 0.0f) != (m < 0.0f))) m += y;
      return m;
    }
    case OP_MIN: return x != x ? x : (y != y ? y : fminf(x, y));
    case OP_MAX: return x != x ? x : (y != y ? y : fmaxf(x, y));
    case OP_LT: return x < y ? 1.0f : 0.0f;
    case OP_LE: return x <= y ? 1.0f : 0.0f;
    case OP_GT: return x > y ? 1.0f : 0.0f;
    case OP_GE: return x >= y ? 1.0f : 0.0f;
    case OP_EQ: return x == y ? 1.0f : 0.0f;
    case OP_NE: return x != y ? 1.0f : 0.0f;
    case OP_AND: return (x != 0.0f && y != 0.0f) ? 1.0f : 0.0f;
    default: return (x != 0.0f || y != 0.0f) ? 1.0f : 0.0f;   // OP_OR
  }
}

__device__ __forceinline__ float unary(int op, float x) {
  switch (op) {
    case OP_NEG: return -x;
    case OP_RECIP: return 1.0f / x;
    case OP_SIN: return sinf(x);
    case OP_COS: return cosf(x);
    case OP_EXP: return expf(x);
    case OP_SQRT: return sqrtf(x);
    case OP_ABS: return fabsf(x);
    default: return x != 0.0f ? 0.0f : 1.0f;                  // OP_NOT
  }
}

// torch.clamp with number bounds (either may be absent): NaN passes through
__device__ __forceinline__ float clamp(float v, bool has_lo, float lo, bool has_hi, float hi) {
  if (v == v) {
    if (has_lo) v = fmaxf(v, lo);
    if (has_hi) v = fminf(v, hi);
  }
  return v;
}

}  // namespace csi_prog
