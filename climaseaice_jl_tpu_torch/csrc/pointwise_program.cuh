// Per-point evaluation of the postfix programs that
// dynamics/fixed_tile_pointwise.py records from elementwise callables, shared
// by pointwise_fixed.cu (kernel 2.10) and thermo_fixed.cu (the flux
// programs of kernel 2.11).
//
// A program is a list of (op, a, b): constants k[a], arrays p[a][point],
// 0-d values p[a][0], the argument T (the surface temperature of a flux),
// radiative emission k[a]·(T + k[b])⁴, registers (STORE keeps the top of the
// stack, LOAD pushes it again), and the float32 operations PyTorch computes
// on the card, in its forms: x / c for a Python number c is x·(1/c) (DIVC),
// remainder is fmod with the sign of the divisor, clamp and minimum/maximum
// pass NaN through, a comparison gives 1 or 0, where selects on a nonzero
// condition.  Sources that include this header are built with -fmad=false,
// so no multiply and add are contracted across two operations.

#pragma once

#include <cuda_runtime.h>

namespace csi_prog {

enum Op {
  OP_CONST, OP_ARRAY, OP_SCALAR, OP_EMISSION, OP_ADD, OP_TEMP, OP_LOAD, OP_STORE,
  OP_SUB, OP_MUL, OP_DIV, OP_DIVC, OP_REM, OP_MIN, OP_MAX, OP_LT, OP_LE, OP_GT, OP_GE,
  OP_EQ, OP_NE, OP_AND, OP_OR, OP_NEG, OP_RECIP, OP_SIN, OP_COS, OP_EXP, OP_SQRT, OP_ABS,
  OP_NOT, OP_CLAMP, OP_WHERE, N_OPS
};

constexpr int MAX_STACK = 16, MAX_REGS = 24;

template <int MAX_OPS>
struct Prog {
  int n;
  int op[MAX_OPS], a[MAX_OPS], b[MAX_OPS];
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

// The program's value at `point`, with T for OP_TEMP.
template <int MAX_OPS>
__device__ float run(const Prog<MAX_OPS>& g, const float* k, const float* const* p,
                     long long point, float T) {
  float st[MAX_STACK];
  float reg[MAX_REGS];
  int top = 0;
  for (int q = 0; q < g.n; ++q) {
    const int op = g.op[q], a = g.a[q], b = g.b[q];
    switch (op) {
      case OP_CONST: st[top++] = k[a]; break;
      case OP_ARRAY: st[top++] = p[a][point]; break;
      case OP_SCALAR: st[top++] = p[a][0]; break;
      case OP_TEMP: st[top++] = T; break;
      case OP_EMISSION: st[top++] = k[a] * powf(T + k[b], 4.0f); break;
      case OP_LOAD: st[top++] = reg[a]; break;
      case OP_STORE: reg[a] = st[top - 1]; break;
      case OP_DIVC: st[top - 1] = st[top - 1] * (1.0f / k[a]); break;
      case OP_CLAMP: {          // torch.clamp with number bounds
        float v = st[top - 1];
        if (v == v) {
          if (a >= 0) v = fmaxf(v, k[a]);
          if (b >= 0) v = fminf(v, k[b]);
        }
        st[top - 1] = v;
        break;
      }
      case OP_WHERE: {
        const float y = st[--top];
        const float x = st[--top];
        st[top - 1] = st[top - 1] != 0.0f ? x : y;
        break;
      }
      default:
        if (op >= OP_NEG) {
          st[top - 1] = unary(op, st[top - 1]);
        } else {
          const float y = st[--top];
          st[top - 1] = binary(op, st[top - 1], y);
        }
    }
  }
  return st[0];
}

// Reads a program from `ints` at `at` (count, then (op, a, b) triples);
// returns -1 where it does not fit or names an unknown operation.
template <int MAX_OPS>
int read_prog(const int* ints, int n_ints, int& at, Prog<MAX_OPS>& g) {
  if (at >= n_ints) return -1;
  g.n = ints[at++];
  if (g.n < 1 || g.n > MAX_OPS || at + 3 * g.n > n_ints) return -1;
  for (int q = 0; q < g.n; ++q) {
    g.op[q] = ints[at++];
    g.a[q] = ints[at++];
    g.b[q] = ints[at++];
    if (g.op[q] < 0 || g.op[q] >= N_OPS) return -1;
    if ((g.op[q] == OP_LOAD || g.op[q] == OP_STORE) && (g.a[q] < 0 || g.a[q] >= MAX_REGS))
      return -1;
  }
  return 0;
}

}  // namespace csi_prog
