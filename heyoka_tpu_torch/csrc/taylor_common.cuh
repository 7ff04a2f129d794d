// Device helpers shared by the jet kernels (taylor_jet.cu: B1, B2;
// taylor_jet_rolled.cu: B3; taylor_phase.cu: B4; proto_phase.cu: T2): the
// opcodes of convert.OPCODES, the dense tape tables of B1/B2/B4/T2, and
// the order-0 rules that are more than one operation.

#pragma once

#include <math.h>
#include <stddef.h>

namespace {

// convert.OPCODES: B1/B2/B3 know the first five, B4 all of them (the
// dense series, OP_SERIES, by copying the rows kernel S1 made)
enum Op {
  OP_SUM, OP_MUL, OP_DIV, OP_SQRT, OP_POW,
  OP_EXP, OP_LOG, OP_SIN, OP_COS, OP_SINH, OP_COSH, OP_TAN, OP_TANH,
  OP_SIGMOID, OP_ASIN, OP_ACOS, OP_ATAN, OP_ATANH, OP_ASINH, OP_ACOSH,
  OP_ERF, OP_ATAN2, OP_KEPE, OP_KEPF, OP_KEPDE, OP_RELU, OP_RELUP,
  OP_SELECT, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE, OP_LAND, OP_LOR,
  OP_LNOT, OP_SERIES
};

// header of the int32 table `it` of kernels B1, B2, B4 and T2
// (taylor/jet_kernels.py _HDR, then taylor/jet_phase.py _PHDR's fields,
// which only B4 and T2 read): sizes, then offsets of the int sub-tables in
// `it` and of the f64 ones in `dt`; H_NOUT and H_OUTC, the sv-func
// columns (the event equations) whose rows B2 writes after the state's,
// which only B2's epilogue reads (not part of Tape, so that the passes'
// code does not change)
enum Hdr {
  H_W, H_NEQ, H_K, H_TIME, H_NG, H_NC, H_NPC, H_NNORM,
  H_RHS, H_NORM, H_CCOLS, H_PCOLS, H_PIDX, H_GOP, H_GSTART, H_GM,
  H_ARGPTR, H_ARGS, H_D_RHOFAC, H_D_CVALS, H_D_ALPHA, H_NOUT, H_OUTC,
  H_LVL, H_COP, H_SYNC, H_AUX, H_SYN, H_NSYN, H_NLV
};

struct Tape {
  int W, n_eq, K, time_col, n_groups, n_const, n_pcol, n_norm;
  const int *rhs, *norm, *ccols, *pcols, *pidx, *gop, *gstart, *gm,
      *argptr, *args;
  const double *cvals, *alpha;
  double rhofac;
};

__device__ Tape load_tape(const int* __restrict__ it,
                          const double* __restrict__ dt) {
  Tape T;
  T.W = it[H_W];
  T.n_eq = it[H_NEQ];
  T.K = it[H_K];
  T.time_col = it[H_TIME];
  T.n_groups = it[H_NG];
  T.n_const = it[H_NC];
  T.n_pcol = it[H_NPC];
  T.n_norm = it[H_NNORM];
  T.rhs = it + it[H_RHS];
  T.norm = it + it[H_NORM];
  T.ccols = it + it[H_CCOLS];
  T.pcols = it + it[H_PCOLS];
  T.pidx = it + it[H_PIDX];
  T.gop = it + it[H_GOP];
  T.gstart = it + it[H_GSTART];
  T.gm = it + it[H_GM];
  T.argptr = it + it[H_ARGPTR];
  T.args = it + it[H_ARGS];
  T.rhofac = dt[it[H_D_RHOFAC]];
  T.cvals = dt + it[H_D_CVALS];
  T.alpha = dt + it[H_D_ALPHA];
  return T;
}

// min / max that propagate NaN, like torch.minimum / torch.maximum
__device__ inline double nmin(double a, double b) {
  return (a < b || isnan(a)) ? a : b;
}
__device__ inline double nmax(double a, double b) {
  return (a > b || isnan(a)) ? a : b;
}

// order-0 power with the JAX package's special cases (jet.py _pow0)
__device__ double pow0(double b, double a) {
  if (a == -1.0) return 1.0 / b;
  if (a == 0.5) return sqrt(b);
  if (a == -0.5) return 1.0 / sqrt(b);
  if (a == -1.5) {
    const double r = 1.0 / sqrt(b);
    return r * r * r;
  }
  if (a == 1.5) return b * sqrt(b);
  if (a == floor(a) && fabs(a) <= 512.0) {
    int n = (int)a;
    double x = n > 0 ? b : 1.0 / b;
    n = n < 0 ? -n : n;
    if (n == 0) return 1.0;
    double r = 0.0;
    bool have = false;
    while (n) {
      if (n & 1) {
        r = have ? r * x : x;
        have = true;
      }
      n >>= 1;
      if (n) x = x * x;
    }
    return r;
  }
  return pow(b, a);
}

}  // namespace
