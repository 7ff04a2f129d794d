// Device helpers shared by the jet kernels (taylor_jet.cu: B1, B2;
// taylor_jet_rolled.cu: B3): the opcodes of convert.OPCODES and the
// order-0 rules that are more than one operation.

#pragma once

#include <math.h>

namespace {

enum Op { OP_SUM = 0, OP_MUL = 1, OP_DIV = 2, OP_SQRT = 3, OP_POW = 4 };

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
