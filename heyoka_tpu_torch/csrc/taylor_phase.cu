// The phase jet (kernel B4): Taylor orders lo..K of every column of a
// tape plan, in place, over the whole recurrence rule set, in f64, for
// NVIDIA Hopper (sm_90a).
//
// Replaces make_phase_kernel (heyoka_tpu/taylor/pallas_phase.py:899),
// whose rules are _rule (:633) and _synth_w (:206).  The TPU kernel runs
// orders mp_order+1..K in f32 on an aliased (W, K+1, B) VMEM block after
// an f64 order 0 in XLA; the H100 has f64, so here one run from lo = 1
// gives the whole jet in f64, and the f32 phase and its scaling have no
// counterpart.
//
// Design: one thread runs one lane and interprets the tables built by
// heyoka_tpu_torch/convert.py and packed by taylor/jet_phase.py (header
// `enum Hdr` in taylor_common.cuh), as kernel B2 does; 64 threads per
// block.  The coefficient buffer is (K+1, W, B) f64 in global memory with
// the lane index minor, written by the caller at order 0 and for the
// virtual columns (literals, parameters, time), which the kernel never
// writes.  The Kepler ops' synthetic series (kepE q = e cos E, kepF
// w = h sin F + k cos F, kepDE w = s0 sin DE - c0 cos DE) live in a
// (K+1, n_syn, B) scratch buffer that the wrapper allocates: filled for
// the orders below lo first, then once per order, as the TPU kernel keeps
// hist[(gi, "synth")].
//
// Order of operations, as in the plain twin (jet_phase.phase_plain): per
// order k, the state rows from the right-hand sides at k-1 over k, then
// the groups in level order, then the synthetic rows.  Every rule reads
// aux columns (the sin/cos pair, tan's square, the Kepler sin/cos, which
// come after their op in the tape) and synthetic rows below order k only.
// Each rule forms its products and partial sums as the twin does; only
// the order inside a sum may differ.  Built with -fmad=false like the
// other kernels.
//
// What bounds it on this card: for small tapes such as the pendulum (a
// handful of columns) the launch and the one-thread-per-lane latency of
// the order loops; for wide tapes the global-memory traffic of the
// convolutions, as for B2.  The design does nothing about either yet
// (no row sharing as in B3, no shared-memory staging); a later change
// measures and attacks them.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "taylor_common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr double kPi = 3.141592653589793;

// A lane's view of the (K+1, n_syn, B) synthetic series.
struct Syn {
  double* s;
  size_t n, B;
  int lane;
  __device__ double& at(int k, int r) const {
    return s[((size_t)k * n + (size_t)r) * B + (size_t)lane];
  }
};

// Order j of the synthetic series of Kepler column o (operands a, aux
// columns x = [sin, cos]).
__device__ double synth(const Lane& L, int op, const int* a, const int* x,
                        int j) {
  double s1 = 0.0, s2 = 0.0;
  if (op == OP_KEPE) {
    for (int i = 0; i <= j; ++i) s1 += L.at(i, a[0]) * L.at(j - i, x[1]);
    return s1;
  }
  for (int i = 0; i <= j; ++i) s1 += L.at(i, a[0]) * L.at(j - i, x[0]);
  for (int i = 0; i <= j; ++i) s2 += L.at(i, a[1]) * L.at(j - i, x[1]);
  return op == OP_KEPF ? s1 + s2 : s1 - s2;
}

__device__ void synth_all(const Tape& T, const int* aux, const int* syn,
                          const Lane& L, const Syn& S, int j) {
  for (int g = 0; g < T.n_groups; ++g) {
    const int op = T.gop[g];
    if (op != OP_KEPE && op != OP_KEPF && op != OP_KEPDE) continue;
    for (int r = 0; r < T.gm[g]; ++r) {
      const int o = T.gstart[g] + r - T.n_eq;
      S.at(j, syn[o]) = synth(L, op, T.args + T.argptr[o], aux + 2 * o, j);
    }
  }
}

// sum_{j=j0..j1} (j a_j) b_{k-j}
__device__ double conv_up(const Lane& L, int a, int b, int k, int j0,
                          int j1) {
  double s = 0.0;
  for (int j = j0; j <= j1; ++j) s += ((double)j * L.at(j, a)) * L.at(k - j, b);
  return s;
}

// sum_{m=m0..k-1} ((k-m) a_m) b_{k-m}
__device__ double conv_dn(const Lane& L, int a, int b, int k, int m0) {
  double s = 0.0;
  for (int m = m0; m < k; ++m)
    s += ((double)(k - m) * L.at(m, a)) * L.at(k - m, b);
  return s;
}

// sum_{m=1..k-1} ((k-m) q_m) f_{k-m}, q a synthetic row, f column c
__device__ double conv_syn(const Lane& L, const Syn& S, int row, int c,
                           int k) {
  double s = 0.0;
  for (int m = 1; m < k; ++m)
    s += ((double)(k - m) * S.at(m, row)) * L.at(k - m, c);
  return s;
}

// Order k (>= 1) of op column c = n_eq + o (pallas_phase._rule in f64).
__device__ double phase_k(const Tape& T, const int* aux, const int* syn,
                          const Lane& L, const Syn& S, int op, int c, int o,
                          int k) {
  const int* a = T.args + T.argptr[o];
  const int na = T.argptr[o + 1] - T.argptr[o];
  const int* x = aux + 2 * o;
  const double kf = (double)k;
  switch (op) {
    case OP_SUM: {
      double v = L.at(k, a[0]);
      for (int q = 1; q < na; ++q) v += L.at(k, a[q]);
      return v;
    }
    case OP_MUL: {  // sum_{j=0..k} a_j b_{k-j}
      double v = 0.0;
      for (int j = 0; j <= k; ++j) v += L.at(j, a[0]) * L.at(k - j, a[1]);
      return v;
    }
    case OP_DIV: {  // (a_k - sum_{j<k} q_j b_{k-j}) / b_0
      double s = 0.0;
      for (int j = 0; j < k; ++j) s += L.at(j, c) * L.at(k - j, a[1]);
      return (L.at(k, a[0]) - s) / L.at(0, a[1]);
    }
    case OP_SQRT: {  // (a_k - sum_{j=1..k-1} q_j q_{k-j}) / (2 q_0)
      double s = 0.0;
      for (int j = 1; j < k; ++j) s += L.at(j, c) * L.at(k - j, c);
      return (L.at(k, a[0]) - s) / (2.0 * L.at(0, c));
    }
    case OP_POW: {  // (sum_{j<k} (alpha (k-j) - j) q_j b_{k-j}) / (k b_0)
      double s1 = 0.0, s2 = 0.0;
      for (int j = 0; j < k; ++j) {
        const double q = L.at(j, c), b = L.at(k - j, a[0]);
        s1 += (q * b) * (double)(k - j);
        s2 += ((double)j * q) * b;
      }
      return (s1 * T.alpha[o] - s2) / (kf * L.at(0, a[0]));
    }
    case OP_EXP:  // (sum_{j=1..k} j b_j e_{k-j}) / k
      return conv_up(L, a[0], c, k, 1, k) / kf;
    case OP_SIN:
    case OP_SINH:
    case OP_COSH:  // (sum_{j=1..k} j b_j p_{k-j}) / k, p the pair
      return conv_up(L, a[0], x[0], k, 1, k) / kf;
    case OP_COS:
      return -(conv_up(L, a[0], x[0], k, 1, k) / kf);
    case OP_LOG:  // (b_k - (sum_{j=1..k-1} j c_j b_{k-j}) / k) / b_0
      return (L.at(k, a[0]) - conv_up(L, c, a[0], k, 1, k - 1) / kf)
             / L.at(0, a[0]);
    case OP_TAN:  // b_k + (sum_{m<k} (k-m) q_m b_{k-m}) / k, q = t^2
      return L.at(k, a[0]) + conv_dn(L, x[0], a[0], k, 0) / kf;
    case OP_TANH:
      return L.at(k, a[0]) - conv_dn(L, x[0], a[0], k, 0) / kf;
    case OP_SIGMOID: {  // (sum_{m<k} (k-m) (s_m - q_m) b_{k-m}) / k
      double s = 0.0;
      for (int m = 0; m < k; ++m)
        s += ((double)(k - m) * (L.at(m, c) - L.at(m, x[0])))
             * L.at(k - m, a[0]);
      return s / kf;
    }
    case OP_ASIN:
    case OP_ACOS:
    case OP_ATAN:
    case OP_ATANH:
    case OP_ASINH:
    case OP_ACOSH: {  // (+-b_k - (sum_{m=1..k-1} (k-m) c_m a_{k-m}) / k) / c_0
      const double bk = L.at(k, a[0]);
      return ((op == OP_ACOS ? -bk : bk) - conv_dn(L, a[1], c, k, 1) / kf)
             / L.at(0, a[1]);
    }
    case OP_ERF:  // (2/sqrt(pi)) (sum_{m<k} (k-m) e_m b_{k-m}) / k
      return (2.0 / sqrt(kPi)) * (conv_dn(L, a[1], a[0], k, 0) / kf);
    case OP_ATAN2: {  // y = a[0], x = a[1], d = a[2] = x^2 + y^2
      double r1 = 0.0, r2 = 0.0, s = 0.0;
      for (int m = 0; m < k; ++m) {
        const double w = (double)(k - m);
        r1 += w * (L.at(m, a[1]) * L.at(k - m, a[0]));
        r2 += w * (L.at(m, a[0]) * L.at(k - m, a[1]));
      }
      for (int m = 1; m < k; ++m)
        s += (double)(k - m) * (L.at(m, a[2]) * L.at(k - m, c));
      return ((r1 - r2) - s) / (kf * L.at(0, a[2]));
    }
    case OP_KEPE: {  // e = a[0], M = a[1]; q = e cos E
      const int row = syn[o];
      const double t1 = kf * L.at(k, a[1]);
      const double t2 = conv_up(L, a[0], x[0], k, 1, k);
      const double t3 = conv_syn(L, S, row, c, k);
      return ((t1 + t2) + t3) / (kf * (1.0 - S.at(0, row)));
    }
    case OP_KEPF: {  // h = a[0], kk = a[1], lam = a[2]; w = h sin + kk cos
      const int row = syn[o];
      const double t1 = kf * L.at(k, a[2]);
      const double t2 = conv_up(L, a[0], x[1], k, 1, k);
      const double t3 = conv_up(L, a[1], x[0], k, 1, k);
      const double t4 = conv_syn(L, S, row, c, k);
      return (((t1 - t2) + t3) + t4) / (kf * (1.0 - S.at(0, row)));
    }
    case OP_KEPDE: {  // s0 = a[0], c0 = a[1], DM = a[2]; w = s0 sin - c0 cos
      const int row = syn[o];
      const double t1 = kf * L.at(k, a[2]);
      const double t2 = (kf * L.at(k, a[0])) * (1.0 - L.at(0, x[1]));
      const double t3 = conv_up(L, a[0], x[1], k, 1, k - 1);
      const double t4 = conv_up(L, a[1], x[0], k, 1, k);
      const double t5 = conv_syn(L, S, row, c, k);
      return ((((t1 - t2) + t3) + t4) - t5) / (kf * (1.0 + S.at(0, row)));
    }
    case OP_RELU:
      return L.at(0, a[0]) > 0.0 ? L.at(k, a[0]) : 0.0;
    case OP_SELECT:
      return L.at(0, a[0]) != 0.0 ? L.at(k, a[1]) : L.at(k, a[2]);
    default:  // relup, the relational and the logical ops
      return 0.0;
  }
}

__global__ void __launch_bounds__(kThreads)
phase_kernel(const int* __restrict__ it, const double* __restrict__ dt,
             double* __restrict__ tc, double* __restrict__ syn_buf, int B,
             int lo) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const Tape T = load_tape(it, dt);
  const int* aux = it + it[H_AUX];
  const int* syn = it + it[H_SYN];
  const Lane L{tc, (size_t)T.W, (size_t)B, lane};
  const Syn S{syn_buf, (size_t)it[H_NSYN], (size_t)B, lane};
  const int n_eq = T.n_eq;
  for (int j = 0; j < lo; ++j) synth_all(T, aux, syn, L, S, j);
  for (int k = lo; k <= T.K; ++k) {
    const double kf = (double)k;
    for (int i = 0; i < n_eq; ++i) L.at(k, i) = L.at(k - 1, T.rhs[i]) / kf;
    for (int g = 0; g < T.n_groups; ++g) {
      const int op = T.gop[g], s = T.gstart[g], m = T.gm[g];
      for (int r = 0; r < m; ++r) {
        const int c = s + r;
        L.at(k, c) = phase_k(T, aux, syn, L, S, op, c, c - n_eq, k);
      }
    }
    if (k < T.K) synth_all(T, aux, syn, L, S, k);
  }
}

}  // namespace

extern "C" int hy_phase_f64(const int* itab, const double* dtab, double* tc,
                            double* syn, int B, int lo, void* stream) {
  phase_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(itab, dtab, tc, syn, B, lo);
  return (int)cudaGetLastError();
}
