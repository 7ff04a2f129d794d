// The phase jet (kernel B4): Taylor orders lo..K of every column of a
// tape plan, in place, over the whole recurrence rule set, in f64
// (hy_phase_f64) or in f32 (hy_phase_f32), for NVIDIA Hopper (sm_90a).
//
// Replaces make_phase_kernel (heyoka_tpu/taylor/pallas_phase.py:899),
// whose rules are _rule (:633) and _synth_w (:206).  The TPU kernel runs
// orders mp_order+1..K in f32 on an aliased (W, K+1, B) VMEM block after
// an f64 order 0 in XLA; the H100 has f64, so here one run from lo = 1
// gives the whole jet in the integrator's precision, and the TPU's
// two-f32 head and its scaling have no counterpart.  The f32 entry is the
// route of every float32 integrator (the JAX package's dtype=float32):
// the same rules, instantiated on float, with the f32 math functions.
//
// Design: the block engine of phase_block.cuh with this file's rules
// (phase_k, synth_j), templated on the scalar F.  A block owns a few
// lanes, stages their rows
// in shared memory (the TPU kernel's (W, K+1, bt) VMEM tile, turned
// lane-minor) and runs one barrier-closed pass per level of the plan, the
// threads sharing out the pass's (row, lane) items; the Kepler ops'
// synthetic series (kepE q = e cos E, kepF w = h sin F + k cos F, kepDE
// w = s0 sin DE - c0 cos DE) stay in shared memory beside the rows, as the
// TPU kernel keeps hist[(gi, "synth")].  taylor/jet_phase.block_shape
// picks the lanes and threads a block from the tape, B and the scalar's
// size, and the global layout (the same passes in place in the caller's
// buffer, 32 lanes a block) where a row of the lanes a block's shared
// memory holds is under a 32-byte sector.
//
// Literals: the tables stay f64 (dtab); the f32 rules round a pow
// exponent to f32 once, where they read it, and so does the twin
// (jet_kernels._eval_k); every other literal reaches the rules through
// the buffer, which the caller seeded in f32.
//
// The data-driven ops, which the JAX package runs outside Pallas (its
// scalar-rule fallback, heyoka_tpu/taylor/compact.py _fallback_rule):
// a dataset interpolant's order k is its lane's slope at u_0, which
// jet_phase.order0 wrote to order 0 of the column's side row, times u_k
// (heyoka_tpu/eop_sw.py:512-521; NaN out of the table stays NaN); its
// slope's is 0 and dayfrac's is u_k (models/dayfrac.py:87).  The f32
// integrator refuses tapes with series or data ops (the side rows are
// f64 data), so only the f64 entry reads them in practice.
//
// Order of operations, as in the plain twin (jet_phase.phase_plain): per
// order k, the state rows from the right-hand sides at k-1 over k, then
// the groups in level order, then the synthetic rows.  Every rule reads
// aux columns (the sin/cos pair, tan's square, the Kepler sin/cos, which
// come after their op in the tape) and synthetic rows below order k only.
// Each rule forms its products and partial sums as the twin does; only
// the order inside a sum may differ.  Each item keeps the expression and
// term order of the one-thread-per-lane kernel this design replaced, so
// the f64 outputs equal its bits (the templating changed no f64
// operation: tools/same_bits.py).  Built with -fmad=false like the other
// kernels.
//
// What bounds it on this card: the latency of a block's chain of passes
// (three an order on the pendulum, each as long as its slowest item: a sum
// of up to k+1 dependent terms and a division) and, for wide tapes, the
// lanes in flight an SM; its bytes bound (each coefficient read and
// written once, 4 B an element in f32) is far below.  The terms and tables
// come from shared memory and a level's items run in parallel: read from
// global memory at stride B after a dependent load of its column index,
// each term would wait on load latency.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "phase_block.cuh"
#include "taylor_common.cuh"

namespace {

constexpr double kPi = 3.141592653589793;

// Order j of the synthetic series of Kepler column o (operands a, aux
// columns x = [sin, cos]).
template <typename F, class LV>
__device__ F synth_j(const LV& L, int op, const int* a, const int* x, int j) {
  F s1 = F(0), s2 = F(0);
  if (op == OP_KEPE) {
    #pragma unroll 4
    for (int i = 0; i <= j; ++i) s1 += L.at(i, a[0]) * L.at(j - i, x[1]);
    return s1;
  }
  #pragma unroll 4
  for (int i = 0; i <= j; ++i) s1 += L.at(i, a[0]) * L.at(j - i, x[0]);
  #pragma unroll 4
  for (int i = 0; i <= j; ++i) s2 += L.at(i, a[1]) * L.at(j - i, x[1]);
  return op == OP_KEPF ? s1 + s2 : s1 - s2;
}

// sum_{j=j0..j1} (j a_j) b_{k-j}
template <typename F, class LV>
__device__ F conv_up(const LV& L, int a, int b, int k, int j0, int j1) {
  F s = F(0);
  #pragma unroll 4
  for (int j = j0; j <= j1; ++j) s += ((F)j * L.at(j, a)) * L.at(k - j, b);
  return s;
}

// sum_{m=m0..k-1} ((k-m) a_m) b_{k-m}
template <typename F, class LV>
__device__ F conv_dn(const LV& L, int a, int b, int k, int m0) {
  F s = F(0);
  #pragma unroll 4
  for (int m = m0; m < k; ++m)
    s += ((F)(k - m) * L.at(m, a)) * L.at(k - m, b);
  return s;
}

// sum_{m=1..k-1} ((k-m) q_m) f_{k-m}, q a synthetic row, f column c
template <typename F, class LV, class SV>
__device__ F conv_syn(const LV& L, const SV& S, int row, int c, int k) {
  F s = F(0);
  #pragma unroll 4
  for (int m = 1; m < k; ++m)
    s += ((F)(k - m) * S.at(m, row)) * L.at(k - m, c);
  return s;
}

// Order k (>= 1) of op column c = n_eq + o (pallas_phase._rule in F).
template <typename F, class LV, class SV, class QV>
__device__ F phase_k(const Tape& T, const int* aux, const int* syn,
                     const LV& L, const SV& S, const QV& Q, int op, int c,
                     int o, int k) {
  const int* a = T.args + T.argptr[o];
  const int na = T.argptr[o + 1] - T.argptr[o];
  const int* x = aux + 2 * o;
  const F kf = (F)k;
  switch (op) {
    case OP_SUM: {
      F v = L.at(k, a[0]);
      #pragma unroll 4
      for (int q = 1; q < na; ++q) v += L.at(k, a[q]);
      return v;
    }
    case OP_MUL: {  // sum_{j=0..k} a_j b_{k-j}
      F v = F(0);
      #pragma unroll 4
      for (int j = 0; j <= k; ++j) v += L.at(j, a[0]) * L.at(k - j, a[1]);
      return v;
    }
    case OP_DIV: {  // (a_k - sum_{j<k} q_j b_{k-j}) / b_0
      F s = F(0);
      #pragma unroll 4
      for (int j = 0; j < k; ++j) s += L.at(j, c) * L.at(k - j, a[1]);
      return (L.at(k, a[0]) - s) / L.at(0, a[1]);
    }
    case OP_SQRT: {  // (a_k - sum_{j=1..k-1} q_j q_{k-j}) / (2 q_0)
      F s = F(0);
      #pragma unroll 4
      for (int j = 1; j < k; ++j) s += L.at(j, c) * L.at(k - j, c);
      return (L.at(k, a[0]) - s) / (F(2) * L.at(0, c));
    }
    case OP_POW: {  // (sum_{j<k} (alpha (k-j) - j) q_j b_{k-j}) / (k b_0)
      F s1 = F(0), s2 = F(0);
      #pragma unroll 4
      for (int j = 0; j < k; ++j) {
        const F q = L.at(j, c), b = L.at(k - j, a[0]);
        s1 += (q * b) * (F)(k - j);
        s2 += ((F)j * q) * b;
      }
      return (s1 * (F)T.alpha[o] - s2) / (kf * L.at(0, a[0]));
    }
    case OP_EXP:  // (sum_{j=1..k} j b_j e_{k-j}) / k
      return conv_up<F>(L, a[0], c, k, 1, k) / kf;
    case OP_SIN:
    case OP_SINH:
    case OP_COSH:  // (sum_{j=1..k} j b_j p_{k-j}) / k, p the pair
      return conv_up<F>(L, a[0], x[0], k, 1, k) / kf;
    case OP_COS:
      return -(conv_up<F>(L, a[0], x[0], k, 1, k) / kf);
    case OP_LOG:  // (b_k - (sum_{j=1..k-1} j c_j b_{k-j}) / k) / b_0
      return (L.at(k, a[0]) - conv_up<F>(L, c, a[0], k, 1, k - 1) / kf)
             / L.at(0, a[0]);
    case OP_TAN:  // b_k + (sum_{m<k} (k-m) q_m b_{k-m}) / k, q = t^2
      return L.at(k, a[0]) + conv_dn<F>(L, x[0], a[0], k, 0) / kf;
    case OP_TANH:
      return L.at(k, a[0]) - conv_dn<F>(L, x[0], a[0], k, 0) / kf;
    case OP_SIGMOID: {  // (sum_{m<k} (k-m) (s_m - q_m) b_{k-m}) / k
      F s = F(0);
      #pragma unroll 4
      for (int m = 0; m < k; ++m)
        s += ((F)(k - m) * (L.at(m, c) - L.at(m, x[0])))
             * L.at(k - m, a[0]);
      return s / kf;
    }
    case OP_ASIN:
    case OP_ACOS:
    case OP_ATAN:
    case OP_ATANH:
    case OP_ASINH:
    case OP_ACOSH: {  // (+-b_k - (sum_{m=1..k-1} (k-m) c_m a_{k-m}) / k) / c_0
      const F bk = L.at(k, a[0]);
      return ((op == OP_ACOS ? -bk : bk) - conv_dn<F>(L, a[1], c, k, 1) / kf)
             / L.at(0, a[1]);
    }
    case OP_ERF:  // (2/sqrt(pi)) (sum_{m<k} (k-m) e_m b_{k-m}) / k
      return F(2.0 / sqrt(kPi)) * (conv_dn<F>(L, a[1], a[0], k, 0) / kf);
    case OP_ATAN2: {  // y = a[0], x = a[1], d = a[2] = x^2 + y^2
      F r1 = F(0), r2 = F(0), s = F(0);
      #pragma unroll 4
      for (int m = 0; m < k; ++m) {
        const F w = (F)(k - m);
        r1 += w * (L.at(m, a[1]) * L.at(k - m, a[0]));
        r2 += w * (L.at(m, a[0]) * L.at(k - m, a[1]));
      }
      #pragma unroll 4
      for (int m = 1; m < k; ++m)
        s += (F)(k - m) * (L.at(m, a[2]) * L.at(k - m, c));
      return ((r1 - r2) - s) / (kf * L.at(0, a[2]));
    }
    case OP_KEPE: {  // e = a[0], M = a[1]; q = e cos E
      const int row = syn[o];
      const F t1 = kf * L.at(k, a[1]);
      const F t2 = conv_up<F>(L, a[0], x[0], k, 1, k);
      const F t3 = conv_syn<F>(L, S, row, c, k);
      return ((t1 + t2) + t3) / (kf * (F(1) - S.at(0, row)));
    }
    case OP_KEPF: {  // h = a[0], kk = a[1], lam = a[2]; w = h sin + kk cos
      const int row = syn[o];
      const F t1 = kf * L.at(k, a[2]);
      const F t2 = conv_up<F>(L, a[0], x[1], k, 1, k);
      const F t3 = conv_up<F>(L, a[1], x[0], k, 1, k);
      const F t4 = conv_syn<F>(L, S, row, c, k);
      return (((t1 - t2) + t3) + t4) / (kf * (F(1) - S.at(0, row)));
    }
    case OP_KEPDE: {  // s0 = a[0], c0 = a[1], DM = a[2]; w = s0 sin - c0 cos
      const int row = syn[o];
      const F t1 = kf * L.at(k, a[2]);
      const F t2 = (kf * L.at(k, a[0])) * (F(1) - L.at(0, x[1]));
      const F t3 = conv_up<F>(L, a[0], x[1], k, 1, k - 1);
      const F t4 = conv_up<F>(L, a[1], x[0], k, 1, k);
      const F t5 = conv_syn<F>(L, S, row, c, k);
      return ((((t1 - t2) + t3) + t4) - t5) / (kf * (F(1) + S.at(0, row)));
    }
    case OP_RELU:
      return L.at(0, a[0]) > F(0) ? L.at(k, a[0]) : F(0);
    case OP_SELECT:
      return L.at(0, a[0]) != F(0) ? L.at(k, a[1]) : L.at(k, a[2]);
    case OP_SERIES:  // a dense series: order k of its row from kernel S1
      return Q.at(k, syn[o]);
    case OP_INTERP:  // S u_k, S the lane's slope at u_0 (its side row)
      return Q.at(0, syn[o]) * L.at(k, a[0]);
    case OP_DAYFRAC:  // d dayfrac / dt = 1
      return L.at(k, a[0]);
    default:  // relup, the relational and logical ops, OP_INTERP_P
      return F(0);
  }
}

// The engine's rules: phase_k and synth_j in F.
template <typename F>
struct B4Rule {
  template <class LV, class SV, class QV>
  __device__ static F order_k(const Tape& T, const int* aux, const int* syn,
                              const LV& L, const SV& S, const QV& Q, int op,
                              int c, int o, int k) {
    return phase_k<F>(T, aux, syn, L, S, Q, op, c, o, k);
  }
  template <class LV>
  __device__ static F synth(const Tape& T, const int* aux, const LV& L,
                            int op, int o, int j) {
    return synth_j<F>(L, op, T.args + T.argptr[o], aux + 2 * o, j);
  }
};

template <typename F, bool kSmem, bool kPasses = true>
__global__ void __launch_bounds__(kPhaseMaxThreads)
phase_kernel(const int* __restrict__ it, const double* __restrict__ dt,
             F* __restrict__ tc, F* __restrict__ syn,
             const F* __restrict__ ser, int n_ser, int B, int lo, int lanes,
             int n_it, int n_dt) {
  phase_block<F, B4Rule<F>, kSmem, kPasses>(it, dt, tc, syn, ser, n_ser, B,
                                            lo, lanes, n_it, n_dt);
}

// One launch of the instance of scalar F on layout `global`.
template <typename F>
int launch_b4(bool* allowed, const int* itab, const double* dtab, F* tc,
              F* syn, const F* ser, int n_ser, int B, int lo, int lanes,
              int threads, int smem, int n_it, int n_dt, int global,
              cudaStream_t s) {
  if (global)
    return launch_phase(phase_kernel<F, false>, allowed[0], itab, dtab, tc,
                        syn, ser, n_ser, B, lo, lanes, threads, smem, n_it,
                        n_dt, s);
  return launch_phase(phase_kernel<F, true>, allowed[1], itab, dtab, tc, syn,
                      ser, n_ser, B, lo, lanes, threads, smem, n_it, n_dt,
                      s);
}

}  // namespace

// `global` 0: the lanes staged in shared memory (`syn` unused); 1: in
// place in `tc`, the synthetic rows in `syn`, a (K+1, n_syn, B) scratch
// buffer.  `ser`: the side rows, a (K+1, n_ser, B) buffer: the
// dense-series rows that kernel S1 filled, then the interpolants' slopes
// at order 0 (null where n_ser is 0).  `lanes`, `threads`, `smem`,
// `n_it`, `n_dt`: jet_phase.block_shape's.
extern "C" int hy_phase_f64(const int* itab, const double* dtab, double* tc,
                            double* syn, const double* ser, int n_ser, int B,
                            int lo, int lanes, int threads, int smem,
                            int n_it, int n_dt, int global, void* stream) {
  static bool allowed[2] = {false, false};
  return launch_b4(allowed, itab, dtab, tc, syn, ser, n_ser, B, lo, lanes,
                   threads, smem, n_it, n_dt, global, (cudaStream_t)stream);
}

// The same on an f32 buffer (the tables stay those of hy_phase_f64).
extern "C" int hy_phase_f32(const int* itab, const double* dtab, float* tc,
                            float* syn, const float* ser, int n_ser, int B,
                            int lo, int lanes, int threads, int smem,
                            int n_it, int n_dt, int global, void* stream) {
  static bool allowed[2] = {false, false};
  return launch_b4(allowed, itab, dtab, tc, syn, ser, n_ser, B, lo, lanes,
                   threads, smem, n_it, n_dt, global, (cudaStream_t)stream);
}

// The staging of hy_phase_f64's smem layout alone (rows in and back, no
// pass): orders lo..K of the columns it writes are left undefined.  Only
// the timing of jet_phase.stage launches it.
extern "C" int hy_phase_stage_f64(const int* itab, const double* dtab,
                                  double* tc, int B, int lo, int lanes,
                                  int threads, int smem, int n_it, int n_dt,
                                  void* stream) {
  static bool allowed = false;
  return launch_phase(phase_kernel<double, true, false>, allowed, itab, dtab,
                      tc, (double*)nullptr, (const double*)nullptr, 0, B, lo,
                      lanes, threads, smem, n_it, n_dt,
                      (cudaStream_t)stream);
}
