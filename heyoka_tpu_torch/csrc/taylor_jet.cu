// Taylor jet and fused multi-step propagation over a tape plan, in f64,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of heyoka_tpu/taylor/pallas_phase.py:
//   hy_jet_f64  <- make_dd_jet_kernel (:1604; slim=True, order0="dd")
//   hy_prop_f64 <- make_dd_prop_kernel (:2454)
// The TPU kernels run in two-f32 arithmetic with an f32 tail and per-lane
// power-of-two coefficient scaling because the TPU has no f64; the H100
// has it, so everything here is plain f64 and none of those tricks exist.
//
// Design: one thread runs one lane and walks the whole plan (the tape is
// interpreted from tables built by heyoka_tpu_torch/convert.py and packed
// by taylor/jet_kernels.py, layout in `enum Hdr` of taylor_common.cuh).
// The coefficient
// buffer is (K+1, W, B) f64 in global memory with the lane index minor, so
// the 32 threads of a warp touch 32 neighbouring doubles on every access.
// A lane's block is (K+1) W 8 bytes (about 61 KB for the outer Solar
// System tape), too large for shared memory at any useful occupancy.
//
// What bounds it on this card: global-memory (L2/HBM) traffic.  Every
// convolution term reads two coefficients from the buffer, so a lane-step
// moves on the order of a megabyte through the memory system while doing
// only a few flops per byte.  The design does nothing about that yet (no
// shared-memory staging, no register blocking of the low orders); a later
// change measures and attacks it.
//
// The recurrences are those of heyoka_tpu/taylor/compact_flat.py (_f_sum,
// _f_mul, _f_div, _f_sqrt, _f_pow); the step control and the state update
// those of heyoka_tpu_torch/taylor/stepper.py.  The plain torch twins in
// taylor/jet_kernels.py compute the same functions.  Build with
// -fmad=false so that a*b - c is not contracted into an FMA: the
// compensated sums then round as in the twins.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "taylor_common.cuh"

namespace {

constexpr int kThreads = 64;  // 10,240 lanes -> 160 blocks for 132 SMs

// Virtual columns: constants and parameters at their values at order 0
// and zero above; the time column (t, 1, 0, ...).  Written once per launch.
__device__ void seed_virtual(const Tape& T, const Lane& L,
                             const double* __restrict__ pars,
                             const double* __restrict__ t) {
  for (int j = 0; j < T.n_const; ++j) {
    const int c = T.ccols[j];
    L.at(0, c) = T.cvals[j];
    for (int k = 1; k <= T.K; ++k) L.at(k, c) = 0.0;
  }
  for (int j = 0; j < T.n_pcol; ++j) {
    const int c = T.pcols[j];
    L.at(0, c) = pars[(size_t)T.pidx[j] * L.B + (size_t)L.lane];
    for (int k = 1; k <= T.K; ++k) L.at(k, c) = 0.0;
  }
  if (T.time_col >= 0) {
    const int c = T.time_col;
    L.at(0, c) = t[L.lane];
    for (int k = 1; k <= T.K; ++k) L.at(k, c) = (k == 1) ? 1.0 : 0.0;
  }
}

// The jet: order 0 of every group column from the order-0 state rows,
// then orders 1..K, level by level.
__device__ void jet_orders(const Tape& T, const Lane& L) {
  const int n_eq = T.n_eq;
  for (int g = 0; g < T.n_groups; ++g) {
    const int op = T.gop[g], s = T.gstart[g], m = T.gm[g];
    for (int r = 0; r < m; ++r) {
      const int c = s + r, o = c - n_eq;
      const int* a = T.args + T.argptr[o];
      const int na = T.argptr[o + 1] - T.argptr[o];
      double v;
      switch (op) {
        case OP_SUM:
          v = L.at(0, a[0]);
          for (int q = 1; q < na; ++q) v += L.at(0, a[q]);
          break;
        case OP_MUL: v = L.at(0, a[0]) * L.at(0, a[1]); break;
        case OP_DIV: v = L.at(0, a[0]) / L.at(0, a[1]); break;
        case OP_SQRT: v = sqrt(L.at(0, a[0])); break;
        default: v = pow0(L.at(0, a[0]), T.alpha[o]); break;
      }
      L.at(0, c) = v;
    }
  }
  for (int k = 1; k <= T.K; ++k) {
    const double kf = (double)k;
    for (int i = 0; i < n_eq; ++i) L.at(k, i) = L.at(k - 1, T.rhs[i]) / kf;
    for (int g = 0; g < T.n_groups; ++g) {
      const int op = T.gop[g], s = T.gstart[g], m = T.gm[g];
      for (int r = 0; r < m; ++r) {
        const int c = s + r, o = c - n_eq;
        const int* a = T.args + T.argptr[o];
        const int na = T.argptr[o + 1] - T.argptr[o];
        double v;
        switch (op) {
          case OP_SUM:
            v = L.at(k, a[0]);
            for (int q = 1; q < na; ++q) v += L.at(k, a[q]);
            break;
          case OP_MUL: {  // sum_{j=0..k} a_j b_{k-j}
            v = 0.0;
            for (int j = 0; j <= k; ++j) v += L.at(j, a[0]) * L.at(k - j, a[1]);
            break;
          }
          case OP_DIV: {  // (a_k - sum_{j<k} q_j b_{k-j}) / b_0
            double sacc = 0.0;
            for (int j = 0; j < k; ++j) sacc += L.at(j, c) * L.at(k - j, a[1]);
            v = (L.at(k, a[0]) - sacc) / L.at(0, a[1]);
            break;
          }
          case OP_SQRT: {  // (a_k - sum_{j=1..k-1} q_j q_{k-j}) / (2 q_0)
            double sacc = 0.0;
            for (int j = 1; j < k; ++j) sacc += L.at(j, c) * L.at(k - j, c);
            v = (L.at(k, a[0]) - sacc) / (2.0 * L.at(0, c));
            break;
          }
          default: {  // (sum_{j<k} (alpha (k-j) - j) q_j b_{k-j}) / (k b_0)
            double s1 = 0.0, s2 = 0.0;
            for (int j = 0; j < k; ++j) {
              const double q = L.at(j, c), b = L.at(k - j, a[0]);
              s1 += (q * b) * (double)(k - j);
              s2 += ((double)j * q) * b;
            }
            v = (s1 * T.alpha[o] - s2) / (kf * L.at(0, a[0]));
            break;
          }
        }
        L.at(k, c) = v;
      }
    }
  }
}

// infinity norms over the state (and sv-func) columns of orders K-1, K, 0
__device__ void norms3(const Tape& T, const Lane& L, double& m1, double& mo,
                       double& m0) {
  m1 = mo = m0 = 0.0;
  for (int j = 0; j < T.n_norm; ++j) {
    const int c = T.norm[j];
    m1 = nmax(m1, fabs(L.at(T.K - 1, c)));
    mo = nmax(mo, fabs(L.at(T.K, c)));
    m0 = nmax(m0, fabs(L.at(0, c)));
  }
}

// Jorba's step size (stepper.h_from_norms), clamped to |mdt| and signed
// like it
__device__ double rho_h(const Tape& T, double m0, double m1, double mo,
                        double mdt) {
  const double num = (m0 <= 1.0) ? 1.0 : m0;
  const double rho = nmin(pow(num / mo, 1.0 / T.K),
                          pow(num / m1, 1.0 / (T.K - 1)));
  const double h = nmin(rho * T.rhofac, fabs(mdt));
  return mdt < 0.0 ? -h : h;
}

// new value of state column i after a step of h: compensated monomial
// sum (high accuracy, stepper.ceval_update) or Horner
__device__ double update(const Tape& T, const Lane& L, int i, double h,
                         bool high_accuracy) {
  const int K = T.K;
  if (high_accuracy) {
    double res = L.at(0, i), comp = 0.0, cur_h = h;
    for (int k = 1; k <= K; ++k) {
      const double tmp = L.at(k, i) * cur_h;
      const double y = tmp - comp;
      const double t = res + y;
      comp = (t - res) - y;
      res = t;
      if (k < K) cur_h = cur_h * h;
    }
    return res;
  }
  double res = L.at(K, i);
  for (int k = 1; k <= K; ++k) res = L.at(K - k, i) + res * h;
  return res;
}

// Knuth two-sum of (hi, lo) + x, renormalized (dfloat.dd_add_d)
__device__ void dd_add_d(double& hi, double& lo, double x) {
  const double s = hi + x;
  const double v = s - hi;
  const double e = ((hi - (s - v)) + (x - v)) + lo;
  hi = s + e;
  lo = e - (hi - s);
}

__global__ void __launch_bounds__(kThreads)
jet_kernel(const int* __restrict__ it, const double* __restrict__ dt,
           const double* __restrict__ state, const double* __restrict__ pars,
           const double* __restrict__ t, double* __restrict__ tc,
           double* __restrict__ out, double* __restrict__ norms, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const Tape T = load_tape(it, dt);
  const Lane L{tc, (size_t)T.W, (size_t)B, lane};
  const size_t Bs = (size_t)B;
  for (int i = 0; i < T.n_eq; ++i) L.at(0, i) = state[i * Bs + lane];
  seed_virtual(T, L, pars, t);
  jet_orders(T, L);
  double m1, mo, m0;
  norms3(T, L, m1, mo, m0);
  norms[lane] = m1;
  norms[Bs + lane] = mo;
  norms[2 * Bs + lane] = m0;
  for (int i = 0; i < T.n_eq; ++i)
    for (int k = 0; k <= T.K; ++k)
      out[((size_t)i * (T.K + 1) + k) * Bs + lane] = L.at(k, i);
}

// Up to n_steps adaptive steps of one lane.  Lane protocol (pallas_phase
// make_dd_prop_kernel): an active lane stops stepping when its natural
// step would reach the target (near), when a step is non-finite (err; the
// step is not applied) or when its step budget is spent.
__global__ void __launch_bounds__(kThreads)
prop_kernel(const int* __restrict__ it, const double* __restrict__ dt,
            const double* __restrict__ state, const double* __restrict__ pars,
            const double* __restrict__ aux, const int* __restrict__ auxi,
            double* __restrict__ tc, double* __restrict__ st,
            double* __restrict__ of, int* __restrict__ oi, int B,
            int n_steps, int high_accuracy) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const Tape T = load_tape(it, dt);
  const Lane L{tc, (size_t)T.W, (size_t)B, lane};
  const size_t Bs = (size_t)B;
  seed_virtual(T, L, pars, nullptr);
  for (int i = 0; i < T.n_eq; ++i) st[i * Bs + lane] = state[i * Bs + lane];
  const double mdt = aux[lane], dir = aux[Bs + lane];
  double rem_h = aux[2 * Bs + lane], rem_l = aux[3 * Bs + lane];
  bool act = aux[4 * Bs + lane] > 0.5;
  const int budget = auxi[lane];
  double acc_h = 0.0, acc_l = 0.0, min_h = INFINITY, max_h = 0.0;
  double last_h = 0.0;
  int ns = 0, near = 0, err = 0;
  for (int step = 0; step < n_steps && act; ++step) {
    for (int i = 0; i < T.n_eq; ++i) L.at(0, i) = st[i * Bs + lane];
    jet_orders(T, L);
    double m1, mo, m0;
    norms3(T, L, m1, mo, m0);
    const double h = rho_h(T, m0, m1, mo, mdt);
    if (h >= rem_h) {  // the exact landing runs outside
      near = 1;
      break;
    }
    if (ns >= budget) break;
    const double hs = h * dir;
    bool ok = (h > 0.0) && isfinite(h);
    // the new state goes into the order-0 rows (column i's update reads
    // only column i); st keeps the old one until the step is accepted
    for (int i = 0; i < T.n_eq; ++i) {
      const double v = update(T, L, i, hs, high_accuracy != 0);
      ok = ok && isfinite(v);
      L.at(0, i) = v;
    }
    if (!ok) {
      err = 1;
      break;
    }
    for (int i = 0; i < T.n_eq; ++i) st[i * Bs + lane] = L.at(0, i);
    dd_add_d(rem_h, rem_l, -h);
    dd_add_d(acc_h, acc_l, hs);
    min_h = fmin(min_h, h);
    max_h = fmax(max_h, h);
    last_h = hs;
    ++ns;
    act = ns < budget;
  }
  of[lane] = acc_h;
  of[Bs + lane] = acc_l;
  of[2 * Bs + lane] = min_h;
  of[3 * Bs + lane] = max_h;
  of[4 * Bs + lane] = last_h;
  oi[lane] = ns;
  oi[Bs + lane] = near;
  oi[2 * Bs + lane] = err;
}

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int hy_jet_f64(const int* itab, const double* dtab,
                          const double* state, const double* pars,
                          const double* t, double* tc, double* out,
                          double* norms, int B, void* stream) {
  jet_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      itab, dtab, state, pars, t, tc, out, norms, B);
  return (int)cudaGetLastError();
}

extern "C" int hy_prop_f64(const int* itab, const double* dtab,
                           const double* state, const double* pars,
                           const double* aux, const int* auxi, double* tc,
                           double* state_out, double* of, int* oi, int B,
                           int n_steps, int high_accuracy, void* stream) {
  prop_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      itab, dtab, state, pars, aux, auxi, tc, state_out, of, oi, B, n_steps,
      high_accuracy);
  return (int)cudaGetLastError();
}
