// Taylor jet and fused multi-step propagation over a tape plan, in f64,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of heyoka_tpu/taylor/pallas_phase.py:
//   hy_jet_f64  <- make_dd_jet_kernel (:1604; slim=True, order0="dd";
//                  the sv_extra rows of the event equations, :1632-1662)
//   hy_prop_f64 <- make_dd_prop_kernel (:2454)
// The TPU kernels run in two-f32 arithmetic with an f32 tail and per-lane
// power-of-two coefficient scaling because the TPU has no f64; the H100
// has it, so everything here is plain f64 and none of those tricks exist.
//
// Design: a block owns L lanes and its threads share out the work of
// those lanes' jets.  The tape is interpreted from tables built by
// heyoka_tpu_torch/convert.py and packed by taylor/jet_kernels.py (layout
// in `enum Hdr` of taylor_common.cuh).
//
// Shared memory.  A block's dynamic shared memory holds, in this order,
// kLaneScalars doubles a lane (kernel B1's per-lane step state, LaneVars),
// the lanes' jets as [K+1][W][L] f64 with the lane index minor, and, where
// the launch made room, a copy of the tables.  One lane's jet is (K+1) W 8
// bytes: 60,960 B on the outer-Solar-System tape (W = 381, K = 19), 61,088
// B with its scalars, 68,588 B with the tables.  An SM has 228 KB and
// keeps 1 KB of it for each resident block, so three such blocks of one
// lane fit on an SM; a block of three lanes fills one.
// jet_kernels.block_shape makes the same count and picks the lanes and
// threads a block; the tables join the jets only where they cost no block
// an SM.  Where one lane's jet and scalars exceed the 232,448
// bytes a block may have (W > 1,452 at K = 19: mascon-128 and wider), the
// same code runs on a global scratch buffer of the same per-block layout,
// kGlobalLanes lanes a block, through the same base pointer arithmetic.
//
// The work of a pass is its (row, lane) items: order 0 of a group, the
// state rows of order k (a[k][i] = a[k-1][rhs[i]] / k), order k of a
// group.  The block's threads take the items in turn and a __syncthreads()
// closes each pass: the rows of one group depend only on earlier groups
// (B3 closes each level the same way).  Each item is one thread's, with
// the terms summed in j ascending as the plain twins write them, so the
// coefficients are the same expressions, bit for bit, as those of the
// one-thread-per-lane kernel this design replaced.  The norms are a
// reduction per lane over a group of the block's threads (norm_group: a
// power of two of at most a warp; nmax is exact and propagates NaN in any
// order, so any group gives the same bits); the step size, the lane
// protocol and the double-length sums run on one thread per lane through
// shared memory; the update is one item per (state row, lane).  So every
// block shape, lanes (HY_LANES) by threads, gives the same bits.  Kernel
// B1 keeps the lanes' state in the order-0 rows
// for the whole launch: it reads the state once and writes st/of/oi once.
//
// B1's step loop is uniform over the block: it runs while any lane of the
// block is active, and the items of a lane that has stopped (near, err,
// budget, inactive from the start, past the last lane) are skipped, so
// its state stays as it was, as prop_plain's torch.where keeps it.
//
// What bounds it on this card: the latency of a block's chain of passes.
// A lane-jet is 8 passes an order on the outer-SS tape, 160 in all, each
// ended by a barrier and each as long as its slowest item, a sum of up to
// k+1 dependent terms read from shared memory; the 15-row groups leave
// most of the block's threads idle.  The card's f64 rate and its
// shared-memory bandwidth are far from used, and the time per jet falls
// with the blocks an SM holds (PERF.md), which on the outer-SS tape the
// jets' shared memory caps at three.  On a small tape shared memory is no
// such limit: the Henon-Heiles tape (W = 17) takes 2,848 B a lane, and
// its passes have at most 4 rows.  There a block holds several lanes and
// only the threads their widest pass needs, so that an SM runs as many
// lanes as its shared memory holds (jet_kernels.block_shape: 16 lanes of
// 64 threads, 80 lanes an SM, where blocks of one lane and 256 threads ran
// 4, the limit of their registers; a chunk 16.6x faster).  Tensor cores (DMMA/wgmma) do not apply: a Cauchy product
// of one row and one lane shares no operand tile with another row, so the
// design is shared memory and f64 CUDA cores.
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

constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have
constexpr int kGlobalLanes = 4;   // a 32-byte sector of each row
constexpr int kLaneScalars = 16;  // jet_kernels.LANE_SCALARS

// Kernel B1's state of one lane, in shared memory; kernel B2 reads `act`
// only.
struct LaneVars {
  double mdt, dir, rem_h, rem_l, acc_h, acc_l, min_h, max_h, last_h, h, hs;
  int budget, ns, act, near, err, bad, take;
};
static_assert(sizeof(LaneVars) <= kLaneScalars * sizeof(double),
              "LaneVars outgrows its kLaneScalars doubles");

// The coefficients of a block's L lanes: [K+1][W][L], lane index minor.
template <int L>
struct Jets {
  double* p;
  int W;
  __device__ double& at(int k, int c, int l) const {
    return p[(k * W + c) * L + l];
  }
};

// The block's lane scalars and jets: the first kLaneScalars L doubles of
// the dynamic shared memory, then the jets (kSmem) or the block's part of
// the global scratch `tc`.
template <int L, bool kSmem>
__device__ Jets<L> block_jets(const Tape& T, double* smem, double* tc) {
  if constexpr (kSmem) {
    return Jets<L>{smem + kLaneScalars * L, T.W};
  } else {
    return Jets<L>{tc + (size_t)blockIdx.x * ((size_t)(T.K + 1) * T.W * L),
                   T.W};
  }
}

// The tape's tables, copied into the block's shared memory behind the jets
// where the launch made room for them (n_it > 0: n_it ints of `it`, n_dt
// doubles of `dt`), else read where they are.
template <int L, bool kSmem>
__device__ Tape block_tape(const int* __restrict__ it,
                           const double* __restrict__ dt, double* smem,
                           int n_it, int n_dt) {
  if (n_it == 0) return load_tape(it, dt);
  const int jets = kSmem ? (it[H_K] + 1) * it[H_W] * L : 0;
  double* sdt = smem + kLaneScalars * L + jets;
  int* sit = reinterpret_cast<int*>(sdt + n_dt);
  for (int i = threadIdx.x; i < n_dt; i += blockDim.x) sdt[i] = dt[i];
  for (int i = threadIdx.x; i < n_it; i += blockDim.x) sit[i] = it[i];
  __syncthreads();
  return load_tape(sit, sdt);
}

// Virtual columns: constants and parameters at their values at order 0
// and zero above; the time column (t, 1, 0, ...).  Written once per launch.
template <int L>
__device__ void seed_virtual(const Tape& T, const Jets<L>& J, int lane0,
                             int B, const double* __restrict__ pars,
                             const double* __restrict__ t) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int it = tid; it < T.n_const * L; it += nt) {
    const int j = it / L, l = it - j * L;
    const int c = T.ccols[j];
    J.at(0, c, l) = T.cvals[j];
    for (int k = 1; k <= T.K; ++k) J.at(k, c, l) = 0.0;
  }
  for (int it = tid; it < T.n_pcol * L; it += nt) {
    const int j = it / L, l = it - j * L;
    if (lane0 + l >= B) continue;
    const int c = T.pcols[j];
    J.at(0, c, l) = pars[(size_t)T.pidx[j] * B + (size_t)(lane0 + l)];
    for (int k = 1; k <= T.K; ++k) J.at(k, c, l) = 0.0;
  }
  if (T.time_col >= 0) {
    for (int l = tid; l < L; l += nt) {
      if (lane0 + l >= B) continue;
      const int c = T.time_col;
      J.at(0, c, l) = t[lane0 + l];
      for (int k = 1; k <= T.K; ++k) J.at(k, c, l) = (k == 1) ? 1.0 : 0.0;
    }
  }
}

// The jet of the block's live lanes (V[l].act): order 0 of every group
// column from the order-0 state rows, then orders 1..K, pass by pass.
template <int L>
__device__ void jet_orders(const Tape& T, const Jets<L>& J,
                           const LaneVars* V) {
  const int n_eq = T.n_eq;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int g = 0; g < T.n_groups; ++g) {
    const int op = T.gop[g], s = T.gstart[g], m = T.gm[g];
    for (int it = tid; it < m * L; it += nt) {
      const int r = it / L, l = it - r * L;
      if (!V[l].act) continue;
      const int c = s + r, o = c - n_eq;
      const int* a = T.args + T.argptr[o];
      const int na = T.argptr[o + 1] - T.argptr[o];
      double v;
      switch (op) {
        case OP_SUM:
          v = J.at(0, a[0], l);
          for (int q = 1; q < na; ++q) v += J.at(0, a[q], l);
          break;
        case OP_MUL: v = J.at(0, a[0], l) * J.at(0, a[1], l); break;
        case OP_DIV: v = J.at(0, a[0], l) / J.at(0, a[1], l); break;
        case OP_SQRT: v = sqrt(J.at(0, a[0], l)); break;
        default: v = pow0(J.at(0, a[0], l), T.alpha[o]); break;
      }
      J.at(0, c, l) = v;
    }
    __syncthreads();
  }
  for (int k = 1; k <= T.K; ++k) {
    const double kf = (double)k;
    for (int it = tid; it < n_eq * L; it += nt) {
      const int i = it / L, l = it - i * L;
      if (V[l].act) J.at(k, i, l) = J.at(k - 1, T.rhs[i], l) / kf;
    }
    __syncthreads();
    for (int g = 0; g < T.n_groups; ++g) {
      const int op = T.gop[g], s = T.gstart[g], m = T.gm[g];
      for (int it = tid; it < m * L; it += nt) {
        const int r = it / L, l = it - r * L;
        if (!V[l].act) continue;
        const int c = s + r, o = c - n_eq;
        const int* a = T.args + T.argptr[o];
        const int na = T.argptr[o + 1] - T.argptr[o];
        // a column's orders lie `os` doubles apart; the sums run in j
        // ascending, unrolled so that the loads of a few terms are in
        // flight together (the order of the adds does not change)
        const int os = J.W * L;
        const double* A = &J.at(0, a[0], l);
        double* Q = &J.at(0, c, l);
        double v;
        switch (op) {
          case OP_SUM:
            v = A[k * os];
#pragma unroll 4
            for (int q = 1; q < na; ++q) v += J.at(k, a[q], l);
            break;
          case OP_MUL: {  // sum_{j=0..k} a_j b_{k-j}
            const double* Bk = &J.at(k, a[1], l);
            v = 0.0;
#pragma unroll 4
            for (int j = 0; j <= k; ++j) v += A[j * os] * Bk[-j * os];
            break;
          }
          case OP_DIV: {  // (a_k - sum_{j<k} q_j b_{k-j}) / b_0
            const double* Bk = &J.at(k, a[1], l);
            double sacc = 0.0;
#pragma unroll 4
            for (int j = 0; j < k; ++j) sacc += Q[j * os] * Bk[-j * os];
            v = (A[k * os] - sacc) / Bk[-k * os];
            break;
          }
          case OP_SQRT: {  // (a_k - sum_{j=1..k-1} q_j q_{k-j}) / (2 q_0)
            double sacc = 0.0;
#pragma unroll 4
            for (int j = 1; j < k; ++j) sacc += Q[j * os] * Q[(k - j) * os];
            v = (A[k * os] - sacc) / (2.0 * Q[0]);
            break;
          }
          default: {  // (sum_{j<k} (alpha (k-j) - j) q_j b_{k-j}) / (k b_0)
            double s1 = 0.0, s2 = 0.0;
#pragma unroll 4
            for (int j = 0; j < k; ++j) {
              const double q = Q[j * os], b = A[(k - j) * os];
              s1 += (q * b) * (double)(k - j);
              s2 += ((double)j * q) * b;
            }
            v = (s1 * T.alpha[o] - s2) / (kf * A[0]);
            break;
          }
        }
        Q[k * os] = v;
      }
      __syncthreads();
    }
  }
}

// threads that take one lane's norms: threads l G .. l G + G - 1 for lane
// l, G a power of two of at most a warp with G L within the block, and no
// more than the norm columns need (one thread a lane where that is all
// there is); a group lies inside one warp
template <int L>
__device__ int norm_group(int n_norm) {
  int g = 32;
  while (g > 1 && g * L > (int)blockDim.x) g >>= 1;
  while (g > 1 && (g >> 1) >= n_norm) g >>= 1;
  return g;
}

// infinity norms of lane l over the state (and sv-func) columns of orders
// K-1, K, 0: the columns shared out over the calling group of G threads,
// then a butterfly, so every thread of the group holds the result
template <int L>
__device__ void norms3(const Tape& T, const Jets<L>& J, int l, int G,
                       double& m1, double& mo, double& m0) {
  m1 = mo = m0 = 0.0;
  const int r = threadIdx.x & (G - 1);
  for (int j = r; j < T.n_norm; j += G) {
    const int c = T.norm[j];
    m1 = nmax(m1, fabs(J.at(T.K - 1, c, l)));
    mo = nmax(mo, fabs(J.at(T.K, c, l)));
    m0 = nmax(m0, fabs(J.at(0, c, l)));
  }
  const unsigned mask = G == 32 ? 0xffffffffu
                                : ((1u << G) - 1u) << ((threadIdx.x & 31) - r);
  for (int off = G >> 1; off > 0; off >>= 1) {
    m1 = nmax(m1, __shfl_xor_sync(mask, m1, off));
    mo = nmax(mo, __shfl_xor_sync(mask, mo, off));
    m0 = nmax(m0, __shfl_xor_sync(mask, m0, off));
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

// new value of state column i of lane l after a step of h: compensated
// monomial sum (high accuracy, stepper.ceval_update) or Horner
template <int L>
__device__ double update(const Tape& T, const Jets<L>& J, int i, int l,
                         double h, bool high_accuracy) {
  const int K = T.K;
  if (high_accuracy) {
    double res = J.at(0, i, l), comp = 0.0, cur_h = h;
    for (int k = 1; k <= K; ++k) {
      const double tmp = J.at(k, i, l) * cur_h;
      const double y = tmp - comp;
      const double t = res + y;
      comp = (t - res) - y;
      res = t;
      if (k < K) cur_h = cur_h * h;
    }
    return res;
  }
  double res = J.at(K, i, l);
  for (int k = 1; k <= K; ++k) res = J.at(K - k, i, l) + res * h;
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

template <int L, bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
jet_kernel(const int* __restrict__ it, const double* __restrict__ dt,
           const double* __restrict__ state, const double* __restrict__ pars,
           const double* __restrict__ t, double* __restrict__ tc,
           double* __restrict__ out, double* __restrict__ norms, int B,
           int n_it, int n_dt) {
  extern __shared__ double smem[];
  const Tape T = block_tape<L, kSmem>(it, dt, smem, n_it, n_dt);
  LaneVars* V = reinterpret_cast<LaneVars*>(smem);
  const Jets<L> J = block_jets<L, kSmem>(T, smem, tc);
  const int lane0 = blockIdx.x * L, tid = threadIdx.x, nt = blockDim.x;
  const size_t Bs = (size_t)B;
  if (tid < L) V[tid].act = lane0 + tid < B;
  for (int i2 = tid; i2 < T.n_eq * L; i2 += nt) {
    const int i = i2 / L, l = i2 - i * L;
    if (lane0 + l < B) J.at(0, i, l) = state[i * Bs + lane0 + l];
  }
  seed_virtual(T, J, lane0, B, pars, t);
  __syncthreads();
  jet_orders(T, J, V);  // ends with a barrier
  const int G = norm_group<L>(T.n_norm), w = tid / G;
  if (w < L && lane0 + w < B) {
    double m1, mo, m0;
    norms3(T, J, w, G, m1, mo, m0);
    if ((tid & (G - 1)) == 0) {
      norms[lane0 + w] = m1;
      norms[Bs + lane0 + w] = mo;
      norms[2 * Bs + lane0 + w] = m0;
    }
  }
  // out (n_eq + n_out, K+1, B): the state rows, then the sv-func rows
  // (the event equations, the columns of the table at H_OUTC, read from
  // the global tables), the items in the order of the output
  const int K1 = T.K + 1;
  for (int i2 = tid; i2 < T.n_eq * K1 * L; i2 += nt) {
    const int ik = i2 / L, l = i2 - ik * L;
    const int i = ik / K1, k = ik - i * K1;
    if (lane0 + l < B) out[(size_t)ik * Bs + lane0 + l] = J.at(k, i, l);
  }
  const int n_out = it[H_NOUT];
  const int* outc = it + it[H_OUTC];
  double* out_sv = out + (size_t)T.n_eq * K1 * Bs;
  for (int i2 = tid; i2 < n_out * K1 * L; i2 += nt) {
    const int jk = i2 / L, l = i2 - jk * L;
    const int j = jk / K1, k = jk - j * K1;
    if (lane0 + l < B)
      out_sv[(size_t)jk * Bs + lane0 + l] = J.at(k, outc[j], l);
  }
}

// Up to n_steps adaptive steps of the block's lanes.  Lane protocol
// (pallas_phase make_dd_prop_kernel): an active lane stops stepping when
// its natural step would reach the target (near), when a step is
// non-finite (err; the step is not applied) or when its step budget is
// spent.
template <int L, bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
prop_kernel(const int* __restrict__ it, const double* __restrict__ dt,
            const double* __restrict__ state, const double* __restrict__ pars,
            const double* __restrict__ aux, const int* __restrict__ auxi,
            double* __restrict__ tc, double* __restrict__ st,
            double* __restrict__ of, int* __restrict__ oi, int B,
            int n_steps, int high_accuracy, int n_it, int n_dt) {
  extern __shared__ double smem[];
  const Tape T = block_tape<L, kSmem>(it, dt, smem, n_it, n_dt);
  LaneVars* V = reinterpret_cast<LaneVars*>(smem);
  const Jets<L> J = block_jets<L, kSmem>(T, smem, tc);
  const int lane0 = blockIdx.x * L, tid = threadIdx.x, nt = blockDim.x;
  const int n_eq = T.n_eq, K = T.K;
  const size_t Bs = (size_t)B;
  if (tid < L) {
    LaneVars& v = V[tid];
    const int lane = lane0 + tid;
    const bool in = lane < B;
    v.mdt = in ? aux[lane] : 0.0;
    v.dir = in ? aux[Bs + lane] : 0.0;
    v.rem_h = in ? aux[2 * Bs + lane] : 0.0;
    v.rem_l = in ? aux[3 * Bs + lane] : 0.0;
    v.act = in && aux[4 * Bs + lane] > 0.5;
    v.budget = in ? auxi[lane] : 0;
    v.acc_h = v.acc_l = 0.0;
    v.min_h = INFINITY;
    v.max_h = v.last_h = v.h = v.hs = 0.0;
    v.ns = v.near = v.err = v.bad = v.take = 0;
  }
  // the lanes' state lives in the order-0 rows until the end
  for (int i2 = tid; i2 < n_eq * L; i2 += nt) {
    const int i = i2 / L, l = i2 - i * L;
    if (lane0 + l < B) J.at(0, i, l) = state[i * Bs + lane0 + l];
  }
  seed_virtual(T, J, lane0, B, pars, nullptr);
  const int G = norm_group<L>(T.n_norm), w = tid / G;
  for (int step = 0; step < n_steps; ++step) {
    if (!__syncthreads_or(tid < L && V[tid].act)) break;
    jet_orders(T, J, V);
    // the step size and the tests that come before the update: group w
    // for lane w
    if (w < L && V[w].act) {
      double m1, mo, m0;
      norms3(T, J, w, G, m1, mo, m0);
      if ((tid & (G - 1)) == 0) {
        LaneVars& v = V[w];
        const double h = rho_h(T, m0, m1, mo, v.mdt);
        if (h >= v.rem_h) {  // the exact landing runs outside
          v.near = 1;
          v.act = 0;
        } else if (v.ns >= v.budget) {
          v.act = 0;
        } else {
          v.h = h;
          v.hs = h * v.dir;
          v.bad = !((h > 0.0) && isfinite(h));
        }
      }
    }
    __syncthreads();
    // the new state into the order-K slot of each state row (a row's
    // update reads that row only); the order-0 rows keep the old state
    // until the step is accepted
    for (int i2 = tid; i2 < n_eq * L; i2 += nt) {
      const int i = i2 / L, l = i2 - i * L;
      if (!V[l].act) continue;
      const double v = update(T, J, i, l, V[l].hs, high_accuracy != 0);
      if (!isfinite(v)) V[l].bad = 1;
      J.at(K, i, l) = v;
    }
    __syncthreads();
    if (tid < L) {
      LaneVars& v = V[tid];
      v.take = 0;
      if (v.act) {
        if (v.bad) {
          v.err = 1;
          v.act = 0;
        } else {
          dd_add_d(v.rem_h, v.rem_l, -v.h);
          dd_add_d(v.acc_h, v.acc_l, v.hs);
          v.min_h = fmin(v.min_h, v.h);
          v.max_h = fmax(v.max_h, v.h);
          v.last_h = v.hs;
          ++v.ns;
          v.act = v.ns < v.budget;
          v.take = 1;
        }
      }
    }
    __syncthreads();
    for (int i2 = tid; i2 < n_eq * L; i2 += nt) {
      const int i = i2 / L, l = i2 - i * L;
      if (V[l].take) J.at(0, i, l) = J.at(K, i, l);
    }
  }
  __syncthreads();
  for (int i2 = tid; i2 < n_eq * L; i2 += nt) {
    const int i = i2 / L, l = i2 - i * L;
    if (lane0 + l < B) st[i * Bs + lane0 + l] = J.at(0, i, l);
  }
  if (tid < L && lane0 + tid < B) {
    const LaneVars& v = V[tid];
    const size_t lane = (size_t)(lane0 + tid);
    of[lane] = v.acc_h;
    of[Bs + lane] = v.acc_l;
    of[2 * Bs + lane] = v.min_h;
    of[3 * Bs + lane] = v.max_h;
    of[4 * Bs + lane] = v.last_h;
    oi[lane] = v.ns;
    oi[Bs + lane] = v.near;
    oi[2 * Bs + lane] = v.err;
  }
}

// A kernel may take more than 48 KB of dynamic shared memory only once it
// has been allowed to: once per kernel instance, before its first launch.
template <class F>
cudaError_t allow_smem(F* kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  done = e == cudaSuccess;
  return e;
}

template <int L, bool kSmem>
int launch_jet(const int* itab, const double* dtab, const double* state,
               const double* pars, const double* t, double* tc, double* out,
               double* norms, int B, int threads, int smem, int n_it,
               int n_dt, cudaStream_t stream) {
  static bool allowed = false;
  const cudaError_t e = allow_smem(jet_kernel<L, kSmem>, allowed);
  if (e != cudaSuccess) return (int)e;
  jet_kernel<L, kSmem><<<(B + L - 1) / L, threads, smem, stream>>>(
      itab, dtab, state, pars, t, tc, out, norms, B, n_it, n_dt);
  return (int)cudaGetLastError();
}

template <int L, bool kSmem>
int launch_prop(const int* itab, const double* dtab, const double* state,
                const double* pars, const double* aux, const int* auxi,
                double* tc, double* state_out, double* of, int* oi, int B,
                int n_steps, int high_accuracy, int threads, int smem,
                int n_it, int n_dt, cudaStream_t stream) {
  static bool allowed = false;
  const cudaError_t e = allow_smem(prop_kernel<L, kSmem>, allowed);
  if (e != cudaSuccess) return (int)e;
  prop_kernel<L, kSmem><<<(B + L - 1) / L, threads, smem, stream>>>(
      itab, dtab, state, pars, aux, auxi, tc, state_out, of, oi, B, n_steps,
      high_accuracy, n_it, n_dt);
  return (int)cudaGetLastError();
}

// whole warps, at most kMaxThreads, and a thread for each lane's scalars
bool bad_shape(int lanes, int threads) {
  return threads % 32 != 0 || threads > kMaxThreads || lanes < 1 ||
         lanes > threads;
}

// the lanes a block may hold with the jets in shared memory, one instance
// of each kernel a count (jet_kernels.LANE_CHOICES)
#define HY_LANES(X) X(1) X(2) X(3) X(4) X(8) X(16) X(32)

}  // namespace

// `tc` null: the jets in shared memory, `lanes` of HY_LANES a block; else
// `tc` is the global scratch of ceil(B / lanes) blocks of (K+1) W lanes
// doubles and `lanes` is kGlobalLanes.  `threads`: whole warps, at least
// `lanes`.  `smem`: the dynamic shared memory of a block in bytes
// (jet_kernels.block_shape), with room for the tables where n_it (the
// ints of itab) and n_dt (the doubles of dtab) are not 0.
extern "C" int hy_jet_f64(const int* itab, const double* dtab,
                          const double* state, const double* pars,
                          const double* t, double* tc, double* out,
                          double* norms, int B, int lanes, int threads,
                          int smem, int n_it, int n_dt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bad_shape(lanes, threads)) return (int)cudaErrorInvalidValue;
  if (tc != nullptr) {
    if (lanes != kGlobalLanes) return (int)cudaErrorInvalidValue;
    return launch_jet<kGlobalLanes, false>(itab, dtab, state, pars, t, tc,
                                           out, norms, B, threads, smem,
                                           n_it, n_dt, s);
  }
  switch (lanes) {
#define HY_CASE(n)                                                          \
  case n:                                                                   \
    return launch_jet<n, true>(itab, dtab, state, pars, t, tc, out, norms, \
                               B, threads, smem, n_it, n_dt, s);
    HY_LANES(HY_CASE)
#undef HY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int hy_prop_f64(const int* itab, const double* dtab,
                           const double* state, const double* pars,
                           const double* aux, const int* auxi, double* tc,
                           double* state_out, double* of, int* oi, int B,
                           int n_steps, int high_accuracy, int lanes,
                           int threads, int smem, int n_it, int n_dt,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bad_shape(lanes, threads)) return (int)cudaErrorInvalidValue;
  if (tc != nullptr) {
    if (lanes != kGlobalLanes) return (int)cudaErrorInvalidValue;
    return launch_prop<kGlobalLanes, false>(
        itab, dtab, state, pars, aux, auxi, tc, state_out, of, oi, B,
        n_steps, high_accuracy, threads, smem, n_it, n_dt, s);
  }
  switch (lanes) {
#define HY_CASE(n)                                                        \
  case n:                                                                 \
    return launch_prop<n, true>(itab, dtab, state, pars, aux, auxi, tc,  \
                                state_out, of, oi, B, n_steps,           \
                                high_accuracy, threads, smem, n_it, n_dt, \
                                s);
    HY_LANES(HY_CASE)
#undef HY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of kernel B1 with the jets in shared memory an SM holds at
// `lanes` x `threads` and `smem` bytes, as the runtime counts them
// (registers included), or minus a CUDA error: the check of
// jet_kernels.blocks_per_sm, which counts shared memory, threads and
// blocks only.
extern "C" int hy_prop_occupancy(int lanes, int threads, int smem) {
  if (bad_shape(lanes, threads)) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (lanes) {
#define HY_CASE(n)                                                     \
  case n: {                                                            \
    static bool allowed = false;                                       \
    e = allow_smem(prop_kernel<n, true>, allowed);                     \
    if (e == cudaSuccess)                                              \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(               \
          &blocks, prop_kernel<n, true>, threads, (size_t)smem);       \
    break;                                                             \
  }
    HY_LANES(HY_CASE)
#undef HY_CASE
    default:
      break;
  }
  return e == cudaSuccess ? blocks : -(int)e;
}
