// Rolled Taylor jet for huge tapes (kernel B3), in f64, for NVIDIA Hopper
// (sm_90a).
//
// Replaces make_dd_jet_kernel_rolled (heyoka_tpu/taylor/pallas_phase.py
// :1842).  Same contract as hy_jet_f64 (taylor_jet.cu): the order-0 state,
// parameters and time in; the state columns' coefficients (n_eq, K+1, B)
// and the per-lane norms of orders K-1, K and 0 out.  What it keeps of the
// TPU kernel: the coefficients live in the row classes of
// taylor/rows.py -- H (K+1, WH, B) full history, C (WC, B) current order
// only, V (WV, B) literals, zero above order 0 -- the orders run in loops
// and the convolutions have dynamic trip counts.  What it drops: the
// two-f32 arithmetic, the f32 tail and the per-lane scaling (the H100 has
// f64).  The tables come from taylor/jet_rolled.py (RolledTape, layout in
// `enum RHdr`); every operand is read through its location word (class
// above bit kClsShift, row in the class buffer below).
//
// Design: a block owns kLanes = 8 lanes (64 B of a row: two 32-byte
// sectors, lane index minor) and its kSlots = 64 row slots share out the
// op columns of each dependency level; a __syncthreads() closes every
// level, since the columns of one level are independent of each other.
// This is the card's counterpart of the reference's intra-step parallel
// mode: at 1,024 lanes the one-thread-per-lane B2 fills 16 blocks, this
// kernel 128 blocks of 16 warps.  The class buffers stay in global memory
// (0.70 MB per lane at mascon-512, order 19).
//
// What bounds it on this card: memory traffic.  An order-k convolution
// row reads 2(k+1) coefficients, so a mascon-512 lane-jet reads about
// 2.2 million f64 (18 MB); the H buffer of all lanes (0.67 GB at 1,024
// lanes) is far beyond the 50 MB L2, so most of it streams from HBM.
// Nothing here stages the low orders in shared memory yet.
//
// The recurrences and their order of summation are those of hy_jet_f64,
// so on the same inputs the two kernels round alike; the plain torch twin
// is jet_rolled.jet_rolled_plain.  Build with -fmad=false, like B2.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "taylor_common.cuh"

namespace {

// header of the int32 table `it` (taylor/jet_rolled.py _RHDR): sizes, then
// offsets of the int sub-tables in `it` and of the f64 ones in `dt`
enum RHdr {
  R_NEQ, R_K, R_WH, R_WC, R_WV, R_TROW, R_NLEV, R_NC, R_NPC, R_NNORM,
  R_RHS, R_NORM, R_CROWS, R_PROWS, R_PIDX, R_LVL, R_OP, R_OLOC, R_ARGPTR,
  R_ALOC, R_D_CVALS, R_D_ALPHA
};

constexpr int kLanes = 8;
constexpr int kThreads = 512;
constexpr int kSlots = kThreads / kLanes;
constexpr int kClsShift = 28;  // jet_rolled.CLS_SHIFT
constexpr int kRowMask = (1 << kClsShift) - 1;
constexpr int kSumBatch = 8;  // loads in flight per thread in a wide sum

struct RTape {
  int n_eq, K, WH, time_row, n_levels, n_const, n_pcol, n_norm;
  const int *rhs, *norm, *crows, *prows, *pidx, *lvl, *op, *oloc, *argptr,
      *aloc;
  const double *cvals, *alpha;
};

__device__ RTape load_rtape(const int* __restrict__ it,
                            const double* __restrict__ dt) {
  RTape T;
  T.n_eq = it[R_NEQ];
  T.K = it[R_K];
  T.WH = it[R_WH];
  T.time_row = it[R_TROW];
  T.n_levels = it[R_NLEV];
  T.n_const = it[R_NC];
  T.n_pcol = it[R_NPC];
  T.n_norm = it[R_NNORM];
  T.rhs = it + it[R_RHS];
  T.norm = it + it[R_NORM];
  T.crows = it + it[R_CROWS];
  T.prows = it + it[R_PROWS];
  T.pidx = it + it[R_PIDX];
  T.lvl = it + it[R_LVL];
  T.op = it + it[R_OP];
  T.oloc = it + it[R_OLOC];
  T.argptr = it + it[R_ARGPTR];
  T.aloc = it + it[R_ALOC];
  T.cvals = dt + it[R_D_CVALS];
  T.alpha = dt + it[R_D_ALPHA];
  return T;
}

// The class buffers, seen from one lane.
struct Bufs {
  double *H, *C, *V;
  size_t WH, B;
  int lane;
};

// One column of one lane: order j sits at p[j * stride] (stride 0 for a C
// row, which holds the current order only); a literal is zero above order 0.
struct Ref {
  double* p;
  size_t stride;
  bool lit;
  __device__ double operator()(int j) const {
    return (lit && j > 0) ? 0.0 : p[(size_t)j * stride];
  }
  __device__ double& at(int k) const { return p[(size_t)k * stride]; }
};

__device__ Ref ref(const Bufs& b, int loc) {
  const size_t row = (size_t)(loc & kRowMask);
  switch (loc >> kClsShift) {
    case 0: return Ref{b.H + row * b.B + b.lane, b.WH * b.B, false};
    case 1: return Ref{b.C + row * b.B + b.lane, 0, false};
    default: return Ref{b.V + row * b.B + b.lane, 0, true};
  }
}

// order 0 of op column o (column n_eq + o)
__device__ double eval0(const RTape& T, const Bufs& b, int o) {
  const int* a = T.aloc + T.argptr[o];
  const int na = T.argptr[o + 1] - T.argptr[o];
  const double a0 = ref(b, a[0])(0);
  switch (T.op[o]) {
    case OP_SUM: {
      double v = a0;
      for (int q = 1; q < na; ++q) v += ref(b, a[q])(0);
      return v;
    }
    case OP_MUL: return a0 * ref(b, a[1])(0);
    case OP_DIV: return a0 / ref(b, a[1])(0);
    case OP_SQRT: return sqrt(a0);
    default: return pow0(a0, T.alpha[o]);
  }
}

// order k >= 1 of op column o, from the lower orders
__device__ double eval_k(const RTape& T, const Bufs& b, int o, int k) {
  const int* a = T.aloc + T.argptr[o];
  const int na = T.argptr[o + 1] - T.argptr[o];
  const Ref A = ref(b, a[0]);
  switch (T.op[o]) {
    case OP_SUM: {
      // summed in operand order; the loads of a batch are issued together
      double v = A(k);
      int q = 1;
      for (; q + kSumBatch <= na; q += kSumBatch) {
        double x[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) x[u] = ref(b, a[q + u])(k);
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) v += x[u];
      }
      for (; q < na; ++q) v += ref(b, a[q])(k);
      return v;
    }
    case OP_MUL: {  // sum_{j=0..k} a_j b_{k-j}
      const Ref Bb = ref(b, a[1]);
      double v = 0.0;
      for (int j = 0; j <= k; ++j) v += A(j) * Bb(k - j);
      return v;
    }
    case OP_DIV: {  // (a_k - sum_{j<k} q_j b_{k-j}) / b_0
      const Ref Bb = ref(b, a[1]), Q = ref(b, T.oloc[o]);
      double sacc = 0.0;
      for (int j = 0; j < k; ++j) sacc += Q(j) * Bb(k - j);
      return (A(k) - sacc) / Bb(0);
    }
    case OP_SQRT: {  // (a_k - sum_{j=1..k-1} q_j q_{k-j}) / (2 q_0)
      const Ref Q = ref(b, T.oloc[o]);
      double sacc = 0.0;
      for (int j = 1; j < k; ++j) sacc += Q(j) * Q(k - j);
      return (A(k) - sacc) / (2.0 * Q(0));
    }
    default: {  // (sum_{j<k} (alpha (k-j) - j) q_j b_{k-j}) / (k b_0)
      const Ref Q = ref(b, T.oloc[o]);
      double s1 = 0.0, s2 = 0.0;
      for (int j = 0; j < k; ++j) {
        const double q = Q(j), bb = A(k - j);
        s1 += (q * bb) * (double)(k - j);
        s2 += ((double)j * q) * bb;
      }
      return (s1 * T.alpha[o] - s2) / ((double)k * A(0));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
jet_rolled_kernel(const int* __restrict__ it, const double* __restrict__ dt,
                  const double* __restrict__ state,
                  const double* __restrict__ pars,
                  const double* __restrict__ t, double* __restrict__ H,
                  double* __restrict__ C, double* __restrict__ V,
                  double* __restrict__ out, double* __restrict__ norms,
                  int B) {
  const RTape T = load_rtape(it, dt);
  const int slot = threadIdx.x / kLanes;
  const int lane = blockIdx.x * kLanes + threadIdx.x % kLanes;
  // a thread past the last lane computes nothing but joins every barrier
  const bool live = lane < B;
  const size_t Bs = (size_t)B, WH = (size_t)T.WH;
  const Bufs b{H, C, V, WH, Bs, lane};
  auto h = [&](int k, int row) -> double& {
    return H[((size_t)k * WH + (size_t)row) * Bs + (size_t)lane];
  };

  // seeds: the state (H rows 0..n_eq-1), the literals and parameters
  // (V rows), the time column (t, 1, 0, ...)
  if (live) {
    for (int i = slot; i < T.n_eq; i += kSlots)
      h(0, i) = state[(size_t)i * Bs + lane];
    for (int j = slot; j < T.n_const; j += kSlots)
      V[(size_t)T.crows[j] * Bs + lane] = T.cvals[j];
    for (int j = slot; j < T.n_pcol; j += kSlots)
      V[(size_t)T.prows[j] * Bs + lane] =
          pars[(size_t)T.pidx[j] * Bs + lane];
    if (T.time_row >= 0 && slot == 0)
      for (int k = 0; k <= T.K; ++k)
        h(k, T.time_row) = k == 0 ? t[lane] : (k == 1 ? 1.0 : 0.0);
  }
  __syncthreads();

  // order 0 of every op column, level by level, before any order 1: a C
  // row holds its order-0 value until its group overwrites it at order 1
  for (int lv = 0; lv < T.n_levels; ++lv) {
    if (live)
      for (int o = T.lvl[lv] + slot; o < T.lvl[lv + 1]; o += kSlots)
        ref(b, T.oloc[o]).at(0) = eval0(T, b, o);
    __syncthreads();
  }
  for (int k = 1; k <= T.K; ++k) {
    const double kf = (double)k;
    if (live)
      for (int i = slot; i < T.n_eq; i += kSlots)
        h(k, i) = ref(b, T.rhs[i])(k - 1) / kf;
    __syncthreads();
    for (int lv = 0; lv < T.n_levels; ++lv) {
      if (live)
        for (int o = T.lvl[lv] + slot; o < T.lvl[lv + 1]; o += kSlots)
          ref(b, T.oloc[o]).at(k) = eval_k(T, b, o, k);
      __syncthreads();
    }
  }

  if (!live) return;
  if (slot == 0) {  // norms over the state (and sv-func) columns
    double m1 = 0.0, mo = 0.0, m0 = 0.0;
    for (int j = 0; j < T.n_norm; ++j) {
      const Ref r = ref(b, T.norm[j]);
      m1 = nmax(m1, fabs(r(T.K - 1)));
      mo = nmax(mo, fabs(r(T.K)));
      m0 = nmax(m0, fabs(r(0)));
    }
    norms[lane] = m1;
    norms[Bs + lane] = mo;
    norms[2 * Bs + lane] = m0;
  }
  for (int i = slot; i < T.n_eq; i += kSlots)
    for (int k = 0; k <= T.K; ++k)
      out[((size_t)i * (T.K + 1) + k) * Bs + lane] = h(k, i);
}

}  // namespace

extern "C" int hy_jet_rolled_f64(const int* itab, const double* dtab,
                                 const double* state, const double* pars,
                                 const double* t, double* H, double* C,
                                 double* V, double* out, double* norms, int B,
                                 void* stream) {
  const int blocks = (B + kLanes - 1) / kLanes;
  jet_rolled_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      itab, dtab, state, pars, t, H, C, V, out, norms, B);
  return (int)cudaGetLastError();
}
