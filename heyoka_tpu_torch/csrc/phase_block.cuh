// The block engine of the phase kernels: kernel B4 (taylor_phase.cu, f64,
// the whole rule set) and kernel T2 (proto_phase.cu, f32, sum/mul/pow).
// Both run Taylor orders lo..K of every column of a tape plan, in place on
// the caller's (K+1, W, B) buffer, lane index minor; they differ in their
// scalar type and their rules only, which a kernel passes as a functor:
//
//   Rule::order_k(T, aux, syn, J, S, Q, op, c, o, k)  order k of column c
//   Rule::synth(T, aux, J, op, o, j)                  order j of the Kepler
//                                                     synthetic row of c
//
// with J and S one lane's views of the coefficients and synthetic rows
// (`at(k, c)`), Q its view of the dense-series rows (`at(k, r)`: the
// read-only (K+1, n_ser, B) buffer kernel S1 filled before the launch; B4
// copies order k of a series column from it, on both layouts, since the
// smem layout stages only orders below lo of an op column and writes
// orders lo..K of it back).  The tables are those of taylor/jet_phase.py
// (`enum Hdr` of taylor_common.cuh), with the level table; `syn[o]` is
// the synthetic row of a Kepler column and the series row of a series
// column.
//
// Layout.  A block owns L consecutive lanes.  On the smem layout its
// dynamic shared memory holds, in this order: the f64 tables (dtab) where
// the launch made room, the lanes' coefficients as [K+1][W][L] and their
// synthetic rows as [K+1][n_syn][L] (lane index minor, as Jets<L> of
// taylor_jet.cu), then the int tables (itab).  The block stages in
// orders 0..lo-1 of every column and all orders of the columns it never
// writes (literals, parameters, time: the columns from n_w = n_eq + n_ops
// on), by rows of L contiguous lanes, with cp.async a coefficient at a
// time; it writes orders lo..K of columns 0..n_w-1 back at the end.  The
// synthetic rows never leave shared memory.  Where a block's shared memory
// holds too few lanes for a row of them to fill a 32-byte sector (fewer
// than four f64 lanes or eight f32 ones: W + n_syn > 363 at K = 19), the
// same code runs on the global layout (jet_phase.block_shape): the block
// works in place in the caller's buffer (the same rows, B elements apart
// instead of L) and the synthetic rows go to a (K+1, n_syn, B) scratch
// buffer.
//
// Passes.  Per order k, one pass per level of the plan: all (row, lane)
// items of the level's groups, shared out over the block's threads, one
// __syncthreads() closing the pass; then one pass for the synthetic rows
// of order k together with the state rows of order k+1 (a[k+1][i] =
// a[k][rhs[i]] / (k+1)), which read columns at order k only.  A first
// pass makes the synthetic rows below lo and the state rows of order lo.
// A level's items are independent at order k: every operand of a column
// lies in an earlier level (jet_phase.check_levels asserts it when the
// tables are packed), and the rules read their own column, the aux columns
// and the synthetic rows below order k only.
//
// Bits.  Each item is one thread's and keeps the expression and the term
// order of the one-thread-per-lane kernels this engine replaced (the
// rules' term loops are unrolled by four, so that the loads of a few terms
// are in flight together; the order of the adds does not change); with
// -fmad=false the outputs equal theirs bit for bit, on every block shape
// and on both layouts (tools/same_bits.py, chip_smoke.py phase 10).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "taylor_common.cuh"

namespace {

constexpr int kPhaseMaxThreads = 256;
constexpr int kPhaseSmemMax = 232448;  // dynamic shared memory a block may have

// The rows of a block's lanes, n rows an order: row (k, c) holds the
// block's lanes, ld elements from the next row.
template <typename T, bool kSmem>
struct BlockRows {
  T* p;
  int n, ld;
  __device__ T& at(int k, int c, int l) const {
    if constexpr (kSmem) {
      return p[(k * n + c) * ld + l];
    } else {
      return p[((size_t)k * n + (size_t)c) * (size_t)ld + (size_t)l];
    }
  }
};

// One lane's view of them: what a rule reads.
template <typename T, bool kSmem>
struct LaneRows {
  BlockRows<T, kSmem> R;
  int l;
  __device__ T& at(int k, int c) const { return R.at(k, c, l); }
};

template <typename T>
__device__ inline void copy_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
}

// The staging of a block's rows: rows (k, c), k0 <= k < k1 and c0 <= c <
// c1, of its nl live lanes.  Item i is row i / nl of the range and lane
// i % nl, so that a warp's items are consecutive lanes of a row: the
// copies read or write the caller's buffer by rows of the block's lanes.
struct StageRange {
  int W, k0, k1, c0, c1;
  __device__ int items(int nl) const { return (k1 - k0) * (c1 - c0) * nl; }
  __device__ int row(int rl) const {  // rl: the range's row, in order
    const int nc = c1 - c0, kk = rl / nc;
    return (k0 + kk) * W + c0 + (rl - kk * nc);
  }
};

// Into the block's rows s from the caller's buffer g (at the block's
// first lane, B elements a row), asynchronously.
template <typename T>
__device__ void stage_in(T* s, const T* g, const StageRange& R, int L,
                         int nl, size_t B) {
  const int n = R.items(nl);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int rl = i / nl, l = i - rl * nl, r = R.row(rl);
    copy_async(s + r * L + l, g + (size_t)r * B + l);
  }
}

// The same rows back from the block's rows s to the caller's buffer g.
template <typename T>
__device__ void stage_out(T* g, const T* s, const StageRange& R, int L,
                          int nl, size_t B) {
  const int n = R.items(nl);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int rl = i / nl, l = i - rl * nl, r = R.row(rl);
    g[(size_t)r * B + l] = s[r * L + l];
  }
}

// One lane's view of the dense-series rows: row (k, r) of a (K+1, n, B)
// buffer in global memory, read only.
template <typename T>
struct SeriesRows {
  const T* p;  // at the lane
  int n;
  size_t ld;
  __device__ T at(int k, int r) const {
    return p[((size_t)k * (size_t)n + (size_t)r) * ld];
  }
};

// The tables the passes read, in shared memory or in place.
struct PhaseTables {
  Tape T;
  const int *aux, *syn, *lvl, *cop, *sync;
  int n_lv, n_syn, n_w;
};

__device__ PhaseTables phase_tables(const int* it, const double* dt) {
  PhaseTables P;
  P.T = load_tape(it, dt);
  P.aux = it + it[H_AUX];
  P.syn = it + it[H_SYN];
  P.lvl = it + it[H_LVL];
  P.cop = it + it[H_COP];
  P.sync = it + it[H_SYNC];
  P.n_lv = it[H_NLV];
  P.n_syn = it[H_NSYN];
  P.n_w = P.lvl[P.n_lv];
  return P;
}

// The synthetic rows of orders j0..j1-1 and the state rows of order ks.
template <typename T, class Rule, bool kSmem>
__device__ void tail_pass(const PhaseTables& P, const BlockRows<T, kSmem>& J,
                          const BlockRows<T, kSmem>& S, int j0, int j1,
                          int ks, int nl) {
  const int n_syn = P.n_syn;
  const int ns = (j1 - j0) * n_syn * nl, n = ns + P.T.n_eq * nl;
  const T kf = (T)ks;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < ns) {
      const int rl = i / nl, l = i - rl * nl;
      const int jj = rl / n_syn, r = rl - jj * n_syn;
      const int o = P.sync[r];
      S.at(j0 + jj, r, l) = Rule::synth(P.T, P.aux, LaneRows<T, kSmem>{J, l},
                                        P.cop[o], o, j0 + jj);
    } else {
      const int q = i - ns, s = q / nl, l = q - s * nl;
      J.at(ks, s, l) = J.at(ks - 1, P.T.rhs[s], l) / kf;
    }
  }
}

// Orders lo..K of the block's lanes (lo <= K); kPasses false: the
// staging alone, rows in and back on the smem layout, which leaves the
// orders it would write undefined (jet_phase.stage times it so).
template <typename T, class Rule, bool kSmem, bool kPasses = true>
__device__ void phase_block(const int* __restrict__ it_g,
                            const double* __restrict__ dt_g,
                            T* __restrict__ tc, T* __restrict__ syn_g,
                            const T* __restrict__ ser_g, int n_ser, int B,
                            int lo, int L, int n_it, int n_dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane0 = blockIdx.x * L;
  // at least 0 (a block has a lane): nvcc then divides by nl unsigned,
  // which keeps the global-layout instance from spilling
  const int nl = max(0, min(L, B - lane0));
  const int W = it_g[H_W], K = it_g[H_K], n_syn = it_g[H_NSYN];
  if (lo > K) return;  // no order to compute
  const size_t Bs = (size_t)B;
  double* sdt = reinterpret_cast<double*>(smem_raw);
  T* sj = reinterpret_cast<T*>(sdt + n_dt);
  const int jn = kSmem ? (K + 1) * W * L : 0;
  const int sn = kSmem ? (K + 1) * n_syn * L : 0;
  int* sit = reinterpret_cast<int*>(sj + jn + sn);
  const int n_w = it_g[it_g[H_LVL] + it_g[H_NLV]];
  const StageRange lower{W, 0, lo, 0, W}, fixed{W, lo, K + 1, n_w, W},
      out{W, lo, K + 1, 0, n_w};
  BlockRows<T, kSmem> J, S;
  if constexpr (kSmem) {
    J = BlockRows<T, kSmem>{sj, W, L};
    S = BlockRows<T, kSmem>{sj + jn, n_syn, L};
    stage_in(sj, tc + lane0, lower, L, nl, Bs);
    stage_in(sj, tc + lane0, fixed, L, nl, Bs);
  } else {
    J = BlockRows<T, kSmem>{tc + lane0, W, B};
    S = BlockRows<T, kSmem>{syn_g == nullptr ? nullptr : syn_g + lane0,
                            n_syn, B};
  }
  for (int i = tid; i < n_dt; i += nt) sdt[i] = dt_g[i];
  for (int i = tid; i < n_it; i += nt) sit[i] = it_g[i];
  if constexpr (kSmem) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if constexpr (kPasses) {
    const PhaseTables P = n_it ? phase_tables(sit, sdt)
                               : phase_tables(it_g, dt_g);
    const int n_eq = P.T.n_eq;
    tail_pass<T, Rule, kSmem>(P, J, S, 0, lo, lo, nl);
    __syncthreads();
    for (int k = lo; k <= K; ++k) {
      for (int v = 0; v < P.n_lv; ++v) {
        const int c0 = P.lvl[v], n = (P.lvl[v + 1] - c0) * nl;
        for (int i = tid; i < n; i += nt) {
          const int r = i / nl, l = i - r * nl;
          const int c = c0 + r, o = c - n_eq;
          J.at(k, c, l) = Rule::order_k(
              P.T, P.aux, P.syn, LaneRows<T, kSmem>{J, l},
              LaneRows<T, kSmem>{S, l},
              SeriesRows<T>{ser_g == nullptr ? nullptr : ser_g + lane0 + l,
                            n_ser, Bs},
              P.cop[o], c, o, k);
        }
        __syncthreads();
      }
      if (k < K) {
        tail_pass<T, Rule, kSmem>(P, J, S, k, k + 1, k + 1, nl);
        __syncthreads();
      }
    }
  }
  if constexpr (kSmem) stage_out(tc + lane0, sj, out, L, nl, Bs);
}

// A launch of a phase kernel instance on `lanes` lanes and `threads`
// threads a block with `smem` bytes of dynamic shared memory; a kernel may
// take more than 48 KB only once it has been allowed to, once per instance
// (`allowed`).  Returns the launch's CUDA error.
template <typename T, class F>
int launch_phase(F* kernel, bool& allowed, const int* itab,
                 const double* dtab, T* tc, T* syn, const T* ser, int n_ser,
                 int B, int lo, int lanes, int threads, int smem, int n_it,
                 int n_dt, cudaStream_t stream) {
  if (threads < 32 || threads % 32 != 0 || threads > kPhaseMaxThreads ||
      lanes < 1 || smem < 0 || smem > kPhaseSmemMax || lo < 1 || B < 1 ||
      n_ser < 0 || (n_ser > 0 && ser == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPhaseSmemMax);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  kernel<<<(B + lanes - 1) / lanes, threads, (size_t)smem, stream>>>(
      itab, dtab, tc, syn, ser, n_ser, B, lo, lanes, n_it, n_dt);
  return (int)cudaGetLastError();
}

}  // namespace
