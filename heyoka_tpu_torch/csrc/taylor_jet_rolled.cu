// Rolled Taylor jet for huge tapes (kernel B3), in f64, for NVIDIA Hopper
// (sm_90a).
//
// Replaces make_dd_jet_kernel_rolled (heyoka_tpu/taylor/pallas_phase.py
// :1842, with its sv_extra rows :1896-1903).  Same contract as hy_jet_f64
// (taylor_jet.cu): the order-0 state, parameters and time in; the state
// columns' coefficients, then the sv-func columns' (the event equations),
// (n_eq + n_out, K+1, B), and the per-lane norms of orders K-1, K and 0
// out.  What it keeps of the
// TPU kernel: the coefficients live in the row classes of taylor/rows.py,
// the orders run in loops and the convolutions have dynamic trip counts.
// What it drops: the two-f32 arithmetic, the f32 tail and the per-lane
// scaling (the H100 has f64).  The tables come from taylor/jet_rolled.py
// (RolledTape, layout in `enum RHdr`); every operand is read through its
// location word (class above bit kClsShift, row in the class buffer below).
//
// One lane's coefficients, in this order, as doubles:
//   H [K+1][WH]  the full history of every column a recurrence reads at
//                lower orders: the state, the time, the roots of the
//                alias chains (order major, so that a level's items read
//                neighbouring rows of one order);
//   A [NA]       order 0 of each literal alias (rows._aliases): a column
//                `a + literal` or `literal * a` whose orders k >= 1 are its
//                root's times the literals of its chain, applied one
//                multiply after the other (AliasRec);
//   C [WC]       the current order of the columns read only at the order
//                they are produced.
// V [WV] (literals and parameters, zero above order 0) stays in global
// memory, one lane's row after another, read at order 0 and to fill S, the
// literals the alias chains multiply by, in shared memory.
//
// Design: one lane a block of 64, 128 or 256 threads, about three items a
// thread in the tape's widest pass (jet_rolled.block_threads: idle threads
// cost more than they gain).  The lane's H, A and C live in the block's
// dynamic shared memory where an SM holds two such blocks or more (up to
// mascon-256, 112,104 B a block), else in a global scratch buffer of the
// same layout, one region per block, 512 threads an SM walking over the
// lanes (mascon-512: 1,033 history rows of its 4,105 H rows, since 3,072
// are aliases, 214,488 B a lane, would leave one block alone on an SM);
// the code is the same.  jet_rolled.block_layout decides.  The block's
// threads share out each level's items and a __syncthreads() closes each
// level, as the columns of one level are independent.  Order 0 computes every op column; orders
// k >= 1 skip the aliases (their items are not in the order-k list, and a
// level left empty costs no barrier).  The item lists are segments, one
// per plan group: an instance-regular group gives its op and arity once
// and its items as fixed-size records [out, operands...], each operand
// resolved in the order-k lists where an alias is among them (root row
// and literals, no alias-table read); a sum group of mixed arity reads its
// records through an offset table, and one of wide sums (mascon's three
// 514-operand sums) gives each item to a warp: 32 operands a chunk into a
// staging row, added by one thread in operand order.
//
// What bounds it on this card: the latency of a lane-jet's chain of 133
// barrier-closed passes (7 an order) and the instructions its SM runs
// (tools/rolled_scan.py, clock64 after each barrier of block 0).  A pass
// costs ~2k cycles whatever its items; at mascon-512 the two 1,536-item
// product levels and the three 514-operand sums (a dependent add every
// ~29 cycles, which bit equality with the previous design keeps in
// operand order) take most of a lane-jet.  Every thread walks every
// segment of a pass, so a block's idle threads cost instruction slots:
// hence the small blocks, every read a load from shared memory (or L2)
// and each literal multiply unconditional (by 1.0 where absent, which is
// exact).
// ptxas gives every instance 128 registers a thread, so an SM holds 512
// threads: two blocks of 256 on the global layout.
//
// Every coefficient is the expression of the design this one replaced
// (eight lanes a block, the class buffers in global memory), the terms
// summed in the same order, so that a rolled jet gives the same
// bits, up to the sign of a zero: an alias's order k is its root's times
// its literals, where the old kernel added the literals' zero terms to it
// (a zero added to -0.0 gives +0.0, and 0 * inf gives NaN).  The plain
// torch twin is jet_rolled.jet_rolled_plain.  Build with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "taylor_common.cuh"

namespace {

// header of the int32 table `it` (taylor/jet_rolled.py _RHDR): sizes, then
// offsets of the int sub-tables in `it` and of the f64 ones in `dt`
enum RHdr {
  R_NEQ, R_K, R_WH, R_WC, R_WV, R_NA, R_NS, R_TROW, R_NLEV, R_NC, R_NPC,
  R_NNORM, R_RHS, R_NORM, R_CROWS, R_PROWS, R_PIDX, R_SROWS, R_ALIAS,
  R_LVL0, R_LVLK, R_SEG, R_REC, R_OFF, R_D_CVALS, R_D_ALPHA, R_NOUT,
  R_OUTC
};

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have
constexpr int kClsShift = 28;     // jet_rolled.CLS_SHIFT
constexpr int kRowMask = (1 << kClsShift) - 1;
constexpr int kAlias = 3;         // jet_rolled.A
constexpr int kSegInts = 6;       // jet_rolled.SEG_INTS
constexpr int kSegWide = -1;      // jet_rolled.SEG_WIDE (SEG_VAR is 0)
constexpr int kSumBatch = 4;      // loads in flight per thread in a sum
constexpr unsigned kFull = 0xffffffffu;

// An alias: its root's H row and the S indices of its chain's literals,
// innermost first (-1: none), as jet_rolled packs them.
struct AliasRec {
  int root, s0, s1, pad;
};

struct RTape {
  int n_eq, K, WH, WC, WV, NA, NS, time_row, n_levels, n_const, n_pcol,
      n_norm;
  const int *rhs, *norm, *crows, *prows, *pidx, *srows, *lvl0, *lvlk, *seg,
      *rec, *off;
  const AliasRec* alias;
  const double *cvals, *alpha;
};

__device__ RTape load_rtape(const int* __restrict__ it,
                            const double* __restrict__ dt) {
  RTape T;
  T.n_eq = it[R_NEQ];
  T.K = it[R_K];
  T.WH = it[R_WH];
  T.WC = it[R_WC];
  T.WV = it[R_WV];
  T.NA = it[R_NA];
  T.NS = it[R_NS];
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
  T.srows = it + it[R_SROWS];
  T.alias = reinterpret_cast<const AliasRec*>(it + it[R_ALIAS]);
  T.lvl0 = it + it[R_LVL0];
  T.lvlk = it + it[R_LVLK];
  T.seg = it + it[R_SEG];
  T.rec = it + it[R_REC];
  T.off = it + it[R_OFF];
  T.cvals = dt + it[R_D_CVALS];
  T.alpha = dt + it[R_D_ALPHA];
  return T;
}

// One lane's coefficients: H [K+1][WH], A [NA], C [WC] in shared memory
// or the block's scratch; S [NS] (the alias chains' literals), Z (a zero:
// a literal above order 0) and a staging double a thread in shared
// memory; V [WV] in global memory.
struct Bufs {
  double *H, *A, *C, *S, *Z, *stage;
  const double* V;
  int WH;
};

// order 0 of a location
__device__ __forceinline__ double val0(const Bufs& L, int loc) {
  const int row = loc & kRowMask;
  switch (loc >> kClsShift) {
    case 0: return L.H[row];
    case 1: return L.C[row];
    case 2: return L.V[row];
    default: return L.A[row];
  }
}

// A column at orders j >= 1 (j >= 0 for an H row): p[j * stride], times
// an alias's literals in turn (1.0 where it has fewer than two: a multiply
// by 1.0 is exact, and cheaper than a select).  A C row holds its current
// order only (stride 0, read at whatever order is asked, as before); a
// literal is zero above order 0 (Z).  On the smem layout every p is
// shared, so the reads are shared-memory loads.
struct Ref {
  const double* p;
  int stride;
  double s0, s1;
  __device__ double operator()(int j) const {
    return s1 * (s0 * p[j * stride]);
  }
};

__device__ __forceinline__ Ref alias_ref(const Bufs& L, int root, int s0,
                                          int s1) {
  return Ref{L.H + root, L.WH, s0 >= 0 ? L.S[s0] : 1.0,
             s1 >= 0 ? L.S[s1] : 1.0};
}

// a location that is not an alias
__device__ __forceinline__ Ref plain_ref(const Bufs& L, int loc) {
  const int row = loc & kRowMask;
  switch (loc >> kClsShift) {
    case 0: return Ref{L.H + row, L.WH, 1.0, 1.0};
    case 1: return Ref{L.C + row, 0, 1.0, 1.0};
    default: return Ref{L.Z, 0, 1.0, 1.0};
  }
}

// any location, an alias through the alias table
__device__ __forceinline__ Ref refk(const RTape& T, const Bufs& L,
                                     int loc) {
  if ((loc >> kClsShift) != kAlias) return plain_ref(L, loc);
  const AliasRec a = T.alias[loc & kRowMask];
  return alias_ref(L, a.root, a.s0, a.s1);
}

// an operand of a record whose operands take `per` ints: the word alone
// (an alias through the alias table), or the word, the alias's root row
// and its S indices plus one (o1, o2 unused for per 1)
__device__ Ref opref_w(const RTape& T, const Bufs& L, int per, int o0,
                       int o1, int o2) {
  if (per == 1) return refk(T, L, o0);
  if ((o0 >> kClsShift) != kAlias) return plain_ref(L, o0);
  return alias_ref(L, o1, (o2 & 0xffff) - 1, (o2 >> 16) - 1);
}

// order j of a location (the reads are inlined: the rhs rows, the norms
// and the event rows read through them, and an outlined call costs the
// passes registers and spills)
__device__ __forceinline__ double value(const RTape& T, const Bufs& L,
                                        int loc, int j) {
  return j == 0 ? val0(L, loc) : refk(T, L, loc)(j);
}

// store order k of an op column: an H row at order k, a C row in its one
// slot, an alias's order 0 (an alias is computed at order 0 only)
__device__ void store(const Bufs& L, int loc, int k, double v) {
  const int row = loc & kRowMask;
  switch (loc >> kClsShift) {
    case 0: L.H[k * L.WH + row] = v; break;
    case 1: L.C[row] = v; break;
    default: L.A[row] = v; break;
  }
}

// An operand of a record: its location word and, where the record's
// operands take RESOLVED ints, an alias's root row and its literals' S
// indices plus one (16 bits each).
struct Opd {
  int w, root, sp;
};

__device__ Opd load_opd(const int* o, int per) {
  Opd d{o[0], 0, 0};
  if (per > 1) {
    d.root = o[1];
    d.sp = o[2];
  }
  return d;
}

__device__ Ref opd_ref(const RTape& T, const Bufs& L, const Opd& d,
                       int per) {
  return opref_w(T, L, per, d.w, d.root, d.sp);
}

// An item of a unary or binary op (mul, div, sqrt, pow): its own location,
// its operands and its exponent, loaded together.
struct Item {
  int own;
  Opd a, b;
  double alpha;
};

__device__ Item load_item(const RTape& T, const int* r, int ar, int per,
                          int op, int aux, int i) {
  Item it;
  it.own = r[0];
  it.a = load_opd(r + 1, per);
  it.b = ar > 1 ? load_opd(r + 1 + per, per) : Opd{0, 0, 0};
  it.alpha = op == OP_POW ? T.alpha[aux + i] : 0.0;
  return it;
}

// order 0 of a unary or binary item
__device__ double eval0_item(const Bufs& L, int op, const Item& it) {
  const double a0 = val0(L, it.a.w);
  switch (op) {
    case OP_MUL: return a0 * val0(L, it.b.w);
    case OP_DIV: return a0 / val0(L, it.b.w);
    case OP_SQRT: return sqrt(a0);
    default: return pow0(a0, it.alpha);
  }
}

// order k >= 1 of a unary or binary item (its own column an H row for
// div, sqrt and pow), from the lower orders; the terms in j ascending, as
// the previous design summed them, the ones that read an order 0 peeled
__device__ double eval_k_item(const RTape& T, const Bufs& L, int op,
                              const Item& it, int per, int k) {
  switch (op) {
    case OP_MUL: {  // sum_{j=0..k} a_j b_{k-j}; a square resolves once
      const Ref A = opd_ref(T, L, it.a, per);
      const Ref Bb = it.b.w == it.a.w ? A : opd_ref(T, L, it.b, per);
      double v = 0.0;
      v += val0(L, it.a.w) * Bb(k);
      for (int j = 1; j < k; ++j) v += A(j) * Bb(k - j);
      v += A(k) * val0(L, it.b.w);
      return v;
    }
    case OP_DIV: {  // (a_k - sum_{j<k} q_j b_{k-j}) / b_0
      const Ref Bb = opd_ref(T, L, it.b, per), Q = plain_ref(L, it.own);
      double sacc = 0.0;
      for (int j = 0; j < k; ++j) sacc += Q(j) * Bb(k - j);
      return (opd_ref(T, L, it.a, per)(k) - sacc) / val0(L, it.b.w);
    }
    case OP_SQRT: {  // (a_k - sum_{j=1..k-1} q_j q_{k-j}) / (2 q_0)
      const Ref Q = plain_ref(L, it.own);
      double sacc = 0.0;
      for (int j = 1; j < k; ++j) sacc += Q(j) * Q(k - j);
      return (opd_ref(T, L, it.a, per)(k) - sacc) / (2.0 * Q(0));
    }
    default: {  // (sum_{j<k} (alpha (k-j) - j) q_j b_{k-j}) / (k b_0)
      const Ref Q = plain_ref(L, it.own), Ak = opd_ref(T, L, it.a, per);
      double s1 = 0.0, s2 = 0.0;
      for (int j = 0; j < k; ++j) {
        const double q = Q(j), bb = Ak(k - j);
        s1 += (q * bb) * (double)(k - j);
        s2 += ((double)j * q) * bb;
      }
      return (s1 * it.alpha - s2) / ((double)k * val0(L, it.a.w));
    }
  }
}

// order k of a sum with operands a[0], a[per], ... in operand order; the
// loads of a batch (the words, then the values) are issued together
__device__ double sum_k(const RTape& T, const Bufs& L, const int* a,
                        int per, int na, int k) {
  double v = 0.0;
  for (int q0 = 0; q0 < na; q0 += kSumBatch) {
    const int m = min(kSumBatch, na - q0);
    Opd d[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u)
      if (u < m) d[u] = load_opd(a + (q0 + u) * per, per);
    double x[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u)
      if (u < m)
        x[u] = k == 0 ? val0(L, d[u].w) : opd_ref(T, L, d[u], per)(k);
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u)
      if (u < m) v = (q0 + u == 0) ? x[u] : v + x[u];
  }
  return v;
}

// order k of a wide sum, by the calling warp: 32 operands a chunk, each
// lane reading one into the warp's staging row and lane 0 adding them in
// operand order (the result is lane 0's).  Each lane holds the operand
// ints of the next kAhead chunks, so the loads of a chunk's words are in
// flight while the chunks before it are summed.
constexpr int kAhead = 4;

__device__ double warp_sum(const RTape& T, const Bufs& L, const int* a,
                           int per, int na, int k) {
  const int l = threadIdx.x & 31;
  double* st = L.stage + (threadIdx.x & ~31);
  Opd d[kAhead];
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    const int q = 32 * c + l;
    d[c] = q < na ? load_opd(a + q * per, per) : Opd{0, 0, 0};
  }
  double v = 0.0;
  for (int base = 0; base < na; base += 32 * kAhead) {
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int b = base + 32 * c;
      if (b >= na) break;  // uniform over the warp
      const int q = b + l;
      double x = 0.0;
      if (q < na)
        x = k == 0 ? val0(L, d[c].w) : opd_ref(T, L, d[c], per)(k);
      const int qn = q + 32 * kAhead;  // this slot's next chunk
      d[c] = qn < na ? load_opd(a + qn * per, per) : Opd{0, 0, 0};
      st[l] = x;
      __syncwarp();
      if (l == 0) {
        const int m = min(32, na - b);
        if (m == 32) {
          v = b == 0 ? st[0] : v + st[0];
#pragma unroll
          for (int u = 1; u < 32; ++u) v += st[u];
        } else {
          for (int u = 0; u < m; ++u) v = (b == 0 && u == 0) ? st[u]
                                                            : v + st[u];
        }
      }
      __syncwarp();
    }
  }
  return v;
}

// One level at order k: its segments' items shared out over the block's
// threads (a warp an item for wide sums).  The caller closes the level
// with a barrier.
template <int NT>
__device__ void level(const RTape& T, const Bufs& L, int s0, int s1,
                      int k) {
  const int tid = threadIdx.x;
  for (int s = s0; s < s1; ++s) {
    const int* S = T.seg + s * kSegInts;
    const int op = S[0], n = S[1], ar = S[3], aux = S[4], per = S[5];
    const int* rec = T.rec + S[2];
    if (ar == kSegWide) {
      for (int i = tid >> 5; i < n; i += NT / 32) {
        const int b = T.off[aux + i];
        const int* r = rec + b;
        const int na = (T.off[aux + i + 1] - b - 1) / per;
        const double v = warp_sum(T, L, r + 1, per, na, k);
        if ((tid & 31) == 0) store(L, r[0], k, v);
      }
      continue;
    }
    if (op == OP_SUM) {
      for (int i = tid; i < n; i += NT) {
        const int* r;
        int na;
        if (ar > 0) {
          r = rec + i * (1 + ar * per);
          na = ar;
        } else {
          const int b = T.off[aux + i];
          r = rec + b;
          na = (T.off[aux + i + 1] - b - 1) / per;
        }
        store(L, r[0], k, sum_k(T, L, r + 1, per, na, k));
      }
      continue;
    }
    const int rs = 1 + ar * per;  // unary and binary ops: fixed records
    for (int i = tid; i < n; i += NT) {
      const Item it = load_item(T, rec + i * rs, ar, per, op, aux, i);
      const double v =
          k == 0 ? eval0_item(L, op, it) : eval_k_item(T, L, op, it, per, k);
      store(L, it.own, k, v);
    }
  }
}

template <int NT, bool kSmem>
__global__ void __launch_bounds__(NT)
jet_rolled_kernel(const int* __restrict__ it, const double* __restrict__ dt,
                  const double* __restrict__ state,
                  const double* __restrict__ pars,
                  const double* __restrict__ t, double* __restrict__ scratch,
                  double* __restrict__ Vg, double* __restrict__ out,
                  double* __restrict__ norms, long long* __restrict__ trace,
                  int B, int lane_dbl) {
  extern __shared__ double smem[];
  const RTape T = load_rtape(it, dt);
  const int tid = threadIdx.x, K = T.K, WH = T.WH;
  const size_t Bs = (size_t)B;
  // shared memory: the lane's H, A and C (smem layout), S, the staging row
  double* base =
      kSmem ? smem : scratch + (size_t)blockIdx.x * (size_t)lane_dbl;
  Bufs L;
  L.H = base;
  L.A = base + (size_t)(K + 1) * WH;
  L.C = L.A + T.NA;
  L.S = smem + (kSmem ? lane_dbl : 0);
  L.Z = L.S + T.NS;
  L.stage = L.Z + 1;
  if (tid == 0) *L.Z = 0.0;
  L.WH = WH;
  // the clock after each barrier of block 0's first lane, where a trace
  // buffer is given (tools/rolled_scan.py): one predicated store a pass
  const bool tr = trace != nullptr && blockIdx.x == 0 && tid == 0;
  int n_tr = 0;
  if (tr) trace[n_tr++] = clock64();
  // the lanes are the same for every thread of the block, so the barriers
  // inside the loop are uniform
  for (int lane = blockIdx.x; lane < B; lane += gridDim.x) {
    double* V = Vg + (size_t)lane * T.WV;
    L.V = V;
    // seeds: the state (H rows 0..n_eq-1), the literals and parameters
    // (V rows, then S from them), the time row (t, 1, 0, ...)
    for (int i = tid; i < T.n_eq; i += NT) L.H[i] = state[i * Bs + lane];
    for (int j = tid; j < T.n_const; j += NT) V[T.crows[j]] = T.cvals[j];
    for (int j = tid; j < T.n_pcol; j += NT)
      V[T.prows[j]] = pars[(size_t)T.pidx[j] * Bs + lane];
    if (T.time_row >= 0)
      for (int k = tid; k <= K; k += NT)
        L.H[k * WH + T.time_row] = k == 0 ? t[lane] : (k == 1 ? 1.0 : 0.0);
    __syncthreads();
    for (int j = tid; j < T.NS; j += NT) L.S[j] = V[T.srows[j]];
    __syncthreads();
    if (tr && lane == 0) trace[n_tr++] = clock64();

    // order 0 of every op column, level by level, before any order 1: a C
    // row holds its order-0 value until its column overwrites it at order 1
    for (int lv = 0; lv < T.n_levels; ++lv) {
      level<NT>(T, L, T.lvl0[lv], T.lvl0[lv + 1], 0);
      __syncthreads();
      if (tr && lane == 0) trace[n_tr++] = clock64();
    }
    for (int k = 1; k <= K; ++k) {
      const double kf = (double)k;
      for (int i = tid; i < T.n_eq; i += NT)
        L.H[k * WH + i] = value(T, L, T.rhs[i], k - 1) / kf;
      __syncthreads();
      if (tr && lane == 0) trace[n_tr++] = clock64();
      for (int lv = 0; lv < T.n_levels; ++lv) {
        const int s0 = T.lvlk[lv], s1 = T.lvlk[lv + 1];
        if (s0 == s1) continue;  // only aliases: nothing to compute
        level<NT>(T, L, s0, s1, k);
        __syncthreads();
        if (tr && lane == 0) trace[n_tr++] = clock64();
      }
    }

    if (tid < 32) {  // norms over the state (and sv-func) columns
      double m1 = 0.0, mo = 0.0, m0 = 0.0;
      for (int j = tid; j < T.n_norm; j += 32) {
        const int loc = T.norm[j];
        m1 = nmax(m1, fabs(value(T, L, loc, K - 1)));
        mo = nmax(mo, fabs(value(T, L, loc, K)));
        m0 = nmax(m0, fabs(val0(L, loc)));
      }
      for (int o = 16; o > 0; o >>= 1) {
        m1 = nmax(m1, __shfl_xor_sync(kFull, m1, o));
        mo = nmax(mo, __shfl_xor_sync(kFull, mo, o));
        m0 = nmax(m0, __shfl_xor_sync(kFull, m0, o));
      }
      if (tid == 0) {
        norms[lane] = m1;
        norms[Bs + lane] = mo;
        norms[2 * Bs + lane] = m0;
      }
    }
    // out (n_eq + n_out, K+1, B): the state rows, then the sv-func rows
    // (the event equations), each read through its location word as the
    // norms read it (an alias through its root and literals)
    const int K1 = K + 1;
    for (int ik = tid; ik < T.n_eq * K1; ik += NT) {
      const int i = ik / K1, k = ik - i * K1;
      out[(size_t)ik * Bs + lane] = L.H[k * WH + i];
    }
    const int n_out = it[R_NOUT];
    const int* outc = it + it[R_OUTC];
    for (int jk = tid; jk < n_out * K1; jk += NT) {
      const int j = jk / K1, k = jk - j * K1;
      out[(size_t)(T.n_eq * K1 + jk) * Bs + lane] = value(T, L, outc[j], k);
    }
    __syncthreads();  // the next lane reuses the buffers
    if (tr && lane == 0) trace[n_tr++] = clock64();
  }
}

template <int NT, bool kSmem>
int launch(const int* itab, const double* dtab, const double* state,
           const double* pars, const double* t, double* scratch, double* V,
           double* out, double* norms, long long* trace, int B, int smem,
           int lane_dbl, int blocks, cudaStream_t stream) {
  // a kernel may take more than 48 KB of dynamic shared memory only once
  // it has been allowed to: once per instance, before its first launch
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        jet_rolled_kernel<NT, kSmem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  jet_rolled_kernel<NT, kSmem><<<blocks, NT, smem, stream>>>(
      itab, dtab, state, pars, t, scratch, V, out, norms, trace, B,
      lane_dbl);
  return (int)cudaGetLastError();
}

template <bool kSmem>
int launch_nt(int threads, const int* itab, const double* dtab,
              const double* state, const double* pars, const double* t,
              double* scratch, double* V, double* out, double* norms,
              long long* trace, int B, int smem, int lane_dbl, int blocks,
              cudaStream_t s) {
  switch (threads) {
    case 64:
      return launch<64, kSmem>(itab, dtab, state, pars, t, scratch, V, out,
                               norms, trace, B, smem, lane_dbl, blocks, s);
    case 128:
      return launch<128, kSmem>(itab, dtab, state, pars, t, scratch, V, out,
                                norms, trace, B, smem, lane_dbl, blocks, s);
    case 256:
      return launch<256, kSmem>(itab, dtab, state, pars, t, scratch, V, out,
                                norms, trace, B, smem, lane_dbl, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One lane a block, `threads` of 64, 128 or 256; `smem` bytes of
// dynamic shared memory (jet_rolled.smem_bytes).  `scratch` null: the
// lane's H, A and C (lane_dbl doubles) in shared memory, `blocks` = B;
// else `scratch` holds `blocks` regions of lane_dbl doubles and the blocks
// walk over the lanes.  `V`: (B, WV) doubles of scratch for the literals
// (jet_rolled._launch_cfg).  `trace`: null, or room for the clock after
// every barrier of block 0's first lane (jet_rolled.trace_len).
extern "C" int hy_jet_rolled_f64(const int* itab, const double* dtab,
                                 const double* state, const double* pars,
                                 const double* t, double* scratch, double* V,
                                 double* out, double* norms,
                                 long long* trace, int B, int threads,
                                 int smem, int lane_dbl, int blocks,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (smem > kSmemMax || (scratch == nullptr && blocks != B))
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr)
    return launch_nt<false>(threads, itab, dtab, state, pars, t, scratch, V,
                            out, norms, trace, B, smem, lane_dbl, blocks, s);
  return launch_nt<true>(threads, itab, dtab, state, pars, t, scratch, V,
                         out, norms, trace, B, smem, lane_dbl, blocks, s);
}
