// The Taylor jet of dense trig series (kernel S1), in f64, for NVIDIA
// Hopper (sm_90a): every series of a step in one launch of each entry.
//
// f(u) = sum_i a_i(u) sin(P_i(u)) over tables amp (n, q+1) and ph (n,
// d+1) (expr/series.py), at an input affine in time, u = u0 + u1 t, one
// (u0, u1) a lane and a series: orders 0..K of f in t on every lane.
// taylor/series_jet.py splits each series' terms, in table order, into
// two classes (split_of) and lays out one work list of (series, class,
// term chunk) items for a step (SeriesWork):
//
// - class L, a constant amplitude and a linear phase: the jet has the
//   closed form s_m = p1^m / m! sin(p0 + m pi/2), p0 = ph0 + u0 ph1, p1 =
//   ph1 u1, so the class's orders are two matrix products,
//   F_m = (u1^m / m!) sum_t W[m][t] X[t][lane], W[m][t] = +-a_t ph1_t^m
//   (the sign of sin(x + m pi/2) folded in), X = sin p0 for even m and
//   cos p0 for odd m.  Entry S1-L, hy_series_lin_f64.
// - class G, the rest: per (lane, term) the tables shifted by u0
//   (synthetic division; its first pass is Horner's rule) and scaled by
//   u1^j, s_0 = sin p_0, c_0 = cos p_0, s_m = (1/m) sum_j j p_j c_{m-j},
//   c_m = -(1/m) sum_j j p_j s_{m-j}, f_m = sum_j a_j s_{m-j}.  Entry
//   S1-G, hy_series_gen_f64.
//
// Each item writes its orders to a slot of a partial buffer; the entry
// launched last adds each series' slots in slot order (its L chunks, then
// its G chunks) into the side buffer's row of the series: no atomics, the
// same bits on every run of a launch shape.
//
// Not a TPU kernel's counterpart: the JAX package runs the recurrence in
// XLA (_series_jet, heyoka_tpu/expr/series.py:427, a lax.scan over orders
// on (window, n_terms) arrays, with an f32 tail and a power-of-two step
// scale that keep emulated f64 in range; plain f64 needs neither).
//
// What bounds it.  S1-L: a sincos of every (lane, term) pair on the FP64
// units (tens of instructions each) and 2(K+1) flops a pair on the FP64
// tensor cores (tools/roofline.series_lin_flops).  On an H100 at 10,240
// lanes of the ELP2000's class L, the library's sincos alone took 1.42
// ms and the products alone 0.58 ms, together 1.84 ms: the two overlap
// little, and the sincos leads.  Design: a warp owns 32 lanes (16 where
// K >= 32) and walks the item's tiles of 16 terms; each thread forms p0
// for exactly the (term, lane) pairs its B fragment of mma.m16n8k16.f64
// holds, takes one sincos a pair (lin_sincos), and
// feeds the sin to the even orders' product and the cos to the odd
// orders'; W's fragments, packed in fragment order by the wrapper, and
// the tiles' ph0/ph1 stream through a double-buffered cp.async ring
// shared by the block's 4 warps; the epilogue applies u1^m / m! per lane
// through shared memory, written coalesced.  p0 = ph0 + u0 ph1 is formed
// without fma (__dmul_rn, __dadd_rn), as the twin's Horner pass rounds
// it: a phase of 4e4 rad off by an ulp moves sin by 7e-12.
// S1-G: ~350 f64 operations a pair (tools/roofline.series_flops).
// Design: a block of 32 lanes by 4 term slices walks an item's terms
// (thread = slice * 32 + lane, so a warp reads one term's row, a
// broadcast); each thread keeps one term's shifted tables and s/c
// windows in registers and its running order sums f_m over all its terms
// in registers too, kGenOrders orders at a time (a fully unrolled,
// guarded order loop: the window shifts are renamings); shared memory
// holds only the staged rows (double-buffered cp.async) and the final
// sum of the slices in slice order.  Instances by the coefficients a
// term: <5, 1> (up to quartic phase, constant amplitude: ELP2000) and
// <8, 8> (the rest), picked per item.  The order recurrence uses fma();
// the shifts do not.
// Built with -fmad=false like the other kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kSmemMax = 232448;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// S1-L: the linear class on the FP64 tensor cores
// ---------------------------------------------------------------------------

// sin and cos of x for S1-L's pairs: x - k pi/2 by two fma (pi/2 as the
// sum of two doubles; the third part, 1.5e-33, stays below 2e-18 for |k|
// < 2^50), then the Taylor polynomials of sin (through r^17) and cos
// (through r^18), whose first omitted terms are under 2e-18 for |r| <=
// 0.91 (pi/4 and the rounding of k for |x| < 2^50, 1.1e15), and the
// quadrant.  Past |x| = 2^50 it degrades, where an f64 phase has an ulp
// over 0.1 rad; inf and NaN give NaN.  No branch: the library's sincos
// carries a slow path for huge arguments that made S1-L slower inline
// (tools/series_scan.py times both).
__device__ __forceinline__ void lin_sincos(double x, double& s, double& c) {
  const double k = rint(x * 0.6366197723675814);  // 2 / pi
  double r = fma(-k, 1.5707963267948966, x);
  r = fma(-k, 6.123233995736766e-17, r);
  const double z = r * r;
  double ps = 2.8114572543455206e-15;  // (-1)^i / (2i+1)!, i = 8 .. 1
  ps = fma(ps, z, -7.647163731819816e-13);
  ps = fma(ps, z, 1.6059043836821613e-10);
  ps = fma(ps, z, -2.505210838544172e-08);
  ps = fma(ps, z, 2.7557319223985893e-06);
  ps = fma(ps, z, -0.0001984126984126984);
  ps = fma(ps, z, 0.008333333333333333);
  ps = fma(ps, z, -0.16666666666666666);
  const double sr = fma(r * z, ps, r);
  double pc = -1.5619206968586225e-16;  // (-1)^i / (2i)!, i = 9 .. 1
  pc = fma(pc, z, 4.779477332387385e-14);
  pc = fma(pc, z, -1.1470745597729725e-11);
  pc = fma(pc, z, 2.08767569878681e-09);
  pc = fma(pc, z, -2.755731922398589e-07);
  pc = fma(pc, z, 2.48015873015873e-05);
  pc = fma(pc, z, -0.001388888888888889);
  pc = fma(pc, z, 0.041666666666666664);
  pc = fma(pc, z, -0.5);
  const double cr = fma(pc, z, 1.0);
  // sin(r + q pi/2), cos(r + q pi/2) for q = k mod 4
  const int q = (int)(__double2ll_rn(k) & 3);
  const double a = (q & 1) ? cr : sr, b = (q & 1) ? sr : cr;
  s = (q & 2) ? -a : a;
  c = ((q + 1) & 2) ? -b : b;
}

constexpr int kLinTerms = 16;  // k of one m16n8k16 product: a tile's terms
constexpr int kLinWarps = 4;
constexpr int kLinThreads = 32 * kLinWarps;
constexpr int kLinStage = 4;  // tiles a stage of the ring

// doubles of one packed tile: ph0[16], ph1[16], then W's A fragments of
// both parities and MT row tiles, [par][mt][j][thread][2] (a thread's
// elements 2j, 2j+1 side by side: 16-B loads, consecutive threads on
// consecutive addresses)
__host__ __device__ constexpr int lin_tile_doubles(int mt) {
  return 2 * kLinTerms + 2 * mt * 256;
}

// D = A B + D, A 16x16 row-major, B 16x8 column-major, f64.  Fragments
// (thread l, g = l / 4, t = l % 4): a[i] at row g + 8 (i % 2), column t +
// 4 (i / 2); b[i] at row t + 4 i, column g; c[i] at row g + 8 (i / 2),
// column 2 t + i % 2.
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// One item (its tiles of one series' class-L terms) on the block's lanes:
// orders 0..K into part[slot][m][lane].  items[4 * y]: series, first
// tile, tiles, slot.  MT: row tiles of 16 orders a parity (K < 32 MT).
template <int MT>
__global__ void __launch_bounds__(kLinThreads)
series_lin_kernel(const double* __restrict__ tiles,
                  const int* __restrict__ items,
                  const double* __restrict__ U0,
                  const double* __restrict__ U1, double* __restrict__ part,
                  int B, int K) {
  constexpr int NT = 4 / MT;  // n tiles of 8 lanes a warp
  constexpr int LW = 8 * NT;  // lanes a warp
  constexpr int TD = lin_tile_doubles(MT);
  constexpr int SD = kLinStage * TD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  const int* it = items + 4 * blockIdx.y;
  const int ser = it[0], tile0 = it[1], ntiles = it[2], slot = it[3];
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int g = l >> 2, t4 = l & 3;
  const int wbase = (blockIdx.x * kLinWarps + warp) * LW;
  const double* u0g = U0 + (size_t)ser * B;
  const double* u1g = U1 + (size_t)ser * B;
  double u0[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int ln = wbase + 8 * j + g;
    u0[j] = ln < B ? u0g[ln] : 0.0;
  }
  double acc[2][MT][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[p][mt][j][v] = 0.0;
  const bool odd = K >= 1;
  const double* src = tiles + (size_t)tile0 * TD;
  const int nst = (ntiles + kLinStage - 1) / kLinStage;
  auto load = [&](int s) {
    const int nt = min(kLinStage, ntiles - s * kLinStage);
    const double* gsrc = src + (size_t)s * SD;
    double* dst = ring + (s & 1) * SD;
    for (int i = tid; i < nt * (TD / 2); i += kLinThreads)
      cp_async16(dst + 2 * i, gsrc + 2 * i);
    cp_commit();
  };
  load(0);
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      load(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int nt = min(kLinStage, ntiles - s * kLinStage);
    const double* st = ring + (s & 1) * SD;
    for (int ti = 0; ti < nt; ++ti) {
      const double* T = st + ti * TD;
      double p0[4], p1[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        p0[v] = T[t4 + 4 * v];
        p1[v] = T[kLinTerms + t4 + 4 * v];
      }
      double a[2][MT][8];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double2 x = *reinterpret_cast<const double2*>(
                T + 2 * kLinTerms + ((p * MT + mt) * 4 + j) * 64 + 2 * l);
            a[p][mt][2 * j] = x.x;
            a[p][mt][2 * j + 1] = x.y;
          }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        double bs[4], bc[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          lin_sincos(__dadd_rn(p0[v], __dmul_rn(u0[j], p1[v])), bs[v],
                     bc[v]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_f64(acc[0][mt][j], a[0][mt], bs);
          if (odd) mma_f64(acc[1][mt][j], a[1][mt], bc);
        }
      }
    }
    __syncthreads();  // the stage is read: the next load may overwrite it
  }
  // the epilogue: the sums to shared memory by order and lane (the ring is
  // free), then a thread a lane applies u1^m / m! and writes the orders
  double* E = ring + warp * (32 * MT * LW);
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int m = 2 * (16 * mt + g + 8 * (v >> 1)) + p;
          E[m * LW + 8 * j + 2 * t4 + (v & 1)] = acc[p][mt][j][v];
        }
  __syncwarp();
  for (int ln = l; ln < LW; ln += 32) {
    const int lane = wbase + ln;
    if (lane >= B) continue;
    const double u1 = u1g[lane];
    double* o = part + (size_t)slot * (K + 1) * B + lane;
    double sc = 1.0;
    for (int m = 0; m <= K; ++m) {
      if (m) sc = sc * u1 / (double)m;
      o[(size_t)m * B] = E[m * LW + ln] * sc;
    }
  }
}

// ---------------------------------------------------------------------------
// S1-G: the general class by the recurrence, order sums in registers
// ---------------------------------------------------------------------------

constexpr int kGenLanes = 32;
constexpr int kGenSlices = 4;
constexpr int kGenThreads = kGenLanes * kGenSlices;
constexpr int kGenStage = 128;  // terms a stage of the ring
constexpr int kGenOrders = 21;  // orders a thread sums in registers at once

// One term's jet on one lane.  ND / NA: the most phase / amplitude
// coefficients (d+1, q+1) of the instance.
template <int ND, int NA>
struct GenTerm {
  // s window: s_m .. s_{m-NW+1}; c window: c_{m-1} .. c_{m-ND+1}
  static constexpr int NW = (ND - 1 > NA) ? ND - 1 : NA;
  static constexpr int NC = ND > 1 ? ND - 1 : 1;
  double jp[ND], a[NA], sw[NW], cw[NC];

  __device__ __forceinline__ GenTerm(const double* am, const double* ph,
                                     int q, int d, double u0, double u1) {
    double p[ND];
#pragma unroll
    for (int r = 0; r < ND; ++r) p[r] = r <= d ? ph[r] : 0.0;
#pragma unroll
    for (int r = 0; r < NA; ++r) a[r] = r <= q ? am[r] : 0.0;
    // the Taylor shift by u0: pass i, r = d-1 .. i
#pragma unroll
    for (int i = 0; i < ND - 1; ++i) {
#pragma unroll
      for (int r = ND - 2; r >= i; --r)
        if (r < d) p[r] = p[r] + u0 * p[r + 1];
    }
#pragma unroll
    for (int i = 0; i < NA - 1; ++i) {
#pragma unroll
      for (int r = NA - 2; r >= i; --r)
        if (r < q) a[r] = a[r] + u0 * a[r + 1];
    }
    // the scale by u1^j
    double up = u1;
#pragma unroll
    for (int j = 1; j < (ND > NA ? ND : NA); ++j) {
      if (j < ND) p[j] = p[j] * up;
      if (j < NA) a[j] = a[j] * up;
      up = up * u1;
    }
#pragma unroll
    for (int j = 1; j < ND; ++j) jp[j] = (double)j * p[j];
#pragma unroll
    for (int i = 1; i < NW; ++i) sw[i] = 0.0;
#pragma unroll
    for (int i = 1; i < NC; ++i) cw[i] = 0.0;
    double s0, c0;
    sincos(p[0], &s0, &c0);
    sw[0] = s0;
    cw[0] = c0;
  }

  __device__ __forceinline__ double f0() const { return a[0] * sw[0]; }

  // to order m (inv = 1/m); returns f_m
  __device__ __forceinline__ double next(double inv) {
    // before the push: sw[j-1] = s_{m-j}, cw[j-1] = c_{m-j}
    double ss = 0.0, cc = 0.0;
#pragma unroll
    for (int j = 1; j < ND; ++j) {
      ss = fma(jp[j], cw[j - 1], ss);
      cc = fma(jp[j], sw[j - 1], cc);
    }
    const double sm = ss * inv, cm = -(cc * inv);
#pragma unroll
    for (int i = NW - 1; i > 0; --i) sw[i] = sw[i - 1];
#pragma unroll
    for (int i = NC - 1; i > 0; --i) cw[i] = cw[i - 1];
    sw[0] = sm;
    cw[0] = cm;
    double fm = 0.0;
#pragma unroll
    for (int j = 0; j < NA; ++j) fm = fma(a[j], sw[j], fm);
    return fm;
  }
};

// Adds orders w0 .. min(K, w0 + kGenOrders - 1) of one term into f.
template <int ND, int NA>
__device__ __forceinline__ void gen_term(const double* row, int q1, int d1,
                                         double u0, double u1, int K, int w0,
                                         const double* inv,
                                         double (&f)[kGenOrders]) {
  GenTerm<ND, NA> t(row, row + q1, q1 - 1, d1 - 1, u0, u1);
  for (int m = 1; m < w0; ++m) t.next(inv[m]);
#pragma unroll
  for (int i = 0; i < kGenOrders; ++i) {
    const int m = w0 + i;
    if (m > K) break;
    f[i] += m == 0 ? t.f0() : t.next(inv[m]);
  }
}

// One item (a chunk of one series' class-G rows, [amp | ph | pad], rw
// doubles each) on the block's 32 lanes: orders 0..K into
// part[slot][m][lane].  items[8 * y]: series, first double, terms, q1,
// d1, rw, slot.
__global__ void __launch_bounds__(kGenThreads)
series_gen_kernel(const double* __restrict__ rows,
                  const int* __restrict__ items,
                  const double* __restrict__ U0,
                  const double* __restrict__ U1, double* __restrict__ part,
                  int B, int K, int ring_doubles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);  // [2][stage rows]
  double* inv = ring + ring_doubles;                   // [K+1]
  const int* it = items + 8 * blockIdx.y;
  const int ser = it[0], n = it[2], q1 = it[3], d1 = it[4], rw = it[5],
            slot = it[6];
  const double* src = rows + it[1];
  const int tid = threadIdx.x;
  const int l = tid % kGenLanes, sl = tid / kGenLanes;
  const int lane = blockIdx.x * kGenLanes + l;
  const bool live = lane < B;
  const bool small = q1 == 1 && d1 <= 5;
  for (int m = tid; m <= K; m += kGenThreads)
    inv[m] = m ? 1.0 / (double)m : 0.0;
  const double u0 = live ? U0[(size_t)ser * B + lane] : 0.0;
  const double u1 = live ? U1[(size_t)ser * B + lane] : 0.0;
  const int SD = kGenStage * rw;
  const int nst = (n + kGenStage - 1) / kGenStage;
  auto load = [&](int s) {
    const int nt = min(kGenStage, n - s * kGenStage);
    const double* gsrc = src + (size_t)s * SD;
    double* dst = ring + (s & 1) * SD;
    for (int i = tid; i < nt * rw / 2; i += kGenThreads)
      cp_async16(dst + 2 * i, gsrc + 2 * i);
    cp_commit();
  };
  for (int w0 = 0; w0 <= K; w0 += kGenOrders) {
    double f[kGenOrders];
#pragma unroll
    for (int i = 0; i < kGenOrders; ++i) f[i] = 0.0;
    __syncthreads();  // inv is set; the last window's sums are read
    load(0);
    for (int s = 0; s < nst; ++s) {
      if (s + 1 < nst) {
        load(s + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int nt = min(kGenStage, n - s * kGenStage);
      const double* st = ring + (s & 1) * SD;
      if (live) {
        if (small) {
          for (int i = sl; i < nt; i += kGenSlices)
            gen_term<5, 1>(st + i * rw, q1, d1, u0, u1, K, w0, inv, f);
        } else {
          for (int i = sl; i < nt; i += kGenSlices)
            gen_term<8, 8>(st + i * rw, q1, d1, u0, u1, K, w0, inv, f);
        }
      }
      __syncthreads();  // the stage is read: the next load may overwrite it
    }
    // the slices, in slice order (the ring is free)
    double* red = ring;  // [kGenOrders][kGenThreads]
#pragma unroll
    for (int i = 0; i < kGenOrders; ++i) red[i * kGenThreads + tid] = f[i];
    __syncthreads();
    const int nm = min(kGenOrders, K + 1 - w0);
    for (int i = tid; i < nm * kGenLanes; i += kGenThreads) {
      const int m = i / kGenLanes, ll = i - m * kGenLanes;
      const int ln = blockIdx.x * kGenLanes + ll;
      if (ln >= B) continue;
      double s = red[m * kGenThreads + ll];
#pragma unroll
      for (int j = 1; j < kGenSlices; ++j)
        s += red[m * kGenThreads + j * kGenLanes + ll];
      part[((size_t)slot * (K + 1) + w0 + m) * B + ln] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// the slots of each series, in slot order, into its row of out
// ---------------------------------------------------------------------------

// out[(m * R + dst[s]) * B + b] = sum over c in [sstart[s], sstart[s+1])
// of part[c][m][b], for the n_ser series s.
__global__ void series_reduce_kernel(const double* __restrict__ part,
                                     const int* __restrict__ sstart,
                                     const int* __restrict__ dst,
                                     double* __restrict__ out, int n_ser,
                                     int R, int K, int B) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per = (size_t)(K + 1) * B;
  if (i >= per * n_ser) return;
  const int s = (int)(i / per);
  const size_t mb = i - (size_t)s * per;
  const int m = (int)(mb / B), b = (int)(mb - (size_t)m * B);
  double acc = 0.0;
  for (int c = sstart[s]; c < sstart[s + 1]; ++c)
    acc += part[(size_t)c * per + mb];
  out[((size_t)m * R + dst[s]) * B + b] = acc;
}

int reduce(const double* part, const int* sstart, const int* dst,
           double* out, int n_ser, int R, int K, int B, cudaStream_t s) {
  if (sstart == nullptr) return 0;
  const size_t n = (size_t)n_ser * (K + 1) * B;
  series_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part, sstart, dst, out, n_ser, R, K, B);
  return (int)cudaGetLastError();
}

template <typename Kern>
int allow_smem(bool& allowed, Kern kern) {
  if (allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  allowed = true;
  return 0;
}

}  // namespace

// Kernel S1-L on n_items items (lin_items (n_items, 4) int32: series,
// first tile, tiles, slot) over the packed tiles (taylor/series_jet.py
// pack_lin) at U0, U1 (n_ser, B): each item's orders 0..K into
// part[slot]; mt row tiles of 16 orders a parity (1 for K < 32, 2 for K
// < 64).  With sstart non-null, then the reduce pass: the slots of series
// s, sstart[s] .. sstart[s+1]-1, added in order into row dst[s] of out
// (K+1, R, B).  smem: the dynamic shared memory (series_jet.lin_smem).
extern "C" int hy_series_lin_f64(const double* tiles, const int* items,
                                 int n_items, const double* U0,
                                 const double* U1, double* part, int B,
                                 int K, int mt, int smem, const int* sstart,
                                 const int* dst, double* out, int n_ser,
                                 int R, void* stream) {
  static bool allowed[2] = {false, false};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_items < 1 || n_items > 65535 || B < 1 || K < 0 || mt < 1 ||
      mt > 2 || K >= 32 * mt || smem < 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int lanes = kLinWarps * 32 / mt;
  const dim3 grid((B + lanes - 1) / lanes, n_items);
  int rc;
  if (mt == 1) {
    rc = allow_smem(allowed[0], series_lin_kernel<1>);
    if (rc) return rc;
    series_lin_kernel<1><<<grid, kLinThreads, (size_t)smem, s>>>(
        tiles, items, U0, U1, part, B, K);
  } else {
    rc = allow_smem(allowed[1], series_lin_kernel<2>);
    if (rc) return rc;
    series_lin_kernel<2><<<grid, kLinThreads, (size_t)smem, s>>>(
        tiles, items, U0, U1, part, B, K);
  }
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce(part, sstart, dst, out, n_ser, R, K, B, s);
}

// Kernel S1-G on n_items items (gen_items (n_items, 8) int32: series,
// first double, terms, q1, d1, rw, slot, 0) over the packed rows
// (series_jet.pack_gen) at U0, U1 (n_ser, B): each item's orders 0..K
// into part[slot]; then, with sstart non-null, the reduce pass as
// hy_series_lin_f64's.  ring: doubles of the staging ring, two stages of
// the widest row and at least the slices' sums (series_jet.gen_ring);
// smem: the dynamic shared memory, 8 (ring + K + 1) bytes or more.
extern "C" int hy_series_gen_f64(const double* rows, const int* items,
                                 int n_items, const double* U0,
                                 const double* U1, double* part, int B,
                                 int K, int ring, int smem,
                                 const int* sstart, const int* dst,
                                 double* out, int n_ser, int R,
                                 void* stream) {
  static bool allowed = false;
  const cudaStream_t s = (cudaStream_t)stream;
  // the ring also holds the slices' sums (kGenOrders x kGenThreads)
  if (n_items < 1 || n_items > 65535 || B < 1 || K < 0 ||
      ring < kGenOrders * kGenThreads || smem < 8 * (ring + K + 1) ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  int rc = allow_smem(allowed, series_gen_kernel);
  if (rc) return rc;
  const dim3 grid((B + kGenLanes - 1) / kGenLanes, n_items);
  series_gen_kernel<<<grid, kGenThreads, (size_t)smem, s>>>(
      rows, items, U0, U1, part, B, K, ring);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return reduce(part, sstart, dst, out, n_ser, R, K, B, s);
}
