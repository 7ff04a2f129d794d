// The Taylor jet of a dense trig series (kernel S1), in f64, for NVIDIA
// Hopper (sm_90a).
//
// f(u) = sum_i a_i(u) sin(P_i(u)) over tables amp (n, q+1) and ph (n,
// d+1) (expr/series.py), at an input affine in time, u = u0 + u1 t, one
// (u0, u1) a lane: out (K+1, B), the plain Taylor coefficients in t.  Per
// (lane, term), as taylor/series_jet.series_jet_plain:
//
//   the tables shifted by u0 (synthetic division; its first pass is
//   Horner's rule, so p_0 and a_0 round as the twin's and the JAX
//   evaluator's) and scaled by u1^j;  s_0 = sin p_0, c_0 = cos p_0;
//   s_m = (1/m) sum_{j=1..min(m,d)} j p_j c_{m-j},
//   c_m = -(1/m) sum_j j p_j s_{m-j};
//   f_m = sum_{j<=min(m,q)} a_j s_{m-j}, summed over the terms.
//
// Not a TPU kernel's counterpart: the JAX package runs this recurrence in
// XLA (_series_jet, heyoka_tpu/expr/series.py:427, a lax.scan over orders
// on (window, n_terms) arrays, with an f32 tail and a power-of-two step
// scale that keep emulated f64 in range; plain f64 needs neither).
//
// What bounds it: f64 arithmetic.  Plain torch would hold a (B, n_terms)
// tensor per window row and order and stream it through memory (at the
// complete ELP2000 tape, 37,863 terms, B = 10,240 and K = 19, ~2e11
// bytes a step).  Here a thread keeps one term's shifted tables, its s/c
// windows and its running order in registers, so the tables are read once
// a block (staged in shared memory kSerTile terms at a time, shared by the
// block's lanes) and the work is ~350 operations a (lane, term)
// (tools/roofline.series_flops).  The order recurrence uses fma(); the
// shifts do not, so that p_0 keeps the twin's bits (a phase of 4e4 rad
// off by an ulp moves sin by 7e-12): the kernel is held to its twin by a
// tolerance per order, the shifts bit for bit.
//
// Design.  A block serves kSerLanes lanes with kSerSlices term slices
// (thread = slice * kSerLanes + lane, so a warp's threads read one term's
// tables, a broadcast); blockIdx.y picks a chunk of `per` terms.  A thread
// walks its slice's terms in order and adds each term's f_m into its own
// column of shared memory; at the end the block adds the slices in slice
// order, and a second pass adds the chunks in chunk order: no atomics, the
// same bits on every run of a launch shape.  Template instances by the
// coefficients a term: <2, 1> (linear phase, constant amplitude: VSOP2013),
// <5, 1> (up to quartic phase: ELP2000), <8, 8> (the rest, up to 8 each).
// Built with -fmad=false like the other kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kSerLanes = 32;
constexpr int kSerSlices = 4;
constexpr int kSerThreads = kSerLanes * kSerSlices;
constexpr int kSerTile = 256;
constexpr int kSerSmemMax = 232448;

// One term at one lane: adds f_m of the term into f[m * kSerThreads],
// m = 0..K.  ND / NA: the most phase / amplitude coefficients (d+1, q+1)
// of the instance.
template <int ND, int NA>
__device__ __forceinline__ void series_term(const double* am,
                                            const double* ph, int q, int d,
                                            double u0, double u1, int K,
                                            const double* inv, double* f) {
  // s window: s_m .. s_{m-NW+1}; c window: c_{m-1} .. c_{m-ND+1}
  constexpr int NW = (ND - 1 > NA) ? ND - 1 : NA;
  double p[ND], a[NA];
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
  double jp[ND];
  #pragma unroll
  for (int j = 1; j < ND; ++j) jp[j] = (double)j * p[j];
  double s0, c0;
  sincos(p[0], &s0, &c0);
  double sw[NW], cw[ND > 1 ? ND - 1 : 1];
  #pragma unroll
  for (int i = 0; i < NW; ++i) sw[i] = 0.0;
  #pragma unroll
  for (int i = 0; i < (ND > 1 ? ND - 1 : 1); ++i) cw[i] = 0.0;
  sw[0] = s0;
  cw[0] = c0;
  f[0] += a[0] * s0;
  for (int m = 1; m <= K; ++m) {
    // before the push: sw[j-1] = s_{m-j}, cw[j-1] = c_{m-j}
    double ss = 0.0, cc = 0.0;
    #pragma unroll
    for (int j = 1; j < ND; ++j) {
      ss = fma(jp[j], cw[j - 1], ss);
      cc = fma(jp[j], sw[j - 1], cc);
    }
    const double sm = ss * inv[m], cm = -(cc * inv[m]);
    #pragma unroll
    for (int i = NW - 1; i > 0; --i) sw[i] = sw[i - 1];
    #pragma unroll
    for (int i = ND - 2; i > 0; --i) cw[i] = cw[i - 1];
    sw[0] = sm;
    cw[0] = cm;
    double fm = 0.0;
    #pragma unroll
    for (int j = 0; j < NA; ++j) fm = fma(a[j], sw[j], fm);
    f[(size_t)m * kSerThreads] += fm;
  }
}

// Orders 0..K of the block's lanes over chunk blockIdx.y's terms:
// out[(blockIdx.y * (K+1) + m) * B + lane].
template <int ND, int NA>
__global__ void __launch_bounds__(kSerThreads)
series_jet_kernel(const double* __restrict__ amp,
                  const double* __restrict__ ph,
                  const double* __restrict__ u0g,
                  const double* __restrict__ u1g, double* __restrict__ out,
                  int n, int q1, int d1, int B, int K, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* facc = reinterpret_cast<double*>(smem_raw);  // [K+1][kSerThreads]
  double* inv = facc + (size_t)(K + 1) * kSerThreads;  // [K+1]
  double* tab = inv + (K + 1);                         // [kSerTile][q1 + d1]
  const int tid = threadIdx.x;
  const int l = tid % kSerLanes, sl = tid / kSerLanes;
  const int lane = blockIdx.x * kSerLanes + l;
  const bool live = lane < B;
  const int t0 = blockIdx.y * per, t1 = min(n, t0 + per);
  const int rw = q1 + d1;
  for (int i = tid; i < (K + 1) * kSerThreads; i += kSerThreads)
    facc[i] = 0.0;
  for (int m = tid; m <= K; m += kSerThreads)
    inv[m] = m ? 1.0 / (double)m : 0.0;
  const double u0 = live ? u0g[lane] : 0.0;
  const double u1 = live ? u1g[lane] : 0.0;
  for (int b0 = t0; b0 < t1; b0 += kSerTile) {
    const int nt = min(kSerTile, t1 - b0);
    __syncthreads();  // the last tile is done with (and facc, inv are set)
    for (int i = tid; i < nt * q1; i += kSerThreads)
      tab[(i / q1) * rw + i % q1] = amp[(size_t)b0 * q1 + i];
    for (int i = tid; i < nt * d1; i += kSerThreads)
      tab[(i / d1) * rw + q1 + i % d1] = ph[(size_t)b0 * d1 + i];
    __syncthreads();
    if (live)
      for (int i = sl; i < nt; i += kSerSlices)
        series_term<ND, NA>(tab + i * rw, tab + i * rw + q1, q1 - 1, d1 - 1,
                            u0, u1, K, inv, facc + tid);
  }
  __syncthreads();
  // the slices, in slice order
  for (int i = tid; i < (K + 1) * kSerLanes; i += kSerThreads) {
    const int m = i / kSerLanes, ll = i - m * kSerLanes;
    const int ln = blockIdx.x * kSerLanes + ll;
    if (ln >= B) continue;
    double s = facc[(size_t)m * kSerThreads + ll];
    #pragma unroll
    for (int j = 1; j < kSerSlices; ++j)
      s += facc[(size_t)m * kSerThreads + j * kSerLanes + ll];
    out[((size_t)blockIdx.y * (K + 1) + m) * B + ln] = s;
  }
}

// The chunks' partial sums, in chunk order: out[i] = sum_c part[c][i].
__global__ void series_reduce_kernel(const double* __restrict__ part,
                                     double* __restrict__ out, int chunks,
                                     size_t n_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  double s = part[i];
  for (int c = 1; c < chunks; ++c) s += part[(size_t)c * n_out + i];
  out[i] = s;
}

template <int ND, int NA>
int launch_series(bool& allowed, const double* amp, const double* ph,
                  const double* u0, const double* u1, double* dst, int n,
                  int q1, int d1, int B, int K, int per, int chunks,
                  int smem, cudaStream_t stream) {
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        series_jet_kernel<ND, NA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSerSmemMax);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const dim3 grid((B + kSerLanes - 1) / kSerLanes, chunks);
  series_jet_kernel<ND, NA><<<grid, kSerThreads, (size_t)smem, stream>>>(
      amp, ph, u0, u1, dst, n, q1, d1, B, K, per);
  return (int)cudaGetLastError();
}

}  // namespace

// Orders 0..K of the series (amp (n, q1), ph (n, d1)) at u = u0 + u1 t on
// B lanes into out (K+1, B).  `chunks` blocks of `per` terms along y
// (taylor/series_jet.launch_shape); where chunks > 1 they write their sums
// to `part` (chunks, K+1, B), which a second pass adds into `out`.
// `smem`: 8 * ((K+1) * 128 + (K+1) + 256 * (q1 + d1)) bytes.
extern "C" int hy_series_jet_f64(const double* amp, const double* ph,
                                 const double* u0, const double* u1,
                                 double* out, double* part, int n, int q1,
                                 int d1, int B, int K, int per, int chunks,
                                 int smem, void* stream) {
  static bool allowed[3] = {false, false, false};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || q1 < 1 || d1 < 1 || q1 > 8 || d1 > 8 || B < 1 || K < 0 ||
      per < 1 || chunks < 1 || chunks > 65535 || (long long)per * chunks < n ||
      smem < 0 || smem > kSerSmemMax || (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  double* dst = chunks > 1 ? part : out;
  int rc;
  if (q1 == 1 && d1 <= 2)
    rc = launch_series<2, 1>(allowed[0], amp, ph, u0, u1, dst, n, q1, d1, B,
                             K, per, chunks, smem, s);
  else if (q1 == 1 && d1 <= 5)
    rc = launch_series<5, 1>(allowed[1], amp, ph, u0, u1, dst, n, q1, d1, B,
                             K, per, chunks, smem, s);
  else
    rc = launch_series<8, 8>(allowed[2], amp, ph, u0, u1, dst, n, q1, d1, B,
                             K, per, chunks, smem, s);
  if (rc != 0 || chunks == 1) return rc;
  const size_t n_out = (size_t)(K + 1) * (size_t)B;
  series_reduce_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
      part, out, chunks, n_out);
  return (int)cudaGetLastError();
}
