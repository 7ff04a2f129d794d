// The order-k Cauchy convolution microbenchmark (kernel T1): c_k =
// sum_{j<=k} a_j b_{k-j} for k < K on (K, N) arrays with the lane index
// minor, in f32 and in two-f32 (double-float) pairs, for NVIDIA Hopper
// (sm_90a).
//
// Replaces conv_pallas_f32 / conv_pallas_dd (tools/microbench_pallas_conv.py
// :45 and :89, whose bodies are conv_kernel_f32 :35 and conv_kernel_dd :64).
// The TPU kernels keep a (K, 2048) tile of each operand in VMEM and unroll
// the k and j loops; here one thread owns one lane column, keeps its K
// values of each operand in registers (loaded once, neighbouring threads on
// neighbouring addresses) and unrolls the same loops, so the sums run in
// the tool's order.  The two-f32 product and sum are exact only if no
// a*b + c is contracted into an FMA: the library is built with -fmad=false
// (_build.NVCC_FLAGS).
//
// What bounds it on this card: bytes.  At the tool's shapes (K = 20,
// N = 204,800) the f32 kernel moves 3 K N 4 B = 49 MB for 400 flops a lane
// (15 us against 1.2 us at 67 TFLOP/s), the two-f32 kernel 98 MB for about
// 4,700 flops a lane (29 us against 14 us).  The design does nothing more
// than read each input once and write each output once.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kK = 20;  // the tool's K; the register arrays need it fixed
constexpr int kThreads = 128;
constexpr float kSplit = 4097.0f;  // Dekker's splitter for f32, 2^12 + 1

__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t n = (size_t)N;
  float ar[kK], br[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    ar[j] = a[j * n + i];
    br[j] = b[j * n + i];
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float s = ar[0] * br[k];
#pragma unroll
    for (int j = 1; j <= k; ++j) s = s + ar[j] * br[k - j];
    c[k * n + i] = s;
  }
}

// Knuth's two-sum: s + e == x + y exactly (the tool's _two_sum)
__device__ __forceinline__ void two_sum(float x, float y, float& s,
                                        float& e) {
  s = x + y;
  const float bb = s - x;
  e = (x - (s - bb)) + (y - bb);
}

__global__ void __launch_bounds__(kThreads)
conv_dd_kernel(const float* __restrict__ ahi_g,
               const float* __restrict__ alo_g,
               const float* __restrict__ bhi_g,
               const float* __restrict__ blo_g, float* __restrict__ chi,
               float* __restrict__ clo, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t n = (size_t)N;
  float ahi[kK], alo[kK], bhi[kK], blo[kK];
  float ah[kK], al[kK], bh[kK], bl[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    ahi[j] = ahi_g[j * n + i];
    alo[j] = alo_g[j * n + i];
    bhi[j] = bhi_g[j * n + i];
    blo[j] = blo_g[j * n + i];
    // the cached Dekker splits of the hi parts
    const float ta = kSplit * ahi[j];
    ah[j] = ta - (ta - ahi[j]);
    al[j] = ahi[j] - ah[j];
    const float tb = kSplit * bhi[j];
    bh[j] = tb - (tb - bhi[j]);
    bl[j] = bhi[j] - bh[j];
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float shi = 0.0f, slo = 0.0f;
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      const int m = k - j;
      const float p = ahi[j] * bhi[m];
      float e = (((ah[j] * bh[m] - p) + ah[j] * bl[m]) + al[j] * bh[m])
                + al[j] * bl[m];
      e = (e + ahi[j] * blo[m]) + alo[j] * bhi[m];
      float e2;
      two_sum(shi, p, shi, e2);
      slo = slo + (e + e2);
    }
    float s, e3;
    two_sum(shi, slo, s, e3);
    chi[k * n + i] = s;
    clo[k * n + i] = e3;
  }
}

inline int blocks_for(int N) { return (N + kThreads - 1) / kThreads; }

}  // namespace

// Every entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue (before any launch) for a K the kernel was not
// built for.
extern "C" int hy_conv_f32(const float* a, const float* b, float* c, int N,
                           int K, void* stream) {
  if (K != kK) return (int)cudaErrorInvalidValue;
  conv_f32_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, c, N);
  return (int)cudaGetLastError();
}

extern "C" int hy_conv_dd(const float* ahi, const float* alo,
                          const float* bhi, const float* blo, float* chi,
                          float* clo, int N, int K, void* stream) {
  if (K != kK) return (int)cudaErrorInvalidValue;
  conv_dd_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      ahi, alo, bhi, blo, chi, clo, N);
  return (int)cudaGetLastError();
}
