// The order-k Cauchy convolution microbenchmark (kernel T1): c_k =
// sum_{j<=k} a_j b_{k-j} for k < K on (K, N) arrays with the lane index
// minor, in f32 and in two-f32 (double-float) pairs, for NVIDIA Hopper
// (sm_90a).
//
// Replaces conv_pallas_f32 / conv_pallas_dd (tools/microbench_pallas_conv.py
// :45 and :89, whose bodies are conv_kernel_f32 :35 and conv_kernel_dd :64).
// The TPU kernels keep a (K, 2048) tile of each operand in VMEM and unroll
// the k and j loops.  Every lane's sums run in the tool's order here too;
// the two-f32 product and sum are exact only if no a*b + c is contracted
// into an FMA, so the library is built with -fmad=false
// (_build.NVCC_FLAGS), and each multiply and add is one FP32 instruction.
//
// What bounds it on this card, at the tool's shapes (K = 20, N = 204,800):
//
// - f32: bytes.  3 K N 4 B = 49 MB (0.0147 ms at 3.35 TB/s) for 400
//   operations a lane.  One thread owns one lane column, keeps its K values
//   of each operand in registers (loaded once, neighbouring threads on
//   neighbouring addresses) and writes each order once.
// - two-f32: two floors of about the same size.  6 K N 4 B = 98 MB (0.0293
//   ms), and ~4,700 FP32 instructions a lane (21 a term over 210 terms,
//   the splits, the last two-sums), 0.96 G in all, which the 132 SMs issue
//   at 128 a cycle each: ~0.029 ms at 1.98 GHz.  A lane's arithmetic wants
//   its 80 inputs and 80 splits in registers (255 a thread: two warps a
//   scheduler), and the card gets near either floor only if the copies
//   stay in flight while it computes.  Hence a persistent ring
//   (conv_dd_ring):
//   - a grid of as many blocks as the SMs hold (the host's rule,
//     heyoka_tpu_torch/tools/microbench_conv.py conv_shape), block b
//     taking tiles b, b + grid, ... of T lanes, one thread a lane;
//   - one stage in dynamic shared memory, a tile's inputs as [array][k][T]
//     floats (rows lane-minor: a warp's reads hit 32 banks), filled by
//     four 2-D TMA copies (a (T, K) box of each input, through a tensor
//     map) onto the stage's mbarrier;
//   - every warp reads its lanes out of the stage into registers and goes
//     on; the last warp to have read the stage refills it with the block's
//     next tile, before its own arithmetic.  So the registers hold one
//     tile and the stage the next: the copies run under the arithmetic, no
//     block barrier in the loop, and a warp waits only for data.  Where the
//     rows are not 16-B aligned (N not a multiple of 4, or a pointer off
//     16 B) that warp copies the tile with 4-B cp.async instead, tracked by
//     the same mbarrier;
//   - a lane's arithmetic as the tool's: each order summed j = 0..k in one
//     thread.
//   Measured on an H100 (the kernel's trace instance, PERF.md): after the
//   first tile the copies land before they are waited for, and what bounds
//   the ring is each warp's arithmetic, a chain of dependent operations
//   that takes about as long alone as beside the SM's seven other warps,
//   so about 2x the two floors.  More stages, two threads a lane (orders
//   dealt in pairs) and fewer registers a thread (more warps) all ran
//   slower.  conv_dd_direct, the same lane body in a persistent loop over
//   plain loads with no shared memory, is the ring's yardstick.

#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: the encoder
                   // comes through cudaGetDriverEntryPoint)
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kK = 20;  // the tool's K; the register arrays need it fixed
constexpr int kThreads = 128;  // the f32 kernel's block
constexpr float kSplit = 4097.0f;  // Dekker's splitter for f32, 2^12 + 1

// the ring: threads a block (T lanes, one thread each), registers a thread
// (ptxas's most; the host's rule counts blocks an SM with it), bytes before
// the stage (its mbarrier and read count; TMA writes the stage at a 128-B
// aligned address)
constexpr int kMaxThreads = 128;
constexpr int kMaxRegs = 255;
constexpr int kBarBytes = 128;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr long long kHangCycles = 4000000000LL;  // ~2 s: a lost copy
constexpr int kTraceTiles = 8;  // tiles a block records in the trace
static_assert(kMaxThreads * kMaxRegs <= 65536,
              "a block of the most threads fits an SM's registers");

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

// Dekker's split of x into h + l, each of at most 12 significant bits
__device__ __forceinline__ void split(float x, float& h, float& l) {
  const float t = kSplit * x;
  h = t - (t - x);
  l = x - h;
}

// the global timer, in ns
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// -- PTX: mbarriers and asynchronous copies into shared memory -------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// this thread's arrival, expecting `bytes` of bulk copies on the phase
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete; trap after ~2 s, so
// that a copy that never lands fails the launch instead of hanging it.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (!done && clock64() - t0 > kHangCycles) __trap();
  } while (!done);
}

// the box of tensor map `map` at column x, row 0 into 128-B aligned shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(0),
      "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// -- the two-f32 ring ----------------------------------------------------------

struct Inputs {  // ahi, alo, bhi, blo: (K, N) each
  const float* p[4];
};
struct Maps {  // their tensor maps, a (T, K) box each
  CUtensorMap m[4];
};
struct Outputs {
  float* hi;
  float* lo;
};
struct Lane {  // one lane's inputs, in registers
  float ahi[kK], alo[kK], bhi[kK], blo[kK];
};

// the lane whose rows start at `st` (row stride T) into registers
__device__ __forceinline__ void load_lane(const float* __restrict__ st, int T,
                                          Lane& v) {
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    v.ahi[j] = st[j * T];
    v.alo[j] = st[(kK + j) * T];
    v.bhi[j] = st[(2 * kK + j) * T];
    v.blo[j] = st[(3 * kK + j) * T];
  }
}

// The lane's orders: the Dekker splits of the hi parts, then each order
// summed j = 0..k in the tool's arithmetic and written to column g of the
// (K, n) outputs.
__device__ __forceinline__ void run_lane(const Lane& v, Outputs out, size_t n,
                                         size_t g) {
  float ah[kK], al[kK], bh[kK], bl[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    split(v.ahi[j], ah[j], al[j]);
    split(v.bhi[j], bh[j], bl[j]);
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float shi = 0.0f, slo = 0.0f;
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      const int m = k - j;
      const float p = v.ahi[j] * v.bhi[m];
      float e = (((ah[j] * bh[m] - p) + ah[j] * bl[m]) + al[j] * bh[m])
                + al[j] * bl[m];
      e = (e + v.ahi[j] * v.blo[m]) + v.alo[j] * v.bhi[m];
      float e2;
      two_sum(shi, p, shi, e2);
      slo = slo + (e + e2);
    }
    float s, e3;
    two_sum(shi, slo, s, e3);
    out.hi[k * n + g] = s;
    out.lo[k * n + g] = e3;
  }
}

// the base of input `i` (a branch, not an indexed load: a kernel argument
// indexed at run time would be copied to local memory)
__device__ __forceinline__ const float* input(const Inputs& in, int i) {
  const float* p = in.p[0];
#pragma unroll
  for (int a = 1; a < 4; ++a)
    if (i == a) p = in.p[a];
  return p;
}

// One warp fills stage `dst` with the tile at lane0 (nv valid lanes),
// completing on `bar`: lane 0 by four TMA boxes (`tma`; out-of-range lanes
// come as zeros and count as bytes), else every lane by 4-B copies.
__device__ __forceinline__ void fill(float* dst, uint64_t* bar,
                                     const Maps& maps, const Inputs& in,
                                     size_t n, int lane0, int nv, int T,
                                     bool tma) {
  const int lane = threadIdx.x & 31;
  if (tma) {
    if (lane == 0) {
      // the block's reads of the stage before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive_expect(bar, (uint32_t)(4 * kK * T * 4));
#pragma unroll
      for (int a = 0; a < 4; ++a) tma_box(dst + a * kK * T, &maps.m[a], lane0, bar);
    }
  } else {
    for (int i = lane; i < 4 * kK * T; i += 32) {
      const int r = i / T, l = i - r * T;
      if (l < nv) copy4(dst + i, input(in, r / kK) + (r % kK) * n + lane0 + l);
    }
    bar_arrive_copies(bar);
  }
}

// The persistent ring: block b takes tiles b, b + gridDim.x, ... of T =
// blockDim.x lanes, thread l lane l of each.  The trace instance (kTrace)
// also writes thread 0's global-timer readings of each of the block's first
// kTraceTiles tiles to `trace`: before its wait, when its data is in, when
// its lane is read (and the stage refilled), when its arithmetic is done
// ([block][tile][4], zeros past the block's last tile).
template <bool kTrace>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv_dd_ring(const __grid_constant__ Maps maps, Inputs in, Outputs out,
             int N, int tiles, int tma, unsigned long long* trace) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* reads = reinterpret_cast<int*>(smem + 8);
  float* stage = reinterpret_cast<float*>(smem + kBarBytes);
  const int T = blockDim.x, l = threadIdx.x;
  const size_t n = (size_t)N;
  const int b = blockIdx.x, grid = gridDim.x;
  const int own = b < tiles ? (tiles - 1 - b) / grid + 1 : 0;
  // the first lane and the lanes of the block's tile `it`
  auto first = [&](int it) { return (b + it * grid) * T; };
  auto count = [&](int it) { return min(T, N - first(it)); };
  const int warps = T / 32;
  if (l == 0) {
    bar_init(bar, tma ? 1 : 32);
    *reads = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (l < 32 && own > 0)
    fill(stage, bar, maps, in, n, first(0), count(0), T, tma);
  unsigned long long* tr = nullptr;
  if constexpr (kTrace)
    if (l == 0) tr = trace + blockIdx.x * kTraceTiles * 4;
  for (int it = 0; it < own; ++it) {
    if constexpr (kTrace)
      if (tr && it < kTraceTiles) tr[4 * it] = now_ns();
    bar_wait(bar, (uint32_t)(it & 1));
    if constexpr (kTrace)
      if (tr && it < kTraceTiles) tr[4 * it + 1] = now_ns();
    const int lane0 = first(it);
    const bool live = l < count(it);
    Lane v;
    if (live) load_lane(stage + l, T, v);
    // the last warp to have read the stage refills it
    __syncwarp();
    int last = 0;
    if ((l & 31) == 0) {
      __threadfence_block();
      last = atomicAdd(reads, 1) == warps - 1;
      if (last) {
        *reads = 0;
        __threadfence_block();
      }
    }
    if (__shfl_sync(0xffffffffu, last, 0) && it + 1 < own)
      fill(stage, bar, maps, in, n, first(it + 1), count(it + 1), T, tma);
    if constexpr (kTrace)
      if (tr && it < kTraceTiles) tr[4 * it + 2] = now_ns();
    if (live) run_lane(v, out, n, (size_t)lane0 + l);
    if constexpr (kTrace)
      if (tr && it < kTraceTiles) tr[4 * it + 3] = now_ns();
  }
}

// The ring's yardstick: the same lane body in the same persistent loop, its
// 80 inputs loaded straight from global memory (neighbouring threads on
// neighbouring addresses), no shared memory and no copies in flight.
__global__ void __launch_bounds__(kMaxThreads, 1)
conv_dd_direct(Inputs in, Outputs out, int N, int tiles) {
  const size_t n = (size_t)N;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int g = t * blockDim.x + threadIdx.x;
    if (g >= N) continue;
    Lane v;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      v.ahi[j] = in.p[0][j * n + g];
      v.alo[j] = in.p[1][j * n + g];
      v.bhi[j] = in.p[2][j * n + g];
      v.blo[j] = in.p[3][j * n + g];
    }
    run_lane(v, out, n, (size_t)g);
  }
}

inline int blocks_for(int N) { return (N + kThreads - 1) / kThreads; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The ring's dynamic shared memory: the bookkeeping, then the stage.
int ring_smem(int T) { return kBarBytes + 4 * kK * T * 4; }

bool bad_tile(int T) { return T < 32 || T % 32 != 0 || T > kMaxThreads; }

// A (T, K) box of the (K, N) f32 array at p, rows N floats apart.
cudaError_t tensor_map(CUtensorMap* m, const float* p, int N, int T) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !fn) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)kK};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 4};
  const cuuint32_t box[2] = {(cuuint32_t)T, (cuuint32_t)kK};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kTrace>
cudaError_t allow_ring() {
  static bool allowed = false;
  if (allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      conv_dd_ring<kTrace>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  allowed = e == cudaSuccess;
  return e;
}

// the ring on (K, N) inputs at T lanes a tile over `blocks` blocks
template <bool kTrace>
int launch_ring(const float* ahi, const float* alo, const float* bhi,
                const float* blo, float* chi, float* clo, int N, int K,
                int T, int blocks, unsigned long long* trace,
                cudaStream_t stream) {
  if (K != kK || N < 1 || blocks < 1 || bad_tile(T))
    return (int)cudaErrorInvalidValue;
  const Inputs in{{ahi, alo, bhi, blo}};
  const bool tma = N % 4 == 0 && aligned16(ahi) && aligned16(alo) &&
                   aligned16(bhi) && aligned16(blo);
  Maps maps{};
  if (tma)
    for (int a = 0; a < 4; ++a) {
      const cudaError_t e = tensor_map(&maps.m[a], in.p[a], N, T);
      if (e != cudaSuccess) return (int)e;
    }
  const cudaError_t e = allow_ring<kTrace>();
  if (e != cudaSuccess) return (int)e;
  conv_dd_ring<kTrace><<<blocks, T, ring_smem(T), stream>>>(
      maps, in, {chi, clo}, N, (N + T - 1) / T, tma ? 1 : 0, trace);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue (before any launch) for a K the kernel was not
// built for or a tile it does not take.
extern "C" int hy_conv_f32(const float* a, const float* b, float* c, int N,
                           int K, void* stream) {
  if (K != kK) return (int)cudaErrorInvalidValue;
  conv_f32_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, c, N);
  return (int)cudaGetLastError();
}

// T lanes a tile, `blocks` persistent blocks (tools/microbench_conv.py
// conv_shape)
extern "C" int hy_conv_dd(const float* ahi, const float* alo,
                          const float* bhi, const float* blo, float* chi,
                          float* clo, int N, int K, int T, int blocks,
                          void* stream) {
  return launch_ring<false>(ahi, alo, bhi, blo, chi, clo, N, K, T, blocks,
                            nullptr, (cudaStream_t)stream);
}

// hy_conv_dd with the clock readings: `trace` holds blocks x kTraceTiles x
// 4 zeroed words (conv_dd_ring)
extern "C" int hy_conv_dd_trace(const float* ahi, const float* alo,
                                const float* bhi, const float* blo,
                                float* chi, float* clo, int N, int K, int T,
                                int blocks, unsigned long long* trace,
                                void* stream) {
  return launch_ring<true>(ahi, alo, bhi, blo, chi, clo, N, K, T, blocks,
                           trace, (cudaStream_t)stream);
}

// The yardstick conv_dd_direct at T threads a block over `blocks` blocks.
extern "C" int hy_conv_dd_direct(const float* ahi, const float* alo,
                                 const float* bhi, const float* blo,
                                 float* chi, float* clo, int N, int K, int T,
                                 int blocks, void* stream) {
  if (K != kK || N < 1 || blocks < 1 || bad_tile(T))
    return (int)cudaErrorInvalidValue;
  conv_dd_direct<<<blocks, T, 0, (cudaStream_t)stream>>>(
      Inputs{{ahi, alo, bhi, blo}}, Outputs{chi, clo}, N, (N + T - 1) / T);
  return (int)cudaGetLastError();
}

// Blocks of the two-f32 ring an SM holds at T lanes a tile, as the runtime
// counts them (registers included), or minus a CUDA error.
extern "C" int hy_conv_dd_occupancy(int T) {
  if (bad_tile(T)) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = allow_ring<false>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, conv_dd_ring<false>, T, ring_smem(T));
  return e == cudaSuccess ? blocks : -(int)e;
}
