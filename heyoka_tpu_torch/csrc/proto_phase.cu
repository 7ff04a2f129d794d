// The f32 phase prototype (kernel T2): Taylor orders lo..K of every column
// of a tape plan made of sum, mul and pow, in place, in f32, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the `phase` kernel of tools/proto_pallas_phase.py (the `kernel`
// closure of main(), :173-237, pallas_call :240), the first prototype of
// the in-kernel f32 phase that became make_phase_kernel (kernel B4).  Its
// rules are build_phase_body's (:23-84): the state rows from the
// right-hand sides at k-1 over k, then the groups in level order: sum over
// the operands, mul as the full Cauchy product a_0 c_k + sum_{j=1..k}
// a_j c_{k-j}, and pow as (sum_{j<k} a_j b_{k-j} (alpha (k-j) - j)) /
// (k b_0), each term's weight rounded to f32 as the prototype's
// np.float32 constants are.  The prototype needs one exponent per pow
// group; here each column reads its own from the tables.
//
// Design: the block engine of phase_block.cuh, the one kernel B4 runs on,
// with these three rules in f32: the two kernels differ in precision
// alone, so chip_smoke.py phase 14 compares f32 with f64 on one design.
// The buffer is f32 in kernel B4's (K+1, W, B) layout, lane index minor;
// the prototype's (W, K+1, B) is a permuted view of it (the wrapper's
// callers permute outside the kernel).  A block stages its lanes' rows in
// shared memory, as the TPU kernel stages each operand's history in VMEM,
// and runs one barrier-closed pass per level.  Built with -fmad=false like
// the other kernels, so every sum rounds as the plain torch body's does,
// and each item keeps the expression and term order of the
// one-thread-per-lane kernel this design replaced.
//
// What bounds it on this card: on the outer-Solar-System tape (W = 381,
// orders 9..19) at B = 10,240 lanes the buffer is 312 MB, of which the
// kernel writes 166 MB, against about 0.9 GFLOP: 143 us at 3.35 TB/s
// against 13 us at 67 TFLOP/s.  A lane takes 30,480 B of shared memory,
// so a block holds seven lanes, whose rows (28 B) would stage by parts of
// 32-byte sectors: this tape runs on the engine's global layout, 32 lanes
// a block, each block a latency chain of passes.

#include <cuda_runtime.h>
#include <stddef.h>

#include "phase_block.cuh"
#include "taylor_common.cuh"

namespace {

// The engine's rules in f32: the state rows are the engine's; sum over the
// operands, mul as the full Cauchy product, pow with its f32 weights.
struct T2Rule {
  template <class LV, class SV, class QV>
  __device__ static float order_k(const Tape& T, const int*, const int*,
                                  const LV& L, const SV&, const QV&, int op,
                                  int c, int o, int k) {
    const float kf = (float)k;
    const int* a = T.args + T.argptr[o];
    const int na = T.argptr[o + 1] - T.argptr[o];
    float v;
    if (op == OP_SUM) {
      v = L.at(k, a[0]);
      #pragma unroll 4
      for (int q = 1; q < na; ++q) v = v + L.at(k, a[q]);
    } else if (op == OP_MUL) {
      v = L.at(0, a[0]) * L.at(k, a[1]);
      #pragma unroll 4
      for (int j = 1; j <= k; ++j) v = v + L.at(j, a[0]) * L.at(k - j, a[1]);
    } else {  // OP_POW; the wrapper's tape admits no other op
      const double alpha = T.alpha[o];
      v = (L.at(0, c) * L.at(k, a[0])) * (float)(alpha * k);
      #pragma unroll 4
      for (int j = 1; j < k; ++j)
        v = v + (L.at(j, c) * L.at(k - j, a[0]))
                    * (float)(alpha * (k - j) - j);
      v = v / (kf * L.at(0, a[0]));
    }
    return v;
  }
  // the prototype's rule set has no Kepler op, so no synthetic row
  template <class LV>
  __device__ static float synth(const Tape&, const int*, const LV&, int, int,
                                int) {
    return 0.0f;
  }
};

template <bool kSmem>
__global__ void __launch_bounds__(kPhaseMaxThreads)
proto_phase_kernel(const int* __restrict__ it, const double* __restrict__ dt,
                   float* __restrict__ tc, float* __restrict__ syn,
                   const float* __restrict__ ser, int n_ser, int B, int lo,
                   int lanes, int n_it, int n_dt) {
  // no dense-series rows (ser is null): the prototype's rule set is
  // {sum, mul, pow}
  phase_block<float, T2Rule, kSmem>(it, dt, tc, syn, ser, n_ser, B, lo,
                                    lanes, n_it, n_dt);
}

}  // namespace

// The arguments of hy_phase_f64 (taylor_phase.cu), on an f32 buffer.
extern "C" int hy_proto_phase_f32(const int* itab, const double* dtab,
                                  float* tc, float* syn, int B, int lo,
                                  int lanes, int threads, int smem, int n_it,
                                  int n_dt, int global, void* stream) {
  static bool allowed[2] = {false, false};
  const cudaStream_t s = (cudaStream_t)stream;
  if (global)
    return launch_phase(proto_phase_kernel<false>, allowed[0], itab, dtab, tc,
                        syn, (const float*)nullptr, 0, B, lo, lanes, threads,
                        smem, n_it, n_dt, s);
  return launch_phase(proto_phase_kernel<true>, allowed[1], itab, dtab, tc,
                      syn, (const float*)nullptr, 0, B, lo, lanes, threads,
                      smem, n_it, n_dt, s);
}
