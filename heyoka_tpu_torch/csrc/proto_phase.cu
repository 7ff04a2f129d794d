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
// Design: one thread runs one lane and interprets the tables built by
// heyoka_tpu_torch/convert.py and packed by taylor/jet_kernels.py (header
// `enum Hdr` in taylor_common.cuh), as kernels B2 and B4 do; 64 threads per
// block.  The buffer is f32 in kernel B4's (K+1, W, B) layout, lane index
// minor; the prototype's (W, K+1, B) is a permuted view of it (the
// wrapper's callers permute outside the kernel).  The TPU kernel stages each
// operand's history in VMEM value lists because Mosaic has no value
// scatter; global memory needs no such staging, so none is ported.  Built
// with -fmad=false like the other kernels, so every sum rounds as the
// plain torch body's does.
//
// What bounds it on this card: bytes.  On the outer-Solar-System tape (W =
// 381, orders 9..19) at B = 10,240 lanes the buffer is 312 MB, of which
// the kernel writes 166 MB, against about 0.9 GFLOP: 143 us at 3.35 TB/s
// against 13 us at 67 TFLOP/s.  One thread per lane reads each operand's
// history once per order, so it moves far more than that and its loads wait
// in line; the design does nothing about it yet (no row sharing as in B3).

#include <cuda_runtime.h>
#include <stddef.h>

#include "taylor_common.cuh"

namespace {

constexpr int kThreads = 64;

// One lane's view of the f32 (K+1, W, B) buffer: order k of column c at
// row k W + c of B lanes, from the lane's own first element.  The row
// index fits an int (at most (K+1) W); only its product with B needs
// size_t.  Indexed so, the outer-SS phase runs faster on the H100 than
// with the whole index in size_t from the buffer's start (PERF.md).
struct LaneF {
  float* tc;
  int W;
  size_t B;
  __device__ float& at(int k, int c) const {
    return tc[(size_t)(k * W + c) * B];
  }
};

__global__ void __launch_bounds__(kThreads)
proto_phase_kernel(const int* __restrict__ it, const double* __restrict__ dt,
                   float* __restrict__ tc, int B, int lo) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const Tape T = load_tape(it, dt);
  const LaneF L{tc + lane, T.W, (size_t)B};
  const int n_eq = T.n_eq;
  for (int k = lo; k <= T.K; ++k) {
    const float kf = (float)k;
    for (int i = 0; i < n_eq; ++i) L.at(k, i) = L.at(k - 1, T.rhs[i]) / kf;
    for (int g = 0; g < T.n_groups; ++g) {
      const int op = T.gop[g], s = T.gstart[g], m = T.gm[g];
      for (int r = 0; r < m; ++r) {
        const int c = s + r, o = c - n_eq;
        const int* a = T.args + T.argptr[o];
        const int na = T.argptr[o + 1] - T.argptr[o];
        float v;
        if (op == OP_SUM) {
          v = L.at(k, a[0]);
          for (int q = 1; q < na; ++q) v = v + L.at(k, a[q]);
        } else if (op == OP_MUL) {
          v = L.at(0, a[0]) * L.at(k, a[1]);
          for (int j = 1; j <= k; ++j)
            v = v + L.at(j, a[0]) * L.at(k - j, a[1]);
        } else {  // OP_POW; the wrapper's tape admits no other op
          const double alpha = T.alpha[o];
          v = (L.at(0, c) * L.at(k, a[0])) * (float)(alpha * k);
          for (int j = 1; j < k; ++j)
            v = v + (L.at(j, c) * L.at(k - j, a[0]))
                        * (float)(alpha * (k - j) - j);
          v = v / (kf * L.at(0, a[0]));
        }
        L.at(k, c) = v;
      }
    }
  }
}

}  // namespace

extern "C" int hy_proto_phase_f32(const int* itab, const double* dtab,
                                  float* tc, int B, int lo, void* stream) {
  proto_phase_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(itab, dtab, tc, B, lo);
  return (int)cudaGetLastError();
}
