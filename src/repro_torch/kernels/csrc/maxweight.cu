// Batched JSQ-MaxWeight claim scoring against a queue snapshot, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_claim_kernel` of
// src/repro/kernels/maxweight.py (launched by `maxweight_claim_pallas`).
// Semantics contract: repro_torch/kernels/ref.py::maxweight_claim.
//
//   tier(b, n) = 0 if queue n is idle server b's own, else 1 + the finest
//                hierarchy level the two share, else D + 1 (remote)
//   score      = Q_n > 0 ? est[b, tier] * Q_n : -inf   (one product)
//   out        = argmax over the N queues, lexicographic on
//                (score, -queue): ties go to the lowest index.
//
// A row whose queues are all empty returns queue 0 and score -inf, as the
// plain version and the reference's oracle do (the Pallas kernel returns
// its -3e38 sentinel there instead).
//
// Exactness: the score is one correctly rounded product (__fmul_rn; the
// build passes --fmad=false), so the kernel equals the plain version bit
// for bit.
//
// Design.  One block of 256 threads serves kIdle idle servers and strides
// over all N queues: coalesced loads of Q and of each ancestor row, the
// idle servers' rates and groups in shared memory.  Nothing crosses
// blocks (the Pallas kernel's running argmax over a sequential grid has
// no counterpart on Hopper).  Per-thread running bests are combined by a
// warp shuffle and then through shared memory.  The depth is a template
// parameter; depth 0 (K = 2) runs natively.  Ragged edges are masked
// here: nothing is padded.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function reads Q
// and the queue ancestor table once (4 N (1 + D) bytes), the idle ids,
// their table and rates (4 B (1 + D + K) bytes), and writes 8 bytes per
// idle server: about 0.7 MB at N = 65536, B = 8192, D = 1, i.e. ~0.2 us.
// The work the data needs is one shared maximum of Q for the remote tier
// plus a product and a comparison for every non-remote (idle server,
// queue) pair: it is bytes-bound.  This kernel tests all B x N pairs and
// re-reads the queue arrays from L2 once per block, so it runs far above
// that bound.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIdle = 8;  // idle servers per block

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
maxweight_kernel(const float* __restrict__ queues,
                 const int* __restrict__ qanc, const int* __restrict__ idle,
                 const int* __restrict__ ianc, const float* __restrict__ est,
                 int n, int b, int* __restrict__ queue_out,
                 float* __restrict__ score_out) {
  constexpr int K = D + 2;
  __shared__ int s_id[kIdle];
  __shared__ int s_grp[kIdle][D > 0 ? D : 1];
  __shared__ float s_est[kIdle][K];
  __shared__ float s_score[kIdle][kWarps];
  __shared__ int s_queue[kIdle][kWarps];

  const int row0 = blockIdx.x * kIdle;
  const int nrow = min(kIdle, b - row0);
  for (int i = threadIdx.x; i < kIdle; i += kThreads) {
    // rows past the last idle server repeat row 0; never written out
    const int r = i < nrow ? row0 + i : row0;
    s_id[i] = idle[r];
#pragma unroll
    for (int lvl = 0; lvl < D; ++lvl) s_grp[i][lvl] = ianc[lvl * b + r];
#pragma unroll
    for (int c = 0; c < K; ++c) s_est[i][c] = est[r * K + c];
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  float best_s[kIdle];
  int best_i[kIdle];
#pragma unroll
  for (int t = 0; t < kIdle; ++t) {
    best_s[t] = neg_inf;
    best_i[t] = INT_MAX;
  }

  for (int nn = threadIdx.x; nn < n; nn += kThreads) {
    const float q = queues[nn];
    int g[D > 0 ? D : 1];
#pragma unroll
    for (int lvl = 0; lvl < D; ++lvl) g[lvl] = qanc[lvl * n + nn];

#pragma unroll
    for (int t = 0; t < kIdle; ++t) {
      int tier = D + 1;
#pragma unroll
      for (int lvl = D - 1; lvl >= 0; --lvl) {
        if (g[lvl] == s_grp[t][lvl]) tier = lvl + 1;
      }
      if (nn == s_id[t]) tier = 0;
      float w = s_est[t][0];
#pragma unroll
      for (int c = 1; c < K; ++c) w = tier == c ? s_est[t][c] : w;
      const float s = q > 0.0f ? __fmul_rn(w, q) : neg_inf;
      if (beats(s, nn, best_s[t], best_i[t])) {
        best_s[t] = s;
        best_i[t] = nn;
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kIdle; ++t) {
    float s = best_s[t];
    int i = best_i[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float so = __shfl_down_sync(0xffffffffu, s, off);
      const int io = __shfl_down_sync(0xffffffffu, i, off);
      if (beats(so, io, s, i)) {
        s = so;
        i = io;
      }
    }
    if (lane == 0) {
      s_score[t][warp] = s;
      s_queue[t][warp] = i;
    }
  }
  __syncthreads();
  if (threadIdx.x < nrow) {
    const int t = threadIdx.x;
    float s = s_score[t][0];
    int i = s_queue[t][0];
    for (int wi = 1; wi < kWarps; ++wi) {
      if (beats(s_score[t][wi], s_queue[t][wi], s, i)) {
        s = s_score[t][wi];
        i = s_queue[t][wi];
      }
    }
    queue_out[row0 + t] = i;
    score_out[row0 + t] = s;
  }
}

template <int D>
cudaError_t launch(const float* q, const int* qanc, const int* idle,
                   const int* ianc, const float* est, int n, int b,
                   int* queue, float* score, cudaStream_t stream) {
  const int blocks = (b + kIdle - 1) / kIdle;
  maxweight_kernel<D><<<blocks, kThreads, 0, stream>>>(
      q, qanc, idle, ianc, est, n, b, queue, score);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Every array is a contiguous device
// pointer: queues (n,) float32, qanc (depth, n) int32, idle (b,) int32,
// ianc (depth, b) int32, est (b, depth+2) float32; outputs queue (b,)
// int32, score (b,) float32.  Returns the cudaError_t of the launch (0 on
// success); depth must be 0..4 and b, n >= 1.
extern "C" int maxweight_launch(const void* queues, const void* qanc,
                                const void* idle, const void* ianc,
                                const void* est, int n, int depth, int b,
                                void* queue, void* score, void* stream) {
  if (n < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(queues);
  const auto* qa = static_cast<const int*>(qanc);
  const auto* id = static_cast<const int*>(idle);
  const auto* ia = static_cast<const int*>(ianc);
  const auto* ef = static_cast<const float*>(est);
  auto* qo = static_cast<int*>(queue);
  auto* so = static_cast<float*>(score);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
    case 0: err = launch<0>(qf, qa, id, ia, ef, n, b, qo, so, st); break;
    case 1: err = launch<1>(qf, qa, id, ia, ef, n, b, qo, so, st); break;
    case 2: err = launch<2>(qf, qa, id, ia, ef, n, b, qo, so, st); break;
    case 3: err = launch<3>(qf, qa, id, ia, ef, n, b, qo, so, st); break;
    case 4: err = launch<4>(qf, qa, id, ia, ef, n, b, qo, so, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
