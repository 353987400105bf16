// Batched Balanced-PANDAS routing against a workload snapshot, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_route_kernel` of
// src/repro/kernels/wwl_route.py (launched by `wwl_route_pallas`).
// Semantics contract: repro_torch/kernels/ref.py::wwl_route.
//
//   tier(m, task) = 0 if m is one of the task's three locals, else
//                   1 + the finest hierarchy level m shares with a local,
//                   else D + 1 (remote)
//   score         = W_m / est[m, tier]          (one IEEE division)
//   out           = argmin over all M servers, lexicographic on
//                   (score, server): ties go to the lowest index.
//
// Exactness: the score is one correctly rounded division (__fdiv_rn; the
// build passes --fmad=false and no fast math), so the kernel equals the
// plain version and the JAX reference bit for bit.
//
// Design.  One block of 256 threads serves kTasks tasks.  The Pallas
// kernel carries a running argmin across server blocks of a sequential
// grid; Hopper runs blocks in no order, so here each block owns its tasks
// outright and its threads stride over all M servers (coalesced loads of
// W and of each ancestor row).  A server's score takes only K values, one
// per tier, so each thread divides W_m by its K rates once and then picks
// the task's tier: K divisions per server and block instead of kTasks.
// Per-thread running bests (strict <, so the lowest index wins within a
// thread) are combined by a warp shuffle and then through shared memory,
// lexicographically on (score, server).  The depth is a template
// parameter so the group ids live in registers; depth 0 (K = 2) runs
// natively.  Ragged edges are masked here: nothing is padded.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function reads
// W, est and the ancestor table once (4 M (1 + K + D) bytes) plus the
// locals, and writes 12 bytes a task: about 1.5 MB at M = 65536, K = 3,
// B = 8192, i.e. ~0.45 us.  The work the data needs is M remote-tier
// scores shared by every task plus a division and a comparison for each
// non-remote (task, server) pair, a few million operations: it is
// bytes-bound.  This kernel instead tests all B x M pairs and re-reads the
// server arrays from L2 once per block, so it runs far above that bound.
// A later version can scan only the contiguous groups of a task's locals
// against one shared remote argmin.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTasks = 8;  // tasks per block

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa < sb || (sa == sb && ia < ib);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
wwl_route_kernel(const float* __restrict__ workload,
                 const float* __restrict__ est, const int* __restrict__ anc,
                 const int* __restrict__ locs, int m, int b,
                 int* __restrict__ server_out, int* __restrict__ tier_out,
                 float* __restrict__ score_out) {
  constexpr int K = D + 2;
  __shared__ int s_loc[kTasks][3];
  __shared__ int s_grp[kTasks][D > 0 ? D : 1][3];
  __shared__ float s_score[kTasks][kWarps];
  __shared__ int s_server[kTasks][kWarps];
  __shared__ int s_tier[kTasks][kWarps];

  const int task0 = blockIdx.x * kTasks;
  const int ntask = min(kTasks, b - task0);
  for (int i = threadIdx.x; i < kTasks * 3; i += kThreads) {
    const int t = i / 3, j = i % 3;
    // rows past the last task repeat task 0's locals; never written out
    const int l = t < ntask ? locs[(task0 + t) * 3 + j] : locs[task0 * 3 + j];
    s_loc[t][j] = l;
#pragma unroll
    for (int lvl = 0; lvl < D; ++lvl) s_grp[t][lvl][j] = anc[lvl * m + l];
  }
  __syncthreads();

  // (score, server) = (+inf, INT_MAX) loses to every real server, so an
  // all-infinite row still returns its lowest index, as argmin does
  float best_s[kTasks];
  int best_i[kTasks], best_t[kTasks];
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    best_s[t] = __int_as_float(0x7f800000);
    best_i[t] = INT_MAX;
    best_t[t] = 0;
  }

  for (int mm = threadIdx.x; mm < m; mm += kThreads) {
    const float w = workload[mm];
    float sc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) sc[c] = __fdiv_rn(w, est[mm * K + c]);
    int g[D > 0 ? D : 1];
#pragma unroll
    for (int lvl = 0; lvl < D; ++lvl) g[lvl] = anc[lvl * m + mm];

#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      int tier = D + 1;
#pragma unroll
      for (int lvl = D - 1; lvl >= 0; --lvl) {
        if (g[lvl] == s_grp[t][lvl][0] || g[lvl] == s_grp[t][lvl][1] ||
            g[lvl] == s_grp[t][lvl][2])
          tier = lvl + 1;
      }
      if (mm == s_loc[t][0] || mm == s_loc[t][1] || mm == s_loc[t][2])
        tier = 0;
      float s = sc[0];
#pragma unroll
      for (int c = 1; c < K; ++c) s = tier == c ? sc[c] : s;
      if (beats(s, mm, best_s[t], best_i[t])) {
        best_s[t] = s;
        best_i[t] = mm;
        best_t[t] = tier;
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    float s = best_s[t];
    int i = best_i[t], tr = best_t[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float so = __shfl_down_sync(0xffffffffu, s, off);
      const int io = __shfl_down_sync(0xffffffffu, i, off);
      const int to = __shfl_down_sync(0xffffffffu, tr, off);
      if (beats(so, io, s, i)) {
        s = so;
        i = io;
        tr = to;
      }
    }
    if (lane == 0) {
      s_score[t][warp] = s;
      s_server[t][warp] = i;
      s_tier[t][warp] = tr;
    }
  }
  __syncthreads();
  if (threadIdx.x < ntask) {
    const int t = threadIdx.x;
    float s = s_score[t][0];
    int i = s_server[t][0], tr = s_tier[t][0];
    for (int wi = 1; wi < kWarps; ++wi) {
      if (beats(s_score[t][wi], s_server[t][wi], s, i)) {
        s = s_score[t][wi];
        i = s_server[t][wi];
        tr = s_tier[t][wi];
      }
    }
    server_out[task0 + t] = i;
    tier_out[task0 + t] = tr;
    score_out[task0 + t] = s;
  }
}

template <int D>
cudaError_t launch(const float* w, const float* est, const int* anc,
                   const int* locs, int m, int b, int* server, int* tier,
                   float* score, cudaStream_t stream) {
  const int blocks = (b + kTasks - 1) / kTasks;
  wwl_route_kernel<D><<<blocks, kThreads, 0, stream>>>(
      w, est, anc, locs, m, b, server, tier, score);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Every array is a contiguous device
// pointer: workload (m,) float32, est (m, depth+2) float32, anc (depth, m)
// int32, locs (b, 3) int32; outputs server (b,) int32, tier (b,) int32,
// score (b,) float32.  Returns the cudaError_t of the launch (0 on
// success); depth must be 0..4 and b, m >= 1.
extern "C" int wwl_route_launch(const void* workload, const void* est,
                                const void* anc, const void* locs, int m,
                                int depth, int b, void* server, void* tier,
                                void* score, void* stream) {
  if (m < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wf = static_cast<const float*>(workload);
  const auto* ef = static_cast<const float*>(est);
  const auto* ai = static_cast<const int*>(anc);
  const auto* li = static_cast<const int*>(locs);
  auto* so = static_cast<int*>(server);
  auto* to = static_cast<int*>(tier);
  auto* sc = static_cast<float*>(score);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
    case 0: err = launch<0>(wf, ef, ai, li, m, b, so, to, sc, st); break;
    case 1: err = launch<1>(wf, ef, ai, li, m, b, so, to, sc, st); break;
    case 2: err = launch<2>(wf, ef, ai, li, m, b, so, to, sc, st); break;
    case 3: err = launch<3>(wf, ef, ai, li, m, b, so, to, sc, st); break;
    case 4: err = launch<4>(wf, ef, ai, li, m, b, so, to, sc, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
