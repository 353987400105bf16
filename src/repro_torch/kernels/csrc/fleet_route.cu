// Fused fleet slot-step private routing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fleet_route_kernel` of
// src/repro/kernels/slot_step.py (launched by `fleet_route_pallas`).
// Semantics contract: repro_torch/kernels/ref.py::fleet_route.
//
//   W_m   = q[m,0]/est[m,0] + q[m,1]/est[m,1] + ...   (left to right, f32)
//           + (serving[m] > 0 ? 1/est[m, serving[m]-1] : 0)
//   score = W_m / rate - rate * 1e-6f   with rate = est[m, tier(m, task)]
//   out   = argmin over servers whose tier is private (tier <= depth),
//           lexicographic on (score, server): ties go to the lowest index.
//
// Exactness: every operation is rounded on its own (__fdiv_rn, __fmul_rn,
// __fsub_rn, __fadd_rn; the build also passes --fmad=false), the constant
// is the float 1e-6f, and division is IEEE, so the kernel agrees bit for
// bit with the plain version and with the JAX reference.
//
// Design.  One block of 256 threads serves kTasks tasks.  Threads stride
// over all M servers; each thread computes W_m once per server and scores
// it for the block's tasks, keeping a per-task running best (strict <, so
// within a thread the lowest index wins).  A warp-shuffle and then a
// shared-memory reduction combine (score, server, tier) lexicographically.
// The kernel reads the (M, .) arrays directly and masks the ragged edges
// itself: no padding.  The tier of a server to a task comes from the
// ancestor table and the task's three locals, deepest level first, with
// the local override; the depth is a template parameter so the per-server
// group ids live in registers.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function reads
// about 0.45 MB at M = 10008, K = 3, B = 5474, i.e. ~0.13 us, and the
// work its data needs (W for every server plus a score for every private
// (task, server) pair) is a few million operations: it is bytes-bound.
// This kernel instead visits all B x M pairs (about 5.5e7 tier tests)
// and re-reads the server arrays once per block from L2, so it runs far
// above that bound.  Idea for a later version: a task's private set lies
// inside the contiguous top-level groups of its three locals (ancestor
// ids are contiguous ranges), so a redesign can scan O(group size)
// servers per task instead of M, with W computed once into a scratch
// vector by a first pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTasks = 8;  // tasks per block
constexpr float kLarge = 3.0e38f;

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa < sb || (sa == sb && ia < ib);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fleet_route_kernel(const int* __restrict__ q, const int* __restrict__ serving,
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

  float best_s[kTasks];
  int best_i[kTasks], best_t[kTasks];
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    best_s[t] = kLarge;
    best_i[t] = 0;
    best_t[t] = 0;
  }

  for (int mm = threadIdx.x; mm < m; mm += kThreads) {
    float e[K];
#pragma unroll
    for (int c = 0; c < K; ++c) e[c] = est[mm * K + c];
    float w = __fdiv_rn(__int2float_rn(q[mm * K]), e[0]);
#pragma unroll
    for (int c = 1; c < K; ++c)
      w = __fadd_rn(w, __fdiv_rn(__int2float_rn(q[mm * K + c]), e[c]));
    const int sv = serving[mm];
    const int ri = min(max(sv - 1, 0), K - 1);
    float er = e[0];
#pragma unroll
    for (int c = 1; c < K; ++c) er = ri == c ? e[c] : er;
    w = __fadd_rn(w, sv > 0 ? __fdiv_rn(1.0f, er) : 0.0f);
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
      if (tier <= D) {
        float rate = e[0];
#pragma unroll
        for (int c = 1; c <= D; ++c) rate = tier == c ? e[c] : rate;
        const float sc =
            __fsub_rn(__fdiv_rn(w, rate), __fmul_rn(rate, 1e-6f));
        if (sc < best_s[t]) {
          best_s[t] = sc;
          best_i[t] = mm;
          best_t[t] = tier;
        }
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
cudaError_t launch(const int* q, const int* serving, const float* est,
                   const int* anc, const int* locs, int m, int b, int* server,
                   int* tier, float* score, cudaStream_t stream) {
  const int blocks = (b + kTasks - 1) / kTasks;
  fleet_route_kernel<D><<<blocks, kThreads, 0, stream>>>(
      q, serving, est, anc, locs, m, b, server, tier, score);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Every array is a contiguous device
// pointer: q (m, depth+2) int32, serving (m,) int32, est (m, depth+2)
// float32, anc (depth, m) int32, locs (b, 3) int32; outputs server (b,)
// int32, tier (b,) int32, score (b,) float32.  Returns the cudaError_t
// of the launch (0 on success); depth must be 0..4 and b, m >= 1.
extern "C" int fleet_route_launch(const void* q, const void* serving,
                                  const void* est, const void* anc,
                                  const void* locs, int m, int depth, int b,
                                  void* server, void* tier, void* score,
                                  void* stream) {
  if (m < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qi = static_cast<const int*>(q);
  const auto* si = static_cast<const int*>(serving);
  const auto* ef = static_cast<const float*>(est);
  const auto* ai = static_cast<const int*>(anc);
  const auto* li = static_cast<const int*>(locs);
  auto* so = static_cast<int*>(server);
  auto* to = static_cast<int*>(tier);
  auto* sc = static_cast<float*>(score);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
    case 0: err = launch<0>(qi, si, ef, ai, li, m, b, so, to, sc, st); break;
    case 1: err = launch<1>(qi, si, ef, ai, li, m, b, so, to, sc, st); break;
    case 2: err = launch<2>(qi, si, ef, ai, li, m, b, so, to, sc, st); break;
    case 3: err = launch<3>(qi, si, ef, ai, li, m, b, so, to, sc, st); break;
    case 4: err = launch<4>(qi, si, ef, ai, li, m, b, so, to, sc, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
