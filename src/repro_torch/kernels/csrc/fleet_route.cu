// Fused fleet slot-step private routing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fleet_route_kernel` of
// src/repro/kernels/slot_step.py (launched by `fleet_route_pallas`, which
// `fleet_sweep` vmaps over the cells of a study).
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
// Precondition (depth D >= 1): every row of the ancestor table is
// non-decreasing, so each group is one contiguous range of server ids,
// and every group lies inside one group of each coarser level.  Then a
// task's private set (servers sharing some level's group with one of its
// three locals) is the union of its locals' top-level groups: at most
// 3 x the largest top-level group, 18 servers at the fleet cell
// (Topology(10008, 6)), 216 at (6, 72).  `Topology.ancestors` builds
// such tables, and `sharding.sim.make_ctx` checks the table once on the
// host before it goes to the card.  The plain version takes any table.
//
// Cells: a study's N (load x error x seed) cells route in one launch,
// blockIdx.y the cell and blockIdx.x its tasks (so N is capped by
// gridDim.y's 65535, not the product).  A cell's servers are the flat
// ids cell * m + mm of q, serving and est, its tasks cell * b + task of
// locs and the outputs, both 64-bit (N M K may pass 2^31); the ancestor
// table and its range search are shared.  The arrays are indexed from
// one flat server base: moving each pointer to its cell instead made a
// one-cell launch slower than the one-cell kernel (`chip_smoke.py --prev`
// times a cell beside it).
//
// Design: one warp per task, eight tasks a block of 256 threads.  The
// private set is small (a few tens to a few hundred servers), so one
// warp's lanes cover it in one or a few strides, and the warp reduces
// its candidates with shuffles: no shared memory and no block barrier.
//   * Locals: every lane loads the task's three locals and their group
//     ids at every level (the same addresses on all lanes: broadcasts).
//   * D = 0: the set is the three locals, scored by lanes 0..2.
//   * D >= 1: the ends of each local's top-level group g = anc[D-1][l]
//     in the row anc[D-1], by `run_bounds` (group_select.cuh, shared
//     with wwl_route.cu and maxweight.cu): lanes 0..15 read the 16 ids
//     below the local and lanes 16..31 the 16 above it, a ballot of
//     those equal to g brackets each end, an end past that window is
//     bracketed by a second round at distances 32, 48, ..., 272 (or by
//     the row's end), and a bracket wider than one is narrowed 16-ary.
//     A group of up to 16 servers is found in one round of loads (the
//     fleet cell's six), one of up to 272 in at most three.  A group
//     already seen for this task (an equal id) is skipped; the lanes
//     stride over the distinct ranges.
//   * Per server a lane computes W_m with the operations above in the
//     order above (the workload is recomputed for each task that scores
//     the server, about 10x redundant at the fleet shape and trivial
//     beside the loads; a first pass writing W to scratch would add a
//     launch), then the tier, deepest level first with the local
//     override, and the score.  It keeps a lexicographic (score, server)
//     best that starts at (3e38, server 0, tier 0), as the all-pairs
//     kernel this one replaced did, so every output, degenerate inputs
//     included, equals that kernel's bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function reads
// about 0.45 MB at M = 10008, K = 3, B = 5474, i.e. ~0.13 us, and the
// work its data needs (W for every server plus a score for every private
// (task, server) pair) is a few million operations: it is bytes-bound.
// The kernel reads the server arrays of the private sets only (about
// 98k scores a launch at the fleet cell) and is bound by the latency of
// its chain of dependent loads (locals, their groups, the range probes, the
// server data) and by the launch: on an H100 80GB HBM3 at 700 W it takes
// about 7 us on the device at D = 1 (4 us at D = 0, 21 us at D = 2 with
// up to 216 servers a task), against 0.14 ms for the all-pairs kernel it
// replaces, which tested all B x M = 5.5e7 (task, server) pairs (PERF.md
// row 1 has both kernels' times).

#include <cuda_runtime.h>

#include "group_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTasks = kThreads / 32;  // tasks a block: one warp each
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
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kTasks + (threadIdx.x >> 5);
  if (task >= b) return;  // whole warps leave together
  const long long cell = blockIdx.y;
  const long long base = cell * m;  // the cell's first server, flat
  const long long t = cell * b + task;

  int loc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) loc[j] = locs[t * 3 + j];
  int grp[D > 0 ? D : 1][3];
#pragma unroll
  for (int lvl = 0; lvl < D; ++lvl)
#pragma unroll
    for (int j = 0; j < 3; ++j) grp[lvl][j] = anc[lvl * m + loc[j]];

  // the private ranges: [lo_j, hi_j) per local, empty when already seen
  int lo[3], hi[3];
  if constexpr (D == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      lo[j] = loc[j];
      hi[j] = loc[j] + 1;
    }
  } else {
    const int g[3] = {grp[D - 1][0], grp[D - 1][1], grp[D - 1][2]};
    run_bounds<32, 3>(anc + (D - 1) * m, m, loc, g, lane, kAll, 0, lo, hi);
    if (grp[D - 1][1] == grp[D - 1][0]) hi[1] = lo[1];
    if (grp[D - 1][2] == grp[D - 1][0] || grp[D - 1][2] == grp[D - 1][1])
      hi[2] = lo[2];
  }

  float best_s = kLarge;
  int best_i = 0, best_t = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    for (int mm = lo[j] + lane; mm < hi[j]; mm += 32) {
      const long long g = base + mm;
      float e[K];
#pragma unroll
      for (int c = 0; c < K; ++c) e[c] = est[g * K + c];
      float w = __fdiv_rn(__int2float_rn(q[g * K]), e[0]);
#pragma unroll
      for (int c = 1; c < K; ++c)
        w = __fadd_rn(w, __fdiv_rn(__int2float_rn(q[g * K + c]), e[c]));
      const int sv = serving[g];
      const int ri = min(max(sv - 1, 0), K - 1);
      float er = e[0];
#pragma unroll
      for (int c = 1; c < K; ++c) er = ri == c ? e[c] : er;
      w = __fadd_rn(w, sv > 0 ? __fdiv_rn(1.0f, er) : 0.0f);

      int tier = D + 1;
#pragma unroll
      for (int lvl = D - 1; lvl >= 0; --lvl) {
        const int gm = anc[lvl * m + mm];
        if (gm == grp[lvl][0] || gm == grp[lvl][1] || gm == grp[lvl][2])
          tier = lvl + 1;
      }
      if (mm == loc[0] || mm == loc[1] || mm == loc[2]) tier = 0;
      if (tier <= D) {
        float rate = e[0];
#pragma unroll
        for (int c = 1; c <= D; ++c) rate = tier == c ? e[c] : rate;
        const float sc =
            __fsub_rn(__fdiv_rn(w, rate), __fmul_rn(rate, 1e-6f));
        if (beats(sc, mm, best_s, best_i)) {
          best_s = sc;
          best_i = mm;
          best_t = tier;
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_down_sync(kAll, best_s, off);
    const int io = __shfl_down_sync(kAll, best_i, off);
    const int to = __shfl_down_sync(kAll, best_t, off);
    if (beats(so, io, best_s, best_i)) {
      best_s = so;
      best_i = io;
      best_t = to;
    }
  }
  if (lane == 0) {
    server_out[t] = best_i;
    tier_out[t] = best_t;
    score_out[t] = best_s;
  }
}

template <int D>
cudaError_t launch(const int* q, const int* serving, const float* est,
                   const int* anc, const int* locs, int m, int b, int n,
                   int* server, int* tier, float* score, cudaStream_t stream) {
  const dim3 grid((b + kTasks - 1) / kTasks, n);
  fleet_route_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, serving, est, anc, locs, m, b, server, tier, score);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Every array is a contiguous device
// pointer: q (n, m, depth+2) int32, serving (n, m) int32, est (n, m,
// depth+2) float32, anc (depth, m) int32 meeting the precondition above
// and shared by the n cells, locs (n, b, 3) int32; outputs server (n, b)
// int32, tier (n, b) int32, score (n, b) float32.  Returns the
// cudaError_t of the launch (0 on success); depth must be 0..4, b, m >= 1
// and n in 1..65535.
extern "C" int fleet_route_launch(const void* q, const void* serving,
                                  const void* est, const void* anc,
                                  const void* locs, int m, int depth, int b,
                                  int n, void* server, void* tier,
                                  void* score, void* stream) {
  if (m < 1 || b < 1 || n < 1 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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
    case 0: err = launch<0>(qi, si, ef, ai, li, m, b, n, so, to, sc, st);
      break;
    case 1: err = launch<1>(qi, si, ef, ai, li, m, b, n, so, to, sc, st);
      break;
    case 2: err = launch<2>(qi, si, ef, ai, li, m, b, n, so, to, sc, st);
      break;
    case 3: err = launch<3>(qi, si, ef, ai, li, m, b, n, so, to, sc, st);
      break;
    case 4: err = launch<4>(qi, si, ef, ai, li, m, b, n, so, to, sc, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
