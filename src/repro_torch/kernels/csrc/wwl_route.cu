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
// Exactness: every score is one correctly rounded division (__fdiv_rn; the
// build passes --fmad=false and no fast math), and every comparison is
// lexicographic on (score, server) from the state (+inf, INT_MAX), so the
// kernel equals the plain version and the JAX reference bit for bit, on any
// visiting order.
//
// Precondition of the fast path (D >= 1): every row of the ancestor table
// is non-decreasing and the groups nest (`slot_step.check_anc_ranges`), so
// a task's non-remote servers are the union of its locals' top-level
// groups.  The function itself takes any table: pass 1 checks the
// precondition on the card while it reads the table, and pass 2 runs the
// all-pairs loop where it fails.  No host read, no cache.
//
// Design: two launches a call.
//   * Pass 1 (`wwl_remote_kernel`: one cluster of one block of 1024
//     threads for each 1024 servers, at most 16).  A server's remote score
//     r_m = W_m / est[m, D+1] is the same for every task, so it is
//     computed once: each thread keeps the four best (r, server) pairs of
//     distinct top-level groups it sees (the four best servers at depth
//     0, where a server is its own group), as 64-bit keys (order-keeping
//     float bits with -0 folded onto +0 and NaN last, then the index).  A
//     warp selects the four best of its lanes' lists in four rounds (each
//     the least key, by two `redux.sync` minima, of every lane's first
//     entry of a group not yet taken), then warp 0 of the block does the
//     same over the warps' lists, every block pushes its list into block
//     0's shared memory (distributed shared memory), and block 0 selects
//     once more: exact, no atomics, the same result every run.  Four,
//     because a task's private set covers at most three top-level groups.
//     The same threads test every row of the table (non-decreasing,
//     nested), and the flag is the OR over the cluster.
//   * Pass 2 (`wwl_route_kernel`: half a warp a task, sixteen tasks a
//     block of 256 threads, so that B = 8192 tasks fit the card at once),
//     launched after pass 1 in stream order.  Every block first reads
//     pass 1's flag.  When it is set, each task's 16 lanes find the
//     ranges of its locals' top-level groups in the sorted top row
//     (`run_bounds`, group_select.cuh: 8 lanes read the 8 ids on each
//     side of a local, a second round probes 16, 24, ..., 72 away where
//     an end lies past them, then 8-ary narrowing: one round of loads for
//     groups of up to 8, three for groups of 64), skip repeated groups
//     and score each private server at its tier (deepest level first, the
//     local override last), four servers a lane a round so that their
//     loads are in flight together.  The result is the better of the
//     private best and the first of pass 1's four pairs whose group is
//     none of the task's (its score recomputed from its index, so the
//     output holds the winner's own bits).  When the flag is clear, the
//     block runs the all-pairs loop below for its sixteen tasks, eight a
//     sweep: the threads stride over all M servers with K divisions a
//     server, per-thread bests go through shuffles and shared memory.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function reads
// W, est and the ancestor table once (4 M (1 + K + D) bytes) plus the
// locals, and writes 12 bytes a task: about 1.5 MB at M = 65536, K = 3,
// B = 8192, i.e. ~0.45 us; the work is M remote scores and one division
// for each private (task, server) pair, about 1.6e6 at that shape: it is
// bytes-bound.  Both passes are bound by latency instead: pass 1 by its
// selection rounds and barriers (about 5.5 us at M = 10008, 8 us at
// 65536), pass 2 by its chain of dependent loads (locals, their groups,
// the range probes, the server data).  On an H100 80GB HBM3 at 700 W a
// call takes about 9.3 us of device time at the fleet shape (M = 10008,
// B = 5474, D = 1; pass 1 5.5, pass 2 3.9) and 17.3 us at M = 65536,
// B = 8192 (7.7 and 9.6), against 0.14 and 0.73 ms for the all-pairs
// kernel it replaces (PERF.md row 2, chip_smoke.py phases 3 and 7).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

#include "group_select.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTasks = kThreads / kLanes;  // pass 2: tasks a block
constexpr int kSlots = 4;  // remote pairs of distinct groups

// What pass 1 hands pass 2 (the wrapper's scratch; see wwl_route.py).
struct Remote {
  int ranges;  // 1: every ancestor row non-decreasing and nested
  int pad;
  unsigned long long key[kSlots];  // ascending; kEmpty when unused
  int group[kSlots];               // each key's top-level group
};
static_assert(sizeof(Remote) <= 64, "wwl_route.py allocates 64 bytes");

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa < sb || (sa == sb && ia < ib);
}

// Ascending key of (score, server): the float order with -0.0 equal to
// +0.0 (as `beats` has it), NaN after every number (never a winner).
__device__ __forceinline__ unsigned long long min_key(float s, int i) {
  unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  if (s != s) u = 0xffffffffu;
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(i);
}

template <int D>
__global__ void __launch_bounds__(kRemoteThreads, 1)
    wwl_remote_kernel(const float* __restrict__ workload,
                      const float* __restrict__ est,
                      const int* __restrict__ anc, int m,
                      Remote* __restrict__ out) {
  constexpr int K = D + 2;
  constexpr int L = D > 0 ? D : 1;
  __shared__ unsigned long long s_k[kRemoteThreads / 32][kSlots];
  __shared__ int s_g[kRemoteThreads / 32][kSlots];
  // rank 0's: every block's list and flag, pushed there
  __shared__ unsigned long long c_k[kMaxCluster][kSlots];
  __shared__ int c_g[kMaxCluster][kSlots];
  __shared__ int c_bad[kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int stride = blocks * kRemoteThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long k[kSlots];
  int g[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    k[j] = kEmpty;
    g[j] = 0;
  }
  bool bad = false;
  // warp-uniform rounds of kUnroll servers a lane: every load first
  for (int base = rank * kRemoteThreads + warp * 32; base < m;
       base += kUnroll * stride) {
    float w[kUnroll], e[kUnroll];
    int a[kUnroll][L];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int mm = base + lane + u * stride;
      if (mm < m) {
        w[u] = workload[mm];
        e[u] = est[mm * K + D + 1];
#pragma unroll
        for (int lvl = 0; lvl < D; ++lvl) a[u][lvl] = anc[lvl * m + mm];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int mm = base + lane + u * stride;
      // the precondition, on the pair (mm, mm + 1): the next server's ids
      // come from the next lane, the last lane loads its own
      bool finer = true;  // below level 0 every server is its own group
#pragma unroll
      for (int lvl = 0; lvl < D; ++lvl) {
        int c = __shfl_down_sync(kAll, a[u][lvl], 1);
        if (lane == 31 && mm + 1 < m) c = anc[lvl * m + mm + 1];
        if (mm + 1 < m)
          bad = bad || c < a[u][lvl] || (c != a[u][lvl] && !finer);
        finer = c != a[u][lvl];
      }
      if (mm < m)
        insert(k, g, min_key(__fdiv_rn(w[u], e[u]), mm),
               D > 0 ? a[u][L - 1] : mm);
    }
  }

  warp_select(k, g);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      s_k[warp][j] = k[j];
      s_g[warp][j] = g[j];
    }
  }
  const int any_bad = __syncthreads_or(bad);
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      k[j] = s_k[lane][j];
      g[j] = s_g[lane][j];
    }
    warp_select(k, g);
    if (lane == 0) {
      unsigned long long* rk = cluster.map_shared_rank(&c_k[rank][0], 0);
      int* rg = cluster.map_shared_rank(&c_g[rank][0], 0);
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        rk[j] = k[j];
        rg[j] = g[j];
      }
      *cluster.map_shared_rank(&c_bad[rank], 0) = any_bad;
    }
  }
  cluster.sync();  // the other blocks may leave: rank 0 holds their lists
  if (rank == 0 && warp == 0) {
    int bad_all = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      k[j] = lane < blocks ? c_k[lane][j] : kEmpty;
      g[j] = lane < blocks ? c_g[lane][j] : 0;
    }
    if (lane < blocks) bad_all = c_bad[lane];
    if (blocks > 1) warp_select(k, g);  // one block: lane 0 has the list
    bad_all = __any_sync(kAll, bad_all);
    if (lane == 0) {
      out->ranges = !bad_all;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        out->key[j] = k[j];
        out->group[j] = g[j];
      }
    }
  }
}

// Pass 2's scan of one task's private servers (its locals' top-level
// groups, the locals alone at depth 0), by the task's kLanes lanes: the
// lexicographic (score, server) best and its tier end in its first lane,
// the task's top-level groups in `excl`.  Only where the table meets the
// precondition.
template <int D>
__device__ __forceinline__ void private_best(
    const float* __restrict__ workload, const float* __restrict__ est,
    const int* __restrict__ anc, const int* __restrict__ locs, int m,
    int task, int hl, unsigned hmask, int shift, float& best_s,
    int& best_i, int& best_t, int (&excl)[3]) {
  constexpr int K = D + 2;
  int loc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) loc[j] = locs[task * 3 + j];
  int grp[D > 0 ? D : 1][3];
#pragma unroll
  for (int lvl = 0; lvl < D; ++lvl)
#pragma unroll
    for (int j = 0; j < 3; ++j) grp[lvl][j] = anc[lvl * m + loc[j]];

  int lo[3], hi[3];  // private ranges
  if constexpr (D == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      lo[j] = loc[j];
      hi[j] = loc[j] + 1;
      excl[j] = loc[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) excl[j] = grp[D - 1][j];
    run_bounds<kLanes, 3>(anc + (D - 1) * m, m, loc, excl, hl, hmask, shift,
                          lo, hi);
    if (excl[1] == excl[0]) hi[1] = lo[1];
    if (excl[2] == excl[0] || excl[2] == excl[1]) hi[2] = lo[2];
  }

  // the private servers as one index space, kUnroll of them a lane a
  // round so that their loads are in flight together
  best_s = __int_as_float(0x7f800000);
  best_i = INT_MAX;
  best_t = 0;
  const int len0 = hi[0] - lo[0], len01 = len0 + hi[1] - lo[1];
  const int total = len01 + hi[2] - lo[2];
  for (int t0 = hl; t0 < total; t0 += kUnroll * kLanes) {
    int mm[kUnroll], tier[kUnroll];
    float w[kUnroll], e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kLanes;
      mm[u] = t < len0 ? lo[0] + t
                       : (t < len01 ? lo[1] + t - len0 : lo[2] + t - len01);
      tier[u] = D;  // a private server shares a local's top-level group
      if (t < total) {
#pragma unroll
        for (int lvl = D - 2; lvl >= 0; --lvl) {
          const int gm = anc[lvl * m + mm[u]];
          if (gm == grp[lvl][0] || gm == grp[lvl][1] || gm == grp[lvl][2])
            tier[u] = lvl + 1;
        }
        if (mm[u] == loc[0] || mm[u] == loc[1] || mm[u] == loc[2])
          tier[u] = 0;
        w[u] = workload[mm[u]];
        e[u] = est[mm[u] * K + tier[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u * kLanes >= total) break;
      const float s = __fdiv_rn(w[u], e[u]);
      if (beats(s, mm[u], best_s, best_i)) {
        best_s = s;
        best_i = mm[u];
        best_t = tier[u];
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float so = __shfl_down_sync(hmask, best_s, off, kLanes);
    const int io = __shfl_down_sync(hmask, best_i, off, kLanes);
    const int to = __shfl_down_sync(hmask, best_t, off, kLanes);
    if (beats(so, io, best_s, best_i)) {
      best_s = so;
      best_i = io;
      best_t = to;
    }
  }
}

// Pass 2 where the table breaks the precondition: the block's threads
// stride over all M servers, for kSweep of its tasks a sweep (the
// registers of a sweep's bests fit the kernel's budget).
template <int D>
__device__ __forceinline__ void all_pairs(
    const float* __restrict__ workload, const float* __restrict__ est,
    const int* __restrict__ anc, const int* __restrict__ locs, int m, int b,
    int* __restrict__ server_out, int* __restrict__ tier_out,
    float* __restrict__ score_out) {
  constexpr int K = D + 2;
  constexpr int kSweep = 8;
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

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t0 = 0; t0 < kTasks; t0 += kSweep) {
    // (score, server) = (+inf, INT_MAX) loses to every real server, so an
    // all-infinite row still returns its lowest index, as argmin does
    float best_s[kSweep];
    int best_i[kSweep], best_t[kSweep];
#pragma unroll
    for (int t = 0; t < kSweep; ++t) {
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
      for (int t = 0; t < kSweep; ++t) {
        const int tt = t0 + t;
        int tier = D + 1;
#pragma unroll
        for (int lvl = D - 1; lvl >= 0; --lvl) {
          if (g[lvl] == s_grp[tt][lvl][0] || g[lvl] == s_grp[tt][lvl][1] ||
              g[lvl] == s_grp[tt][lvl][2])
            tier = lvl + 1;
        }
        if (mm == s_loc[tt][0] || mm == s_loc[tt][1] || mm == s_loc[tt][2])
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

#pragma unroll
    for (int t = 0; t < kSweep; ++t) {
      float s = best_s[t];
      int i = best_i[t], tr = best_t[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float so = __shfl_down_sync(kAll, s, off);
        const int io = __shfl_down_sync(kAll, i, off);
        const int to = __shfl_down_sync(kAll, tr, off);
        if (beats(so, io, s, i)) {
          s = so;
          i = io;
          tr = to;
        }
      }
      if (lane == 0) {
        s_score[t0 + t][warp] = s;
        s_server[t0 + t][warp] = i;
        s_tier[t0 + t][warp] = tr;
      }
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
__global__ void __launch_bounds__(kThreads, 4)
wwl_route_kernel(const float* __restrict__ workload,
                 const float* __restrict__ est, const int* __restrict__ anc,
                 const int* __restrict__ locs, int m, int b,
                 const Remote* __restrict__ remote,
                 int* __restrict__ server_out, int* __restrict__ tier_out,
                 float* __restrict__ score_out) {
  constexpr int K = D + 2;
  if (!remote->ranges) {  // block-uniform
    all_pairs<D>(workload, est, anc, locs, m, b, server_out, tier_out,
                 score_out);
    return;
  }
  // two tasks a warp: lanes 0-15 and 16-31
  const int hl = threadIdx.x & (kLanes - 1), shift = threadIdx.x & 16;
  const unsigned hmask = 0xffffu << shift;
  const int task = blockIdx.x * kTasks + threadIdx.x / kLanes;
  if (task >= b) return;  // whole half-warps
  float best_s;
  int best_i, best_t, excl[3];
  private_best<D>(workload, est, anc, locs, m, task, hl, hmask, shift,
                  best_s, best_i, best_t, excl);
  if (hl != 0) return;
  // the best remote server: the first pair whose group is not the task's
  int r = -1;
#pragma unroll
  for (int j = kSlots - 1; j >= 0; --j) {
    const unsigned long long key = remote->key[j];
    const int grp = remote->group[j];
    if (key != kEmpty && grp != excl[0] && grp != excl[1] && grp != excl[2])
      r = static_cast<int>(key & 0xffffffffu);
  }
  if (r >= 0) {
    const float rs = __fdiv_rn(workload[r], est[r * K + D + 1]);
    if (beats(rs, r, best_s, best_i)) {
      best_s = rs;
      best_i = r;
      best_t = D + 1;
    }
  }
  server_out[task] = best_i;
  tier_out[task] = best_t;
  score_out[task] = best_s;
}

template <int D>
cudaError_t launch(const float* w, const float* est, const int* anc,
                   const int* locs, int m, int b, int* server, int* tier,
                   float* score, Remote* remote, cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      wwl_remote_kernel<D>, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (allowed != cudaSuccess) return allowed;
  const int cluster =
      min(kMaxCluster, max(1, (m + kPerBlock - 1) / kPerBlock));
  const cudaError_t err = launch_cluster(wwl_remote_kernel<D>, cluster,
                                         kRemoteThreads, stream, w, est,
                                         anc, m, remote);
  if (err != cudaSuccess) return err;
  wwl_route_kernel<D><<<(b + kTasks - 1) / kTasks, kThreads, 0, stream>>>(
      w, est, anc, locs, m, b, remote, server, tier, score);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Every array is a contiguous device
// pointer: workload (m,) float32, est (m, depth+2) float32, anc (depth, m)
// int32, locs (b, 3) int32; outputs server (b,) int32, tier (b,) int32,
// score (b,) float32; scratch 64 bytes, written by the first launch and
// read by the second (its first int32 is 1 when the group-restricted path
// ran, 0 when the all-pairs one did).  Launches both passes on `stream`
// and returns the first failing launch's cudaError_t (0 on success);
// depth must be 0..4 and 1 <= b, 1 <= m < 2^30.
extern "C" int wwl_route_launch(const void* workload, const void* est,
                                const void* anc, const void* locs, int m,
                                int depth, int b, void* server, void* tier,
                                void* score, void* scratch, void* stream) {
  if (m < 1 || m >= (1 << 30) || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* wf = static_cast<const float*>(workload);
  const auto* ef = static_cast<const float*>(est);
  const auto* ai = static_cast<const int*>(anc);
  const auto* li = static_cast<const int*>(locs);
  auto* so = static_cast<int*>(server);
  auto* to = static_cast<int*>(tier);
  auto* sc = static_cast<float*>(score);
  auto* rm = static_cast<Remote*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
    case 0: err = launch<0>(wf, ef, ai, li, m, b, so, to, sc, rm, st); break;
    case 1: err = launch<1>(wf, ef, ai, li, m, b, so, to, sc, rm, st); break;
    case 2: err = launch<2>(wf, ef, ai, li, m, b, so, to, sc, rm, st); break;
    case 3: err = launch<3>(wf, ef, ai, li, m, b, so, to, sc, rm, st); break;
    case 4: err = launch<4>(wf, ef, ai, li, m, b, so, to, sc, rm, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
