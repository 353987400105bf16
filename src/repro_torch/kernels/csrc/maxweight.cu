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
// Exactness: every score is one correctly rounded product (__fmul_rn; the
// build passes --fmad=false), and every comparison is lexicographic on
// (score, -queue), so the kernel equals the plain version bit for bit.
//
// Precondition of the fast path: every row of the queue table is
// non-decreasing with nested groups (`slot_step.check_anc_ranges`), and
// every idle server's column of `idle_anc` is its own queue's column of
// `queue_anc` (as every caller passes it: idle_anc = queue_anc[:, idle]),
// with the idle ids inside 0..N-1.  Then an idle server's non-remote
// queues are its own top-level group, one range holding its own queue.
// Pass 1 checks all of this on the card while it reads the tables, and
// pass 2 runs the all-pairs loop where it fails.  No host read, no cache.
//
// Design: two launches a call.
//   * Pass 1 (`maxweight_remote_kernel`: one cluster of one block of 1024
//     threads for each 1024 queues, at most 16).  The remote rate w =
//     est[b, D+1] is one number a row, and fl(w Q) is monotone in Q for
//     w > 0, so the remote argmax follows the argmax of Q: each thread
//     keeps the two best (Q, queue) pairs of distinct top-level groups
//     (Q descending, then the index ascending, as 64-bit keys; Q > 0
//     only), selected exactly over the warp (two rounds of `redux.sync`
//     minima), the block, and the cluster (every block pushes its list
//     into every block's shared memory, and each block selects the final
//     pair itself).  Two, because an idle server excludes only its own
//     group.  But fl(w Q) is not one-to-one: two Q within 2^-22 of each
//     other can round to one product, and then the lower index wins even
//     with the smaller Q.  So a second sweep lists, in block 0, the queues
//     with Q in [Q*(1 - 2^-21), Q*) for either pair's Q* (up to kNear of
//     them; none for integer queue lengths below 2^21).  The same threads
//     check the precondition, and the flag is the OR over the cluster.
//   * Pass 2 (`maxweight_kernel`: half a warp an idle server, sixteen a
//     block of 256 threads), launched after pass 1 in stream order.
//     Every block first reads pass 1's flag.  When it is set, each idle
//     server's 16 lanes find its own group's range in the sorted top row
//     around its own queue (`run_bounds`, group_select.cuh: 8 lanes read
//     the 8 ids on each side, a second round probes 16, 24, ..., 72 away
//     where an end lies past them, then 8-ary narrowing) and score
//     those queues at their tiers, then take the remote candidate: the
//     first pair whose group is not their own, scored with their own w,
//     beside every listed near queue outside their group, rescored.
//     Where that shortcut does not hold exactly (Q* or w Q* not a normal
//     float, the list overflowed), the lanes scan every remote queue; for
//     a rate that is not positive and finite they scan every queue as the
//     all-pairs loop does.  When the flag is clear, the block runs the
//     all-pairs loop below for its sixteen idle servers, eight a sweep.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function reads Q
// and the queue ancestor table once (4 N (1 + D) bytes), the idle ids,
// their table and rates (4 B (1 + D + K) bytes), and writes 8 bytes per
// idle server: about 0.7 MB at N = 65536, B = 8192, D = 1, i.e. ~0.2 us;
// the work is one shared maximum of Q plus a product for every queue of
// each idle server's own group: it is bytes-bound.  Both passes are bound
// by latency instead (pass 1's selection rounds and barriers, pass 2's
// chain of dependent loads).  On an H100 80GB HBM3 at 700 W a call takes
// about 8.5 us of device time at the fleet shape (N = 10008, B = 5474,
// D = 1; pass 1 5.8, pass 2 2.7) and 11.9 us at N = 65536, B = 8192 (7.5
// and 4.3), against 0.066 and 0.54 ms for the all-pairs kernel it
// replaces (PERF.md row 3, chip_smoke.py phases 3 and 7).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

#include "group_select.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIdle = kThreads / kLanes;  // pass 2: idle servers a block
constexpr int kSlots = 2;                 // remote pairs of distinct groups
constexpr int kNear = 64;                 // near-tie queues listed at most
constexpr float kTiny = 7.8886091e-31f;  // 2^-100: well inside the normals

// What pass 1 hands pass 2 (the wrapper's scratch; see maxweight.py).
struct Remote {
  int ranges;  // 1: the tables meet the precondition
  int near;    // near-tie queues found (more than kNear: not all listed)
  unsigned long long key[kSlots];  // ascending; kEmpty when unused
  int group[kSlots];               // each key's top-level group
  int near_queue[kNear];
  int near_group[kNear];
};
static_assert(sizeof(Remote) <= 1024, "maxweight.py allocates 1 KiB");

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Ascending key of (Q descending, queue ascending), for Q > 0.
__device__ __forceinline__ unsigned long long max_key(float q, int i) {
  const unsigned u = ~(__float_as_uint(q) | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(i);
}

template <int D>
__global__ void __launch_bounds__(kRemoteThreads, 1)
    maxweight_remote_kernel(const float* __restrict__ queues,
                            const int* __restrict__ qanc,
                            const int* __restrict__ idle,
                            const int* __restrict__ ianc, int n, int b,
                            Remote* __restrict__ out) {
  constexpr int L = D > 0 ? D : 1;
  __shared__ unsigned long long s_k[kRemoteThreads / 32][kSlots];
  __shared__ int s_g[kRemoteThreads / 32][kSlots];
  // every block's list and flag, pushed into every block
  __shared__ unsigned long long c_k[kMaxCluster][kSlots];
  __shared__ int c_g[kMaxCluster][kSlots];
  __shared__ int c_bad[kMaxCluster];
  // the merged pairs and their Q; rank 0's: the near-tie list
  __shared__ unsigned long long f_k[kSlots];
  __shared__ int f_g[kSlots];
  __shared__ float f_q[kSlots];
  __shared__ int f_near;
  __shared__ int f_queue[kNear];
  __shared__ int f_group[kNear];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int stride = blocks * kRemoteThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) f_near = 0;
  unsigned long long k[kSlots];
  int g[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    k[j] = kEmpty;
    g[j] = 0;
  }
  bool bad = false;
  // warp-uniform rounds of kUnroll queues a lane: every load first
  for (int base = rank * kRemoteThreads + warp * 32; base < n;
       base += kUnroll * stride) {
    float q[kUnroll];
    int a[kUnroll][L];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int nn = base + lane + u * stride;
      if (nn < n) {
        q[u] = queues[nn];
#pragma unroll
        for (int lvl = 0; lvl < D; ++lvl) a[u][lvl] = qanc[lvl * n + nn];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int nn = base + lane + u * stride;
      // the precondition, on the pair (nn, nn + 1): the next queue's ids
      // come from the next lane, the last lane loads its own
      bool finer = true;  // below level 0 every queue is its own group
#pragma unroll
      for (int lvl = 0; lvl < D; ++lvl) {
        int c = __shfl_down_sync(kAll, a[u][lvl], 1);
        if (lane == 31 && nn + 1 < n) c = qanc[lvl * n + nn + 1];
        if (nn + 1 < n)
          bad = bad || c < a[u][lvl] || (c != a[u][lvl] && !finer);
        finer = c != a[u][lvl];
      }
      if (nn < n && q[u] > 0.0f)
        insert(k, g, max_key(q[u], nn), D > 0 ? a[u][L - 1] : nn);
    }
  }
  // each idle server's own queue, and its column of the table
  for (int bb = rank * kRemoteThreads + threadIdx.x; bb < b; bb += stride) {
    const int id = idle[bb];
    if (id < 0 || id >= n) {
      bad = true;
      continue;
    }
#pragma unroll
    for (int lvl = 0; lvl < D; ++lvl)
      bad = bad || ianc[lvl * b + bb] != qanc[lvl * n + id];
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
    if (lane < blocks) {  // lane r pushes the block's list into block r
      unsigned long long* rk = cluster.map_shared_rank(&c_k[rank][0], lane);
      int* rg = cluster.map_shared_rank(&c_g[rank][0], lane);
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        rk[j] = k[j];
        rg[j] = g[j];
      }
      *cluster.map_shared_rank(&c_bad[rank], lane) = any_bad;
    }
  }
  cluster.sync();
  if (warp == 0) {  // every block merges the lists itself
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      k[j] = lane < blocks ? c_k[lane][j] : kEmpty;
      g[j] = lane < blocks ? c_g[lane][j] : 0;
    }
    const int bad_all = __any_sync(kAll, lane < blocks && c_bad[lane]);
    if (blocks > 1) warp_select(k, g);  // one block: lane 0 has the list
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        f_k[j] = k[j];
        f_g[j] = g[j];
        f_q[j] = k[j] != kEmpty
                     ? queues[static_cast<int>(k[j] & 0xffffffffu)]
                     : 0.0f;
      }
      if (rank == 0) out->ranges = !bad_all;
    }
  }
  __syncthreads();

  // second sweep: the queues whose product may round onto a pair's
  float qs[kSlots], thr[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    qs[j] = f_q[j];  // 0 for an unused pair: no queue lies in [thr, 0)
    thr[j] = __fmul_rn(qs[j], 1.0f - 4.76837158e-7f);  // Q* (1 - 2^-21)
  }
  int* near = cluster.map_shared_rank(&f_near, 0);
  int* near_queue = cluster.map_shared_rank(&f_queue[0], 0);
  int* near_group = cluster.map_shared_rank(&f_group[0], 0);
  for (int nn = rank * kRemoteThreads + threadIdx.x; nn < n; nn += stride) {
    const float q = queues[nn];
    bool hit = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) hit = hit || (q >= thr[j] && q < qs[j]);
    if (q > 0.0f && hit) {
      const int slot = atomicAdd(near, 1);
      if (slot < kNear) {
        near_queue[slot] = nn;
        near_group[slot] = D > 0 ? qanc[(D - 1) * n + nn] : nn;
      }
    }
  }
  cluster.sync();
  if (rank == 0) {
    const int count = f_near;
    if (threadIdx.x == 0) {
      out->near = count;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        out->key[j] = f_k[j];
        out->group[j] = f_g[j];
      }
    }
    for (int t = threadIdx.x; t < min(count, kNear); t += kRemoteThreads) {
      out->near_queue[t] = f_queue[t];
      out->near_group[t] = f_group[t];
    }
  }
}

// Tier of queue nn for an idle server with own queue `id` and groups
// `grp`, deepest level first with the self override.
template <int D>
__device__ __forceinline__ int tier_of(const int* __restrict__ qanc, int n,
                                       int nn, int id,
                                       const int (&grp)[D > 0 ? D : 1],
                                       int from_level, int start) {
  int tier = start;
#pragma unroll
  for (int lvl = D - 1; lvl >= 0; --lvl)
    if (lvl < from_level && qanc[lvl * n + nn] == grp[lvl]) tier = lvl + 1;
  return nn == id ? 0 : tier;
}

// What pass 2 knows of one idle server before it reads pass 1's results.
template <int D>
struct Claim {
  int id;          // its own queue
  int own;         // its top-level group (its own queue at depth 0)
  int lo, hi;      // the own group's range of queues
  bool rates_ok;   // every rate a positive finite float
  float w_remote;  // est[row, D + 1]
  float best_s;    // this lane's best so far
  int best_i;
};

// Pass 2's first part, for one idle server by one warp: the queues of its
// own top-level group at their tiers, or, with a rate that is not
// positive and finite, every queue as the all-pairs loop scores it.  Only
// where the tables meet the precondition.
template <int D>
__device__ __forceinline__ Claim<D> own_group(
    const float* __restrict__ queues, const int* __restrict__ qanc,
    const int* __restrict__ idle, const int* __restrict__ ianc,
    const float* __restrict__ est, int n, int b, int row, int hl,
    unsigned hmask, int shift) {
  constexpr int K = D + 2;
  const float neg_inf = __int_as_float(0xff800000);
  Claim<D> c;
  c.id = idle[row];
  float e[K];
  c.rates_ok = true;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    e[j] = est[row * K + j];
    c.rates_ok = c.rates_ok && e[j] > 0.0f && e[j] <= FLT_MAX;
  }
  c.w_remote = e[D + 1];
  int grp[D > 0 ? D : 1];
#pragma unroll
  for (int lvl = 0; lvl < D; ++lvl) grp[lvl] = ianc[lvl * b + row];
  c.own = D > 0 ? grp[D > 0 ? D - 1 : 0] : c.id;
  c.best_s = neg_inf;
  c.best_i = INT_MAX;
  if (!c.rates_ok) {
    for (int nn = hl; nn < n; nn += kLanes) {
      const int tier = tier_of<D>(qanc, n, nn, c.id, grp, D, D + 1);
      float w = e[0];
#pragma unroll
      for (int j = 1; j < K; ++j) w = tier == j ? e[j] : w;
      const float q = queues[nn];
      const float s = q > 0.0f ? __fmul_rn(w, q) : neg_inf;
      if (beats(s, nn, c.best_s, c.best_i)) {
        c.best_s = s;
        c.best_i = nn;
      }
    }
    return c;
  }
  c.lo = c.id;
  c.hi = c.id + 1;
  if constexpr (D > 0) {
    const int p[1] = {c.id}, g[1] = {c.own};
    int lo[1], hi[1];
    run_bounds<kLanes, 1>(qanc + (D - 1) * n, n, p, g, hl, hmask, shift, lo,
                          hi);
    c.lo = lo[0];
    c.hi = hi[0];
  }
  // kUnroll queues a lane a round, so that their loads are in flight
  // together
  for (int n0 = c.lo + hl; n0 < c.hi; n0 += kUnroll * kLanes) {
    float q[kUnroll], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int nn = n0 + u * kLanes;
      if (nn < c.hi) {
        // a queue of the own range shares the top-level group
        const int tier = tier_of<D>(qanc, n, nn, c.id, grp, D - 1, D);
        w[u] = e[0];
#pragma unroll
        for (int j = 1; j <= D; ++j) w[u] = tier == j ? e[j] : w[u];
        q[u] = queues[nn];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int nn = n0 + u * kLanes;
      if (nn >= c.hi) break;
      const float s = q[u] > 0.0f ? __fmul_rn(w[u], q[u]) : neg_inf;
      if (beats(s, nn, c.best_s, c.best_i)) {
        c.best_s = s;
        c.best_i = nn;
      }
    }
  }
  return c;
}

// Pass 2's second part, with pass 1's results: the remote candidate (the
// first pair outside the own group, scored with the remote rate, beside
// the listed near queues outside it; or every remote queue where that
// shortcut does not hold exactly), then the warp's best.
template <int D>
__device__ __forceinline__ void finish_claim(
    const float* __restrict__ queues, int n,
    const Remote* __restrict__ remote, Claim<D>& c, int hl, unsigned hmask,
    int row,
    int* __restrict__ queue_out, float* __restrict__ score_out) {
  const float neg_inf = __int_as_float(0xff800000);
  if (c.rates_ok) {
    int r = -1;
#pragma unroll
    for (int j = kSlots - 1; j >= 0; --j) {
      const unsigned long long key = remote->key[j];
      if (key != kEmpty && remote->group[j] != c.own)
        r = static_cast<int>(key & 0xffffffffu);
    }
    if (r >= 0) {
      const int nnear = remote->near;
      const float w = c.w_remote;
      const float qr = queues[r];
      const float top = __fmul_rn(w, qr);
      if (qr >= kTiny && top >= kTiny && top <= FLT_MAX && nnear <= kNear) {
        if (hl == 0 && beats(top, r, c.best_s, c.best_i)) {
          c.best_s = top;
          c.best_i = r;
        }
        for (int t = hl; t < nnear; t += kLanes) {
          if (remote->near_group[t] == c.own) continue;
          const int nn = remote->near_queue[t];
          const float s = __fmul_rn(w, queues[nn]);
          if (beats(s, nn, c.best_s, c.best_i)) {
            c.best_s = s;
            c.best_i = nn;
          }
        }
      } else {
        for (int nn = hl; nn < n; nn += kLanes) {
          if (nn >= c.lo && nn < c.hi) continue;
          const float q = queues[nn];
          if (!(q > 0.0f)) continue;
          const float s = __fmul_rn(w, q);
          if (beats(s, nn, c.best_s, c.best_i)) {
            c.best_s = s;
            c.best_i = nn;
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float so = __shfl_down_sync(hmask, c.best_s, off, kLanes);
    const int io = __shfl_down_sync(hmask, c.best_i, off, kLanes);
    if (beats(so, io, c.best_s, c.best_i)) {
      c.best_s = so;
      c.best_i = io;
    }
  }
  if (hl == 0) {
    // with positive finite rates a score is -inf only for an empty queue,
    // so a best of -inf means every queue is empty: queue 0, as argmax
    if (c.rates_ok && c.best_s == neg_inf) c.best_i = 0;
    queue_out[row] = c.best_i;
    score_out[row] = c.best_s;
  }
}

// Pass 2 where the tables break the precondition: the block's threads
// stride over all N queues, for kSweep of its idle servers a sweep (the
// registers of a sweep's bests fit the kernel's budget).
template <int D>
__device__ __forceinline__ void all_pairs(
    const float* __restrict__ queues, const int* __restrict__ qanc,
    const int* __restrict__ idle, const int* __restrict__ ianc,
    const float* __restrict__ est, int n, int b, int* __restrict__ queue_out,
    float* __restrict__ score_out) {
  constexpr int K = D + 2;
  constexpr int kSweep = 8;
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t0 = 0; t0 < kIdle; t0 += kSweep) {
    float best_s[kSweep];
    int best_i[kSweep];
#pragma unroll
    for (int t = 0; t < kSweep; ++t) {
      best_s[t] = neg_inf;
      best_i[t] = INT_MAX;
    }

    for (int nn = threadIdx.x; nn < n; nn += kThreads) {
      const float q = queues[nn];
      int g[D > 0 ? D : 1];
#pragma unroll
      for (int lvl = 0; lvl < D; ++lvl) g[lvl] = qanc[lvl * n + nn];

#pragma unroll
      for (int t = 0; t < kSweep; ++t) {
        const int tt = t0 + t;
        int tier = D + 1;
#pragma unroll
        for (int lvl = D - 1; lvl >= 0; --lvl) {
          if (g[lvl] == s_grp[tt][lvl]) tier = lvl + 1;
        }
        if (nn == s_id[tt]) tier = 0;
        float w = s_est[tt][0];
#pragma unroll
        for (int c = 1; c < K; ++c) w = tier == c ? s_est[tt][c] : w;
        const float s = q > 0.0f ? __fmul_rn(w, q) : neg_inf;
        if (beats(s, nn, best_s[t], best_i[t])) {
          best_s[t] = s;
          best_i[t] = nn;
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kSweep; ++t) {
      float s = best_s[t];
      int i = best_i[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float so = __shfl_down_sync(kAll, s, off);
        const int io = __shfl_down_sync(kAll, i, off);
        if (beats(so, io, s, i)) {
          s = so;
          i = io;
        }
      }
      if (lane == 0) {
        s_score[t0 + t][warp] = s;
        s_queue[t0 + t][warp] = i;
      }
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
__global__ void __launch_bounds__(kThreads, 4)
maxweight_kernel(const float* __restrict__ queues,
                 const int* __restrict__ qanc, const int* __restrict__ idle,
                 const int* __restrict__ ianc, const float* __restrict__ est,
                 int n, int b, const Remote* __restrict__ remote,
                 int* __restrict__ queue_out, float* __restrict__ score_out) {
  if (!remote->ranges) {  // block-uniform
    all_pairs<D>(queues, qanc, idle, ianc, est, n, b, queue_out, score_out);
    return;
  }
  // two idle servers a warp: lanes 0-15 and 16-31
  const int hl = threadIdx.x & (kLanes - 1), shift = threadIdx.x & 16;
  const unsigned hmask = 0xffffu << shift;
  const int row = blockIdx.x * kIdle + threadIdx.x / kLanes;
  if (row >= b) return;  // whole half-warps
  Claim<D> c = own_group<D>(queues, qanc, idle, ianc, est, n, b, row, hl,
                            hmask, shift);
  finish_claim<D>(queues, n, remote, c, hl, hmask, row, queue_out,
                  score_out);
}

template <int D>
cudaError_t launch(const float* q, const int* qanc, const int* idle,
                   const int* ianc, const float* est, int n, int b,
                   int* queue, float* score, Remote* remote,
                   cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      maxweight_remote_kernel<D>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  const int cluster =
      min(kMaxCluster, max(1, (n + kPerBlock - 1) / kPerBlock));
  const cudaError_t err =
      launch_cluster(maxweight_remote_kernel<D>, cluster, kRemoteThreads,
                     stream, q, qanc, idle, ianc, n, b, remote);
  if (err != cudaSuccess) return err;
  maxweight_kernel<D><<<(b + kIdle - 1) / kIdle, kThreads, 0, stream>>>(
      q, qanc, idle, ianc, est, n, b, remote, queue, score);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Every array is a contiguous device
// pointer: queues (n,) float32, qanc (depth, n) int32, idle (b,) int32,
// ianc (depth, b) int32, est (b, depth+2) float32; outputs queue (b,)
// int32, score (b,) float32; scratch 1 KiB, written by the first launch
// and read by the second (its first int32 is 1 when the group-restricted
// path ran, 0 when the all-pairs one did).  Launches both passes on
// `stream` and returns the first failing launch's cudaError_t (0 on
// success); depth must be 0..4 and 1 <= b, 1 <= n < 2^30.
extern "C" int maxweight_launch(const void* queues, const void* qanc,
                                const void* idle, const void* ianc,
                                const void* est, int n, int depth, int b,
                                void* queue, void* score, void* scratch,
                                void* stream) {
  if (n < 1 || n >= (1 << 30) || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(queues);
  const auto* qa = static_cast<const int*>(qanc);
  const auto* id = static_cast<const int*>(idle);
  const auto* ia = static_cast<const int*>(ianc);
  const auto* ef = static_cast<const float*>(est);
  auto* qo = static_cast<int*>(queue);
  auto* so = static_cast<float*>(score);
  auto* rm = static_cast<Remote*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
    case 0: err = launch<0>(qf, qa, id, ia, ef, n, b, qo, so, rm, st); break;
    case 1: err = launch<1>(qf, qa, id, ia, ef, n, b, qo, so, rm, st); break;
    case 2: err = launch<2>(qf, qa, id, ia, ef, n, b, qo, so, rm, st); break;
    case 3: err = launch<3>(qf, qa, id, ia, ef, n, b, qo, so, rm, st); break;
    case 4: err = launch<4>(qf, qa, id, ia, ef, n, b, qo, so, rm, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
