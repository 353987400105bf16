// Shared pieces of the group-restricted scheduling kernels for Hopper
// (sm_90a): the exact selection of the best keys of distinct groups (per
// thread, over a warp) and the cluster launch of the two-pass kernels
// (wwl_route.cu, maxweight.cu), and the search for a group's range in a
// sorted ancestor row by a task's lanes (those two and fleet_route.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kRemoteThreads = 1024;  // pass 1: threads a block
constexpr int kPerBlock = 1024;       // pass 1: items a block, at most
constexpr int kMaxCluster = 16;       // pass 1: blocks of the one cluster
constexpr int kLanes = 16;            // pass 2: lanes a task
constexpr int kUnroll = 4;            // loads in flight a lane

// Insert (key, grp) into the ascending list of the best keys of distinct
// groups: a group keeps its best key only.
template <int S>
__device__ __forceinline__ void insert(unsigned long long (&k)[S],
                                       int (&g)[S], unsigned long long key,
                                       int grp) {
  if (key >= k[S - 1]) return;
  int dup = S;
  unsigned long long kd = kEmpty;
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (k[j] != kEmpty && g[j] == grp) {
      dup = j;
      kd = k[j];
    }
  if (dup < S) {
    if (kd <= key) return;
#pragma unroll
    for (int j = 0; j < S - 1; ++j)
      if (j >= dup) {
        k[j] = k[j + 1];
        g[j] = g[j + 1];
      }
  }
  k[S - 1] = key;
  g[S - 1] = grp;
#pragma unroll
  for (int j = S - 1; j > 0; --j)
    if (k[j] < k[j - 1]) {
      const unsigned long long tk = k[j];
      k[j] = k[j - 1];
      k[j - 1] = tk;
      const int tg = g[j];
      g[j] = g[j - 1];
      g[j - 1] = tg;
    }
}

// The least key over the warp: the high words first, then the low words
// of the lanes that hold the least high word.
__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  const unsigned hi = static_cast<unsigned>(x >> 32);
  const unsigned mh = __reduce_min_sync(kAll, hi);
  const unsigned ml = __reduce_min_sync(
      kAll, hi == mh ? static_cast<unsigned>(x) : 0xffffffffu);
  return (static_cast<unsigned long long>(mh) << 32) | ml;
}

// The warp's best S keys of distinct groups, from every lane's list
// (ascending, distinct groups), in S rounds: round r takes the least,
// over the lanes, of each lane's first entry whose group no earlier round
// took (exact: a lane's best entry outside r taken groups is among its
// first r + 1).  Every lane ends with the result.
template <int S>
__device__ __forceinline__ void warp_select(unsigned long long (&k)[S],
                                            int (&g)[S]) {
  unsigned long long rk[S];
  int rg[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    unsigned long long ck = kEmpty;
    int cg = 0;
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
      bool taken = false;
#pragma unroll
      for (int t = 0; t < r; ++t) taken = taken || rg[t] == g[j];
      if (k[j] != kEmpty && !taken) {
        ck = k[j];
        cg = g[j];
      }
    }
    const unsigned long long mk = warp_min(ck);
    const unsigned owner = __ballot_sync(kAll, ck == mk);
    rk[r] = mk;
    rg[r] = __shfl_sync(kAll, cg, __ffs(owner) - 1);
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    k[j] = rk[j];
    g[j] = rg[j];
  }
}

// i / S of len, in 64 bits (len may be near 2^30)
template <int S>
__device__ __forceinline__ int part(int i, int len) {
  return static_cast<int>(static_cast<long long>(i) * len / S);
}

// [lo, hi) of the run of g[j] that holds p[j] in the non-decreasing row r
// of length n, for J positions at once, by a task's LANES lanes (16 or
// 32; `hl` 0..LANES-1, `hmask` and `shift` place them in the warp), in
// rounds of one load a lane and a ballot: the lower half of the lanes
// looks below p, the upper half above, S = LANES/2 probes a side.  Round
// 1 reads the window of the S ids on each side of p (contiguous), which
// holds both ends of any run of up to S servers around p.  Where an end
// lies past it, round 2 reads distances 2 S, 3 S, .., S S + S (an end
// past those too is bracketed by the end of the row); then S-ary
// narrowing of each gap between the last probe found equal and the first
// found different.  A run of up to S S + S servers takes at most three
// rounds.  Every load lies inside the row, and the loop ends on any row
// (each narrowing round narrows every gap).
template <int LANES, int J>
__device__ __forceinline__ void run_bounds(const int* __restrict__ r, int n,
                                           const int (&p)[J],
                                           const int (&g)[J], int hl,
                                           unsigned hmask, int shift,
                                           int (&lo)[J], int (&hi)[J]) {
  constexpr int S = LANES / 2;  // probes a side
  constexpr unsigned kOne = (1u << S) - 1u;
  const bool up = hl >= S;
  const int i = hl & (S - 1);
  bool open = false;  // an end past the window
#pragma unroll
  for (int j = 0; j < J; ++j) {  // the window: lo, hi - 1 known equal
    const int pos = up ? p[j] + 1 + i : p[j] - 1 - i;
    const bool same = pos >= 0 && pos < n && r[pos] == g[j];
    const unsigned mask = __ballot_sync(hmask, same) >> shift;
    const int fd = __ffs(~mask & kOne) - 1;  // -1: every probe equal
    const int fu = __ffs(~(mask >> S) & kOne) - 1;
    lo[j] = p[j] - (fd < 0 ? S : fd);
    hi[j] = p[j] + (fu < 0 ? S : fu) + 1;
    open = open || fd < 0 || fu < 0;
  }
  if (open) {  // uniform: the task's lanes hold the same masks
    int klo[J], blo[J], khi[J], bhi[J];  // known equal / known different
#pragma unroll
    for (int j = 0; j < J; ++j) {  // distances S (i + 2)
      // a side is open where its window probes were all equal
      const bool open_lo = lo[j] == p[j] - S;
      const bool open_hi = hi[j] == p[j] + S + 1;
      klo[j] = lo[j];
      blo[j] = lo[j] - 1;
      khi[j] = hi[j] - 1;
      bhi[j] = hi[j];
      const int d = S * (i + 2);
      const int pos = up ? min(p[j] + d, n) : max(p[j] - d, -1);
      const bool same = (up ? open_hi : open_lo) && pos >= 0 && pos < n &&
                        r[pos] == g[j];
      const unsigned mask = __ballot_sync(hmask, same) >> shift;
      if (open_lo) {
        const int f = __ffs(~mask & kOne) - 1;  // -1: every probe equal
        klo[j] = p[j] - S * (f < 0 ? S + 1 : f + 1);
        blo[j] = f < 0 ? -1 : max(p[j] - S * (f + 2), -1);
      }
      if (open_hi) {
        const int f = __ffs(~(mask >> S) & kOne) - 1;
        khi[j] = p[j] + S * (f < 0 ? S + 1 : f + 1);
        bhi[j] = f < 0 ? n : min(p[j] + S * (f + 2), n);
      }
    }
    while (true) {  // narrowing
      bool more = false;
#pragma unroll
      for (int j = 0; j < J; ++j)
        more = more || klo[j] - blo[j] > 1 || bhi[j] - khi[j] > 1;
      if (!more) break;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int ld = klo[j] - blo[j] - 1, lu = bhi[j] - khi[j] - 1;
        // probes ascend through the gap: blo + 1 + part(i, ld) below p
        const int len = up ? lu : ld, from = up ? khi[j] : blo[j];
        bool same = false;
        if (len > 0) same = r[from + 1 + part<S>(i, len)] == g[j];
        const unsigned mask = __ballot_sync(hmask, same) >> shift;
        if (ld > 0) {  // equal ids form a suffix of the gap below p
          const unsigned eq = mask & kOne;
          if (eq) {
            const int f = __ffs(eq) - 1;
            const int nb = f ? blo[j] + 1 + part<S>(f - 1, ld) : blo[j];
            klo[j] = blo[j] + 1 + part<S>(f, ld);
            blo[j] = nb;
          } else {
            blo[j] = blo[j] + 1 + part<S>(S - 1, ld);
          }
        }
        if (lu > 0) {  // equal ids form a prefix of the gap above p
          const unsigned ne = ~(mask >> S) & kOne;
          if (ne) {
            const int f = __ffs(ne) - 1;
            const int nk = f ? khi[j] + 1 + part<S>(f - 1, lu) : khi[j];
            bhi[j] = khi[j] + 1 + part<S>(f, lu);
            khi[j] = nk;
          } else {
            khi[j] = khi[j] + 1 + part<S>(S - 1, lu);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      lo[j] = klo[j];
      hi[j] = bhi[j];
    }
  }
}

// Launch `kernel` on `grid` blocks of `threads` threads as one cluster of
// the whole grid (pass 1, whose blocks meet through distributed shared
// memory; one block needs no cluster attribute).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int grid, int threads,
                           cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = grid > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
