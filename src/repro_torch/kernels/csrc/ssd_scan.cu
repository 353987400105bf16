// Mamba-2 SSD (state-space duality) scan with initial and final state,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (launched by `ssd_chunked`).  Semantics
// contract: repro_torch/kernels/ref.py::ssd.
//
//   x (B, T, H, P), b and c (B, T, N) in one type (float32 or bf16),
//   a (B, T, H) float32 log-decay <= 0, h0 (B, H, P, N) float32 (or none,
//   zeros, for the chunked kernels); for every (batch, head), in order
//   over t:
//     h_t = exp(a_t) h_{t-1} + x_t (outer) b_t,   y_t = h_t c_t;
//   y (B, T, H, P) in x's type, hT = h_T (B, H, P, N) float32.
//
// Three kernels, chosen by the caller (`ssd_scan_launch`'s route code; the
// rule lives in ssd_scan.py's `route`): P a multiple of 8 up to 64 and N
// a multiple of 8 run the chunked form on the tensor cores, bf16 in
// `ssd_tc_kernel`, float32 as split TF32 in `ssd_tf32_kernel`; other
// shapes (N = 4, P over 64) run the recurrent form on the CUDA cores
// (`ssd_scan_kernel`).  One TF32 product keeps about 11 significant bits,
// too few for float32's 3e-4 limit; a split one (hi hi + hi lo + lo hi,
// split_tf32.cuh) keeps about 21, which meets it.  The float32 chunked
// kernel reads x, b and c at any strides with the last axis contiguous
// (b and c with rows 16-byte aligned).  Nothing falls back on an error:
// a launch returns its error.
//
// bf16 design (the tensor cores).  Within a chunk of L = 64 steps the
// output is a masked (L, L) product and only the chunk-to-chunk state is
// sequential (Dao & Gu 2024), as in the Pallas kernel.  One block of 288
// threads owns one (batch, head) and its whole (P, N) state, and a loop
// over chunks inside the block takes the place of the Pallas kernel's
// sequential chunk grid axis.  Its VMEM state scratch becomes the float32
// accumulator (64 rows p, P padded to 64, x N columns) of the state
// warpgroup.  A producer warp keeps a 2-stage ring of chunks full with
// TMA (x as a 4-d map (P, H, T, B), b and c as (N, T, B); 64-column
// boxes, 128-byte swizzle; rows past T and columns past P or N come in as
// zeros and never from the next batch).  With lcum the inclusive prefix
// sum of a over the chunk (two warp scans, log2 units; each warpgroup
// keeps its own) and total its last value, per chunk:
//   * the state warpgroup makes w o B (w_s = exp(total - lcum_s)) in B's
//     swizzled layout, scales h by exp(total) and adds X^T (w o B)
//     (`wgmma` m64n{64,128}k16, both operands MN-major from shared
//     memory), then writes h's bf16 copy for the next chunk's C h^T into
//     one of two buffers (mbarriers: copy full / copy read);
//   * the output warpgroup takes S = C B^T and Z = C h^T over that copy
//     (m64n64k16, K-major), S'[t, u] = S exp(lcum_t - lcum_u) for u <= t
//     (else 0) into bf16 register-A pairs, y = exp(lcum_t) Z + S' X (X an
//     MN-major B), and stores y rows < T, rounded once;
//   * both release the stage (an mbarrier of 256 arrivals).
// The state chain (h_k from h_{k-1}) does not wait for the outputs, so
// the state warpgroup runs up to a chunk ahead and the two overlap: at
// T = 8192 this took the kernel from 0.495 ms (one warpgroup doing both
// in turn) to 0.32-0.34 ms on an H100 80GB HBM3 at 700 W.  Every wgmma
// is issued and waited for inside straight-line code (ptxas serialises
// products in flight across a branch); computing the next chunk's S
// under this chunk's S' ran out of registers at 288 threads (C7511) and
// was slower (0.41 ms).  Every exponent is <= 0 (differences clamped at
// 0, as in the Pallas kernel), so nothing overflows.  A ragged last chunk
// carries a = 0 and b = 0 past T, which leaves the state as it was, as
// `ssd_chunked` pads.  L = 64 keeps S, y (64 x 64) and the state (64 x
// 128) in one warpgroup's registers each, and the ring (2 x 40 KB at
// N = 128), w o B and two state copies (32 KB each) in 178 KB of shared
// memory; L = 128 would need two warpgroups for the outputs.
// Rounding: three float32 values feed the tensor cores, each as a pair
// of bf16 hi + lo (hi = bf16(v), lo = bf16(v - hi), about 2^-17 of v):
// S' (the scores times their decay), w o B, and the state's copy used
// in C h^T; each costs a second product.  In one bf16 each (2^-9) they
// broke the existing limits or came near them on an H100: w o B put the
// float32 final state 6e-3 off (limit 3e-4); S' put one y element of
// 33.5M at T = 8192 0.036 off (limit 0.03 + 3% of the value); the state
// copy in one bf16 took the worst y element from 23% to 67% of its
// limit at T = 8192 for 7% of the time.  So the only bf16 roundings are
// the inputs' and y's own; sums and the state are float32.
//
// float32 design (split TF32 on the tensor cores, `ssd_tf32_kernel`).
// The bf16 kernel's chunked form, L = 64, one block a (batch, head), a
// state warpgroup and an output warpgroup, with every product split TF32
// (three `wgmma` m64n64k8 .tf32 a product: lo hi, hi lo, hi hi) and all
// sums and the state float32.  `wgmma` takes no transpose for .tf32, so
// every shared operand is K-major, and the operands are laid out for it:
//   * the output warpgroup takes S = C B^T and Z = C h^T with C and B as
//     stored (rows t, K-major over N) and h's copy (rows p, over N),
//     S' = S exp(lcum_t - lcum_u) (u <= t) split in registers into A
//     fragments, and y = exp(lcum_t) Z + S' X with X stored transposed,
//     X^T (rows p, over the chunk's steps in `tf32::kperm` order, which
//     lets the accumulator's S' be an A fragment without a shuffle);
//   * the state warpgroup keeps h^T (rows n, in N / 64 blocks of 64;
//     columns p) and adds (w o B)^T X with (w o B)^T built in registers as
//     A fragments from the B tile (hi + lo, times w_u = exp(total -
//     lcum_u), split again), against the same X^T: one transposed copy of
//     X a chunk serves both products, and no transposed B is stored;
//     then it writes h's copy for the next chunk's Z (rows p, over n).
// A producer warpgroup copies the raw float32 of C, B and X from the
// caller's strides (`mamba_block`'s b and c are views into the
// convolution's output) straight to where each hi goes, by `cp.async` (no
// register holds them): C and B 16 bytes at a time, X one value at a time
// into X^T, 4 steps of a column p a thread that `kperm` puts side by
// side; then it splits them in place, 16 bytes at a time (hi there, lo
// into the lo tile).  Each tile is released on its own barrier, so the
// next chunk's C goes in while this chunk's y and state products run.
// The producer sets the pace: loading through registers held 64-160
// values a thread and spilled, and 4-byte copies and splits took 1.57 ms
// at T = 8192 against this form's 1.16 ms (`chip_smoke.py` phase 3c, on
// an H100 80GB HBM3 at 700 W).
// Shared memory is the limit: at N = 128 the split C and B are 64 KB
// each, X^T 32 KB and h's copy 64 KB, 224 KB of the 227 KB a block can
// have, so there is one buffer of each (the bf16 kernel has a 2-stage
// ring and two state copies).  Every exponent is <= 0 and a ragged last
// chunk carries a = 0 and b = 0 past T, as in the bf16 kernel.
//
// The recurrent form (the CUDA cores; float32 and bf16 at the shapes the
// chunked kernels do not take).  Each row p of a head's (P, N) state
// evolves on its own: row p at step t needs only x[t, p], the step's
// decay and the shared b_t and c_t.  So the TPU's
// sequential chunk grid becomes a loop over t inside a block that owns
// ROWS rows of the state of one (batch, head); blocks never exchange
// anything, and a grid of (P / ROWS, H, B) puts 256 blocks in flight at
// mamba2-1.3b's widths (P 64, N 128, H 64).  A block has 128 threads: G
// = N / NPT threads share a row, each holding NPT (<= 16) state entries
// in registers for the whole sequence (columns n = 4 G q + 4 g + i, i <
// 4, so that the G lanes of a row read b and c as conflict-free
// float4s).  Per step a thread does NPT decays and rank-1 updates and
// NPT products with c, and the row's G lanes sum their products with
// warp shuffles.  Steps are staged kLT = 32 at a time: the block copies
// the steps' decays (expf of a, once), b, c and its rows of x into
// shared memory as float32 (37 KB at N 128), walks them, and writes the
// steps' y rows back coalesced.  Each thread's share of the next stage
// is loaded into registers before the block walks the current one, so
// the global loads overlap the steps.  A ragged last stage is cut at T.
// N is a template parameter (4, 8, 16, 32, 64, 128); P is taken at run
// time and rows past P are masked.  The step's update and product call
// fmaf() explicitly, which the build's global --fmad=false leaves fused.
//
// Bound on an H100 SXM: the function reads x, a, b, c and h0 once and
// writes y and hT (bytes / 3.35 TB/s); the least work is the chunked
// form, about 2 L P + 4 P N flops a step and head with C B^T shared by
// the heads (flops / 989 TFLOP/s in bf16).  mamba2-1.3b's prefill
// (T <= 128: 6 MB, 1.9 us) and a long prefill (T = 8192: 145 MB, 43 us)
// are both bound by bytes in bf16; in float32 (three TF32 products a
// product at 494.7 TFLOP/s, about 165 TFLOP/s) a long prefill is bound
// by operations (0.16 ms).  On an H100 80GB HBM3 at 700 W the recurrent
// kernel, which ran bf16 too before the chunked one, takes 1.99 ms at
// T = 8192 (46x the bound) and the chunked one 0.32-0.34 ms (PERF.md row
// 5 has both kernels' times).  The chunked kernel's grid is H x B blocks
// (64 at B = 1, on 132 SMs) walking the chunks in order: at long T the
// chain of chunks, not the bytes, sets its time, and a chunk-parallel
// (three-pass) form is the next step.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <math.h>
#include <stddef.h>

#include "split_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// The recurrent form on the CUDA cores (float32; bf16 shapes the tensor-
// core kernel cannot take)
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kLT = 32;   // steps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int N>
struct Layout {
  static constexpr int NPT = N < 16 ? N : 16;   // state entries a thread
  static constexpr int G = N / NPT;              // threads a row
  static constexpr int ROWS = kThreads / G;      // state rows a block
  static_assert(NPT % 4 == 0 && N % NPT == 0 && 32 % G == 0,
                "N must be 4, 8, 16, 32, 64 or 128");
  // column of a thread's entry j: float4 q = j / 4 of lane g
  static __device__ __forceinline__ int col(int g, int j) {
    return (j >> 2) * (4 * G) + 4 * g + (j & 3);
  }
};

// One thread's share of a stage's inputs, held in registers between the
// global loads and the shared-memory stores, so that the loads of stage
// k + 1 are in flight while the block walks stage k.  Loops of fixed
// trip count, fully unrolled: every load of a stage issues back to back.
template <typename T, int N>
struct StageRegs {
  static constexpr int ROWS = Layout<N>::ROWS;
  static constexpr int BC = kLT * N / kThreads;     // b and c elements
  static constexpr int XS = kLT * ROWS / kThreads;  // x elements
  T b[BC], c[BC], x[XS];
  float a;

  __device__ __forceinline__ void load(const T* __restrict__ xg,
                                       const float* __restrict__ ag,
                                       const T* __restrict__ bg,
                                       const T* __restrict__ cg, int tid,
                                       int bb, int h, int p0, int t0,
                                       int t_len, int heads, int p_dim) {
    const int steps = min(kLT, t_len - t0);
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      const int e = tid + i * kThreads, s = e / N;
      const size_t gi = (size_t(bb) * t_len + t0 + s) * N + e % N;
      b[i] = s < steps ? bg[gi] : zero<T>();
      c[i] = s < steps ? cg[gi] : zero<T>();
    }
#pragma unroll
    for (int i = 0; i < XS; ++i) {
      const int e = tid + i * kThreads, s = e / ROWS, pr = p0 + e % ROWS;
      x[i] = s < steps && pr < p_dim
                 ? xg[((size_t(bb) * t_len + t0 + s) * heads + h) * p_dim +
                      pr]
                 : zero<T>();
    }
    a = tid < steps ? ag[(size_t(bb) * t_len + t0 + tid) * heads + h] : 0.0f;
  }

  __device__ __forceinline__ void store(float* sb, float* sc, float* sx,
                                        float* sdec, int tid) const {
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      sb[tid + i * kThreads] = to_f32(b[i]);
      sc[tid + i * kThreads] = to_f32(c[i]);
    }
#pragma unroll
    for (int i = 0; i < XS; ++i) sx[tid + i * kThreads] = to_f32(x[i]);
    if (tid < kLT) sdec[tid] = expf(a);   // a = 0 past T: decay 1
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ b, const T* __restrict__ c,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hT, int t_len, int heads, int p_dim) {
  using Lo = Layout<N>;
  constexpr int NPT = Lo::NPT, G = Lo::G, ROWS = Lo::ROWS;
  __shared__ __align__(16) float sb[kLT * N];
  __shared__ __align__(16) float sc[kLT * N];
  __shared__ float sx[kLT * ROWS];
  __shared__ float sy[kLT * ROWS];
  __shared__ float sdec[kLT];

  const int tid = threadIdx.x;
  const int r = tid / G, g = tid % G;
  const int p0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int p = p0 + r;
  const bool live = p < p_dim;

  // this thread's state entries, from h0
  const size_t srow = ((size_t(bb) * heads + h) * p_dim + p) * N;
  float st[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j)
    st[j] = live ? h0[srow + Lo::col(g, j)] : 0.0f;

  StageRegs<T, N> next;
  next.load(x, a, b, c, tid, bb, h, p0, 0, t_len, heads, p_dim);
  for (int t0 = 0; t0 < t_len; t0 += kLT) {
    const int steps = min(kLT, t_len - t0);
    __syncthreads();  // the previous stage's readers are done
    next.store(sb, sc, sx, sdec, tid);
    __syncthreads();
    if (t0 + kLT < t_len)  // the next stage's loads fly during this one
      next.load(x, a, b, c, tid, bb, h, p0, t0 + kLT, t_len, heads, p_dim);

    for (int s = 0; s < steps; ++s) {
      const float dec = sdec[s];
      const float xv = sx[s * ROWS + r];
      const float4* b4 = reinterpret_cast<const float4*>(sb + s * N);
      const float4* c4 = reinterpret_cast<const float4*>(sc + s * N);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < NPT / 4; ++q) {
        const float4 bv = b4[q * G + g];
        const float4 cv = c4[q * G + g];
        float* e = st + 4 * q;
        e[0] = fmaf(xv, bv.x, e[0] * dec);
        e[1] = fmaf(xv, bv.y, e[1] * dec);
        e[2] = fmaf(xv, bv.z, e[2] * dec);
        e[3] = fmaf(xv, bv.w, e[3] * dec);
        acc = fmaf(e[0], cv.x, acc);
        acc = fmaf(e[1], cv.y, acc);
        acc = fmaf(e[2], cv.z, acc);
        acc = fmaf(e[3], cv.w, acc);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (g == 0) sy[s * ROWS + r] = acc;
    }
    __syncthreads();

    for (int e = tid; e < steps * ROWS; e += kThreads) {
      const int s = e / ROWS, pr = p0 + e % ROWS;
      if (pr < p_dim)
        store(y + ((size_t(bb) * t_len + t0 + s) * heads + h) * p_dim + pr,
              sy[e]);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) hT[srow + Lo::col(g, j)] = st[j];
  }
}

template <typename T, int N>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* h0, void* y, void* hT, int batch, int t_len, int heads,
           int p_dim, cudaStream_t stream) {
  constexpr int ROWS = Layout<N>::ROWS;
  const dim3 grid((p_dim + ROWS - 1) / ROWS, heads, batch);
  ssd_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hT), t_len, heads, p_dim);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int n, const void* x, const void* a, const void* b,
             const void* c, const void* h0, void* y, void* hT, int batch,
             int t_len, int heads, int p_dim, cudaStream_t s) {
  switch (n) {
    case 4:
      return launch<T, 4>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                          s);
    case 8:
      return launch<T, 8>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                          s);
    case 16:
      return launch<T, 16>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                           s);
    case 32:
      return launch<T, 32>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                           s);
    case 64:
      return launch<T, 64>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                           s);
    case 128:
      return launch<T, 128>(x, a, b, c, h0, y, hT, batch, t_len, heads,
                            p_dim, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// bf16: the chunked SSD form on the tensor cores (wgmma), TMA ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kL = 64;          // steps a chunk
constexpr int kStages = 2;      // chunk ring depth
constexpr int kWarpgroup = 128;
constexpr int kThreads = 2 * kWarpgroup + 32;   // state, output, producer
constexpr int kRow = 128;       // bytes of a swizzled row: 64 bf16 columns
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kL == 64, "the prefix sum below spans two warps");

template <int N>
struct Shape {
  static constexpr int kBoxes = N <= 64 ? 1 : 2;   // 64-column boxes of N
  static constexpr int kKSteps = (N + 15) / 16;    // k16 steps over N
  static constexpr int kXBytes = kL * kRow;        // X: L x 64 (P padded)
  static constexpr int kBCBytes = kBoxes * kL * kRow;  // B or C: L x N
  static constexpr int kStageBytes = kXBytes + 2 * kBCBytes;
  static constexpr int kHBytes = kBoxes * 64 * kRow;   // state: 64 x N
  // stages, w o B as bf16 hi and lo, two buffers of the state copy as
  // bf16 hi and lo; then two buffers of prefix sums a warpgroup, 8
  // barriers, and room to align the base to 1024 bytes
  static constexpr int kTiles =
      kStages * kStageBytes + 2 * kBCBytes + 4 * kHBytes;
  static constexpr int kSmem = kTiles + 16 * kL + 8 * 8 + 1024;
};

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device.
template <auto Kernel>
cudaError_t set_smem_once(int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d / 4-d tensor map into shared memory, completing on
// `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose
// atoms start 1024-byte aligned: start address, leading and stride byte
// offsets (16-byte units), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Make this thread's plain shared-memory stores visible to wgmma (the
// async proxy); a barrier must follow before any wgmma reads them.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma registers across the
// asynchronous instructions.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

#define SSD_ACC8(i)                                                    \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define SSD_ACC8E(i)                                                   \
  "+f"(e[(i)]), "+f"(e[(i) + 1]), "+f"(e[(i) + 2]), "+f"(e[(i) + 3]), \
      "+f"(e[(i) + 4]), "+f"(e[(i) + 5]), "+f"(e[(i) + 6]), "+f"(e[(i) + 7])
#define SSD_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SSD_REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, float32) (+)= A (64 x 16) B (16 x 64), A and B bf16 from
// shared memory; TA / TB set: the operand is MN-major (transpose bit),
// else K-major.  `acc` 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : SSD_ACC8(0), SSD_ACC8(8), SSD_ACC8(16), SSD_ACC8(24)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// The same over 128 columns of B (two 64-column boxes, LBO apart): d
// takes the first 64 columns, e the next.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], float (&e)[32],
                                         uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SSD_REGS64
      ", %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : SSD_ACC8(0), SSD_ACC8(8), SSD_ACC8(16), SSD_ACC8(24), SSD_ACC8E(0),
        SSD_ACC8E(8), SSD_ACC8E(16), SSD_ACC8E(24)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d (64 x 64, float32) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) B (16 x 64, bf16 in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SSD_ACC8(0), SSD_ACC8(8), SSD_ACC8(16), SSD_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SSD_ACC8
#undef SSD_ACC8E
#undef SSD_REGS32
#undef SSD_REGS64

// 2^x on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// (x0, x1) as two bf16 pairs: returns hi = bf16(x), sets lo = bf16(x - hi)
// (x - hi is exact in float32), so hi + lo is x within about 2^-17.
__device__ __forceinline__ uint32_t split_bf16(float x0, float x1,
                                               uint32_t& lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hi);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
  return *reinterpret_cast<const uint32_t*>(&hi);
}

// Shared-memory layout of a block: the 1024-byte aligned base in both
// address spaces, the tiles, the prefix sums and the barriers.
template <int N>
struct Smem {
  using S = Shape<N>;
  uint32_t base;   // shared-space address
  uint8_t* ptr;    // the same byte, generic
  __device__ uint32_t x(int s) const { return base + s * S::kStageBytes; }
  __device__ uint32_t b(int s) const { return x(s) + S::kXBytes; }
  __device__ uint32_t c(int s) const { return b(s) + S::kBCBytes; }
  // w o B = hi + lo, two bf16 tiles in B's layout
  __device__ uint32_t wb(int part) const {
    return base + kStages * S::kStageBytes + part * S::kBCBytes;
  }
  // the state's bf16 copy = hi + lo, two tiles of 64 rows p, in two
  // buffers: C_k h^T reads buffer k % 2
  __device__ uint32_t h(int buf, int part) const {
    return wb(2) + (2 * buf + part) * S::kHBytes;
  }
  __device__ uint8_t* at(uint32_t addr) const { return ptr + (addr - base); }
  // prefix sums of chunk k, warpgroup wg's own, in buffer k % 2
  __device__ float* lcum(int wg, int buf) const {
    return reinterpret_cast<float*>(ptr + S::kTiles) + (2 * wg + buf) * kL;
  }
  __device__ uint32_t bar(int i) const {
    return base + S::kTiles + 16 * kL + 8 * i;
  }
  // stage s loaded / released by both warpgroups
  __device__ uint32_t full(int s) const { return bar(s); }
  __device__ uint32_t empty(int s) const { return bar(kStages + s); }
  // state copy buffer j written / read
  __device__ uint32_t cfull(int j) const { return bar(2 * kStages + j); }
  __device__ uint32_t cempty(int j) const { return bar(2 * kStages + 2 + j); }
};

// Byte offset of element (row, col) in a 128-byte-swizzled tile of
// `rows` rows a 64-column box.
__device__ __forceinline__ uint32_t sw128_at(int row, int col, int rows) {
  return uint32_t((col >> 6) * rows * kRow + row * kRow +
                  ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
}

// What both consumer warpgroups share: their lane's place in the wgmma
// accumulator layout (rows r0 and r0 + 8, columns 8 j + cq + {0, 1} of
// every 8-column chunk), their own prefix sums and their own barrier.
template <int N>
struct Warpgroup {
  Smem<N> sm;
  int wg, tid, r0, cq;   // tid: 0..127 within the warpgroup

  __device__ void init(const Smem<N>& smem, int which, int t) {
    sm = smem;
    wg = which;
    tid = t;
    r0 = 16 * (tid / 32) + (tid % 32) / 4;
    cq = 2 * (tid % 4);
  }

  // barrier 1 + wg over this warpgroup alone
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWarpgroup)
                 : "memory");
  }

  // log2-unit inclusive prefix sum of a over chunk k, at step t
  __device__ __forceinline__ float lcum(int k, int t) const {
    const float* l = sm.lcum(wg, k & 1);
    return l[t] + (t >= 32 ? l[31] : 0.0f);
  }

  // Warp-level inclusive scans of chunk k's a (threads 0..63, one step
  // each; zero past T) into buffer k % 2; `lcum` adds warp 0's total for
  // steps 32..63.  Chunk k - 1 may still be read from the other buffer;
  // a `sync` must follow before chunk k's are read.
  __device__ __forceinline__ void scan(float av, int k) const {
    float v = av * kLog2e;
    const int lane = tid & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kAll, v, o);
      if (lane >= o) v += u;
    }
    if (tid < kL) sm.lcum(wg, k & 1)[tid] = v;
  }
};

// The state warpgroup: h (64 x N, rows p) in its accumulator, chunk by
// chunk h <- exp(total) h + X^T (w o B), and h's bf16 copy for the
// output warpgroup's C h^T.
template <int N>
struct StateWG : Warpgroup<N> {
  using S = Shape<N>;
  static constexpr int NB = S::kBoxes;
  float h[NB][32];

  // h as bf16 hi + lo into copy buffer j: 64 rows p, N columns, each a
  // K-major B of C h^T.
  __device__ __forceinline__ void store_state(int j) {
#pragma unroll
    for (int a = 0; a < NB; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t at =
              sw128_at(this->r0 + 8 * hh, 64 * a + 8 * c + this->cq, 64);
          uint32_t lo;
          const uint32_t hi = split_bf16(h[a][4 * c + 2 * hh],
                                         h[a][4 * c + 2 * hh + 1], lo);
          *reinterpret_cast<uint32_t*>(this->sm.at(this->sm.h(j, 0)) + at) =
              hi;
          *reinterpret_cast<uint32_t*>(this->sm.at(this->sm.h(j, 1)) + at) =
              lo;
        }
  }

  // Chunk k from stage s: w o B (w_s = exp(total - lcum_s)) as a pair of
  // bf16 tiles hi + lo (hi = bf16(w B), lo = bf16(w B - hi)) in B's
  // swizzled layout (a 16-byte chunk holds 8 columns of one row), then
  // h <- exp(total) h + X^T hi + X^T lo (both operands MN-major).
  __device__ __forceinline__ void chunk(int s, int k) {
    const Smem<N>& sm = this->sm;
    const float total = this->lcum(k, kL - 1);
#pragma unroll
    for (int i = 0; i < NB * kL * 8 / kWarpgroup; ++i) {
      const int q = this->tid + i * kWarpgroup;
      const float w = ex2(fminf(total - this->lcum(k, (q >> 3) % kL), 0.0f));
      const uint4 in = *reinterpret_cast<const uint4*>(sm.at(sm.b(s)) + 16 * q);
      const uint32_t* iv = reinterpret_cast<const uint32_t*>(&in);
      uint4 hi, lo;
      uint32_t* hv = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lv = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&iv[r]));
        hv[r] = split_bf16(f.x * w, f.y * w, lv[r]);
      }
      *reinterpret_cast<uint4*>(sm.at(sm.wb(0)) + 16 * q) = hi;
      *reinterpret_cast<uint4*>(sm.at(sm.wb(1)) + 16 * q) = lo;
    }
    proxy_fence();
    this->sync();   // every thread's w o B is in place

    const float decay = ex2(total);
#pragma unroll
    for (int a = 0; a < NB; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) h[a][i] *= decay;
    wg_fence();
#pragma unroll
    for (int j = 0; j < 2 * kL / 16; ++j) {   // hi and lo a k16 slice
      const uint64_t da =
          sw128_desc(sm.x(s) + 16 * (j / 2) * kRow, kL * kRow, 1024);
      const uint64_t db = sw128_desc(sm.wb(j % 2) + 16 * (j / 2) * kRow,
                                     kL * kRow, 1024);
      if constexpr (NB == 2)
        wgmma_ss<1, 1>(h[0], h[1], da, db, 1);
      else
        wgmma_ss<1, 1>(h[0], da, db, 1);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int a = 0; a < NB; ++a) reg_fence(h[a]);
    mbar_arrive(sm.empty(s));
  }
};

// The output warpgroup: S = C B^T and Z = C h^T (the state entering the
// chunk, from its bf16 copy), S' and y = exp(lcum_t) Z + S' X.
template <int N>
struct OutputWG : Warpgroup<N> {
  using S = Shape<N>;
  float sacc[32];    // S = C B^T, then S'
  float yacc[32];    // C h^T, then y
  uint32_t pa[2][kL / 16][4];   // S' = hi + lo, bf16 register-A

  // Chunk k from stage s, its first step at t0: y rows < T, columns < P,
  // rounded once.
  __device__ __forceinline__ void chunk(int s, int k, int t0, int t_len,
                                        __nv_bfloat16* __restrict__ y,
                                        size_t y_row, int y_stride,
                                        int p_dim) {
    const Smem<N>& sm = this->sm;
    // the state entering chunk k, from the state warpgroup (waited for
    // before any product is in flight: ptxas serialises wgmma across a
    // branch)
    const int j = k & 1;
    mbar_wait(sm.cfull(j), (k >> 1) & 1);
    // S = C B^T, then C h^T over the state copy hi and lo, all K-major
    // over N
    wg_fence();
#pragma unroll
    for (int i = 0; i < S::kKSteps; ++i) {
      const uint32_t kb = (i / 4) * kL * kRow + 32 * (i % 4);
      wgmma_ss<0, 0>(sacc, sw128_desc(sm.c(s) + kb, 16, 1024),
                     sw128_desc(sm.b(s) + kb, 16, 1024), i);
    }
#pragma unroll
    for (int i = 0; i < 2 * S::kKSteps; ++i) {
      const int kk = i % S::kKSteps;
      const uint32_t kb = (kk / 4) * kL * kRow + 32 * (kk % 4);
      wgmma_ss<0, 0>(
          yacc, sw128_desc(sm.c(s) + kb, 16, 1024),
          sw128_desc(sm.h(j, i / S::kKSteps) + (kk / 4) * 64 * kRow +
                         32 * (kk % 4),
                     16, 1024),
          i);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(sacc);
    reg_fence(yacc);
    mbar_arrive(sm.cempty(j));

    // S'[t, u] = S exp(lcum_t - lcum_u) for u <= t, else 0; the carried
    // state's share exp(lcum_t) C h^T
    float lr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) lr[hh] = this->lcum(k, this->r0 + 8 * hh);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int t = this->r0 + 8 * hh, u = 8 * (i >> 2) + this->cq + (i & 1);
      const float dec = ex2(fminf(lr[hh] - this->lcum(k, u), 0.0f));
      sacc[i] = u <= t ? sacc[i] * dec : 0.0f;
      yacc[i] *= ex2(lr[hh]);
    }
#pragma unroll
    for (int q = 0; q < kL / 16; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[0][q][r] = split_bf16(sacc[8 * q + 2 * r],
                                 sacc[8 * q + 2 * r + 1], pa[1][q][r]);

    // y += S' X (X MN-major B), S' hi and lo a k16 slice
    wg_fence();
#pragma unroll
    for (int q = 0; q < 2 * kL / 16; ++q)
      wgmma_rs(yacc, pa[q % 2][q / 2],
               sw128_desc(sm.x(s) + 16 * (q / 2) * kRow, kL * kRow, 1024));
    wg_commit();
    wg_wait<0>();
    reg_fence(yacc);
    reg_fence(pa[0]);
    reg_fence(pa[1]);
    mbar_arrive(sm.empty(s));

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + this->r0 + 8 * hh;
      if (t >= t_len) continue;
      __nv_bfloat16* row = y + (y_row + size_t(t)) * y_stride;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int p = 8 * c + this->cq;
        if (p < p_dim)
          *reinterpret_cast<__nv_bfloat162*>(row + p) =
              __floats2bfloat162_rn(yacc[4 * c + 2 * hh],
                                    yacc[4 * c + 2 * hh + 1]);
      }
    }
  }
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap cmap,
              const float* __restrict__ a, const float* __restrict__ h0,
              __nv_bfloat16* __restrict__ y, float* __restrict__ hT,
              int t_len, int heads, int p_dim) {
  using S = Shape<N>;
  constexpr int NB = S::kBoxes;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align every tile to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Smem<N> sm{base, smem_raw + (base - raw)};

  const int hd = blockIdx.x, bb = blockIdx.y;
  const int chunks = (t_len + kL - 1) / kL;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 2 * kWarpgroup);   // both warpgroups
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(sm.cfull(j), kWarpgroup);    // the state warpgroup
      mbar_init(sm.cempty(j), kWarpgroup);   // the output warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  if (wg == 2) {
    // producer warp: one thread keeps the ring full; chunk k lives in
    // stage k % kStages
    if (tid == 0) {
      for (int k = 0; k < chunks; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(sm.empty(s), (k / kStages - 1) & 1);
        mbar_expect_tx(sm.full(s), S::kStageBytes);
        tma_load(sm.x(s), &xmap, sm.full(s), 0, hd, k * kL, bb);
        for (int box = 0; box < NB; ++box) {
          tma_load(sm.b(s) + box * kL * kRow, &bmap, sm.full(s), 64 * box,
                   k * kL, bb);
          tma_load(sm.c(s) + box * kL * kRow, &cmap, sm.full(s), 64 * box,
                   k * kL, bb);
        }
      }
    }
    return;
  }

  // a of step t of chunk k (0 past T), one step a thread of 0..63
  auto load_a = [&](int k) {
    const int t = k * kL + tid;
    return tid < kL && t < t_len ? a[(size_t(bb) * t_len + t) * heads + hd]
                                 : 0.0f;
  };
  const size_t hrow = (size_t(bb) * heads + hd) * p_dim;

  if (wg == 0) {
    StateWG<N> st;
    st.init(sm, 0, tid);
    // the state from h0 (rows < P, columns < N; the padding stays 0)
#pragma unroll
    for (int a0 = 0; a0 < NB; ++a0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = st.r0 + 8 * hh, n = 64 * a0 + 8 * j + st.cq;
          float2 v = make_float2(0.0f, 0.0f);
          if (h0 != nullptr && p < p_dim && n < N)
            v = *reinterpret_cast<const float2*>(h0 + (hrow + p) * N + n);
          st.h[a0][4 * j + 2 * hh] = v.x;
          st.h[a0][4 * j + 2 * hh + 1] = v.y;
        }
    st.store_state(0);   // C_0 h0^T reads buffer 0
    proxy_fence();
    mbar_arrive(sm.cfull(0));
    st.scan(load_a(0), 0);
    st.sync();
    for (int k = 0; k < chunks; ++k) {
      const float a_next = load_a(k + 1);   // in flight during the chunk
      const int s = k % kStages;
      mbar_wait(sm.full(s), (k / kStages) & 1);
      st.chunk(s, k);
      if (k + 1 < chunks) {
        // the state entering chunk k + 1, for C_{k+1} h^T: buffer
        // (k + 1) % 2, once C_{k-1} h^T has read it
        const int j = (k + 1) & 1, fill = (k + 1) >> 1;
        if (fill > 0) mbar_wait(sm.cempty(j), (fill - 1) & 1);
        st.store_state(j);
        proxy_fence();
        mbar_arrive(sm.cfull(j));
      }
      st.scan(a_next, k + 1);
      st.sync();
    }
    // the final state, float32
#pragma unroll
    for (int a0 = 0; a0 < NB; ++a0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = st.r0 + 8 * hh, n = 64 * a0 + 8 * j + st.cq;
          if (p < p_dim && n < N)
            *reinterpret_cast<float2*>(hT + (hrow + p) * N + n) =
                make_float2(st.h[a0][4 * j + 2 * hh],
                            st.h[a0][4 * j + 2 * hh + 1]);
        }
  } else {
    OutputWG<N> out;
    out.init(sm, 1, tid);
    out.scan(load_a(0), 0);
    out.sync();
    const size_t y_row = size_t(bb) * t_len;
    const int y_stride = heads * p_dim;
    __nv_bfloat16* yh = y + size_t(hd) * p_dim;
    for (int k = 0; k < chunks; ++k) {
      const float a_next = load_a(k + 1);
      const int s = k % kStages;
      mbar_wait(sm.full(s), (k / kStages) & 1);
      out.chunk(s, k, k * kL, t_len, yh, y_row, y_stride, p_dim);
      out.scan(a_next, k + 1);
      out.sync();
    }
  }
}

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (no -lcuda at link time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; sizes in elements,
// strides in bytes of dims 1..rank-1) with the given box, whose innermost
// extent is 64 elements (128 bytes, 128-byte swizzle); out-of-range
// elements load as zeros.
bool encode(CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (B, T, H, P) as (P, H, T, B), boxes 64 x 1 x L x 1: one head's L
// steps, P padded to 64 with zeros; b or c (B, T, N) as (N, T, B), boxes
// 64 x L x 1.  Rows past T load as zeros and never from the next batch.
bool encode_all(CUtensorMap* maps, const void* x, const void* b,
                const void* c, int batch, int t_len, int heads, int p_dim,
                int n) {
  const cuuint64_t xd[4] = {cuuint64_t(p_dim), cuuint64_t(heads),
                            cuuint64_t(t_len), cuuint64_t(batch)};
  const cuuint64_t xs[3] = {cuuint64_t(p_dim) * 2,
                            cuuint64_t(heads) * p_dim * 2,
                            cuuint64_t(t_len) * heads * p_dim * 2};
  const cuuint32_t xb[4] = {64, 1, kL, 1};
  const cuuint64_t bd[3] = {cuuint64_t(n), cuuint64_t(t_len),
                            cuuint64_t(batch)};
  const cuuint64_t bs[2] = {cuuint64_t(n) * 2, cuuint64_t(t_len) * n * 2};
  const cuuint32_t bx[3] = {64, kL, 1};
  return encode(&maps[0], x, 4, xd, xs, xb) &&
         encode(&maps[1], b, 3, bd, bs, bx) &&
         encode(&maps[2], c, 3, bd, bs, bx);
}

template <int N>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* h0, void* y, void* hT, int batch, int t_len, int heads,
           int p_dim, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!encode_all(maps, x, b, c, batch, t_len, heads, p_dim, N))
    return int(cudaErrorInvalidValue);
  constexpr auto kernel = ssd_tc_kernel<N>;
  const cudaError_t err = set_smem_once<kernel>(Shape<N>::kSmem);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(heads, batch), kThreads, Shape<N>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(hT), t_len, heads, p_dim);
  return int(cudaGetLastError());
}

int dispatch(int n, const void* x, const void* a, const void* b,
             const void* c, const void* h0, void* y, void* hT, int batch,
             int t_len, int heads, int p_dim, cudaStream_t s) {
  if (p_dim < 8 || p_dim > 64 || p_dim % 8 != 0)
    return int(cudaErrorInvalidValue);
  switch (n) {
    case 8:
      return launch<8>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim, s);
    case 16:
      return launch<16>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                        s);
    case 32:
      return launch<32>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                        s);
    case 64:
      return launch<64>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                        s);
    case 128:
      return launch<128>(x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                         s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: the chunked SSD form as split TF32 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

namespace tfc {

using tc::ex2;
using tc::kAll;
using tc::kLog2e;
using tc::mbar_arrive;
using tc::mbar_init;
using tc::mbar_wait;
using tc::set_smem_once;
using tc::smem_u32;
using tf32::kLine;

// Element strides of x (batch, time, head) and of b and c (batch, time),
// the last axis of each contiguous.
struct Strides {
  long long x[3], b[2], c[2];
};

constexpr int kL = 64;          // steps a chunk
constexpr int kWG = 128;
constexpr int kThreads = 3 * kWG;   // state, output, producer warpgroups

template <int N>
struct Shape {
  static constexpr int kLines = N < 32 ? 1 : N / 32;   // 32-float lines of N
  static constexpr int kKSteps = N / 8;                // k8 steps over N
  static constexpr int kMB = N < 64 ? 1 : N / 64;      // 64-row blocks of h^T
  // bytes of one part (hi or lo): C or B (L rows t x N), X^T (64 rows p x
  // L steps), the state's copy (64 rows p x N)
  static constexpr int kCBytes = kL * kLine * kLines;
  static constexpr int kXBytes = 64 * kLine * (kL / 32);
  static constexpr int kHBytes = 64 * kLine * kLines;
  static constexpr int kTiles = 2 * (2 * kCBytes + kXBytes + kHBytes);
  // tiles, prefix sums (2 warpgroups x 2 buffers x L), 8 barriers, and
  // room to align the base to 1024 bytes
  static constexpr int kSmem = kTiles + 16 * kL + 8 * 8 + 1024;
  static_assert(kSmem <= 232448, "over the shared memory of a block");
};

template <int N>
struct Smem {
  using S = Shape<N>;
  uint32_t base;   // shared-space address, 1024-byte aligned
  uint8_t* ptr;    // the same byte, generic
  __device__ uint32_t c(int part) const { return base + part * S::kCBytes; }
  __device__ uint32_t b(int part) const {
    return base + (2 + part) * S::kCBytes;
  }
  __device__ uint32_t x(int part) const {
    return base + 4 * S::kCBytes + part * S::kXBytes;
  }
  __device__ uint32_t h(int part) const {
    return base + 4 * S::kCBytes + 2 * S::kXBytes + part * S::kHBytes;
  }
  __device__ float* lcum(int wg, int buf) const {
    return reinterpret_cast<float*>(ptr + S::kTiles) + (2 * wg + buf) * kL;
  }
  __device__ uint32_t bar(int i) const {
    return base + S::kTiles + 16 * kL + 8 * i;
  }
  // C, B, X^T of a chunk and the state's copy: written (full), released
  // (empty)
  __device__ uint32_t c_full() const { return bar(0); }
  __device__ uint32_t c_empty() const { return bar(1); }
  __device__ uint32_t b_full() const { return bar(2); }
  __device__ uint32_t b_empty() const { return bar(3); }
  __device__ uint32_t x_full() const { return bar(4); }
  __device__ uint32_t x_empty() const { return bar(5); }
  __device__ uint32_t h_full() const { return bar(6); }
  __device__ uint32_t h_empty() const { return bar(7); }
};

// A consumer warpgroup's place in the accumulator layout (rows r0 and
// r0 + 8, columns 8 j + cq + {0, 1}), its own prefix sums and barrier:
// `tc::Warpgroup`'s.
template <int N>
struct Warpgroup {
  Smem<N> sm;
  int wg, tid, r0, cq;

  __device__ void init(const Smem<N>& smem, int which, int t) {
    sm = smem;
    wg = which;
    tid = t;
    r0 = 16 * (tid / 32) + (tid % 32) / 4;
    cq = 2 * (tid % 4);
  }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWG) : "memory");
  }
  __device__ __forceinline__ float lcum(int k, int t) const {
    const float* l = sm.lcum(wg, k & 1);
    return l[t] + (t >= 32 ? l[31] : 0.0f);
  }
  __device__ __forceinline__ void scan(float av, int k) const {
    float v = av * kLog2e;
    const int lane = tid & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kAll, v, o);
      if (lane >= o) v += u;
    }
    if (tid < kL) sm.lcum(wg, k & 1)[tid] = v;
  }
};

__device__ __forceinline__ void reg_fence(uint32_t (&d)[kL / 8][4]) {
#pragma unroll
  for (int i = 0; i < kL / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// The state warpgroup: h^T (N rows n in blocks of 64, 64 columns p) in its
// accumulators, chunk by chunk h^T <- exp(total) h^T + (w o B)^T X, with
// (w o B)^T built in registers as A fragments from the B tile and X^T's
// steps in `kperm` order; then h's copy (rows p, K-major over n) for the
// output warpgroup's C h^T.
template <int N>
struct StateWG : Warpgroup<N> {
  using S = Shape<N>;
  float h[S::kMB][32];

  // (n, p) of accumulator entry i of block mb
  __device__ __forceinline__ int row(int mb, int i) const {
    return 64 * mb + this->r0 + 8 * ((i >> 1) & 1);
  }
  __device__ __forceinline__ int col(int i) const {
    return 8 * (i >> 2) + this->cq + (i & 1);
  }

  __device__ __forceinline__ void store_state() {
    const Smem<N>& sm = this->sm;
#pragma unroll
    for (int mb = 0; mb < S::kMB; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int n = row(mb, i);
        const uint32_t at = tf32::sw(col(i), n, 64);
        if (n < N) tf32::store_split(sm.h(0) + at, sm.h(1) + at, h[mb][i]);
      }
  }

  __device__ __forceinline__ void chunk(int k) {
    const Smem<N>& sm = this->sm;
    const float total = this->lcum(k, kL - 1);
    // w_u = exp(total - lcum_u) at this thread's steps u = 8 j + cq (+1)
    float w[kL / 8][2];
#pragma unroll
    for (int j = 0; j < kL / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        w[j][e] = ex2(fminf(total - this->lcum(k, 8 * j + this->cq + e),
                            0.0f));
    const float decay = ex2(total);
#pragma unroll
    for (int mb = 0; mb < S::kMB; ++mb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) h[mb][i] *= decay;
      // A = (w o B)^T rows n, k = steps: (n, u0), (n + 8, u0), (n, u1),
      // (n + 8, u1) with u0 = 8 j + cq, u1 = u0 + 1 (kperm positions t
      // and t + 4)
      uint32_t ah[kL / 8][4], al[kL / 8][4];
      const uint32_t bh = tf32::opaque(sm.b(0)), bl = tf32::opaque(sm.b(1));
#pragma unroll
      for (int j = 0; j < kL / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 64 * mb + this->r0 + 8 * (r & 1);
          const int u = 8 * j + this->cq + (r >> 1);
          const uint32_t at = tf32::sw(u, n, kL);
          const float bv = n < N ? tf32::load_shared(bh + at) +
                                       tf32::load_shared(bl + at)
                                 : 0.0f;
          tf32::split(w[j][r >> 1] * bv, ah[j][r], al[j][r]);
        }
      const uint64_t xh = tf32::desc_here(sm.x(0));
      const uint64_t xl = tf32::desc_here(sm.x(1));
      tf32::fence();
#pragma unroll
      for (int j = 0; j < kL / 8; ++j)
        tf32::mma3_rs<64>(h[mb], ah[j], al[j], tf32::kstep(xh, j, 64),
                          tf32::kstep(xl, j, 64));
      tf32::commit();
      tf32::wait<0>();
      tf32::reg_fence(h[mb]);
      reg_fence(ah);
      reg_fence(al);
    }
  }
};

// The output warpgroup: S = C B^T and Z = C h^T (the state entering the
// chunk, from its copy), S' and y = exp(lcum_t) Z + S' X, S' split in
// registers into A fragments against X^T's `kperm` order.
template <int N>
struct OutputWG : Warpgroup<N> {
  using S = Shape<N>;
  float sacc[32];    // S = C B^T, then S'
  float yacc[32];    // C h^T, then y
  uint32_t ph[kL / 8][4], pl[kL / 8][4];

  __device__ __forceinline__ void chunk(int k, int t0, int t_len,
                                        float* __restrict__ y,
                                        size_t y_row, int y_stride,
                                        int p_dim) {
    const Smem<N>& sm = this->sm;
    const uint32_t par = k & 1;
    mbar_wait(sm.c_full(), par);
    mbar_wait(sm.b_full(), par);
    mbar_wait(sm.h_full(), par);
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = yacc[i] = 0.0f;
    const uint64_t ch = tf32::desc_here(sm.c(0));
    const uint64_t cl = tf32::desc_here(sm.c(1));
    const uint64_t bh = tf32::desc_here(sm.b(0));
    const uint64_t bl = tf32::desc_here(sm.b(1));
    const uint64_t hh = tf32::desc_here(sm.h(0));
    const uint64_t hl = tf32::desc_here(sm.h(1));
    tf32::fence();
#pragma unroll
    for (int i = 0; i < S::kKSteps; ++i)
      tf32::mma3_ss<64>(sacc, tf32::kstep(ch, i, kL), tf32::kstep(cl, i, kL),
                        tf32::kstep(bh, i, kL), tf32::kstep(bl, i, kL), i);
#pragma unroll
    for (int i = 0; i < S::kKSteps; ++i)
      tf32::mma3_ss<64>(yacc, tf32::kstep(ch, i, kL), tf32::kstep(cl, i, kL),
                        tf32::kstep(hh, i, 64), tf32::kstep(hl, i, 64), i);
    tf32::commit();
    tf32::wait<0>();
    tf32::reg_fence(sacc);
    tf32::reg_fence(yacc);
    mbar_arrive(sm.h_empty());
    mbar_arrive(sm.c_empty());
    mbar_arrive(sm.b_empty());

    float lr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) lr[hh] = this->lcum(k, this->r0 + 8 * hh);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int t = this->r0 + 8 * hh, u = 8 * (i >> 2) + this->cq + (i & 1);
      const float dec = ex2(fminf(lr[hh] - this->lcum(k, u), 0.0f));
      sacc[i] = u <= t ? sacc[i] * dec : 0.0f;
      yacc[i] *= ex2(lr[hh]);
    }
#pragma unroll
    for (int j = 0; j < kL / 8; ++j)
      tf32::frag(sacc[4 * j], sacc[4 * j + 1], sacc[4 * j + 2],
                 sacc[4 * j + 3], ph[j], pl[j]);

    mbar_wait(sm.x_full(), par);
    const uint64_t xh = tf32::desc_here(sm.x(0));
    const uint64_t xl = tf32::desc_here(sm.x(1));
    tf32::fence();
#pragma unroll
    for (int j = 0; j < kL / 8; ++j)
      tf32::mma3_rs<64>(yacc, ph[j], pl[j], tf32::kstep(xh, j, 64),
                        tf32::kstep(xl, j, 64));
    tf32::commit();
    tf32::wait<0>();
    tf32::reg_fence(yacc);
    reg_fence(ph);
    reg_fence(pl);
    mbar_arrive(sm.x_empty());

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + this->r0 + 8 * hh;
      if (t >= t_len) continue;
      float* yr = y + (y_row + size_t(t)) * y_stride;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int p = 8 * c + this->cq;
        if (p < p_dim)
          *reinterpret_cast<float2*>(yr + p) =
              make_float2(yacc[4 * c + 2 * hh], yacc[4 * c + 2 * hh + 1]);
      }
    }
  }
};

// The producer warpgroup's tiles of a chunk (C and B: rows t, K-major over
// N; X^T: rows p, steps in `kperm` order): raw float32 copied from the
// caller's strides straight to where their hi goes (`cp.async`, no
// register; zeros past T and past P), then split in place: hi there, lo in
// the lo tile.  C and B rows go 16 bytes at a time (4 columns); X goes to
// X^T one value at a time, 4 steps of a column p a thread, the 4 that
// `kperm` puts side by side (steps 8 g + o, + 2, + 4, + 6, o = 0 or 1), so
// that its split is 16 bytes at a time too.  A thread splits exactly what
// it copied, so needs no barrier between the two.
template <int N>
struct Producer {
  static constexpr int C4 = N / 4;            // 16-byte chunks of a row
  static constexpr int RC = kWG / C4;         // C or B rows a pass
  static constexpr int CQ = kL * C4 / kWG;    // C or B chunks a thread
  static constexpr int XQ = 64 * (kL / 4) / kWG;   // X^T quads a thread
  Smem<N> sm;
  const float* cb;   // this block's batch (and head) origins
  const float* bo;
  const float* xb;
  int ct, bt, xt;    // time strides
  int tid, t_len, p_dim;

  // C or B of chunk k into the tile at `hi`, once `empty` is released
  // (from chunk 1 on); one copy group
  __device__ __forceinline__ void copy_cb(const float* src, int ts,
                                          uint32_t hi, uint32_t empty,
                                          int k) const {
    if (k > 0) mbar_wait(empty, (k - 1) & 1);
    const int t0 = k * kL, c = 4 * (tid % C4), r0 = tid / C4;
    int off = (t0 + r0) * ts + c;
#pragma unroll
    for (int i = 0; i < CQ; ++i) {
      const bool in = t0 + r0 + RC * i < t_len;
      tf32::copy16(hi + tf32::sw(r0 + RC * i, c, kL), src + (in ? off : 0),
                   in);
      off += RC * ts;
    }
    tf32::copy_commit();
  }
  __device__ __forceinline__ void split_cb(uint32_t hi, uint32_t lo,
                                           uint32_t full) const {
    const int c = 4 * (tid % C4), r0 = tid / C4;
#pragma unroll
    for (int i = 0; i < CQ; ++i) {
      const uint32_t at = tf32::sw(r0 + RC * i, c, kL);
      tf32::split4_in_place(hi + at, lo + at);
    }
    tf32::proxy_fence();
    mbar_arrive(full);
  }
  __device__ __forceinline__ void copy_x(int k) const {
    if (k > 0) mbar_wait(sm.x_empty(), (k - 1) & 1);
    const int t0 = k * kL, p = tid % 64, q0 = tid / 64;
#pragma unroll
    for (int i = 0; i < XQ; ++i) {
      const int q = q0 + 2 * i, u = 8 * (q >> 1) + (q & 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const bool in = t0 + u + 2 * m < t_len && p < p_dim;
        tf32::copy4(sm.x(0) + tf32::sw(p, 4 * q + m, 64),
                    xb + (in ? (t0 + u + 2 * m) * xt + p : 0), in);
      }
    }
    tf32::copy_commit();
  }
  __device__ __forceinline__ void split_x() const {
    const int p = tid % 64, q0 = tid / 64;
#pragma unroll
    for (int i = 0; i < XQ; ++i) {
      const uint32_t at = tf32::sw(p, 4 * (q0 + 2 * i), 64);
      tf32::split4_in_place(sm.x(0) + at, sm.x(1) + at);
    }
    tf32::proxy_fence();
    mbar_arrive(sm.x_full());
  }

  // chunk k: C, B and X copied, each split once its group has landed
  __device__ __forceinline__ void chunk(int k) const {
    copy_cb(cb, ct, sm.c(0), sm.c_empty(), k);
    copy_cb(bo, bt, sm.b(0), sm.b_empty(), k);
    tf32::copy_wait<1>();
    split_cb(sm.c(0), sm.c(1), sm.c_full());
    copy_x(k);
    tf32::copy_wait<1>();
    split_cb(sm.b(0), sm.b(1), sm.b_full());
    tf32::copy_wait<0>();
    split_x();
  }
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tf32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ hT, Strides st, int t_len, int heads,
                int p_dim) {
  using S = Shape<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Smem<N> sm{base, smem_raw + (base - raw)};

  const int hd = blockIdx.x, bb = blockIdx.y;
  const int chunks = (t_len + kL - 1) / kL;

  if (threadIdx.x == 0) {
    mbar_init(sm.c_full(), kWG);       // every producer thread
    mbar_init(sm.b_full(), kWG);
    mbar_init(sm.x_full(), kWG);
    mbar_init(sm.c_empty(), kWG);      // the output warpgroup
    mbar_init(sm.b_empty(), 2 * kWG);  // both consumer warpgroups
    mbar_init(sm.x_empty(), 2 * kWG);
    mbar_init(sm.h_full(), kWG);       // the state warpgroup
    mbar_init(sm.h_empty(), kWG);      // the output warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  if (wg == 2) {
    // producer warpgroup (`Producer`); 80 registers a thread go to the
    // consumers (40 each)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    const Producer<N> pr{sm, c + bb * st.c[0], b + bb * st.b[0],
                         x + bb * st.x[0] + hd * st.x[2], int(st.c[1]),
                         int(st.b[1]), int(st.x[1]), tid, t_len, p_dim};
    for (int k = 0; k < chunks; ++k) pr.chunk(k);
    return;
  }

  // a of step t of chunk k (0 past T), one step a thread of 0..63
  auto load_a = [&](int k) {
    const int t = k * kL + tid;
    return tid < kL && t < t_len ? a[(size_t(bb) * t_len + t) * heads + hd]
                                 : 0.0f;
  };
  const size_t hrow = (size_t(bb) * heads + hd) * p_dim;

  if (wg == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
    StateWG<N> sw;
    sw.init(sm, 0, tid);
    // the state from h0 (none: zeros; rows p < P, n < N, the rest 0)
#pragma unroll
    for (int mb = 0; mb < S::kMB; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int n = sw.row(mb, i), p = sw.col(i);
        sw.h[mb][i] = h0 != nullptr && p < p_dim && n < N
                          ? h0[(hrow + p) * N + n]
                          : 0.0f;
      }
    sw.store_state();   // C_0 h0^T
    tf32::proxy_fence();
    mbar_arrive(sm.h_full());
    sw.scan(load_a(0), 0);
    sw.sync();
    for (int k = 0; k < chunks; ++k) {
      const float a_next = load_a(k + 1);   // in flight during the chunk
      mbar_wait(sm.b_full(), k & 1);
      mbar_wait(sm.x_full(), k & 1);
      sw.chunk(k);
      mbar_arrive(sm.b_empty());
      mbar_arrive(sm.x_empty());
      if (k + 1 < chunks) {
        // the state entering chunk k + 1, once C_k h^T has read the copy
        mbar_wait(sm.h_empty(), k & 1);
        sw.store_state();
        tf32::proxy_fence();
        mbar_arrive(sm.h_full());
      }
      sw.scan(a_next, k + 1);
      sw.sync();
    }
#pragma unroll
    for (int mb = 0; mb < S::kMB; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int n = sw.row(mb, i), p = sw.col(i);
        if (p < p_dim && n < N) hT[(hrow + p) * N + n] = sw.h[mb][i];
      }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
    OutputWG<N> out;
    out.init(sm, 1, tid);
    out.scan(load_a(0), 0);
    out.sync();
    const size_t y_row = size_t(bb) * t_len;
    const int y_stride = heads * p_dim;
    float* yh = y + size_t(hd) * p_dim;
    for (int k = 0; k < chunks; ++k) {
      const float a_next = load_a(k + 1);
      out.chunk(k, k * kL, t_len, yh, y_row, y_stride, p_dim);
      out.scan(a_next, k + 1);
      out.sync();
    }
  }
}

template <int N>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* h0, void* y, void* hT, const Strides& st, int batch,
           int t_len, int heads, int p_dim, cudaStream_t stream) {
  constexpr auto kernel = ssd_tf32_kernel<N>;
  const cudaError_t err = set_smem_once<kernel>(Shape<N>::kSmem);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(heads, batch), kThreads, Shape<N>::kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), st, t_len, heads, p_dim);
  return int(cudaGetLastError());
}

int dispatch(int n, const void* x, const void* a, const void* b,
             const void* c, const void* h0, void* y, void* hT,
             const Strides& st, int batch, int t_len, int heads, int p_dim,
             cudaStream_t s) {
  if (p_dim < 8 || p_dim > 64 || p_dim % 8 != 0)
    return int(cudaErrorInvalidValue);
  switch (n) {
    case 8:
      return launch<8>(x, a, b, c, h0, y, hT, st, batch, t_len, heads, p_dim,
                       s);
    case 16:
      return launch<16>(x, a, b, c, h0, y, hT, st, batch, t_len, heads,
                        p_dim, s);
    case 32:
      return launch<32>(x, a, b, c, h0, y, hT, st, batch, t_len, heads,
                        p_dim, s);
    case 64:
      return launch<64>(x, a, b, c, h0, y, hT, st, batch, t_len, heads,
                        p_dim, s);
    case 128:
      return launch<128>(x, a, b, c, h0, y, hT, st, batch, t_len, heads,
                         p_dim, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace tfc

}  // namespace

// Plain C interface for ctypes.  route: 0 float32 and 1 bfloat16 on the
// recurrent kernel (CUDA cores), 2 bfloat16 on the chunked kernel (tensor
// cores; x, b, c 16-byte aligned), 3 float32 on the chunked kernel as
// split TF32 (tensor cores).  Routes 2 and 3 take P a multiple of 8 up to
// 64 and N one of 8, 16, 32, 64, 128.  x, b, c and y are in the route's
// type; a, h0 and hT are float32.  Route 3 reads x, b and c at
// `strides`: 7 element strides, x's (batch, time, head) then b's and c's
// (batch, time), the last axis of each contiguous; the other routes take
// them contiguous and do not read `strides`.  a, y, h0 and hT are
// contiguous; on routes 2 and 3 h0 may be null (a zero initial state).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, const void* h0, void* y,
                               void* hT, const long long* strides, int batch,
                               int t_len, int heads, int p_dim, int n,
                               int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return tc::dispatch(n, x, a, b, c, h0, y, hT, batch, t_len, heads, p_dim,
                        s);
  if (route == 0)
    return dispatch<float>(n, x, a, b, c, h0, y, hT, batch, t_len, heads,
                           p_dim, s);
  if (route == 1)
    return dispatch<__nv_bfloat16>(n, x, a, b, c, h0, y, hT, batch, t_len,
                                   heads, p_dim, s);
  if (route == 3) {
    const tfc::Strides st{{strides[0], strides[1], strides[2]},
                          {strides[3], strides[4]},
                          {strides[5], strides[6]}};
    return tfc::dispatch(n, x, a, b, c, h0, y, hT, st, batch, t_len, heads,
                         p_dim, s);
  }
  return int(cudaErrorInvalidValue);
}
