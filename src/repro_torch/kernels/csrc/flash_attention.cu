// Block-wise online-softmax attention (GQA, causal, sliding window,
// softcap) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_kernel` of
// src/repro/kernels/flash_attention.py (launched by `flash_attention`).
// Semantics contract: repro_torch/kernels/ref.py::mha.
//
//   q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) (bf16 contiguous, float32 at
//   any strides with D contiguous and rows 16-byte aligned); query head
//   h reads kv head h / (Hq / Hkv) (GQA, no K/V copy);
//   qpos = i + (Tk - Tq), kpos = j;
//   logit = scale * (q . k), then softcap * tanh(logit / softcap);
//   kept where kpos < Tk, kpos <= qpos (causal), kpos > qpos - window;
//   out = softmax over the kept keys, 0 for a row with none kept.
//   m, l and the accumulator are float32; out is in q's type.
//
// Three kernels, chosen by `flash_attention_launch`'s route (the rule
// lives in flash_attention.py's `route`): bf16 on the tensor cores
// (`attention_tc_kernel`), float32 as split TF32 on the tensor cores at
// D 8, 16, 32, 64, 128 (`attention_tf32_kernel`), float32 at D = 256 on
// the CUDA cores (`attention_f32_kernel`), where the split Q tile alone
// would fill the shared memory.  Every kernel is instantiated at D 8, 16,
// 32, 64, 128 and 256 (`FA_DISPATCH`; the split-TF32 one but at 256): the
// route code of the C entry point picks one, so the CUDA-core kernel is
// reachable at every head dim, and is checked there on the card.  Nothing
// falls back: a launch that fails
// returns its error.  One TF32 product keeps about 11 significant bits,
// too few for float32's 2e-5 limit; a split one (hi hi + hi lo + lo hi,
// split_tf32.cuh) keeps about 21, which meets it.
//
// Bound on an H100 SXM: the function reads q, k, v once and writes o
// (bytes / 3.35 TB/s) and does 4 D flops per kept (query, key) pair per
// (batch, head) (flops / 989 TFLOP/s for bf16 on the tensor cores; for
// float32 three TF32 products a product at 494.7 TFLOP/s, about 165
// TFLOP/s).  chatglm3-6b's serving prefill (T = 128, bf16) is bound by
// bytes (0.7 us), a long prefill (T = 8192) by operations (0.56 ms in
// bf16, 3.3 ms in float32): only the tensor cores come near the latter,
// and the softmax's exponentials (one a logit, on the special-function
// units) are what the design hides under the products.
//
// bf16 design (the tensor-core rate).  A block of 384 threads owns
// BQ = 128 query rows of one (batch, head): one producer warpgroup and
// two consumer warpgroups of 64 rows each.  The producer gives up its
// registers (`setmaxnreg` 24, consumers 240) and one of its threads
// issues TMA copies: the Q tile once, then K and V tiles of BK keys
// (128 for D <= 128, 64 at D = 256) into a 2-stage ring, with a full and
// an empty barrier for K and for V of each stage.  The tensor maps are
// 3-d, (D, T, B*H), so rows past T come in as zeros and never from the
// next head; a row is D / 64 boxes of 64 columns (128 bytes, 128-byte
// swizzle), and D < 64 is padded with zero columns to 64 by the box.
// What that padding costs at D = 16 (granite-moe-1b's smoke config; 8
// alike): Q K^T is one k16 step, K = 16 exactly, but P V runs N = 64, of
// which 48 columns are zeros (4x the product's work, 8x at D = 8), and
// each tile takes 128-byte rows where 32 bytes are data.  An N = 16 P V
// needs V MN-major in a 32-byte swizzle (a 128-byte one spans 64
// columns), so other tensor maps and descriptors; no served model has
// D = 16 at full width, so the padded form stays.
// A consumer's step t issues S(t) = Q K(t)^T (`wgmma` m64n{BK}k16, Q and
// K from shared memory, both K-major) and O += P(t-1) V(t-1) back to
// back, then runs the softmax of S(t) while the second product is in
// flight.  P is rounded to bf16 pairs in registers, which is the
// register-A layout of the next `wgmma` (m64n128k16, or m64n64k16 for
// D <= 64), with V read from shared memory as an MN-major B (transpose
// bit); K is released once S(t) has retired, V once P V has.  Each step
// is straight-line code: ptxas serialises products that are in flight
// across a branch, so the mask test depends on the block alone and the
// masked and the softcapped forms are compiled apart.  The softmax lives
// in registers: a row sits on 4 threads, so its max takes two shuffles
// and its sum stays a per-thread partial until the end; p = 2^(x u -
// max u) is one fused multiply-add and one `ex2` (u = scale log2 e; the
// build's --fmad=false would not contract it), masks apply only on
// tiles that cross the causal, window or Tk edge, and softcap's tanh
// comes before the log2 e.  O stays float32 in registers, is divided by
// l, rounded once and stored for rows < Tq and columns < D.  Key tiles
// wholly outside the causal or window band are never loaded.  Blocks run
// the longest causal query tiles first, with the query heads that share
// a KV head side by side so their K/V stays in L2.  P in bf16 is the
// one rounding the Pallas kernel (float32 p) does not make: at most
// 2^-9 relative a weight.  ptxas spills 32 bytes in one bf16
// instantiation (D = 256 without softcap): the masks of an edge tile,
// which it hoists above the product's wait; no other bf16 instantiation
// spills.  Of the float32 kernel's (attention_tf32_kernel below), D = 64
// without softcap spills too: 4 bytes stored, 8 loaded (nvcc 12.8,
// -Xptxas -v).
//
// float32 design (split TF32 on the tensor cores).  The bf16 kernel's
// block: 384 threads own BQ = 128 query rows of one (batch, head), a
// producer warpgroup and two consumer warpgroups of 64 rows, K and V in
// rings of their own, straight-line steps (S(t) and P(t-1) V(t-1) issued
// back to back, the softmax of S(t) under the second), the masked and
// softcapped forms compiled apart, tiles outside the causal or window
// band skipped, the longest query tiles first and the query heads of a
// KV head side by side.  What differs is what the tensor cores are fed:
//   * every operand as two TF32 tiles, hi and lo (split_tf32.cuh), and
//     every product as three `wgmma` m64nNk8 .tf32: S = Q_lo K_hi +
//     Q_hi K_lo + Q_hi K_hi over D / 8 k-steps, O += P_lo V_hi + P_hi
//     V_lo + P_hi V_hi over BK / 8, P split in registers into A
//     fragments (float32 p, so the bf16 kernel's rounding of P is gone);
//   * `wgmma` takes no transpose for .tf32, so every shared operand is
//     K-major: Q and K are (rows, D) as stored, but V is MN-major in
//     P V, so V is stored transposed, V^T (D rows, BK keys), its keys in
//     `tf32::kperm` order, which is what lets the accumulator's P be an
//     A fragment without a shuffle;
//   * so a tile is not a plain copy: the producer warpgroup (128 threads,
//     not one TMA thread) copies the raw float32 from the caller's strides
//     (the attention layer's (B, H, T, D) views of (B, T, H, D) storage)
//     straight to where each hi goes, by `cp.async` (no register holds
//     them; no tensor map to encode on the host): Q and K 16 bytes at a
//     time, V one value at a time into V^T, 4 keys of a column a thread
//     that `kperm` puts side by side; then it splits them in place, 16
//     bytes at a time (hi there, lo into the lo tile).  The producer sets
//     the pace: loading through registers held 64-128 values a thread
//     and spilled, and 4-byte copies and splits, with 2.4x the
//     shared-memory instructions of this form, took 15.6 ms at T = 8192
//     against this form's 7.25 ms (`chip_smoke.py` phase 3b, on an H100
//     80GB HBM3 at 700 W).
// Shared memory is the limit: the split Q tile is 128 rows x D x 8
// bytes, 128 KB at D = 128.  So BK = 32 keys, one K slot and two V^T
// slots at D = 128 (Q 128 KB, K 32 KB, V^T 64 KB: 224 KB of the 227 KB a
// block can have), BK = 64 and two slots of each below (D = 64: 192 KB,
// D = 32: 96 KB, D = 16: 80 KB, D = 8: 72 KB; below D = 32 a row takes
// one 128-byte line, of which Q K^T's D / 8 k8 steps read D x 4 bytes, and
// P V's N is D exactly: m64n16k8 at D = 16, no padded product), and
// D = 256 (256 KB of split Q) stays on the CUDA cores.  V has the second
// slot because a step waits for V(t-1), written only once P(t-2) V(t-2)
// has retired; K(t + 1) is written while step t's softmax runs.  The
// output is written at the caller's strides: the wrapper allocates
// (B, Tq, Hq, D) storage, which the layer's reshape reads without a
// copy.  Rounding: hi + lo is each operand within 2^-22,
// the dropped lo lo products are below 2^-22 of a product, and the sums
// are float32 in the tensor cores' accumulators (tests/
// test_torch_flash_attention.py holds a model of exactly this to 2e-5).
//
// float32 design at D = 256 (the CUDA cores).  One block of 256 threads
// owns BQ = 32 query rows; the scaled Q tile and each 32-key K/V tile are
// staged in shared memory as float32 (rows padded to D + 1); logits, the
// online softmax and P V run on the CUDA cores with explicit fmaf() (the
// build's global --fmad=false leaves those fused).
//
// Every kernel sets its shared-memory attribute once per device, not on
// every launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <math.h>

#include "split_tf32.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;  // running-max start, as the Pallas kernel
constexpr int kMaxDevices = 64;

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

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 32;   // query rows per block
constexpr int kBK = 32;   // keys per tile (one per lane)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (D + 1) + 2 * size_t(kBK) * (D + 1) +
          size_t(kBQ) * (kBK + 1) + 3 * kBQ);
}

// Element strides (batch, head, time) of q, k, v and o; the last axis
// (D) is contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides st, int hq, int hkv, int tq, int tk, float scale,
                     int causal, int window, float softcap) {
  constexpr int LD = D + 1;                   // padded row stride (floats)
  constexpr int LP = kBK + 1;
  constexpr int RPT = kBQ * D / kThreads;     // accumulator rows a thread
  static_assert(kThreads % D == 0 && RPT >= 1,
                "the head dim must divide the block");
  extern __shared__ float smem[];
  float* sq = smem;                  // kBQ x LD, scaled q
  float* sk = sq + kBQ * LD;         // kBK x LD
  float* sv = sk + kBK * LD;         // kBK x LD
  float* sp = sv + kBK * LD;         // kBQ x LP, logits then probabilities
  float* sm = sp + kBQ * LP;         // kBQ running max
  float* sl = sm + kBQ;              // kBQ running sum
  float* sa = sl + kBQ;              // kBQ rescale of this tile

  const int tid = threadIdx.x;
  const int bb = blockIdx.y / hq, h = blockIdx.y % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int off = tk - tq;
  const float* qb = q + bb * st.q[0] + h * st.q[1];
  const float* kb = k + bb * st.k[0] + kvh * st.k[1];
  const float* vb = v + bb * st.v[0] + kvh * st.v[1];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    sq[i * LD + d] = q0 + i < tq ? qb[(q0 + i) * st.q[2] + d] * scale : 0.0f;
  }
  if (tid < kBQ) {
    sm[tid] = kNegInf;
    sl[tid] = 0.0f;
  }

  // the key range any row of this block can keep
  const int qlo = q0 + off;                           // first row's qpos
  const int qhi = min(q0 + kBQ, tq) - 1 + off;        // last real row's
  const int kend = causal ? min(tk, qhi + 1) : tk;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) / kBK * kBK : 0;

  const int col = tid % D;       // this thread's accumulator column
  const int row0 = tid / D * RPT;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;

  const int lane = tid & 31, warp = tid >> 5;
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < tk;
      sk[j * LD + d] = in ? kb[(k0 + j) * st.k[2] + d] : 0.0f;
      sv[j * LD + d] = in ? vb[(k0 + j) * st.v[2] + d] : 0.0f;
    }
    __syncthreads();

    // logits: key j = lane, rows warp + 8 r
    {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* kr = sk + lane * LD;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s[r] = fmaf(sq[(warp + 8 * r) * LD + d], kd, s[r]);
      }
      const int kpos = k0 + lane;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = warp + 8 * r;
        const int qpos = q0 + i + off;
        float x = s[r];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool keep = kpos < tk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
        sp[i * LP + lane] = keep ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 4 w .. 4 w + 3, lane = key
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = warp * 4 + r;
      const float x = sp[i * LP + lane];
      const float m_prev = sm[i];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = x == -INFINITY ? 0.0f : expf(x - m_new);
      const float sum = warp_sum(p);
      sp[i * LP + lane] = p;
      if (lane == 0) {
        const float alpha = m_prev > kNegInf ? expf(m_prev - m_new) : 0.0f;
        sl[i] = sl[i] * alpha + sum;
        sm[i] = m_new;
        sa[i] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, one V load for the thread's RPT rows
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] *= sa[row0 + r];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float vj = sv[j * LD + col];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        acc[r] = fmaf(sp[(row0 + r) * LP + j], vj, acc[r]);
    }
  }
  __syncthreads();

  float* ob = o + bb * st.o[0] + h * st.o[1];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + r;
    if (q0 + i < tq) {
      const float l = sl[i];
      ob[(q0 + i) * st.o[2] + col] = acc[r] / (l == 0.0f ? 1.0f : l);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Strides& st, int b, int hq, int hkv, int tq, int tk,
               float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  constexpr auto kernel = attention_f32_kernel<D>;
  const cudaError_t err = set_smem_once<kernel>(int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((tq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, hq, hkv, tq,
      tk, scale, causal, window, softcap);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA ring, warp-specialised
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;         // query rows a block: 2 consumers x 64
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 2;       // K/V ring depth
constexpr int kAtom = 128;       // bytes of a swizzled row: 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kAtoms = D < 64 ? 1 : D / 64;  // 64-column boxes a row
  static constexpr int kBK = D == 256 ? 64 : 128;     // keys a tile
  static constexpr int kKSteps = (D + 15) / 16;       // k16 steps of Q K^T
  static constexpr int kQBytes = kBQ * kAtom * kAtoms;
  static constexpr int kKVBytes = kBK * kAtom * kAtoms;  // one K or V tile
  // tiles, 9 barriers, and room to align the base to 1024 bytes
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 128 + 1024;
};

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

// One box of a 3-d tensor map into shared memory, completing on `bar`.
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

#define FA_ACC8(i)                                                     \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define FA_ACC8E(i)                                                    \
  "+f"(e[(i)]), "+f"(e[(i) + 1]), "+f"(e[(i) + 2]), "+f"(e[(i) + 3]), \
      "+f"(e[(i) + 4]), "+f"(e[(i) + 5]), "+f"(e[(i) + 6]), "+f"(e[(i) + 7])
#define FA_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FA_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N, float32) (+)= A (64 x 16) B (16 x N), A and B bf16 from
// shared memory, both K-major.  `acc` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24), FA_ACC8(32),
        FA_ACC8(40), FA_ACC8(48), FA_ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, float32) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) B (16 x 64, bf16 in shared memory, MN-major:
// transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same over 128 columns of B (two 64-column boxes, LBO apart): d
// takes the first 64 columns, e the next.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], float (&e)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24), FA_ACC8E(0),
        FA_ACC8E(8), FA_ACC8E(16), FA_ACC8E(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_ACC8
#undef FA_ACC8E
#undef FA_REGS32
#undef FA_REGS64

// 2^x on the special-function unit (relative error about 2^-22; 0 for
// -inf), without exp2f's range handling.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Shared-memory addresses of the tiles and barriers of a block.
template <int D>
struct Ring {
  uint32_t base;  // 1024-byte aligned: Q, then K and V of each stage
  static constexpr int kTiles = Shape<D>::kQBytes + 2 * kStages *
                                                        Shape<D>::kKVBytes;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const {
    return base + Shape<D>::kQBytes + 2 * s * Shape<D>::kKVBytes;
  }
  __device__ uint32_t v(int s) const { return k(s) + Shape<D>::kKVBytes; }
  // 8-byte barriers: Q full; per stage K full, V full, K empty, V empty
  __device__ uint32_t q_full() const { return base + kTiles; }
  __device__ uint32_t k_full(int s) const { return q_full() + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const { return k_full(kStages + s); }
  __device__ uint32_t k_empty(int s) const {
    return k_full(2 * kStages + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return k_full(3 * kStages + s);
  }
};

// One consumer warpgroup: 64 query rows, their O in registers, and the
// online softmax.  Step t issues S(t) = Q K(t)^T and O += P(t-1) V(t-1)
// back to back, then runs the softmax of S(t) while the second product
// is in flight.  Every wgmma is issued and waited for inside one
// straight-line step, so none is in flight across a branch.
template <int D, bool kCap>
struct Consumer {
  static constexpr int BK = Shape<D>::kBK, NA = Shape<D>::kAtoms;
  Ring<D> ring;
  uint32_t sq;           // this warpgroup's 64 rows of the Q tile
  int tk, causal, window, cq, qpos0;
  float scale, softcap, sl2;
  float acc[NA][32];     // O, float32
  float sc[BK / 2];      // S of the current tile, then its P (float32)
  uint32_t pa[BK / 16][4];  // P of the previous tile: bf16 register-A
  // per row: running max (in logit units: raw q.k, or the capped logit
  // in log2 units under softcap), sum, rescale of O
  float m[2], l[2], alpha[2];

  __device__ __forceinline__ void issue_s(int s) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int i = 0; i < Shape<D>::kKSteps; ++i) {
      const int a = i / 4, kk = i % 4;   // box, 16-column step in it
      wgmma_ss(sc, sw128_desc(sq + a * kBQ * kAtom + 32 * kk, 16, 1024),
               sw128_desc(ring.k(s) + a * BK * kAtom + 32 * kk, 16, 1024),
               i);
    }
    wg_commit();
  }

  // 128 columns of D a product where D has them, else 64
  __device__ __forceinline__ void issue_pv(int s) {
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t v = ring.v(s) + 16 * j * kAtom;
      if constexpr (NA % 2 == 0) {
#pragma unroll
        for (int a = 0; a < NA; a += 2)
          wgmma_rs(acc[a], acc[a + 1], pa[j],
                   sw128_desc(v + a * BK * kAtom, BK * kAtom, 1024));
      } else {
        wgmma_rs(acc[0], pa[j], sw128_desc(v, BK * kAtom, 1024));
      }
    }
    wg_commit();
  }

  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i >> 1) & 1];
  }

  // Softmax of the tile at k0; p stays in sc.  The max is taken over the
  // logits x as they stand (raw q.k without softcap, whose scale is
  // positive), and p = 2^(x u - max u) is one fused multiply-add and one
  // ex2, with u = scale log2(e) (1 under softcap, whose logits are scaled
  // and in log2 units already).  kMask: the tile crosses the causal,
  // window or Tk edge.
  template <bool kMask>
  __device__ __forceinline__ void softmax(int k0) {
    const float u = kCap ? 1.0f : sl2;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;              // row r0 + 8 h
      float x = kCap ? softcap * tanhf(sc[i] * scale / softcap) * kLog2e
                     : sc[i];
      if (kMask) {
        const int kpos = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qpos = qpos0 + 8 * h;
        const bool keep = kpos < tk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
        x = keep ? x : -INFINITY;
      }
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float rs[2] = {0.0f, 0.0f}, mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mu[h] = -mx[h] * u;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], u, mu[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = m[h] > kNegInf ? ex2((m[h] - mx[h]) * u) : 0.0f;
      m[h] = mx[h];
      l[h] = l[h] * alpha[h] + rs[h];
    }
  }

  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
  }

  // Step 0: S(0) and its softmax.
  template <bool kMask>
  __device__ __forceinline__ void first(int k0) {
    mbar_wait(ring.k_full(0), 0);
    issue_s(0);
    wg_wait<0>();
    reg_fence(sc);
    mbar_arrive(ring.k_empty(0));
    softmax<kMask>(k0);
    pack();
  }

  // Step t >= 1: S(t), then P(t-1) V(t-1) under the softmax of S(t).
  template <bool kMask>
  __device__ __forceinline__ void step(int t, int k0) {
    const int s = t % kStages, sp = (t - 1) % kStages;
    mbar_wait(ring.k_full(s), (t / kStages) & 1);
    mbar_wait(ring.v_full(sp), ((t - 1) / kStages) & 1);
    rescale();
    issue_s(s);
    issue_pv(sp);
    wg_wait<1>();
    reg_fence(sc);
    mbar_arrive(ring.k_empty(s));
    softmax<kMask>(k0);
    wg_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) reg_fence(acc[a]);
    reg_fence(pa);
    mbar_arrive(ring.v_empty(sp));
    pack();
  }

  // After the last step: P(n-1) V(n-1).
  __device__ __forceinline__ void last(int n) {
    const int sp = (n - 1) % kStages;
    mbar_wait(ring.v_full(sp), ((n - 1) / kStages) & 1);
    rescale();
    issue_pv(sp);
    wg_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) reg_fence(acc[a]);
  }
};

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ o, int hq, int hkv, int tq,
                    int tk, float scale, int causal, int window,
                    float softcap) {
  using S = Shape<D>;
  constexpr int BK = S::kBK, NA = S::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align every tile to it
  const Ring<D> ring{(smem_u32(smem_raw) + 1023u) & ~1023u};

  const int bh = blockIdx.x;                          // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const int off = tk - tq;
  // the key range any row of this block can keep
  const int qlo = q0 + off;
  const int qhi = min(q0 + kBQ, tq) - 1 + off;
  const int kend = causal ? min(tk, qhi + 1) : tk;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) / BK * BK : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.k_full(s), 1);
      mbar_init(ring.v_full(s), 1);
      mbar_init(ring.k_empty(s), 2 * 128);  // every consumer thread arrives
      mbar_init(ring.v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full; tile t lives in
    // stage t % kStages, its K and V released apart
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.q_full(), S::kQBytes);
      for (int a = 0; a < NA; ++a)
        tma_load(ring.q() + a * kBQ * kAtom, &qmap, ring.q_full(), 64 * a, q0,
                 bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        const uint32_t par = (t / kStages - 1) & 1;
        const int k0 = kbeg + t * BK;
        if (t >= kStages) mbar_wait(ring.k_empty(s), par);
        mbar_expect_tx(ring.k_full(s), S::kKVBytes);
        for (int a = 0; a < NA; ++a)
          tma_load(ring.k(s) + a * BK * kAtom, &kmap, ring.k_full(s), 64 * a,
                   k0, kvh);
        if (t >= kStages) mbar_wait(ring.v_empty(s), par);
        mbar_expect_tx(ring.v_full(s), S::kKVBytes);
        for (int a = 0; a < NA; ++a)
          tma_load(ring.v(s) + a * BK * kAtom, &vmap, ring.v_full(s), 64 * a,
                   k0, kvh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int ct = threadIdx.x - 128;
    const int w = ct / 128;                    // rows 64 w .. 64 w + 63
    const int warp = (ct % 128) / 32, lane = ct % 32;
    // accumulator layout: this thread holds rows r0 and r0 + 8, columns
    // 8 c + cq + {0, 1} of every 8-column chunk c
    const int r0 = 64 * w + 16 * warp + lane / 4;
    Consumer<D, kCap> c;
    c.ring = ring;
    c.sq = ring.q() + 64 * w * kAtom;
    c.tk = tk;
    c.causal = causal;
    c.window = window;
    c.cq = 2 * (lane % 4);
    c.qpos0 = q0 + r0 + off;
    c.scale = scale;
    c.softcap = softcap;
    c.sl2 = scale * kLog2e;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) c.acc[a][i] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c.m[h] = kNegInf;
      c.l[h] = 0.0f;
      c.alpha[h] = 1.0f;
    }
    // a tile needs masks where it crosses the Tk, causal or window edge
    // of the block's rows: the test depends on the block alone, so both
    // branches are uniform and no product is serialised around them
    auto edge = [&](int k0) {
      return k0 + BK > tk || (causal && k0 + BK - 1 > qlo) ||
             (window > 0 && k0 <= q0 + kBQ - 1 + off - window);
    };

    mbar_wait(ring.q_full(), 0);
    if (ntiles > 0) {
      if (edge(kbeg))
        c.template first<true>(kbeg);
      else
        c.template first<false>(kbeg);
      for (int t = 1; t < ntiles; ++t) {
        const int k0 = kbeg + t * BK;
        if (edge(k0))
          c.template step<true>(t, k0);
        else
          c.template step<false>(t, k0);
      }
      c.last(ntiles);
    }

    // epilogue: O / l, rounded once, rows < Tq and columns < D
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = c.l[h] + __shfl_xor_sync(0xffffffffu, c.l[h], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      c.l[h] = sum == 0.0f ? 1.0f : sum;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + 8 * h;
      if (row >= tq) continue;
      __nv_bfloat16* orow = o + (size_t(bh) * tq + row) * D;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int col = 64 * a + 8 * cc + c.cq;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(c.acc[a][4 * cc + 2 * h] / c.l[h],
                                      c.acc[a][4 * cc + 2 * h + 1] / c.l[h]);
        }
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

// The (D, T, B*H) view of a contiguous (B, H, T, D) bf16 tensor, boxes of
// 64 columns x `rows` x 1 with 128-byte swizzle; out-of-range elements
// (columns past D, rows past T) load as zeros.
bool encode(CUtensorMap* map, const void* ptr, int d, int t, int bh,
            int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(t), cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(t) * d * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
bool encode_all(CUtensorMap* maps, const void* q, const void* k,
                const void* v, int b, int hq, int hkv, int tq, int tk) {
  return encode(&maps[0], q, D, tq, b * hq, kBQ) &&
         encode(&maps[1], k, D, tk, b * hkv, Shape<D>::kBK) &&
         encode(&maps[2], v, D, tk, b * hkv, Shape<D>::kBK);
}

template <int D, bool kCap>
int launch_cap(const CUtensorMap (&maps)[3], void* o, int b, int hq, int hkv,
               int tq, int tk, float scale, int causal, int window,
               float softcap, cudaStream_t stream) {
  constexpr auto kernel = attention_tc_kernel<D, kCap>;
  const cudaError_t err = set_smem_once<kernel>(Shape<D>::kSmem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(b * hq, (tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, Shape<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), hq, hkv, tq,
      tk, scale, causal, window, softcap);
  return int(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int tq, int tk, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!encode_all<D>(maps, q, k, v, b, hq, hkv, tq, tk))
    return int(cudaErrorInvalidValue);
  return softcap > 0.0f
             ? launch_cap<D, true>(maps, o, b, hq, hkv, tq, tk, scale, causal,
                                   window, softcap, stream)
             : launch_cap<D, false>(maps, o, b, hq, hkv, tq, tk, scale,
                                    causal, window, softcap, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: split TF32 on the tensor cores (wgmma), a producer warpgroup
// ---------------------------------------------------------------------------

namespace tf {

using tc::ex2;
using tc::mbar_arrive;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tf32::kLine;

constexpr int kBQ = 128;         // query rows a block: 2 consumers x 64
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kLines = D < 32 ? 1 : D / 32;   // 32-float lines a row
  static constexpr int kBK = D == 128 ? 32 : 64;       // keys a tile
  static constexpr int kKStages = D == 128 ? 1 : 2;    // K ring depth
  static constexpr int kVStages = 2;                   // V ring depth
  static constexpr int kKSteps = D / 8;                // k8 steps of Q K^T
  static constexpr int kPer = kBK * D / 128;   // K (or V) values a producer
  // bytes of one part (hi or lo): Q (kBQ rows), K (kBK rows), V^T (D rows
  // of kBK keys)
  static constexpr int kQBytes = kBQ * kLine * kLines;
  static constexpr int kKBytes = kBK * kLine * kLines;
  static constexpr int kVBytes = D * kLine * (kBK / 32);
  static constexpr int kTiles =
      2 * (kQBytes + kKStages * kKBytes + kVStages * kVBytes);
  // tiles, 1 + 2 (kKStages + kVStages) barriers, and room to align the
  // base to 1024
  static constexpr int kSmem =
      kTiles + 8 * (1 + 2 * (kKStages + kVStages)) + 1024;
  static_assert(kSmem <= 232448, "over the shared memory of a block");
};

// Shared-memory addresses of the tiles (hi, lo) and barriers of a block.
template <int D>
struct Ring {
  using S = Shape<D>;
  uint32_t base;   // 1024-byte aligned, shared space
  __device__ uint32_t q(int part) const { return base + part * S::kQBytes; }
  __device__ uint32_t k(int s, int part) const {
    return base + 2 * S::kQBytes + (2 * s + part) * S::kKBytes;
  }
  __device__ uint32_t v(int s, int part) const {
    return base + 2 * S::kQBytes + 2 * S::kKStages * S::kKBytes +
           (2 * s + part) * S::kVBytes;
  }
  // Q full; per K stage full and empty, per V stage full and empty
  __device__ uint32_t q_full() const { return base + S::kTiles; }
  __device__ uint32_t k_full(int s) const { return q_full() + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const {
    return k_full(S::kKStages + s);
  }
  __device__ uint32_t v_full(int s) const {
    return k_full(2 * S::kKStages + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return k_full(2 * S::kKStages + S::kVStages + s);
  }
};

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// One consumer warpgroup: 64 query rows, their O in registers and the
// online softmax, as the bf16 kernel's `tc::Consumer`, with every product
// split: S(t) = Q K(t)^T from the Q and K tiles (hi, lo), O += P(t-1)
// V(t-1) with P split in registers into A fragments and V^T's keys in
// `tf32::kperm` order.
template <int D, bool kCap>
struct Consumer {
  using S = Shape<D>;
  static constexpr int BK = S::kBK;
  Ring<D> ring;
  uint32_t qrow;         // byte offset of this warpgroup's 64 rows in Q
  int tk, causal, window, cq, qpos0;
  float scale, softcap, sl2;
  float acc[D / 2];      // O, float32
  float sc[BK / 2];      // S of the current tile, then its P (float32)
  uint32_t ph[BK / 8][4], pl[BK / 8][4];   // P of the previous tile
  float m[2], l[2], alpha[2];

  __device__ __forceinline__ void issue_s(int s) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    const uint64_t qh = tf32::desc_here(ring.q(0) + qrow);
    const uint64_t ql = tf32::desc_here(ring.q(1) + qrow);
    const uint64_t kh = tf32::desc_here(ring.k(s, 0));
    const uint64_t kl = tf32::desc_here(ring.k(s, 1));
    tf32::fence();
#pragma unroll
    for (int i = 0; i < S::kKSteps; ++i)
      tf32::mma3_ss<BK>(sc, tf32::kstep(qh, i, kBQ), tf32::kstep(ql, i, kBQ),
                        tf32::kstep(kh, i, BK), tf32::kstep(kl, i, BK), i);
    tf32::commit();
  }

  __device__ __forceinline__ void issue_pv(int s) {
    const uint64_t vh = tf32::desc_here(ring.v(s, 0));
    const uint64_t vl = tf32::desc_here(ring.v(s, 1));
    tf32::fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      tf32::mma3_rs<D>(acc, ph[j], pl[j], tf32::kstep(vh, j, D),
                       tf32::kstep(vl, j, D));
    tf32::commit();
  }

  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }

  // `tc::Consumer::softmax`, on float32 p.
  template <bool kMask>
  __device__ __forceinline__ void softmax(int k0) {
    const float u = kCap ? 1.0f : sl2;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;              // row r0 + 8 h
      float x = kCap ? softcap * tanhf(sc[i] * scale / softcap) * kLog2e
                     : sc[i];
      if (kMask) {
        const int kpos = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qpos = qpos0 + 8 * h;
        const bool keep = kpos < tk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
        x = keep ? x : -INFINITY;
      }
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float rs[2] = {0.0f, 0.0f}, mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mu[h] = -mx[h] * u;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], u, mu[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = m[h] > kNegInf ? ex2((m[h] - mx[h]) * u) : 0.0f;
      m[h] = mx[h];
      l[h] = l[h] * alpha[h] + rs[h];
    }
  }

  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      tf32::frag(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3],
                 ph[j], pl[j]);
  }

  template <bool kMask>
  __device__ __forceinline__ void first(int k0) {
    mbar_wait(ring.k_full(0), 0);
    issue_s(0);
    tf32::wait<0>();
    tf32::reg_fence(sc);
    mbar_arrive(ring.k_empty(0));
    softmax<kMask>(k0);
    pack();
  }

  template <bool kMask>
  __device__ __forceinline__ void step(int t, int k0) {
    constexpr int NK = S::kKStages, NV = S::kVStages;
    const int s = t % NK, sp = (t - 1) % NV;
    mbar_wait(ring.k_full(s), (t / NK) & 1);
    mbar_wait(ring.v_full(sp), ((t - 1) / NV) & 1);
    rescale();
    issue_s(s);
    issue_pv(sp);
    tf32::wait<1>();
    tf32::reg_fence(sc);
    mbar_arrive(ring.k_empty(s));
    softmax<kMask>(k0);
    tf32::wait<0>();
    tf32::reg_fence(acc);
    reg_fence(ph);
    reg_fence(pl);
    mbar_arrive(ring.v_empty(sp));
    pack();
  }

  __device__ __forceinline__ void last(int n) {
    constexpr int NV = S::kVStages;
    const int sp = (n - 1) % NV;
    mbar_wait(ring.v_full(sp), ((n - 1) / NV) & 1);
    rescale();
    issue_pv(sp);
    tf32::wait<0>();
    tf32::reg_fence(acc);
  }
};

// The producer warpgroup's Q, K and V tiles: raw float32 copied from the
// caller's strides straight to where their hi goes (`cp.async`, no
// register; zeros past Tq or Tk), then split in place: hi there, lo in the
// lo tile.  Q and K rows go 16 bytes at a time (4 columns); V goes to V^T
// one value at a time, 4 keys of a column a thread, the 4 that `kperm`
// puts side by side (keys 8 g + o, + 2, + 4, + 6, o = 0 or 1), so that its
// split is 16 bytes at a time too.  A thread splits exactly what it
// copied, so needs no barrier between the two; rows are walked by a
// running 32-bit offset, so that no per-row address is held across the
// loop.
template <int D>
struct Producer {
  using S = Shape<D>;
  static constexpr int BK = S::kBK, NK = S::kKStages, NV = S::kVStages;
  static constexpr int C4 = D < 4 ? 1 : D / 4;    // 16-byte chunks a row
  static constexpr int RK = 128 / C4;             // rows a pass of Q or K
  static constexpr int KQ = BK * C4 / 128;        // K chunks a thread
  static constexpr int R = 128 / D;               // V^T quads a pass
  static constexpr int VQ = D * (BK / 4) / 128;   // V^T quads a thread
  static_assert(KQ >= 1 && VQ >= 1, "D must divide 128");
  Ring<D> ring;
  const float* kb;   // this (batch, KV head)'s origins
  const float* vb;
  int kt, vt;        // time strides
  int kbeg, tk, pt;

  // Q's rows q0 .. q0 + kBQ - 1 (rows from tq on as zeros); one copy group
  __device__ __forceinline__ void copy_q(const float* qb, int qt, int q0,
                                         int tq) const {
    const int c = 4 * (pt % C4), r0 = pt / C4;
    int off = (q0 + r0) * qt + c;
    for (int r = r0; r < kBQ; r += RK) {
      const bool in = q0 + r < tq;
      tf32::copy16(ring.q(0) + tf32::sw(r, c, kBQ), qb + (in ? off : 0), in);
      off += RK * qt;
    }
    tf32::copy_commit();
  }
  __device__ __forceinline__ void split_q() const {
    const int c = 4 * (pt % C4), r0 = pt / C4;
    for (int r = r0; r < kBQ; r += RK) {
      const uint32_t at = tf32::sw(r, c, kBQ);
      tf32::split4_in_place(ring.q(0) + at, ring.q(1) + at);
    }
    tf32::proxy_fence();
    mbar_arrive(ring.q_full());
  }

  // tile t: K and V copied into their slots, once free (two copy groups)
  __device__ __forceinline__ void copy(int t) const {
    const int s = t % NK, sv = t % NV, k0 = kbeg + t * BK;
    if (t >= NK) mbar_wait(ring.k_empty(s), (t / NK - 1) & 1);
    const int c = 4 * (pt % C4), j0 = pt / C4;
    int off = (k0 + j0) * kt + c;
#pragma unroll
    for (int i = 0; i < KQ; ++i) {
      const bool in = k0 + j0 + RK * i < tk;
      tf32::copy16(ring.k(s, 0) + tf32::sw(j0 + RK * i, c, BK),
                   kb + (in ? off : 0), in);
      off += RK * kt;
    }
    tf32::copy_commit();
    if (t >= NV) mbar_wait(ring.v_empty(sv), (t / NV - 1) & 1);
    const int d = pt % D, q0 = pt / D;
#pragma unroll
    for (int i = 0; i < VQ; ++i) {
      const int q = q0 + R * i, key = 8 * (q >> 1) + (q & 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const bool in = k0 + key + 2 * m < tk;
        tf32::copy4(ring.v(sv, 0) + tf32::sw(d, 4 * q + m, D),
                    vb + (in ? (k0 + key + 2 * m) * vt + d : 0), in);
      }
    }
    tf32::copy_commit();
  }

  // tile t split in place and handed over: K once its copy group has
  // landed, then V
  __device__ __forceinline__ void split(int t) const {
    const int s = t % NK, sv = t % NV;
    const int c = 4 * (pt % C4), j0 = pt / C4;
    tf32::copy_wait<1>();
#pragma unroll
    for (int i = 0; i < KQ; ++i) {
      const uint32_t at = tf32::sw(j0 + RK * i, c, BK);
      tf32::split4_in_place(ring.k(s, 0) + at, ring.k(s, 1) + at);
    }
    tf32::proxy_fence();
    mbar_arrive(ring.k_full(s));
    const int d = pt % D, q0 = pt / D;
    tf32::copy_wait<0>();
#pragma unroll
    for (int i = 0; i < VQ; ++i) {
      const uint32_t at = tf32::sw(d, 4 * (q0 + R * i), D);
      tf32::split4_in_place(ring.v(sv, 0) + at, ring.v(sv, 1) + at);
    }
    tf32::proxy_fence();
    mbar_arrive(ring.v_full(sv));
  }
};

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      Strides st, int hq, int hkv, int tq, int tk,
                      float scale, int causal, int window, float softcap) {
  using S = Shape<D>;
  constexpr int BK = S::kBK, NK = S::kKStages, NV = S::kVStages;
  constexpr int PER = S::kPer;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Ring<D> ring{base};

  const int bh = blockIdx.x;                          // b * hq + h
  const int bb = bh / hq, h = bh % hq, kvh = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int off = tk - tq;
  const int qlo = q0 + off;
  const int qhi = min(q0 + kBQ, tq) - 1 + off;
  const int kend = causal ? min(tk, qhi + 1) : tk;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) / BK * BK : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full(), 128);      // every producer thread arrives
    for (int s = 0; s < NK; ++s) {
      mbar_init(ring.k_full(s), 128);
      mbar_init(ring.k_empty(s), 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < NV; ++s) {
      mbar_init(ring.v_full(s), 128);
      mbar_init(ring.v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    // producer warpgroup: the Q tile, then the K and V tiles (`Producer`)
    const Producer<D> pr{ring, k + bb * st.k[0] + kvh * st.k[1],
                         v + bb * st.v[0] + kvh * st.v[1], int(st.k[2]),
                         int(st.v[2]), kbeg, tk, int(threadIdx.x)};
    // Q's copy group first, tile 0's behind it
    pr.copy_q(q + bb * st.q[0] + h * st.q[1], int(st.q[2]), q0, tq);
    if (ntiles > 0) {
      pr.copy(0);
      tf32::copy_wait<2>();
    } else {
      tf32::copy_wait<0>();
    }
    pr.split_q();
    for (int t = 0; t < ntiles; ++t) {
      if (t > 0) pr.copy(t);
      pr.split(t);
    }
  } else {
    // the producer's 64 registers a thread, to both consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int ct = threadIdx.x - 128;
    const int w = ct / 128;                    // rows 64 w .. 64 w + 63
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int r0 = 64 * w + 16 * warp + lane / 4;
    Consumer<D, kCap> c;
    c.ring = ring;
    c.qrow = 64 * w * kLine;
    c.tk = tk;
    c.causal = causal;
    c.window = window;
    c.cq = 2 * (lane % 4);
    c.qpos0 = q0 + r0 + off;
    c.scale = scale;
    c.softcap = softcap;
    c.sl2 = scale * kLog2e;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) c.acc[i] = 0.0f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      c.m[hh] = kNegInf;
      c.l[hh] = 0.0f;
      c.alpha[hh] = 1.0f;
    }
    auto edge = [&](int k0) {
      return k0 + BK > tk || (causal && k0 + BK - 1 > qlo) ||
             (window > 0 && k0 <= q0 + kBQ - 1 + off - window);
    };

    mbar_wait(ring.q_full(), 0);
    if (ntiles > 0) {
      if (edge(kbeg))
        c.template first<true>(kbeg);
      else
        c.template first<false>(kbeg);
      for (int t = 1; t < ntiles; ++t) {
        const int k0 = kbeg + t * BK;
        if (edge(k0))
          c.template step<true>(t, k0);
        else
          c.template step<false>(t, k0);
      }
      c.last(ntiles);
    }

    // epilogue: O / l for rows < Tq, columns < D, at o's strides
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = c.l[hh] + __shfl_xor_sync(0xffffffffu, c.l[hh], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      c.l[hh] = sum == 0.0f ? 1.0f : sum;
    }
    float* ob = o + bb * st.o[0] + h * st.o[1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      if (row >= tq) continue;
      float* orow = ob + row * st.o[2];
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc) {
        const int col = 8 * cc + c.cq;
        orow[col] = c.acc[4 * cc + 2 * hh] / c.l[hh];
        orow[col + 1] = c.acc[4 * cc + 2 * hh + 1] / c.l[hh];
      }
    }
  }
}

template <int D, bool kCap>
int launch_cap(const void* q, const void* k, const void* v, void* o,
               const Strides& st, int b, int hq, int hkv, int tq, int tk,
               float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  constexpr auto kernel = attention_tf32_kernel<D, kCap>;
  const cudaError_t err = set_smem_once<kernel>(Shape<D>::kSmem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(b * hq, (tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, Shape<D>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, hq, hkv, tq,
      tk, scale, causal, window, softcap);
  return int(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int b, int hq, int hkv, int tq, int tk,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  if constexpr (D == 256) {   // the split Q tile alone would be 256 KB
    return int(cudaErrorInvalidValue);
  } else {
    return softcap > 0.0f
               ? launch_cap<D, true>(q, k, v, o, st, b, hq, hkv, tq, tk,
                                     scale, causal, window, softcap, stream)
               : launch_cap<D, false>(q, k, v, o, st, b, hq, hkv, tq, tk,
                                      scale, causal, window, softcap, stream);
  }
}

// One m64n32k8 .tf32 product of raw float32 operands: A (64 x 8) and B
// (32 x 8), both row-major in global memory, out (64 x 32) = A B^T as the
// tensor cores compute it.  One warpgroup.
__global__ void __launch_bounds__(128)
tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out) {
  __shared__ __align__(1024) uint8_t tile[96 * kLine];
  const int tid = threadIdx.x;
  for (int e = tid; e < 64 * 8; e += 128)
    *reinterpret_cast<float*>(tile + tf32::sw(e / 8, e % 8, 64)) = a[e];
  for (int e = tid; e < 32 * 8; e += 128)
    *reinterpret_cast<float*>(tile + 64 * kLine + tf32::sw(e / 8, e % 8, 32)) =
        b[e];
  tf32::proxy_fence();
  __syncthreads();
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0.0f;
  const uint32_t base = smem_u32(tile);
  tf32::fence();
  tf32::mma_ss<32>(d, tf32::desc(base), tf32::desc(base + 64 * kLine), 0);
  tf32::commit();
  tf32::wait<0>();
  tf32::reg_fence(d);
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[(r0 + 8 * ((i >> 1) & 1)) * 32 + 8 * (i >> 2) + cq + (i & 1)] = d[i];
}

}  // namespace tf

#define FA_DISPATCH(FN, ...)                     \
  switch (d) {                                   \
    case 8: return FN<8>(__VA_ARGS__);           \
    case 16: return FN<16>(__VA_ARGS__);         \
    case 32: return FN<32>(__VA_ARGS__);         \
    case 64: return FN<64>(__VA_ARGS__);         \
    case 128: return FN<128>(__VA_ARGS__);       \
    case 256: return FN<256>(__VA_ARGS__);       \
    default: break;                              \
  }

}  // namespace

// Plain C interface for ctypes.  route: 0 float32 on the CUDA cores, 1
// bfloat16 on the tensor cores (contiguous q, k, v, o; `strides` is not
// read), 2 float32 as split TF32 on the tensor cores (D 8, 16, 32, 64,
// 128).  Each route takes D 8, 16, 32, 64, 128 and 256 but route 2 at
// D = 256.
// `strides`: 12 element strides, (batch, head, time) of q, k, v and o in
// turn; D is contiguous.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int b, int hq,
                                      int hkv, int tq, int tk, int d,
                                      int route, float scale, int causal,
                                      int window, float softcap,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    FA_DISPATCH(tc::launch, q, k, v, o, b, hq, hkv, tq, tk, scale, causal,
                window, softcap, s)
    return int(cudaErrorInvalidValue);
  }
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  if (route == 0) {
    FA_DISPATCH(launch_f32, q, k, v, o, st, b, hq, hkv, tq, tk, scale,
                causal, window, softcap, s)
  } else if (route == 2) {
    FA_DISPATCH(tf::launch, q, k, v, o, st, b, hq, hkv, tq, tk, scale,
                causal, window, softcap, s)
  }
  return int(cudaErrorInvalidValue);
}

// The TF32 probe: out (64 x 32, float32) = a (64 x 8) b^T (b 32 x 8), all
// row-major float32 on the card, as one `wgmma` .tf32 product of the raw
// values computes it (whether the tensor cores truncate or round a
// float32 operand).  Returns the cudaError_t of the launch.
extern "C" int tf32_probe(const void* a, const void* b, void* out,
                          void* stream) {
  tf::tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

// Host cost of the bf16 path's tensor maps: mean microseconds to encode
// the three maps of one launch, over `reps` encodings; -1 if encoding
// fails.  Touches no device memory.
extern "C" double flash_attention_encode_us(const void* q, const void* k,
                                            const void* v, int b, int hq,
                                            int hkv, int tq, int tk, int d,
                                            int reps) {
  CUtensorMap maps[3];
  auto once = [&]() -> bool {
    FA_DISPATCH(tc::encode_all, maps, q, k, v, b, hq, hkv, tq, tk)
    return false;
  };
  if (reps < 1 || !once()) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r) once();
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / reps;
}
