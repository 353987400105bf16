// Block-wise online-softmax attention (GQA, causal, sliding window,
// softcap) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_kernel` of
// src/repro/kernels/flash_attention.py (launched by `flash_attention`).
// Semantics contract: repro_torch/kernels/ref.py::mha.
//
//   q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D), contiguous; query head h reads
//   kv head h / (Hq / Hkv) (GQA, no K/V copy);
//   qpos = i + (Tk - Tq), kpos = j;
//   logit = (scale * q) . k, then softcap * tanh(logit / softcap);
//   kept where kpos < Tk, kpos <= qpos (causal), kpos > qpos - window;
//   out = softmax over the kept keys, 0 for a row with none kept.
//   m, l and the accumulator are float32; out is in q's type.
//
// Design.  One block of 256 threads owns BQ = 32 query rows of one
// (batch, head): the Pallas grid's sequential key axis becomes a loop
// inside the block, so nothing crosses blocks.  The scaled Q tile stays
// in shared memory as float32; each BK = 32 key tile of K and V is
// staged into shared memory (float32, rows padded to D + 1 floats so
// that the 32 lanes reading 32 key rows hit 32 banks).  Per tile: every
// thread computes 4 logits (one key, 4 rows); each warp takes 4 rows for
// the online-softmax update (lane = key: warp-shuffle max and sum); then
// every thread updates its RPT = 32 D / 256 accumulator entries (one
// column, RPT rows) in registers.  Key tiles wholly outside the causal
// or window band are skipped: a masked tile leaves m, l and the
// accumulator unchanged, so the result is the same.  D is a template
// parameter (8, 32, 64, 128, 256); float32 and bf16 inputs.
//
// Bound on an H100 SXM: the function reads q, k, v once and writes o
// (bytes / 3.35 TB/s) and does 4 D flops per kept (query, key) pair per
// (batch, head) (flops / 989 TFLOP/s for bf16 on the tensor cores,
// 67 TFLOP/s for float32).  chatglm3-6b's serving prefill (T = 128,
// bf16) is bound by bytes (0.7 us), a long prefill (T = 8192) by
// operations (0.56 ms).  This kernel runs on the CUDA cores in float32
// from shared memory (about one shared load per fused multiply-add), far
// from the tensor-core rate; `mma`/`wgmma` tiles are later work.
//
// The two inner loops (logits and P V) call fmaf() explicitly, which
// the build's global --fmad=false leaves as fused multiply-adds: this
// kernel needs no bitwise match, and the plain version is held to a
// tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;   // query rows per block
constexpr int kBK = 32;   // keys per tile (one per lane)
constexpr float kNegInf = -2.0e38f;  // running-max start, as the Pallas kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int tq, int tk, float scale, int causal,
                       int window, float softcap) {
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
  const int bh = blockIdx.y;                      // b * hq + h
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const int q0 = blockIdx.x * kBQ;
  const int off = tk - tq;
  const T* qb = q + size_t(bh) * tq * D;
  const T* kb = k + size_t(kvh) * tk * D;
  const T* vb = v + size_t(kvh) * tk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    sq[i * LD + d] = q0 + i < tq ? to_f32(qb[size_t(q0 + i) * D + d]) * scale
                                 : 0.0f;
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
      const size_t g = size_t(k0 + j) * D + d;
      sk[j * LD + d] = in ? to_f32(kb[g]) : 0.0f;
      sv[j * LD + d] = in ? to_f32(vb[g]) : 0.0f;
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

  T* ob = o + size_t(bh) * tq * D;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + r;
    if (q0 + i < tq) {
      const float l = sl[i];
      store(ob + size_t(q0 + i) * D + col, acc[r] / (l == 0.0f ? 1.0f : l));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int tq, int tk, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((tq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, tq, tk, scale,
      causal, window, softcap);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int b, int hq, int hkv, int tq, int tk, float scale, int causal,
             int window, float softcap, cudaStream_t s) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, o, b, hq, hkv, tq, tk, scale, causal,
                          window, softcap, s);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, tq, tk, scale, causal,
                           window, softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, tq, tk, scale, causal,
                           window, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, tq, tk, scale, causal,
                            window, softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, o, b, hq, hkv, tq, tk, scale, causal,
                            window, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 float32, 1 bfloat16.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int tq, int tk, int d,
                                      int dtype, float scale, int causal,
                                      int window, float softcap,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, o, b, hq, hkv, tq, tk, scale, causal,
                           window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, tq, tk, scale,
                                   causal, window, softcap, s);
  return int(cudaErrorInvalidValue);
}
