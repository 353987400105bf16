// Mamba-2 SSD (state-space duality) scan with initial and final state,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (launched by `ssd_chunked`).  Semantics
// contract: repro_torch/kernels/ref.py::ssd.
//
//   x (B, T, H, P), b and c (B, T, N) in one type (float32 or bf16),
//   a (B, T, H) float32 log-decay <= 0, h0 (B, H, P, N) float32;
//   for every (batch, head), in order over t:
//     h_t = exp(a_t) h_{t-1} + x_t (outer) b_t,   y_t = h_t c_t;
//   y (B, T, H, P) in x's type, hT = h_T (B, H, P, N) float32.
//
// Design.  Each row p of a head's (P, N) state evolves on its own: row p
// at step t needs only x[t, p], the step's decay and the shared b_t and
// c_t.  So the TPU's sequential chunk grid becomes a loop over t inside
// a block that owns ROWS rows of the state of one (batch, head); blocks
// never exchange anything, and a grid of (P / ROWS, H, B) puts 256
// blocks in flight at mamba2-1.3b's widths (P 64, N 128, H 64).  A block
// has 128 threads: G = N / NPT threads share a row, each holding NPT
// (<= 16) state entries in registers for the whole sequence (columns
// n = 4 G q + 4 g + i, i < 4, so that the G lanes of a row read b and c
// as conflict-free float4s).  Per step a thread does NPT decays and
// rank-1 updates and NPT products with c, and the row's G lanes sum
// their products with warp shuffles.  Steps are staged kLT = 32 at a
// time: the block copies the steps' decays (expf of a, once), b, c and
// its rows of x into shared memory as float32 (37 KB at N 128), walks
// them, and writes the steps' y rows back coalesced.  Each thread's
// share of the next stage is loaded into registers before the block
// walks the current one, so the global loads overlap the steps.  A
// ragged last stage is cut at T (the Pallas kernel pads it with
// a_log = 0, b = 0, which leaves the state as it was: the same result).  N is a template
// parameter (4, 8, 16, 32, 64, 128); P is taken at run time and rows
// past P are masked.
//
// Bound on an H100 SXM: the function reads x, a, b, c and h0 once and
// writes y and hT (bytes / 3.35 TB/s); the least work is the chunked
// (SSD) form on the tensor cores, about 2 L P + 4 P N flops a step and
// head with C B^T shared by the heads (flops / 989 TFLOP/s in bf16).
// mamba2-1.3b's prefill (T <= 128: 6 MB, 1.8 us) and a long prefill
// (T = 8192: 142 MB, 42 us) are both bound by bytes.  This kernel is
// the recurrent form on the CUDA cores instead: about 5 P N float32
// flops a step and head, a chain of T dependent steps per block, and
// b and c re-read from L2 by every block of a batch row.  It is far
// above the bytes bound at long T; the chunked form on `mma`/`wgmma`
// tiles is later work.
//
// The step's update and product call fmaf() explicitly, which the
// build's global --fmad=false leaves fused: this kernel needs no
// bitwise match, and the plain version is held to a tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

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

}  // namespace

// Plain C interface for ctypes.  dtype: 0 float32, 1 bfloat16 (x, b, c
// and y; a, h0 and hT are float32).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, const void* h0, void* y,
                               void* hT, int batch, int t_len, int heads,
                               int p_dim, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(n, x, a, b, c, h0, y, hT, batch, t_len, heads,
                           p_dim, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(n, x, a, b, c, h0, y, hT, batch, t_len,
                                   heads, p_dim, s);
  return int(cudaErrorInvalidValue);
}
