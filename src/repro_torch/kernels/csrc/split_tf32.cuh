// Split-precision TF32 on Hopper's tensor cores (sm_90a): the pieces the
// float32 routes of flash_attention.cu and ssd_scan.cu share.
//
// A float32 v enters `wgmma ... .tf32` as two TF32 values, hi = tf32(v)
// and lo = tf32(v - hi) (round to nearest, ties away from zero: `cvt.rna`;
// v - hi is exact in float32), and a product a b as a_lo b_hi + a_hi b_lo
// + a_hi b_hi, three products into one float32 accumulator (the small ones
// first).  hi keeps the leading 11 significant bits of v and lo the next
// 11 (the bits after those are rounded into lo), so hi + lo is v within
// 2^-22 of |v| and the dropped a_lo b_lo is below 2^-22 of |a b|: about
// 21 bits a product, against one TF32 product's 11.  Both parts are exact
// TF32 values, so the tensor cores read them as they are, whatever they
// make of a raw float32 operand (`tf32_probe` in flash_attention.cu shows
// which: chip_smoke.py prints it).
//
// Shared-memory operands are K-major (`wgmma` takes no transpose bit for
// .tf32) and 128-byte swizzled: a row of 32 floats is one 128-byte line, 8
// rows make a 1024-byte atom, and a tile of `rows` rows is one column of
// atoms after another (`sw`).  A k8 step is 32 bytes of a line (`kstep`).
// A register A fragment of m64nNk8 holds, in each thread, rows g and g + 8
// (g = lane / 4, in its warp's 16 rows) at k = t and t + 4 (t = lane % 4),
// while an accumulator holds columns 2t and 2t + 1 of each group of 8
// columns.  So an accumulator becomes an A operand without a shuffle when
// the other operand's k order is permuted within each group of 8:
// position t holds column 2t and position t + 4 column 2t + 1 (`kperm`).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32 {

constexpr int kLine = 128;   // bytes of a swizzled row: 32 floats

__device__ __forceinline__ uint32_t rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// v as two exact TF32 values, hi + lo.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna(v);
  lo = rna(v - __uint_as_float(hi));
}

// v split into hi and lo and stored at the shared-space addresses `hi`
// and `lo` (32-bit addresses: no generic pointer arithmetic).
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo,
                                            float v) {
  uint32_t h, l;
  split(v, h, l);
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(hi), "r"(h) : "memory");
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(lo), "r"(l) : "memory");
}

// 4 bytes from global to shared memory without a register (`cp.async`,
// its own commit groups); zeros where `in` is false (nothing is read).
__device__ __forceinline__ void copy4(uint32_t dst, const float* src,
                                      bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// 16 bytes from global to shared memory (both 16-byte aligned) the same
// way.
__device__ __forceinline__ void copy16(uint32_t dst, const float* src,
                                       bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float load_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// An address the compiler cannot see through: what is derived from it is
// computed where it is used, not hoisted out of a loop into registers.
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
}

// The four raw float32 this thread copied to `hi` (16-byte aligned),
// split in place: hi there, lo at `lo`.
__device__ __forceinline__ void split4_in_place(uint32_t hi, uint32_t lo) {
  float v[4];
  uint32_t h[4], l[4];
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(hi)
               : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], h[i], l[i]);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(hi),
               "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
               : "memory");
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(lo),
               "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
               : "memory");
}

// Byte offset of element (row, col) in a swizzled float32 tile of `rows`
// rows (a multiple of 8).
__device__ __forceinline__ uint32_t sw(int row, int col, int rows) {
  return uint32_t((col >> 5) * rows * kLine + row * kLine +
                  ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4);
}

// Where column c of an operand whose k order is permuted sits.
__device__ __forceinline__ int kperm(int c) {
  return (c & ~7) | ((c & 1) << 2) | ((c & 7) >> 1);
}

// wgmma descriptor of a 128-byte-swizzled K-major operand (atoms 1024-byte
// aligned): start address, leading byte offset 16 (unused), stride byte
// offset 1024 (8 rows), layout type 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// `desc` made opaque where it is called, so that the compiler derives the
// k-steps' descriptors from it there (one add each) and does not hoist
// dozens of them out of a loop into registers.
__device__ __forceinline__ uint64_t desc_here(uint32_t addr) {
  uint64_t d = desc(addr);
  asm volatile("" : "+l"(d));
  return d;
}

// The descriptor of k8 step i of a K-major tile of `rows` rows whose
// descriptor is d: 32 bytes a step along a line, a column of atoms every
// 4 steps (the start address field cannot carry: shared memory is below
// 256 KB).
__device__ __forceinline__ uint64_t kstep(uint64_t d, int i, int rows) {
  return d + uint64_t(((i >> 2) * rows * kLine + 32 * (i & 3)) >> 4);
}

// The A fragment (hi, lo) of k8 step j from four accumulator values of
// group j: acc[0], acc[1] row g columns 2t, 2t + 1; acc[2], acc[3] row g + 8.
__device__ __forceinline__ void frag(float a0, float a1, float a2, float a3,
                                     uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(a0, hi[0], lo[0]);   // (g, t): column 2t
  split(a2, hi[1], lo[1]);   // (g + 8, t)
  split(a1, hi[2], lo[2]);   // (g, t + 4): column 2t + 1
  split(a3, hi[3], lo[3]);   // (g + 8, t + 4)
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Plain shared-memory stores made visible to wgmma (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TF_A8(i)                                                       \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define TF_R4 "{%0, %1, %2, %3}"
#define TF_R16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"
#define TF_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define TF_R64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define TF_SS(n, regs, a, b, p) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #p ", 0;\n"                       \
  "wgmma.mma_async.sync.aligned.m64n" #n "k8.f32.tf32.tf32 " regs         \
  ", %" #a ", %" #b ", p, 1, 1;\n}\n"

// d (64 x N, float32) (+)= A (64 x 8) B (8 x N), both TF32 in shared
// memory, K-major; `acc` 0 overwrites d.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int acc) {
  static_assert(N == 32 || N == 64, "N of a shared-memory A product");
  if constexpr (N == 32) {
    asm volatile(TF_SS(32, TF_R16, 16, 17, 18)
                 : TF_A8(0), TF_A8(8)
                 : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(TF_SS(64, TF_R32, 32, 33, 34)
                 : TF_A8(0), TF_A8(8), TF_A8(16), TF_A8(24)
                 : "l"(da), "l"(db), "r"(acc));
  }
}

// d (64 x N, float32) += A (64 x 8, TF32 in registers, `frag`'s layout)
// B (8 x N, TF32 in shared memory, K-major).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 8 || N == 32 || N == 64 || N == 128,
                "N of a register A product");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 " TF_R4
        ", {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TF_R16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : TF_A8(0), TF_A8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : TF_A8(0), TF_A8(8), TF_A8(16), TF_A8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TF_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : TF_A8(0), TF_A8(8), TF_A8(16), TF_A8(24), TF_A8(32), TF_A8(40),
          TF_A8(48), TF_A8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// The three products of a split pair: d (+)= a_lo b_hi + a_hi b_lo + a_hi
// b_hi, A and B in shared memory: the descriptors of each one's hi and lo
// at this k8 step.
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a,
                                        uint64_t a_lo, uint64_t b,
                                        uint64_t b_lo, int acc) {
  mma_ss<N>(d, a_lo, b, acc);
  mma_ss<N>(d, a, b_lo, 1);
  mma_ss<N>(d, a, b, 1);
}

// The same with A in registers.
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[4],
                                        const uint32_t (&a_lo)[4], uint64_t b,
                                        uint64_t b_lo) {
  mma_rs<N>(d, a_lo, b);
  mma_rs<N>(d, a, b_lo);
  mma_rs<N>(d, a, b);
}

#undef TF_A8
#undef TF_R4
#undef TF_R16
#undef TF_R32
#undef TF_R64
#undef TF_SS

}  // namespace tf32
