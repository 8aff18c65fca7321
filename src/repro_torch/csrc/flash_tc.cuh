// Device helpers of K4's tensor-core kernels, shared by csrc/flash.cu (the
// forward) and csrc/flash_bwd.cu (the backward): shared-memory addresses,
// mbarriers, TMA loads and maps, the wgmma forms (bf16, and tf32 for the
// three-pass float32 kernels below), ex2 and bf16 packing.
//
//   * wgmma_ss: S (+)= A B^T over one k-step of 16, A [64 x 16] and
//     B [N x 16] both K-major in shared memory, N = 64 or 128;
//   * wgmma_rs: D += A B over one k-step of 16, A [64 x 16] bf16 in
//     registers (the accumulator fragment of an m64nN product, converted
//     in place), B [16 x N] MN-major in shared memory through the
//     descriptor's transpose flag, N = 64, 128 or 256;
//   * tiles are stored in the 128-byte-swizzled layout the descriptors
//     name: rows of 64 bf16 (128 bytes), 16-byte chunk c of row r at chunk
//     c ^ (r % 8), in blocks of 64 columns of R rows each;
//   * accumulator register i of a thread (lane l of warp w of the
//     warpgroup) is row 16 w + l / 4 + 8 ((i >> 1) & 1), column
//     8 (i >> 2) + 2 (l % 4) + (i & 1).
//
// Everything here is inline or local to the including file (an unnamed
// namespace): each library keeps its own copy of what it uses.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory: a stage's tile has landed once its
// barrier's phase flips.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: one [64 columns, rows, 1] box of a [bh, S, D] tensor at (col, row,
// head) into shared memory, 128-byte swizzled as the map says; rows past
// S and columns past D are zero.  Completion counts on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(bar)
      : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (st.shared)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers in place around the asynchronous products: the compiler
// may neither move a write before the wgmma.fence nor a read before the
// wgmma.wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.  The swizzle
// atoms are 1,024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The accumulator registers of a wgmma, as inline-asm operands: c is
// "+f" (accumulate) or "=f" (overwrite).
#define WG_ACC8(c, i)                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),          \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define WG_ACC32(c, i) \
  WG_ACC8(c, i), WG_ACC8(c, i + 8), WG_ACC8(c, i + 16), WG_ACC8(c, i + 24)
#define WG_ACC64(c) WG_ACC32(c, 0), WG_ACC32(c, 32)
#define WG_ACC128(c) WG_ACC64(c), WG_ACC32(c, 64), WG_ACC32(c, 96)
#define WG_D32                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define WG_D64                                                           \
  WG_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"
#define WG_D128                                                          \
  WG_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "   \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "     \
  "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "     \
  "%125, %126, %127"

// S (+)= A B^T over one k-step of 16: A [64 x 16] and B [N x 16], both
// K-major in shared memory; N = 64 or 128 keys.  The first k-step
// overwrites S (its registers are outputs only, so their old values are
// not kept alive), the others accumulate.
#define WG_SS_ASM(NN, DLIST, ACC, C, IA, IB, IP, SCALE_D)                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" NN                     \
               "k16.f32.bf16.bf16 {" DLIST "}, %" IA ", %" IB             \
               ", p, 1, 1, 0, 0;\n}\n"                                     \
               : ACC(C)                                                   \
               : "l"(da), "l"(db), "r"(SCALE_D))
#define WG_SS(NN, R, DLIST, ACC, IA, IB, IP)                               \
  __device__ __forceinline__ void wgmma_ss(float(&d)[R], uint64_t da,     \
                                           uint64_t db, bool accumulate) { \
    if (accumulate) {                                                     \
      WG_SS_ASM(NN, DLIST, ACC, "+f", IA, IB, IP, 1);                     \
    } else {                                                              \
      WG_SS_ASM(NN, DLIST, ACC, "=f", IA, IB, IP, 0);                     \
    }                                                                     \
  }
#define WG_ACC32_0(c) WG_ACC32(c, 0)
WG_SS("64", 32, WG_D32, WG_ACC32_0, "32", "33", "34")
WG_SS("128", 64, WG_D64, WG_ACC64, "64", "65", "66")

// D += A B over one k-step of 16: A [64 x 16] bf16 in registers, B
// [16 x N] MN-major in shared memory (the transpose flag); N = 64, 128
// or 256 columns.
#define WG_RS(NN, R, DLIST, ACC, IA, IB, IP)                               \
  __device__ __forceinline__ void wgmma_rs(                               \
      float(&d)[R], const uint32_t(&a)[4], uint64_t db) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" NN                   \
                 "k16.f32.bf16.bf16 {" DLIST "}, {" IA "}, %" IB          \
                 ", p, 1, 1, 1;\n}\n"                                      \
                 : ACC("+f")                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                   "r"(1));                                               \
  }
WG_RS("64", 32, WG_D32, WG_ACC32_0, "%32, %33, %34, %35", "36", "37")
WG_RS("128", 64, WG_D64, WG_ACC64, "%64, %65, %66, %67", "68", "69")
WG_RS("256", 128, WG_D128, WG_ACC128, "%128, %129, %130, %131", "132", "133")

// -- float32 on the tensor cores: three-pass TF32 ------------------------
//
// A float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away: cvt.rna), and a product is accumulated in
// float32 as lo.hi + hi.lo + hi.hi; the dropped lo.lo term is about 2^-22
// of the product (CUTLASS's 3xTF32).  The .tf32 forms take k-steps of 8
// (32 bytes, as a bf16 k-step of 16) and both shared-memory operands
// K-major only (no transpose flag for 32-bit types), so a product whose B
// is MN-major in its natural layout reads a transposed copy.  Tiles are
// float32 in the same 128-byte-swizzled layout as the bf16 ones: rows of
// 32 floats (128 bytes), 16-byte chunk c of row r at chunk c ^ (r % 8), in
// blocks of 32 columns of R rows each; make_desc serves unchanged.
//
// The A fragment of a k-step from registers (m64 x k8, one warp's 16
// rows): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
// with g = lane / 4, t = lane % 4.  An m64nN float32 accumulator holds
// columns 8 j + 2 t and 8 j + 2 t + 1 of rows g, g + 8 in registers
// 4 j .. 4 j + 3, so its registers serve as the A fragment of k-step j in
// the order (0, 2, 1, 3) with A's column t standing for the accumulator's
// column 2 t of the group of 8 and t + 4 for 2 t + 1: the B tile's rows
// are stored in that order (perm8), and the sum over the k dimension is
// unchanged.  No shuffles.

#define WG_ACC16(c, i) WG_ACC8(c, i), WG_ACC8(c, i + 8)
#define WG_ACC16_0(c) WG_ACC16(c, 0)
#define WG_D16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"

// D (+)= A B^T over one k-step of 8: A [64 x 8] and B [N x 8] tf32, both
// K-major in shared memory; N = 32 or 64.  The first k-step overwrites D.
//
// The tensor cores' float32 accumulation is not an IEEE sum rounded to
// nearest: measured on an H100 (PERF.md, PR 33), a chain of n k-steps
// into one accumulator drifts by about n float32 ulps of it, as rounding
// toward zero would.  So every product in the three-pass kernels is one
// tile's, started afresh (its first k-step overwrites D), and the kernel
// adds it to its running sum in float32, rounded to nearest: the drift
// stays that of one tile's 3 D / 8 or 3 BK / 8 k-steps, whatever the
// sequence length.
#define WG_TF32_SS_ASM(NN, DLIST, ACC, C, IA, IB, IP, SCALE_D)            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" NN                     \
               "k8.f32.tf32.tf32 {" DLIST "}, %" IA ", %" IB              \
               ", p, 1, 1;\n}\n"                                           \
               : ACC(C)                                                   \
               : "l"(da), "l"(db), "r"(SCALE_D))
#define WG_TF32_SS(NN, R, DLIST, ACC, IA, IB, IP)                          \
  __device__ __forceinline__ void wgmma_tf32_ss(                          \
      float(&d)[R], uint64_t da, uint64_t db, bool accumulate) {          \
    if (accumulate) {                                                     \
      WG_TF32_SS_ASM(NN, DLIST, ACC, "+f", IA, IB, IP, 1);                \
    } else {                                                              \
      WG_TF32_SS_ASM(NN, DLIST, ACC, "=f", IA, IB, IP, 0);                \
    }                                                                     \
  }
WG_TF32_SS("32", 16, WG_D16, WG_ACC16_0, "16", "17", "18")
WG_TF32_SS("64", 32, WG_D32, WG_ACC32_0, "32", "33", "34")

// D (+)= A B over one k-step of 8: A [64 x 8] tf32 in registers (the
// fragment above), B [N x 8] tf32 K-major in shared memory; N = 32, 64 or
// 128.  Without accumulate D is overwritten (a product's first k-step).
#define WG_TF32_RS_ASM(NN, DLIST, ACC, C, IA, IB, IP, SCALE_D)            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" NN                     \
               "k8.f32.tf32.tf32 {" DLIST "}, {" IA "}, %" IB             \
               ", p, 1, 1;\n}\n"                                           \
               : ACC(C)                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(SCALE_D))
#define WG_TF32_RS(NN, R, DLIST, ACC, IA, IB, IP)                          \
  __device__ __forceinline__ void wgmma_tf32_rs(                          \
      float(&d)[R], const uint32_t(&a)[4], uint64_t db, bool accumulate) { \
    if (accumulate) {                                                     \
      WG_TF32_RS_ASM(NN, DLIST, ACC, "+f", IA, IB, IP, 1);                \
    } else {                                                              \
      WG_TF32_RS_ASM(NN, DLIST, ACC, "=f", IA, IB, IP, 0);                \
    }                                                                     \
  }
WG_TF32_RS("32", 16, WG_D16, WG_ACC16_0, "%16, %17, %18, %19", "20", "21")
WG_TF32_RS("64", 32, WG_D32, WG_ACC32_0, "%32, %33, %34, %35", "36", "37")
WG_TF32_RS("128", 64, WG_D64, WG_ACC64, "%64, %65, %66, %67", "68", "69")

// x rounded to tf32 (10 mantissa bits, to nearest, ties away), as the
// .b32 the tensor cores read; its 13 low bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;
}
// x = hi + lo.  hi is x rounded as to_tf32 rounds it, by integer
// arithmetic on its bits (the same value for every finite x, without the
// conversion's cost, which is what a split of every p pays most for);
// lo = to_tf32(x - hi), exact in float32 before its rounding, keeps a NaN
// of x (whatever hi became).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

// The A fragment of k-step j, hi and lo, from an accumulator's registers
// 4 j .. 4 j + 3 (x[0..3]), in the order (0, 2, 1, 3).
__device__ __forceinline__ void acc_to_a(const float* x, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[2], hi[1], lo[1]);
  split_tf32(x[1], hi[2], lo[2]);
  split_tf32(x[3], hi[3], lo[3]);
}

// Where row j of a group of 8 goes in a B tile read by such an A: the
// accumulator's column 2 t is A's column t, 2 t + 1 is t + 4.
__device__ __forceinline__ int perm8(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j >> 1) & 3);
}

// Byte offset of element (r, c) of a K-major float32 tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t f32_offset(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
         ((c & 3) << 2);
}

// The descriptor offset (16-byte units) of k-step kk in a K-major tile of
// R rows: 32 bytes a k-step inside a 128-byte row, R * 128 bytes a block
// of 32 columns.
template <int R>
__device__ __forceinline__ uint32_t kstep(int kk) {
  return (kk >> 2) * (R * 128 / 16) + (kk & 3) * 2;
}

// D = A B^T over KSTEPS k-steps in three passes, lo.hi, hi.lo, then
// hi.hi (the first k-step overwrites D): a and b are the descriptors of
// A's hi tile (RA rows) and B's (RB rows); their lo tiles lie lo_a and
// lo_b (16-byte units) past them.
template <int KSTEPS, int RA, int RB, int N>
__device__ __forceinline__ void tf32x3_ss(float (&d)[N], uint64_t a,
                                          uint32_t lo_a, uint64_t b,
                                          uint32_t lo_b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_tf32_ss(d, a + lo_a + kstep<RA>(kk), b + kstep<RB>(kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_tf32_ss(d, a + kstep<RA>(kk), b + lo_b + kstep<RB>(kk), true);
  }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_tf32_ss(d, a + kstep<RA>(kk), b + kstep<RB>(kk), true);
  }
}

// D = A B over KSTEPS k-steps in the same three passes, A's hi and lo
// fragments in registers (acc_to_a), B's hi tile (RB rows) at b and its
// lo tile lo_b past it.
template <int KSTEPS, int RB, int N>
__device__ __forceinline__ void tf32x3_rs(float (&d)[N],
                                          const uint32_t (&hi)[KSTEPS][4],
                                          const uint32_t (&lo)[KSTEPS][4],
                                          uint64_t b, uint32_t lo_b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_tf32_rs(d, lo[kk], b + kstep<RB>(kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_tf32_rs(d, hi[kk], b + lo_b + kstep<RB>(kk), true);
  }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_tf32_rs(d, hi[kk], b + kstep<RB>(kk), true);
  }
}

// Rows [row0, row0 + R) of a [len, d] float32 slab, DP columns, into
// registers: chunk c = threadIdx.x + i THREADS of the tile is row c % R,
// columns 4 (c / R) .. + 3 (a warp's lanes take 32 rows of one column
// chunk, so the stores below are free of bank conflicts).  Rows at or past
// len and columns at or past d (d % 4 == 0) are zero.  vec: 16-byte loads
// (the slab starts 16 bytes aligned).
template <int R, int DP, int THREADS>
__device__ __forceinline__ void fetch_f32(float4 (&x)[R * DP / 4 / THREADS],
                                          const float* __restrict__ src,
                                          int row0, int len, int d,
                                          bool vec) {
  static_assert(R * DP % (4 * THREADS) == 0 && R % 32 == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < R * DP / 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int row = row0 + c % R;
    const int col = 4 * (c / R);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < len && col < d) {
      const float* p = src + (long long)row * d + col;
      if (vec) {
        v = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      }
    }
    x[i] = v;
  }
}

// fetch_f32's registers split into the hi and lo K-major [R][DP] tiles at
// shared addresses hi and lo.
template <int R, int DP, int THREADS>
__device__ __forceinline__ void put_f32(uint32_t hi, uint32_t lo,
                                        const float4 (&x)[R * DP / 4 /
                                                          THREADS]) {
#pragma unroll
  for (int i = 0; i < R * DP / 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const uint32_t off = f32_offset<R>(c % R, 4 * (c / R));
    uint32_t h[4], l[4];
    split_tf32(x[i].x, h[0], l[0]);
    split_tf32(x[i].y, h[1], l[1]);
    split_tf32(x[i].z, h[2], l[2]);
    split_tf32(x[i].w, h[3], l[3]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + off),
                 "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + off),
                 "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                 : "memory");
  }
}

// The same registers split into transposed K-major [DP][R] tiles: element
// (r, c) at row c, column perm8(r), the B operand of a product whose A is
// an accumulator fragment (acc_to_a).
template <int R, int DP, int THREADS>
__device__ __forceinline__ void put_f32_t(uint32_t hi, uint32_t lo,
                                          const float4 (&x)[R * DP / 4 /
                                                            THREADS]) {
#pragma unroll
  for (int i = 0; i < R * DP / 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int p = perm8(c % R);
    const int col = 4 * (c / R);
    const float v[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = f32_offset<DP>(col + e, p);
      uint32_t h, l;
      split_tf32(v[e], h, l);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi + off), "r"(h)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo + off), "r"(l)
                   : "memory");
    }
  }
}

// 2^x on the MUFU, denormal results flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [row0, row0 + R) of a [len, d] bf16 slab into a swizzled [R, DP]
// tile at shared address dst, element by element by THREADS threads, as TMA would lay it
// out: 16-byte chunk c (columns 8c .. 8c + 7) of row r goes to
// (c / 8) * R * 128 + r * 128 + ((c % 8) ^ (r % 8)) * 16.  Rows at or
// past len and columns at or past d are zero.
template <int R, int DP, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int len, int d) {
  constexpr int kRowChunks = DP / 8;
  constexpr int kChunks = R * kRowChunks;
  static_assert(kChunks % THREADS == 0, "whole passes over the tile");
#pragma unroll
  for (int i = 0; i < kChunks / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / kRowChunks;
    const int c8 = c % kRowChunks;
    const uint32_t to = dst + (c8 >> 3) * (R * 128) + r * 128 +
                        (((c8 & 7) ^ (r & 7)) << 4);
    const int row = row0 + r;
    const int col = c8 * 8;
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t lo = 0, hi = 0;
      if (row < len) {
        const long long at = (long long)row * d + col + 2 * e;
        if (col + 2 * e < d) lo = s16[at];
        if (col + 2 * e + 1 < d) hi = s16[at + 1];
      }
      w[e] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(to),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The TMA map of a [bh, len, d] bf16 tensor read in boxes of 64 columns
// by `rows` rows of one head, 128-byte swizzled; out-of-range elements
// read as zero.  Returns false if the encoding is refused.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int len, int d,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)len,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)len};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
}  // namespace
