// Multi-head attention forward with an online softmax (FlashAttention),
// causal or bidirectional, on Hopper (sm_90a).
//
// Replaces repro/kernels/flash/flash.py::flash_pallas (body
// _flash_kernel).
//
// What it computes, per (batch, head) and query row i of q [B, H, Sq, D]
// against k, v [B, KvH, Sk, D] (float32 or bfloat16; H a multiple of KvH,
// grouped-query attention: query head h reads KV head h / (H / KvH), the
// JAX package's _split_gqa order; KvH = H is multi-head attention):
//     s[j] = (q[i] . k[j]) * (1 / sqrt(D))                 in float32
//     s[j] = -1e30 where causal and j > i                  (the TPU
//            kernel's finite sentinel, with positions from 0 top-left)
//     out[i] = sum_j p[j] v[j] / max(sum_j p[j], 1e-30),  p = softmax(s)
// kept, as on the TPU, as a running max m, denominator l and float32
// accumulator over key tiles: per tile, m' = max(m, max s),
// l = l e^(m - m') + sum p, acc = acc e^(m - m') + p v with
// p = e^(s - m'), where p is rounded to v's type before the product (for
// bfloat16) and not before the sum.  Keys at or past Sk do not exist
// (the wrapper pads nothing): their p is 0.  For the backward
// (flash_bwd.cu), flash_launch also writes each row's log-sum-exp
// m + log l (natural units, float32) at finalize; serving passes none.
//
// Bound: for the shapes attention runs at (S in the thousands), the
// arithmetic: 4 D flops and one exp per (query, key) pair against
// 2 D (q, k, v, out) elements moved per row.  The card's rate for that
// arithmetic is its tensor cores: bf16 products at 4,096 flops a clock
// per SM, float32 ones as three TF32 passes at 2,048 (so 683 float32
// flops a clock against the FMA units' 256); at D = 64 the exps (16 per
// clock per SM on the MUFU) take as long as the bfloat16 products.  At
// BERT4Rec's [B, 2, 200, 32] the float32 call moves as many bytes as its
// three-pass products take.  Three kernels, chosen by type and head dim
// (flash_plan mirrors the choice):
//
// bfloat16: tc::flash_wgmma_kernel, on the tensor cores.
//   * one block of two warpgroups (256 threads) per (batch * head,
//     128-query tile), longest causal tiles first; each warpgroup owns
//     64 query rows.  The head dim is padded to DP = 64, 128 or 256
//     (zero columns add nothing to q . k; output columns past D are not
//     stored); keys come BK = 128 at a time at DP = 64, else 64;
//   * S = Q K^T is wgmma m64nBKk16 with Q and K in shared memory (the
//     first k-step overwrites S, so its old registers are not kept
//     alive); O += P V is wgmma m64nDPk16 with P as the register
//     operand, converted in place from S's float32 accumulator fragment
//     (the bf16 rounding of p the TPU kernel makes before AV is exactly
//     this conversion), and V read from shared memory through the
//     descriptor's transpose flag;
//   * Q, K and V tiles are stored in the 128-byte-swizzled layout the
//     descriptors name: rows of 64 bf16 (128 bytes), 16-byte chunk c of
//     row r at chunk c ^ (r % 8), in blocks of 64 columns;
//   * K and V sit in a ring of two stages; tile t + 1 is in flight while
//     tile t is in the products.  One thread fills a stage by TMA, 3-D
//     maps (Q's [B H, Sq, D], K's and V's [B KvH, Sk, D], a block's K/V
//     row given by kv_row) in boxes of 64 columns, so that rows past Sk and
//     columns past D read as zeros within a head, and every thread waits
//     on the stage's mbarrier.  TMA needs rows 16-byte aligned
//     (D % 8 == 0); for other D every thread stores the tiles element by
//     element into the same layout, with no overlap (a fallback only);
//   * the online softmax runs in registers: each thread holds two rows'
//     columns 8j + 2 (lane % 4) + {0, 1}; a row's max takes two quad
//     shuffles, its sum is kept per thread and folded once at the end;
//     the max is taken over raw scores and scaled, and
//     p = 2^(s * scale * log2 e - m) is one FFMA and one ex2.approx.ftz
//     (the sentinel scaled alike): this differs from the TPU kernel's
//     e^(s * scale - m) only by float32 rounding (and by flushing p below
//     2^-126, which is below every sum's last bit); masks are computed
//     only on tiles that cross the diagonal or Sk, from per-row limits
//     against constant columns, and a warpgroup skips causal tiles wholly
//     above its diagonal (there every p is exactly 0 and m does not
//     move, so the result is unchanged);
//   * registers are capped at 128 for DP = 64 so that two blocks share an
//     SM and hide each other's softmax and waits; wider ones run one
//     block per SM;
//   * shared memory: 2 DP (128 + 2 * 2 * BK) bytes, two mbarriers and
//     1 KB for alignment: 83,008 / 99,392 / 197,696 bytes at DP = 64 /
//     128 / 256.
//   Not done here (later work): a producer warp with setmaxnreg,
//   ping-pong between the warpgroups so one's softmax hides under the
//   other's products, S of the next tile on the tensor cores under the
//   softmax of this one (tried: without setmaxnreg its registers do not
//   fit, and ptxas serialises the wgmma), persistent blocks.
//
// float32 with D % 8 == 0 up to 128: tf32::flash_tf32_kernel, on the
// tensor cores in three TF32 passes (flash_tc.cuh): every float32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), rounded to
// nearest (cvt.rna's rounding), and a product is lo.hi + hi.lo + hi.hi
// summed in float32.  The one change from IEEE float32 products is the
// dropped lo.lo term, about 2^-22 of the product; the errors against
// the plain version stay at the FMA tiles' order (PERF.md).
//   * one block of two warpgroups (256 threads) per (batch * head,
//     128-query tile), longest causal tiles first, as the bf16 kernel; the
//     head dim is padded to DP = 32, 64 or 128 (the PV product's N), keys
//     come BK = 64 at a time at DP = 64, else 32 (at DP = 32 a 64-key tile
//     needs more than the 128 registers two blocks an SM leave; at 128,
//     more shared memory than there is);
//   * .tf32 wgmma reads both shared-memory operands K-major only, so V is
//     stored transposed ([DP][keys]) for O += P V, whose A is P from
//     registers: S's accumulator fragment serves as the tf32 A fragment
//     in place, with each group of 8 keys of the V^T tile stored in the
//     order 0, 2, 4, 6, 1, 3, 5, 7 (perm8; no shuffles);
//   * the threads load Q, K and V (16 bytes a lane where the rows are
//     aligned), split them and store hi and lo tiles in the 128-byte
//     swizzled layout (TMA cannot split or transpose); K and V of tile
//     t + 1 wait in registers while tile t is in the products (not at
//     DP = 128, where the registers are the accumulators');
//   * the softmax as the bf16 kernel's (ex2 on the MUFU, masks from per-row
//     limits), p split in registers; each tile's P V goes to its own
//     registers and is added to the output accumulator rounded to nearest
//     (the tensor cores' accumulation drifts over a long chain of k-steps:
//     flash_tc.cuh);
//   * registers capped at 128 at DP = 32 (two blocks an SM), one block an
//     SM wider; no spills, no wgmma serialisation (ptxas; chip_smoke.py
//     phase 1 fails on either);
//   * shared memory 8 DP (128 + 2 BK) + 1,024 bytes: 50,176 / 132,096 /
//     197,632 at DP = 32 / 64 / 128.
//   Not done here (later work): TMA into a staging ring, a producer warp,
//   S of the next tile under the softmax of this one.
//
// float32 otherwise: f32::flash_kernel, IEEE float32 products on the FMA
// units:
//   * one block of 256 threads per (batch * head, 64-query tile), with
//     the longest causal tiles launched first; the Q tile stays in shared
//     memory, and K and V stream through it 64 keys at a time;
//   * each thread holds a 4 x 4 block of the score tile and a
//     4 x ceil(D / 16) block of the accumulator in registers; tiles are
//     stored with an odd row stride so that the lanes of a warp read
//     distinct banks; a row's 16 threads form half a warp and reduce its
//     max and sum with shuffles;
//   * causal tiles wholly above the diagonal are skipped;
//   * D up to 256: the three tiles plus the P tile take up to 214,016
//     bytes of dynamic shared memory, so the launch opts in above 48 KB.
//   Shared-memory bandwidth, not the FMA units, caps this version: at
//   D = 32 it reaches 14% of the FMA bound, a third of the TF32 kernel's
//   speed (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"  // smem_addr, mbar_*, tma_load, make_desc, wgmma_*

namespace {

// The K/V row ([B * KvH] of them) that query row g = batch * H + head
// reads: batch * KvH + head / (H / KvH).  KvH = H gives g.
__device__ __forceinline__ long long kv_row(long long g, int h, int kvh) {
  return (g / h) * kvh + (g % h) / (h / kvh);
}

namespace f32 {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per streamed tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// p as the AV product sees it: rounded to v's type.
template <typename T>
__device__ __forceinline__ float as_v_type(float p) {
  return to_f32(from_f32<T>(p));
}

// Rows [row0, row0 + rows) of a [len, d] slab into a [rows][ld] float32
// tile; rows at or past len are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src,
                                          int row0, int rows, int len, int d,
                                          int ld) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    tile[r * ld + c] =
        row0 + r < len ? to_f32(src[(long long)(row0 + r) * d + c]) : 0.0f;
  }
}

// NJ = ceil(D / 16) rounded up to a power of two: accumulator columns
// per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int bh, int h, int kvh, int sq, int sk,
             int d, float scale, int causal, int n_qtiles) {
  extern __shared__ float smem[];
  const int ld = d + 1;                 // odd stride: no bank conflicts
  float* qs = smem;                     // [kBQ][ld]
  float* ks = qs + kBQ * ld;            // [kBK][ld]
  float* vs = ks + kBK * ld;            // [kBK][ld]
  float* ps = vs + kBK * ld;            // [kBQ][kBK + 1]
  constexpr int kLdp = kBK + 1;

  const int tx = threadIdx.x & 15;      // key / column lane
  const int ty = threadIdx.x >> 4;      // query lane
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);
  const long long g = blockIdx.x % bh;  // batch * head
  const long long gk = kv_row(g, h, kvh);
  const int q0 = qt * kBQ;
  const T* qg = q + g * sq * d;
  const T* kg = k + gk * sk * d;
  const T* vg = v + gk * sk * d;

  load_tile(qs, qg, q0, kBQ, sq, d, ld);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // Causal: keys past the tile's last query are masked for all its rows.
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(ks, kg, k0, kBK, sk, d, ld);
    load_tile(vs, vg, k0, kBK, sk, d, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= sk) {
          x = -INFINITY;  // no such key: p = 0
        } else if (causal && kpos > qpos) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kLdp + tx + 16 * j] = as_v_type<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // P is complete

    const int kn = min(kBK, k_end - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        // Past column d the row holds the next row's values: unused.
        const float vv = col < d ? vs[c * ld + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // The row's log-sum-exp, for the backward (none when serving).
    if (lse != nullptr && tx == 0) lse[g * sq + r] = m[i] + logf(den);
    T* orow = o + (g * sq + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) orow[col] = from_f32<T>(acc[i][j] / den);
    }
  }
}

// Dynamic shared memory of the kernel at head dim d: Q, K, V tiles with
// an odd row stride, and the P tile.
int smem_bytes(int d) {
  return ((kBQ + 2 * kBK) * (d + 1) + kBQ * (kBK + 1)) * 4;
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o,
              float* lse, int bh, int h, int kvh, int sq, int sk, int d,
              float scale, int causal, cudaStream_t stream) {
  const int smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return -1;
  flash_kernel<T, NJ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, bh, h, kvh, sq, sk,
      d, scale, causal, n_qtiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int h, int kvh, int sq, int sk, int d, float scale,
           int causal, cudaStream_t st) {
  const int groups = (d + 15) / 16;
  if (groups <= 1) {
    return launch_nj<T, 1>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                           causal, st);
  }
  if (groups <= 2) {
    return launch_nj<T, 2>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                           causal, st);
  }
  if (groups <= 4) {
    return launch_nj<T, 4>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                           causal, st);
  }
  if (groups <= 8) {
    return launch_nj<T, 8>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                           causal, st);
  }
  return launch_nj<T, 16>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                          causal, st);
}

}  // namespace f32

namespace tc {

constexpr int kBQ = 128;      // queries per block: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kStages = 2;    // K/V ring
constexpr float kNegInf2 = -1e30f * kLog2e;  // the sentinel, pre-scaled

// Dynamic shared memory of the DP-wide kernel with BK-key tiles: Q, then
// kStages (K, V) pairs, then one 8-byte mbarrier per stage (64 bytes
// kept), plus room to align the base to 1,024 bytes (one 128-byte
// swizzle atom of 8 rows).
constexpr int smem_bytes(int dp, int bk) {
  return 2 * dp * (kBQ + 2 * kStages * bk) + 64 + 1024;
}

// The padded head dim and the key tile for a head dim d in [1, 256].
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}
__host__ __device__ constexpr int key_tile(int dp) {
  return dp == 64 ? 128 : 64;
}
// Blocks per SM the registers are capped for (__launch_bounds__): at
// DP = 64 two blocks' warpgroups hide each other's softmax and waits in
// 128 registers; wider accumulators run one block (two blocks at DP =
// 128 measured slower on an H100).
__host__ __device__ constexpr int min_blocks(int dp) {
  return dp == 64 ? 2 : 1;
}

// tma: Q, K and V come by TMA through the three maps (rows 16-byte
// aligned: D % 8 == 0 and aligned bases); otherwise element by element,
// and the maps are unused.
template <int DP, int BK, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int bh, int h, int kvh, int sq, int sk, int d,
                   float scale_log2, int causal,
                   int n_qtiles,
                   int tma, const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v) {
  constexpr int kQBytes = kBQ * DP * 2;
  constexpr int kKVBytes = BK * DP * 2;  // one of K or V
  constexpr int kNS = BK / 2;            // score registers per thread
  constexpr int kNO = DP / 2;            // output registers per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_kv = base + kQBytes;  // stage st: K at s_kv + 2 st kKV
  const uint32_t s_bar = s_kv + kStages * 2 * kKVBytes;  // 8 B per stage

  const int wg = threadIdx.x >> 7;       // warpgroup: rows 64 wg ..
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // and r0 + 8, of the 64 rows
  const int cq = 2 * (lane & 3);           // column in each 8-column chunk

  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);  // longest first
  const long long g = blockIdx.x % bh;   // batch * head
  const long long gk = kv_row(g, h, kvh);  // its K/V row
  const int q0 = qt * kBQ;
  const int q0w = q0 + 64 * wg;          // this warpgroup's first query
  const __nv_bfloat16* qg = q + g * sq * d;
  const __nv_bfloat16* kg = k + gk * sk * d;
  const __nv_bfloat16* vg = v + gk * sk * d;
  // A masked score in raw (unscaled) units: -1e30 once scaled.
  const float neg_raw = kNegInf2 / scale_log2;

  // Causal: keys past the tile's last query are masked for all its rows.
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // Descriptors of this warpgroup's Q rows and of the first K and V
  // stage; a k-step or stage moves the start address (16-byte units).
  const uint64_t desc_q = make_desc(s_q + wg * (64 * 128), 16, 1024);
  const uint64_t desc_k = make_desc(s_kv, 16, 1024);
  const uint64_t desc_v = make_desc(s_kv + kKVBytes, BK * 128, 1024);

  // K(j) and V(j) go to stage j % kStages; a stage's offset in the
  // descriptors is in 16-byte units.
  auto stage_of = [](int j) {
    return (uint32_t)((j % kStages) * (2 * kKVBytes / 16));
  };
  // Copies K(j) and V(j) into their stage: by TMA, one thread issuing
  // DP / 64 boxes of each against the stage's barrier (plus Q's with
  // tile 0); or by every thread, element by element.
  auto load_kv = [&](int j) {
    const uint32_t dst = s_kv + (j % kStages) * 2 * kKVBytes;
    if (tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = s_bar + 8 * (j % kStages);
        mbar_expect(bar, 2 * kKVBytes + (j == 0 ? kQBytes : 0));
        if (j == 0) {
#pragma unroll
          for (int c = 0; c < DP / 64; ++c)
            tma_load(s_q + c * (kBQ * 128), &map_q, 64 * c, q0, (int)g, bar);
        }
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(dst + c * (BK * 128), &map_k, 64 * c, j * BK, (int)gk,
                   bar);
          tma_load(dst + kKVBytes + c * (BK * 128), &map_v, 64 * c, j * BK,
                   (int)gk, bar);
        }
      }
    } else {
      if (j == 0) load_tile<kBQ, DP, kThreads>(s_q, qg, q0, sq, d);
      load_tile<BK, DP, kThreads>(dst, kg, j * BK, sk, d);
      load_tile<BK, DP, kThreads>(dst + kKVBytes, vg, j * BK, sk, d);
    }
  };
  // Waits until K(j), V(j) (and Q with tile 0) are in shared memory and
  // visible to every thread's wgmma.
  auto wait_kv = [&](int j) {
    if (tma) {
      mbar_wait(s_bar + 8 * (j % kStages), (j / kStages) & 1);
    } else {
      fence_proxy_async();
      __syncthreads();
    }
  };

  if (tma && threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(s_bar + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_kv(0);  // Q and the first K/V tile

  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf2, kNegInf2};
  float l[2] = {0.0f, 0.0f};             // this thread's part of each row

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t + 1 is copied while tile t is in the products.
    if (t + 1 < n_tiles) load_kv(t + 1);
    wait_kv(t);
    const int k0 = t * BK;
    // A causal tile wholly above this warpgroup's diagonal is skipped:
    // every p there is exactly 0 and m does not move, so the result is
    // unchanged.
    if (!(causal && k0 > q0w + 63)) {
      // S = Q K^T in raw units over the padded width (zero columns add
      // nothing).
      float sc[kNS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // 32 bytes per k-step inside a 64-column block of rows.
        const uint32_t col = ((kk & 3) << 5) >> 4;
        wgmma_ss(sc, desc_q + (kk >> 2) * (kBQ * 128 / 16) + col,
                 desc_k + stage_of(t) + (kk >> 2) * (BK * 128 / 16) + col,
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Online softmax in the log2 domain.  Score i of this thread is
      // row r0 + 8 h, h = (i >> 1) & 1, and key k0 + cq + jc with
      // jc = 8 (i >> 2) + (i & 1), a constant: the masks compare it with
      // per-row limits.
      if (k0 + BK > sk || (causal && k0 + BK - 1 > q0w)) {
        const int key_lim = sk - k0 - cq;     // keys: jc < key_lim
        const int diag = q0w + r0 - k0 - cq;  // causal: jc <= diag + 8 h
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int jc = 8 * (i >> 2) + (i & 1);
          if (jc >= key_lim) {
            sc[i] = -INFINITY;  // no such key: p = 0
          } else if (causal && jc > diag + 8 * ((i >> 1) & 1)) {
            sc[i] = neg_raw;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float corr[2], neg_m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        neg_m[h] = -m_new;
        l[h] *= corr[h];
      }
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int i = 0; i < kNS; i += 2) {
        const int h = (i >> 1) & 1;
        // p = 2^(s scale log2 e - m): one FFMA and one MUFU op.
        const float p0 = ex2(fmaf(sc[i], scale_log2, neg_m[h]));
        const float p1 = ex2(fmaf(sc[i + 1], scale_log2, neg_m[h]));
        l[h] += p0 + p1;  // unrounded float32 p
        p[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < kNO; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P V, P from registers.
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 keys = two 8-row groups (2,048 bytes) per k-step.
        wgmma_rs(acc, p[kk], desc_v + stage_of(t) + kk * (16 * 128 / 16));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0w + r0 + 8 * h;
    if (r >= sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    // The row's log-sum-exp in natural units, for the backward (none when
    // serving): m is the log2-domain max.
    if (lse != nullptr && (lane & 3) == 0) {
      lse[g * sq + r] = (m[h] + log2f(den)) * 0.6931471805599453f;
    }
    __nv_bfloat16* orow = o + (g * sq + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      const float a = acc[4 * j + 2 * h] / den;
      const float b = acc[4 * j + 2 * h + 1] / den;
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(a, b);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(a);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(b);
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int h, int kvh, int sq, int sk, int d, float scale,
           int causal, cudaStream_t stream) {
  constexpr int kBK = key_tile(DP);
  constexpr int kSmem = smem_bytes(DP, kBK);
  constexpr int kMinBlocks = min_blocks(DP);
  static_assert(kSmem <= 232448, "fits one SM's shared memory");
  auto kernel = flash_wgmma_kernel<DP, kBK, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return -1;
  // TMA wherever every row starts 16 bytes aligned (its map's stride
  // must be a multiple of 16 bytes): d % 8 == 0 and aligned bases.
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int tma = d % 8 == 0 && aligned;
  // K and V hold B * KvH rows of [Sk, D].
  const int bkv = bh / h * kvh;
  CUtensorMap map_q = {}, map_k = {}, map_v = {};
  if (tma && !(make_map(&map_q, q, bh, sq, d, kBQ) &&
               make_map(&map_k, k, bkv, sk, d, kBK) &&
               make_map(&map_v, v, bkv, sk, d, kBK))) {
    return -2;
  }
  kernel<<<(unsigned)blocks, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, bh, h, kvh, sq, sk, d, scale * kLog2e, causal, n_qtiles, tma,
      map_q, map_k, map_v);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int h, int kvh, int sq, int sk, int d,
             float scale, int causal, cudaStream_t st) {
  switch (padded_dim(d)) {
    case 64:
      return launch<64>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                        causal, st);
    case 128:
      return launch<128>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                         causal, st);
    default:
      return launch<256>(q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale,
                         causal, st);
  }
}

}  // namespace tc

namespace tf32 {

constexpr int kBQ = 128;      // queries per block: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kMaxDim = 128;  // the widest head dim the route takes
constexpr float kNegInf2 = -1e30f * tc::kLog2e;  // the sentinel, pre-scaled

// The padded head dim (the PV product's N) of a head dim d (d % 8 == 0,
// d <= kMaxDim), the key tile (the S product's N) and the blocks an SM
// the registers are capped for.
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}
__host__ __device__ constexpr int key_tile(int dp) {
  return dp == 64 ? 64 : 32;
}
__host__ __device__ constexpr int min_blocks(int dp) {
  return dp == 32 ? 2 : 1;
}
// Dynamic shared memory: the hi and lo tiles of Q (kBQ rows), K (BK rows)
// and V^T (DP rows of BK keys), float32, and 1 KB to align the base to a
// 128-byte swizzle atom of 8 rows.
__host__ __device__ constexpr int smem_bytes(int dp, int bk) {
  return 2 * 4 * dp * (kBQ + 2 * bk) + 1024;
}

// vec: q, k, v and o start 16 bytes aligned (16-byte loads, 8-byte
// stores); otherwise element by element.
template <int DP, int BK, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int bh, int h, int kvh, int sq,
                  int sk, int d, float scale_log2, int causal, int n_qtiles,
                  int vec) {
  constexpr int kQTile = kBQ * DP * 4;  // bytes of Q's hi or lo tile
  constexpr int kKTile = BK * DP * 4;   // of K's or V^T's
  constexpr int kNS = BK / 2;           // score registers per thread
  constexpr int kNO = DP / 2;           // output registers per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (tc::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_qh = base, s_ql = s_qh + kQTile;
  const uint32_t s_kh = s_ql + kQTile, s_kl = s_kh + kKTile;
  const uint32_t s_vh = s_kl + kKTile, s_vl = s_vh + kKTile;

  const int wg = threadIdx.x >> 7;       // warpgroup: rows 64 wg ..
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // and r0 + 8, of the 64 rows
  const int cq = 2 * (lane & 3);           // column in each 8-column chunk

  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);  // longest first
  const long long g = blockIdx.x % bh;   // batch * head
  const long long gk = kv_row(g, h, kvh);  // its K/V row
  const int q0 = qt * kBQ;
  const int q0w = q0 + 64 * wg;          // this warpgroup's first query
  const float* kg = k + gk * sk * d;
  const float* vg = v + gk * sk * d;
  // A masked score in raw (unscaled) units: -1e30 once scaled.
  const float neg_raw = kNegInf2 / scale_log2;

  // Causal: keys past the tile's last query are masked for all its rows.
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // A of S: this warpgroup's Q rows; B of S: K; B of O: V^T (the hi
  // tiles; each lo tile follows its hi one).
  const uint64_t desc_q = tc::make_desc(s_qh + wg * (64 * 128), 16, 1024);
  const uint64_t desc_k = tc::make_desc(s_kh, 16, 1024);
  const uint64_t desc_v = tc::make_desc(s_vh, 16, 1024);

  {
    float4 x[kBQ * DP / 4 / kThreads];
    tc::fetch_f32<kBQ, DP, kThreads>(x, q + g * sq * d, q0, sq, d, vec);
    tc::put_f32<kBQ, DP, kThreads>(s_qh, s_ql, x);
  }
  // Tile t's K and V are read into registers, up to width 64 tile
  // t + 1's while tile t is in the products (kPrefetch); at 128 those
  // registers are not there (the accumulators take them).
  constexpr bool kPrefetch = DP <= 64;
  float4 kx[BK * DP / 4 / kThreads], vx[BK * DP / 4 / kThreads];
  auto fetch = [&](int t) {
    tc::fetch_f32<BK, DP, kThreads>(kx, kg, t * BK, sk, d, vec);
    tc::fetch_f32<BK, DP, kThreads>(vx, vg, t * BK, sk, d, vec);
  };
  if (kPrefetch) fetch(0);

  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf2, kNegInf2};
  float l[2] = {0.0f, 0.0f};             // this thread's part of each row

  for (int t = 0; t < n_tiles; ++t) {
    if (!kPrefetch) fetch(t);
    if (t > 0) __syncthreads();  // the previous tile's K and V are consumed
    tc::put_f32<BK, DP, kThreads>(s_kh, s_kl, kx);
    tc::put_f32_t<BK, DP, kThreads>(s_vh, s_vl, vx);
    tc::fence_proxy_async();
    __syncthreads();
    if (kPrefetch && t + 1 < n_tiles) fetch(t + 1);
    const int k0 = t * BK;
    // A causal tile wholly above this warpgroup's diagonal is skipped:
    // every p there is exactly 0 and m does not move.
    if (causal && k0 > q0w + 63) continue;

    // S = Q K^T in raw units over the padded width, in three passes.
    float sc[kNS];
    tc::wgmma_fence();
    tc::tf32x3_ss<DP / 8, kBQ, BK>(sc, desc_q, kQTile / 16, desc_k,
                                   kKTile / 16);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(sc);

    // Online softmax in the log2 domain, as tc::flash_wgmma_kernel.
    // Score i of this thread is row r0 + 8 ((i >> 1) & 1) and key
    // k0 + cq + 8 (i >> 2) + (i & 1).
    if (k0 + BK > sk || (causal && k0 + BK - 1 > q0w)) {
      const int key_lim = sk - k0 - cq;     // keys: jc < key_lim
      const int diag = q0w + r0 - k0 - cq;  // causal: jc <= diag + 8 h
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int jc = 8 * (i >> 2) + (i & 1);
        if (jc >= key_lim) {
          sc[i] = -INFINITY;  // no such key: p = 0
        } else if (causal && jc > diag + 8 * ((i >> 1) & 1)) {
          sc[i] = neg_raw;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float corr[2], neg_m[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * scale_log2);
      corr[hh] = tc::ex2(m[hh] - m_new);
      m[hh] = m_new;
      neg_m[hh] = -m_new;
      l[hh] *= corr[hh];
    }
    // p = 2^(s scale log2 e - m), in place, then split into the A
    // fragments of the PV product.
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      sc[i] = tc::ex2(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) tc::acc_to_a(sc + 4 * j, ph[j], pl[j]);

    // This tile's P V in three passes, into its own registers (the tensor
    // cores' accumulation drifts with the chain: see flash_tc.cuh), then
    // acc = acc e^(m - m') + P V rounded to nearest.  Every k-step is
    // issued, past the last key too (p = 0 there): a wgmma under a branch
    // is serialised.
    float pv[kNO];
    tc::fence_regs(ph);
    tc::fence_regs(pl);
    tc::wgmma_fence();
    tc::tf32x3_rs<BK / 8, DP>(pv, ph, pl, desc_v, kKTile / 16);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(pv);
#pragma unroll
    for (int i = 0; i < kNO; ++i) {
      acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], pv[i]);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0w + r0 + 8 * hh;
    if (r >= sq) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    // The row's log-sum-exp in natural units (m is the log2-domain max).
    if (lse != nullptr && (lane & 3) == 0) {
      lse[g * sq + r] = (m[hh] + log2f(den)) * 0.6931471805599453f;
    }
    float* orow = o + (g * sq + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;  // d % 8 == 0: col < d keeps col + 1
      if (col >= d) continue;
      const float a = acc[4 * j + 2 * hh] / den;
      const float b = acc[4 * j + 2 * hh + 1] / den;
      if (vec) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(a, b);
      } else {
        orow[col] = a;
        orow[col + 1] = b;
      }
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int bh, int h, int kvh, int sq, int sk, int d,
           float scale, int causal, cudaStream_t stream) {
  constexpr int kBK = key_tile(DP);
  constexpr int kSmem = smem_bytes(DP, kBK);
  static_assert(kSmem <= 232448, "fits one SM's shared memory");
  auto kernel = flash_tf32_kernel<DP, kBK, min_blocks(DP)>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return -1;
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  kernel<<<(unsigned)blocks, kThreads, kSmem, stream>>>(
      q, k, v, o, lse, bh, h, kvh, sq, sk, d, scale * tc::kLog2e, causal,
      n_qtiles, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int h, int kvh, int sq, int sk, int d,
             float scale, int causal, cudaStream_t st) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  switch (padded_dim(d)) {
    case 32:
      return launch<32>(qf, kf, vf, of, lse, bh, h, kvh, sq, sk, d, scale,
                        causal, st);
    case 64:
      return launch<64>(qf, kf, vf, of, lse, bh, h, kvh, sq, sk, d, scale,
                        causal, st);
    default:
      return launch<128>(qf, kf, vf, of, lse, bh, h, kvh, sq, sk, d, scale,
                         causal, st);
  }
}

}  // namespace tf32

// The float32 route: the three-pass TF32 kernel at d % 8 == 0 up to
// tf32::kMaxDim, the FMA tiles otherwise.
constexpr bool tf32_route(int d) {
  return d % 8 == 0 && d <= tf32::kMaxDim;
}

}  // namespace

// C entry points, bound with ctypes.  q, o [bh, sq, d] and k, v
// [bh / h * kvh, sk, d], contiguous, with bh = B * H and h = H a multiple
// of kvh = KvH; dtype 0 = float32 (the three-pass TF32 kernel at
// d % 8 == 0 up to 128, else the FMA kernel), 1 = bfloat16 (the
// tensor-core kernel).  lse, if not null, is [bh, sq] float32: each row's
// log-sum-exp of its scaled, masked scores (m + log l, in natural units),
// which the backward (flash_bwd.cu) recomputes p from.  Returns -1 for
// arguments the kernels do not take (d outside [1, 256], an empty side, H
// not a multiple of KvH or not dividing bh), -2 if the TMA map cannot be
// made, else cudaGetLastError().
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int h, int kvh,
                            int sq, int sk, int d, float scale, int causal,
                            int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 256) return -1;
  if (h <= 0 || kvh <= 0 || h % kvh != 0 || bh % h != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0 && tf32_route(d)) {
    return tf32::dispatch(q, k, v, o, lse_f, bh, h, kvh, sq, sk, d, scale,
                          causal != 0, st);
  }
  if (dtype == 0) {
    return f32::launch<float>(q, k, v, o, lse_f, bh, h, kvh, sq, sk, d,
                              scale, causal != 0, st);
  }
  if (dtype == 1) {
    return tc::dispatch(q, k, v, o, lse_f, bh, h, kvh, sq, sk, d, scale,
                        causal != 0, st);
  }
  return -1;
}

// Dynamic shared memory, in bytes, that flash_launch asks for at head
// dim d and dtype (as above); -1 for what it does not take.
extern "C" int flash_smem_bytes(int d, int dtype) {
  if (d <= 0 || d > 256) return -1;
  if (dtype == 0 && tf32_route(d)) {
    const int dp = tf32::padded_dim(d);
    return tf32::smem_bytes(dp, tf32::key_tile(dp));
  }
  if (dtype == 0) return f32::smem_bytes(d);
  if (dtype == 1) {
    const int dp = tc::padded_dim(d);
    return tc::smem_bytes(dp, tc::key_tile(dp));
  }
  return -1;
}
