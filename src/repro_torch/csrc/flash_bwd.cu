// Backward of K4 (csrc/flash.cu): dQ, dK and dV of causal or
// bidirectional attention, multi-head or grouped-query, on Hopper
// (sm_90a).
//
// The JAX package has no backward kernel (autodiff of its stock-op
// attention computes the gradient); this is the same gradient, written by
// hand for the port's training path.  Per (batch, head) with
// p = exp(s * scale - lse) recomputed from q, k and the forward's saved
// row log-sum-exp lse ([B H, Sq] float32, flash_launch):
//     delta[i] = sum_c dO[i, c] O[i, c]
//     dP[i, j] = dO[i] . v[j]
//     dS[i, j] = p[i, j] (dP[i, j] - delta[i])
//     dV[j]   += sum_i round_v(p[i, j]) dO[i]      (p rounded to v's
//                type, as the forward rounds it before its AV product)
//     dK[j]   += scale * sum_i dS[i, j] q[i]
//     dQ[i]    = scale * sum_j dS[i, j] k[j]
// with the forward's numbers: scale = 1 / sqrt(D), masked pairs (causal
// j > i, keys at or past Sk) have p = exp(-1e30 - lse) = 0 exactly.  Query
// head h reads KV head h / (H / KvH); dK and dV of a KV head sum its
// H / KvH query heads in a fixed order.  Inputs float32 or bfloat16,
// every sum in float32, outputs in the input type.  No atomics: each
// kernel writes its own rows, so two calls give the same bits.
//
// Bound: 10 D flops (five products of 2 D) and one exp per kept pair
// against 4 (B H + B KvH) S D elements moved: the arithmetic, on the
// tensor cores (bfloat16, and float32 as three TF32 passes).  Three
// kernels, queued by one call:
//   1. flash_bwd_delta: delta, one warp a row (every route);
//   2. dK / dV, one block a (key tile, batch * KvH): K and V stay while
//      the block walks the group's query heads and, causal, the query
//      tiles from the key tile's diagonal on;
//   3. dQ, one block a (query tile, batch * H), longest causal tiles
//      first: Q and dO stay, K and V stream through.
// Kernels 2 and 3 each recompute S and dP (14 D flops a pair in all, two
// exps), which keeps dQ free of atomics.  The route is static, by type
// and head dim (route_of; flash_bwd_plan mirrors it):
//
// bfloat16 with D % 8 == 0 and D <= 128: flash_bwd_dkdv_wgmma and
// flash_bwd_dq_wgmma, on the tensor cores with the forward's forms
// (flash_tc.cuh).  The head dim is padded to DP = 64 or 128 as the
// forward pads it (zero columns add nothing; columns past D are not
// stored).
//   * two warpgroups a block, 64 of the block's 128 rows (keys for dK /
//     dV, queries for dQ) each; the streamed tiles are 64 rows (queries
//     of the group's heads for dK / dV, keys for dQ) in a ring of three
//     stages (3% faster than two at llama3.2-1b's shape on an H100) that
//     one thread fills by TMA from 3-D maps ([B H, Sq, D],
//     [B KvH, Sk, D]: rows past S and columns past D read as zero), the
//     resident tiles arrive with the first stage;
//   * dK / dV: S^T = K Q^T and dP^T = V dO^T by wgmma_ss into registers;
//     P^T = 2^(S^T scale log2 e - lse log2 e) on the MUFU (the row
//     statistics of a stage, lse in log2 units and delta, are staged in
//     shared memory beside it); dS^T = P^T (dP^T - delta); both become
//     bf16 A fragments in place, and dV += P^T dO, dK += dS^T Q by
//     wgmma_rs with dO and Q read MN-major from the same stage;
//   * dQ: S = Q K^T and dP = dO V^T by wgmma_ss, dS in registers,
//     dQ += dS K by wgmma_rs with K read MN-major;
//   * masks only on tiles that cross the diagonal or Sk (dQ); a
//     warpgroup skips causal tiles wholly above its diagonal; in dK / dV
//     queries past Sq are zero rows of Q and dO with lse = delta = 0, so
//     they add nothing, and keys past Sk are rows that are not stored;
//   * the one rounding the FMA route does not make: dS to bf16 before
//     the dK and dQ products (the tensor cores take bf16 operands); P is
//     rounded to bf16 before dV as on both routes;
//   * registers: dK and dV take DP float32 a thread, S^T and dP^T 32 each;
//     at DP = 256 dK and dV alone would need 256, above the 255 a thread
//     may hold, so DP = 256 stays on the FMA route.
//   Not done here (later work): a producer warp with setmaxnreg, S of the
//   next tile under the exps of this one, dQ by atomics in the dK / dV
//   pass (one pass, not deterministic), persistent blocks.  Measured no
//   faster on an H100 (tools/flash_variants.py --backward): the exps
//   under the dP product in two wgmma groups, dK / dV blocks ordered by
//   KV head, three warpgroups a block, two dK / dV blocks an SM.
//
// float32 with D % 8 == 0 and D <= 64: flash_bwd_dkdv_tf32 and
// flash_bwd_dq_tf32, on the tensor cores in three TF32 passes with the
// forward's split (flash_tc.cuh: hi = tf32(x), lo = tf32(x - hi),
// lo.hi + hi.lo + hi.hi in float32; only the lo.lo term, about 2^-22 of
// a product, is dropped).  The head dim is padded to DP = 32 or 64.
//   * the bf16 route's two-kernel shape: 128 own rows a block (two
//     warpgroups), streamed tiles of 32 rows, one stage in shared memory;
//     the threads load, split and store every tile (TMA cannot split or
//     transpose), at DP = 64 (one block an SM) tile t + 1 waiting in
//     registers while tile t is in the products, at DP = 32 (two blocks
//     an SM, registers capped at 128) the other block hiding the loads;
//   * .tf32 wgmma reads shared memory K-major only: S^T = K Q^T,
//     dP^T = V dO^T (dK / dV) and S = Q K^T, dP = dO V^T (dQ) read the
//     natural tiles; dV += P^T dO, dK += dS^T Q and dQ += dS K read
//     transposed copies (dO^T, Q^T, K^T, [DP][rows]) with each group of 8
//     rows in perm8's order, so that P^T, dS^T and dS serve as A
//     fragments in place from the accumulators;
//   * dV's products complete before dS^T is split (two sets of fragments
//     live at once would spill at two blocks an SM); each tile's dV, dK or
//     dQ goes to its own registers and is added to the running sum
//     rounded to nearest (the tensor cores' accumulation drifts over a
//     long chain of k-steps: flash_tc.cuh);
//   * shared memory, the hi and lo tiles: dK / dV 99,584 / 197,888 bytes
//     at DP = 32 / 64 (K, V, and Q, dO, Q^T, dO^T of a tile with its lse
//     and delta), dQ 91,136 / 181,248 (Q, dO, and K, V, K^T); at D = 128
//     the resident tiles alone would take 256 KB, so D = 128 stays on the
//     FMA tiles.
//
// float32 otherwise, and bfloat16 with D % 8 != 0 (TMA needs 16-byte
// rows) or D > 128: flash_bwd_dkdv and flash_bwd_dq on the FMA units,
// IEEE float32 products.  256 threads a block; each
// holds R keys (or queries) x NJ columns of dK and dV (or dQ) in
// registers.  Tiles are BT = 16 R rows square (R = 4 up to D = 128, else
// 2), stored as float32 with an odd row stride (D + 1) so that a warp's
// lanes read distinct banks, as f32::flash_kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"  // smem_addr, mbar_*, tma_load, make_desc, wgmma_*

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;  // the forward's mask sentinel

// The K/V row ([B * KvH] of them) that query row g = batch * H + head
// reads: batch * KvH + head / (H / KvH).
__device__ __forceinline__ long long kv_row(long long g, int h, int kvh) {
  return (g / h) * kvh + (g % h) / (h / kvh);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p as the forward's AV product saw it: rounded to v's type.
template <typename T>
__device__ __forceinline__ float as_v_type(float p) {
  return to_f32(from_f32<T>(p));
}

// Rows [row0, row0 + rows) of a [len, d] slab into a [rows][ld] float32
// tile; rows at or past len are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile,
                                          const T* __restrict__ src,
                                          int row0, int rows, int len, int d,
                                          int ld) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    tile[r * ld + c] =
        row0 + r < len ? to_f32(src[(long long)(row0 + r) * d + c]) : 0.0f;
  }
}

// delta[row] = dO[row] . O[row] over `rows` rows of width d.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) {
    s = fmaf(to_f32(orow[c]), to_f32(drow[c]), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) delta[row] = s;
}

// s (+)= A[ra] . B[rb] for R x R pairs of tile rows: A rows ty + 16 a,
// B rows tx + 16 b, both [BT][ld] float32 tiles in shared memory.
template <int R>
__device__ __forceinline__ void tile_dots(float (&s)[R][R],
                                          float (&t)[R][R], const float* a1,
                                          const float* b1, const float* a2,
                                          const float* b2, int d, int ld,
                                          int tx, int ty) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[i][j] = 0.0f;
      t[i][j] = 0.0f;
    }
  for (int c = 0; c < d; ++c) {
    float x1[R], y1[R], x2[R], y2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      x1[i] = a1[(ty + 16 * i) * ld + c];
      x2[i] = a2[(ty + 16 * i) * ld + c];
      y1[i] = b1[(tx + 16 * i) * ld + c];
      y2[i] = b2[(tx + 16 * i) * ld + c];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(x1[i], y1[j], s[i][j]);
        t[i][j] = fmaf(x2[i], y2[j], t[i][j]);
      }
  }
}

// Dynamic shared memory of the two tile kernels at head dim d and tile
// BT: four [BT][d + 1] tiles, the [BT][BT + 1] products (P and dS for
// dK / dV, dS for dQ) and 2 BT row statistics (lse, delta), float32.
__host__ __device__ constexpr int dkdv_smem_bytes(int d, int bt) {
  return (4 * bt * (d + 1) + 2 * bt * (bt + 1) + 2 * bt) * 4;
}
__host__ __device__ constexpr int dq_smem_bytes(int d, int bt) {
  return (4 * bt * (d + 1) + bt * (bt + 1) + 2 * bt) * 4;
}
// Rows a thread holds: R = 4 (64-row tiles) up to D = 128, else 2.
__host__ __device__ constexpr int rows_per_thread(int d) {
  return d <= 128 ? 4 : 2;
}

// dK and dV of one key tile of one KV head (see the header).
template <typename T, int R, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int bkv, int h, int kvh, int sq, int sk,
               int d, float scale, int causal) {
  constexpr int BT = 16 * R;
  constexpr int kLdp = BT + 1;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;                 // [BT][ld]
  float* vs = ks + BT * ld;
  float* qs = vs + BT * ld;
  float* dos = qs + BT * ld;
  float* ps = dos + BT * ld;        // [BT keys][kLdp]: p rounded to T
  float* dss = ps + BT * kLdp;      // [BT keys][kLdp]: dS
  float* st = dss + BT * kLdp;      // lse [BT], delta [BT]

  const int tx = threadIdx.x & 15;  // query lane
  const int ty = threadIdx.x >> 4;  // key lane
  const int kt = (int)(blockIdx.x / bkv);  // the first tiles walk longest
  const long long gk = blockIdx.x % bkv;   // batch * KvH + KV head
  const int k0 = kt * BT;
  const int rep = h / kvh;
  const long long g0 = (gk / kvh) * h + (gk % kvh) * rep;  // first q head

  load_tile(ks, k + gk * sk * d, k0, BT, sk, d, ld);
  load_tile(vs, v + gk * sk * d, k0, BT, sk, d, ld);

  float acc_k[R][NJ], acc_v[R][NJ];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc_k[a][j] = 0.0f;
      acc_v[a][j] = 0.0f;
    }

  const int n_qtiles = (sq + BT - 1) / BT;
  // Causal: query tiles wholly before the key tile see none of its keys.
  const int qt0 = causal ? k0 / BT : 0;
  for (int r = 0; r < rep; ++r) {
    const long long g = g0 + r;
    const T* qg = q + g * sq * d;
    const T* dog = dout + g * sq * d;
    for (int qt = qt0; qt < n_qtiles; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tiles are consumed
      load_tile(qs, qg, q0, BT, sq, d, ld);
      load_tile(dos, dog, q0, BT, sq, d, ld);
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        const bool in = q0 + i < sq;
        st[i] = in ? lse[g * sq + q0 + i] : 0.0f;
        st[BT + i] = in ? delta[g * sq + q0 + i] : 0.0f;
      }
      __syncthreads();

      // S and dP, transposed: [key ty + 16 a][query tx + 16 b].
      float s[R][R], dp[R][R];
      tile_dots<R>(s, dp, ks, qs, vs, dos, d, ld, tx, ty);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int key = k0 + ty + 16 * a;
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const int qc = tx + 16 * b;
          const int qpos = q0 + qc;
          float x = s[a][b] * scale;
          if (causal && key > qpos) x = kNegInf;
          float p = expf(x - st[qc]);
          if (key >= sk || qpos >= sq) p = 0.0f;  // no such key or query
          ps[(ty + 16 * a) * kLdp + qc] = as_v_type<T>(p);
          dss[(ty + 16 * a) * kLdp + qc] = p * (dp[a][b] - st[BT + qc]);
        }
      }
      __syncthreads();  // P and dS are complete

      const int qn = min(BT, sq - q0);
      for (int i = 0; i < qn; ++i) {
        float pv[R], dsv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pv[a] = ps[(ty + 16 * a) * kLdp + i];
          dsv[a] = dss[(ty + 16 * a) * kLdp + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          // Past column d the row holds the next row's values: unused.
          const float dov = col < d ? dos[i * ld + col] : 0.0f;
          const float qv = col < d ? qs[i * ld + col] : 0.0f;
#pragma unroll
          for (int a = 0; a < R; ++a) {
            acc_v[a][j] = fmaf(pv[a], dov, acc_v[a][j]);
            acc_k[a][j] = fmaf(dsv[a], qv, acc_k[a][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= sk) continue;
    T* krow = dk + (gk * sk + key) * d;
    T* vrow = dv + (gk * sk + key) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        krow[col] = from_f32<T>(acc_k[a][j] * scale);
        vrow[col] = from_f32<T>(acc_v[a][j]);
      }
    }
  }
}

// dQ of one query tile of one head (see the header).
template <typename T, int R, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int bh, int h, int kvh, int sq, int sk,
             int d, float scale, int causal, int n_qtiles) {
  constexpr int BT = 16 * R;
  constexpr int kLdp = BT + 1;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                 // [BT][ld]
  float* dos = qs + BT * ld;
  float* ks = dos + BT * ld;
  float* vs = ks + BT * ld;
  float* dss = vs + BT * ld;        // [BT queries][kLdp]: dS
  float* st = dss + BT * kLdp;      // lse [BT], delta [BT]

  const int tx = threadIdx.x & 15;  // key lane
  const int ty = threadIdx.x >> 4;  // query lane
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);  // longest first
  const long long g = blockIdx.x % bh;
  const long long gk = kv_row(g, h, kvh);
  const int q0 = qt * BT;
  const T* kg = k + gk * sk * d;
  const T* vg = v + gk * sk * d;

  load_tile(qs, q + g * sq * d, q0, BT, sq, d, ld);
  load_tile(dos, dout + g * sq * d, q0, BT, sq, d, ld);
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    const bool in = q0 + i < sq;
    st[i] = in ? lse[g * sq + q0 + i] : 0.0f;
    st[BT + i] = in ? delta[g * sq + q0 + i] : 0.0f;
  }

  float acc[R][NJ];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.0f;

  // Causal: keys past the tile's last query are masked for all its rows.
  const int k_end = causal ? min(sk, q0 + BT) : sk;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous K, V and dS are consumed
    load_tile(ks, kg, k0, BT, sk, d, ld);
    load_tile(vs, vg, k0, BT, sk, d, ld);
    __syncthreads();

    // S and dP: [query ty + 16 a][key tx + 16 b].
    float s[R][R], dp[R][R];
    tile_dots<R>(s, dp, qs, ks, dos, vs, d, ld, tx, ty);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int qr = ty + 16 * a;
      const int qpos = q0 + qr;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int key = k0 + tx + 16 * b;
        float x = s[a][b] * scale;
        if (causal && key > qpos) x = kNegInf;
        float p = expf(x - st[qr]);
        if (key >= sk || qpos >= sq) p = 0.0f;
        dss[qr * kLdp + tx + 16 * b] = p * (dp[a][b] - st[BT + qr]);
      }
    }
    __syncthreads();  // dS is complete

    const int kn = min(BT, k_end - k0);
    for (int c = 0; c < kn; ++c) {
      float dsv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) dsv[a] = dss[(ty + 16 * a) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float kv = col < d ? ks[c * ld + col] : 0.0f;
#pragma unroll
        for (int a = 0; a < R; ++a) acc[a][j] = fmaf(dsv[a], kv, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= sq) continue;
    T* row = dq + (g * sq + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) row[col] = from_f32<T>(acc[a][j] * scale);
    }
  }
}

template <typename T, int R, int NJ>
int launch_tiles(const T* q, const T* k, const T* v, const T* dout,
                 const float* lse, const float* delta, T* dq, T* dk, T* dv,
                 int bh, int h, int kvh, int sq, int sk, int d, float scale,
                 int causal, cudaStream_t stream) {
  constexpr int BT = 16 * R;
  const int smem_kv = dkdv_smem_bytes(d, BT);
  const int smem_q = dq_smem_bytes(d, BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, R, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, R, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  const int bkv = bh / h * kvh;
  const long long kv_blocks = (long long)((sk + BT - 1) / BT) * bkv;
  const int n_qtiles = (sq + BT - 1) / BT;
  const long long q_blocks = (long long)n_qtiles * bh;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return -1;
  flash_bwd_dkdv<T, R, NJ><<<(unsigned)kv_blocks, kThreads, smem_kv,
                              stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                        bkv, h, kvh, sq, sk, d, scale,
                                        causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T, R, NJ><<<(unsigned)q_blocks, kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, bh, h, kvh, sq, sk, d, scale, causal,
      n_qtiles);
  return (int)cudaGetLastError();
}

namespace tc {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRows = 128;     // a block's own rows, 64 a warpgroup
constexpr int kCols = 64;      // rows of a streamed tile
constexpr int kStages = 3;     // the streamed ring

// The padded head dim of a head dim d the route takes (d <= 128).
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 64 ? 64 : 128;
}

// Dynamic shared memory at padded width dp: the two resident tiles
// (kRows rows each), kStages pairs of streamed tiles (kCols rows each),
// for dK / dV each stage's kCols lse and delta floats, one 8-byte
// mbarrier per stage (64 bytes kept) and 1,024 bytes to align the base
// to a 128-byte swizzle atom of 8 rows.
__host__ __device__ constexpr int dq_smem(int dp) {
  return 2 * dp * (2 * kRows + 2 * kStages * kCols) + 64 + 1024;
}
__host__ __device__ constexpr int dkdv_smem(int dp) {
  return dq_smem(dp) + kStages * 2 * kCols * 4;
}

// dK and dV of kRows keys of one KV head (see the header).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma(const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int bkv, int h,
                     int kvh, int sq, int sk, int d, float scale,
                     float scale_log2, int causal,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do) {
  constexpr int kKBytes = kRows * DP * 2;  // K or V
  constexpr int kQBytes = kCols * DP * 2;  // one stage's Q or dO
  constexpr int kNS = kCols / 2;           // S^T registers a thread
  constexpr int kNO = DP / 2;              // dK or dV registers a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + kKBytes;
  const uint32_t s_q = s_v + kKBytes;  // stage st: Q at s_q + 2 st kQBytes
  const uint32_t s_stat = s_q + kStages * 2 * kQBytes;
  const uint32_t s_bar = s_stat + kStages * 2 * kCols * 4;
  float* stat = reinterpret_cast<float*>(smem_raw + (s_stat - raw));

  const int wg = threadIdx.x >> 7;         // keys 64 wg .. of the block's
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // and r0 + 8, of the 64 keys
  const int cq = 2 * (lane & 3);           // column in each 8-column chunk

  const int kt = (int)(blockIdx.x / bkv);  // the first tiles walk longest
  const long long gk = blockIdx.x % bkv;   // batch * KvH + KV head
  const int k0 = kt * kRows;
  const int k0w = k0 + 64 * wg;            // this warpgroup's first key
  const int rep = h / kvh;
  const long long g0 = (gk / kvh) * h + (gk % kvh) * rep;  // first q head
  // Causal: query tiles wholly before the key tile see none of its keys.
  const int n_qt = (sq + kCols - 1) / kCols;
  const int qt0 = causal ? k0 / kCols : 0;
  const int per_head = max(n_qt - qt0, 0);
  const int n_tiles = rep * per_head;      // heads outer, query tiles inner
  auto head_of = [&](int t) { return (int)(g0 + t / per_head); };
  auto q0_of = [&](int t) { return (qt0 + t % per_head) * kCols; };

  // A: this warpgroup's keys of K and V, K-major.  B of S^T and dP^T: a
  // stage's Q and dO, K-major; B of dV and dK: the same tiles, MN-major.
  // A k-step or stage moves the start address (16-byte units).
  const uint64_t desc_k = make_desc(s_k + wg * (64 * 128), 16, 1024);
  const uint64_t desc_v = make_desc(s_v + wg * (64 * 128), 16, 1024);
  const uint64_t desc_q = make_desc(s_q, 16, 1024);
  const uint64_t desc_do = make_desc(s_q + kQBytes, 16, 1024);
  const uint64_t desc_qt = make_desc(s_q, kCols * 128, 1024);
  const uint64_t desc_dot = make_desc(s_q + kQBytes, kCols * 128, 1024);
  auto stage_of = [](int t) {
    return (uint32_t)((t % kStages) * (2 * kQBytes / 16));
  };
  // Copies tile t's Q and dO (and, with tile 0, K and V) into its stage
  // by TMA: one thread, DP / 64 boxes each, against the stage's barrier.
  auto load_tiles = [&](int t) {
    if (threadIdx.x != 0) return;
    const uint32_t bar = s_bar + 8 * (t % kStages);
    const uint32_t dst = s_q + (t % kStages) * 2 * kQBytes;
    mbar_expect(bar, 2 * kQBytes + (t == 0 ? 2 * kKBytes : 0));
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      if (t == 0) {
        tma_load(s_k + c * (kRows * 128), &map_k, 64 * c, k0, (int)gk, bar);
        tma_load(s_v + c * (kRows * 128), &map_v, 64 * c, k0, (int)gk, bar);
      }
      tma_load(dst + c * (kCols * 128), &map_q, 64 * c, q0_of(t),
               head_of(t), bar);
      tma_load(dst + kQBytes + c * (kCols * 128), &map_do, 64 * c, q0_of(t),
               head_of(t), bar);
    }
  };
  // Stages tile t's row statistics: lse in log2 units, then delta; 0 for
  // queries past Sq (their Q and dO rows are zero).
  auto load_stat = [&](int t) {
    const int i = threadIdx.x;
    if (i >= 2 * kCols) return;
    const int qpos = q0_of(t) + (i % kCols);
    const long long row = (long long)head_of(t) * sq + qpos;
    float x = 0.0f;
    if (qpos < sq) x = i < kCols ? lse[row] * kLog2e : delta[row];
    stat[(t % kStages) * 2 * kCols + i] = x;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(s_bar + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_tiles > 0) load_stat(0);
  __syncthreads();
  if (n_tiles > 0) load_tiles(0);

  float acc_k[kNO], acc_v[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) {
    acc_k[i] = 0.0f;
    acc_v[i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t + 1 is copied while tile t is in the products.
    if (t + 1 < n_tiles) {
      load_tiles(t + 1);
      load_stat(t + 1);
    }
    mbar_wait(s_bar + 8 * (t % kStages), (t / kStages) & 1);
    const int q0 = q0_of(t);
    // A causal tile wholly above this warpgroup's diagonal (every key
    // past every query) adds nothing.
    if (!(causal && k0w > q0 + kCols - 1)) {
      float st[kNS], dpt[kNS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = ((kk & 3) << 5) >> 4;  // 32 bytes a k-step
        wgmma_ss(st, desc_k + (kk >> 2) * (kRows * 128 / 16) + col,
                 desc_q + stage_of(t) + (kk >> 2) * (kCols * 128 / 16) + col,
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = ((kk & 3) << 5) >> 4;
        wgmma_ss(dpt, desc_v + (kk >> 2) * (kRows * 128 / 16) + col,
                 desc_do + stage_of(t) + (kk >> 2) * (kCols * 128 / 16) +
                     col,
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // Register i is key k0w + r0 + 8 ((i >> 1) & 1) and query
      // q0 + cq + jc, jc = 8 (i >> 2) + (i & 1); causal, the pair is
      // masked where the key is past the query: jc < diag + 8 h.
      const float* lse2 = stat + (t % kStages) * 2 * kCols;
      const float* dl = lse2 + kCols;
      const bool edge = causal && k0w + 63 > q0;
      const int diag = k0w + r0 - q0 - cq;
      uint32_t pf[kCols / 16][4], dsf[kCols / 16][4];
#pragma unroll
      for (int i = 0; i < kNS; i += 2) {
        const int jc = 8 * (i >> 2);
        const int lim = diag + 8 * ((i >> 1) & 1);
        const float2 l = *reinterpret_cast<const float2*>(lse2 + jc + cq);
        const float2 e = *reinterpret_cast<const float2*>(dl + jc + cq);
        // p = 2^(s scale log2 e - lse log2 e): one FFMA and one MUFU op.
        float p0 = ex2(fmaf(st[i], scale_log2, -l.x));
        float p1 = ex2(fmaf(st[i + 1], scale_log2, -l.y));
        if (edge) {
          if (jc < lim) p0 = 0.0f;
          if (jc + 1 < lim) p1 = 0.0f;
        }
        pf[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
        dsf[i >> 3][(i >> 1) & 3] =
            pack_bf16(p0 * (dpt[i] - e.x), p1 * (dpt[i + 1] - e.y));
      }

      // dV += P^T dO, dK += dS^T Q: 16 queries (2,048 bytes) a k-step.
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pf);
      fence_regs(dsf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        wgmma_rs(acc_v, pf[kk],
                 desc_dot + stage_of(t) + kk * (16 * 128 / 16));
      }
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        wgmma_rs(acc_k, dsf[kk],
                 desc_qt + stage_of(t) + kk * (16 * 128 / 16));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // Keys past Sk are not stored; d % 8 == 0, so a stored column's pair is
  // whole.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0w + r0 + 8 * hh;
    if (key >= sk) continue;
    __nv_bfloat16* krow = dk + (gk * sk + key) * d;
    __nv_bfloat16* vrow = dv + (gk * sk + key) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= d) continue;
      const int i = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(krow + col) =
          __floats2bfloat162_rn(acc_k[i] * scale, acc_k[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
          __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
    }
  }
}

// dQ of kRows queries of one head (see the header).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int bh, int h, int kvh,
                   int sq, int sk, int d, float scale, float scale_log2,
                   int causal, int n_qtiles,
                   const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do) {
  constexpr int kQBytes = kRows * DP * 2;  // Q or dO
  constexpr int kKBytes = kCols * DP * 2;  // one stage's K or V
  constexpr int kNS = kCols / 2;           // S registers a thread
  constexpr int kNO = DP / 2;              // dQ registers a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_do = s_q + kQBytes;
  const uint32_t s_kv = s_do + kQBytes;  // stage st: K at s_kv + 2 st kKBytes
  const uint32_t s_bar = s_kv + kStages * 2 * kKBytes;

  const int wg = threadIdx.x >> 7;         // queries 64 wg .. of the block's
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // and r0 + 8, of the 64 queries
  const int cq = 2 * (lane & 3);

  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);  // longest first
  const long long g = blockIdx.x % bh;     // batch * head
  const long long gk = kv_row(g, h, kvh);  // its K/V row
  const int q0 = qt * kRows;
  const int q0w = q0 + 64 * wg;            // this warpgroup's first query
  // Causal: keys past the tile's last query are masked for all its rows.
  const int k_end = causal ? min(sk, q0 + kRows) : sk;
  const int n_tiles = (k_end + kCols - 1) / kCols;

  // This thread's two rows' statistics: lse in log2 units and delta.
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0w + r0 + 8 * hh;
    lse2[hh] = r < sq ? lse[g * sq + r] * kLog2e : 0.0f;
    dl[hh] = r < sq ? delta[g * sq + r] : 0.0f;
  }

  // A: this warpgroup's rows of Q and dO, K-major.  B of S and dP: a
  // stage's K and V, K-major; B of dQ: the stage's K, MN-major.
  const uint64_t desc_q = make_desc(s_q + wg * (64 * 128), 16, 1024);
  const uint64_t desc_do = make_desc(s_do + wg * (64 * 128), 16, 1024);
  const uint64_t desc_k = make_desc(s_kv, 16, 1024);
  const uint64_t desc_v = make_desc(s_kv + kKBytes, 16, 1024);
  const uint64_t desc_kt = make_desc(s_kv, kCols * 128, 1024);
  auto stage_of = [](int t) {
    return (uint32_t)((t % kStages) * (2 * kKBytes / 16));
  };
  // Copies K(t) and V(t) (and, with tile 0, Q and dO) into their stage.
  auto load_tiles = [&](int t) {
    if (threadIdx.x != 0) return;
    const uint32_t bar = s_bar + 8 * (t % kStages);
    const uint32_t dst = s_kv + (t % kStages) * 2 * kKBytes;
    mbar_expect(bar, 2 * kKBytes + (t == 0 ? 2 * kQBytes : 0));
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      if (t == 0) {
        tma_load(s_q + c * (kRows * 128), &map_q, 64 * c, q0, (int)g, bar);
        tma_load(s_do + c * (kRows * 128), &map_do, 64 * c, q0, (int)g, bar);
      }
      tma_load(dst + c * (kCols * 128), &map_k, 64 * c, t * kCols, (int)gk,
               bar);
      tma_load(dst + kKBytes + c * (kCols * 128), &map_v, 64 * c, t * kCols,
               (int)gk, bar);
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(s_bar + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_tiles(0);

  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tiles(t + 1);
    mbar_wait(s_bar + 8 * (t % kStages), (t / kStages) & 1);
    const int k0 = t * kCols;
    // A causal tile wholly above this warpgroup's diagonal adds nothing.
    if (!(causal && k0 > q0w + 63)) {
      float sc[kNS], dp[kNS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = ((kk & 3) << 5) >> 4;
        wgmma_ss(sc, desc_q + (kk >> 2) * (kRows * 128 / 16) + col,
                 desc_k + stage_of(t) + (kk >> 2) * (kCols * 128 / 16) + col,
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = ((kk & 3) << 5) >> 4;
        wgmma_ss(dp, desc_do + (kk >> 2) * (kRows * 128 / 16) + col,
                 desc_v + stage_of(t) + (kk >> 2) * (kCols * 128 / 16) + col,
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // Register i is query q0w + r0 + 8 h, h = (i >> 1) & 1, and key
      // k0 + cq + jc, jc = 8 (i >> 2) + (i & 1): masked at jc >= key_lim
      // (no such key) or, causal, jc > diag + 8 h.
      const bool edge = k0 + kCols > sk || (causal && k0 + kCols - 1 > q0w);
      const int key_lim = sk - k0 - cq;
      const int diag = q0w + r0 - k0 - cq;
      uint32_t dsf[kCols / 16][4];
#pragma unroll
      for (int i = 0; i < kNS; i += 2) {
        const int hh = (i >> 1) & 1;
        const int jc = 8 * (i >> 2);
        float p0 = ex2(fmaf(sc[i], scale_log2, -lse2[hh]));
        float p1 = ex2(fmaf(sc[i + 1], scale_log2, -lse2[hh]));
        if (edge) {
          if (jc >= key_lim || (causal && jc > diag + 8 * hh)) p0 = 0.0f;
          if (jc + 1 >= key_lim || (causal && jc + 1 > diag + 8 * hh)) {
            p1 = 0.0f;
          }
        }
        dsf[i >> 3][(i >> 1) & 3] =
            pack_bf16(p0 * (dp[i] - dl[hh]), p1 * (dp[i + 1] - dl[hh]));
      }

      // dQ += dS K: 16 keys (2,048 bytes) a k-step.
      fence_regs(acc);
      fence_regs(dsf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        wgmma_rs(acc, dsf[kk], desc_kt + stage_of(t) + kk * (16 * 128 / 16));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0w + r0 + 8 * hh;
    if (r >= sq) continue;
    __nv_bfloat16* row = dq + (g * sq + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= d) continue;
      const int i = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int bh, int h, int kvh, int sq, int sk, int d,
           float scale, int causal, cudaStream_t stream) {
  constexpr int kSmemKV = dkdv_smem(DP);
  constexpr int kSmemQ = dq_smem(DP);
  static_assert(kSmemKV <= 232448, "fits one SM's shared memory");
  auto dkdv = flash_bwd_dkdv_wgmma<DP>;
  auto dqk = flash_bwd_dq_wgmma<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemQ);
  if (err != cudaSuccess) return (int)err;
  // TMA reads rows 16 bytes aligned: d % 8 == 0 (the route) and bases.
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) != 0) {
    return -1;
  }
  const int bkv = bh / h * kvh;  // K and V hold B * KvH rows of [Sk, D]
  const long long kv_blocks = (long long)((sk + kRows - 1) / kRows) * bkv;
  const int n_qtiles = (sq + kRows - 1) / kRows;
  const long long q_blocks = (long long)n_qtiles * bh;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return -1;
  // Maps of the streamed tiles (kCols rows) and the resident ones (kRows).
  CUtensorMap q_s = {}, do_s = {}, k_r = {}, v_r = {};
  CUtensorMap q_r = {}, do_r = {}, k_s = {}, v_s = {};
  if (!(make_map(&q_s, q, bh, sq, d, kCols) &&
        make_map(&do_s, dout, bh, sq, d, kCols) &&
        make_map(&k_r, k, bkv, sk, d, kRows) &&
        make_map(&v_r, v, bkv, sk, d, kRows) &&
        make_map(&q_r, q, bh, sq, d, kRows) &&
        make_map(&do_r, dout, bh, sq, d, kRows) &&
        make_map(&k_s, k, bkv, sk, d, kCols) &&
        make_map(&v_s, v, bkv, sk, d, kCols))) {
    return -2;
  }
  const float scale_log2 = scale * kLog2e;
  dkdv<<<(unsigned)kv_blocks, kThreads, kSmemKV, stream>>>(
      lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), bkv, h, kvh, sq, sk, d, scale,
      scale_log2, causal, q_s, k_r, v_r, do_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<(unsigned)q_blocks, kThreads, kSmemQ, stream>>>(
      lse, delta, static_cast<__nv_bfloat16*>(dq), bh, h, kvh, sq, sk, d,
      scale, scale_log2, causal, n_qtiles, q_r, k_s, v_s, do_r);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, int bh, int h, int kvh, int sq, int sk, int d,
             float scale, int causal, cudaStream_t st) {
  if (padded_dim(d) == 64) {
    return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, h, kvh, sq,
                      sk, d, scale, causal, st);
  }
  return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, h, kvh, sq,
                     sk, d, scale, causal, st);
}

}  // namespace tc

namespace tf32 {

using namespace tc;  // the header's helpers; this namespace's names first

constexpr int kThreads = 256;  // 128 a warpgroup, two of them
constexpr int kRows = 128;     // rows a block owns, 64 a warpgroup
constexpr int kCols = 32;      // rows of a streamed tile
constexpr int kMaxDim = 64;    // the widest head dim the route takes

// The padded head dim (the N of the dV, dK and dQ products) of a head dim
// d the route takes, and the blocks an SM the registers are capped for.
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 32 ? 32 : 64;
}
__host__ __device__ constexpr int min_blocks(int dp) {
  return dp == 32 ? 2 : 1;
}

// Dynamic shared memory at padded width dp, float32 hi and lo tiles: the
// two resident ones (kRows rows each); per streamed tile (kCols rows) for
// dK / dV Q and dO and their transposes, and the tile's kCols lse and
// delta floats, for dQ K and V and K's transpose; 1,024 bytes to align
// the base to a 128-byte swizzle atom of 8 rows.
__host__ __device__ constexpr int dkdv_smem(int dp) {
  return 2 * 2 * 4 * dp * kRows + 4 * 2 * 4 * dp * kCols + 2 * kCols * 4 +
         1024;
}
__host__ __device__ constexpr int dq_smem(int dp) {
  return 2 * 2 * 4 * dp * kRows + 3 * 2 * 4 * dp * kCols + 1024;
}

// dK and dV of kRows keys of one KV head (see the header).  vec: every
// operand starts 16 bytes aligned (16-byte loads, 8-byte stores).
template <int DP, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
flash_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int bkv, int h, int kvh, int sq,
                    int sk, int d, float scale, float scale_log2, int causal,
                    int vec) {
  constexpr int kRT = kRows * DP * 4;  // bytes of a resident hi or lo tile
  constexpr int kCT = kCols * DP * 4;  // of a streamed one
  constexpr int kNS = kCols / 2;       // S^T registers a thread
  constexpr int kNO = DP / 2;          // dK or dV registers a thread
  constexpr int kRF = kRows * DP / 4 / kThreads;  // float4s a thread
  constexpr int kCF = kCols * DP / 4 / kThreads;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_kh = base, s_kl = s_kh + kRT;
  const uint32_t s_vh = s_kl + kRT, s_vl = s_vh + kRT;
  const uint32_t s_qh = s_vl + kRT, s_ql = s_qh + kCT;    // Q
  const uint32_t s_oh = s_ql + kCT, s_ol = s_oh + kCT;    // dO
  const uint32_t s_qth = s_ol + kCT, s_qtl = s_qth + kCT;  // Q^T
  const uint32_t s_oth = s_qtl + kCT, s_otl = s_oth + kCT;  // dO^T
  const uint32_t s_stat = s_otl + kCT;
  float* stat = reinterpret_cast<float*>(smem_raw + (s_stat - raw));

  const int wg = threadIdx.x >> 7;         // keys 64 wg .. of the block's
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // and r0 + 8, of the 64 keys
  const int cq = 2 * (lane & 3);           // column in each 8-column chunk

  const int kt = (int)(blockIdx.x / bkv);  // longest walks first
  const long long gk = blockIdx.x % bkv;   // batch * KvH + KV head
  const int k0 = kt * kRows;
  const int k0w = k0 + 64 * wg;            // this warpgroup's first key
  const int rep = h / kvh;
  const long long g0 = (gk / kvh) * h + (gk % kvh) * rep;  // first q head
  // Causal: query tiles wholly before the key tile see none of its keys.
  const int n_qt = (sq + kCols - 1) / kCols;
  const int qt0 = causal ? k0 / kCols : 0;
  const int per_head = max(n_qt - qt0, 0);
  const int n_tiles = rep * per_head;      // heads outer, query tiles inner
  auto head_of = [&](int t) { return g0 + t / per_head; };
  auto q0_of = [&](int t) { return (qt0 + t % per_head) * kCols; };

  // Descriptors of this warpgroup's rows of the resident tiles and of the
  // streamed ones; every tile is a constant offset from one of the two.
  uint64_t d_res = make_desc(s_kh + wg * (64 * 128), 16, 1024);
  uint64_t d_str = make_desc(s_qh, 16, 1024);

  {
    float4 x[kRF];
    fetch_f32<kRows, DP, kThreads>(x, k + gk * sk * d, k0, sk, d, vec);
    put_f32<kRows, DP, kThreads>(s_kh, s_kl, x);
    fetch_f32<kRows, DP, kThreads>(x, v + gk * sk * d, k0, sk, d, vec);
    put_f32<kRows, DP, kThreads>(s_vh, s_vl, x);
  }
  // Tile t's Q, dO and row statistic (lse in log2 units for threads below
  // kCols, delta for the next kCols; 0 past Sq, where Q and dO are zero
  // rows) are read into registers; at one block an SM (kPrefetch) tile
  // t + 1's while tile t is in the products, at two the other block's
  // products hide the reads (and the registers are not there).
  constexpr bool kPrefetch = MIN_BLOCKS == 1;
  float4 qx[kCF], ox[kCF];
  float stv = 0.0f;
  auto fetch = [&](int t) {
    const long long g = head_of(t);
    const int q0 = q0_of(t);
    fetch_f32<kCols, DP, kThreads>(qx, q + g * sq * d, q0, sq, d, vec);
    fetch_f32<kCols, DP, kThreads>(ox, dout + g * sq * d, q0, sq, d, vec);
    const int i = threadIdx.x;
    const int qpos = q0 + (i % kCols);
    stv = 0.0f;
    if (i < 2 * kCols && qpos < sq) {
      stv = i < kCols ? lse[g * sq + qpos] * kLog2e : delta[g * sq + qpos];
    }
  };
  if (kPrefetch && n_tiles > 0) fetch(0);

  float acc_k[kNO], acc_v[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) {
    acc_k[i] = 0.0f;
    acc_v[i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (!kPrefetch) fetch(t);
    __syncthreads();  // the previous tile is consumed (K and V are stored)
    put_f32<kCols, DP, kThreads>(s_qh, s_ql, qx);
    put_f32<kCols, DP, kThreads>(s_oh, s_ol, ox);
    put_f32_t<kCols, DP, kThreads>(s_qth, s_qtl, qx);
    put_f32_t<kCols, DP, kThreads>(s_oth, s_otl, ox);
    if (threadIdx.x < 2 * kCols) stat[threadIdx.x] = stv;
    fence_proxy_async();
    __syncthreads();
    const int q0 = q0_of(t);
    if (kPrefetch && t + 1 < n_tiles) fetch(t + 1);
    // A causal tile wholly above this warpgroup's diagonal (every key
    // past every query) adds nothing.
    if (causal && k0w > q0 + kCols - 1) continue;

    // A of S^T and dP^T: this warpgroup's keys of K and V; B: the
    // streamed Q and dO; B of dV and dK: the transposes dO^T and Q^T
    // (hi tiles; each lo tile follows its hi one).  The two bases are
    // pinned here so that the offsets are added where they are used, not
    // kept live as 64-bit registers.
    asm volatile("" : "+l"(d_res), "+l"(d_str));
    constexpr uint32_t kR16 = kRT / 16, kC16 = kCT / 16;
    float st[kNS], dpt[kNS];
    wgmma_fence();
    tf32x3_ss<DP / 8, kRows, kCols>(st, d_res, kR16, d_str, kC16);
    tf32x3_ss<DP / 8, kRows, kCols>(dpt, d_res + 2 * kR16, kR16,
                                    d_str + 2 * kC16, kC16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // Register i is key k0w + r0 + 8 ((i >> 1) & 1) and query
    // q0 + cq + jc, jc = 8 (i >> 2) + (i & 1); causal, the pair is masked
    // where the key is past the query: jc < diag + 8 h.  P^T in place of
    // S^T, dS^T = P^T (dP^T - delta) in place of dP^T.
    const bool edge = causal && k0w + 63 > q0;
    const int diag = k0w + r0 - q0 - cq;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int jc = 8 * (i >> 2) + (i & 1);
      float p = ex2(fmaf(st[i], scale_log2, -stat[jc + cq]));
      if (edge && jc < diag + 8 * ((i >> 1) & 1)) p = 0.0f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - stat[kCols + jc + cq]);
    }
    // dV += P^T dO, then dK += dS^T Q, three passes each, one after the
    // other (P^T's fragments are dead before dS^T's are made: two sets
    // live at once would spill at two blocks an SM).  Every k-step is
    // issued, past Sq too (dO and Q are zero rows there): a wgmma under a
    // branch is serialised.
    uint32_t ph[kCols / 8][4], pl[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) acc_to_a(st + 4 * j, ph[j], pl[j]);
    // Each tile's products go to one set of registers in turn and are
    // added to dV and dK rounded to nearest (the tensor cores'
    // accumulation drifts with the chain: see flash_tc.cuh).
    float tile[kNO];
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    tf32x3_rs<kCols / 8, DP>(tile, ph, pl, d_str + 6 * kC16, kC16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(tile);
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc_v[i] += tile[i];
    uint32_t sh[kCols / 8][4], sl[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) acc_to_a(dpt + 4 * j, sh[j], sl[j]);
    fence_regs(sh);
    fence_regs(sl);
    wgmma_fence();
    tf32x3_rs<kCols / 8, DP>(tile, sh, sl, d_str + 4 * kC16, kC16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(tile);
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc_k[i] += tile[i];
  }

  // Keys past Sk are not stored; d % 8 == 0, so a stored column's pair is
  // whole.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0w + r0 + 8 * hh;
    if (key >= sk) continue;
    float* krow = dk + (gk * sk + key) * d;
    float* vrow = dv + (gk * sk + key) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= d) continue;
      const int i = 4 * j + 2 * hh;
      const float2 kk2 = make_float2(acc_k[i] * scale, acc_k[i + 1] * scale);
      const float2 vv2 = make_float2(acc_v[i], acc_v[i + 1]);
      if (vec) {
        *reinterpret_cast<float2*>(krow + col) = kk2;
        *reinterpret_cast<float2*>(vrow + col) = vv2;
      } else {
        krow[col] = kk2.x;
        krow[col + 1] = kk2.y;
        vrow[col] = vv2.x;
        vrow[col + 1] = vv2.y;
      }
    }
  }
}

// dQ of kRows queries of one head (see the header).
template <int DP, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int bh, int h, int kvh, int sq, int sk, int d, float scale,
                  float scale_log2, int causal, int n_qtiles, int vec) {
  constexpr int kRT = kRows * DP * 4;
  constexpr int kCT = kCols * DP * 4;
  constexpr int kNS = kCols / 2;       // S registers a thread
  constexpr int kNO = DP / 2;          // dQ registers a thread
  constexpr int kRF = kRows * DP / 4 / kThreads;
  constexpr int kCF = kCols * DP / 4 / kThreads;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_qh = base, s_ql = s_qh + kRT;          // Q
  const uint32_t s_oh = s_ql + kRT, s_ol = s_oh + kRT;    // dO
  const uint32_t s_kh = s_ol + kRT, s_kl = s_kh + kCT;    // K
  const uint32_t s_vh = s_kl + kCT, s_vl = s_vh + kCT;    // V
  const uint32_t s_kth = s_vl + kCT, s_ktl = s_kth + kCT;  // K^T

  const int wg = threadIdx.x >> 7;         // queries 64 wg .. of the block's
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // and r0 + 8, of the 64 queries
  const int cq = 2 * (lane & 3);

  const int qt = n_qtiles - 1 - (int)(blockIdx.x / bh);  // longest first
  const long long g = blockIdx.x % bh;     // batch * head
  const long long gk = kv_row(g, h, kvh);  // its K/V row
  const int q0 = qt * kRows;
  const int q0w = q0 + 64 * wg;            // this warpgroup's first query
  const float* kg = k + gk * sk * d;
  const float* vg = v + gk * sk * d;
  // Causal: keys past the tile's last query are masked for all its rows.
  const int k_end = causal ? min(sk, q0 + kRows) : sk;
  const int n_tiles = (k_end + kCols - 1) / kCols;

  // Descriptors of this warpgroup's rows of the resident tiles and of the
  // streamed ones, as in dK / dV.
  uint64_t d_res = make_desc(s_qh + wg * (64 * 128), 16, 1024);
  uint64_t d_str = make_desc(s_kh, 16, 1024);

  {
    float4 x[kRF];
    fetch_f32<kRows, DP, kThreads>(x, q + g * sq * d, q0, sq, d, vec);
    put_f32<kRows, DP, kThreads>(s_qh, s_ql, x);
    fetch_f32<kRows, DP, kThreads>(x, dout + g * sq * d, q0, sq, d, vec);
    put_f32<kRows, DP, kThreads>(s_oh, s_ol, x);
  }
  // Tile t's K and V are read into registers; at one block an SM tile
  // t + 1's while tile t is in the products (as in dK / dV).
  constexpr bool kPrefetch = MIN_BLOCKS == 1;
  float4 kx[kCF], vx[kCF];
  auto fetch = [&](int t) {
    fetch_f32<kCols, DP, kThreads>(kx, kg, t * kCols, sk, d, vec);
    fetch_f32<kCols, DP, kThreads>(vx, vg, t * kCols, sk, d, vec);
  };
  if (kPrefetch) fetch(0);

  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (!kPrefetch) fetch(t);
    __syncthreads();  // the previous tile is consumed (Q and dO are stored)
    put_f32<kCols, DP, kThreads>(s_kh, s_kl, kx);
    put_f32<kCols, DP, kThreads>(s_vh, s_vl, vx);
    put_f32_t<kCols, DP, kThreads>(s_kth, s_ktl, kx);
    fence_proxy_async();
    __syncthreads();
    if (kPrefetch && t + 1 < n_tiles) fetch(t + 1);
    const int k0 = t * kCols;
    // A causal tile wholly above this warpgroup's diagonal adds nothing.
    if (causal && k0 > q0w + 63) continue;

    // A of S and dP: this warpgroup's rows of Q and dO; B: the streamed
    // K and V; B of dQ: K^T (pinned bases, as in dK / dV).
    asm volatile("" : "+l"(d_res), "+l"(d_str));
    constexpr uint32_t kR16 = kRT / 16, kC16 = kCT / 16;
    float sc[kNS], dp[kNS];
    wgmma_fence();
    tf32x3_ss<DP / 8, kRows, kCols>(sc, d_res, kR16, d_str, kC16);
    tf32x3_ss<DP / 8, kRows, kCols>(dp, d_res + 2 * kR16, kR16,
                                    d_str + 2 * kC16, kC16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // This thread's two rows' statistics, lse in log2 units and delta,
    // read again each tile (cached) rather than held in four registers
    // through the products.
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0w + r0 + 8 * hh;
      lse2[hh] = r < sq ? __ldg(lse + g * sq + r) * kLog2e : 0.0f;
      dl[hh] = r < sq ? __ldg(delta + g * sq + r) : 0.0f;
    }
    // Register i is query q0w + r0 + 8 h, h = (i >> 1) & 1, and key
    // k0 + cq + jc, jc = 8 (i >> 2) + (i & 1): masked at jc >= key_lim
    // (no such key) or, causal, jc > diag + 8 h.  dS in place of dP.
    const bool edge = k0 + kCols > sk || (causal && k0 + kCols - 1 > q0w);
    const int key_lim = sk - k0 - cq;
    const int diag = q0w + r0 - k0 - cq;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int hh = (i >> 1) & 1;
      const int jc = 8 * (i >> 2) + (i & 1);
      float p = ex2(fmaf(sc[i], scale_log2, -lse2[hh]));
      if (edge && (jc >= key_lim || (causal && jc > diag + 8 * hh))) {
        p = 0.0f;
      }
      dp[i] = p * (dp[i] - dl[hh]);
    }
    uint32_t sh[kCols / 8][4], sl[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) acc_to_a(dp + 4 * j, sh[j], sl[j]);

    // dQ += dS K, three passes (every k-step: past the last key dS is 0).
    float tile[kNO];  // this tile's dS K, added rounded to nearest
    fence_regs(sh);
    fence_regs(sl);
    wgmma_fence();
    tf32x3_rs<kCols / 8, DP>(tile, sh, sl, d_str + 4 * kC16, kC16);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(tile);
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc[i] += tile[i];
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0w + r0 + 8 * hh;
    if (r >= sq) continue;
    float* row = dq + (g * sq + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= d) continue;
      const int i = 4 * j + 2 * hh;
      if (vec) {
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[i] * scale, acc[i + 1] * scale);
      } else {
        row[col] = acc[i] * scale;
        row[col + 1] = acc[i + 1] * scale;
      }
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, int bh, int h, int kvh, int sq, int sk, int d,
           float scale, int causal, cudaStream_t stream) {
  constexpr int kSmemKV = dkdv_smem(DP);
  constexpr int kSmemQ = dq_smem(DP);
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448,
                "fits one SM's shared memory");
  auto dkdv = flash_bwd_dkdv_tf32<DP, min_blocks(DP)>;
  auto dqk = flash_bwd_dq_tf32<DP, min_blocks(DP)>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemQ);
  if (err != cudaSuccess) return (int)err;
  const int bkv = bh / h * kvh;  // K and V hold B * KvH rows of [Sk, D]
  const long long kv_blocks = (long long)((sk + kRows - 1) / kRows) * bkv;
  const int n_qtiles = (sq + kRows - 1) / kRows;
  const long long q_blocks = (long long)n_qtiles * bh;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return -1;
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout) |
                    reinterpret_cast<uintptr_t>(dq) |
                    reinterpret_cast<uintptr_t>(dk) |
                    reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  const float scale_log2 = scale * kLog2e;
  dkdv<<<(unsigned)kv_blocks, kThreads, kSmemKV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, bkv, h, kvh, sq, sk, d, scale,
      scale_log2, causal, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<(unsigned)q_blocks, kThreads, kSmemQ, stream>>>(
      q, k, v, dout, lse, delta, dq, bh, h, kvh, sq, sk, d, scale,
      scale_log2, causal, n_qtiles, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, int bh, int h, int kvh, int sq, int sk, int d,
             float scale, int causal, cudaStream_t st) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (padded_dim(d) == 32) {
    return launch<32>(qf, kf, vf, of, lse, delta, dqf, dkf, dvf, bh, h, kvh,
                      sq, sk, d, scale, causal, st);
  }
  return launch<64>(qf, kf, vf, of, lse, delta, dqf, dkf, dvf, bh, h, kvh,
                    sq, sk, d, scale, causal, st);
}

}  // namespace tf32

// The route of a call: 1, the tensor-core kernels for bfloat16 (dtype 1)
// with D % 8 == 0 up to D = 128; 2, the three-pass TF32 kernels for
// float32 (dtype 0) with D % 8 == 0 up to tf32::kMaxDim; 0, the FMA tiles
// otherwise.
constexpr int route_of(int d, int dtype) {
  if (d % 8 != 0) return 0;
  if (dtype == 1 && d <= 128) return 1;
  if (dtype == 0 && d <= tf32::kMaxDim) return 2;
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int h, int kvh, int sq, int sk, int d,
           float scale, int causal, int dtype, cudaStream_t st) {
  const long long rows = (long long)bh * sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return -1;
  // Set as for every K4 launch, though the pre-pass takes no shared
  // memory: the budget model reads each launcher's opt-in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_delta<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 0);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_delta<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (route_of(d, dtype) == 1) {
    return tc::dispatch(q, k, v, dout, lse, delta, dq, dk, dv, bh, h, kvh, sq,
                        sk, d, scale, causal, st);
  }
  if (route_of(d, dtype) == 2) {
    return tf32::dispatch(q, k, v, dout, lse, delta, dq, dk, dv, bh, h, kvh,
                          sq, sk, d, scale, causal, st);
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  const int groups = (d + 15) / 16;
#define FLASH_BWD_TILES(R, NJ)                                             \
  launch_tiles<T, R, NJ>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, bh, h, \
                         kvh, sq, sk, d, scale, causal, st)
  if (groups <= 1) return FLASH_BWD_TILES(4, 1);
  if (groups <= 2) return FLASH_BWD_TILES(4, 2);
  if (groups <= 4) return FLASH_BWD_TILES(4, 4);
  if (groups <= 8) return FLASH_BWD_TILES(4, 8);
  return FLASH_BWD_TILES(2, 16);
#undef FLASH_BWD_TILES
}

}  // namespace

// C entry points, bound with ctypes.  q, o, dout, dq [bh, sq, d] and k, v,
// dk, dv [bh / h * kvh, sk, d], contiguous, in one type (dtype 0 =
// float32, 1 = bfloat16), with bh = B * H and h = H a multiple of
// kvh = KvH; lse [bh, sq] float32 from flash_launch; delta a [bh, sq]
// float32 workspace.  Queues the three kernels of the call's route
// (flash_bwd_route) on the stream.  Returns -1 for arguments the kernels
// do not take (on the bfloat16 tensor-core route also q, k, v or dout
// not 16-byte aligned), -2 if a TMA map cannot be made, else
// cudaGetLastError().
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int bh, int h, int kvh,
                                int sq, int sk, int d, float scale,
                                int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > kMaxHeadDim) return -1;
  if (h <= 0 || kvh <= 0 || h % kvh != 0 || bh % h != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0) {
    return launch<float>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bh, h,
                         kvh, sq, sk, d, scale, causal != 0, dtype, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse_f, delta_f, dq, dk,
                                 dv, bh, h, kvh, sq, sk, d, scale,
                                 causal != 0, dtype, st);
  }
  return -1;
}

// The route flash_bwd_launch takes at head dim d and dtype (as above): 1
// for the bfloat16 tensor-core kernels, 2 for the three-pass TF32 ones, 0
// for the FMA tiles, -1 for what it does not take.
extern "C" int flash_bwd_route(int d, int dtype) {
  if (d <= 0 || d > kMaxHeadDim || (dtype != 0 && dtype != 1)) return -1;
  return route_of(d, dtype);
}

// Dynamic shared memory, in bytes, of the dK / dV kernel (which = 0) or
// the dQ kernel (which = 1) at head dim d and dtype; -1 for what it does
// not take.
extern "C" int flash_bwd_smem_bytes(int d, int dtype, int which) {
  const int route = flash_bwd_route(d, dtype);
  if (route < 0 || (which != 0 && which != 1)) return -1;
  if (route == 1) {
    const int dp = tc::padded_dim(d);
    return which == 0 ? tc::dkdv_smem(dp) : tc::dq_smem(dp);
  }
  if (route == 2) {
    const int dp = tf32::padded_dim(d);
    return which == 0 ? tf32::dkdv_smem(dp) : tf32::dq_smem(dp);
  }
  const int bt = 16 * rows_per_thread(d);
  return which == 0 ? dkdv_smem_bytes(d, bt) : dq_smem_bytes(d, bt);
}
