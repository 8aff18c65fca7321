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
// every product and sum in float32, outputs in the input type.
//
// Three kernels, queued by one call, each deterministic (no atomics):
//   1. flash_bwd_delta: delta, one warp a row;
//   2. flash_bwd_dkdv: one block of 256 threads a (key tile, batch * KvH):
//      K and V tiles stay in shared memory while the block walks the
//      group's query heads and, causal, the query tiles from the key
//      tile's diagonal on; each thread holds R keys x NJ columns of dK
//      and dV in registers;
//   3. flash_bwd_dq: one block a (query tile, batch * H), longest causal
//      tiles first: Q and dO stay, K and V stream through, R queries x
//      NJ columns of dQ a thread.
// Tiles are BT = 16 R rows square (R = 4 up to D = 128, else 2), stored
// as float32 with an odd row stride (D + 1) so that a warp's lanes read
// distinct banks, as f32::flash_kernel does.  Products run on the FMA
// units: simple and right first (tensor cores are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int h, int kvh, int sq, int sk, int d,
           float scale, int causal, cudaStream_t st) {
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
// float32 workspace.  Queues the three kernels on the stream.  Returns -1
// for arguments the kernels do not take, else cudaGetLastError().
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
                         kvh, sq, sk, d, scale, causal != 0, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse_f, delta_f, dq, dk,
                                 dv, bh, h, kvh, sq, sk, d, scale,
                                 causal != 0, st);
  }
  return -1;
}

// Dynamic shared memory, in bytes, of the dK / dV kernel (which = 0) or
// the dQ kernel (which = 1) at head dim d; -1 for what it does not take.
extern "C" int flash_bwd_smem_bytes(int d, int which) {
  if (d <= 0 || d > kMaxHeadDim) return -1;
  const int bt = 16 * rows_per_thread(d);
  if (which == 0) return dkdv_smem_bytes(d, bt);
  if (which == 1) return dq_smem_bytes(d, bt);
  return -1;
}
