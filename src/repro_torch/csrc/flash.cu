// Multi-head attention forward with an online softmax (FlashAttention),
// causal or bidirectional, on Hopper (sm_90a).
//
// Replaces repro/kernels/flash/flash.py::flash_pallas (body
// _flash_kernel).
//
// What it computes, per (batch, head) and query row i of q, k, v
// [B, H, S, D] (float32 or bfloat16):
//     s[j] = (q[i] . k[j]) * (1 / sqrt(D))                 in float32
//     s[j] = -1e30 where causal and j > i                  (the TPU
//            kernel's finite sentinel, with positions from 0 top-left)
//     out[i] = sum_j p[j] v[j] / max(sum_j p[j], 1e-30),  p = softmax(s)
// kept, as on the TPU, as a running max m, denominator l and float32
// accumulator over key tiles: per tile, m' = max(m, max s),
// l = l e^(m - m') + sum p, acc = acc e^(m - m') + p v with
// p = e^(s - m'), where p is rounded to v's type before the product (for
// bfloat16) and not before the sum.  Keys at or past Sk do not exist
// (the wrapper pads nothing): their p is 0.
//
// Bound: for the shapes attention runs at (S in the thousands), the
// arithmetic: 4 D flops and one exp per (query, key) pair against
// 2 D (q, k, v, out) elements moved per row.  The card's rate for that
// arithmetic is its tensor cores (bfloat16) or its float32 FMA units.
// This kernel is the simple first version, on the FMA units:
//   * one block of 256 threads per (batch * head, 64-query tile), with
//     the longest causal tiles launched first; the Q tile stays in shared
//     memory, and K and V stream through it 64 keys at a time, converted
//     to float32 once on load (no TF32 anywhere: float32 inputs keep
//     IEEE float32 products);
//   * each thread holds a 4 x 4 block of the score tile and a
//     4 x ceil(D / 16) block of the accumulator in registers; tiles are
//     stored with an odd row stride so that the lanes of a warp read
//     distinct banks; a row's 16 threads form half a warp and reduce its
//     max and sum with shuffles;
//   * causal tiles wholly above the diagonal are skipped: there every p
//     is exactly 0 in float32 and the running max does not move, so the
//     result is unchanged;
//   * D up to 256: the three tiles plus the P tile take up to 214,016
//     bytes of dynamic shared memory, so the launch opts in above 48 KB.
// Not done here (later work): the tensor cores (mma.sync / wgmma) with
// bfloat16 operands, TMA or cp.async staging of K and V in a ring of
// tiles, and larger per-thread blocks; shared-memory bandwidth, not the
// FMA units, caps this version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per streamed tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
             const T* __restrict__ v, T* __restrict__ o, int bh, int sq,
             int sk, int d, float scale, int causal, int n_qtiles) {
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
  const int q0 = qt * kBQ;
  const T* qg = q + g * sq * d;
  const T* kg = k + g * sk * d;
  const T* vg = v + g * sk * d;

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
    T* orow = o + (g * sq + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) orow[col] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int sk, int d, float scale, int causal,
              cudaStream_t stream) {
  const int smem = ((kBQ + 2 * kBK) * (d + 1) + kBQ * (kBK + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return -1;
  flash_kernel<T, NJ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, sq, sk, d, scale,
      causal, n_qtiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int d, float scale, int causal,
           cudaStream_t st) {
  const int groups = (d + 15) / 16;
  if (groups <= 1) {
    return launch_nj<T, 1>(q, k, v, o, bh, sq, sk, d, scale, causal, st);
  }
  if (groups <= 2) {
    return launch_nj<T, 2>(q, k, v, o, bh, sq, sk, d, scale, causal, st);
  }
  if (groups <= 4) {
    return launch_nj<T, 4>(q, k, v, o, bh, sq, sk, d, scale, causal, st);
  }
  if (groups <= 8) {
    return launch_nj<T, 8>(q, k, v, o, bh, sq, sk, d, scale, causal, st);
  }
  return launch_nj<T, 16>(q, k, v, o, bh, sq, sk, d, scale, causal, st);
}

}  // namespace

// C entry point, bound with ctypes.  q, o [bh, sq, d] and k, v
// [bh, sk, d], contiguous; dtype 0 = float32, 1 = bfloat16.  Returns -1
// for arguments the kernel does not take (d outside [1, 256], an empty
// side), else cudaGetLastError().
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* o, int bh, int sq, int sk, int d,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 256) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, o, bh, sq, sk, d, scale, causal != 0, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale,
                                 causal != 0, st);
  }
  return -1;
}
