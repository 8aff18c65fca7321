// Fused incidence delivery for one degree class: gather + live mask +
// monoid segment-combine over a dst-sorted CSR edge list, on Hopper
// (sm_90a).
//
// Replaces repro/kernels/deliver/fused.py::deliver_fused_pallas (body
// _combine_kernel), the TPU kernel that deliver_fused_classes launches
// once per degree class.
//
// What it computes: for each destination row r < n_rows,
//     out[r, :] = fold(monoid, identity,
//                      msgs[src[e], :] for lanes e with dst[e] == r
//                                      and act[src[e]] != 0)
// Empty rows get the identity.  Padding lanes carry the identity sender
// and an out-of-range dst, so no row ever selects them.
//
// Bound: memory traffic.  Each lane costs 12 bytes of indices (src, dst,
// the sender's activity flag) and D * 4 bytes of gathered message row,
// for one combine per element: far below the card's ratio of
// operations to bytes.  What the design does about it:
//   * the [nnz, D] gathered intermediate never exists: rows are read
//     straight from the message table into registers and folded there;
//   * the per-lane activity is read as act[src[e]] inside the kernel, so
//     the [nnz] `live` gather of the JAX driver never materializes;
//   * rows are dst-sorted CSR, so each row is folded by one group of
//     lanes and combined with a register shuffle tree: no atomics, and
//     every output element is written exactly once;
//   * one thread block owns one tile of block_n rows and reads only its
//     tile's edge blocks (class_bounds, the block-sparse skip of the TPU
//     kernel); it finds the rows' lane ranges with one coalesced pass
//     over dst instead of a search per row, so the index streams are
//     read with full-sector loads and no chain of dependent reads;
//   * the group width follows the tile's mean row length, so short rows
//     (the degree-1 and -2 classes) do not leave most of a warp idle.
// Not done here (later work): TMA / cp.async staging of the index
// streams, a D-aware tile for wide rows.
//
// Determinism: the group width is a function of the layout alone, each
// lane folds its edges in a fixed order and the group combines with a
// fixed xor-shuffle tree, so the same input gives the same bits on every
// run.  Float min/max propagate NaN (as jnp.minimum /
// jnp.maximum do; fminf/fmaxf would drop it); int32 sum and prod wrap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Monoid { kSum = 0, kMin = 1, kMax = 2, kProd = 3 };

template <typename T, int M>
struct Op;

template <>
struct Op<float, kSum> {
  static __device__ __forceinline__ float ident() { return 0.0f; }
  static __device__ __forceinline__ float comb(float a, float b) {
    return a + b;
  }
};
template <>
struct Op<float, kProd> {
  static __device__ __forceinline__ float ident() { return 1.0f; }
  static __device__ __forceinline__ float comb(float a, float b) {
    return a * b;
  }
};
template <>
struct Op<float, kMin> {
  static __device__ __forceinline__ float ident() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float comb(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
  }
};
template <>
struct Op<float, kMax> {
  static __device__ __forceinline__ float ident() { return __int_as_float(0xff800000); }
  static __device__ __forceinline__ float comb(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
  }
};
template <>
struct Op<int32_t, kSum> {
  static __device__ __forceinline__ int32_t ident() { return 0; }
  static __device__ __forceinline__ int32_t comb(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};
template <>
struct Op<int32_t, kProd> {
  static __device__ __forceinline__ int32_t ident() { return 1; }
  static __device__ __forceinline__ int32_t comb(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
};
template <>
struct Op<int32_t, kMin> {
  static __device__ __forceinline__ int32_t ident() { return INT32_MAX; }
  static __device__ __forceinline__ int32_t comb(int32_t a, int32_t b) {
    return b < a ? b : a;
  }
};
template <>
struct Op<int32_t, kMax> {
  static __device__ __forceinline__ int32_t ident() { return INT32_MIN; }
  static __device__ __forceinline__ int32_t comb(int32_t a, int32_t b) {
    return b > a ? b : a;
  }
};

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// One thread block per tile of block_n destination rows.
//
// Pass 1 finds every row's lane range with no search: dst is sorted, so
// a lane e whose dst differs from its predecessor's is where the rows
// (dst[e-1], dst[e]] begin.  The block reads its tile's edge blocks once,
// coalesced, and each such boundary lane writes the start of the tile
// rows it opens into shared memory (exactly one writer per row; rows no
// boundary opens start at `last`).
//
// Pass 2 folds each row with a group of G lanes (G = the tile's mean
// row length rounded up to a power of two, at most a warp): the group
// strides over the row's lanes, reads src, the sender's activity and
// the message row, and combines with an xor-shuffle tree inside the
// group.  DC message columns per pass are kept in registers.
template <typename T, int M, int DC>
__global__ void __launch_bounds__(kThreads)
deliver_fused_kernel(const T* __restrict__ msgs,
                     const int32_t* __restrict__ act,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst,
                     const int32_t* __restrict__ bounds,
                     T* __restrict__ out, int n_rows, int d,
                     int64_t nnz_pad, int block_n, int block_e) {
  extern __shared__ int64_t row_start[];  // block_n + 1 entries
  const int tile = blockIdx.x;
  const int64_t base = (int64_t)tile * block_n;
  const int64_t rows_left = (int64_t)n_rows - base;
  const int rows_here = rows_left < block_n ? (int)rows_left : block_n;
  const int64_t first = (int64_t)__ldg(bounds + 2 * tile) * block_e;
  int64_t last = first + (int64_t)__ldg(bounds + 2 * tile + 1) * block_e;
  if (last > nnz_pad) last = nnz_pad;

  for (int i = threadIdx.x; i <= block_n; i += blockDim.x) row_start[i] = last;
  __syncthreads();
  for (int64_t e = first + threadIdx.x; e < last; e += blockDim.x) {
    const int64_t cur = __ldg(dst + e);
    const int64_t prev = (e == first) ? INT64_MIN / 2 : __ldg(dst + e - 1);
    if (cur != prev) {
      const int64_t lo = prev + 1 > base ? prev + 1 : base;
      const int64_t hi = cur < base + block_n ? cur : base + block_n;
      for (int64_t r = lo; r <= hi; ++r) row_start[r - base] = e;
    }
  }
  __syncthreads();

  const int64_t total = row_start[rows_here] - row_start[0];
  const int64_t mean = (total + rows_here - 1) / rows_here;
  int g = 1;
  while (g < mean && g < kWarp) g <<= 1;
  const int groups = blockDim.x / g;
  const int group = threadIdx.x / g;
  const int gl = threadIdx.x % g;

  // Every thread runs the same number of row steps, so whole warps
  // reach each shuffle together.
  for (int row0 = 0; row0 < rows_here; row0 += groups) {
    const int row = row0 + group;
    const bool valid = row < rows_here;
    const int64_t a = valid ? row_start[row] : 0;
    const int64_t b = valid ? row_start[row + 1] : 0;
    for (int d0 = 0; d0 < d; d0 += DC) {
      T acc[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] = Op<T, M>::ident();
      for (int64_t e = a + gl; e < b; e += g) {
        const int32_t s = __ldg(src + e);
        if (act != nullptr && __ldg(act + s) == 0) continue;
        const T* msg_row = msgs + (int64_t)s * d + d0;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (d0 + j < d) acc[j] = Op<T, M>::comb(acc[j], __ldg(msg_row + j));
        }
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        for (int off = g / 2; off > 0; off >>= 1) {
          acc[j] = Op<T, M>::comb(acc[j], __shfl_xor_sync(kFull, acc[j], off));
        }
      }
      if (valid && gl == 0) {
        T* out_row = out + (base + row) * d + d0;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (d0 + j < d) out_row[j] = acc[j];
        }
      }
    }
  }
}

template <typename T, int M>
void launch_t(const void* msgs, const void* act, const void* src,
              const void* dst, const void* bounds, void* out, int n_rows,
              int d, int64_t nnz_pad, int block_n, int block_e,
              cudaStream_t stream) {
  const dim3 grid((unsigned)((n_rows + block_n - 1) / block_n));
  const dim3 block(kThreads);
  const size_t smem = (size_t)(block_n + 1) * sizeof(int64_t);
  const T* m = static_cast<const T*>(msgs);
  const int32_t* ac = static_cast<const int32_t*>(act);
  const int32_t* s = static_cast<const int32_t*>(src);
  const int32_t* ds = static_cast<const int32_t*>(dst);
  const int32_t* bd = static_cast<const int32_t*>(bounds);
  T* o = static_cast<T*>(out);
  if (d == 1) {
    deliver_fused_kernel<T, M, 1><<<grid, block, smem, stream>>>(
        m, ac, s, ds, bd, o, n_rows, d, nnz_pad, block_n, block_e);
  } else if (d == 2) {
    deliver_fused_kernel<T, M, 2><<<grid, block, smem, stream>>>(
        m, ac, s, ds, bd, o, n_rows, d, nnz_pad, block_n, block_e);
  } else {
    deliver_fused_kernel<T, M, 4><<<grid, block, smem, stream>>>(
        m, ac, s, ds, bd, o, n_rows, d, nnz_pad, block_n, block_e);
  }
}

template <typename T>
int launch_monoid(int monoid, const void* msgs, const void* act,
                  const void* src, const void* dst, const void* bounds,
                  void* out, int n_rows, int d, int64_t nnz_pad,
                  int block_n, int block_e, cudaStream_t stream) {
  switch (monoid) {
    case kSum:
      launch_t<T, kSum>(msgs, act, src, dst, bounds, out, n_rows, d,
                        nnz_pad, block_n, block_e, stream);
      return 0;
    case kMin:
      launch_t<T, kMin>(msgs, act, src, dst, bounds, out, n_rows, d,
                        nnz_pad, block_n, block_e, stream);
      return 0;
    case kMax:
      launch_t<T, kMax>(msgs, act, src, dst, bounds, out, n_rows, d,
                        nnz_pad, block_n, block_e, stream);
      return 0;
    case kProd:
      launch_t<T, kProd>(msgs, act, src, dst, bounds, out, n_rows, d,
                         nnz_pad, block_n, block_e, stream);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = int32.
// monoid: 0 sum, 1 min, 2 max, 3 prod.  `act` may be null (all live).
// Returns -1 for an unknown dtype or monoid, else cudaGetLastError().
extern "C" int deliver_fused_launch(const void* msgs, const void* act,
                                    const void* src, const void* dst,
                                    const void* bounds, void* out,
                                    int n_rows, int d, long long nnz_pad,
                                    int block_n, int block_e, int dtype,
                                    int monoid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch_monoid<float>(monoid, msgs, act, src, dst, bounds, out,
                              n_rows, d, nnz_pad, block_n, block_e, st);
  } else if (dtype == 1) {
    rc = launch_monoid<int32_t>(monoid, msgs, act, src, dst, bounds, out,
                                n_rows, d, nnz_pad, block_n, block_e, st);
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
