// Fused incidence delivery for one leaf: gather + live mask + monoid
// segment-combine over every degree class of a dst-sorted CSR layout, in
// one launch, on Hopper (sm_90a).
//
// Replaces repro/kernels/deliver/fused.py::deliver_fused_pallas (body
// _combine_kernel), the TPU kernel that deliver_fused_classes launches
// once per degree class, and the inv_perm assembly that follows it.
//
// What it computes: for each destination row r of each class c,
//     fold(monoid, identity,
//          msgs[src_c[e], :] for lanes e with dst_c[e] == r
//                            and act[src_c[e]] != 0)
// written to out[slot_dst[slot_base_c + r], :] (a leaf: the [n_dst, D]
// result, rows of bucket-padding slots, slot_dst < 0, dropped), or to
// out[r, :] (one class with no slot map: its [n_rows, D] partial).  The
// zero-degree destinations get the identity.  Padding lanes carry an
// out-of-range dst, so no row ever selects them and the kernel never reads
// their sender: msgs needs no appended identity row.
//
// Bound: memory traffic.  Each lane costs 8 bytes of indices (src, dst),
// the sender's activity flag and D * 4 bytes of gathered message row, for
// one combine per element: far below the card's ratio of operations to
// bytes.  What the design does about it:
//   * one launch per leaf: every class's blocks in one grid, the widest
//     class's first (they take longest and must not form the tail); the
//     output rows are written where they belong, so no class partial, no
//     concatenation and no inv_perm gather ever exists;
//   * the [nnz, D] gathered intermediate never exists: rows are read
//     straight from the message table into registers and folded there;
//     the activity is read as act[src[e]] inside the kernel;
//   * rows are dst-sorted CSR, so each row is folded by one group of
//     lanes and combined with a register shuffle tree: no atomics, and
//     every output element is written exactly once;
//   * a block owns `span` rows, about two row steps of its threads, and
//     reads only their tiles' edge blocks (class_bounds, the block-sparse
//     skip of the TPU kernel; tiles of block_n rows).  A class whose rows
//     are long gets spans smaller than the tile (more blocks, few row
//     steps each; a warp-wide 32-ary search narrows the tile's edge range
//     to the span's lanes), a class of one-lane rows spans several tiles
//     (fewer blocks, every thread folding a row).  The
//     rows' lane ranges then come from one coalesced pass over dst, which
//     also stages the lanes' sender ids in shared memory, so the fold's
//     gathers wait on one device-memory round fewer;
//   * the group width follows the span's mean row length, so that each
//     lane folds about four edges of a row: short rows (the degree-1 and
//     -2 classes) take one lane each and do not leave a warp idle, and
//     each lane issues the loads of four of its edges before folding
//     them, so it keeps several gathers in flight.
// Measured limit (tools/leaf_isect_ab.py and chip_smoke.py on one NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md): a DBLP PageRank leaf takes 47-48 us
// of device time against a 10.5 us byte bound, held by the latency of
// each block's chain of dependent reads (tile bounds, then dst and src,
// then the message rows) over a few waves of blocks.
//
// Determinism: spans and group widths are functions of the layout alone,
// each lane folds its edges in a fixed order and the group combines with
// a fixed xor-shuffle tree, so the same input gives the same bits on
// every run.  Float min/max propagate NaN (as jnp.minimum / jnp.maximum
// do; fminf/fmaxf would drop it); int32 sum and prod wrap.

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
constexpr int kMaxClasses = 16;
constexpr int kUnroll = 4;
// Sender ids of up to this many lanes per block are staged in shared
// memory by the row-start pass (more: read again from device memory).
constexpr int kStage = 2048;
constexpr unsigned kFull = 0xffffffffu;
// The host's per-class descriptor (int64 words, fused.py::_DESC_FIELDS).
constexpr int kDescWords = 9;

struct ClassArgs {
  const int32_t* src;
  const int32_t* dst;
  const int32_t* bounds;
  long long nnz_pad;
  int n_rows;
  int block_e;
  int slot_base;
  int span;     // rows per block; divides block_n or is a multiple of it
  int entries;  // blocks: ceil(n_rows / span)
};

// A launch plan: the classes in launch order (widest first), each
// followed by its blocks.
struct Plan {
  ClassArgs cls[kMaxClasses];
  int n_classes;
  int block_n;
  int max_span;
};
constexpr int kMaxSpan = 4096;

// The first lane e in [lo, hi) with dst[e] >= key (dst sorted), else hi;
// by the whole warp, 32 probes a step.
__device__ int64_t warp_lower_bound(const int32_t* __restrict__ dst,
                                    int64_t lo, int64_t hi, int64_t key,
                                    int lane) {
  while (lo < hi) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t probe = lo + lane * step;
    const bool ge = probe >= hi || __ldg(dst + probe) >= key;
    const unsigned m = __ballot_sync(kFull, ge);
    const int f = m ? __ffs(m) - 1 : kWarp;
    if (step == 1) return f < kWarp ? lo + f : hi;
    if (f == 0) return lo;
    // The answer lies in (probe_{f-1}, probe_f].
    const int64_t new_hi = f == kWarp ? hi : lo + (int64_t)f * step;
    lo = lo + (int64_t)(f - 1) * step + 1;
    hi = new_hi < hi ? new_hi : hi;
  }
  return lo;
}

template <int ACT>
__device__ __forceinline__ bool is_live(const void* act, int32_t s) {
  if (ACT == 1) return __ldg(static_cast<const int32_t*>(act) + s) != 0;
  if (ACT == 2) return __ldg(static_cast<const uint8_t*>(act) + s) != 0;
  return true;
}

// One block per (class, span of rows).  ACT: 0 all senders live, 1 int32
// activity, 2 bool activity.  DC message columns per pass in registers.
//
// Row starts: dst is sorted, so a lane e whose dst differs from its
// predecessor's is where the rows (dst[e-1], dst[e]] begin.  The block
// reads its span's lanes once, coalesced, and each such boundary lane
// writes the start of the span rows it opens into shared memory (exactly
// one writer per row; rows no boundary opens start at `last`).
//
// Fold: a group of G lanes per row (G = a kUnroll-th of the span's mean
// row length, rounded up to a power of two, at most a warp) strides over
// the row's
// lanes, reads src, the sender's activity and the message row, and
// combines with an xor-shuffle tree inside the group.
template <typename T, int M, int DC, int ACT>
__global__ void __launch_bounds__(kThreads, DC == 1 ? 8 : 4)
deliver_fused_kernel(const T* __restrict__ msgs,
                     const void* __restrict__ act,
                     const __grid_constant__ Plan plan,
                     const int32_t* __restrict__ slot_dst,
                     const int32_t* __restrict__ zero_dst,
                     long long n_zero, T* __restrict__ out, int d) {
  // max_span + 1 row starts (span + 1 used), then kStage sender ids.
  extern __shared__ int64_t row_start[];
  int32_t* s_src = reinterpret_cast<int32_t*>(row_start + plan.max_span + 1);
  __shared__ int64_t range[2];

  // The identity rows of the zero-degree destinations, over the grid.
  for (long long z = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       z < n_zero; z += (long long)gridDim.x * blockDim.x) {
    T* row = out + (long long)__ldg(zero_dst + z) * d;
    for (int j = 0; j < d; ++j) row[j] = Op<T, M>::ident();
  }

  int entry = blockIdx.x;
  int c = 0;
  while (c + 1 < plan.n_classes && entry >= plan.cls[c].entries) {
    entry -= plan.cls[c].entries;
    ++c;
  }
  const ClassArgs& k = plan.cls[c];
  const int span = k.span;
  const int r0 = entry * span;  // < n_rows < 2^31
  const int rows_here = min(span, k.n_rows - r0);
  const int tile = r0 / plan.block_n;
  int64_t first = (int64_t)__ldg(k.bounds + 2 * tile) * k.block_e;
  int64_t last = first + (int64_t)__ldg(k.bounds + 2 * tile + 1) * k.block_e;
  if (span > plan.block_n) {
    // Several tiles: their lanes run from the first tile's start to the
    // latest end (an empty tile's end may lie before its neighbour's).
    const int n_tiles = (k.n_rows + plan.block_n - 1) / plan.block_n;
    const int t_end = min(tile + span / plan.block_n, n_tiles);
    for (int t = tile + 1; t < t_end; ++t) {
      const int64_t end =
          ((int64_t)__ldg(k.bounds + 2 * t) + __ldg(k.bounds + 2 * t + 1)) *
          k.block_e;
      last = end > last ? end : last;
    }
  }
  if (last > k.nnz_pad) last = k.nnz_pad;
  if (span < plan.block_n) {
    // Narrow the tile's lanes to this span's: warp 0 finds the first
    // lane of row r0, warp 1 the first past row r0 + span - 1.
    const int warp = threadIdx.x / kWarp;
    if (warp < 2) {
      const int64_t e = warp_lower_bound(k.dst, first, last,
                                         (int64_t)r0 + warp * span,
                                         threadIdx.x % kWarp);
      if (threadIdx.x % kWarp == 0) range[warp] = e;
    }
    __syncthreads();
    first = range[0];
    last = range[1];
  }

  const bool staged = last - first <= kStage;
  for (int i = threadIdx.x; i <= span; i += blockDim.x) row_start[i] = last;
  __syncthreads();
  for (int64_t e = first + threadIdx.x; e < last; e += blockDim.x) {
    if (staged) s_src[e - first] = __ldg(k.src + e);
    const int64_t cur = __ldg(k.dst + e);
    const int64_t prev = (e == first) ? INT64_MIN / 2 : __ldg(k.dst + e - 1);
    if (cur != prev) {
      const int64_t lo = prev + 1 > r0 ? prev + 1 : r0;
      const int64_t hi = cur < r0 + span ? cur : r0 + span;
      for (int64_t r = lo; r <= hi; ++r) row_start[r - r0] = e;
    }
  }
  __syncthreads();

  const int64_t total = row_start[rows_here] - row_start[0];
  const int mean = total >= kWarp * (int64_t)rows_here
                       ? kWarp
                       : ((int)total + rows_here - 1) / rows_here;
  int g = 1;
  while (g * kUnroll < mean && g < kWarp) g <<= 1;
  const int groups = blockDim.x / g;
  const int group = threadIdx.x / g;
  const int gl = threadIdx.x % g;
  // A lane's sender: from shared memory when staged.
  const int32_t* __restrict__ src = k.src;
  auto sender = [&](int64_t e) {
    return staged ? s_src[e - first] : __ldg(src + e);
  };

  // Every thread runs the same number of row steps, so whole warps
  // reach each shuffle together.
  for (int row0 = 0; row0 < rows_here; row0 += groups) {
    const int row = row0 + group;
    const bool valid = row < rows_here;
    const int64_t a = valid ? row_start[row] : 0;
    const int64_t b = valid ? row_start[row + 1] : 0;
    int64_t dest = -1;
    if (valid) {
      dest = slot_dst != nullptr
                 ? (int64_t)__ldg(slot_dst + k.slot_base + r0 + row)
                 : (int64_t)(r0 + row);
    }
    for (int d0 = 0; d0 < d; d0 += DC) {
      T acc[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] = Op<T, M>::ident();
      int64_t e = a + gl;
      // kUnroll of this lane's edges at a time: every load first, then
      // the folds in edge order (the order of the one-at-a-time loop).
      for (; e + (kUnroll - 1) * g < b; e += kUnroll * g) {
        int32_t s[kUnroll];
        bool live[kUnroll];
        T v[kUnroll][DC];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) s[q] = sender(e + q * g);
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) live[q] = is_live<ACT>(act, s[q]);
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const T* row_q = msgs + (int64_t)s[q] * d + d0;
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            v[q][j] = (live[q] && d0 + j < d) ? __ldg(row_q + j)
                                              : Op<T, M>::ident();
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (!live[q]) continue;
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            if (d0 + j < d) acc[j] = Op<T, M>::comb(acc[j], v[q][j]);
          }
        }
      }
      for (; e < b; e += g) {
        const int32_t s = sender(e);
        if (!is_live<ACT>(act, s)) continue;
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
      if (dest >= 0 && gl == 0) {
        T* out_row = out + dest * d + d0;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (d0 + j < d) out_row[j] = acc[j];
        }
      }
    }
  }
}

struct Launch {
  const void* msgs;
  const void* act;
  const Plan* plan;
  const int32_t* slot_dst;
  const int32_t* zero_dst;
  long long n_zero;
  void* out;
  int d;
  unsigned blocks;
  cudaStream_t stream;
};

template <typename T, int M, int DC, int ACT>
void launch_k(const Launch& l) {
  const size_t smem = (size_t)(l.plan->max_span + 1) * sizeof(int64_t) +
                      (size_t)kStage * sizeof(int32_t);
  deliver_fused_kernel<T, M, DC, ACT><<<l.blocks, kThreads, smem, l.stream>>>(
      static_cast<const T*>(l.msgs), l.act, *l.plan, l.slot_dst, l.zero_dst,
      l.n_zero, static_cast<T*>(l.out), l.d);
}

template <typename T, int M, int DC>
int launch_act(const Launch& l, int act_kind) {
  switch (act_kind) {
    case 0: launch_k<T, M, DC, 0>(l); return 0;
    case 1: launch_k<T, M, DC, 1>(l); return 0;
    case 2: launch_k<T, M, DC, 2>(l); return 0;
    default: return -1;
  }
}

template <typename T, int M>
int launch_dc(const Launch& l, int act_kind) {
  return l.d == 1 ? launch_act<T, M, 1>(l, act_kind)
                  : launch_act<T, M, 4>(l, act_kind);
}

template <typename T>
int launch_monoid(const Launch& l, int monoid, int act_kind) {
  switch (monoid) {
    case kSum: return launch_dc<T, kSum>(l, act_kind);
    case kMin: return launch_dc<T, kMin>(l, act_kind);
    case kMax: return launch_dc<T, kMax>(l, act_kind);
    case kProd: return launch_dc<T, kProd>(l, act_kind);
    default: return -1;
  }
}

}  // namespace

// C entry point, bound with ctypes.  `classes` is a host array of
// n_classes x 9 int64 words per class, in launch order: src, dst and
// bounds pointers, nnz_pad, n_rows, block_e, slot_base, span, blocks.
// `act` may be null (all live); act_kind 0 none, 1 int32, 2 bool.
// `slot_dst` null writes each class row r to out row r (one class);
// `zero_dst` lists the destinations that get the identity.  dtype: 0 =
// float32, 1 = int32.  monoid: 0 sum, 1 min, 2 max, 3 prod.  Returns -1
// for arguments the kernel does not take, else cudaGetLastError().
extern "C" int deliver_fused_launch(const void* msgs, const void* act,
                                    int act_kind, const long long* classes,
                                    int n_classes, int block_n,
                                    const void* slot_dst,
                                    const void* zero_dst, long long n_zero,
                                    void* out, int d, int dtype, int monoid,
                                    void* stream) {
  if (n_classes < 1 || n_classes > kMaxClasses || d < 1 || block_n < 1 ||
      block_n > 4096 || (act == nullptr) != (act_kind == 0)) {
    return -1;
  }
  Plan plan = {};
  plan.n_classes = n_classes;
  plan.block_n = block_n;
  long long blocks = 0;
  for (int c = 0; c < n_classes; ++c) {
    const long long* w = classes + (long long)c * kDescWords;
    ClassArgs& k = plan.cls[c];
    k.src = reinterpret_cast<const int32_t*>(w[0]);
    k.dst = reinterpret_cast<const int32_t*>(w[1]);
    k.bounds = reinterpret_cast<const int32_t*>(w[2]);
    k.nnz_pad = w[3];
    k.n_rows = (int)w[4];
    k.block_e = (int)w[5];
    k.slot_base = (int)w[6];
    k.span = (int)w[7];
    k.entries = (int)w[8];
    if (k.span < 1 || k.span > kMaxSpan ||
        (block_n % k.span != 0 && k.span % block_n != 0) || k.entries < 1 ||
        (long long)k.entries * k.span < k.n_rows) {
      return -1;
    }
    plan.max_span = max(plan.max_span, k.span);
    blocks += k.entries;
  }
  if (blocks > 0x7fffffffLL) return -1;
  const Launch l = {msgs, act, &plan,
                    static_cast<const int32_t*>(slot_dst),
                    static_cast<const int32_t*>(zero_dst), n_zero, out, d,
                    (unsigned)blocks, static_cast<cudaStream_t>(stream)};
  int rc;
  if (dtype == 0) {
    rc = launch_monoid<float>(l, monoid, act_kind);
  } else if (dtype == 1) {
    rc = launch_monoid<int32_t>(l, monoid, act_kind);
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
