// Hyperedge-pair (and triple) bitset intersection sizes: AND + popcount
// over word rows, summed per pair, on Hopper (sm_90a).
//
// Replaces repro/kernels/isect/isect.py:
//   * isect_pallas (body _isect_kernel) -> isect_launch: pre-gathered
//     rows a, b [P, W];
//   * isect_pallas_fused (body _isect_fused_kernel) -> isect_fused_launch:
//     rows gathered in the kernel from bits [E, W] by pair ids ea, eb,
//     plus an optional third id stream ec for the census's triples (the
//     body of repro/motifs/intersect.py::_tile_bitset).
//
// What it computes: out[p] = sum over words w of
//     popcount(A[p, w] & B[p, w] (& C[p, w]))
// with A[p] = bits[ea[p]] (fused) or a[p] (pre-gathered).  The words are
// int32 holding the bits of the reference's uint32 lanes; a self pair
// gives |e|.  The result is an integer sum, so it is the same bits on
// every run, whatever the order.
//
// Bound: at the census's shapes (W = 104 words at Apache, tens of
// millions of pairs) the popcount throughput, not device memory: each
// pair reads 8-12 bytes of ids and writes 4, its rows come from an index
// that fits in L2 (32.5 MB at Apache), and every word costs one __popc,
// which the SM issues at 16 a clock.  What the design does about it:
//   * a persistent grid: a few blocks per SM (as many as fit), each warp
//     walking chunks of 32 consecutive pairs in a grid-stride loop;
//   * ids loaded once per chunk, one pair's ids per lane (coalesced), and
//     the next chunk's ids loaded while this one runs;
//   * a register run cache (K3b): each lane holds its slice of the row it
//     last loaded in each id stream (one int4 when W <= 128 words and
//     W % 4 == 0, else up to four words when W <= 128), in a ring of R
//     register slots; rows load R - 1 pairs ahead of the pair being
//     counted.  A ballot over the chunk marks where a stream's id changes
//     from the pair before; a pair whose id repeats reuses the registers
//     and loads nothing.  The test is warp-uniform.  The census emits
//     triples grouped by draw, so a and b stay the same over runs of
//     thousands of pairs: a&b loads almost nothing, b&c and c&a one row
//     per pair, a&b&c one;
//   * a streamed ring (K3a, whose pre-gathered rows never repeat): each
//     lane copies its slice of the rows R - 1 pairs ahead into its warp's
//     ring in shared memory with cp.async, one commit group per pair,
//     waited in order, so the copies stay in flight without holding
//     registers (on the card K3b's register-ring kernel and the uncached
//     loop took 43-46% longer on the whole Apache index);
//   * a transposed reduction: each pair's per-lane partial is merged into
//     a binary counter of shuffles (31 per 32 pairs, none dependent on the
//     next pair), which leaves lane i with pair i's total; lane i writes
//     it, so the chunk's 32 stores are one coalesced write.  No atomics,
//     no padding of P or W;
//   * every pair's popcounts are done, repeated tuples included: the
//     bound counts them.
// Rows wider than 128 words take the uncached loop: ids broadcast per
// pair, each lane striding over the row's units, the same transposed
// reduction.
//
// Measured limit (tools/leaf_isect_ab.py and chip_smoke.py on one NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md): the census's a&b batch, which loads
// almost nothing, runs at 1.9e12 popcounts/s, 46% of the card's popcount
// rate (26 of a warp's 32 lanes carry a W = 104 row: 81% is this layout's
// ceiling); b&c, c&a and a&b&c gather one 416-byte row per pair from L2,
// about 23 GB a batch at 4.8 TB/s, where the card's measured L2 read rate
// is 6.5-7.2 TB/s.  K3a reads its rows from device memory at the rate of
// the older kernel (0.0185 ms on the cold index against a 0.0098 ms
// bound; the L2 flush before each timed call leaves dirty lines that the
// read must first write back).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// Slots of the streamed path's shared-memory ring per id stream: rows
// are copied kStreamRing - 1 pairs ahead (4 beat 2 and 8 on the card).
constexpr int kStreamRing = 4;

__device__ __forceinline__ int popc(int x) { return __popc(x); }
__device__ __forceinline__ int popc(int4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}
__device__ __forceinline__ int band(int x, int y) { return x & y; }
__device__ __forceinline__ int4 band(int4 x, int4 y) {
  return make_int4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}
// cp.async: this lane's 4 or 16 bytes from device memory into shared
// memory, in the background; groups of them complete in order.
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(V) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Waits until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ int vzero<int>() { return 0; }
template <>
__device__ __forceinline__ int4 vzero<int4>() { return make_int4(0, 0, 0, 0); }

// One level of the transposed reduction: `lo` and `hi` are this lane's
// partials of two sibling blocks of pairs; lanes with bit `off` set keep
// `hi`'s sum over the lane pair, the others `lo`'s.
__device__ __forceinline__ int merge(int lo, int hi, int off, int lane) {
  const bool upper = (lane & off) != 0;
  const int keep = upper ? hi : lo;
  const int send = upper ? lo : hi;
  return keep + __shfl_xor_sync(kFull, send, off);
}

// Folds pair j's partial `x` into the binary counter `acc`; after pair 31
// the returned value is pair `lane`'s total (lane keeps, at level k, the
// block its bit k selects).  j is a constant once the loop is unrolled.
__device__ __forceinline__ int fold_pair(int (&acc)[5], int x, int j,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if ((j >> k) & 1) {
      x = merge(acc[k], x, 1 << k, lane);
    } else {
      acc[k] = x;
      break;
    }
  }
  return x;
}

// The id streams of one launch.  MODE 0: pre-gathered rows (row p of a
// and of b); MODE 1: pairs (rows ea[p], eb[p] of a = bits); MODE 2:
// triples (rows ea[p], eb[p], ec[p] of bits).
template <int MODE>
struct Streams {
  static constexpr int S = MODE == 2 ? 3 : 2;
  const int32_t* base[S];
  const int32_t* ids[S];
  __device__ Streams(const int32_t* a, const int32_t* b, const int32_t* ea,
                     const int32_t* eb, const int32_t* ec) {
    base[0] = a;
    base[1] = MODE == 0 ? b : a;
    ids[0] = ea;
    ids[1] = eb;
    if (MODE == 2) {
      base[S - 1] = a;
      ids[S - 1] = ec;
    }
  }
  // This lane's id of pair p0 + lane in stream s (MODE 0: the row itself).
  __device__ __forceinline__ int id(int s, long long p0, int lane,
                                    int n) const {
    if (MODE == 0) return lane;  // rows p0 + lane: offset by p0 in row()
    return lane < n ? __ldg(ids[s] + p0 + lane) : -1;
  }
  // Row `r` (an id; MODE 0: a pair index within the chunk at p0).
  __device__ __forceinline__ const int32_t* row(int s, long long p0, int r,
                                                int w) const {
    return base[s] + ((MODE == 0 ? p0 : 0) + (long long)r) * w;
  }
};

// Cached path (K3b): each lane holds U units (V = int4 or int) of a row
// per stream in registers, in a ring of R slots; pair j is counted from
// slot j % R while pair j + R - 1 loads.  R divides 32, so pair 31's slot
// is R - 1 in every chunk, and the next chunk's pair 0 can reuse it.
template <int MODE, typename V, int U>
__global__ void __launch_bounds__(kThreads)
isect_cached(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             const int32_t* __restrict__ ea, const int32_t* __restrict__ eb,
             const int32_t* __restrict__ ec, int32_t* __restrict__ out,
             int w, long long n_pairs) {
  using St = Streams<MODE>;
  constexpr int S = St::S;
  constexpr int R = 2;  // a deeper ring ran slower on the card (PERF.md)
  constexpr int PF = R - 1;
  static_assert(MODE != 0, "pre-gathered rows take isect_stream");
  static_assert(32 % R == 0, "the ring must divide the chunk");
  const St st(a, b, ea, eb, ec);
  const int lane = threadIdx.x & (kWarp - 1);
  const int units = w / (int)(sizeof(V) / sizeof(int));
  const long long n_warps = ((long long)gridDim.x * kThreads) / kWarp;
  const long long n_chunks = (n_pairs + kWarp - 1) / kWarp;
  long long chunk = ((long long)blockIdx.x * kThreads + threadIdx.x) / kWarp;

  V ring[S][R][U];
  int last[S];  // the id whose row ring[s][R - 1] holds; -1: none
#pragma unroll
  for (int s = 0; s < S; ++s) last[s] = -1;

  int nid[S];
  if (chunk < n_chunks) {
    const int n = (int)min((long long)kWarp, n_pairs - chunk * kWarp);
#pragma unroll
    for (int s = 0; s < S; ++s) nid[s] = st.id(s, chunk * kWarp, lane, n);
  }
  for (; chunk < n_chunks; chunk += n_warps) {
    const long long p0 = chunk * kWarp;
    const int n = (int)min((long long)kWarp, n_pairs - p0);
    int id[S];
    unsigned chg[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      id[s] = nid[s];
      int before = __shfl_up_sync(kFull, id[s], 1);
      if (lane == 0) before = last[s];
      chg[s] = __ballot_sync(kFull, id[s] != before);
    }
    // The next chunk's ids, while this one runs.
    const long long next = chunk + n_warps;
    if (next < n_chunks) {
      const int nn = (int)min((long long)kWarp, n_pairs - next * kWarp);
#pragma unroll
      for (int s = 0; s < S; ++s) nid[s] = st.id(s, next * kWarp, lane, nn);
    }

    int acc[5];
    int total = 0;
#pragma unroll
    for (int j = -PF; j < kWarp; ++j) {
      // Load pair j + PF into its slot (or copy the slot before it when
      // the id repeats).  Warp-uniform branches: chg is a ballot.
      const int f = j + PF;
      if (f < kWarp && f < n) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if ((chg[s] >> f) & 1u) {
            const int r = __shfl_sync(kFull, id[s], f);
            const V* row = reinterpret_cast<const V*>(st.row(s, p0, r, w));
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int i = lane + kWarp * u;
              ring[s][f % R][u] = i < units ? __ldg(row + i) : vzero<V>();
            }
          } else {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              ring[s][f % R][u] = ring[s][(f + R - 1) % R][u];
            }
          }
        }
      }
      if (j < 0) continue;
      int x = 0;
      if (j < n) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          V v = band(ring[0][j % R][u], ring[1][j % R][u]);
          if (S == 3) v = band(v, ring[S - 1][j % R][u]);
          x += popc(v);
        }
      }
      total = fold_pair(acc, x, j, lane);
    }
    if (lane < n) out[p0 + lane] = total;
#pragma unroll
    for (int s = 0; s < S; ++s) last[s] = __shfl_sync(kFull, id[s], kWarp - 1);
  }
}

// Streamed path (K3a: rows p of a and b, which never repeat): each lane
// copies its U units of pair j + R - 1's rows into its warp's ring of R
// slots in shared memory (cp.async, one commit group per pair, waited in
// order) while pair j is counted from slot j % R.  Each lane reads back
// only the units it copied, so no barrier is needed.  When a and b are
// the same rows (the census's cardinalities), they are copied once.
template <typename V, int U>
__global__ void __launch_bounds__(kThreads)
isect_stream(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             const int32_t* __restrict__ ea, const int32_t* __restrict__ eb,
             const int32_t* __restrict__ ec, int32_t* __restrict__ out,
             int w, long long n_pairs) {
  constexpr int R = kStreamRing;
  constexpr int PF = R - 1;
  static_assert(32 % R == 0, "the ring must divide the chunk");
  const int lane = threadIdx.x & (kWarp - 1);
  const int units = w / (int)(sizeof(V) / sizeof(int));
  const bool same = a == b;
  const long long n_warps = ((long long)gridDim.x * kThreads) / kWarp;
  const long long n_chunks = (n_pairs + kWarp - 1) / kWarp;
  extern __shared__ int4 smem[];
  // This warp's ring, [slot][stream][unit][lane].
  V* mine = reinterpret_cast<V*>(smem) +
            (threadIdx.x / kWarp) * (R * 2 * U * kWarp) + lane;
  for (long long chunk = ((long long)blockIdx.x * kThreads + threadIdx.x) /
                         kWarp;
       chunk < n_chunks; chunk += n_warps) {
    const long long p0 = chunk * kWarp;
    const int n = (int)min((long long)kWarp, n_pairs - p0);
    int acc[5];
    int total = 0;
#pragma unroll
    for (int j = -PF; j < kWarp; ++j) {
      const int f = j + PF;
      if (f < kWarp && f < n) {
        const long long row = (p0 + f) * w;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (s == 1 && same) break;
          const V* src = reinterpret_cast<const V*>((s ? b : a) + row) + lane;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (lane + kWarp * u < units) {
              copy_async(mine + (((f % R) * 2 + s) * U + u) * kWarp,
                         src + kWarp * u);
            }
          }
        }
      }
      commit_async();
      if (j < 0) continue;
      wait_async<PF>();  // pair j's group is the PF + 1-th newest
      int x = 0;
      if (j < n) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (lane + kWarp * u < units) {
            const V va = mine[(((j % R) * 2) * U + u) * kWarp];
            const V vb = same ? va : mine[(((j % R) * 2 + 1) * U + u) * kWarp];
            x += popc(band(va, vb));
          }
        }
      }
      total = fold_pair(acc, x, j, lane);
    }
    if (lane < n) out[p0 + lane] = total;
  }
  wait_async<0>();
}

// Shared memory of the streamed path's rings: every warp's slots of
// 2 streams x U units x 32 lanes.
template <typename V, int U>
constexpr size_t ring_bytes() {
  return (size_t)(kThreads / kWarp) * kStreamRing * 2 * U * kWarp * sizeof(V);
}

// Uncached path, any width: per pair the ids are broadcast and each lane
// strides over the row's units; the same transposed reduction.
template <int MODE, typename V>
__global__ void __launch_bounds__(kThreads)
isect_loop(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           const int32_t* __restrict__ ea, const int32_t* __restrict__ eb,
           const int32_t* __restrict__ ec, int32_t* __restrict__ out, int w,
           long long n_pairs) {
  using St = Streams<MODE>;
  constexpr int S = St::S;
  const St st(a, b, ea, eb, ec);
  const int lane = threadIdx.x & (kWarp - 1);
  const int units = w / (int)(sizeof(V) / sizeof(int));
  const long long n_warps = ((long long)gridDim.x * kThreads) / kWarp;
  const long long n_chunks = (n_pairs + kWarp - 1) / kWarp;
  for (long long chunk = ((long long)blockIdx.x * kThreads + threadIdx.x) /
                         kWarp;
       chunk < n_chunks; chunk += n_warps) {
    const long long p0 = chunk * kWarp;
    const int n = (int)min((long long)kWarp, n_pairs - p0);
    int id[S];
#pragma unroll
    for (int s = 0; s < S; ++s) id[s] = st.id(s, p0, lane, n);
    int acc[5];
    int total = 0;
#pragma unroll
    for (int j = 0; j < kWarp; ++j) {
      int x = 0;
      if (j < n) {
        const V* row[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int r = MODE == 0 ? j : __shfl_sync(kFull, id[s], j);
          row[s] = reinterpret_cast<const V*>(st.row(s, p0, r, w));
        }
        for (int i = lane; i < units; i += kWarp) {
          V v = band(__ldg(row[0] + i), __ldg(row[1] + i));
          if (S == 3) v = band(v, __ldg(row[S - 1] + i));
          x += popc(v);
        }
      }
      total = fold_pair(acc, x, j, lane);
    }
    if (lane < n) out[p0 + lane] = total;
  }
}

using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, int32_t*, int,
                        long long);

// Blocks of `kernel` that the card holds at once (SMs x blocks per SM),
// asked once per kernel and device: the query costs more than a launch.
cudaError_t resident_blocks(Kernel kernel, size_t smem, long long* out) {
  struct Entry {
    Kernel kernel;
    int dev;
    long long blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    if (cache[i].kernel == kernel && cache[i].dev == dev) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  *out = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (n_cached < 64) cache[n_cached++] = {kernel, dev, *out};
  return cudaSuccess;
}

// A persistent grid: as many blocks as fit on the card at once, fewer
// when the pairs give each warp less than one chunk.
struct Pick {
  Kernel kernel;
  size_t smem;
};

int launch_persistent(Pick k, const int32_t* a, const int32_t* b,
                      const int32_t* ea, const int32_t* eb,
                      const int32_t* ec, int32_t* out, int w,
                      long long n_pairs, cudaStream_t stream) {
  long long resident = 0;
  const cudaError_t err = resident_blocks(k.kernel, k.smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long warps_per_block = kThreads / kWarp;
  const long long chunks = (n_pairs + kWarp - 1) / kWarp;
  long long blocks = (chunks + warps_per_block - 1) / warps_per_block;
  if (blocks > resident) blocks = resident;
  k.kernel<<<dim3((unsigned)blocks), kThreads, k.smem, stream>>>(
      a, b, ea, eb, ec, out, w, n_pairs);
  return (int)cudaGetLastError();
}

template <int MODE, typename V, int U>
Pick cached() {
  if constexpr (MODE == 0) {
    return {isect_stream<V, U>, ring_bytes<V, U>()};
  } else {
    return {isect_cached<MODE, V, U>, 0};
  }
}

// The kernel for a mode, unit type and width: the ring paths when a
// lane's slice of a row is one int4 (vec) or at most four words, the
// loop above that.
template <int MODE, typename V>
Pick pick_unit(int units) {
  if (units <= kWarp) return cached<MODE, V, 1>();
  if constexpr (sizeof(V) == sizeof(int)) {
    if (units <= 4 * kWarp) return cached<MODE, V, 4>();
  }
  return {isect_loop<MODE, V>, 0};
}

template <int MODE>
int launch(const int32_t* a, const int32_t* b, const int32_t* ea,
           const int32_t* eb, const int32_t* ec, int32_t* out, int w,
           long long n_pairs, int vec, cudaStream_t stream) {
  if (w <= 0 || n_pairs <= 0 || (vec && w % 4 != 0)) return -1;
  const Pick k = vec ? pick_unit<MODE, int4>(w / 4)
                     : pick_unit<MODE, int>(w);
  return launch_persistent(k, a, b, ea, eb, ec, out, w, n_pairs, stream);
}

}  // namespace

// C entry points, bound with ctypes.  `vec` = 1 takes 16-byte loads and
// needs w % 4 == 0 and 16-byte aligned rows.  Return -1 for arguments
// the kernel does not take, else the CUDA error code.

// K3a: out[p] = sum_w popcount(a[p, w] & b[p, w]); a, b [n_pairs, w].
extern "C" int isect_launch(const void* a, const void* b, void* out, int w,
                            long long n_pairs, int vec, void* stream) {
  return launch<0>(static_cast<const int32_t*>(a),
                   static_cast<const int32_t*>(b), nullptr, nullptr,
                   nullptr, static_cast<int32_t*>(out), w, n_pairs, vec,
                   static_cast<cudaStream_t>(stream));
}

// K3b: out[p] = sum_w popcount(bits[ea[p], w] & bits[eb[p], w]
//                              (& bits[ec[p], w] when ec is not null)).
extern "C" int isect_fused_launch(const void* bits, const void* ea,
                                  const void* eb, const void* ec, void* out,
                                  int w, long long n_pairs, int vec,
                                  void* stream) {
  const int32_t* bt = static_cast<const int32_t*>(bits);
  const int32_t* ia = static_cast<const int32_t*>(ea);
  const int32_t* ib = static_cast<const int32_t*>(eb);
  const int32_t* ic = static_cast<const int32_t*>(ec);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ic == nullptr) {
    return launch<1>(bt, nullptr, ia, ib, nullptr, o, w, n_pairs, vec, st);
  }
  return launch<2>(bt, nullptr, ia, ib, ic, o, w, n_pairs, vec, st);
}
