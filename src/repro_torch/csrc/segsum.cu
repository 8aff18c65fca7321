// Segment sum: msgs [E, D] summed by destination id into [N, D], on
// Hopper (sm_90a), in two forms.
//
// Replaces repro/kernels/segsum/segsum.py::segsum_pallas:
//   * the unsorted body (_segsum_kernel, the pallas_call without
//     tile_bounds) -> segsum_launch (K2a): any dst order;
//   * the sorted body (_segsum_sorted_kernel, the pallas_call with
//     tile_bounds) -> segsum_sorted_launch (K2b): dst non-decreasing,
//     given as CSR row offsets.
//
// What it computes: out[n, :] = sum over e with dst[e] == n of
// msgs[e, :], accumulated in float32 and rounded once to the output's
// type (float32 or bfloat16, the type of msgs).  Ids outside [0, N) are
// dropped; a row with no edges is 0.
//
// The TPU kernel builds a one-hot [block_n, block_e] matrix and
// multiplies it on the MXU, sweeping every edge block for every output
// tile in the unsorted form (O(n_tiles * n_blocks) steps).  A segment
// sum does one add per element it reads, so on this card it is bound by
// device memory: each edge costs D * sizeof(T) bytes of message and 4 of
// id, each row D * sizeof(T) of output.  Neither the one-hot product
// (which turns 0 * inf into NaN in the rows that share a tile with an
// infinite message) nor the tile sweep is carried over:
//   * K2a buckets the edges by output tile (block_n rows) and sums each
//     tile in shared memory, so no float32 [N, D] buffer goes through
//     device memory.  Four kernels, queued by one call:
//       1. k2a_count: edges per tile, one pass over dst; a block bins
//          its 8,192 ids by tile in shared memory (lanes of a warp with
//          the same tile add once, __match_any_sync, so runs of equal
//          ids do not serialise on one bin) and adds each bin it
//          touched to the tile's count once;
//       2. k2a_plan (one block): scans of the counts into each tile's
//          edge offset, its work items (max(1, ceil(count / block_e)):
//          a tile with no edges still gets one, which writes its zeros)
//          and, for a tile of several items, the partial slots and
//          tickets of its combine tree; and the item -> tile map;
//       3. k2a_scatter: a second pass over dst, binned as the first,
//          writes each kept edge's index and its row within the tile,
//          one 8-byte store, into the tile's bucket: one cursor atomic
//          per tile a block touches places the block's share;
//       4. k2a_accumulate: a block per (work item, column slice); the
//          grid is an upper bound on the items (n_tiles + E / block_e),
//          so the host reads no count, and blocks past the real count
//          return at once.  A block zeroes a float32 [block_n, D_slice]
//          tile in shared memory and takes its edges kChunk at a time:
//          a counting sort by row in shared memory, then each lane group
//          folds a run of the sorted edges in registers (16-byte loads
//          where rows are aligned, a few edges in flight per lane) and
//          adds each row's sum into the tile once; runs end on row
//          boundaries, so only a row longer than a run is added
//          atomically.  (Float atomics on shared memory compile to a
//          compare-and-swap loop on this card, ATOMS.CAST.SPIN, too
//          slow to add every edge with.)  A tile of one item (most of
//          them) is stored once, rounded there for bfloat16.  The items
//          of a heavy tile write their touched rows as float32 partials
//          and meet in a tree of fan-in kFan: the last block of a group
//          to arrive (a ticket after __threadfence) sums the group's
//          partials in item order and goes up a level; the root stores.
//          So a tile that takes every edge runs on many blocks, and
//          combines read only the rows that were touched.
//     Columns beyond the shared-memory budget are cut into slices, a
//     grid dimension of their own (segsum.py's k2a_geometry).  The
//     order of the edges within a row after the sort, and of the atomic
//     adds at the ends of the runs, changes from run to run, so the last
//     bits of a float sum may too: K2a is not bitwise repeatable.
//   * K2b splits the work by items, not rows: the merge path of the row
//     ends and the edges (Merrill and Garland's merge-based CSR SpMV,
//     with every value 1 and D columns) is cut into equal shares of
//     `items` per block (segsum.py's k2b_geometry: block_e times 1,024
//     bytes over a row's bytes, 64 over them for rows of at most 4
//     bytes), so the longest row no longer sets the kernel's time: it is
//     cut across blocks.  A block finds its two ends with a warp-wide
//     search (32 probes a round, 4 rounds at DBLP's 782,660 offsets),
//     stages its row offsets in shared memory (and, for rows of at most
//     4 bytes, its message rows, by cp.async) and cuts its items into
//     equal shares again, one per lane group.  A group walks its share in
//     edge order, 4 edges loaded at a time, folding into float32
//     registers (16-byte loads where every row is aligned; staged rows:
//     one lane holds the whole row), stores each row that starts and ends
//     in the share at once (staged rows through shared memory, stored by
//     neighbouring lanes), and keeps the first
//     row if it started earlier (a head) and the open last row (a tail).
//     A segmented scan of the tails over the groups, keyed by row, in a
//     fixed order (shuffles in a warp, then earlier warps' totals
//     ascending), gives each head the rest of its row in the block.  A
//     row cut across blocks leaves a float32 piece per block, summed in
//     a tree of fan-in 16 over ascending blocks with tickets (the last
//     block of a group to arrive sums it and goes up; the tickets stay
//     zeroed between calls, each reset by its last arrival); a row that
//     only spills items / 8 edges or fewer into the block before is read
//     whole by the block where it ends instead.  Every sum is taken in an
//     order the blocks' arrival does not change: the same bits on every
//     run.
// Not done here (later work): overlapping a K2a block's sort and tile
// store with another item's loads (a block waits on each phase in
// turn); in K2b, overlapping a block's search and staging with another
// block's walk (at D = 1 the four search rounds and the staging take
// two thirds of the time; a block-wide search of 96 probes a round, in
// three rounds, was slower, and 16-byte copies of the staged rows no
// faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---- K2a -------------------------------------------------------------------
// Constants shared with segsum.py (K2A_FAN_IN, K2A_MAX_ROWS,
// K2A_SMEM_BYTES): the geometry there sizes the grid and the scratch.
constexpr int kFan = 8;             // partials one combine sums
constexpr int kMaxMaskWords = 128;  // touched-row bits: block_n <= 4096
constexpr int kPlanThreads = 1024;
constexpr int kUnroll = 4;          // edges in flight per lane group
constexpr int kChunk = 512;         // edges sorted in shared memory at once
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBinThreads = 512;    // passes 1 and 3
constexpr int kIdsPer = 16;         // ids a thread of passes 1 and 3
constexpr int kBinIds = kBinThreads * kIdsPer;
constexpr int kBinWindow = 8192;    // tiles binned in shared memory at once

// The tile of id r, or -1 for an id outside [0, n) (dropped).
__device__ __forceinline__ int tile_of(int r, int n, int block_n) {
  return (unsigned)r < (unsigned)n ? r / block_n : -1;
}

// Lanes of a warp whose tile is the same (`peers`) add to its counter
// once, through their leader: ids in runs do not serialise on one
// counter.  Returns the lane's place among its peers; `base` gets the
// counter's value before the add.
__device__ __forceinline__ int bin_add(int* bin, bool in, unsigned peers,
                                       int& base) {
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int old = 0;
  if (in && lane == leader) old = atomicAdd(bin, __popc(peers));
  base = __shfl_sync(kAll, old, leader);
  return __popc(peers & ((1u << lane) - 1));
}

// Pass 1: edges per tile.  A block takes kBinIds consecutive ids,
// kIdsPer a thread (lanes of a warp on neighbouring ids), and bins them
// by tile in shared memory, kBinWindow tiles at a time: one global
// atomic per tile a block touches, not per edge (on DBLP's shuffled
// ids, about half as many).
__global__ void __launch_bounds__(kBinThreads)
k2a_count(const int32_t* __restrict__ dst, long long n_edges, int n,
          int block_n, int n_tiles, int* __restrict__ counts) {
  __shared__ int bins[kBinWindow];
  const int tid = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kBinIds + tid;
  int tile[kIdsPer];
#pragma unroll
  for (int q = 0; q < kIdsPer; ++q) {
    const long long i = i0 + (long long)q * kBinThreads;
    tile[q] = i < n_edges ? tile_of(__ldg(dst + i), n, block_n) : -1;
  }
  for (int w0 = 0; w0 < n_tiles; w0 += kBinWindow) {
    const int width = min(kBinWindow, n_tiles - w0);
    for (int b = tid; b < width; b += kBinThreads) bins[b] = 0;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kIdsPer; ++q) {
      const int b = tile[q] - w0;
      const bool in = tile[q] >= 0 && b < width && b >= 0;
      int base;
      bin_add(bins + (in ? b : 0), in, __match_any_sync(kAll, in ? b : -1),
              base);
    }
    __syncthreads();
    for (int b = tid; b < width; b += kBinThreads)
      if (bins[b]) atomicAdd(counts + w0 + b, bins[b]);
    __syncthreads();
  }
}

// Pass 3: each kept edge's index and row within its tile, one 8-byte
// store, into the tile's bucket [edge_off[t], edge_off[t + 1]), binned
// as in pass 1: one cursor atomic per tile a block touches places the
// block's share, and each edge's bin gives its place in it.
__global__ void __launch_bounds__(kBinThreads)
k2a_scatter(const int32_t* __restrict__ dst, long long n_edges, int n,
            int block_n, int n_tiles, const int* __restrict__ edge_off,
            int* __restrict__ cursors, int2* __restrict__ bucket) {
  __shared__ int bins[kBinWindow];
  const int tid = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kBinIds + tid;
  int id[kIdsPer];
#pragma unroll
  for (int q = 0; q < kIdsPer; ++q) {
    const long long i = i0 + (long long)q * kBinThreads;
    id[q] = i < n_edges ? __ldg(dst + i) : -1;
  }
  for (int w0 = 0; w0 < n_tiles; w0 += kBinWindow) {
    const int width = min(kBinWindow, n_tiles - w0);
    for (int b = tid; b < width; b += kBinThreads) bins[b] = 0;
    __syncthreads();
    int rank[kIdsPer];
#pragma unroll
    for (int q = 0; q < kIdsPer; ++q) {
      const int t = tile_of(id[q], n, block_n), b = t - w0;
      const bool in = t >= 0 && b < width && b >= 0;
      int base;
      rank[q] = bin_add(bins + (in ? b : 0), in,
                        __match_any_sync(kAll, in ? b : -1), base);
      rank[q] += base;
    }
    __syncthreads();
    for (int b = tid; b < width; b += kBinThreads) {
      const int c = bins[b];
      if (c) bins[b] = edge_off[w0 + b] + atomicAdd(cursors + w0 + b, c);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kIdsPer; ++q) {
      const int t = tile_of(id[q], n, block_n), b = t - w0;
      if (t < 0 || b < 0 || b >= width) continue;
      const int edge = (int)(i0 + (long long)q * kBinThreads);
      bucket[bins[b] + rank[q]] = make_int2(edge, id[q] - t * block_n);
    }
    __syncthreads();
  }
}

// Slots (partials) and tickets of the combine tree of a tile of k items:
// level 0 has k nodes, each level above one per group of kFan below,
// up to a level of one node (the root, which stores).
__device__ __forceinline__ void tree_sizes(int k, int& slots, int& tickets) {
  slots = 0;
  tickets = 0;
  while (k > 1) {
    slots += k;
    k = (k + kFan - 1) / kFan;
    tickets += k;
  }
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ int4 shfl_up4(int4 v, int o) {
  return make_int4(__shfl_up_sync(kAll, v.x, o), __shfl_up_sync(kAll, v.y, o),
                   __shfl_up_sync(kAll, v.z, o), __shfl_up_sync(kAll, v.w, o));
}

// Inclusive scan of v over the block (kPlanThreads threads).
__device__ int4 block_scan(int4 v, int4* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int4 u = shfl_up4(v, o);
    if (lane >= o) v = add4(v, u);
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int4 w = warp_sums[lane];  // kPlanThreads / 32 == 32 warps
    for (int o = 1; o < 32; o <<= 1) {
      const int4 u = shfl_up4(w, o);
      if (lane >= o) w = add4(w, u);
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = add4(v, warp_sums[warp - 1]);
  __syncthreads();
  return v;
}

// Pass 2, one block: per tile the exclusive offsets of (edges, items,
// slots, tickets), a chunk of kPlanThreads tiles at a time with a
// carry; and item_tile[i] for every item of the chunk.
__global__ void __launch_bounds__(kPlanThreads)
k2a_plan(const int* __restrict__ counts, int n_tiles, int block_e,
         int* __restrict__ edge_off, int* __restrict__ item_off,
         int* __restrict__ slot_off, int* __restrict__ ticket_off,
         int* __restrict__ n_items, int* __restrict__ item_tile) {
  __shared__ int4 warp_sums[32];
  __shared__ int4 carry;
  __shared__ int first_item[kPlanThreads + 1];
  const int tid = threadIdx.x;
  if (tid == 0) carry = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int c0 = 0; c0 < n_tiles; c0 += kPlanThreads) {
    const int t = c0 + tid;
    int4 v = make_int4(0, 0, 0, 0);
    if (t < n_tiles) {
      const int c = counts[t];
      const int k = c > block_e ? (int)(((long long)c + block_e - 1) / block_e)
                                : 1;
      int slots, tickets;
      tree_sizes(k, slots, tickets);
      v = make_int4(c, k, slots, tickets);
    }
    const int4 base = carry;
    const int4 incl = block_scan(v, warp_sums);
    const int4 ex = make_int4(incl.x - v.x, incl.y - v.y, incl.z - v.z,
                              incl.w - v.w);
    if (t < n_tiles) {
      edge_off[t] = base.x + ex.x;
      item_off[t] = base.y + ex.y;
      slot_off[t] = base.z + ex.z;
      ticket_off[t] = base.w + ex.w;
    }
    first_item[tid] = ex.y;
    if (tid == kPlanThreads - 1) first_item[kPlanThreads] = incl.y;
    __syncthreads();
    // Item q of the chunk belongs to the last tile whose first item is
    // <= q (tiles past n_tiles start at the chunk's total, past every q).
    const int total = first_item[kPlanThreads];
    for (int q = tid; q < total; q += kPlanThreads) {
      int lo = 0, hi = kPlanThreads - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (first_item[mid] <= q) lo = mid; else hi = mid - 1;
      }
      item_tile[base.y + q] = c0 + lo;
    }
    __syncthreads();
    if (tid == kPlanThreads - 1) carry = add4(base, incl);
    __syncthreads();
  }
  if (tid == 0) {
    edge_off[n_tiles] = carry.x;
    item_off[n_tiles] = carry.y;
    slot_off[n_tiles] = carry.z;
    ticket_off[n_tiles] = carry.w;
    *n_items = carry.y;
  }
}

// VEC columns of a message row as loaded (one 16-byte load when VEC >
// 1), widened to float32 only when added: bfloat16 stays packed in 4
// registers, not 8.
template <typename T, int VEC>
struct Cols;
template <>
struct Cols<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void add_to(float (&a)[4]) const {
    a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
  }
};
template <>
struct Cols<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ void add_to(float (&a)[1]) const { a[0] += v; }
};
template <>
struct Cols<__nv_bfloat16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // A bfloat16 is the top half of a float32: widen by shifts.
  __device__ __forceinline__ void add_to(float (&a)[8]) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[2 * q] += __uint_as_float(w[q] << 16);
      a[2 * q + 1] += __uint_as_float(w[q] & 0xffff0000u);
    }
  }
};
template <>
struct Cols<__nv_bfloat16, 1> {
  __nv_bfloat16 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(p);
  }
  __device__ __forceinline__ void add_to(float (&a)[1]) const {
    a[0] += __bfloat162float(v);
  }
};

// VEC float32 sums from the tile (16-byte aligned when VEC > 1) into
// the output row, rounded once for bfloat16.
template <int VEC>
__device__ __forceinline__ void store_cols(float* o, const float* p) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(p);
  else
    *o = *p;
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <int VEC>
__device__ __forceinline__ void store_cols(__nv_bfloat16* o, const float* p) {
  if constexpr (VEC == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    *reinterpret_cast<uint4*>(o) =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                   pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  } else {
    *o = __float2bfloat16_rn(*p);
  }
}

// W floats (16-byte aligned when W == 4): copied, stored from registers,
// loaded into registers, or loaded from device memory through L2 (a
// combine reads what other blocks wrote).
template <int W>
__device__ __forceinline__ void copy_w(float* dst, const float* src) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else
    *dst = *src;
}
template <int W>
__device__ __forceinline__ void put_w(float* dst, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *dst = x[0];
}
template <int W>
__device__ __forceinline__ void get_w(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void get_cg_w(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = __ldcg(p);
  }
}

__device__ __forceinline__ bool has_row(const unsigned* mask, int r) {
  return (mask[r >> 5] >> (r & 31)) & 1u;
}

// In-place exclusive scan of bins[0, n) over the block (kMaxThreads
// threads, each on a run of neighbouring bins).
__device__ void scan_bins(int* bins, int n, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kMaxThreads - 1) / kMaxThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += bins[i];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int i = lo; i < hi; ++i) {
    const int c = bins[i];
    bins[i] = run;
    run += c;
  }
}

// Adds a lane's VEC sums into row r of the tile: a plain add when the
// lane's group holds all of the row's edges in this chunk, else atomic.
template <int VEC>
__device__ __forceinline__ void flush_row(float* p, const float (&acc)[VEC],
                                          bool owned) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    if (owned) p[q] += acc[q];
    else atomicAdd(p + q, acc[q]);
  }
}

// Where the run of edges from sorted position p on starts: p, moved on
// to the end of the row there when that row is no longer than per.
__device__ __forceinline__ int run_start(int p, int per, int len, int rows,
                                         const uint16_t* sorted_row,
                                         const int* bins) {
  if (p >= len) return len;
  const int r = sorted_row[p];
  const int start = bins[r], end = r + 1 < rows ? bins[r + 1] : len;
  return start == p || end - start > per ? p : end;
}

// Pass 4: one block per (work item, column slice).  The item's edges
// go through shared memory kChunk at a time: a counting sort by row
// (integer atomics on a histogram of block_n bins), then each lane
// group folds a run of neighbouring sorted edges in registers and adds
// each row's sum into the float32 tile once: plainly for the rows whose
// edges all lie in its run (runs end on row boundaries unless a row is
// longer than a run), atomically (at most two a run) for a long row it
// shares with the next or previous group.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
k2a_accumulate(const T* __restrict__ msgs, T* __restrict__ out,
               const int2* __restrict__ bucket,
               const int* __restrict__ item_tile,
               const int* __restrict__ n_items,
               const int* __restrict__ edge_off,
               const int* __restrict__ item_off,
               const int* __restrict__ slot_off,
               const int* __restrict__ ticket_off, int* tickets,
               unsigned* masks, float* partials, int n, int d, int block_n,
               int block_e, int d_slice, int n_slices, int lanes,
               int mask_words) {
  // Dynamic: the float32 tile [rows, d_slice], then block_n row bins.
  extern __shared__ __align__(16) float tile[];
  __shared__ unsigned touched[kMaxMaskWords];
  __shared__ unsigned group_masks[kFan][kMaxMaskWords];
  __shared__ int sorted_edge[kChunk];
  __shared__ uint16_t sorted_row[kChunk];
  __shared__ int warp_sums[kMaxThreads / 32];
  __shared__ int last;
  const int item = blockIdx.x;
  if (item >= *n_items) return;
  const int tid = threadIdx.x;
  const int slice = blockIdx.y, c0 = slice * d_slice;
  const int cols = min(d_slice, d - c0);
  const int t = item_tile[item];
  const int k_first = item_off[t];
  const int k = item_off[t + 1] - k_first, j = item - k_first;
  const long long e_begin = edge_off[t] + (long long)j * block_e;
  const long long e_stop = min(e_begin + block_e, (long long)edge_off[t + 1]);
  const int rows = min(block_n, n - t * block_n);
  int* bins = reinterpret_cast<int*>(tile + block_n * d_slice);

  // Tile rows are moved W floats at a time (16 bytes when VEC > 1).
  constexpr int W = VEC >= 4 ? 4 : 1;
  const int nw = cols / W;
  for (int x = tid; x < rows * d_slice / W; x += blockDim.x) {
    const float zero[W] = {};
    put_w<W>(tile + x * W, zero);
  }
  for (int w = tid; w < mask_words; w += blockDim.x) touched[w] = 0;

  // A group of `lanes` lanes per run of edges, lane l on vectors l,
  // l + lanes, ... of each row.
  const int nv = cols / VEC;  // cols is a multiple of VEC
  const int lane = tid % lanes, group = tid / lanes;
  const int groups = blockDim.x / lanes;
  constexpr int kPer = kChunk / kMaxThreads;
  // Edges in flight per lane: bfloat16's groups of 8 lanes are twice as
  // many as float32's of 16, and run faster with half as many each.
  constexpr int kIn = VEC == 8 ? kUnroll / 2 : kUnroll;
  for (long long c_at = e_begin; c_at < e_stop; c_at += kChunk) {
    const int len = (int)min((long long)kChunk, e_stop - c_at);
    for (int r = tid; r < rows; r += blockDim.x) bins[r] = 0;
    __syncthreads();
    int my_edge[kPer], my_row[kPer], my_rank[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int x = tid + q * kMaxThreads;
      my_row[q] = -1;
      if (x < len) {
        const int2 at = __ldg(bucket + c_at + x);
        my_edge[q] = at.x;
        my_row[q] = at.y;
        my_rank[q] = atomicAdd(bins + my_row[q], 1);
      }
    }
    __syncthreads();
    scan_bins(bins, rows, warp_sums);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (my_row[q] < 0) continue;
      const int at = bins[my_row[q]] + my_rank[q];
      sorted_edge[at] = my_edge[q];
      sorted_row[at] = (uint16_t)my_row[q];
    }
    for (int r = tid; r < rows; r += blockDim.x) {
      const int end = r + 1 < rows ? bins[r + 1] : len;
      if (end > bins[r]) atomicOr(touched + (r >> 5), 1u << (r & 31));
    }
    __syncthreads();

    // Group g's run starts at g * per, moved on to the end of the row
    // there when that row is no longer than per: short rows belong to
    // one run, and only a longer row is split (its ends added
    // atomically).
    const int per = (len + groups - 1) / groups;
    const int a = run_start(group * per, per, len, rows, sorted_row, bins);
    const int b =
        run_start((group + 1) * per, per, len, rows, sorted_row, bins);
    for (int v = lane; v < nv && a < b; v += lanes) {
      const T* base = msgs + c0 + v * VEC;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      int cur = sorted_row[a];
      for (int e = a; e < b; e += kIn) {
        Cols<T, VEC> x[kIn];
#pragma unroll
        for (int u = 0; u < kIn; ++u)
          if (e + u < b) x[u].load(base + (long long)sorted_edge[e + u] * d);
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          if (e + u >= b) break;
          const int r = sorted_row[e + u];
          if (r != cur) {
            const int end = cur + 1 < rows ? bins[cur + 1] : len;
            flush_row<VEC>(tile + cur * d_slice + v * VEC, acc,
                           bins[cur] >= a && end <= b);
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
            cur = r;
          }
          x[u].add_to(acc);
        }
      }
      const int end = cur + 1 < rows ? bins[cur + 1] : len;
      flush_row<VEC>(tile + cur * d_slice + v * VEC, acc,
                     bins[cur] >= a && end <= b);
    }
    __syncthreads();
  }
  __syncthreads();

  // A heavy tile's items meet in its combine tree; the root goes on.
  if (k > 1) {
    int node = j, level_nodes = k;
    int slot = slot_off[t], ticket = ticket_off[t];
    while (level_nodes > 1) {
      const int group = node / kFan, first = group * kFan;
      const int size = min(kFan, level_nodes - first);
      if (size > 1) {
        const long long at = (long long)(slot + node) * n_slices + slice;
        float* part = partials + at * block_n * d_slice;
        for (int w = tid; w < mask_words; w += blockDim.x)
          masks[at * mask_words + w] = touched[w];
        for (int x = tid; x < rows * nw; x += blockDim.x) {
          const int r = x / nw, c = (x - r * nw) * W;
          if (has_row(touched, r))
            copy_w<W>(part + r * d_slice + c, tile + r * d_slice + c);
        }
        __threadfence();
        __syncthreads();
        if (tid == 0)
          last = atomicAdd(tickets + (long long)(ticket + group) * n_slices +
                               slice, 1) == size - 1;
        __syncthreads();
        if (!last) return;
        __threadfence();
        const long long at0 = (long long)(slot + first) * n_slices + slice;
        for (int x = tid; x < size * mask_words; x += blockDim.x) {
          const int s = x / mask_words, w = x - s * mask_words;
          group_masks[s][w] =
              __ldcg(masks + (at0 + (long long)s * n_slices) * mask_words + w);
        }
        __syncthreads();
        for (int w = tid; w < mask_words; w += blockDim.x) {
          unsigned m = 0;
          for (int s = 0; s < size; ++s) m |= group_masks[s][w];
          touched[w] = m;
        }
        // The group's partials, summed in item order; this block's own
        // is still in its tile.
        const int own = node - first;
        for (int x = tid; x < rows * nw; x += blockDim.x) {
          const int r = x / nw, c = (x - r * nw) * W;
          float* p = tile + r * d_slice + c;
          float acc[W] = {};
          for (int s = 0; s < size; ++s) {
            if (!has_row(group_masks[s], r)) continue;
            float v[W];
            if (s == own)
              get_w<W>(p, v);
            else
              get_cg_w<W>(partials +
                              ((at0 + (long long)s * n_slices) * block_n + r) *
                                  d_slice + c,
                          v);
#pragma unroll
            for (int q = 0; q < W; ++q) acc[q] += v[q];
          }
          put_w<W>(p, acc);
        }
        __syncthreads();
      }
      slot += level_nodes;
      level_nodes = (level_nodes + kFan - 1) / kFan;
      ticket += level_nodes;
      node = group;
    }
  }

  T* o = out + (long long)t * block_n * d + c0;
  for (int x = tid; x < rows * nv; x += blockDim.x) {
    const int r = x / nv, v = x - r * nv;
    store_cols<VEC>(o + (long long)r * d + v * VEC,
                    tile + r * d_slice + v * VEC);
  }
}

// ---- K2b -------------------------------------------------------------------
// Constants shared with segsum.py (K2B_THREADS, K2B_FAN_IN): the geometry
// there sizes the grid, the scratch and the shared memory.
constexpr int kK2bThreads = 256;
constexpr int kK2bWarps = kK2bThreads / 32;
constexpr int kLgFan = 4;              // the carries' combine tree: fan-in 16
constexpr int kK2bIn = 4;              // edges loaded at a time per lane

// The merge path of the row ends (off[1..n]) and the edges
// (off[0]..off[n] - 1): how many rows end among its first k items, a
// row's end coming before an edge when they tie, and off[] at that row.
// Row x ends among them when off[x + 1] - off[0] <= k - x - 1, which
// holds below the answer and fails from it on.  A warp probes 32 points
// of the range a round (4 dependent rounds for 782,660 offsets), and one
// round settles a range of at most 32.  off[answer] is a value some
// probe loaded (or off[0]), so it costs no round of its own.
__device__ __forceinline__ int diag_search(const int32_t* __restrict__ off,
                                           int n, int off0, long long k,
                                           int& off_at) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = min(k, (long long)n);
  int off_lo = off0;  // off[lo]
  while (lo < hi) {
    const long long len = hi - lo;
    const bool fine = len <= 32;
    const long long p = fine ? lo + lane : lo + (lane + 1) * len / 33;
    const bool probe = !fine || lane < len;
    const int a = probe ? __ldg(off + p + 1) : 0;
    const bool ends = probe && a <= off0 + k - p - 1;
    const int cnt = __popc(__ballot_sync(kAll, ends));
    const long long p_last = __shfl_sync(kAll, p, max(cnt - 1, 0));
    const long long p_next = __shfl_sync(kAll, p, min(cnt, 31));
    const int a_last = __shfl_sync(kAll, a, max(cnt - 1, 0));
    if (cnt > 0) {
      lo = p_last + 1;
      off_lo = a_last;
    }
    if (fine) break;
    if (cnt < 32) hi = p_next;
  }
  off_at = off_lo;
  return (int)lo;
}

// The same count in shared memory, local to a block that starts at
// (row i0, edge js): rows m in [lo, hi] of s_off[m] = off[i0 + m], item r
// of the block.  One thread, bisection, in 32-bit arithmetic.
__device__ __forceinline__ int diag_search_smem(const int* s_off, int lo,
                                                int hi, int js, int r) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_off[mid + 1] - js <= r - mid - 1) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// cp.async: 4 bytes from device memory into shared memory, in the
// background (as isect.cu's copy_async); wait_async_all waits for all of
// this thread's copies.
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void wait_async_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// count elements from device memory into shared memory, the block's
// threads on neighbouring elements: 4-byte ones by cp.async, all in
// flight at once; others 8 loads a thread at a time.
template <typename U>
__device__ __forceinline__ void stage(U* dst, const U* __restrict__ src,
                                      int count) {
  if constexpr (sizeof(U) == 4) {
    for (int x = threadIdx.x; x < count; x += kK2bThreads)
      copy4_async(dst + x, src + x);
  } else {
    constexpr int kB = 8;
    for (int x0 = threadIdx.x; x0 < count; x0 += kB * kK2bThreads) {
      U v[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (x0 + u * kK2bThreads < count) v[u] = src[x0 + u * kK2bThreads];
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (x0 + u * kK2bThreads < count) dst[x0 + u * kK2bThreads] = v[u];
    }
  }
}

// A staged row's VEC columns (shared memory), widened to float32.
template <typename T, int VEC>
struct Staged {
  float v[VEC];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = to_f32(p[q]);
  }
  __device__ __forceinline__ void add_to(float (&a)[VEC]) const {
#pragma unroll
    for (int q = 0; q < VEC; ++q) a[q] += v[q];
  }
};

// VEC float32 sums, rounded once to T, into a 4-byte slot of shared
// memory (VEC * sizeof(T) <= 4).
template <typename T, int VEC>
__device__ __forceinline__ void put_slot(int* slot, const float (&a)[VEC]) {
  T* p = reinterpret_cast<T*>(slot);
#pragma unroll
  for (int q = 0; q < VEC; ++q) store(p + q, a[q]);
}

// VEC float32 sums into an output row, rounded once for bfloat16: one
// 16-byte store where VEC fills it.
template <int VEC>
__device__ __forceinline__ void store_vec(float* o, const float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) o[q] = a[q];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* o,
                                          const float (&a)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]),
                   pack_bf16(a[4], a[5]), pack_bf16(a[6], a[7]));
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) store(o + q, a[q]);
  }
}

// Adds row `row`'s pieces from the blocks b_s..b_e (each block one piece,
// float32 [d] in `carry`: block b's head piece at slot 2b, its tail piece
// at 2b + 1) in a tree of fixed shape over ascending blocks: level L
// groups the nodes (blocks >> 4L) by 16.  The last block of a group to
// arrive (a ticket per level and group) sums the group's nodes in
// ascending order into the slot of its first node and goes up; the block
// that sums the last group stores the row.  Block b enters with its own
// piece, which it wrote to its slot before the call (fenced, synced).
template <typename T>
__device__ void k2b_combine(int row, int b_s, int b_e, T* __restrict__ out,
                            int* tickets, float* carry, int d, int n_blocks,
                            int* s_last) {
  int cb = blockIdx.x;  // the block whose slot holds this block's node
  for (int level = 0;; ++level) {
    const int sh = level * kLgFan;
    const int node = cb >> sh, grp = node >> kLgFan;
    const int n_lo = max(b_s >> sh, grp << kLgFan);
    const int n_hi = min(b_e >> sh, (grp << kLgFan) + (1 << kLgFan) - 1);
    if (n_hi == n_lo) continue;  // alone in its group: up a level
    const int rep_lo = max(b_s, n_lo << sh);
    if (threadIdx.x == 0) {
      int* ticket = tickets + (long long)level * n_blocks + rep_lo;
      *s_last = atomicAdd(ticket, 1) == n_hi - n_lo;
      if (*s_last) *ticket = 0;  // every other arrival is in: reset
    }
    __syncthreads();
    const bool last = *s_last;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const bool root = (b_s >> (sh + kLgFan)) == (b_e >> (sh + kLgFan));
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float acc = 0.0f;
      for (int m = n_lo; m <= n_hi; ++m) {
        const int rep = max(b_s, m << sh);
        const long long slot = rep == b_e ? 2LL * b_e : 2LL * rep + 1;
        acc += __ldcg(carry + slot * d + c);
      }
      if (root) store(out + (long long)row * d + c, acc);
      else carry[(2LL * rep_lo + 1) * d + c] = acc;
    }
    if (root) return;
    cb = rep_lo;
    __threadfence();
    __syncthreads();
  }
}

// K2b: one block per `items` items of the merge path (row ends and
// edges), so a block's work is set by its share of the items whatever
// its rows' lengths.  Steps:
//   1. warps 0 and 1 find the block's first and last (row, edge) on the
//      path (diag_search); a row that ends in the block with at most
//      items / 8 edges in the block before is read whole, from its first
//      item, and the block before keeps no piece of it;
//   2. the block's row offsets off[i0..i1] go to shared memory, and for
//      rows of at most 4 bytes (STAGED: VEC == D) its message rows too;
//   3. the block's items are cut into equal shares, one per group of
//      `lanes` lanes (one lane when STAGED); a group finds its share's
//      start in shared memory and walks it in order, folding each edge
//      into float32 registers (its lane's VEC columns), kK2bIn edges
//      loaded at a time (from device memory, or shared memory when
//      STAGED).  A row that starts and ends in the share is stored at
//      once (STAGED: into shared memory, stored by the block at the
//      end); the first row, if it
//      started in an earlier share, is kept (the head), and so is the
//      open row at the share's end (the tail);
//   4. the tails go through a segmented inclusive scan over the groups,
//      keyed by row, in a fixed order (shuffles in a warp, then the
//      warps' totals in ascending order), so a group's head adds the
//      tails before it of the same row;
//   5. a row that ends in the block and started in it is stored; the
//      block's first row, if it started in an earlier block, and its
//      open last row are written as float32 pieces to `carry` and summed
//      by k2b_combine.
// Wide rows of more than 32 vectors are walked a column chunk (32 vectors
// of each group) at a time.
template <typename T, int VEC, bool STAGED>
__global__ void __launch_bounds__(kK2bThreads, 4)
k2b_kernel(const T* __restrict__ msgs, const int32_t* __restrict__ off,
           T* __restrict__ out, int* tickets, float* carry, int n, int d,
           int lanes, int items, int n_blocks) {
  // Dynamic: off[i0..i1], then (STAGED) from the next 16-byte boundary
  // the block's message rows as loaded.
  extern __shared__ __align__(16) int s_off[];
  constexpr int kW = STAGED ? VEC : 32 * VEC;  // a warp's last group
  // Staged rows go out through shared memory: row m's sums replace
  // off[i0 + m + 1] (read by the one lane that ends row m), and the block
  // stores its rows at the end, neighbouring lanes on neighbouring rows.
  static_assert(!STAGED || VEC * sizeof(T) <= 4, "a staged row fits a slot");
  __shared__ int s_i[2], s_off_i0;
  __shared__ int s_wkey[kK2bWarps];
  __shared__ int s_ma[kK2bThreads];
  __shared__ float s_wval[kK2bWarps][kW];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int off0 = __ldg(off);
  const long long k0 = (long long)b * items;

  // 1. The block's ends on the path (k1 past the end gives i1 = n).
  if (warp < 2) {
    int off_at;
    const int i = diag_search(off, n, off0, k0 + (warp ? items : 0), off_at);
    if (lane == 0) {
      s_i[warp] = i;
      if (!warp) s_off_i0 = off_at;
    }
  }
  const long long total = (long long)n + (__ldg(off + n) - off0);
  if (k0 >= total) return;  // the grid is a bound: E + n items
  const long long k1 = min(k0 + items, total);
  __syncthreads();
  const int i0 = s_i[0], i1 = s_i[1], off_i0 = s_off_i0;
  const int j0 = off0 + (int)(k0 - i0), j1 = off0 + (int)(k1 - i1);
  // A row that ends here, started in the previous block and has at most
  // items / 8 edges there is read whole by this block, which starts at
  // its first item: the previous block keeps no piece of it.
  const int reread = items / 8;
  const bool head_in = i0 < i1 && off_i0 < j0;
  const bool head_whole =
      head_in && ((long long)off_i0 - off0 + i0) / items == b - 1 &&
      j0 - off_i0 <= reread;
  const long long ks = head_whole ? (long long)(off_i0 - off0) + i0 : k0;
  const int js = head_whole ? off_i0 : j0;

  // 2. Offsets (and staged rows) into shared memory.
  stage(s_off, off + i0, i1 - i0 + 1);
  T* s_val = reinterpret_cast<T*>(s_off + ((i1 - i0 + 1 + 3) & ~3));
  if constexpr (STAGED)
    stage(s_val, msgs + (long long)js * VEC, (j1 - js) * VEC);
  wait_async_all();
  __syncthreads();

  // 3. This group's share [ra, rb) of the block's items [ks, k1), as
  // items from ks: rows i0 + ma .. i0 + mb, edges [ea, eb).
  const int G = STAGED ? 1 : lanes;
  const int groups = kK2bThreads / G;
  const int g = tid / G, gl = tid % G;
  const int nk = (int)(k1 - ks), rows = i1 - i0;
  const int per = (nk + groups - 1) / groups;
  const int ra = min(g * per, nk), rb = min(ra + per, nk);
  // Each group finds its share's first row; its last is the next share's.
  const int ma = diag_search_smem(s_off, 0, rows, js, ra);
  if (gl == 0) s_ma[g] = ma;
  __syncthreads();
  const int mb = g + 1 < groups ? s_ma[g + 1] : rows;
  const int ea = js + (ra - ma), eb = js + (rb - mb);
  // Row ma ends in this share but started before it: a head.
  const bool split_head = ma < mb && s_off[ma] < ea;
  const bool block_head = head_in && !head_whole;
  // The open last row leaves a piece unless the next block reads it whole.
  const int off_i1 = s_off[rows];
  bool block_tail = i1 < n && off_i1 < j1;
  int tail_end = 0;
  if (block_tail) {
    tail_end = __ldg(off + i1 + 1);
    const long long next = (long long)(b + 1) * items;
    block_tail = !(((long long)off_i1 - off0 + i1) / items == b &&
                   ((long long)tail_end - off0 + i1) / items == b + 1 &&
                   off0 + (next - i1) - off_i1 <= reread);
  }
  if constexpr (STAGED) __syncthreads();  // the searches read every slot

  const int nv = STAGED ? 1 : d / VEC;  // vectors a lane group covers
  for (int v0 = 0; v0 < nv; v0 += G) {
    const int v = v0 + gl;
    const bool on = v < nv;
    const int c0 = STAGED ? 0 : v * VEC;
    T* const out_c = out + (long long)i0 * d + c0;  // row i0, this lane
    float acc[VEC], head[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = head[q] = 0.0f;
    int r = ma;
    int next_end = r < mb ? s_off[r + 1] : INT_MAX;
    // Row i0 + r is done: kept as the head, or stored.
    auto finish = [&]() {
      if (r == ma && split_head) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) head[q] = acc[q];
      } else if (on) {
        if constexpr (STAGED) put_slot<T, VEC>(s_off + r + 1, acc);
        else store_vec<VEC>(out_c + (long long)r * d, acc);
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      ++r;
      next_end = r < mb ? s_off[r + 1] : INT_MAX;
    };
    // kK2bIn edges at a time, loaded before any is added: from device
    // memory, or shared memory (STAGED).
    const T* base = msgs + c0;
    for (int e = ea; e < eb; e += kK2bIn) {
      std::conditional_t<STAGED, Staged<T, VEC>, Cols<T, VEC>> x[kK2bIn];
#pragma unroll
      for (int u = 0; u < kK2bIn; ++u) {
        if (!on || e + u >= eb) continue;
        if constexpr (STAGED) x[u].load(s_val + (e + u - js) * VEC);
        else x[u].load(base + (long long)(e + u) * d);
      }
#pragma unroll
      for (int u = 0; u < kK2bIn; ++u) {
        if (e + u >= eb) break;
        while (next_end <= e + u) finish();
        if (on) x[u].add_to(acc);
      }
    }
    while (r < mb) finish();

    // 4. Segmented inclusive scan of the tails (row mb), in place in
    // acc, over the groups.
    const int key = mb;
    for (int o = G; o < 32; o <<= 1) {
      const int ku = __shfl_up_sync(kAll, key, o);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float u = __shfl_up_sync(kAll, acc[q], o);
        if (lane >= o && ku == key) acc[q] = u + acc[q];
      }
    }
    const bool warp_last = lane >= 32 - G;
    if (warp_last) {
      s_wkey[warp] = key;
#pragma unroll
      for (int q = 0; q < VEC; ++q) s_wval[warp][gl * VEC + q] = acc[q];
    }
    __syncthreads();
    {
      float pre[VEC];
      bool have = false;
      for (int w = 0; w < warp; ++w) {
        if (s_wkey[w] != key) continue;
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          pre[q] = have ? pre[q] + s_wval[w][gl * VEC + q]
                        : s_wval[w][gl * VEC + q];
        have = true;
      }
      if (have) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = pre[q] + acc[q];
      }
    }
    __syncthreads();
    if (warp_last) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) s_wval[warp][gl * VEC + q] = acc[q];
    }
    __syncthreads();
    // A head adds the scan just before its group: the tails of its row.
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      float prev = __shfl_up_sync(kAll, acc[q], G);
      if (lane < G) prev = warp > 0 ? s_wval[warp - 1][gl * VEC + q] : 0.0f;
      if (g > 0) head[q] = prev + head[q];
    }

    // 5. Heads: stored, or the block's head piece; the last group holds
    // the block's tail piece.
    if (split_head && on) {
      if (ma == 0 && block_head) {
        float* p = carry + 2LL * b * d + c0;
#pragma unroll
        for (int q = 0; q < VEC; ++q) p[q] = head[q];
      } else if constexpr (STAGED) {
        put_slot<T, VEC>(s_off + ma + 1, head);
      } else {
        store_vec<VEC>(out_c + (long long)ma * d, head);
      }
    }
    if (g == groups - 1 && block_tail && on) {
      float* p = carry + (2LL * b + 1) * d + c0;
#pragma unroll
      for (int q = 0; q < VEC; ++q) p[q] = acc[q];
    }
    __syncthreads();  // s_wval is reused by the next chunk
  }
  if constexpr (STAGED) {
    for (int m = tid + block_head; m < rows; m += kK2bThreads) {
      const T* slot = reinterpret_cast<const T*>(s_off + m + 1);
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        out[(long long)(i0 + m) * VEC + q] = slot[q];
    }
  }

  if (!block_head && !block_tail) return;
  __threadfence();
  __syncthreads();
  if (block_head)
    k2b_combine<T>(i0, (int)(((long long)off_i0 - off0 + i0) / items), b,
                   out, tickets, carry, d, n_blocks, &s_last);
  if (block_tail) {
    const long long first = (long long)off_i1 - off0 + i1;
    const long long end = (long long)tail_end - off0 + i1;
    k2b_combine<T>(i1, (int)(first / items), (int)(end / items), out,
                   tickets, carry, d, n_blocks, &s_last);
  }
}

// Lanes per edge or row: the columns rounded up to a power of two, at
// most a warp.
int col_lanes(int d) {
  int g = 1;
  while (g < d && g < 32) g <<= 1;
  return g;
}

}  // namespace

// C entry points, bound with ctypes.  dtype 0 = float32, 1 = bfloat16
// (msgs and out).  Return -1 for arguments the kernels do not take, else
// cudaGetLastError().

// K2a.  scratch is int32, laid out as segsum.py's k2a_geometry counts
// it, in this order: the bucket (int2: edge, row within its tile)
// [n_edges], counts [n_tiles], cursors [n_tiles], tickets [tickets *
// n_slices] (the three zeroed here), edge_off, item_off, slot_off,
// ticket_off [n_tiles + 1 each], n_items [1], item_tile [grid_items],
// masks [slots * n_slices * mask_words].  partials is float32 [slots *
// n_slices, block_n, d_slice].  vec is 1, or the elements of 16 bytes
// when every message row is 16-byte aligned; d_slice a multiple of vec.
extern "C" int segsum_launch(const void* msgs, const void* dst, void* out,
                             void* scratch, void* partials, long long n_edges,
                             int n, int d, int dtype, int block_n, int block_e,
                             int vec, int d_slice, int n_slices,
                             long long grid_items, long long slots,
                             long long tickets, void* stream) {
  if (n_edges <= 0 || n <= 0 || d <= 0 || block_e <= 0 || block_n <= 0 ||
      block_n > 32 * kMaxMaskWords || d_slice <= 0 || d_slice % vec ||
      n_slices <= 0 || n_slices > 65535 || grid_items > 0x7fffffffLL)
    return -1;
  const int n_tiles = (n + block_n - 1) / block_n;
  const int mask_words = (block_n + 31) / 32;
  const bool wide = vec > 1;
  if (wide && vec != (dtype == 0 ? 4 : 8)) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* bucket = static_cast<int2*>(scratch);
  int* counts = reinterpret_cast<int*>(bucket + n_edges);
  int* cursors = counts + n_tiles;
  int* ticket = cursors + n_tiles;
  int* edge_off = ticket + tickets * n_slices;
  int* item_off = edge_off + n_tiles + 1;
  int* slot_off = item_off + n_tiles + 1;
  int* ticket_off = slot_off + n_tiles + 1;
  int* n_items = ticket_off + n_tiles + 1;
  int* item_tile = n_items + 1;
  unsigned* masks = reinterpret_cast<unsigned*>(item_tile + grid_items);

  cudaError_t err = cudaMemsetAsync(
      counts, 0, (2 * (size_t)n_tiles + tickets * n_slices) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int32_t* ids = static_cast<const int32_t*>(dst);
  const unsigned pass_grid = (unsigned)((n_edges + kBinIds - 1) / kBinIds);
  k2a_count<<<pass_grid, kBinThreads, 0, st>>>(ids, n_edges, n, block_n,
                                               n_tiles, counts);
  k2a_plan<<<1, kPlanThreads, 0, st>>>(counts, n_tiles, block_e, edge_off,
                                       item_off, slot_off, ticket_off, n_items,
                                       item_tile);
  k2a_scatter<<<pass_grid, kBinThreads, 0, st>>>(ids, n_edges, n, block_n,
                                                 n_tiles, edge_off, cursors,
                                                 bucket);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int lanes = col_lanes((d_slice + vec - 1) / vec);
  const dim3 grid((unsigned)grid_items, (unsigned)n_slices);
  const size_t smem = (size_t)block_n * (d_slice + 1) * sizeof(float);
  float* part = static_cast<float*>(partials);
#define K2A_ARGS                                                          \
  bucket, item_tile, n_items, edge_off, item_off, slot_off, ticket_off,   \
      ticket, masks, part, n, d, block_n, block_e, d_slice, n_slices,     \
      lanes, mask_words
  if (dtype == 0) {
    const float* m = static_cast<const float*>(msgs);
    float* o = static_cast<float*>(out);
    if (wide)
      k2a_accumulate<float, 4><<<grid, kMaxThreads, smem, st>>>(m, o, K2A_ARGS);
    else
      k2a_accumulate<float, 1><<<grid, kMaxThreads, smem, st>>>(m, o, K2A_ARGS);
  } else {
    const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(msgs);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (wide)
      k2a_accumulate<__nv_bfloat16, 8>
          <<<grid, kMaxThreads, smem, st>>>(m, o, K2A_ARGS);
    else
      k2a_accumulate<__nv_bfloat16, 1>
          <<<grid, kMaxThreads, smem, st>>>(m, o, K2A_ARGS);
  }
#undef K2A_ARGS
  return (int)cudaGetLastError();
}

// K2b.  offsets [n + 1] int32, non-decreasing, in [0, E]: row r sums msgs
// rows [offsets[r], offsets[r + 1]).  One block per `items` items of the
// merge path; n_blocks = ceil((n + E) / items), a bound (blocks past the
// real count return at once).  narrow: rows of d * sizeof(T) <= 4 bytes,
// vec == d, staged in shared memory; else vec is 1 or 16 bytes' worth
// (every row 16-byte aligned) and `lanes` (a power of two <= 32) lanes
// cover a row's d / vec vectors.  tickets: int32, at least levels *
// n_blocks (a level per factor of 16 in n_blocks), all 0; the kernel
// leaves them 0.  carry: float32 [2 * n_blocks, d].  smem: the dynamic
// shared memory, as segsum.py's k2b_geometry counts it.
namespace {

template <typename T, int VEC, bool STAGED>
int k2b_launch(const void* msgs, const int32_t* off, void* out, int* tickets,
               float* carry, int n, int d, int lanes, int items,
               long long n_blocks, int smem, cudaStream_t st) {
  auto kernel = k2b_kernel<T, VEC, STAGED>;
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)n_blocks, kK2bThreads, smem, st>>>(
      static_cast<const T*>(msgs), off, static_cast<T*>(out), tickets, carry,
      n, d, lanes, items, (int)n_blocks);
  return 0;
}

}  // namespace

extern "C" int segsum_sorted_launch(const void* msgs, const void* offsets,
                                    void* out, void* tickets, void* carry,
                                    int n, int d, int dtype, int narrow,
                                    int vec, int lanes, int items,
                                    long long n_blocks, int smem,
                                    void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  if (n <= 0 || d <= 0 || items <= 0 || n_blocks <= 0 ||
      n_blocks > 0x7fffffffLL || smem < 4 * (items + 1) ||
      (dtype != 0 && dtype != 1))
    return -1;
  if (narrow ? (vec != d || d * size > 4 || lanes != 1)
             : ((vec != 1 && vec != 16 / size) || d % vec || lanes < 1 ||
                lanes > 32 || (lanes & (lanes - 1))))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tk = static_cast<int*>(tickets);
  float* cr = static_cast<float*>(carry);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  int rc;
  if (narrow) {
    rc = dtype == 0 ? k2b_launch<float, 1, true>(msgs, off, out, tk, cr, n, d,
                                                 1, items, n_blocks, smem, st)
         : d == 1   ? k2b_launch<__nv_bfloat16, 1, true>(
                        msgs, off, out, tk, cr, n, d, 1, items, n_blocks,
                        smem, st)
                    : k2b_launch<__nv_bfloat16, 2, true>(
                        msgs, off, out, tk, cr, n, d, 1, items, n_blocks,
                        smem, st);
  } else if (dtype == 0) {
    rc = vec == 4 ? k2b_launch<float, 4, false>(msgs, off, out, tk, cr, n, d,
                                                lanes, items, n_blocks, smem,
                                                st)
                  : k2b_launch<float, 1, false>(msgs, off, out, tk, cr, n, d,
                                                lanes, items, n_blocks, smem,
                                                st);
  } else {
    rc = vec == 8
             ? k2b_launch<__nv_bfloat16, 8, false>(msgs, off, out, tk, cr, n,
                                                   d, lanes, items, n_blocks,
                                                   smem, st)
             : k2b_launch<__nv_bfloat16, 1, false>(msgs, off, out, tk, cr, n,
                                                   d, lanes, items, n_blocks,
                                                   smem, st);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
