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
// millions of pairs) the popcount throughput, not device memory.  Each
// pair reads 8-12 bytes of ids and writes 4, and its W-word rows come
// from an index that fits in L2 (32.5 MB at Apache), while every word
// costs one __popc, which the SM executes at a quarter of its integer
// add rate.  What the design does about it:
//   * one group of G lanes (G = the row's 16-byte vectors, rounded up to
//     a power of two, at most a warp) owns a pair; its lanes stride over
//     the words, so a pair's rows are read with neighbouring lanes on
//     neighbouring addresses and no lane idles on a short row;
//   * 16-byte vector loads when W % 4 == 0 (every row then starts on a
//     16-byte boundary; the wrapper checks the base pointer); otherwise
//     one word per lane per step;
//   * the two or three rows are ANDed in registers and counted with
//     __popc: no [P, W] operand is ever written, and no SWAR arithmetic
//     (the TPU kernel's SWAR popcount existed for Pallas portability);
//   * each lane sums its words, the group folds the sums with an
//     xor-shuffle tree, and one lane writes: no atomics, no padding of P
//     or W, and no revisiting accumulator across word tiles.
// Not done here (later work): several pairs per lane to hide the gather
// latency, sorting the pairs by row so hot rows stay in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int popc4(int4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

__device__ __forceinline__ int4 and4(int4 x, int4 y) {
  return make_int4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}

// MODE 0: pre-gathered pairs (rows p of a and b).
// MODE 1: fused pairs (rows ea[p], eb[p] of bits; b unused).
// MODE 2: fused triples (rows ea[p], eb[p], ec[p] of bits).
// VEC: W % 4 == 0, rows read as int4.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
isect_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             const int32_t* __restrict__ ea, const int32_t* __restrict__ eb,
             const int32_t* __restrict__ ec, int32_t* __restrict__ out,
             int w, long long n_pairs, int g) {
  const int group = threadIdx.x / g;
  const int gl = threadIdx.x % g;
  const long long p = (long long)blockIdx.x * (kThreads / g) + group;
  int sum = 0;
  if (p < n_pairs) {
    const int32_t* ra;
    const int32_t* rb;
    const int32_t* rc = nullptr;
    if (MODE == 0) {
      ra = a + p * w;
      rb = b + p * w;
    } else {
      ra = a + (long long)__ldg(ea + p) * w;
      rb = a + (long long)__ldg(eb + p) * w;
      if (MODE == 2) rc = a + (long long)__ldg(ec + p) * w;
    }
    if (VEC) {
      const int nv = w >> 2;
      const int4* va = reinterpret_cast<const int4*>(ra);
      const int4* vb = reinterpret_cast<const int4*>(rb);
      const int4* vc = reinterpret_cast<const int4*>(rc);
      for (int i = gl; i < nv; i += g) {
        int4 x = and4(__ldg(va + i), __ldg(vb + i));
        if (MODE == 2) x = and4(x, __ldg(vc + i));
        sum += popc4(x);
      }
    } else {
      for (int i = gl; i < w; i += g) {
        int x = __ldg(ra + i) & __ldg(rb + i);
        if (MODE == 2) x &= __ldg(rc + i);
        sum += __popc(x);
      }
    }
  }
  // Groups tile the warp and every lane reaches the shuffles.
  for (int off = g >> 1; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(kFull, sum, off);
  }
  if (p < n_pairs && gl == 0) out[p] = sum;
}

// Lanes per pair: the row's vectors (or words), rounded up to a power of
// two, at most a warp.
int group_width(int w, bool vec) {
  const int units = vec ? (w >> 2) : w;
  int g = 1;
  while (g < units && g < 32) g <<= 1;
  return g;
}

template <int MODE>
int launch(const int32_t* a, const int32_t* b, const int32_t* ea,
           const int32_t* eb, const int32_t* ec, int32_t* out, int w,
           long long n_pairs, int vec, cudaStream_t stream) {
  if (w <= 0 || n_pairs <= 0) return -1;
  const int g = group_width(w, vec != 0);
  const long long per_block = kThreads / g;
  const long long blocks = (n_pairs + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return -1;
  const dim3 grid((unsigned)blocks);
  if (vec) {
    isect_kernel<MODE, true><<<grid, kThreads, 0, stream>>>(
        a, b, ea, eb, ec, out, w, n_pairs, g);
  } else {
    isect_kernel<MODE, false><<<grid, kThreads, 0, stream>>>(
        a, b, ea, eb, ec, out, w, n_pairs, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes.  `vec` = 1 takes 16-byte loads and
// needs w % 4 == 0 and 16-byte aligned rows.  Return -1 for arguments
// the kernel does not take, else cudaGetLastError().

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
  const int32_t* a = static_cast<const int32_t*>(ea);
  const int32_t* b = static_cast<const int32_t*>(eb);
  const int32_t* c = static_cast<const int32_t*>(ec);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == nullptr) {
    return launch<1>(bt, nullptr, a, b, nullptr, o, w, n_pairs, vec, st);
  }
  return launch<2>(bt, nullptr, a, b, c, o, w, n_pairs, vec, st);
}
