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
//   * K2a makes one pass over the edges.  A group of G lanes (D rounded
//     up to a power of two, at most a warp) owns an edge; its lanes read
//     the message row with neighbouring lanes on neighbouring columns and
//     add it into a zeroed float32 [N, D] buffer with atomicAdd (a `red`
//     instruction: the sum is made in L2).  For bfloat16 a second kernel
//     rounds the buffer into the output.  The order of the atomic adds
//     changes from run to run, so the last bits of a float sum may too:
//     K2a is not bitwise repeatable.
//   * K2b gives each thread block a tile of block_n rows.  Row r's edges
//     are [offsets[r], offsets[r + 1]), so a tile reads only its own
//     edges (the block-sparse skip of the TPU kernel, at row instead of
//     block granularity).  A group of G lanes owns a row, and each lane
//     folds its columns over the row's edges in edge order, in registers,
//     and writes each output element once: no atomics, no zeroing, and
//     the same bits on every run.
// Not done here (later work): vector loads and stores for wide rows;
// folding runs of equal ids in a warp before the atomics of K2a; more
// lanes on a very long row of K2b (one lane folds a whole column of it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// K2a: one group of g lanes per edge, block_e edges per block.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
segsum_atomic_kernel(const T* __restrict__ msgs,
                     const int32_t* __restrict__ dst, float* __restrict__ acc,
                     long long n_edges, int n, int d, int block_e, int g) {
  const int groups = blockDim.x / g;
  const int lane = threadIdx.x % g;
  const long long e0 = (long long)blockIdx.x * block_e;
  const long long e1 = min(e0 + block_e, n_edges);
  for (long long e = e0 + threadIdx.x / g; e < e1; e += groups) {
    const int r = __ldg(dst + e);
    if ((unsigned)r >= (unsigned)n) continue;  // negative or >= N: dropped
    const T* row = msgs + e * d;
    float* out = acc + (long long)r * d;
    for (int c = lane; c < d; c += g) atomicAdd(out + c, to_f32(row[c]));
  }
}

// K2a's epilogue for bfloat16: round the float32 sums once.
__global__ void __launch_bounds__(kMaxThreads)
round_bf16_kernel(const float* __restrict__ acc,
                  __nv_bfloat16* __restrict__ out, long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    out[i] = __float2bfloat16_rn(acc[i]);
  }
}

// K2b: one group of g lanes per row, block_n rows per block.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
segsum_sorted_kernel(const T* __restrict__ msgs,
                     const int32_t* __restrict__ offsets, T* __restrict__ out,
                     int n, int d, int block_n, int g) {
  const int groups = blockDim.x / g;
  const int lane = threadIdx.x % g;
  const long long r0 = (long long)blockIdx.x * block_n;
  const long long r1 = min(r0 + block_n, (long long)n);
  for (long long r = r0 + threadIdx.x / g; r < r1; r += groups) {
    const long long e0 = __ldg(offsets + r);
    const long long e1 = __ldg(offsets + r + 1);
    for (int c = lane; c < d; c += g) {
      float sum = 0.0f;
      for (long long e = e0; e < e1; ++e) sum += to_f32(msgs[e * d + c]);
      store(out + r * d + c, sum);
    }
  }
}

// Lanes per edge or row: the columns rounded up to a power of two, at
// most a warp.
int col_lanes(int d) {
  int g = 1;
  while (g < d && g < 32) g <<= 1;
  return g;
}

// Threads per block for `items` edges or rows of g lanes each: whole
// warps, at most kMaxThreads.
int block_threads(int items, int g) {
  long long t = (long long)items * g;
  if (t > kMaxThreads) t = kMaxThreads;
  return (int)((t + 31) / 32 * 32);
}

}  // namespace

// C entry points, bound with ctypes.  dtype 0 = float32, 1 = bfloat16
// (msgs and out).  Return -1 for arguments the kernels do not take, else
// cudaGetLastError().

// K2a.  acc is a float32 [n, d] scratch buffer, zeroed here; for float32
// it may be out itself.
extern "C" int segsum_launch(const void* msgs, const void* dst, void* acc,
                             void* out, long long n_edges, int n, int d,
                             int block_e, int dtype, void* stream) {
  if (n_edges <= 0 || n <= 0 || d <= 0 || block_e <= 0) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long count = (long long)n * d;
  cudaError_t err = cudaMemsetAsync(acc, 0, count * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int g = col_lanes(d);
  const long long blocks = (n_edges + block_e - 1) / block_e;
  if (blocks > 0x7fffffffLL) return -1;
  const int threads = block_threads(block_e, g);
  const int32_t* ids = static_cast<const int32_t*>(dst);
  float* sums = static_cast<float*>(acc);
  if (dtype == 0) {
    segsum_atomic_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(msgs), ids, sums, n_edges, n, d, block_e,
        g);
    return (int)cudaGetLastError();
  }
  segsum_atomic_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(msgs), ids, sums, n_edges, n, d,
      block_e, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long want = (count + kMaxThreads - 1) / kMaxThreads;
  const unsigned grid = (unsigned)(want < 132 * 32 ? want : 132 * 32);
  round_bf16_kernel<<<grid, kMaxThreads, 0, st>>>(
      sums, static_cast<__nv_bfloat16*>(out), count);
  return (int)cudaGetLastError();
}

// K2b.  offsets [n + 1] int32, non-decreasing: row r sums msgs rows
// [offsets[r], offsets[r + 1]).
extern "C" int segsum_sorted_launch(const void* msgs, const void* offsets,
                                    void* out, int n, int d, int block_n,
                                    int dtype, void* stream) {
  if (n <= 0 || d <= 0 || block_n <= 0) return -1;
  const long long blocks = ((long long)n + block_n - 1) / block_n;
  if (blocks > 0x7fffffffLL) return -1;
  const int g = col_lanes(d);
  const int threads = block_threads(block_n, g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  if (dtype == 0) {
    segsum_sorted_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(msgs), off, static_cast<float*>(out), n, d,
        block_n, g);
  } else if (dtype == 1) {
    segsum_sorted_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, threads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(msgs), off,
            static_cast<__nv_bfloat16*>(out), n, d, block_n, g);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
