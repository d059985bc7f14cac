// The toolchain probes S3 and S4 on Hopper, launched from the torch ops of
// spike_ops.cpp.  S1 and S2 are in spike_elementwise.cu.
//
// Replace two Pallas TPU kernels of scripts/spike_pallas.py:
//   spike_prng         <- prng_kernel  (S3): random bits from an int32 seed
//                         read inside the kernel
//   spike_column_sum   <- loop_kernel  (S4): (R, C) -> (1, C), the rows
//                         added in order 0..R-1, as the fori_loop adds them,
//                         so the float32 sums are the loop's own
//
// S3's TPU kernel drew the TPU's hardware generator, which no other chip
// reproduces.  spike_prng computes in registers the threefry2x32 words of
// jax.random.bits(PRNGKey(seed), shape) (threefry.cuh, the words the R-MAT
// kernel rmat_prng draws), so its bits are those of a documented stream.
//
// What bounds them on the H100: at the spike's shapes (4 KB) the launch.
// At large shapes S4 moves 4 bytes per element and adds once (bytes, 3.35
// TB/s of HBM); S3 does 41 alu-only and 27 more integer operations per
// 4-byte word (operations, the alu pipe).  The design:
//   * S4: each thread owns 4 adjacent columns and reads one 16-byte float4
//     per row into 4 float32 accumulators, rows in order, the row loop
//     unrolled by kUnroll so that that many loads are in flight; adds
//     only, so nothing contracts into an FMA.  When x or the output is not
//     16-byte aligned (a view at an odd offset) or C % 4 != 0 (rows that
//     start off a 16-byte boundary), a scalar pass in the same kernel takes
//     the columns the vector pass does not.  The grid follows the column
//     count, one thread per 4 columns; indices are 32-bit, so a call takes
//     at most 2^31 - 1 elements (the binding refuses more).
//   * S3: each thread makes 4 consecutive words c..c+3, four independent
//     threefry chains that the scheduler interleaves, and writes them with
//     one 16-byte store; a scalar pass takes the n % 4 tail.  The grid
//     follows the word count: CTAs of kThreads or, for few words (the
//     spike's 1024), of as few warps as spread them over every SM: one
//     SM's schedulers issuing four chains for each of 256 threads take
//     longer than the launch itself; capped at kBlocksPerSm CTAs per SM
//     with a grid-stride loop past the cap.  Counters are 64-bit, as
//     jax's are.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 8;                    // S4 rows in flight a thread
constexpr long long kMaxSumElements = (1LL << 31) - 1;

// S3: o[c] = threefry word c of the key (0, seed) for c < n; with `vec`
// (o 16-byte aligned) four words a thread and a 16-byte store, else the
// scalar pass alone.
__global__ void prng_vec4_kernel(const int32_t* __restrict__ seed,
                                 int32_t* __restrict__ o, long long n,
                                 bool vec) {
  // PRNGKey(seed) = (0, seed as uint32), as jax keys a 32-bit seed
  const uint32_t k1 = (uint32_t)seed[0];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = vec ? n >> 2 : 0;
  int4* o4 = reinterpret_cast<int4*>(o);
#pragma unroll 1
  for (long long i = tid; i < n4; i += stride) {
    const uint64_t c = (uint64_t)i << 2;
    o4[i] = make_int4((int32_t)threefry::threefry_word(0u, k1, c),
                      (int32_t)threefry::threefry_word(0u, k1, c + 1),
                      (int32_t)threefry::threefry_word(0u, k1, c + 2),
                      (int32_t)threefry::threefry_word(0u, k1, c + 3));
  }
  for (long long c = (n4 << 2) + tid; c < n; c += stride)
    o[c] = (int32_t)threefry::threefry_word(0u, k1, (uint64_t)c);
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// S4: o[c] = x[0][c] + x[1][c] + ... + x[rows-1][c], added in that order.
// Threads 0..c4-1 each take columns 4t..4t+3 with float4 loads; the rest
// take one column each of cols - 4 c4 scalar columns.
__global__ void column_sum_vec4_kernel(const float* __restrict__ x,
                                       float* __restrict__ o, int rows,
                                       int cols, int c4) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < c4) {
    const float4* p = reinterpret_cast<const float4*>(x) + t;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int r = 0;
    for (; r + kUnroll <= rows; r += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = p[u * c4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add4(acc, v[u]);
      p += kUnroll * c4;
    }
#pragma unroll 1
    for (; r < rows; ++r, p += c4) add4(acc, *p);
    reinterpret_cast<float4*>(o)[t] = acc;
    return;
  }
  const int c = 4 * c4 + (t - c4);
  if (c >= cols) return;
  const float* p = x + c;
  float acc = 0.f;
#pragma unroll 1
  for (int r = 0; r < rows; ++r, p += cols) acc += *p;
  o[c] = acc;
}

}  // namespace

extern "C" {

// seed: one int32 on the current device; o: n int32 (n >= 0, else
// cudaErrorInvalidValue).  Launches one kernel on `stream` (also for
// n == 0, when it writes nothing).
cudaError_t spike_prng(const int32_t* seed, int32_t* o, long long n,
                       cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  const bool vec = probe_grid::aligned16(o);
  const long long items = vec ? (n >> 2) + (n & 3) : n;
  const int threads = probe_grid::threads_for(items, kThreads);
  const long long cap = (long long)probe_grid::sm_count() * kBlocksPerSm;
  long long blocks = (items + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks < cap ? blocks : cap);
  prng_vec4_kernel<<<(unsigned)blocks, threads, 0, stream>>>(seed, o, n,
                                                             vec);
  return cudaGetLastError();
}

// x: (rows, cols) float32 row-major, o: cols float32, both on the current
// device; rows, cols >= 0 and rows * cols <= 2^31 - 1 (else
// cudaErrorInvalidValue).  Launches one kernel on `stream` (also for
// cols == 0, when it writes nothing).
cudaError_t spike_column_sum(const float* x, float* o, long long rows,
                             long long cols, cudaStream_t stream) {
  if (rows < 0 || cols < 0 || (cols > 0 && rows > kMaxSumElements / cols))
    return cudaErrorInvalidValue;
  const bool vec =
      probe_grid::aligned16(x) && probe_grid::aligned16(o) && cols % 4 == 0;
  const long long c4 = vec ? cols / 4 : 0;
  const long long items = c4 + (cols - 4 * c4);
  long long blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : blocks;
  column_sum_vec4_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, o, (int)rows, (int)cols, (int)c4);
  return cudaGetLastError();
}

}  // extern "C"
