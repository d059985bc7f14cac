// The toolchain probes S3 and S4 on Hopper, bound to PyTorch through a
// plain C interface (ctypes).  S1 and S2 are in spike_elementwise.cu.
//
// Replace two Pallas TPU kernels of scripts/spike_pallas.py:
//   spike_prng         <- prng_kernel  (S3): random bits from an int32 seed
//                         read inside the kernel
//   spike_column_sum   <- loop_kernel  (S4): (R, C) -> (1, C), each thread
//                         walks the rows 0..R-1 in order, as the fori_loop
//                         does, so the float32 sums are the loop's own
//
// S3's TPU kernel drew the TPU's hardware generator, which no other chip
// reproduces.  spike_prng computes in registers the threefry2x32 words of
// jax.random.bits(PRNGKey(seed), shape) (threefry.cuh, the words the R-MAT
// kernel rmat_prng draws), so its bits are those of a documented stream.
//
// What bounds them on the H100: at the spike's shapes (4 KB) the launch.
// S4 moves a few bytes per element; S3 does ~70 integer operations per
// 4-byte word.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void prng_kernel(const int32_t* __restrict__ seed,
                            int32_t* __restrict__ o, long long n) {
  // PRNGKey(seed) = (0, seed as uint32), as jax keys a 32-bit seed
  const uint32_t k1 = (uint32_t)seed[0];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    o[i] = (int32_t)threefry::threefry_word(0u, k1, (uint64_t)i);
}

__global__ void column_sum_kernel(const float* __restrict__ x,
                                  float* __restrict__ o, int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc += x[(size_t)r * cols + c];
  o[c] = acc;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code (0 = ok).

// seed: one int32 on the card
int spike_prng(const int32_t* seed, int32_t* o, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  prng_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(seed, o, n);
  return (int)cudaGetLastError();
}

int spike_column_sum(const float* x, float* o, int rows, int cols,
                     void* stream) {
  if (rows < 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  column_sum_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(x, o, rows, cols);
  return (int)cudaGetLastError();
}

const char* spike_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
