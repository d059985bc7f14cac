// The toolchain probes S1-S4 on Hopper, bound to PyTorch through a plain C
// interface (ctypes).
//
// Replace the Pallas TPU kernels of scripts/spike_pallas.py, one for one:
//   spike_add          <- add_kernel   (S1): o = x + y, float32
//   spike_double       <- blk_kernel   (S2): o = 2 x over a grid of row
//                         blocks, one CTA per block as the BlockSpec cuts it
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
// What bounds them on the H100: at the spike's shapes (a few KB to 2 MB)
// the launch.  S1, S2 and S4 move a few bytes per element; S3 does ~70
// integer operations per 4-byte word.  Build without --use_fast_math.

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

__global__ void add_kernel(const float* __restrict__ x,
                           const float* __restrict__ y, float* __restrict__ o,
                           long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    o[i] = x[i] + y[i];
}

__global__ void double_kernel(const float* __restrict__ x,
                              float* __restrict__ o, long long block_elems) {
  const long long base = (long long)blockIdx.x * block_elems;
  for (long long i = threadIdx.x; i < block_elems; i += blockDim.x)
    o[base + i] = 2.0f * x[base + i];
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

int spike_add(const float* x, const float* y, float* o, long long n,
              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  add_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, y, o, n);
  return (int)cudaGetLastError();
}

// x and o are (n_blocks * block_rows, cols); one CTA per block of rows
int spike_double(const float* x, float* o, int n_blocks, int block_rows,
                 int cols, void* stream) {
  if (n_blocks <= 0 || block_rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  double_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, o, (long long)block_rows * cols);
  return (int)cudaGetLastError();
}

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
