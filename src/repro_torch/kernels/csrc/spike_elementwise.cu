// The elementwise toolchain probes S1 and S2 on Hopper, launched from the
// torch ops of spike_ops.cpp.
//
// Replace two Pallas TPU kernels of scripts/spike_pallas.py:
//   spike_elementwise_add     <- add_kernel (S1): o = x + y, float32
//   spike_elementwise_double  <- blk_kernel (S2): o = 2 x, float32; the
//                                Pallas grid of 128-row BlockSpec blocks
//                                is the TPU's way to stage VMEM and is not
//                                the launch shape here
//
// What bounds them on the H100: each moves 8-12 bytes per element and does
// one float operation, so at large n the bytes (3.35 TB/s of HBM) and at
// the spike's shapes (4 KB to 1 MB) the launch itself.  Neither reuses a
// byte, so TMA, wgmma and shared memory have nothing to offer.  The design
// keeps the launch cheap and the memory pipe full:
//   * 16-byte accesses: each thread loads and stores float4, neighbouring
//     threads on neighbouring addresses, when all pointers are 16-byte
//     aligned; a scalar pass in the same kernel takes the n % 4 tail, or
//     the whole call when a pointer is not aligned (a view at an odd
//     offset);
//   * a grid from the element count, capped at kBlocksPerSm CTAs per SM
//     (the SM count read once per device), with a grid-stride loop past
//     the cap;
//   * 32-bit indices and loops kept rolled, so a thread's one pass at the
//     spike's shapes starts at once; a call takes at most kMaxElements
//     (2^30) elements, which keeps every index and grid stride inside an
//     int (the binding refuses more).
// The results are bit for bit x + y and 2 x in float32 (one rounding, no
// contraction).

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr long long kMaxElements = 1LL << 30;

struct Add {
  __device__ float operator()(float x, float y) const { return x + y; }
};

struct Double {
  __device__ float operator()(float x, float) const { return 2.0f * x; }
};

// o[i] = op(x[i], y[i]) for i < n; y is read only when Op uses it (Double
// is given x twice and ignores the second).  n + the grid stride fits an
// int (n <= kMaxElements), so no 64-bit arithmetic is on the path; the
// loops are not unrolled: at the spike's shapes each thread makes one
// pass, and an unrolled loop would first compute its trip count with a
// division.
template <class Op>
__global__ void elementwise_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   float* __restrict__ o, int n, bool vec) {
  const Op op{};
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll 1
    for (int i = tid; i < n4; i += stride) {
      const float4 a = x4[i], b = y4[i];
      o4[i] = make_float4(op(a.x, b.x), op(a.y, b.y), op(a.z, b.z),
                          op(a.w, b.w));
    }
    done = n4 << 2;
  }
#pragma unroll 1
  for (int i = done + tid; i < n; i += stride) o[i] = op(x[i], y[i]);
}

template <class Op>
cudaError_t launch(const float* x, const float* y, float* o, long long n,
                   cudaStream_t stream) {
  if (n < 0 || n > kMaxElements) return cudaErrorInvalidValue;
  const bool vec = probe_grid::aligned16(x) && probe_grid::aligned16(y) &&
                   probe_grid::aligned16(o);
  const long long items = vec ? (n >> 2) + (n & 3) : n;
  const long long cap = (long long)probe_grid::sm_count() * kBlocksPerSm;
  long long blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks < cap ? blocks : cap);
  elementwise_kernel<Op><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, y, o, (int)n, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y, o: n float32 each on the current device, 0 <= n <= 2^30 (else
// cudaErrorInvalidValue); launches one kernel on `stream` (also for
// n == 0, when it writes nothing)
cudaError_t spike_elementwise_add(const float* x, const float* y, float* o,
                                  long long n, cudaStream_t stream) {
  return launch<Add>(x, y, o, n, stream);
}

cudaError_t spike_elementwise_double(const float* x, float* o, long long n,
                                     cudaStream_t stream) {
  return launch<Double>(x, x, o, n, stream);
}

}  // extern "C"
