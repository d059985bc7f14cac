// R-MAT (stochastic Kronecker) edge sampling on Hopper: three kernels with
// one body, bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rmat_sample.py:
//   rmat_uniforms  <- rmat_sample_uniforms (_kernel_uniforms)
//   rmat_bits      <- rmat_sample_bits     (_kernel_bits, _bits_to_uniform)
//   rmat_prng      <- rmat_sample_prng     (_kernel_prng)
// and the shared core they run (_run_descend, src/repro/core/descend.py).
//
// What each edge computes: for each of L = max(n, m) levels, one uniform u
// and the level's (a, b, c); the square levels push one src bit
// (u >= a+b) and one dst bit ((a <= u < a+b) or u >= (a+b)+c), the extra
// levels only the marginal bit.  Ids above 31 bits are built as (hi, lo)
// int32 words, as the reference does, so outputs compare word for word.
//
// What bounds it on the H100:
//   * uniforms / bits: memory.  Each edge reads L 4-byte words and writes
//     2-4 int32 words, against a handful of compares per level.
//     Design: one thread per edge in a grid-stride loop; level ell reads
//     row ell of the (L, stride) input, so a warp's 32 loads of a level
//     are one contiguous 128-byte segment; the output words are written
//     the same way.  The level thresholds live in shared memory.
//   * prng: integer work.  The TPU kernel drew the TPU's hardware bits in
//     VMEM, which Hopper does not have.  This kernel computes in registers
//     (threefry.cuh)
//     the threefry2x32 word that rmat_bits would read from memory:
//     word (ell, e) = w0 ^ w1 of threefry2x32(key, (c >> 32, c & 0xffffffff))
//     with c = ell * stride + e, i.e. jax.random.bits(key, (L, stride)) in
//     jax's partitionable mode.  Its ids therefore equal rmat_bits's on
//     those bits, bit for bit; only the ids touch memory.  The bound is
//     integer work on the alu pipe: per level, threefry's 20 rotations
//     (one funnel shift each) and 21 xors run there alone, 64 lanes per
//     SM and clock; its 27 adds can also issue on the FMA pipe.
//
// The float sums are taken as the reference takes them, in float32:
// a + b, then (a + b) + c, and a + c.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kMaxLevels = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Source { kUniforms = 0, kBits = 1, kPrng = 2 };

__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

template <int SRC>
__global__ void __launch_bounds__(kThreads)
rmat_kernel(const float* __restrict__ thetas, const void* __restrict__ in,
            uint32_t k0, uint32_t k1, int n, int m, long long n_edges,
            long long stride, int32_t* __restrict__ src_hi,
            int32_t* __restrict__ src_lo, int32_t* __restrict__ dst_hi,
            int32_t* __restrict__ dst_lo) {
  // per level: a, a+b, (a+b)+c, a+c
  __shared__ float th[kMaxLevels][4];
  const int L = max(n, m);
  for (int ell = threadIdx.x; ell < L; ell += blockDim.x) {
    const float a = thetas[4 * ell], b = thetas[4 * ell + 1],
                c = thetas[4 * ell + 2];
    const float ab = a + b;
    th[ell][0] = a;
    th[ell][1] = ab;
    th[ell][2] = ab + c;
    th[ell][3] = a + c;
  }
  __syncthreads();

  const int lv_sq = min(n, m);
  const int n_hi = max(0, n - 31), m_hi = max(0, m - 31);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_edges; e += step) {
    uint32_t shi = 0, slo = 0, dhi = 0, dlo = 0;
    int si = 0, di = 0;
    for (int ell = 0; ell < L; ++ell) {
      const long long at = (long long)ell * stride + e;
      float u;
      if (SRC == kUniforms) {
        u = static_cast<const float*>(in)[at];
      } else if (SRC == kBits) {
        u = bits_to_unit(static_cast<const uint32_t*>(in)[at]);
      } else {
        u = bits_to_unit(threefry::threefry_word(k0, k1, (uint64_t)at));
      }
      int sb = -1, db = -1;
      if (ell < lv_sq) {
        sb = u >= th[ell][1];
        db = (u >= th[ell][0] && u < th[ell][1]) || u >= th[ell][2];
      } else if (n > m) {
        sb = u >= th[ell][1];
      } else {
        db = u >= th[ell][3];
      }
      if (sb >= 0) {
        if (si < n_hi) shi = shi * 2u + sb; else slo = slo * 2u + sb;
        ++si;
      }
      if (db >= 0) {
        if (di < m_hi) dhi = dhi * 2u + db; else dlo = dlo * 2u + db;
        ++di;
      }
    }
    if (src_hi) src_hi[e] = (int32_t)shi;
    src_lo[e] = (int32_t)slo;
    if (dst_hi) dst_hi[e] = (int32_t)dhi;
    dst_lo[e] = (int32_t)dlo;
  }
}

template <int SRC>
int launch(const float* thetas, const void* in, uint32_t k0, uint32_t k1,
           int n, int m, long long n_edges, long long stride, int32_t* sh,
           int32_t* sl, int32_t* dh, int32_t* dl, void* stream) {
  if (max(n, m) > kMaxLevels || n_edges <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n_edges + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rmat_kernel<SRC><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      thetas, in, k0, k1, n, m, n_edges, stride, sh, sl, dh, dl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rmat_uniforms(const float* thetas, const float* uniforms, int n, int m,
                  long long n_edges, long long stride, int32_t* src_hi,
                  int32_t* src_lo, int32_t* dst_hi, int32_t* dst_lo,
                  void* stream) {
  return launch<kUniforms>(thetas, uniforms, 0u, 0u, n, m, n_edges, stride,
                           src_hi, src_lo, dst_hi, dst_lo, stream);
}

int rmat_bits(const float* thetas, const uint32_t* bits, int n, int m,
              long long n_edges, long long stride, int32_t* src_hi,
              int32_t* src_lo, int32_t* dst_hi, int32_t* dst_lo,
              void* stream) {
  return launch<kBits>(thetas, bits, 0u, 0u, n, m, n_edges, stride, src_hi,
                       src_lo, dst_hi, dst_lo, stream);
}

int rmat_prng(const float* thetas, uint32_t k0, uint32_t k1, int n, int m,
              long long n_edges, long long stride, int32_t* src_hi,
              int32_t* src_lo, int32_t* dst_hi, int32_t* dst_lo,
              void* stream) {
  return launch<kPrng>(thetas, nullptr, k0, k1, n, m, n_edges, stride,
                       src_hi, src_lo, dst_hi, dst_lo, stream);
}

const char* rmat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
