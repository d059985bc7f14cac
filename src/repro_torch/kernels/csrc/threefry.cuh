// threefry2x32 (20 rounds) in registers: the word jax.random.bits (and
// repro_torch.random.bits) draws at flat index c of a key, in jax's
// partitionable mode.  Shared by the R-MAT kernels (rmat_sample.cu) and
// the probe kernels (spike.cu).
#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// x0 += x1 is written x0 * one + x1: with `one` a 1 that ptxas cannot see
// (a kernel argument) it stays one IMAD on the FMA pipe, where a plain add
// may be folded with the key injection before it into an IADD3, which
// only the alu pipe runs; with the literal 1 it is the plain add
#define TF_ROUND(r)   \
  x0 = x0 * one + x1; \
  x1 = rotl(x1, r);   \
  x1 ^= x0;

// w0 ^ w1 of threefry2x32 from the keyed counter words x0 = c_hi + k0 and
// x1 = c_lo + k1, with k2 = k0 ^ k1 ^ 0x1BD11BDA: the 20 rounds and the
// key injections after the first
__device__ __forceinline__ uint32_t threefry_keyed(uint32_t x0, uint32_t x1,
                                                   uint32_t k0, uint32_t k1,
                                                   uint32_t k2,
                                                   uint32_t one = 1u) {
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// w0 ^ w1 of threefry2x32((k0, k1), (c >> 32, c & 0xffffffff))
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint64_t c) {
  return threefry_keyed((uint32_t)(c >> 32) + k0, (uint32_t)c + k1, k0, k1,
                        k0 ^ k1 ^ 0x1BD11BDAu);
}

#undef TF_ROUND

}  // namespace threefry
