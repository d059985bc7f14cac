// Host-side launch helpers of the probe kernels (spike_elementwise.cu,
// spike.cu): the SM count a grid is capped by, and the 16-byte alignment
// that a vector pass needs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace probe_grid {

constexpr int kMaxDevices = 64;

// the current device's SM count, read once per device (132 if unknown)
inline int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  if (counts[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = sms > 0 ? sms : 132;
  }
  return counts[dev];
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Threads per CTA for `items` pieces of work: `most`, unless that would
// leave SMs idle; then as few whole warps as spread the items over every
// SM, so that few long items (S3's four threefry chains) are not issued
// by one SM's schedulers
inline int threads_for(long long items, int most) {
  const long long sms = sm_count();
  if (items >= sms * most) return most;
  const long long per_sm = (items + sms - 1) / sms;
  const int warps = (int)((per_sm + 31) / 32);
  return warps < 1 ? 32 : 32 * warps;
}

}  // namespace probe_grid
