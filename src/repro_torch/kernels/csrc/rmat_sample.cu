// R-MAT (stochastic Kronecker) edge sampling on Hopper, bound to PyTorch
// through a plain C interface (ctypes).
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
// The float sums are taken as the reference takes them, in float32:
// a + b, then (a + b) + c, and a + c.  Build without --use_fast_math.
//
// rmat_uniforms / rmat_bits (rmat_kernel): memory bounds them.  Each edge
// reads L 4-byte words and writes 2-4 int32 words, against a handful of
// compares per level.  One thread per edge in a grid-stride loop; level
// ell reads row ell of the (L, stride) input, so a warp's 32 loads of a
// level are one contiguous 128-byte segment; the output words are written
// the same way.  The level thresholds live in shared memory.
//
// rmat_prng (rmat_prng_kernel): integer work bounds it.  The TPU kernel
// drew the TPU's hardware bits in VMEM, which Hopper does not have.  This
// kernel computes in registers (threefry.cuh) the threefry2x32 word that
// rmat_bits would read from memory:
//   word (ell, e) = w0 ^ w1 of threefry2x32(key, (c >> 32, c & 0xffffffff))
// with c = ell * stride + e, i.e. jax.random.bits(key, (L, stride)) in
// jax's partitionable mode.  Its ids therefore equal rmat_bits's on those
// bits, bit for bit; only the ids touch memory (8-16 bytes an edge against
// L threefry blocks).  Per level threefry does 21 xors, which only the
// alu pipe runs (64 lanes per SM and clock), 30 adds, which either pipe
// runs (bounds.py counts 27, three-input folds allowed), and 20
// rotations: one alu funnel shift each, or two IMADs on the FMA pipe (64
// lanes; rotl(x, r) = hi(x * 2^r) + x * 2^r).  The four warp schedulers
// issue 128 lanes per SM and clock.  bounds.py's floor splits the
// rotations between the pipes at best, 36.3 alu and 36.3 FMA operations
// a level, which also fills the issue port.  This kernel keeps every
// rotation on the alu pipe (20 funnel shifts, 41 alu operations of
// threefry's own) plus three alu operations a square level, and puts the
// rest on the FMA pipe; a rotation moved there costs one issue slot more,
// and the issue port (~83 instructions a level) is then the limit.  It
// gives the schedulers independent work:
//   * Several edges a thread.  A thread owns kEdges = 8 consecutive edges
//     and runs their eight threefry chains level by level in one straight
//     run of code: each chain is a serial run of 20 add -> rotate -> xor
//     rounds, and eight independent ones keep both pipes fed (62 registers,
//     four CTAs of 256 an SM; the S3 probe, spike.cu, runs four).  The thread
//     writes each id word array with two 16-byte stores, and single stores
//     for a ragged last group; the launcher refuses outputs that are not
//     16-byte aligned (the wrapper's are fresh allocations).  A level's
//     threshold row is one 16-byte shared-memory load for all eight edges.
//   * Integer level thresholds, no float work.  The mantissa trick gives
//     u = (b >> 9) * 2^-23 exactly, so u >= t holds exactly when
//     k = b >> 9 >= T(t), T(t) = min(ceil(t * 2^23), 2^23) (0 for t <= 0;
//     2^23, which no 23-bit k reaches, also for NaN).  The prologue turns
//     each level's float32 a, a+b, (a+b)+c and the tail's marginal (a+b
//     for extra src levels, a+c for extra dst levels) into such thresholds
//     in shared memory, the first three sorted as A = min(Ta, Tab, Tabc)
//     <= B = Tab <= C = max(Tab, Tabc).  Then the src bit is k >= B, and
//     the dst bit, (k >= Ta && k < Tab) || k >= Tabc, equals [k >= A] -
//     [k >= B] + [k >= C], so its complement is the parity of k < A,
//     k < B, k < C: exact for every θ without NaN, in any order.  k is one
//     IMAD.HI (hi(b * 2^23)) and each k - T one IMAD, whose sign bit is
//     k < T; the parity is one 3-input xor and each id takes its
//     complemented bit by one funnel shift of a sign bit: three alu
//     operations and four FMA-pipe ones a square level (kernels/ref.py's
//     unit_threshold and rmat_prng_thresholds_ref mirror this on the CPU).
//   * Adds kept on the FMA pipe.  threefry's round add x0 += x1 is written
//     x0 * one + x1 with `one` a kernel argument (1): ptxas then issues an
//     IMAD, where it folded a plain add with the key injection before it
//     into an IADD3, which only the alu pipe runs.  The same `one` keeps
//     the threshold subtractions as IMADs, and 2^23 = one << 23 keeps
//     hi(b * 2^23) an IMAD.HI, not a shift.  Before this, the built SASS
//     held ~89 instructions an edge and level, 55 of them alu-only; now
//     ~83, 44 alu-only (chip_smoke.py logs the counts).
//   * No per-level branches.  The level loop is split into the square
//     segment [0, min(n, m)), which pushes both bits, and the one-sided
//     tail, which pushes the marginal bit into the side chosen once per
//     group.  Whether ids need hi words is a template parameter: narrow
//     ids (n, m <= 31, the main path) keep one 32-bit accumulator; wide
//     ones two words, complemented and cut to their levels after the last
//     level and split into (hi, lo) = (acc >> 31, acc & 0x7fffffff), which
//     is what pushing the first n - 31 bits into hi and the rest into lo
//     gives, wrap included.
//   * A counter carried, not rebuilt.  When L * stride <= 2^32 (the main
//     path's chunks, Fig. 8 and the generation cell) every counter's hi
//     word is 0, so x0 starts at k0 and the thread carries x1 = e + k1 +
//     ell * stride, one add of stride a level.  Wider counters (a template
//     parameter) carry the 64-bit counter instead.
//   * A grid from the card.  A launch with work for every resident thread
//     gets kThreads-thread CTAs, as many as the SMs hold at once
//     (sm_count times the kernel's occupancy), in a grid-stride loop over
//     groups of kEdges edges; a smaller one gets as few warps a CTA as
//     spread its groups over every SM (grid.cuh's threads_for).  A launch
//     whose groups of eight would not give each of an SM's four schedulers
//     one whole warp (fewer than sm_count * 128 groups, about 135 000
//     edges on an H100; most of the streamed path's chunks hold a few
//     thousand) runs one edge a thread instead, the same body with EDGES
//     = 1: there one warp would issue its eight chains alone on its
//     scheduler, where eight warps of one chain each share the card's
//     schedulers and overlap their latencies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "threefry.cuh"

namespace {

constexpr int kMaxLevels = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Source { kUniforms = 0, kBits = 1 };

__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

template <int SRC>
__global__ void __launch_bounds__(kThreads)
rmat_kernel(const float* __restrict__ thetas, const void* __restrict__ in,
            int n, int m, long long n_edges, long long stride,
            int32_t* __restrict__ src_hi, int32_t* __restrict__ src_lo,
            int32_t* __restrict__ dst_hi, int32_t* __restrict__ dst_lo) {
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
      } else {
        u = bits_to_unit(static_cast<const uint32_t*>(in)[at]);
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
int launch(const float* thetas, const void* in, int n, int m,
           long long n_edges, long long stride, int32_t* sh, int32_t* sl,
           int32_t* dh, int32_t* dl, void* stream) {
  if (max(n, m) > kMaxLevels || n_edges <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n_edges + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rmat_kernel<SRC><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      thetas, in, n, m, n_edges, stride, sh, sl, dh, dl);
  return (int)cudaGetLastError();
}

// ---- rmat_prng ----

// consecutive edges a thread of a launch that fills the card (a multiple
// of 4: whole 16-byte stores); a smaller launch runs one edge a thread
constexpr int kEdges = 8;
static_assert(kEdges % 4 == 0, "kEdges: whole 16-byte stores");
constexpr uint32_t kUnitSteps = 1u << 23;  // the 23-bit mantissas

// k = b >> 9 satisfies bits_to_unit(b) >= t exactly when k >= this
// threshold: t * 2^23 is exact (a power-of-two scale of a float32) and
// k * 2^-23 >= t holds for an integer k exactly when k >= ceil(t * 2^23)
__device__ __forceinline__ uint32_t unit_threshold(float t) {
  if (!(t < 1.0f)) return kUnitSteps;      // t >= 1 or NaN: never
  if (t <= 0.0f) return 0u;                // always
  return (uint32_t)ceilf(t * 8388608.0f);
}

// k = b >> 9 as hi(b * 2^23): one IMAD.HI on the FMA pipe, where a shift
// would take the alu pipe; `scale` (2^23) comes from a kernel argument so
// that ptxas cannot make it a shift
__device__ __forceinline__ uint32_t mantissa(uint32_t b, uint32_t scale) {
  return __umulhi(b, scale);
}

// The threefry words of one level for the thread's EDGES edges.  NARROW:
// every counter's hi word is 0, so x0 = k0 and the thread carries the
// keyed lo word x1 = e0 + k1 + ell * stride; else it carries the 64-bit
// counter e0 + ell * stride.
template <bool WIDE_CTR>
struct Counter;

template <>
struct Counter<false> {
  uint32_t x1;
  __device__ Counter(long long e0, uint32_t k1) : x1((uint32_t)e0 + k1) {}
  template <int EDGES>
  __device__ __forceinline__ void words(uint32_t (&w)[EDGES], uint32_t k0,
                                        uint32_t k1, uint32_t k2,
                                        uint32_t one) const {
#pragma unroll
    for (int j = 0; j < EDGES; ++j)
      w[j] = threefry::threefry_keyed(k0, x1 + j, k0, k1, k2, one);
  }
  __device__ __forceinline__ void next(long long stride) {
    x1 += (uint32_t)stride;
  }
};

template <>
struct Counter<true> {
  uint64_t c;
  __device__ Counter(long long e0, uint32_t) : c((uint64_t)e0) {}
  template <int EDGES>
  __device__ __forceinline__ void words(uint32_t (&w)[EDGES], uint32_t k0,
                                        uint32_t k1, uint32_t k2,
                                        uint32_t one) const {
#pragma unroll
    for (int j = 0; j < EDGES; ++j) {
      const uint64_t cj = c + j;
      w[j] = threefry::threefry_keyed((uint32_t)(cj >> 32) + k0,
                                      (uint32_t)cj + k1, k0, k1, k2, one);
    }
  }
  __device__ __forceinline__ void next(long long stride) {
    c += (uint64_t)stride;
  }
};

// An id's complemented bits, pushed at the low end: one funnel shift
// takes the sign bit of x (1 where the id's bit is 0).  WIDE: 64 bits in
// two words, for ids above 31 bits.
template <bool WIDE>
struct Bits;

template <>
struct Bits<false> {
  uint32_t lo = 0;
  __device__ __forceinline__ void push(uint32_t x) {
    lo = __funnelshift_l(x, lo, 1);
  }
  // the id of `bits` levels as its (hi, lo) int32 words (hi unused)
  __device__ __forceinline__ void id(int bits, int32_t& hi_w,
                                     int32_t& lo_w) const {
    hi_w = 0;
    lo_w = (int32_t)(~lo & ((1u << bits) - 1u));
  }
};

template <>
struct Bits<true> {
  uint32_t lo = 0, hi = 0;
  __device__ __forceinline__ void push(uint32_t x) {
    hi = __funnelshift_l(lo, hi, 1);
    lo = __funnelshift_l(x, lo, 1);
  }
  // (acc >> 31, acc & 0x7fffffff) of the id's `bits` levels: the first
  // bits - 31 pushed into hi and the rest into lo, wrap included
  __device__ __forceinline__ void id(int bits, int32_t& hi_w,
                                     int32_t& lo_w) const {
    const uint64_t acc = ~(((uint64_t)hi << 32) | lo);
    const uint64_t v = bits >= 64 ? acc : acc & ((1ull << bits) - 1ull);
    hi_w = (int32_t)(uint32_t)(v >> 31);
    lo_w = (int32_t)(uint32_t)(v & 0x7fffffffu);
  }
};

template <bool WIDE_IDS, int EDGES>
__device__ __forceinline__ void store(int32_t* hi, int32_t* lo,
                                      const Bits<WIDE_IDS> (&acc)[EDGES],
                                      int bits, long long e0, int valid) {
  int32_t w_hi[EDGES], w_lo[EDGES];
#pragma unroll
  for (int j = 0; j < EDGES; ++j) acc[j].id(bits, w_hi[j], w_lo[j]);
  if constexpr (EDGES % 4 == 0) {
    if (valid == EDGES) {
#pragma unroll
      for (int q = 0; q < EDGES; q += 4) {
        reinterpret_cast<int4*>(lo + e0 + q)[0] =
            make_int4(w_lo[q], w_lo[q + 1], w_lo[q + 2], w_lo[q + 3]);
        if (WIDE_IDS && hi)
          reinterpret_cast<int4*>(hi + e0 + q)[0] =
              make_int4(w_hi[q], w_hi[q + 1], w_hi[q + 2], w_hi[q + 3]);
      }
      return;
    }
  }
  for (int j = 0; j < valid; ++j) {
    lo[e0 + j] = w_lo[j];
    if (WIDE_IDS && hi) hi[e0 + j] = w_hi[j];
  }
}

template <bool WIDE_IDS, bool WIDE_CTR, int EDGES>
__global__ void __launch_bounds__(kThreads)
rmat_prng_kernel(const float* __restrict__ thetas, uint32_t k0, uint32_t k1,
                 int n, int m, long long n_edges, long long stride,
                 uint32_t one, int32_t* __restrict__ src_hi,
                 int32_t* __restrict__ src_lo, int32_t* __restrict__ dst_hi,
                 int32_t* __restrict__ dst_lo) {
  // per level, negated: A = min(Ta, Tab, Tabc), B = Tab, C = max(Tab,
  // Tabc) and the tail's marginal threshold.  With A <= B <= C the src
  // bit is k >= B and the dst bit, (k >= Ta && k < Tab) || k >= Tabc, is
  // [k >= A] - [k >= B] + [k >= C]: its complement is the parity of
  // k < A, k < B, k < C.
  __shared__ uint4 thr[kMaxLevels];
  const int L = max(n, m), lv_sq = min(n, m);
  const bool tail_src = n > m;
  for (int ell = threadIdx.x; ell < L; ell += blockDim.x) {
    const float a = thetas[4 * ell], b = thetas[4 * ell + 1],
                c = thetas[4 * ell + 2];
    const float ab = a + b;
    const uint32_t ta = unit_threshold(a), tab = unit_threshold(ab),
                   tabc = unit_threshold(ab + c);
    thr[ell] = make_uint4(0u - min(min(ta, tab), tabc), 0u - tab,
                          0u - max(tab, tabc),
                          0u - unit_threshold(tail_src ? ab : a + c));
  }
  __syncthreads();

  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t scale = one << 23;
  const long long groups = (n_edges + EDGES - 1) / EDGES;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += step) {
    const long long e0 = g * EDGES;
    Counter<WIDE_CTR> ctr(e0, k1);
    Bits<WIDE_IDS> s[EDGES], d[EDGES];
    uint32_t w[EDGES];
#pragma unroll 1
    for (int ell = 0; ell < lv_sq; ++ell) {
      ctr.words(w, k0, k1, k2, one);
      ctr.next(stride);
      const uint4 t = thr[ell];
#pragma unroll
      for (int j = 0; j < EDGES; ++j) {
        // k - T, one IMAD each: its sign bit is k < T (|k - T| <= 2^23)
        const uint32_t k = mantissa(w[j], scale);
        const uint32_t lt_b = k * one + t.y;
        s[j].push(lt_b);
        d[j].push((k * one + t.x) ^ lt_b ^ (k * one + t.z));
      }
    }
    // the tail pushes only the marginal bit, into the side chosen here
    Bits<WIDE_IDS> r[EDGES];
#pragma unroll
    for (int j = 0; j < EDGES; ++j) r[j] = tail_src ? s[j] : d[j];
#pragma unroll 1
    for (int ell = lv_sq; ell < L; ++ell) {
      ctr.words(w, k0, k1, k2, one);
      ctr.next(stride);
      const uint32_t t = thr[ell].w;
#pragma unroll
      for (int j = 0; j < EDGES; ++j)
        r[j].push(mantissa(w[j], scale) * one + t);
    }
#pragma unroll
    for (int j = 0; j < EDGES; ++j) {
      if (tail_src) s[j] = r[j]; else d[j] = r[j];
    }
    const long long left = n_edges - e0;
    const int valid = left < EDGES ? (int)left : EDGES;
    store<WIDE_IDS, EDGES>(src_hi, src_lo, s, n, e0, valid);
    store<WIDE_IDS, EDGES>(dst_hi, dst_lo, d, m, e0, valid);
  }
}

// CTAs of kThreads that one SM holds at once, per device (1 if unknown)
template <bool WIDE_IDS, bool WIDE_CTR, int EDGES>
int blocks_per_sm() {
  static int counts[probe_grid::kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 ||
      dev >= probe_grid::kMaxDevices)
    return 1;
  if (counts[dev] == 0) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, rmat_prng_kernel<WIDE_IDS, WIDE_CTR, EDGES>, kThreads, 0);
    counts[dev] = blocks > 0 ? blocks : 1;
  }
  return counts[dev];
}

template <bool WIDE_IDS, bool WIDE_CTR, int EDGES>
int launch_prng_edges(const float* thetas, uint32_t k0, uint32_t k1, int n,
                      int m, long long n_edges, long long stride,
                      int32_t* sh, int32_t* sl, int32_t* dh, int32_t* dl,
                      cudaStream_t stream) {
  const long long groups = (n_edges + EDGES - 1) / EDGES;
  const int threads = probe_grid::threads_for(groups, kThreads);
  long long blocks = (groups + threads - 1) / threads;
  const long long resident = (long long)probe_grid::sm_count() *
                             blocks_per_sm<WIDE_IDS, WIDE_CTR, EDGES>();
  if (blocks > resident) blocks = resident;
  rmat_prng_kernel<WIDE_IDS, WIDE_CTR, EDGES><<<(unsigned)blocks, threads, 0,
                                                stream>>>(
      thetas, k0, k1, n, m, n_edges, stride, 1u, sh, sl, dh, dl);
  return (int)cudaGetLastError();
}

// kEdges edges a thread when their groups give each of an SM's four warp
// schedulers a whole warp at least; below that, eight chains a thread
// would leave most schedulers idle while each ran its chains in series,
// so one edge a thread spreads the work over 8x as many warps
template <bool WIDE_IDS, bool WIDE_CTR>
int launch_prng(const float* thetas, uint32_t k0, uint32_t k1, int n, int m,
                long long n_edges, long long stride, int32_t* sh, int32_t* sl,
                int32_t* dh, int32_t* dl, cudaStream_t stream) {
  const long long groups = (n_edges + kEdges - 1) / kEdges;
  if (groups >= (long long)probe_grid::sm_count() * 4 * 32)
    return launch_prng_edges<WIDE_IDS, WIDE_CTR, kEdges>(
        thetas, k0, k1, n, m, n_edges, stride, sh, sl, dh, dl, stream);
  return launch_prng_edges<WIDE_IDS, WIDE_CTR, 1>(
      thetas, k0, k1, n, m, n_edges, stride, sh, sl, dh, dl, stream);
}

bool aligned_or_null(const void* p) {
  return p == nullptr || probe_grid::aligned16(p);
}

}  // namespace

extern "C" {

int rmat_uniforms(const float* thetas, const float* uniforms, int n, int m,
                  long long n_edges, long long stride, int32_t* src_hi,
                  int32_t* src_lo, int32_t* dst_hi, int32_t* dst_lo,
                  void* stream) {
  return launch<kUniforms>(thetas, uniforms, n, m, n_edges, stride, src_hi,
                           src_lo, dst_hi, dst_lo, stream);
}

int rmat_bits(const float* thetas, const uint32_t* bits, int n, int m,
              long long n_edges, long long stride, int32_t* src_hi,
              int32_t* src_lo, int32_t* dst_hi, int32_t* dst_lo,
              void* stream) {
  return launch<kBits>(thetas, bits, n, m, n_edges, stride, src_hi, src_lo,
                       dst_hi, dst_lo, stream);
}

// Outputs must be 16-byte aligned (else cudaErrorInvalidValue), as fresh
// allocations are; 0 <= n, m, max(n, m) <= 64, 0 < n_edges <= stride.
int rmat_prng(const float* thetas, uint32_t k0, uint32_t k1, int n, int m,
              long long n_edges, long long stride, int32_t* src_hi,
              int32_t* src_lo, int32_t* dst_hi, int32_t* dst_lo,
              void* stream) {
  const int L = max(n, m);
  if (min(n, m) < 0 || L > kMaxLevels || n_edges <= 0 || stride < n_edges ||
      !aligned_or_null(src_hi) || !aligned_or_null(dst_hi) ||
      !probe_grid::aligned16(src_lo) || !probe_grid::aligned16(dst_lo))
    return (int)cudaErrorInvalidValue;
  const bool wide_ids = n > 31 || m > 31;
  const bool wide_ctr = (long long)L * stride > (1LL << 32);
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide_ids)
    return wide_ctr ? launch_prng<true, true>(thetas, k0, k1, n, m, n_edges,
                                              stride, src_hi, src_lo, dst_hi,
                                              dst_lo, s)
                    : launch_prng<true, false>(thetas, k0, k1, n, m, n_edges,
                                               stride, src_hi, src_lo,
                                               dst_hi, dst_lo, s);
  return wide_ctr ? launch_prng<false, true>(thetas, k0, k1, n, m, n_edges,
                                             stride, src_hi, src_lo, dst_hi,
                                             dst_lo, s)
                  : launch_prng<false, false>(thetas, k0, k1, n, m, n_edges,
                                              stride, src_hi, src_lo, dst_hi,
                                              dst_lo, s);
}

const char* rmat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
