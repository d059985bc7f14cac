// Flash attention for bfloat16 on Hopper's tensor cores (wgmma + TMA),
// bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel K4 of src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) for bfloat16 inputs with head dim
// 64 or 128; flash_attention.cu's float32-FMA kernel takes the other calls.
// It computes what _flash_kernel computes:
//   * scores s = (q . k^T) / sqrt(d) in float32 (products of bf16 values
//     summed in float32 by the tensor cores);
//   * NEG_INF = -1e30 wherever col > row (causal; absolute indices) and,
//     in this kernel, wherever col >= T (a ragged last key tile);
//   * a running (m, l, acc) in float32 per query row; key tiles past a
//     causal tile's last row are skipped;
//   * out = acc / max(l, 1e-20), rounded to bf16;
//   * query head h reads kv head h / group: K and V are never repeated.
// The tensor cores take bf16 operands, and the reference keeps p =
// exp(s - m) in float32 for the p . v product.  So p goes in as a bf16
// pair, hi = bf16(p) and lo = bf16(p - hi), in two products that add into
// the same float32 accumulator: hi + lo is p within 2^-16 p, where hi
// alone left up to 2^-8 p, which put early causal rows of outputs >= 4
// (few keys, each p weighing much) more than one bf16 step off the
// reference.  l sums the float32 p, as the reference does.  The scale
// is folded into exp2f with log2(e), so the running max lives in the log2
// domain.
//
// What bounds it on the H100: operations.  At the scoring path's shape
// (Hq = 128, Hkv = 16, S = T = 2048, d = 64, causal) it does ~6.9e10
// useful FLOP on ~75 MB of inputs and outputs, ~900 FLOP per byte, three
// times the card's bf16 ridge of ~295 FLOP per byte.  So both products run
// on the tensor cores (wgmma, 989 TFLOP/s dense bf16) and the tiles arrive
// by TMA, with no thread spending instructions on loads.
//
// Design: one CTA of 288 threads per (query head, 128 query rows), the
// heaviest causal tiles launched first.  Warps 0-7 are two consumer
// warpgroups that own 64 query rows each; warp 8 is the producer, one of
// whose threads issues every copy.  Q's tile is loaded once; 128-key tiles
// of K and V go through a ring of two stages, each with a K-full, a V-full
// and an empty mbarrier.  Every tile is stored as 64-column (128-byte) TMA
// boxes with the 128-byte swizzle, which is the layout the wgmma
// descriptors read (K-major for Q and K, MN-major for V, whose tile is
// [keys][d] row-major and is read through the descriptor's transpose).
// Per key tile, each consumer warpgroup:
//   1. S = Q K^T with m64n128k16 wgmmas from shared memory into 64 float32
//      registers per thread;
//   2. scale, mask (diagonal and ragged tiles only), row max over the 4
//      lanes of a row by two shuffles, exp2f, running l and the rescale of
//      acc -- all on the wgmma accumulator layout;
//   3. P as bf16 hi and lo parts in registers is the A operand of two
//      O += P V wgmmas per k-step (m64n{d}k16, B = V from shared memory):
//      the accumulator layout of S columns 16k..16k+15 is the A-fragment
//      layout of k-step k.  The lo product is a third more tensor work,
//      and at d = 128 its operand registers make ptxas spill a few words
//      under the 168-register cap of a 288-thread CTA;
//   4. one arrive per warp on the stage's empty barrier.
// Rows past T come back from TMA as zeros and are masked; rows past S are
// loaded as zeros and not stored.  Persistent CTAs, ping-pong between the
// warpgroups and overlap of softmax with the next tile's wgmma are later
// work.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                  // query rows per CTA
constexpr int kBN = 128;                  // keys per K/V tile
constexpr int kStages = 2;                // K/V ring depth
constexpr int kConsumers = 256;           // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32; // + the producer warp
constexpr int kBox = 64;                  // bf16 columns per 128-byte TMA box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// codes beyond cudaError_t's range
constexpr int kErrNoEncoder = 100000;
constexpr int kErrEncode = 100001;

// Shared memory of one CTA, in bytes from a 1024-aligned base: every tile
// starts on a 1024-byte boundary, as the 128-byte swizzle's 8-row atom
// needs, so the descriptors' base offset is 0.
template <int D>
struct Smem {
  static constexpr int kBoxes = D / kBox;      // 128-byte boxes per row
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;  // one K or one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, then per stage k_full, v_full, empty
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 3-D tensor map (x = column, y = row, z = head) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x),
        "r"(y), "r"(z) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.  K-major operands ignore
// the leading offset; their stride offset is the 1024 bytes between 8-row
// groups.  The MN-major V operand's leading offset steps from one 64-column
// box to the next, its stride offset from one 8-key group to the next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// (a, b) as two bf16 pairs, a in bits 0-15 of each: hi = bf16(a), bf16(b)
// and lo = the bf16 of what hi leaves (a - hi is exact in float32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d (64 x 128, f32) = A . B (+ d when scale_d): A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A . B: A (bf16 pairs) from registers, B from shared
// memory stored MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A . B: A (bf16 pairs) from registers, B from shared
// memory stored MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int Hq, int S, int T,
                   int group, int n_qt, int causal, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + 3 * s); };
  auto v_full = [&](int s) { return q_full + 8u * (2 + 3 * s); };
  auto empty = [&](int s) { return q_full + 8u * (3 + 3 * s); };

  // heaviest causal tiles first: block b takes row tile n_qt-1-b/Hq of
  // head b%Hq, so neighbouring blocks share kv heads in L2
  const int q0 = (n_qt - 1 - (int)blockIdx.x / Hq) * kBM;
  const int h = (int)blockIdx.x % Hq;
  int n_kt = (T + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (min(q0 + kBM, S) - 1) / kBN + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues copies
    if (tid == kConsumers) {
      const int hk = h / group;
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(sq + c * kBM * 128, &tq, q_full, c * kBox, q0, h);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        // the first round finds every stage free (parity of the phase
        // before the barrier's first)
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        const uint32_t kd = sk + s * L::kTileBytes, vd = sv + s * L::kTileBytes;
        mbar_expect_tx(k_full(s), L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(kd + c * kBN * 128, &tk, k_full(s), c * kBox, t * kBN, hk);
        mbar_expect_tx(v_full(s), L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(vd + c * kBN * 128, &tv, v_full(s), c * kBox, t * kBN, hk);
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows q0 + 64 wg .. + 63; in the wgmma
  // accumulator layout this thread holds rows r and r + 8 and, in each
  // 8-column group j, columns 8j + 2(lane % 4) + {0, 1}
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row_first = q0 + 64 * wg;
  const int r = row_first + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_wg = sq + wg * 64 * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    const uint32_t ph = (t / kStages) & 1;
    const int c0 = t * kBN;
    const uint32_t kt = sk + s * L::kTileBytes, vt = sv + s * L::kTileBytes;

    // 1. S = Q K^T: d / 16 k-steps, 32 bytes apart inside a 128-byte box
    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full(s), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = sw128_desc(q_wg + (kk / 4) * kBM * 128 + off, 16, 1024);
      const uint64_t db = sw128_desc(kt + (kk / 4) * kBN * 128 + off, 16, 1024);
      wgmma_ss_n128(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // 2. online softmax in the log2 domain; only a tile that crosses the
    // diagonal or the end of the keys is masked
    const bool edge = (causal && c0 + kBN - 1 > row_first) || c0 + kBN > T;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x0 = sc[4 * j + c] * scale_log2;
        float x1 = sc[4 * j + 2 + c] * scale_log2;
        if (edge) {
          const int col = c0 + 8 * j + cq + c;
          if (col >= T || (causal && col > r)) x0 = kNegInf;
          if (col >= T || (causal && col > r + 8)) x1 = kNegInf;
        }
        sc[4 * j + c] = x0;
        sc[4 * j + 2 + c] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // bf16 pairs of P's hi and lo parts: [2j] row r, [2j+1] row r+8
    uint32_t p_hi[kBN / 4], p_lo[kBN / 4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float e0 = exp2f(sc[4 * j] - mn0), e1 = exp2f(sc[4 * j + 1] - mn0);
      const float e2 = exp2f(sc[4 * j + 2] - mn1), e3 = exp2f(sc[4 * j + 3] - mn1);
      rs0 += e0 + e1;
      rs1 += e2 + e3;
      split_bf16(e0, e1, p_hi[2 * j], p_lo[2 * j]);
      split_bf16(e2, e3, p_hi[2 * j + 1], p_lo[2 * j + 1]);
    }
    l0 = l0 * a0 + rs0;  // this thread's part of the row sum
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }

    // 3. O += P_hi V + P_lo V: k-step kk takes S's column groups 2kk and
    // 2kk+1 as its A fragments and keys 16kk.. of V (16 rows of 128 bytes
    // per box)
    mbar_wait(v_full(s), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t db = sw128_desc(vt + kk * 16 * 128, kBN * 128, 1024);
      if constexpr (D == 64) {
        wgmma_rs_n64(acc, p_hi + 4 * kk, db);
        wgmma_rs_n64(acc, p_lo + 4 * kk, db);
      } else {
        wgmma_rs_n128(acc, p_hi + 4 * kk, db);
        wgmma_rs_n128(acc, p_lo + 4 * kk, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // 4. this warp is done with the stage
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-20f), den1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* o0 = o + ((size_t)h * S + r) * D + cq;
  __nv_bfloat16* o1 = o0 + (size_t)8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / den0, acc[4 * j + 1] / den0);
    if (r + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / den1, acc[4 * j + 3] / den1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, rows, d) bf16 row-major as a 3-D map of 64-column x box_rows boxes,
// 128-byte swizzle; reads past `rows` fill with zeros
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d, int rows,
           int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int hq,
           int hkv, int s, int t, int group, int causal, float sm_scale,
           void* stream) {
  using L = Smem<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  CUtensorMap tq, tk, tv;
  int rc = encode(fn, &tq, q, D, s, hq, kBM);
  if (rc == 0) rc = encode(fn, &tk, k, D, t, hkv, kBN);
  if (rc == 0) rc = encode(fn, &tv, v, D, t, hkv, kBN);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (s + kBM - 1) / kBM;
  const long long blocks = (long long)n_qt * hq;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<D><<<(unsigned)blocks, kThreads, L::kAlloc,
                          (cudaStream_t)stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq, s, t, group, n_qt,
      causal, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (hq, s, d), k and v (hkv, t, d), o (hq, s, d): contiguous bfloat16,
// 16-byte aligned; d is 64 or 128; s, t >= 1.  Returns 0 on success, else a
// cudaError_t code or one of this file's codes (see the error string).
int flash_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                    int hq, int hkv, int s, int t, int d, int group,
                    int causal, float sm_scale, void* stream) {
  if (group <= 0 || hq != hkv * group || s <= 0 || t <= 0)
    return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch<64>(q, k, v, o, hq, hkv, s, t, group, causal, sm_scale, stream);
  if (d == 128)
    return launch<128>(q, k, v, o, hq, hkv, s, t, group, causal, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

const char* flash_wgmma_error_string(int code) {
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
