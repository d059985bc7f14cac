// Flash attention (online softmax, causal or full, grouped-query) on Hopper,
// bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel K4 of src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel) and computes what it computes:
//   * q is cast to float32 and scaled by sm_scale before the product;
//   * s = q . k^T in float32, with NEG_INF = -1e30 wherever col > row
//     (causal; row and col are absolute indices in the sequence);
//   * a running (m, l, acc) in float32 per query row, with
//     alpha = exp(m_prev - m_cur), p = exp(s - m_cur),
//     l = l * alpha + sum(p), acc = acc * alpha + p . v;
//   * key tiles past the last row of a causal query tile are skipped;
//   * out = acc / max(l, 1e-20), cast to q's type;
//   * query head h reads kv head h / group: K and V are never repeated.
// q is (Hq, S, d), k and v are (Hkv, T, d), all contiguous, float32 or
// bfloat16; d is 16, 32, 64 or 128.
//
// What bounds it on the H100: operations.  At the scoring path's shape
// (Hq = 128, S = T = 2048, d = 64, bf16, causal) it does ~6.9e10 useful
// FLOP on ~75 MB of inputs and outputs, ~900 FLOP per byte, far above the
// card's ~295 FLOP/byte ridge.  This first version is simple and exact
// rather than fast: plain float32 FMAs, no tensor cores (the wgmma/TMA
// redesign is later work), so its ceiling is the 67 TFLOP/s float32 rate.
// Design: one CTA of 256 threads per (query head, 64 query rows), heaviest
// causal tiles launched first.  The CTA keeps q (pre-scaled) in shared
// memory and walks 64-key tiles of K and V staged through shared memory in
// float32.  Each thread owns a 4 x 4 block of the 64 x 64 score tile, read
// from transposed q and k tiles as two float4 loads per 16 FMAs; the
// online softmax runs in registers, with row max and row sum reduced over
// the 16 threads that share a row by warp shuffles.  p goes through shared
// memory (transposed) to the p . v product, where each thread owns 4 rows
// x d/16 columns of acc in registers.  Scores never touch device memory.
// Build without --use_fast_math: expf and the division are the accurate
// ones, so the result stays within float32 rounding of the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per CTA
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows 4ty.., tx cols 4tx..
constexpr int kLd = kBN + 4;   // row length of transposed tiles (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int D>
constexpr size_t smem_floats() {
  return 2 * D * kLd + kBN * D + kBN * kLd;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
             int group, int n_qt, int causal, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kLd] q * sm_scale
  float* kt = qt + D * kLd;                      // [D][kLd] k tile
  float* vs = kt + D * kLd;                      // [kBN][D] v tile
  float* pt = vs + kBN * D;                      // [kBN][kLd] p tile

  constexpr int DPT = D / 16;  // acc columns per thread: tx + 16 * jj
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kBM;
  const T* qh = q + (size_t)h * S * D;
  const T* kh = k + (size_t)(h / group) * Tk * D;
  const T* vh = v + (size_t)(h / group) * Tk * D;

  for (int idx = tid; idx < kBM * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const float x = q0 + r < S ? to_f32(qh[(size_t)(q0 + r) * D + c]) : 0.f;
    qt[c * kLd + r] = x * sm_scale;
  }

  float acc[4][DPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
  }

  int n_kt = (Tk + kBN - 1) / kBN;
  if (causal) {
    const int last_row = min(q0 + kBM, S) - 1;
    n_kt = min(n_kt, last_row / kBN + 1);
  }
  for (int t = 0; t < n_kt; ++t) {
    const int c0 = t * kBN;
    __syncthreads();  // q is staged; the last tile's readers are done
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = c0 + r < Tk;
      const size_t off = (size_t)(c0 + r) * D + c;
      kt[c * kLd + r] = in ? to_f32(kh[off]) : 0.f;
      vs[r * D + c] = in ? to_f32(vh[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        if (col >= Tk || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_cur);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_cur;
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * kLd + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) {
        const float vv = vs[c * D + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + ((size_t)h * S + row) * D;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) store(orow + tx + 16 * jj, acc[i][jj] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int hq,
           int s, int t, int group, int causal, float sm_scale,
           void* stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (s + kBM - 1) / kBM;
  const long long blocks = (long long)n_qt * hq;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_kernel<T, D><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, group, n_qt, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int hq, int s, int t, int group, int causal, float sm_scale,
             void* stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, hq, s, t, group, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, hq, s, t, group, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, hq, s, t, group, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, hq, s, t, group, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code (0 = ok).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int hq, int hkv, int s, int t, int d,
                        int group, int causal, float sm_scale, void* stream) {
  if (group <= 0 || hq != hkv * group || s <= 0 || t < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, hq, s, t, group, causal, sm_scale, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, hq, s, t, group, causal, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
