// Torch ops over the toolchain probes of spike_elementwise.cu and spike.cu:
//
//   torch.ops.repro_spike.add(Tensor x, Tensor y) -> Tensor          (S1)
//   torch.ops.repro_spike.double_blocks(Tensor x) -> Tensor          (S2)
//   torch.ops.repro_spike.prng_bits(Tensor seed, int[] shape) -> Tensor
//                                                                    (S3)
//   torch.ops.repro_spike.column_sum(Tensor x) -> Tensor             (S4)
//
// Registered for CUDA tensors only; kernels/spike.py takes the plain
// versions for CPU tensors.  The checks, the device guard, the stream and
// the allocation run in C++ behind the dispatcher, so a call costs about
// what one of torch's own elementwise ops costs on the host.  A refused
// input raises ValueError in Python (TORCH_CHECK_VALUE) with the words of
// the CPU path's checks.  The file includes no Python and no
// torch/extension.h, so the host compiler builds it in seconds.
//
// The output comes from at::detail::empty_cuda, the CUDA caching
// allocator's tensor without the dispatcher, as torch's own elementwise
// kernels take theirs: at::empty_like would go through the dispatcher
// twice more (empty_like, then empty_strided), which on the card's host
// cost more than the rest of the call's overhead together.  It lives in
// libtorch_cuda, so the library links that too.

#include <ATen/core/Tensor.h>
#include <ATen/cuda/EmptyTensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

extern "C" {
cudaError_t spike_elementwise_add(const float* x, const float* y, float* o,
                                  long long n, cudaStream_t stream);
cudaError_t spike_elementwise_double(const float* x, float* o, long long n,
                                     cudaStream_t stream);
cudaError_t spike_prng(const int32_t* seed, int32_t* o, long long n,
                       cudaStream_t stream);
cudaError_t spike_column_sum(const float* x, float* o, long long rows,
                             long long cols, cudaStream_t stream);
}

namespace {

// the kernels' 32-bit indices: the elementwise probes' (with their grid
// stride) and the column sum's (spike_elementwise.cu, spike.cu)
constexpr int64_t kMaxElements = int64_t{1} << 30;
constexpr int64_t kMaxSumElements = (int64_t{1} << 31) - 1;

// A contiguous tensor of `sizes` and `dtype` on `device`
at::Tensor empty(at::IntArrayRef sizes, at::ScalarType dtype,
                 const at::Device& device) {
  return at::detail::empty_cuda(sizes, dtype, device, c10::nullopt);
}

// The CPU path's check (kernels/spike.py), in its words
void check_tensor(const char* name, const at::Tensor& t, at::ScalarType dtype,
                  int64_t dim) {
  TORCH_CHECK_VALUE(
      t.scalar_type() == dtype && t.dim() == dim && t.is_contiguous(), name,
      " must be a contiguous ", dim, "-d ", dtype == at::kFloat ?
      "torch.float32" : "torch.int32", " tensor, got ", t.scalar_type(), " ",
      t.sizes());
}

void check_float32(const char* name, const at::Tensor& t, int64_t dim) {
  check_tensor(name, t, at::kFloat, dim);
  TORCH_CHECK_VALUE(t.numel() <= kMaxElements, name, " has ", t.numel(),
                    " elements; the elementwise probes take at most 2^30");
}

at::Tensor add(const at::Tensor& x, const at::Tensor& y) {
  check_float32("x", x, x.dim());
  check_float32("y", y, x.dim());
  TORCH_CHECK_VALUE(x.sizes() == y.sizes() && x.device() == y.device(), "x ",
                    x.sizes(), " on ", x.device(), " and y ", y.sizes(),
                    " on ", y.device(), ": one shape, one device");
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = empty(x.sizes(), at::kFloat, x.device());
  C10_CUDA_CHECK(spike_elementwise_add(
      x.data_ptr<float>(), y.data_ptr<float>(), out.data_ptr<float>(),
      x.numel(), c10::cuda::getCurrentCUDAStream().stream()));
  return out;
}

at::Tensor double_blocks(const at::Tensor& x) {
  check_float32("x", x, 2);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = empty(x.sizes(), at::kFloat, x.device());
  C10_CUDA_CHECK(spike_elementwise_double(
      x.data_ptr<float>(), out.data_ptr<float>(), x.numel(),
      c10::cuda::getCurrentCUDAStream().stream()));
  return out;
}

at::Tensor prng_bits(const at::Tensor& seed, at::IntArrayRef shape) {
  check_tensor("seed", seed, at::kInt, 1);
  TORCH_CHECK_VALUE(seed.numel() == 1, "seed must hold one int32, got ",
                    seed.numel());
  for (const int64_t s : shape)
    TORCH_CHECK_VALUE(s >= 0, "shape ", shape, " has a negative size");
  const c10::cuda::CUDAGuard guard(seed.device());
  at::Tensor out = empty(shape, at::kInt, seed.device());
  C10_CUDA_CHECK(spike_prng(seed.data_ptr<int32_t>(),
                            out.data_ptr<int32_t>(), out.numel(),
                            c10::cuda::getCurrentCUDAStream().stream()));
  return out;
}

at::Tensor column_sum(const at::Tensor& x) {
  check_tensor("x", x, at::kFloat, 2);
  TORCH_CHECK_VALUE(x.numel() <= kMaxSumElements, "x has ", x.numel(),
                    " elements; the column sum takes at most 2^31 - 1");
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t cols = x.size(1);
  at::Tensor out = empty({1, cols}, at::kFloat, x.device());
  C10_CUDA_CHECK(spike_column_sum(
      x.data_ptr<float>(), out.data_ptr<float>(), x.size(0), cols,
      c10::cuda::getCurrentCUDAStream().stream()));
  return out;
}

}  // namespace

TORCH_LIBRARY(repro_spike, m) {
  m.def("add(Tensor x, Tensor y) -> Tensor");
  m.def("double_blocks(Tensor x) -> Tensor");
  m.def("prng_bits(Tensor seed, int[] shape) -> Tensor");
  m.def("column_sum(Tensor x) -> Tensor");
}

TORCH_LIBRARY_IMPL(repro_spike, CUDA, m) {
  m.impl("add", &add);
  m.impl("double_blocks", &double_blocks);
  m.impl("prng_bits", &prng_bits);
  m.impl("column_sum", &column_sum);
}
