// y = 2 x on a contiguous f32 array, for Hopper (sm_90a): the toolchain's
// smoke test.
//
// Replaces the Pallas kernel `k` of tools/pallas_smoke.py (`o = x * 2` on
// one whole (256, 256) block). It proves that nvcc builds for this card,
// that the library loads through ctypes, and that a launch on PyTorch's
// stream reads and writes PyTorch's memory, in two seconds and with a
// clear line, before any larger kernel is trusted. One thread per element.
// Bound by bytes: 4 read and 4 written per element (0.5 MB at (256, 256),
// far below what fills the card, so its time is the launch's).

#include <cuda_runtime.h>

namespace {

__global__ void smoke_scale_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() of the launch; 0 means it was accepted.
extern "C" int smoke_scale(const float* x, float* y, long long n, void* stream) {
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  smoke_scale_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
