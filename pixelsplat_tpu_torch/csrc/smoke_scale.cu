// y = 2 x on a contiguous f32 array, for Hopper (sm_90a): the toolchain's
// smoke test.
//
// Replaces the Pallas kernel `k` of tools/pallas_smoke.py (`o = x * 2` on
// one whole (256, 256) block). It proves that nvcc builds for this card,
// that the library loads through ctypes, and that a launch on PyTorch's
// stream reads and writes PyTorch's memory, in two seconds and with a
// clear line, before any larger kernel is trusted.
//
// Bound by bytes: 4 read and 4 written per element (0.5 MB at (256, 256),
// 0.16 us at HBM rate, far below what fills the card), so a call's time is
// the host's: the wrapper's Python, the allocation and the launch. Design:
// - where x and y are 16-byte aligned, one thread per float4 (16-byte load
//   and store; 16,384 vectors, 64 blocks of 256 threads at (256, 256)),
//   the last n % 4 elements by the first threads of the grid; otherwise
//   one thread per element;
// - the launch goes straight to the driver's cuLaunchKernel with the
//   kernel's handle looked up once per device (reached through
//   cudaGetDriverEntryPoint, so nothing links libcuda), which skips the
//   runtime's per-launch work behind <<<...>>>.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
smoke_scale_vec_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long vectors = n / 4;
  if (i < vectors) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(y)[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
  if (i < n - vectors * 4) y[vectors * 4 + i] = x[vectors * 4 + i] * 2.0f;
}

__global__ void __launch_bounds__(kThreads)
smoke_scale_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

typedef CUresult (*LaunchKernel)(CUfunction, unsigned, unsigned, unsigned, unsigned, unsigned,
                                 unsigned, unsigned, CUstream, void**, void**);

struct Launcher {
  CUfunction vec = nullptr;
  CUfunction scalar = nullptr;
  LaunchKernel launch = nullptr;  // set last: non-null means ready
};

// The current device's launcher, set up on its first call; null on failure.
const Launcher* launcher() {
  static Launcher per_device[kMaxDevices];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return nullptr;
  Launcher& l = per_device[device];
  if (l.launch == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuLaunchKernel", &entry, 12000, cudaEnableDefault, &found) != cudaSuccess) {
      return nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuLaunchKernel", &entry, cudaEnableDefault, &found) != cudaSuccess) return nullptr;
#endif
    cudaFunction_t vec, scalar;
    if (found != cudaDriverEntryPointSuccess ||
        cudaGetFuncBySymbol(&vec, reinterpret_cast<const void*>(smoke_scale_vec_kernel)) != cudaSuccess ||
        cudaGetFuncBySymbol(&scalar, reinterpret_cast<const void*>(smoke_scale_kernel)) != cudaSuccess) {
      return nullptr;
    }
    l.vec = reinterpret_cast<CUfunction>(vec);
    l.scalar = reinterpret_cast<CUfunction>(scalar);
    l.launch = reinterpret_cast<LaunchKernel>(entry);
  }
  return &l;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns the launch's error code (a CUresult; that of cudaGetLastError()
// where the lookup failed); 0 means it was accepted.
extern "C" int smoke_scale(const float* x, float* y, long long n, void* stream) {
  if (n == 0) return 0;
  const Launcher* l = launcher();
  if (l == nullptr) {
    const int err = static_cast<int>(cudaGetLastError());
    return err != 0 ? err : static_cast<int>(cudaErrorInitializationError);
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long threads = aligned ? (n / 4 > 0 ? n / 4 : 1) : n;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &y, &n};
  return static_cast<int>(l->launch(aligned ? l->vec : l->scalar, static_cast<unsigned>(blocks), 1, 1, kThreads,
                                    1, 1, 0, static_cast<CUstream>(stream), args, nullptr));
}
