// Row-major copy of a strided 2-D table, for Hopper (sm_90a), and the
// atomic segment sum that the segment-sum bench sets beside it.
//
// copy_rows replaces the Pallas kernel of tools/bench_segment_sum.py::
// _force_row_major_u16: an identity copy of an (n, m) table in 1024-row
// blocks whose output is row-major whatever layout the producer left. On
// the TPU that anchored an XLA gather's layout; on a GPU it means: hand the
// row gather a table whose rows are contiguous. The input is read through
// its two strides (so a transposed view is taken as it is), the output is
// a fresh contiguous array.
//
// Design: one block of 256 threads per 1024 rows, as the TPU kernel's grid.
// A block's output is one contiguous range that starts on a 16-byte
// boundary (1024 rows x m elements x 2, 4 or 8 bytes), so each thread
// fills 16-byte vectors of consecutive output elements, reading each
// element through the strides, and stores them whole: writes are
// coalesced 16-byte stores for every row width; the last partial vector
// of the table is written element by element. Reads of a row-major input
// are contiguous too; reads of a transposed input are strided by n and
// lean on the caches (a block's 1024 rows are m runs of contiguous
// addresses). Bound by bytes: n x m elements read once and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 1024;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_rows_kernel(const T* __restrict__ in, T* __restrict__ out, long long n,
                 long long m, long long stride0, long long stride1) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte store
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long rows = min(static_cast<long long>(kRowsPerBlock), n - row0);
  const long long first = row0 * m;       // this block's first output element
  const long long count = rows * m;
  const long long vectors = count / kVec;

  for (long long v = threadIdx.x; v < vectors; v += kThreads) {
    const long long e0 = first + v * kVec;
    long long row = e0 / m;
    long long col = e0 - row * m;
    union { uint4 whole; T part[kVec]; } vec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      vec.part[k] = in[row * stride0 + col * stride1];
      if (++col == m) { col = 0; ++row; }
    }
    *reinterpret_cast<uint4*>(out + e0) = vec.whole;
  }
  for (long long e = first + vectors * kVec + threadIdx.x; e < first + count; e += kThreads) {
    const long long row = e / m;
    out[e] = in[row * stride0 + (e - row * m) * stride1];
  }
}

// out[ids[i], :] += rows[i, :], one thread per (slot, column): the
// per-Gaussian gradient sum as the backward compositing kernel does it
// inside itself. A helper of the segment-sum bench.
__global__ void segment_sum_atomic_kernel(const float* __restrict__ rows,
                                          const int* __restrict__ ids,
                                          float* __restrict__ out,
                                          long long n, int f) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * f) return;
  const long long slot = i / f;
  const int col = static_cast<int>(i - slot * f);
  atomicAdd(out + static_cast<long long>(ids[slot]) * f + col, rows[i]);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() of the launch; 0 means it was accepted.
// Strides are in elements; `out` must be 16-byte aligned.
extern "C" int copy_rows(const void* in, void* out, long long n, long long m,
                         long long stride0, long long stride1, int itemsize,
                         void* stream) {
  if (n == 0 || m == 0) return 0;
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 2:
      copy_rows_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out), n, m, stride0, stride1);
      break;
    case 4:
      copy_rows_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
          static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n, m, stride0, stride1);
      break;
    case 8:
      copy_rows_kernel<uint64_t><<<grid, kThreads, 0, s>>>(
          static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n, m, stride0, stride1);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_sum_atomic(const float* rows, const int* ids, float* out,
                                  long long n, int f, void* stream) {
  if (n == 0 || f == 0) return 0;
  const long long blocks = (n * f + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_atomic_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(rows, ids, out, n, f);
  return static_cast<int>(cudaGetLastError());
}
