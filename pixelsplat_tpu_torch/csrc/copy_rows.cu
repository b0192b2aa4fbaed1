// Row-major copy of a strided 2-D table, for Hopper (sm_90a), and the
// atomic segment sum that the segment-sum bench sets beside it.
//
// copy_rows replaces the Pallas kernel of tools/bench_segment_sum.py::
// _force_row_major_u16: an identity copy of an (n, m) table in 1024-row
// blocks whose output is row-major whatever layout the producer left. On
// the TPU that anchored an XLA gather's layout; on a GPU it means: hand the
// row gather a table whose rows are contiguous. The output is a fresh
// contiguous array, 16-byte aligned.
//
// Bound by bytes: n x m elements read once and written once. The wrapper
// (ops/kernel_tools.py::copy_rows_route) picks one of three routes from the
// input's layout alone:
//
// - flat (row-major input, 16-byte aligned): a streaming copy of
//   n*m*itemsize bytes. Each block of 128 threads copies 16 KB, each
//   thread issuing its 8 independent 16-byte loads before its stores, so
//   enough bytes are in flight to cover HBM's latency; the grid covers the
//   table once (on an H100 this was faster than a grid-stride loop over 4
//   or 8 blocks per SM, and than 4 loads a thread in blocks of 256). The
//   last (n*m) % (16 / itemsize) elements go one by one.
// - column-major (stride0 == 1, stride1 >= n: each column is a contiguous
//   run, as a transposed view or a prefix sum along the short axis leaves
//   it): a tile of R rows x G columns (G = m unless that would not fit) is
//   staged through shared memory. Each column's R elements are read as one
//   contiguous run: 16-byte cp.async for its aligned body, element loads
//   for the unaligned head and tail (a column start that is not 16-byte
//   aligned, as with a leading dimension of 820,225, lands at the same
//   offset within its 16-byte slot in shared memory, so the body's copies
//   stay aligned at both ends). A column's slot is R + 16 / itemsize
//   elements long: the slack takes that offset and pads the tile, so
//   successive columns start four banks apart. The tile then leaves as one
//   contiguous run of R*m elements in 16-byte stores, each thread
//   gathering a vector's elements from the tile's columns. Each block
//   walks several tiles with two buffers: the next tile's cp.async copies
//   are in flight while this tile is written out.
// - general (anything else: sliced, padded rows, stride 0, unaligned): one
//   block of 256 threads per 1024 rows, as the TPU kernel's grid; each
//   thread fills 16-byte vectors of consecutive output elements, reading
//   each element through the two strides.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

// Route codes: the index of the route's name in
// ops/kernel_tools.py::COPY_ROUTES.
constexpr int kRouteGeneral = 0;
constexpr int kRouteFlat = 1;
constexpr int kRouteColumnMajor = 2;

int sm_count() {
  static int cached[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (device < 64 && cached[device] > 0) return cached[device];
  int count = 0;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  if (device < 64) cached[device] = count;
  return count;
}

// ---------------------------------------------------------------------------
// general

constexpr int kRowsPerBlock = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_general_kernel(const T* __restrict__ in, T* __restrict__ out, long long n,
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

// ---------------------------------------------------------------------------
// flat

constexpr int kFlatThreads = 128;
constexpr int kFlatUnroll = 8;
constexpr int kFlatTile = kFlatThreads * kFlatUnroll;  // 16-byte vectors a block copies

// Streaming hints: each byte is read once and written once, so neither
// should displace what the caches hold (ld/st .cs, evict first).
template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
copy_flat_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, long long vectors,
                 const T* __restrict__ in_tail, T* __restrict__ out_tail, int tail) {
  const long long v = static_cast<long long>(blockIdx.x) * kFlatTile + threadIdx.x;
  uint4 r[kFlatUnroll];
#pragma unroll
  for (int k = 0; k < kFlatUnroll; ++k) {
    if (v + k * kFlatThreads < vectors) r[k] = __ldcs(in + v + k * kFlatThreads);
  }
#pragma unroll
  for (int k = 0; k < kFlatUnroll; ++k) {
    if (v + k * kFlatThreads < vectors) __stcs(out + v + k * kFlatThreads, r[k]);
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) out_tail[threadIdx.x] = in_tail[threadIdx.x];
}

// ---------------------------------------------------------------------------
// column-major

constexpr int kTileBytes = 16384;  // one of a block's two tile buffers, at most
constexpr int kMaxTileRows = 1024;
constexpr int kMinTileRows = 32;
constexpr int kColumnBlocksPerSM = 4;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The shape of the tiles: R rows (a power of two) by G columns, each column
// in a slot of `pitch` = R + 16 / itemsize elements of shared memory.
struct ColumnTiles {
  const void* in;
  void* out;
  long long n;        // rows of the table
  long long ld;       // stride1: elements from one column's start to the next
  long long row_tiles;
  long long tiles;    // row_tiles x column groups
  int m;              // columns of the table
  int rows_log2;      // log2 R
  int group;          // G
  int pitch;          // R + 16 / itemsize
  int in_offset;      // (in / itemsize) % (16 / itemsize)
  int ld_mod;         // ld % (16 / itemsize)
};

template <typename T>
struct ColumnTile {
  static constexpr int kVec = 16 / sizeof(T);
  long long r0;
  int j0, rows, cols;

  __device__ ColumnTile(const ColumnTiles& p, long long tile) {
    const long long group_index = tile / p.row_tiles;
    r0 = (tile - group_index * p.row_tiles) << p.rows_log2;
    j0 = static_cast<int>(group_index) * p.group;
    rows = static_cast<int>(min(static_cast<long long>(1) << p.rows_log2, p.n - r0));
    cols = min(p.group, p.m - j0);
  }

  // Where element 0 of column j of the tile sits in its slot: the column
  // start's offset within its 16-byte slot (R is a multiple of kVec, so it
  // is the same for every tile of the column).
  static __device__ __forceinline__ int shift(const ColumnTiles& p, int j) {
    return (p.in_offset + j * p.ld_mod) & (kVec - 1);
  }

  // The 16-byte cp.async copies of each column's aligned body.
  __device__ void load_body(const ColumnTiles& p, T* buf) const {
    const T* in = static_cast<const T*>(p.in);
    const int slots_log2 = p.rows_log2 - (kVec == 8 ? 3 : kVec == 4 ? 2 : 1);  // R / kVec chunks a column
    const int chunks = cols << slots_log2;
    for (int idx = threadIdx.x; idx < chunks; idx += kThreads) {
      const int c = idx >> slots_log2;
      const int s = shift(p, j0 + c);
      const int i0 = ((kVec - s) & (kVec - 1)) + ((idx - (c << slots_log2)) * kVec);
      if (i0 + kVec <= rows) {
        cp_async_16(buf + c * p.pitch + s + i0, in + static_cast<long long>(j0 + c) * p.ld + r0 + i0);
      }
    }
  }

  // The unaligned head (before the first 16-byte boundary) and tail (after
  // the last) of each column, element by element.
  __device__ void load_edges(const ColumnTiles& p, T* buf) const {
    const T* in = static_cast<const T*>(p.in);
    for (int idx = threadIdx.x; idx < cols * 2 * kVec; idx += kThreads) {
      const int c = idx / (2 * kVec);
      const int e = idx - c * 2 * kVec;
      const int s = shift(p, j0 + c);
      const int head = (kVec - s) & (kVec - 1);
      const int body_end = rows > head ? head + ((rows - head) / kVec) * kVec : head;
      const int i = e < kVec ? (e < head ? e : rows) : body_end + e - kVec;
      if (i < rows) buf[c * p.pitch + s + i] = in[static_cast<long long>(j0 + c) * p.ld + r0 + i];
    }
  }

  __device__ __forceinline__ T at(const ColumnTiles& p, const T* buf, int i, int c) const {
    return buf[c * p.pitch + shift(p, j0 + c) + i];
  }

  __device__ void write_out(const ColumnTiles& p, const T* buf) const {
    T* out = static_cast<T*>(p.out);
    if (cols == p.m) {
      // The tile's rows are one contiguous, 16-byte aligned run of the output.
      T* run = out + r0 * p.m;
      const int count = rows * p.m;
      const int vectors = count / kVec;
      for (int v = threadIdx.x; v < vectors; v += kThreads) {
        const int e0 = v * kVec;
        int i = e0 / p.m;
        int c = e0 - i * p.m;
        union { uint4 whole; T part[kVec]; } vec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          vec.part[k] = at(p, buf, i, c);
          if (++c == p.m) { c = 0; ++i; }
        }
        *reinterpret_cast<uint4*>(run + e0) = vec.whole;
      }
      for (int e = vectors * kVec + threadIdx.x; e < count; e += kThreads) {
        const int i = e / p.m;
        run[e] = at(p, buf, i, e - i * p.m);
      }
    } else {
      // A column group: `rows` runs of `cols` elements, m apart.
      for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
        const int i = e / cols;
        const int c = e - i * cols;
        out[(r0 + i) * p.m + j0 + c] = at(p, buf, i, c);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) copy_column_major_kernel(const ColumnTiles p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const bufs = reinterpret_cast<T*>(smem_raw);
  const int buf_elems = p.group * p.pitch;
  long long tile = blockIdx.x;
  if (tile >= p.tiles) return;
  {
    const ColumnTile<T> first(p, tile);
    first.load_body(p, bufs);
    cp_async_commit();
    first.load_edges(p, bufs);
  }
  for (int b = 0; tile < p.tiles; tile += gridDim.x, b ^= 1) {
    const ColumnTile<T> current(p, tile);
    const long long next_index = tile + gridDim.x;
    T* const next_buf = bufs + (b ^ 1) * buf_elems;
    const bool has_next = next_index < p.tiles;
    const ColumnTile<T> next(p, has_next ? next_index : tile);
    if (has_next) next.load_body(p, next_buf);
    cp_async_commit();
    cp_async_wait_all_but_newest();  // this tile's copies have landed
    __syncthreads();
    current.write_out(p, bufs + b * buf_elems);
    if (has_next) next.load_edges(p, next_buf);
    __syncthreads();  // this buffer is read out before the next copies into it
  }
}

// ---------------------------------------------------------------------------
// launches

template <typename T>
int launch_copy(const void* in, void* out, long long n, long long m, long long stride0,
                long long stride1, int route, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (route == kRouteFlat) {
    const long long count = n * m;
    const long long vectors = count / kVec;
    const long long blocks = std::max((vectors + kFlatTile - 1) / kFlatTile, 1LL);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    copy_flat_kernel<T><<<static_cast<unsigned>(blocks), kFlatThreads, 0, s>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), vectors,
        static_cast<const T*>(in) + vectors * kVec, static_cast<T*>(out) + vectors * kVec,
        static_cast<int>(count - vectors * kVec));
  } else if (route == kRouteColumnMajor) {
    const int sms = sm_count();
    if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    if (m > 2147483647LL / kMaxTileRows) return static_cast<int>(cudaErrorInvalidValue);
    int rows_log2 = 10;  // log2 kMaxTileRows
    auto slot_bytes = [](int rows_log2) { return ((1 << rows_log2) + kVec) * static_cast<int>(sizeof(T)); };
    while ((1 << rows_log2) > kMinTileRows && m * slot_bytes(rows_log2) > kTileBytes) --rows_log2;
    const int pitch = (1 << rows_log2) + kVec;
    const int group = static_cast<int>(std::min(m, std::max(1LL, static_cast<long long>(kTileBytes / slot_bytes(rows_log2)))));
    ColumnTiles p;
    p.in = in;
    p.out = out;
    p.n = n;
    p.ld = stride1;
    p.row_tiles = (n + (1 << rows_log2) - 1) >> rows_log2;
    p.tiles = p.row_tiles * ((m + group - 1) / group);
    p.m = static_cast<int>(m);
    p.rows_log2 = rows_log2;
    p.group = group;
    p.pitch = pitch;
    p.in_offset = static_cast<int>((reinterpret_cast<uintptr_t>(in) / sizeof(T)) & (kVec - 1));
    p.ld_mod = static_cast<int>(stride1 & (kVec - 1));
    const long long blocks = std::min(p.tiles, static_cast<long long>(sms) * kColumnBlocksPerSM);
    const size_t smem = 2 * static_cast<size_t>(group) * pitch * sizeof(T);
    copy_column_major_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(p);
  } else {
    const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    copy_general_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n, m, stride0, stride1);
  }
  return static_cast<int>(cudaGetLastError());
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
// Strides are in elements; `out` must be 16-byte aligned; `route` is the
// wrapper's choice (kRoute*), and the flat route also needs `in` 16-byte
// aligned and row-major, the column-major one stride0 == 1.
extern "C" int copy_rows(const void* in, void* out, long long n, long long m,
                         long long stride0, long long stride1, int itemsize,
                         int route, void* stream) {
  if (n == 0 || m == 0) return 0;
  if (route != kRouteGeneral && route != kRouteFlat && route != kRouteColumnMajor) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 2: return launch_copy<uint16_t>(in, out, n, m, stride0, stride1, route, s);
    case 4: return launch_copy<uint32_t>(in, out, n, m, stride0, stride1, route, s);
    case 8: return launch_copy<uint64_t>(in, out, n, m, stride0, stride1, route, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
