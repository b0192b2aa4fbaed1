// K11: MVSplat's stride-1 3x3 convolutions (the UniMatch CNN's, both U-Nets',
// the depth heads' and the Gaussian head's), for Hopper (sm_90a), as an
// implicit GEMM on the tensor cores in split precision.
//
// It replaces no Pallas kernel: the JAX package has no MVSplat encoder, and
// its convolutions elsewhere are left to XLA. In the port cuDNN ran these 87
// convolutions of an evaluation scene in float32 on the FMA units, 9 ms of
// device time a scene on an H100.
//
// What it computes: stride 1, pad 1, NCHW float32 in and out, as the modules
// hand them over,
//   out = act(conv(x, w) + bias),
// act the exact-erf GELU or none, bias optional. As a GEMM, M = the output
// pixels, N = c_out, K = 9 c_in, both operands K-major.
//
// What bounds it: operations. The scene's 87 convolutions are 227 GFLOP
// against a few hundred MB of memory traffic. Plain TF32 keeps 10 mantissa
// bits and fails the port's image limits, so every operand is split as hi =
// tf32(a), lo = tf32(a - hi) and lo*hi + hi*lo + hi*hi is summed in float32
// (`split_tf32.cuh`): float32's accuracy at a third of the TF32 rate, 495 /
// 3 = 165 TFLOP/s.
//
// The design, for the widths MVSplat has: c_out from 8 to 256, as narrow as
// 32 and as odd as 84 and 168; c_in as odd as 37 and 163. The pixels are
// operand A, so that a narrow c_out does not waste a 64-row tile: a
// warpgroup's product is 64 output pixels (4 rows of 16) by BN output
// channels, BN of 32, 64, 88 or 128, with c_out split over blocks, and K
// too where a small image leaves SMs idle (`conv3x3_plan` chooses by the
// shape and the SM count). K is walked as chunks of 8 input channels (one
// k8 step), each against the 9 taps.
//
// A block is three warpgroups. One reads: chunk by chunk, the halo patch
// from the NCHW input, 4 channels of a pixel into 16 bytes, split into hi
// and lo planes as it is stored, and the weights (c_out, c_in, 3, 3) from
// the module's own tensor, each (output channel, input channel) run of 9
// taps by one thread, split and stored as each tap's B tile, [quad][n][4],
// its quad planes padded so the stores hit every bank once; the c_in and
// c_out tails are zeros. No packed or split copy of either goes to device
// memory. Two compute, each on its own rows of the block's tile (MT = 2
// tiles each where BN is 32, else one): a tap's A fragments are 4 ldmatrix
// rows of 8 neighbouring pixels of the patch, shifted by (dy, dx) pixels.
// Two chunk buffers and named barriers (full, empty) let the reading of
// chunk k + 1 overlap the products of chunk k, and a computing warp reads
// the next tap's fragments while this tap's products run. On an H100 the
// reading was, before this, as long as the products at the widest tiles.
//
// Every 8 taps' products (24 per output, as K9's 4 taps of 16 channels) are
// summed from zero on the tensor cores and then added to the float32 sum by
// FADD.
//
// The epilogue adds the bias, applies the GELU, and writes NCHW: a warp's
// store covers 8 neighbouring pixels of 4 channels. terms = 1 runs the plain
// TF32 product (hi*hi only), which the card tests use to show that their
// tolerance tells the two apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace {

using namespace split_tf32;

constexpr int kConsumers = 2;                    // warpgroups computing; one more reads
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileW = 16;                       // output pixels a row of the block's tile
constexpr int kPatchW = kTileW + 2;
constexpr int kChunk = 8;                        // input channels a chunk: 2 quads, one k8 step
constexpr int kTaps = 9;
constexpr int kFlushTaps = 8;                    // taps summed on the tensor cores between FADDs
constexpr int kMaxWidth = 128;                   // output channels a block at most
// Named barriers: chunk buffer b is full (the reader has stored it) and
// empty (the computing warpgroups are done with it).
constexpr int kFull = 1, kEmpty = 3;

template <int BN>
struct Tile {
  static constexpr int kMT = BN <= 32 ? 2 : 1;                // 64-pixel tiles a computing warpgroup
  static constexpr int kTileH = 4 * kMT * kConsumers;
  static constexpr int kPatchPix = kPatchW * (kTileH + 2);
  static constexpr int kQuadBytes = kPatchPix * 16;           // a quad's plane of the patch
  static constexpr int kPatchBytes = 2 * kQuadBytes;          // one of hi, lo
  // A tap's B tile: [quad][n][4 channels], the quad planes 64 bytes apart
  // beyond the tile, so that a warp's 32 stores of (4 n, 8 channels) fall in
  // distinct banks.
  static constexpr int kWQuadBytes = BN * 16 + 64;
  static constexpr int kWTapBytes = 2 * kWQuadBytes;
  static constexpr int kWBytes = kTaps * kWTapBytes;          // one of hi, lo
  // A chunk's buffer: the patch's hi and lo, then the weights' hi and lo.
  static constexpr int kWAt = 2 * kPatchBytes;
  static constexpr int kBufBytes = kWAt + 2 * kWBytes;
  static constexpr int kSmemBytes = 2 * kBufBytes;
  // Weight runs (output channel, input channel) a reading thread stores,
  // all read at once.
  static constexpr int kRuns = BN * kChunk;
  static constexpr int kRunsPer = (kRuns + 127) / 128;
};

struct Args {
  const float* x;     // (n, cin, h, w)
  const float* w;     // (cout, cin, 3, 3), the module's own
  const float* bias;  // (cout,) or null
  float* out;         // (n, cout, h, w)
  float* partial;     // (splits, n, cout, h, w) where K is split, else null
  int n, cin, h, w_img, cout, gelu, terms, n_tiles, splits;
};

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// The chunk's weights into the hi and lo B tiles of each tap: run r of the
// block's (BN output channels x 8 input channels) is w[n0 + r / 8][c0 + r %
// 8][0..8], zeros past c_out or c_in; `p` is the reading thread.
template <int BN>
__device__ __forceinline__ void load_weights(const Args& a, char* wts, int c0, int n0, int p) {
  using T = Tile<BN>;
  float v[T::kRunsPer][kTaps];
#pragma unroll
  for (int j = 0; j < T::kRunsPer; ++j) {
    const int r = p + 128 * j;
    const int n = n0 + r / kChunk, c = c0 + r % kChunk;
    const bool live = r < T::kRuns && n < a.cout && c < a.cin;
    const float* src = a.w + (static_cast<long long>(n) * a.cin + c) * kTaps;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) v[j][tap] = live ? __ldg(src + tap) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < T::kRunsPer; ++j) {
    const int r = p + 128 * j;
    if (r >= T::kRuns) continue;
    const int n = r / kChunk, c = r % kChunk;
    const int off = (c >> 2) * T::kWQuadBytes + n * 16 + (c & 3) * 4;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      uint32_t hi, lo;
      split(v[j][tap], hi, lo);
      *reinterpret_cast<uint32_t*>(wts + tap * T::kWTapBytes + off) = hi;
      *reinterpret_cast<uint32_t*>(wts + T::kWBytes + tap * T::kWTapBytes + off) = lo;
    }
  }
}

// The chunk's halo patch into the hi and lo planes, [quad][patch pixel][4],
// zeros outside the image and past c_in; `p` is the reading thread.
template <int BN>
__device__ __forceinline__ void load_patch(const Args& a, char* patch, int img, int y0, int x0, int c0, int p) {
  using T = Tile<BN>;
  constexpr int kItems = 2 * T::kPatchPix;
  constexpr int kPer = (kItems + 127) / 128;
  const long long plane = static_cast<long long>(a.h) * a.w_img;
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = p + 128 * i;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < kItems) {
      const int q = idx / T::kPatchPix, pix = idx - q * T::kPatchPix;
      const int py = pix / kPatchW, px = pix - py * kPatchW;
      const int y = y0 - 1 + py, x = x0 - 1 + px;
      if (y >= 0 && y < a.h && x >= 0 && x < a.w_img) {
        const int c = c0 + 4 * q;
        const float* src =
            a.x + (static_cast<long long>(img) * a.cin + c) * plane + static_cast<long long>(y) * a.w_img + x;
        if (c < a.cin) v[i].x = __ldg(src);
        if (c + 1 < a.cin) v[i].y = __ldg(src + plane);
        if (c + 2 < a.cin) v[i].z = __ldg(src + 2 * plane);
        if (c + 3 < a.cin) v[i].w = __ldg(src + 3 * plane);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = p + 128 * i;
    if (idx < kItems) {
      const int q = idx / T::kPatchPix, pix = idx - q * T::kPatchPix;
      const int off = q * T::kQuadBytes + pix * 16;
      uint4 h, l;
      split(v[i].x, h.x, l.x);
      split(v[i].y, h.y, l.y);
      split(v[i].z, h.z, l.z);
      split(v[i].w, h.w, l.w);
      *reinterpret_cast<uint4*>(patch + off) = h;
      *reinterpret_cast<uint4*>(patch + T::kPatchBytes + off) = l;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_split_kernel(const Args a) {
  using T = Tile<BN>;
  constexpr int MT = T::kMT;
  extern __shared__ __align__(128) char smem[];
  const uint32_t smem_at = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // The blocks of one pixel tile's output channels and K splits are
  // neighbours in launch order, so that its patches are read from L2 after
  // the first.
  const int split_k = blockIdx.x % a.splits;
  const int nt = blockIdx.x / a.splits % a.n_tiles;
  int tile = blockIdx.x / a.splits / a.n_tiles;
  const int tiles_x = (a.w_img + kTileW - 1) / kTileW, tiles_y = (a.h + T::kTileH - 1) / T::kTileH;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * T::kTileH, x0 = tx * kTileW, n0 = nt * BN;
  // This block's chunks of K: split `split_k` of `splits`.
  const int all_chunks = (a.cin + kChunk - 1) / kChunk;
  const int per_split = (all_chunks + a.splits - 1) / a.splits;
  const int first = split_k * per_split;
  const int chunks = max(0, min(all_chunks - first, per_split));
  const int wg = threadIdx.x >> 7;

  if (wg == kConsumers) {
    // The reading warpgroup: each chunk, once its buffer is free, into it.
    const int p = threadIdx.x - 128 * kConsumers;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int buf = chunk & 1;
      if (chunk >= 2) named_sync(kEmpty + buf);
      char* at = smem + buf * T::kBufBytes;
      load_patch<BN>(a, at, img, y0, x0, (first + chunk) * kChunk, p);
      load_weights<BN>(a, at + T::kWAt, (first + chunk) * kChunk, n0, p);
      fence_proxy_async();
      named_arrive(kFull + buf);
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 4 * MT * wg;  // this warpgroup's first tile row

  // This lane's ldmatrix row: matrix lane / 8 is (quad lane / 16, pixels 0-7
  // or 8-15 of the warp's row); tile m's row row0 + 4 m + warp, tap (dy, dx)
  // further.
  const int mat = lane >> 3;
  const uint32_t lane_at =
      (mat >> 1) * T::kQuadBytes + ((row0 + warp) * kPatchW + (lane & 7) + 8 * (mat & 1)) * 16;

  float acc[MT][BN / 2], part[MT][BN / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[m][k] = 0.f;

  const int steps = chunks * kTaps;
  int step = 0;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int buf = chunk & 1;
    const uint32_t buf_at = smem_at + buf * T::kBufBytes;
    named_sync(kFull + buf);
    // Tap t's fragments, hi and lo, in set t % 2: the next tap's are read
    // while this tap's products run.
    uint32_t fh[2][MT][4], fl[2][MT][4];
    auto fragments = [&](int tap, uint32_t (&ah)[MT][4], uint32_t (&al)[MT][4]) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const uint32_t at = buf_at + lane_at + (dy * kPatchW + dx) * 16;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldmatrix_x4(at + m * 4 * kPatchW * 16, ah[m]);
        ldmatrix_x4(at + T::kPatchBytes + m * 4 * kPatchW * 16, al[m]);
      }
    };
    fragments(0, fh[0], fl[0]);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap, ++step) {
      const int f = tap & 1;
      const uint32_t w_hi = buf_at + T::kWAt + tap * T::kWTapBytes;
      const uint64_t bh = descriptor(w_hi, T::kWQuadBytes, 128);
      const uint64_t bl = descriptor(w_hi + T::kWBytes, T::kWQuadBytes, 128);
      const int keep_d = starts_partial(step, kFlushTaps) ? 0 : 1;  // `part` starts from zero
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (a.terms == 3) {
          wgmma_tf32<BN>(part[m], fl[f][m], bh, keep_d);
          wgmma_tf32<BN>(part[m], fh[f][m], bl, 1);
          wgmma_tf32<BN>(part[m], fh[f][m], bh, 1);
        } else {
          wgmma_tf32<BN>(part[m], fh[f][m], bh, keep_d);
        }
      }
      wgmma_commit();
      if (ends_partial(step, steps, kFlushTaps)) {
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < MT; ++m) flush(acc[m], part[m]);
      } else {
        wgmma_wait<1>();  // the last tap's products, which read the other set, are done
      }
      if (tap + 1 < kTaps) fragments(tap + 1, fh[f ^ 1], fl[f ^ 1]);
    }
    wgmma_wait<0>();  // every product that reads this buffer is done
    if (chunk + 2 < chunks) named_arrive(kEmpty + buf);
  }

  // Epilogue: acc[m][4 j + e] holds output channel n0 + 8 j + 2 t (+ 1 for
  // odd e) at tile row row0 + 4 m + warp, pixel g (+ 8 for e >= 2). A split
  // of K writes its sum alone, which `conv3x3_split_kernel_sum` adds up.
  const long long plane = static_cast<long long>(a.h) * a.w_img;
  const bool whole = a.splits == 1;
  float* const out = whole ? a.out : a.partial + split_k * (static_cast<long long>(a.n) * a.cout * plane);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 8 * j + 2 * t + h;
      if (n >= a.cout) continue;
      const float b = a.bias != nullptr && whole ? __ldg(a.bias + n) : 0.f;
      float* dst = out + (static_cast<long long>(img) * a.cout + n) * plane;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int y = y0 + row0 + 4 * m + warp;
        if (y >= a.h) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = x0 + g + 8 * half;
          if (x >= a.w_img) continue;
          float z = acc[m][4 * j + 2 * half + h] + b;
          if (a.gelu && whole) z = gelu(z);
          dst[static_cast<long long>(y) * a.w_img + x] = z;
        }
      }
    }
  }
}

// out = act(sum over the splits of partial + bias), where K was split.
__global__ void __launch_bounds__(256) conv3x3_split_kernel_sum(const Args a) {
  const long long plane = static_cast<long long>(a.h) * a.w_img;
  const long long total = static_cast<long long>(a.n) * a.cout * plane;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += static_cast<long long>(gridDim.x) * 256) {
    float z = 0.f;
    for (int s = 0; s < a.splits; ++s) z += a.partial[s * total + i];
    if (a.bias != nullptr) z += __ldg(a.bias + i / plane % a.cout);
    a.out[i] = a.gelu ? gelu(z) : z;
  }
}

template <int BN>
long long blocks_of(const Args& a) {
  using T = Tile<BN>;
  return static_cast<long long>(a.n) * ((a.h + T::kTileH - 1) / T::kTileH) * ((a.w_img + kTileW - 1) / kTileW) *
         a.n_tiles * a.splits;
}

template <int BN>
int launch(const Args& a, cudaStream_t stream) {
  using T = Tile<BN>;
  // The shared-memory opt-in, once a device.
  static bool configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || !configured[device]) {
    err = cudaFuncSetAttribute(conv3x3_split_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) configured[device] = true;
  }
  const long long blocks = blocks_of<BN>(a);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_split_kernel<BN><<<static_cast<unsigned>(blocks), kThreads, T::kSmemBytes, stream>>>(a);
  if (a.splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(a.n) * a.cout * a.h * a.w_img;
    const long long sum_blocks = (total + 255) / 256;
    conv3x3_split_kernel_sum<<<static_cast<unsigned>(sum_blocks < 4096 ? sum_blocks : 4096), 256, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

long long blocks_at(int width, const Args& a) {
  switch (width) {
    case 32: return blocks_of<32>(a);
    case 64: return blocks_of<64>(a);
    case 88: return blocks_of<88>(a);
    default: return blocks_of<kMaxWidth>(a);
  }
}

}  // namespace

// How an (n, cin, h, w) -> cout convolution is cut into blocks on `sms`
// SMs. The width: of 32, 64, 88 and 128 output channels those that waste at
// most 15 % of their columns (32 always qualifies), the one whose rounds of
// blocks over the SMs take the least time, a block's time taken as its
// pixels times its width plus 40 (its share that does not grow with the
// width), the wider on a tie; *n_tiles receives the blocks of output
// channels. Where the blocks still leave SMs idle, K is split over up to 8
// blocks (*splits), each with at least 2 chunks of 8 input channels, and a
// second kernel adds the splits up. Returns the width.
extern "C" int conv3x3_plan(int n, int cin, int h, int w_img, int cout, int sms, int* n_tiles, int* splits) {
  constexpr int kWidths[] = {kMaxWidth, 88, 64, 32};
  Args a{};
  a.n = n, a.h = h, a.w_img = w_img, a.splits = 1;
  int best = 32, best_tiles = (cout + 31) / 32;
  double best_cost = -1.0;
  for (int width : kWidths) {
    const int tiles = (cout + width - 1) / width;
    if (width != 32 && tiles * width > 1.15 * cout) continue;
    a.n_tiles = tiles;
    const long long rounds = (blocks_at(width, a) + sms - 1) / sms;
    const double cost = static_cast<double>(rounds) * (width <= 32 ? 2 : 1) * (width + 40);
    if (best_cost < 0 || cost < best_cost) best = width, best_tiles = tiles, best_cost = cost;
  }
  a.n_tiles = best_tiles;
  const long long blocks = blocks_at(best, a);
  const int chunks = (cin + kChunk - 1) / kChunk;
  long long k = blocks < sms ? sms / blocks : 1;
  k = k < 8 ? k : 8;
  k = k < chunks / 2 ? k : chunks / 2;
  if (n_tiles != nullptr) *n_tiles = best_tiles;
  if (splits != nullptr) *splits = k > 1 ? static_cast<int>(k) : 1;
  return best;
}

// out = act(conv3x3(x, w) + bias), stride 1, pad 1: x (n, cin, h, w) and out
// (n, cout, h, w) NCHW float32, w (cout, cin, 3, 3) float32 as the module
// holds it, bias (cout,) or null; gelu 1 applies the exact GELU. cout at
// least 8 (the wrapper checks). `sms` the device's SM count; `partial`
// holds conv3x3_plan's splits (when more than 1) times out's size, or is
// null. terms 3: split precision; 1: plain TF32. Returns the CUDA error of
// the launch, 0 on success.
extern "C" int conv3x3(const float* x, const float* w, const float* bias, float* out, float* partial, int n, int cin,
                       int h, int w_img, int cout, int gelu, int terms, int sms, void* stream) {
  if (n == 0 || h == 0 || w_img == 0) return 0;
  if (n < 0 || h < 0 || w_img < 0 || cin <= 0 || cout < 8 || sms <= 0 || (terms != 1 && terms != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int n_tiles = 1, splits = 1;
  const int width = conv3x3_plan(n, cin, h, w_img, cout, sms, &n_tiles, &splits);
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, out, partial, n, cin, h, w_img, cout, gelu, terms, n_tiles, splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 88: return launch<88>(a, s);
    default: return launch<kMaxWidth>(a, s);
  }
}
