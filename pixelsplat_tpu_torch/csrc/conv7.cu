// K9: the epipolar transformer's two 7x7 refinement convolutions, for Hopper
// (sm_90a), as an implicit GEMM on the tensor cores in split precision.
//
// It replaces no Pallas kernel: the JAX package leaves these convolutions
// (`pixelsplat_tpu/model/encoder/epipolar/epipolar_transformer.py`,
// `upscale_refinement`) to XLA. In the port cuDNN ran them in float32 at a
// third of the card's FMA peak, 40 % of an evaluation scene.
//
// What it computes: stride 1, pad 3, channels-last float32 in and out,
//   out = act(conv(x, w) + bias) [+ residual],
// act the exact-erf GELU or none. As a GEMM, M = c_out, N = n h w output
// pixels, K = 49 c_in, both operands K-major.
//
// What bounds it: operations. A view at 256x256 with 128 -> 256 -> 128
// channels is 4.2e11 FLOP, against about 130 MB of memory traffic. Plain
// TF32 keeps 10 mantissa bits and fails the port's image limits, so every
// operand is split as hi = tf32(a), lo = tf32(a - hi) and the products
// lo*hi + hi*lo + hi*hi are summed in float32 ("3xTF32"): float32's
// accuracy at a third of the TF32 rate, 495 / 3 = 165 TFLOP/s.
//
// The design: one warpgroup a block computes 64 output channels by 128
// output pixels (8 wide, 16 tall) with wgmma m64n128k8: the weights are
// operand A, in registers, the pixels operand B, in shared memory. The
// block walks K as 16-channel chunks of the input, each against the 49
// taps. A chunk's halo patch (22 x 14 pixels) is read once, split into hi
// and lo as it is stored, and serves all 49 taps: a tap is the same patch
// seen through a descriptor whose start moves by (dy, dx) pixels, which
// works because the patch keeps 4 channels of a pixel in 16 bytes, so
// that 8 neighbouring pixels of a row are one core matrix. The weights
// come packed in the fragment order of A (`ops/conv7_kernel.py::
// pack_weight`), so a thread reads each tap's fragments as two 16-byte
// loads, two taps ahead, and splits them in registers.
//
// The tensor cores add into their accumulator rounding toward zero: a sum
// left there over all K = 49 c_in steps was 5e-5 of the output's RMS off
// float64, where cuDNN's float32 is 1.6e-6 off. So every 4 taps' 24
// products are summed from zero on the tensor cores and then added to the
// float32 sum by FADD, which rounds to nearest: 5.8e-7 off (4.4e-7 with
// every tap's, 20 % slower on an H100). The other block on the SM keeps
// the tensor cores busy while a block waits for its products.
//
// The epilogue adds the bias, applies the GELU or adds the residual, and
// writes channels-last; with grad enabled it also writes the
// pre-activation. TERMS = 1 builds the plain TF32 product (hi*hi only),
// which the card tests use to show that their tolerance tells the two
// apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 49;
constexpr int kTileW = 8;                      // output pixels a row of the tile
constexpr int kTileH = 16;                     // rows: N = 128 pixels
constexpr int kPatchW = kTileW + 6;
constexpr int kPatchH = kTileH + 6;
constexpr int kPatchPix = kPatchW * kPatchH;   // 308
constexpr int kChunk = 16;                     // input channels a chunk: 4 quads
constexpr int kQuadBytes = kPatchPix * 16;     // a quad's plane of the patch
constexpr int kPatchBytes = 4 * kQuadBytes;    // one of hi, lo
constexpr int kBlockM = 64;                    // output channels a block
constexpr int kThreads = 128;
constexpr int kMinBlocks = 2;                  // blocks an SM
constexpr int kFlushTaps = 4;                  // taps summed on the tensor cores between FADDs
constexpr int kSmemBytes = 2 * kPatchBytes;
// Descriptor strides of the pixel operand (K-major, no swizzle): between
// the two core matrices of a k8 step (the next quad plane), and between
// core matrices along N (the next row of 8 pixels).
constexpr uint32_t kLeadBytes = kQuadBytes;
constexpr uint32_t kStrideBytes = kPatchW * 16;

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 does; the low 13 bits come out zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint64_t descriptor(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLeadBytes >> 4) << 16) |
         (static_cast<uint64_t>(kStrideBytes >> 4) << 32);
}

// d (64 x 128 f32, this thread's 64) = a b + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.70710678118654752440f));
}

struct Args {
  const float* x;         // (n, h, w, cin)
  const float* w;         // packed: (cout / 16, cin / 16, 49, 2, 32, 4), A's fragment order
  const float* bias;      // (cout,)
  const float* residual;  // (n, h, w, cout) or null
  float* out;             // (n, h, w, cout)
  float* pre;             // (n, h, w, cout) pre-activation, or null
  int n, h, w_img, cin, cout, gelu;
};

// A chunk's halo patch, split into hi and lo: [quad][row][pixel][4] each,
// zeros outside the image; then made visible to the tensor cores.
__device__ __forceinline__ void load_patch(const Args& a, char* smem, int img, int y0, int x0, int chunk) {
  constexpr int kVecs = kPatchPix * 4;
  constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < kVecs) {
      const int pix = idx >> 2, q = idx & 3;
      const int py = pix / kPatchW, px = pix - py * kPatchW;
      const int y = y0 - 3 + py, x = x0 - 3 + px;
      if (y >= 0 && y < a.h && x >= 0 && x < a.w_img) {
        const float* src =
            a.x + ((static_cast<long long>(img) * a.h + y) * a.w_img + x) * a.cin + chunk * kChunk + q * 4;
        v[i] = __ldg(reinterpret_cast<const float4*>(src));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    if (idx < kVecs) {
      const int pix = idx >> 2, q = idx & 3;
      const int off = q * kQuadBytes + pix * 16;
      uint4 h, l;
      split(v[i].x, h.x, l.x);
      split(v[i].y, h.y, l.y);
      split(v[i].z, h.z, l.z);
      split(v[i].w, h.w, l.w);
      *reinterpret_cast<uint4*>(smem + off) = h;
      *reinterpret_cast<uint4*>(smem + kPatchBytes + off) = l;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int TERMS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) conv7_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // Blocks of one pixel tile are neighbours in launch order, so that its
  // patches are read from L2 after the first.
  const int blocks_m = a.cout / kBlockM;
  const int tiles_x = (a.w_img + kTileW - 1) / kTileW, tiles_y = (a.h + kTileH - 1) / kTileH;
  const int mb = blockIdx.x % blocks_m;
  int tile = blockIdx.x / blocks_m;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * kTileH, x0 = tx * kTileW;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  float acc[64], part[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.f;

  // This warp's 16 output channels' packed fragments: 2 k8 steps x 4
  // values a thread a tap, contiguous over the block's taps, read two taps
  // ahead of their use.
  const int chunks = a.cin / kChunk;
  const float4* wp = reinterpret_cast<const float4*>(a.w) +
                     (static_cast<long long>(mb * (kBlockM / 16) + warp) * chunks * kTaps * 2) * 32 + lane;
  const int iters = chunks * kTaps;
  float4 w0 = __ldg(wp), w1 = __ldg(wp + 32);
  float4 n0 = w0, n1 = w1;  // the next tap's
  if (iters > 1) n0 = __ldg(wp + 64), n1 = __ldg(wp + 96);

  int tap = 0, chunk = 0;
  for (int it = 0; it < iters; ++it) {
    if (tap == 0) {
      __syncthreads();  // every warp is done with the last chunk's patch
      load_patch(a, smem, img, y0, x0, chunk);
      __syncthreads();
    }
    uint32_t ah[2][4], al[2][4];
    split(w0.x, ah[0][0], al[0][0]);
    split(w0.y, ah[0][1], al[0][1]);
    split(w0.z, ah[0][2], al[0][2]);
    split(w0.w, ah[0][3], al[0][3]);
    split(w1.x, ah[1][0], al[1][0]);
    split(w1.y, ah[1][1], al[1][1]);
    split(w1.z, ah[1][2], al[1][2]);
    split(w1.w, ah[1][3], al[1][3]);
    w0 = n0, w1 = n1;
    if (it + 2 < iters) {
      n0 = __ldg(wp + (it + 2) * 64);
      n1 = __ldg(wp + (it + 2) * 64 + 32);
    }
    const int dy = tap / 7, dx = tap - dy * 7;
    const uint32_t at = smem_base + (dy * kPatchW + dx) * 16;
    const bool fresh = it % kFlushTaps == 0;  // `part` starts from zero
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t hi = descriptor(at + 2 * s * kQuadBytes);
      const int keep_d = (s == 0 && fresh) ? 0 : 1;
      if (TERMS == 3) {
        const uint64_t lo = descriptor(at + kPatchBytes + 2 * s * kQuadBytes);
        wgmma(part, al[s], hi, keep_d);
        wgmma(part, ah[s], lo, 1);
        wgmma(part, ah[s], hi, 1);
      } else {
        wgmma(part, ah[s], hi, keep_d);
      }
    }
    wgmma_commit();
    wgmma_wait();
    if ((it + 1) % kFlushTaps == 0 || it + 1 == iters) {
#pragma unroll
      for (int k = 0; k < 64; ++k) {
        keep(part[k]);
        acc[k] += part[k];
      }
    }
    if (++tap == kTaps) {
      tap = 0;
      ++chunk;
    }
  }

  // Epilogue: acc[4 j + e] holds channel 16 warp + g (+ 8 for e >= 2) at
  // tile row j, pixel 2 t (+ 1 for odd e).
  const int c_lo = mb * kBlockM + 16 * warp + g;
  const float bias_lo = a.bias[c_lo], bias_hi = a.bias[c_lo + 8];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int y = y0 + j;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = x0 + 2 * t + (e & 1);
      if (y >= a.h || x >= a.w_img) continue;
      const int c = c_lo + (e >> 1) * 8;
      const long long at = ((static_cast<long long>(img) * a.h + y) * a.w_img + x) * a.cout + c;
      float z = acc[4 * j + e] + ((e >> 1) ? bias_hi : bias_lo);
      if (a.pre != nullptr) a.pre[at] = z;
      if (a.gelu) z = gelu(z);
      if (a.residual != nullptr) z += a.residual[at];
      a.out[at] = z;
    }
  }
}

template <int TERMS>
int launch(const Args& a, cudaStream_t stream) {
  // The shared-memory opt-in, once a device.
  static bool configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || !configured[device]) {
    err = cudaFuncSetAttribute(conv7_kernel<TERMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) configured[device] = true;
  }
  const long long tiles =
      static_cast<long long>(a.n) * ((a.h + kTileH - 1) / kTileH) * ((a.w_img + kTileW - 1) / kTileW);
  const long long blocks = tiles * (a.cout / kBlockM);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  conv7_kernel<TERMS><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = act(conv7x7(x, w) + bias) [+ residual]. x (n, h, w, cin) and out
// (n, h, w, cout) channels-last float32; w packed by
// `conv7_kernel.pack_weight`; residual and pre may be null. cin a
// multiple of 16, cout of 64, pointers 16-byte aligned (the wrapper
// checks). terms 3: split precision; 1: plain TF32. Returns the CUDA error
// of the launch, 0 on success.
extern "C" int conv7(const float* x, const float* w, const float* bias, const float* residual, float* out,
                     float* pre, int n, int h, int w_img, int cin, int cout, int gelu, int terms, void* stream) {
  if (n == 0 || h == 0 || w_img == 0) return 0;
  if (cin <= 0 || cout <= 0 || cin % kChunk != 0 || cout % kBlockM != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, w, bias, residual, out, pre, n, h, w_img, cin, cout, gelu};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (terms == 3) return launch<3>(a, s);
  if (terms == 1) return launch<1>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
