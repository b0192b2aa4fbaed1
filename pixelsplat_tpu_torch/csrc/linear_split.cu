// K10: the DINO ViT's four linear layers (qkv, proj, fc1, fc2 of each of its
// blocks), for Hopper (sm_90a), as a GEMM on the tensor cores in split
// precision.
//
// It replaces no Pallas kernel: the JAX package leaves these products
// (`pixelsplat_tpu/model/encoder/backbone/dino.py`) to XLA. In the port
// cuBLAS ran them in float32 on the FMA units, the largest block of device
// time left in an evaluation scene.
//
// What it computes: out = epi(x w^T + bias), x (m, k) and w (n, k) float32
// row-major (w is the `nn.Linear` weight as it is), out (m, n) row-major;
// epi is the identity, the exact-erf GELU (fc1), or the addition of a
// residual (m, n) (proj and fc2: the block's `x + ...`). Both operands are
// K-major, as the TF32 tensor-core products need, so nothing is repacked.
//
// What bounds it: operations. At ViT-B's widths a token costs 2 x 768 x
// 9216 FLOP a block against a few kB of memory traffic. Plain TF32 keeps
// 10 mantissa bits and fails the port's image limits, so each operand is
// split as hi + lo, both TF32, and lo*hi + hi*lo + hi*hi is summed in
// float32 ("3xTF32"): float32's accuracy at a third of the TF32 rate,
// 495 / 3 = 165 TFLOP/s.
//
// The design: a block computes 128 rows (two warpgroups of 64) by BN = 128
// or 64 columns with wgmma m64nBNk8. It walks K in stages of 32 (one
// 128-byte row of a tile, the span of the 128-byte swizzle) through a ring
// of 4 stages that thread 0 fills by TMA, one mbarrier a stage; rows past m
// arrive as zeros (TMA's out-of-bounds fill). The weight tile is operand B
// of both warpgroups. It serves as its own hi as it arrives, since the
// tensor cores read a float32 as TF32 by dropping its low 13 bits (hi =
// trunc(w)); all 256 threads write its lo = tf32(w - hi), rounded to
// nearest, into a second buffer. Each warpgroup reads its own 64 rows of x
// as operand A into registers and splits them there, hi = tf32(x) and lo =
// tf32(x - hi). No split copy of either goes to device memory. The threads
// split the next stage after issuing a stage's products; on an H100 the two
// add up rather than overlap (a TF32-only build saves only a third of the
// time), which with the rounds of blocks over the SMs holds K10 to 40-50 %
// of its bound at the ViT's shapes (PERF.md).
//
// The tensor cores add into their accumulator rounding toward zero: a sum
// left there over all of fc2's K = 3072 drifts far from float32 (K9, with K
// = 49 x 128, read 5e-5 of the output's RMS against 5.8e-7). So every 2
// stages' products (K = 64) are summed from zero on the tensor cores and
// then added to the float32 sum by FADD, which rounds to nearest.
//
// The epilogue adds the bias and applies the GELU or adds the residual,
// writing each thread's two neighbouring columns as one 8-byte store; with
// grad enabled it also writes the pre-activation. TERMS = 1 builds the plain
// TF32 product (hi*hi only), which the card tests use to show that their
// tolerance tells the two apart.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;             // rows a block: a warpgroup's 64 each
constexpr int kBlockK = 32;              // K a stage: 128 bytes of a row
constexpr int kSteps = kBlockK / 8;      // k8 products a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kFlushStages = 2;          // stages summed on the tensor cores between FADDs
constexpr int kABytes = kBlockM * kBlockK * 4;
constexpr int kSwizzleRow = kBlockK * 4;  // bytes a tile row, the swizzle's span

template <int BN>
struct Layout {
  static constexpr int kBBytes = BN * kBlockK * 4;
  // A stage: x's tile, the weight tile (its own hi), the weight's lo.
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  // The ring, 1024 bytes to align it (the swizzle's 8-row atom), one mbarrier a stage.
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 8 * kStages;
};

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 does; the low 13 bits come out zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The lo part of a float32 that serves as its own hi: tf32(a - trunc(a)).
__device__ __forceinline__ uint32_t lo_of_raw(uint32_t a) {
  return tf32(__uint_as_float(a) - __uint_as_float(a & 0xffffe000u));
}

// A K-major operand tile with the 128-byte swizzle: rows of 128 bytes,
// 8-row atoms 1024 bytes apart; a k8 step starts 32 bytes further on.
__device__ __forceinline__ uint64_t descriptor(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x BN f32, this thread's BN / 2) = a b + (scale_d ? d : 0).
template <int BN>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma<128>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
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

template <>
__device__ __forceinline__ void wgmma<64>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The (32 x rows) box at K offset k0, row r0 of `map`, into shared memory
// at dst, completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(r0)
      : "memory");
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.70710678118654752440f));
}

struct Args {
  const float* bias;      // (n,)
  const float* residual;  // (m, n) or null
  float* out;             // (m, n)
  float* pre;             // (m, n) pre-activation, or null
  int m, n, k, gelu;
};

template <int BN, int TERMS>
__global__ void __launch_bounds__(kThreads, 1)
    linear_split_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                        const Args a) {
  using L = Layout<BN>;
  extern __shared__ char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kStages * L::kStageBytes;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBlockM;
  const int stages = a.k / kBlockK;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Stage s: x's tile at x_at(s), the weight's tile (its hi) at hi_at(s) and
  // its lo after it.
  auto x_at = [&](int s) { return s * L::kStageBytes; };
  auto hi_at = [&](int s) { return s * L::kStageBytes + kABytes; };
  auto bar = [&](int s) { return bars + 8u * s; };
  const CUtensorMap* tiles_x = &map_x;
  const CUtensorMap* tiles_w = &map_w;
  auto fill = [&](int s, int kb) {
    mbar_expect(bar(s), kABytes + L::kBBytes);
    tma_load(base + x_at(s), tiles_x, bar(s), kb * kBlockK, m0);
    tma_load(base + hi_at(s), tiles_w, bar(s), kb * kBlockK, n0);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages && s < stages; ++s) fill(s, s);
  }

  // The lo parts of stage s's weight tile into its lo buffer, 16 bytes a
  // thread at a time, then made visible to the tensor cores.
  auto split_weights = [&](int s) {
    const char* hi = smem + hi_at(s);
    char* lo = smem + hi_at(s) + L::kBBytes;
#pragma unroll
    for (int i = 0; i < L::kBBytes / 16 / kThreads; ++i) {
      const int off = (tid + kThreads * i) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(hi + off);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(lo_of_raw(v.x), lo_of_raw(v.y), lo_of_raw(v.z), lo_of_raw(v.w));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // This thread's A fragments of stage s, split: for k8 step j, register e
  // holds row 16 warp + g (+ 8 for odd e) of its warpgroup's 64, column
  // 8 j + t (+ 4 for e >= 2), found through the swizzle (16-byte chunk c of
  // row r at chunk c ^ (r % 8); r % 8 is g for both rows).
  auto load_x = [&](int s, uint32_t (&fh)[kSteps][4], uint32_t (&fl)[kSteps][4]) {
    const float* row0 = reinterpret_cast<const float*>(smem + x_at(s) + (64 * wg + 16 * warp + g) * kSwizzleRow);
    const float* row1 = row0 + 8 * kBlockK;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int c0 = ((2 * j) ^ g) * 4 + t, c1 = ((2 * j + 1) ^ g) * 4 + t;
      split(row0[c0], fh[j][0], fl[j][0]);
      split(row1[c0], fh[j][1], fl[j][1]);
      split(row0[c1], fh[j][2], fl[j][2]);
      split(row1[c1], fh[j][3], fl[j][3]);
    }
  };

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t xh0[kSteps][4], xl0[kSteps][4], xh1[kSteps][4], xl1[kSteps][4];

  mbar_wait(bar(0), 0);
  split_weights(0);
  load_x(0, xh0, xl0);
  __syncthreads();

  // Stage kb's products from (xh, xl), then the next stage's split into
  // (nh, nl) while they run.
  auto step = [&](int kb, uint32_t (&xh)[kSteps][4], uint32_t (&xl)[kSteps][4], uint32_t (&nh)[kSteps][4],
                  uint32_t (&nl)[kSteps][4]) {
    const int s = kb % kStages;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const uint32_t hi = base + hi_at(s) + 32 * j;
      const uint64_t dh = descriptor(hi);
      const int keep_d = (j == 0 && kb % kFlushStages == 0) ? 0 : 1;  // `part` starts from zero
      if (TERMS == 3) {
        const uint64_t dl = descriptor(hi + L::kBBytes);
        wgmma<BN>(part, xl[j], dh, keep_d);
        wgmma<BN>(part, xh[j], dl, 1);
        wgmma<BN>(part, xh[j], dh, 1);
      } else {
        wgmma<BN>(part, xh[j], dh, keep_d);
      }
    }
    wgmma_commit();
    if (kb + 1 < stages) {
      const int s1 = (kb + 1) % kStages;
      mbar_wait(bar(s1), ((kb + 1) / kStages) & 1);
      split_weights(s1);
      wgmma_wait<1>();  // stage kb - 1's products, which read (nh, nl), are done
      load_x(s1, nh, nl);
    }
    if ((kb + 1) % kFlushStages == 0 || kb + 1 == stages) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        keep(part[i]);
        acc[i] += part[i];
      }
    }
    __syncthreads();  // the next stage is split by all; stage kb - 1 is read by none
    if (tid == 0 && kb >= 1 && kb - 1 + kStages < stages) fill((kb - 1) % kStages, kb - 1 + kStages);
  };
  for (int kb = 0; kb < stages; kb += 2) {
    step(kb, xh0, xl0, xh1, xl1);
    if (kb + 1 < stages) step(kb + 1, xh1, xl1, xh0, xl0);
  }

  // Epilogue: acc[4 j + e] holds row 16 warp + g (+ 8 for e >= 2) of the
  // warpgroup's 64, column 8 j + 2 t (+ 1 for odd e).
  const int r0 = m0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(a.bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= a.m) continue;
      const long long at = static_cast<long long>(row) * a.n + col;
      float z0 = acc[4 * j + 2 * h] + b.x, z1 = acc[4 * j + 2 * h + 1] + b.y;
      if (a.pre != nullptr) *reinterpret_cast<float2*>(a.pre + at) = make_float2(z0, z1);
      if (a.gelu) {
        z0 = gelu(z0);
        z1 = gelu(z1);
      }
      if (a.residual != nullptr) {
        const float2 r = *reinterpret_cast<const float2*>(a.residual + at);
        z0 += r.x;
        z1 += r.y;
      }
      *reinterpret_cast<float2*>(a.out + at) = make_float2(z0, z1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime once, so the
// library needs no link to libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, k) float32 matrix read as (32 x box_rows) tiles with
// the 128-byte swizzle; rows past the end read as zeros.
cudaError_t tile_map(CUtensorMap* map, const float* data, int rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 4};
  const cuuint32_t box[2] = {kBlockK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(data), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, int TERMS>
int launch(const float* x, const float* w, const Args& a, cudaStream_t stream) {
  // The shared-memory opt-in, once a device.
  static bool configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || !configured[device]) {
    err = cudaFuncSetAttribute(linear_split_kernel<BN, TERMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<BN>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) configured[device] = true;
  }
  CUtensorMap map_x, map_w;
  err = tile_map(&map_x, x, a.m, a.k, kBlockM);
  if (err == cudaSuccess) err = tile_map(&map_w, w, a.n, a.k, BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n / BN, (a.m + kBlockM - 1) / kBlockM);
  linear_split_kernel<BN, TERMS><<<grid, kThreads, Layout<BN>::kSmemBytes, stream>>>(map_x, map_w, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = epi(x w^T + bias): x (m, k), w (n, k), out (m, n) row-major float32;
// gelu 1 applies the exact GELU, residual (m, n) is added where not null,
// pre (m, n) receives x w^T + bias where not null. k a multiple of 32, n of
// block_n (128 or 64, the block's columns, which the wrapper chooses from
// the shape); x and w 16-byte aligned, bias, residual, out and pre 8-byte
// (the wrapper checks). terms 3: split precision; 1: plain TF32. Returns
// the CUDA error of the launch, 0 on success.
extern "C" int linear_split(const float* x, const float* w, const float* bias, const float* residual, float* out,
                            float* pre, int m, int n, int k, int gelu, int block_n, int terms, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || n <= 0 || k <= 0 || k % kBlockK != 0 || (block_n != 64 && block_n != 128) || n % block_n != 0 ||
      (m + kBlockM - 1) / kBlockM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{bias, residual, out, pre, m, n, k, gelu};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (terms == 3) return block_n == 128 ? launch<128, 3>(x, w, a, s) : launch<64, 3>(x, w, a, s);
  if (terms == 1) return block_n == 128 ? launch<128, 1>(x, w, a, s) : launch<64, 1>(x, w, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
