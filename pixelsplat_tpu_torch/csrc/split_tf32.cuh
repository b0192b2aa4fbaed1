// Split-precision ("3xTF32") building blocks for the port's Hopper (sm_90a)
// kernels: each float32 operand a = hi + lo with hi = tf32(a) and lo =
// tf32(a - hi), both rounded to nearest, and lo*hi + hi*lo + hi*hi summed in
// float32 on the tensor cores. The tensor cores add into their accumulator
// rounding toward zero, so a kernel sums a fixed number of K steps from zero
// on the tensor cores (`part`) and then adds that partial sum into its
// float32 total by FADD, which rounds to nearest (`flush`).
//
// K11 (`conv3x3.cu`) is built on this header. K9 (`conv7.cu`) and K10
// (`linear_split.cu`) carry their own copies of the same helpers and can
// move onto it: `tf32`, `split`, `keep`, `gelu`, the wgmma fence, commit and
// wait, and `wgmma_tf32<N>` (m64nNk8, A from registers, B from shared
// memory by descriptor) for the widths below.

#pragma once

#include <stdint.h>

namespace split_tf32 {

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero, as
// cvt.rna.tf32.f32 does; the low 13 bits come out zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Whether step `step` of `steps` starts a partial sum from zero, and whether
// it ends one (then the partial sum is flushed), with a flush every `every`
// steps.
__device__ __forceinline__ bool starts_partial(int step, int every) { return step % every == 0; }
__device__ __forceinline__ bool ends_partial(int step, int steps, int every) {
  return (step + 1) % every == 0 || step + 1 == steps;
}

// An asm barrier on a register, so the compiler keeps its read after the
// wgmma wait that precedes it.
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// total += part, by FADD, once the products that wrote `part` are done.
template <int N>
__device__ __forceinline__ void flush(float (&total)[N], float (&part)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    keep(part[k]);
    total[k] += part[k];
  }
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.70710678118654752440f));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory made visible to the tensor cores'
// reads by descriptor.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Four 8x8 matrices of 16-bit values, each row 16 bytes: lane l gives the
// shared address of row l % 8 of matrix l / 8, and receives in r[i] the word
// (l / 4, l % 4) of matrix i, which for rows of 4 TF32 values is the A
// fragment layout of a k8 product.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A K-major operand in shared memory without swizzle: core matrices of 8
// rows of 16 bytes (4 TF32 values), `lead` bytes apart along K and `stride`
// bytes apart along M or N.
__device__ __forceinline__ uint64_t descriptor(uint32_t smem_addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32);
}

// d (64 x N f32, this thread's N / 2) = a b + (scale_d ? d : 0), a this
// warp's A fragment (rows 16 warp + g and + 8, columns t and t + 4), b a
// descriptor of the (N x 8) B tile; N of 32, 64, 88 (K11) and 128 (K9, K10
// and K11).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
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

template <>
__device__ __forceinline__ void wgmma_tf32<88>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, {%44, %45, %46, %47}, %48, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a, uint64_t b, int scale_d) {
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


}  // namespace split_tf32
