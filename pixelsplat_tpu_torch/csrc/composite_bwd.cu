// Backward of the tile compositing of depth-sorted Gaussians, for Hopper
// (sm_90a).
//
// Replaces pixelsplat_tpu/ops/rasterizer/pallas_backward.py::
// pallas_composite_bwd (the Pallas TPU kernel `_bwd_kernel`), together with
// what composite.py::_composite_packed_bwd does around it: the u16 row
// gather in front and the per-Gaussian sum of the per-slot gradients behind
// (tile_gather.py::segment_sum_rows, a sort-based stand-in for scatter-add).
// It computes the same function: for each 16x16 tile, walk the n_proc
// chunks the forward composited, last chunk first and each chunk's slots
// back to front, and per (slot i, pixel)
//   power, raw = opacity * exp(power), live = power <= 0 && raw >= 1/255,
//   alpha = live ? min(0.99, raw) : 0               (the forward's values)
//   T_i   = exp(log(max(T_end, 1e-30)) - sum_{j >= i} log1p(-alpha_j))
//   w     = alpha * T_i,   cg = colour . g
//   S_i   = gT * T_end + sum_{j > i} w_j * cg_j
//   d_alpha = T_i * cg - S_i / (1 - alpha), only where live and raw < 0.99
//   d_power = d_alpha * raw;  d_opacity = d_alpha * exp(power)
//   d_conic a/b/c = (-0.5 dx^2, -dx dy, -0.5 dy^2) * d_power
//   d_mean x/y = (a dx + b dy, c dy + b dx) * d_power;  d_colour_k = g_k * w
// summed over the tile's 256 pixels and added to the Gaussian's row of
// d_table. Chunks past n_proc contribute nothing, and neither does the
// sentinel row (the last one), which pad slots point at.
//
// Inputs: the (rows, 12) f32 table, flat int32 id list, block_start and
// counts of the forward (composite_fwd.cu), the forward's n_proc (T,) and
// final trans (T, 256), and the cotangents g_acc (T, 8, 256) (channels 0-5
// are read) and g_trans (T, 256). Output: d_table (rows, 12) f32, which the
// caller zero-fills; the kernel only adds to it.
//
// Design: one block per tile, one thread per pixel. Each thread carries
// log T and S as two scalars while it walks a chunk's shared-memory rows
// backward (the TPU kernel's triangular matmuls for the suffix sums, its
// u16 hi/lo row split and its double-buffered DMAs have no counterpart).
// The 12 per-slot partials are summed over a warp with 16 shuffles (a
// butterfly that halves the number of values each round), twelve lanes add
// one sum each to a (chunk, 12) accumulator in shared memory, and after the
// chunk the block adds that accumulator to d_table with one atomicAdd per
// (slot, column). A slot that no pixel of a warp sees (alpha == 0 in all
// 32 lanes) changes neither T, S nor any sum and is skipped by that warp.
// The atomics make the sums' order, and so their last bits, vary from run
// to run.
//
// Bound on this card: every processed (slot, pixel) pair costs about 74
// FP32 operations (the forward's 16 recomputed, 12 for colour . g, 10 for
// T, w, S and d_alpha, 24 for the twelve partials, 12 for their sums) plus
// two expf and one log1pf, so a training view of ~0.2-0.4M list slots is
// ~4-8 GFLOP against 67 TFLOP/s of FP32, ~0.07-0.1 ms; the bytes (table
// 18.9 MB, d_table 18.9 MB, ids, 2.9 MB of cotangents and T) take ~13 us
// at 3.35 TB/s. So it is compute-bound. What it takes in fact is set by
// its longest tile: a warp walks its tile's slots one after another
// (~200 instructions for a slot it sees), only 256 blocks of 8 warps are
// in flight, and the tile with the most chunks finishes last. Making it
// fast is later work: split a tile's slot range over several warps (a
// two-pass scan of log T and S), cp.async prefetch of the next chunk's
// rows, and cheaper log1pf/expf where accuracy allows.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kRow = 12;                // floats per table row
constexpr int kRowVec = kRow / 4;       // float4s per table row
constexpr int kMaxChunk = 128;
constexpr int kChPad = 8;               // cotangent channels per tile
constexpr int kColours = 6;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMinTrans = 1e-30f;
constexpr unsigned kFullMask = 0xffffffffu;

// Sums each of 16 per-lane values over the warp with 16 shuffles instead of
// 16 x 5: every round a lane keeps one half of its values, hands the other
// half to the lane whose index differs in one bit and adds what it gets
// back, so 16 values become 8, 4, 2, 1; a last exchange joins the two
// lanes that then hold the same value. Afterwards lane l holds the warp's
// total of value number l / 2.
__device__ __forceinline__ float warp_sum_16(float (&v)[16], int lane) {
#pragma unroll
  for (int half = 8; half >= 1; half >>= 1) {
    const int bit = half << 1;  // lane bits 16, 8, 4, 2
    const bool upper = (lane & bit) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float keep = upper ? v[k + half] : v[k];
      const float send = upper ? v[k] : v[k + half];
      v[k] = keep + __shfl_xor_sync(kFullMask, send, bit);
    }
  }
  return v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
}

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float4* __restrict__ table,
                     const int* __restrict__ flat,
                     const int* __restrict__ block_start,
                     const int* __restrict__ counts,
                     const int* __restrict__ n_proc,
                     const float* __restrict__ trans_end,
                     const float* __restrict__ g_acc,
                     const float* __restrict__ g_trans,
                     int tiles_x, int chunk, int sentinel,
                     float* __restrict__ d_table) {
  __shared__ float4 rows[kMaxChunk * kRowVec];
  __shared__ float d_rows[kMaxChunk * kRow];
  __shared__ int ids[kMaxChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const float px = static_cast<float>((t % tiles_x) * kTile + (p % kTile));
  const float py = static_cast<float>((t / tiles_x) * kTile + (p / kTile));
  // Never past the tile's own list, whatever n_proc says.
  const int chunks = min(n_proc[t], (counts[t] + chunk - 1) / chunk);
  const long long base = static_cast<long long>(block_start[t]) * chunk;

  float g[kColours];
  const float* g_in = g_acc + static_cast<long long>(t) * kChPad * kPixels + p;
#pragma unroll
  for (int k = 0; k < kColours; ++k) g[k] = g_in[k * kPixels];
  const float t_end = trans_end[static_cast<long long>(t) * kPixels + p];
  float log_t = logf(fmaxf(t_end, kMinTrans));
  float s_run = g_trans[static_cast<long long>(t) * kPixels + p] * t_end;

  for (int i = chunks - 1; i >= 0; --i) {
    const int* chunk_ids = flat + base + static_cast<long long>(i) * chunk;
    for (int e = p; e < chunk * kRowVec; e += kPixels) {
      const int slot = e / kRowVec;
      const int part = e - slot * kRowVec;
      rows[e] = __ldg(table + static_cast<long long>(__ldg(chunk_ids + slot)) * kRowVec + part);
    }
    for (int e = p; e < chunk; e += kPixels) ids[e] = __ldg(chunk_ids + e);
    for (int e = p; e < chunk * kRow; e += kPixels) d_rows[e] = 0.0f;
    __syncthreads();

    const float* r = reinterpret_cast<const float*>(rows);
    for (int c = chunk - 1; c >= 0; --c) {
      const float* q = r + c * kRow;
      const float dx = px - q[0];
      const float dy = py - q[1];
      const float power = -0.5f * (q[2] * dx * dx + q[4] * dy * dy) - q[3] * dx * dy;
      const float expp = expf(power);
      const float raw = q[5] * expp;
      const bool live = power <= 0.0f && raw >= kMinAlpha;
      // No pixel of this warp sees the slot: T, S and every sum stay.
      if (!__any_sync(kFullMask, live)) continue;
      const float alpha = live ? fminf(kMaxAlpha, raw) : 0.0f;

      log_t -= log1pf(-alpha);           // inclusive suffix: log T before slot c
      const float t_i = expf(log_t);
      const float w = alpha * t_i;
      float cg = 0.0f;
#pragma unroll
      for (int k = 0; k < kColours; ++k) cg += q[6 + k] * g[k];
      // Selects, not products with a 0/1 mask: an overflowed exp(power) of
      // a masked slot must not turn 0 * inf into NaN.
      const bool pass = live && raw < kMaxAlpha;
      const float d_alpha = pass ? t_i * cg - s_run / (1.0f - alpha) : 0.0f;
      s_run += w * cg;
      const float d_power = pass ? d_alpha * raw : 0.0f;

      float part[16];
      part[0] = (q[2] * dx + q[3] * dy) * d_power;  // d mean x
      part[1] = (q[4] * dy + q[3] * dx) * d_power;  // d mean y
      part[2] = -0.5f * dx * dx * d_power;          // d conic a
      part[3] = -dx * dy * d_power;                 // d conic b
      part[4] = -0.5f * dy * dy * d_power;          // d conic c
      part[5] = pass ? d_alpha * expp : 0.0f;       // d opacity
#pragma unroll
      for (int k = 0; k < kColours; ++k) part[6 + k] = g[k] * w;
#pragma unroll
      for (int k = kRow; k < 16; ++k) part[k] = 0.0f;
      const float sum = warp_sum_16(part, lane);
      // Lanes 0, 2, ..., 22 hold the sums of columns 0..11.
      if ((lane & 1) == 0 && (lane >> 1) < kRow) atomicAdd(&d_rows[c * kRow + (lane >> 1)], sum);
    }
    __syncthreads();

    for (int e = p; e < chunk * kRow; e += kPixels) {
      const int slot = e / kRow;
      const int id = ids[slot];
      const float v = d_rows[e];
      if (id < sentinel && v != 0.0f)
        atomicAdd(d_table + static_cast<long long>(id) * kRow + (e - slot * kRow), v);
    }
    __syncthreads();  // before rows, ids and d_rows are overwritten
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() of the launch; 0 means it was accepted.
// `rows` is the table's row count; its last row is the sentinel.
extern "C" int composite_bwd(const float* table, const int* flat,
                             const int* block_start, const int* counts,
                             const int* n_proc, const float* trans, const float* g_acc,
                             const float* g_trans,
                             int num_tiles, int tiles_x, int chunk, int rows,
                             float* d_table, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  composite_bwd_kernel<<<num_tiles, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), flat, block_start, counts, n_proc, trans, g_acc,
      g_trans, tiles_x, chunk, rows - 1, d_table);
  return static_cast<int>(cudaGetLastError());
}
