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
// caller zero-fills; the kernel only adds to it. Scratch from the caller:
// one float2 per (flat block, pixel) and one int per flat block.
//
// Design: chunk-parallel, from a two-pass scan. The sweep along a tile is
// a linear recurrence in two values per pixel, log T and S, so it splits by
// chunk. With n = min(n_proc, ceil(counts / chunk)) chunks in tile t:
//   map     one thread per tile writes block_map[block_start[t] + c] = t for
//           c < n; every other flat block stays -1 (a memset). block_start
//           is not searched: it is unsorted where the pair budget dropped a
//           tile (binning.py points such a tile past the end).
//   pass A  one block per flat block (tile, chunk c), one thread per pixel,
//           from the chunk's rows alone: L_c = sum log(1 - alpha_j), taken
//           as the log of products of 8 factors (each >= 0.01), and
//           U_c = sum alpha_j tau_j cg_j with tau_j = prod_{k<j} (1 - alpha_k),
//           the transmittance from the chunk's start (<= 1, no overflow).
//   scan    one block per tile walks its chunks back to front and replaces
//           (L_c, U_c) in place by the seeds of pass B: E_c = log T after
//           chunk c (from log max(T_end, 1e-30)) and S_c = S after chunk c;
//           then E_{c-1} = E_c - L_c and S_{c-1} = S_c + exp(E_c - L_c) U_c.
//   pass B  one warp per flat block, eight pixels of one column per thread:
//           from T = exp(E_c) and S = S_c, the chunk's slots back to front,
//           T before a slot being T after it times 1 / (1 - alpha), in the
//           log-space rebuild's order (so it overflows where that does). A
//           thread sums its pixels' partials (the five geometry ones from
//           three moments of d_power over dy: its pixels share dx), the warp
//           sums the 12 with 16 shuffles (a butterfly that halves the number
//           of values each round), and twelve lanes store the slot's sums in
//           shared memory; the block then adds them to d_table with one
//           atomicAdd per (slot, column).
// Blocks whose map entry is -1 (chunks past n_proc, blocks no tile owns)
// exit at once. Why this shape, from stage knock-outs timed on the H100
// while it was designed (scripts/bench_bwd_ablation.py times today's): the
// first chunk-parallel version's time was the per-slot instruction stream
// of its warps, and the largest part of it the warp butterfly, so pass B
// puts eight pixels behind each shuffle;
// log1pf, expf and an IEEE division per (slot, pixel) became one
// approximate reciprocal, since the chain in linear space is one chunk long
// from the scan's seed (~128 roundings at most); the butterfly's rounds are
// templates because a loop over them was left rolled, with a branch per
// select; and a one-warp block stores its sums, because atomicAdd on a
// shared float is a compare-and-swap loop on this card. Pass A keeps one
// pixel per thread: with eight it ran slower (fewer warps, no shuffles to
// share). Pass A and the scan stay apart: fusing them would need a per-tile
// completion counter and a last-block-does-the-scan protocol for a scan
// that reads and writes ~2 KB per chunk. Both passes stage the chunk's rows
// with plain loads: a block handles one chunk, so there is no next chunk to
// prefetch, and the other blocks on the SM hide the gather. A slot that no
// pixel of a warp sees changes neither T, S nor any sum and is skipped by
// that warp in both passes. The atomics into d_table make the sums' order,
// and so their last bits, vary from run to run.
//
// Bound on this card: every processed (slot, pixel) pair costs about 74
// FP32 operations (the forward's 16 recomputed, 12 for colour . g, 10 for
// T, w, S and d_alpha, 24 for the twelve partials, 12 for their sums) plus
// the special functions, so a training view of ~0.13-0.26M list slots is
// ~2.5-5 GFLOP against 67 TFLOP/s of FP32, ~0.04-0.08 ms; the bytes (table
// 18.9 MB, d_table 18.9 MB, ids, 2.9 MB of cotangents and T) take ~13 us at
// 3.35 TB/s. So it is compute-bound. The one-block-per-tile design was held
// back by a serial chain at low occupancy: 256 blocks of 8 warps for 132
// SMs, each walking all of its tile's chunks (up to 15) one after another.
// Here a view's 1,200-2,200 processed chunks are as many independent
// blocks, and the chain in a block is one chunk.

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
constexpr int kMapThreads = 128;
constexpr int kPixPerThread = 8;                       // pass B
constexpr int kGradThreads = kPixels / kPixPerThread;  // pass B's block: one warp
static_assert(kGradThreads == 32, "pass B writes each slot's sums from one warp");
constexpr int kLogGroup = 8;                           // factors per log in pass A

// One round of warp_sum_16: a lane keeps one half of its kHalf * 2 values,
// hands the other half to the lane whose index differs in bit kHalf * 2
// and adds what it gets back.
template <int kHalf>
__device__ __forceinline__ void butterfly_round(float (&v)[16], int lane) {
  constexpr int kBit = kHalf << 1;
  const bool upper = (lane & kBit) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float keep = upper ? v[k + kHalf] : v[k];
    const float send = upper ? v[k] : v[k + kHalf];
    v[k] = keep + __shfl_xor_sync(kFullMask, send, kBit);
  }
}

// Sums each of 16 per-lane values over the warp with 16 shuffles instead of
// 16 x 5: the rounds turn 16 values into 8, 4, 2, 1 (lane bits 16, 8, 4,
// 2); a last exchange joins the two lanes that then hold the same value.
// Afterwards lane l holds the warp's total of value number l / 2. The
// rounds are templates so that every loop unrolls and v stays in registers.
__device__ __forceinline__ float warp_sum_16(float (&v)[16], int lane) {
  butterfly_round<8>(v, lane);
  butterfly_round<4>(v, lane);
  butterfly_round<2>(v, lane);
  butterfly_round<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
}

// Reads the block's tile from the map; where it has one, stages the
// chunk's rows (and ids) into shared memory with kThreads threads and
// returns after a barrier. Returns the tile, or -1: nothing to do.
template <int kThreads>
__device__ __forceinline__ int stage_chunk(const float4* __restrict__ table, const int* __restrict__ flat,
                                           const int* __restrict__ block_map, int chunk, float4* rows,
                                           int* ids) {
  const int tile = block_map[blockIdx.x];
  if (tile < 0) return tile;
  const int* chunk_ids = flat + static_cast<long long>(blockIdx.x) * chunk;
  for (int e = threadIdx.x; e < chunk * kRowVec; e += kThreads) {
    const int slot = e / kRowVec;
    const int part = e - slot * kRowVec;
    rows[e] = __ldg(table + static_cast<long long>(__ldg(chunk_ids + slot)) * kRowVec + part);
  }
  if (ids != nullptr)
    for (int e = threadIdx.x; e < chunk; e += kThreads) ids[e] = __ldg(chunk_ids + e);
  __syncthreads();
  return tile;
}

// The forward's quantities of one (slot, pixel) pair.
struct Slot {
  float dx, dy, expp, raw, alpha;
  bool live;
};

__device__ __forceinline__ Slot eval_slot(const float* q, float px, float py) {
  Slot s;
  s.dx = px - q[0];
  s.dy = py - q[1];
  // Rounded op by op, as the forward kernel and the plain versions round
  // it, so that all of them take the same pairs across power = 0 and
  // raw = 1/255.
  const float power = __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(q[2], s.dx), s.dx), __fmul_rn(__fmul_rn(q[4], s.dy), s.dy))),
      __fmul_rn(__fmul_rn(q[3], s.dx), s.dy));
  s.expp = expf(power);
  s.raw = q[5] * s.expp;
  s.live = power <= 0.0f && s.raw >= kMinAlpha;
  s.alpha = s.live ? fminf(kMaxAlpha, s.raw) : 0.0f;
  return s;
}

__device__ __forceinline__ float pixel_x(int tile, int tiles_x, int pixel) {
  return static_cast<float>((tile % tiles_x) * kTile + (pixel % kTile));
}

__device__ __forceinline__ float pixel_y(int tile, int tiles_x, int pixel) {
  return static_cast<float>((tile / tiles_x) * kTile + (pixel / kTile));
}

__global__ void __launch_bounds__(kMapThreads)
chunk_map_kernel(const int* __restrict__ block_start, const int* __restrict__ counts,
                 const int* __restrict__ n_proc, int num_tiles, int chunk, int n_blocks,
                 int* __restrict__ block_map) {
  const int t = blockIdx.x * kMapThreads + threadIdx.x;
  if (t >= num_tiles) return;
  // Never past the tile's own list, whatever n_proc says.
  const int n = min(n_proc[t], (counts[t] + chunk - 1) / chunk);
  const int b0 = block_start[t];
  for (int c = 0; c < n; ++c)
    if (b0 + c >= 0 && b0 + c < n_blocks) block_map[b0 + c] = t;
}

// Pass A: per (chunk, pixel) L = sum log(1 - alpha) and U = sum alpha tau
// cg, one pixel per thread. L is summed as the log of products of
// kLogGroup factors (each >= 0.01, so a product stays far above the
// smallest float).
__global__ void __launch_bounds__(kPixels)
chunk_sums_kernel(const float4* __restrict__ table, const int* __restrict__ flat,
                  const int* __restrict__ block_map, const float* __restrict__ g_acc,
                  int tiles_x, int chunk, float2* __restrict__ sums) {
  __shared__ float4 rows[kMaxChunk * kRowVec];
  const int tile = stage_chunk<kPixels>(table, flat, block_map, chunk, rows, nullptr);
  if (tile < 0) return;
  const int p = threadIdx.x;
  const float px = pixel_x(tile, tiles_x, p);
  const float py = pixel_y(tile, tiles_x, p);
  float g[kColours];
  const float* g_in = g_acc + static_cast<long long>(tile) * kChPad * kPixels + p;
#pragma unroll
  for (int k = 0; k < kColours; ++k) g[k] = g_in[k * kPixels];

  const float* r = reinterpret_cast<const float*>(rows);
  float sum_log = 0.0f, sum_u = 0.0f, tau = 1.0f, group = 1.0f;
  int in_group = 0;  // the same in every lane of a warp
  for (int c = 0; c < chunk; ++c) {
    const float* q = r + c * kRow;
    const Slot s = eval_slot(q, px, py);
    if (!__any_sync(kFullMask, s.live)) continue;
    float cg = 0.0f;
#pragma unroll
    for (int k = 0; k < kColours; ++k) cg += q[6 + k] * g[k];
    const float keep = 1.0f - s.alpha;
    sum_u += s.alpha * tau * cg;
    tau *= keep;
    group *= keep;
    if (++in_group == kLogGroup) {
      sum_log += logf(group);
      group = 1.0f;
      in_group = 0;
    }
  }
  sums[static_cast<long long>(blockIdx.x) * kPixels + p] = make_float2(sum_log + logf(group), sum_u);
}

// The scan: per tile and pixel, (L_c, U_c) -> (E_c, S_c), back to front.
__global__ void __launch_bounds__(kPixels)
chunk_scan_kernel(const int* __restrict__ block_start, const int* __restrict__ counts,
                  const int* __restrict__ n_proc, const float* __restrict__ trans_end,
                  const float* __restrict__ g_trans, int chunk, int n_blocks,
                  float2* __restrict__ sums) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int b0 = block_start[t];
  // The chunks the map gave this tile.
  const int n = min(min(n_proc[t], (counts[t] + chunk - 1) / chunk), n_blocks - b0);
  if (n <= 0 || b0 < 0) return;
  const float t_end = trans_end[static_cast<long long>(t) * kPixels + p];
  float log_t = logf(fmaxf(t_end, kMinTrans));
  float s_run = g_trans[static_cast<long long>(t) * kPixels + p] * t_end;
  float2* seeds = sums + static_cast<long long>(b0) * kPixels + p;
  for (int c = n - 1; c >= 0; --c) {
    const float2 lu = seeds[static_cast<long long>(c) * kPixels];
    seeds[static_cast<long long>(c) * kPixels] = make_float2(log_t, s_run);
    log_t -= lu.x;                 // log T before chunk c
    s_run += expf(log_t) * lu.y;   // T at the chunk's start times U_c
  }
}

// Pass B: the per-slot sweep of one chunk from its seeds, kPixPerThread
// pixels per thread (one column, every kGradThreads / 16-th row), and the
// sums into d_table.
__global__ void __launch_bounds__(kGradThreads)
chunk_grad_kernel(const float4* __restrict__ table, const int* __restrict__ flat,
                  const int* __restrict__ block_map, const float* __restrict__ g_acc,
                  const float2* __restrict__ seeds, int tiles_x, int chunk, int sentinel,
                  float* __restrict__ d_table) {
  __shared__ float4 rows[kMaxChunk * kRowVec];
  __shared__ float d_rows[kMaxChunk * kRow];
  __shared__ int ids[kMaxChunk];
  const int tid = threadIdx.x;
  for (int e = tid; e < chunk * kRow; e += kGradThreads) d_rows[e] = 0.0f;
  const int tile = stage_chunk<kGradThreads>(table, flat, block_map, chunk, rows, ids);
  if (tile < 0) return;
  const int lane = tid & 31;

  const float px = pixel_x(tile, tiles_x, tid);  // the same for all the thread's pixels
  float py[kPixPerThread], g[kPixPerThread][kColours];
  float t_run[kPixPerThread], s_run[kPixPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int pixel = tid + j * kGradThreads;
    py[j] = pixel_y(tile, tiles_x, pixel);
    const float* g_in = g_acc + static_cast<long long>(tile) * kChPad * kPixels + pixel;
#pragma unroll
    for (int k = 0; k < kColours; ++k) g[j][k] = g_in[k * kPixels];
    const float2 seed = seeds[static_cast<long long>(blockIdx.x) * kPixels + pixel];
    t_run[j] = expf(seed.x);  // T after the chunk's last slot
    s_run[j] = seed.y;
  }

  const float* r = reinterpret_cast<const float*>(rows);
  for (int c = chunk - 1; c >= 0; --c) {
    const float* q = r + c * kRow;
    Slot s[kPixPerThread];
    bool seen = false;
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      s[j] = eval_slot(q, px, py[j]);
      seen = seen || s[j].live;
    }
    // No pixel of this warp sees the slot: T, S and every sum stay.
    if (!__any_sync(kFullMask, seen)) continue;

    // The thread's pixels share a column, so dx: the geometry partials
    // come from three moments of d_power over their dy.
    float dp_sum = 0.0f, dp_dy = 0.0f, dp_dy2 = 0.0f;
    float part[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) part[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      const Slot& e = s[j];
      // 1 / (1 - alpha): T before the slot from T after it, and S's share.
      const float inv = e.live ? __fdividef(1.0f, 1.0f - e.alpha) : 1.0f;
      t_run[j] *= inv;
      const float w = e.alpha * t_run[j];
      float cg = 0.0f;
#pragma unroll
      for (int k = 0; k < kColours; ++k) cg += q[6 + k] * g[j][k];
      // Selects, not products with a 0/1 mask: an overflowed exp(power) of
      // a masked slot must not turn 0 * inf into NaN.
      const bool pass = e.live && e.raw < kMaxAlpha;
      const float d_alpha = pass ? t_run[j] * cg - s_run[j] * inv : 0.0f;
      s_run[j] += w * cg;
      const float d_power = pass ? d_alpha * e.raw : 0.0f;
      dp_sum += d_power;
      dp_dy += e.dy * d_power;
      dp_dy2 += e.dy * e.dy * d_power;
      part[5] += pass ? d_alpha * e.expp : 0.0f;  // d opacity
#pragma unroll
      for (int k = 0; k < kColours; ++k) part[6 + k] += g[j][k] * w;
    }
    const float dx = s[0].dx;
    part[0] = q[2] * dx * dp_sum + q[3] * dp_dy;  // d mean x: sum (a dx + b dy) d_power
    part[1] = q[4] * dp_dy + q[3] * dx * dp_sum;  // d mean y: sum (c dy + b dx) d_power
    part[2] = -0.5f * dx * dx * dp_sum;           // d conic a
    part[3] = -dx * dp_dy;                        // d conic b
    part[4] = -0.5f * dp_dy2;                     // d conic c
    const float sum = warp_sum_16(part, lane);
    // Lanes 0, 2, ..., 22 hold the sums of columns 0..11; the block is one
    // warp, so nothing else writes this slot's row.
    if ((lane & 1) == 0 && (lane >> 1) < kRow) d_rows[c * kRow + (lane >> 1)] = sum;
  }
  __syncwarp();

  for (int e = tid; e < chunk * kRow; e += kGradThreads) {
    const int slot = e / kRow;
    const int id = ids[slot];
    const float v = d_rows[e];
    if (id < sentinel && v != 0.0f)
      atomicAdd(d_table + static_cast<long long>(id) * kRow + (e - slot * kRow), v);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Enqueues the map, pass A, the
// scan and pass B on `stream` and returns the first non-zero
// cudaGetLastError() after a launch; 0 means all were accepted. `rows` is
// the table's row count (its last row is the sentinel); `n_blocks` is
// flat's length in whole chunks. `sums` (n_blocks * 256 float2) and
// `block_map` (n_blocks int) are scratch that need no initial values.
extern "C" int composite_bwd(const float* table, const int* flat,
                             const int* block_start, const int* counts,
                             const int* n_proc, const float* trans, const float* g_acc,
                             const float* g_trans,
                             int num_tiles, int tiles_x, int chunk, int rows, int n_blocks,
                             void* sums, int* block_map, float* d_table, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || rows < 1 || n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0 || n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* table4 = reinterpret_cast<const float4*>(table);
  float2* sums2 = static_cast<float2*>(sums);
  int err = static_cast<int>(cudaMemsetAsync(block_map, 0xff, sizeof(int) * n_blocks, s));  // -1
  if (err != 0) return err;
  chunk_map_kernel<<<(num_tiles + kMapThreads - 1) / kMapThreads, kMapThreads, 0, s>>>(
      block_start, counts, n_proc, num_tiles, chunk, n_blocks, block_map);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  chunk_sums_kernel<<<n_blocks, kPixels, 0, s>>>(table4, flat, block_map, g_acc, tiles_x, chunk, sums2);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  chunk_scan_kernel<<<num_tiles, kPixels, 0, s>>>(block_start, counts, n_proc, trans, g_trans, chunk, n_blocks,
                                                 sums2);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  chunk_grad_kernel<<<n_blocks, kGradThreads, 0, s>>>(table4, flat, block_map, g_acc, sums2, tiles_x, chunk,
                                                 rows - 1, d_table);
  return static_cast<int>(cudaGetLastError());
}
