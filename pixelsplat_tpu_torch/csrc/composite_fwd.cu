// Forward tile compositing of depth-sorted Gaussians, for Hopper (sm_90a).
//
// Replaces pixelsplat_tpu/ops/rasterizer/pallas_composite.py::
// pallas_composite_core (the Pallas TPU kernel `_kernel`), together with
// the row gather in front of it (composite.py::_gather_params_u16). It
// computes the same function: for each 16x16 tile, walk its front-to-back
// list of Gaussians in chunks of `chunk` slots and composite
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx, dy from the pixel centre
//   alpha = min(0.99, opacity * exp(power)), zeroed unless power <= 0 and
//           alpha >= 1/255
//   acc  += alpha * T * colour;  T *= 1 - alpha
// The tile stops after chunk i unless chunk i+1 exists and some pixel of
// the tile still has T >= 1e-4 (the Pallas kernel's exit rule; there is
// no per-pixel stop inside a chunk). n_proc counts the chunks processed;
// the backward kernel walks exactly those.
//
// Inputs: the (rows, 12) f32 parameter table from composite.py::
// pack_columns (mx, my, conic a/b/c, opacity, six colours; the last row is
// the all-zero sentinel), the flat int32 id list of binning.py::TileLists
// (tile t's list starts at slot block_start[t] * chunk, counts[t] long,
// sentinel-padded to whole chunks) and the per-tile counts.
// Outputs: acc (T, 8, 256) with colours in channels 0-5 and zeros in 6-7,
// trans (T, 256), n_proc (T,) int32.
//
// Design: one block per tile, one thread per pixel (256 threads). The
// block walks its tile's chunks in order; every thread walks each chunk's
// 128 rows from shared memory, all threads reading the same row at the same
// time, which shared memory broadcasts. The exit vote is __syncthreads_or,
// the one barrier per chunk. It decides n_proc for the whole tile, which
// the backward replays exactly, so the tile stays in one block. The TPU
// kernel's u16 hi/lo row split, triangular-matmul prefix product and bf16
// coefficient split exist for the TPU's gather and matrix unit and have no
// counterpart here.
//
// Bound on this card: compositing evaluates every processed (slot, pixel)
// pair: one expf plus about 31 FP32 operations (offset, quadratic form,
// clamps, six colour FMAs, transmittance update). At the evaluation
// scene's ~0.13-0.4M list slots per view that is ~0.3-1e8 evaluations,
// ~1-3 GFLOP against the H100's 67 TFLOP/s of FP32 (and 1 expf each
// against the SFUs' ~4 Tops/s), while the bytes it must move (the 48 B
// table rows, the 4 B ids, 9 KB of output per tile) take a few
// microseconds at 3.35 TB/s. So it is compute-bound. The stage ablation
// (composite_fwd_ablation.cu) seemed to say that staging each chunk's rows
// (dependent loads: the id, then the 48 B row, nothing in flight while the
// tile composited) took over half of the kernel, so composite_fwd_body.cuh
// now pipelines it: chunk i+1's rows are copied with cp.async into a second
// shared buffer, and chunk i+2's ids loaded, while chunk i composites. On
// the H100 that gains ~1-2 %: the ablation's `-gather` reads one row for
// every slot, which lets the compiler hoist that row's whole per-slot
// arithmetic out of the loop, so it timed the arithmetic, not the gather.
// What bounds the kernel is issuing the per-slot instructions of the SMs
// that hold two of a view's longest tiles (256 tiles on 132 SMs); two
// pixels per thread (fewer instructions, half the warps) and a warp vote
// that skips unseen slots were both slower. A chunk-parallel forward, as
// the backward now is, is what is left.

#include "composite_fwd_body.cuh"

namespace {

using namespace composite;

// The loop itself is composite_fwd_body.cuh's composite_tile, which the
// stage-ablation kernel shares; <0, true> is every stage and the exit vote.
__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float4* __restrict__ table,
                     const int* __restrict__ flat,
                     const int* __restrict__ block_start,
                     const int* __restrict__ counts,
                     int tiles_x, int chunk,
                     float* __restrict__ acc_out,
                     float* __restrict__ trans_out,
                     int* __restrict__ nproc_out) {
  __shared__ float4 rows[kRowsShared];
  composite_tile<0u, true>(table, flat, block_start, counts, tiles_x, chunk,
                           acc_out, trans_out, nproc_out, rows);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() of the launch; 0 means it was accepted.
extern "C" int composite_fwd(const float* table, const int* flat,
                             const int* block_start, const int* counts,
                             int num_tiles, int tiles_x, int chunk,
                             float* acc, float* trans, int* n_proc,
                             void* stream) {
  if (chunk < 1 || chunk > composite::kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  composite_fwd_kernel<<<num_tiles, composite::kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), flat, block_start, counts, tiles_x,
      chunk, acc, trans, n_proc);
  return static_cast<int>(cudaGetLastError());
}
