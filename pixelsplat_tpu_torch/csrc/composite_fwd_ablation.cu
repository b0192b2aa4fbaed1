// Stage ablation of the forward compositing kernel, for Hopper (sm_90a).
//
// Replaces the Pallas kernel variants of tools/bench_kernel_ablation.py
// (`run_variant.call`): the forward compositor with chosen stages of its
// per-slot work stubbed out (same shapes, numerically wrong on purpose)
// and a fixed-trip loop over all of a tile's chunks, so that the time each
// stage costs can be read off the scene's real tile lists. The device code
// is composite_fwd_body.cuh's composite_tile, the production kernel's own;
// each variant is one instantiation of it:
//   drop = 0, exit_vote = 0   `full`: every stage, all chunks, no vote
//   drop = 0, exit_vote = 1   the production loop (__syncthreads_or)
//   drop bits                 1 gather, 2 power, 4 exp_power,
//                             8 transmittance, 16 colours; 31 everything
// Inputs and outputs are composite_fwd's. What bounds it on this card is
// what bounds composite_fwd (its FP32 work per (slot, pixel) pair); this
// kernel exists to say which stage that work goes to.

#include "composite_fwd_body.cuh"

namespace {

using namespace composite;

template <unsigned kDrop, bool kExitVote>
__global__ void __launch_bounds__(kPixels)
ablation_kernel(const float4* __restrict__ table, const int* __restrict__ flat,
                const int* __restrict__ block_start,
                const int* __restrict__ counts, int tiles_x, int chunk,
                float* __restrict__ acc_out, float* __restrict__ trans_out,
                int* __restrict__ nproc_out) {
  __shared__ float4 rows[kMaxChunk * kRowVec];
  composite_tile<kDrop, kExitVote>(table, flat, block_start, counts, tiles_x,
                                   chunk, acc_out, trans_out, nproc_out, rows);
}

}  // namespace

#define LAUNCH_VARIANT(DROP, VOTE)                                              \
  ablation_kernel<DROP, VOTE><<<num_tiles, composite::kPixels, 0,                          \
                                static_cast<cudaStream_t>(stream)>>>(           \
      reinterpret_cast<const float4*>(table), flat, block_start, counts,        \
      tiles_x, chunk, acc, trans, n_proc)

// Plain C entry point (loaded with ctypes). Launches the variant (drop,
// exit_vote) on `stream` and returns cudaGetLastError() of the launch;
// a variant that was not instantiated gives cudaErrorInvalidValue.
extern "C" int composite_fwd_ablation(int drop, int exit_vote,
                                      const float* table, const int* flat,
                                      const int* block_start, const int* counts,
                                      int num_tiles, int tiles_x, int chunk,
                                      float* acc, float* trans, int* n_proc,
                                      void* stream) {
  if (chunk < 1 || chunk > composite::kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  if (exit_vote) {
    if (drop != 0) return static_cast<int>(cudaErrorInvalidValue);
    LAUNCH_VARIANT(0u, true);
    return static_cast<int>(cudaGetLastError());
  }
  switch (static_cast<unsigned>(drop)) {
    case 0u: LAUNCH_VARIANT(0u, false); break;
    case composite::kDropGather: LAUNCH_VARIANT(composite::kDropGather, false); break;
    case composite::kDropPower: LAUNCH_VARIANT(composite::kDropPower, false); break;
    case composite::kDropExpPower: LAUNCH_VARIANT(composite::kDropExpPower, false); break;
    case composite::kDropTransmittance: LAUNCH_VARIANT(composite::kDropTransmittance, false); break;
    case composite::kDropColours: LAUNCH_VARIANT(composite::kDropColours, false); break;
    case composite::kDropEverything: LAUNCH_VARIANT(composite::kDropEverything, false); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
