// The forward compositing loop of one 16x16 tile, shared by the production
// kernel (composite_fwd.cu) and the stage-ablation kernel
// (composite_fwd_ablation.cu), so that the ablation's `full` variant is the
// production kernel's own code whenever that code changes.
//
// composite_tile<kDrop, kExitVote> is called by every thread of a
// 256-thread block (one thread per pixel) with `rows`, a shared-memory
// buffer of kMaxChunk * kRowVec float4s. kDrop = 0 and kExitVote = true
// give the production function. Each bit of kDrop replaces one stage of
// the per-slot work by a stub of the same shape, numerically wrong on
// purpose, to cost that stage; kExitVote = false walks all of a tile's
// chunks with a plain barrier and no exit vote.

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kRow = 12;                // floats per table row
constexpr int kRowVec = kRow / 4;       // float4s per table row
constexpr int kMaxChunk = 128;
constexpr int kChPad = 8;               // output channels
constexpr int kColours = 6;
constexpr float kTransEps = 1e-4f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinAlpha = 1.0f / 255.0f;

// Stages that the ablation kernel can drop.
constexpr unsigned kDropGather = 1u;         // no staging of the chunk's rows: every slot reads row 0
constexpr unsigned kDropPower = 2u;          // no quadratic form
constexpr unsigned kDropExpPower = 4u;       // no expf, no alpha tests
constexpr unsigned kDropTransmittance = 8u;  // no running product
constexpr unsigned kDropColours = 16u;       // no colour reads or FMAs
constexpr unsigned kDropEverything = 31u;

template <unsigned kDrop, bool kExitVote>
__device__ __forceinline__ void composite_tile(
    const float4* __restrict__ table, const int* __restrict__ flat,
    const int* __restrict__ block_start, const int* __restrict__ counts,
    int tiles_x, int chunk, float* __restrict__ acc_out,
    float* __restrict__ trans_out, int* __restrict__ nproc_out, float4* rows) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((t % tiles_x) * kTile + (p % kTile));
  const float py = static_cast<float>((t / tiles_x) * kTile + (p / kTile));
  const int n_chunks = (counts[t] + chunk - 1) / chunk;
  const long long base = static_cast<long long>(block_start[t]) * chunk;

  float trans = 1.0f;
  float acc[kColours];
#pragma unroll
  for (int k = 0; k < kColours; ++k) acc[k] = 0.0f;

  if (kDrop & kDropGather) {
    // One row, staged once: what every slot of every chunk then reads.
    if (p < kRowVec && n_chunks > 0)
      rows[p] = __ldg(table + static_cast<long long>(__ldg(flat + base)) * kRowVec + p);
    __syncthreads();
  }

  int done = 0;
  bool go = n_chunks > 0;
  while (go) {
    if (!(kDrop & kDropGather)) {
      const int* ids = flat + base + static_cast<long long>(done) * chunk;
      for (int e = p; e < chunk * kRowVec; e += kPixels) {
        const int slot = e / kRowVec;
        const int part = e - slot * kRowVec;
        rows[e] = __ldg(table + static_cast<long long>(__ldg(ids + slot)) * kRowVec + part);
      }
      __syncthreads();
    }

    const float* r = reinterpret_cast<const float*>(rows);
    for (int c = 0; c < chunk; ++c) {
      const float* g = (kDrop & kDropGather) ? r : r + c * kRow;
      float power;
      if (kDrop & kDropPower) {
        power = -(g[2] + g[3] + g[4]);
      } else {
        const float dx = px - g[0];
        const float dy = py - g[1];
        power = -0.5f * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy;
      }
      float alpha;
      if (kDrop & kDropExpPower) {
        alpha = fminf(0.02f, fmaxf(0.0f, g[5] * (1.0f + power * 0.01f)));
      } else {
        alpha = fminf(kMaxAlpha, g[5] * expf(power));
        if (!(power <= 0.0f && alpha >= kMinAlpha)) alpha = 0.0f;
      }
      const float weight = (kDrop & kDropTransmittance) ? alpha : alpha * trans;
      if (kDrop & kDropColours) {
#pragma unroll
        for (int k = 0; k < kColours; ++k) acc[k] += weight;
      } else {
#pragma unroll
        for (int k = 0; k < kColours; ++k) acc[k] += weight * g[6 + k];
      }
      if (!(kDrop & kDropTransmittance)) trans *= 1.0f - alpha;
    }
    ++done;
    if (kExitVote) {
      // Block-wide vote; also the barrier before `rows` is overwritten.
      const int any_open = __syncthreads_or(trans >= kTransEps);
      go = any_open && done < n_chunks;
    } else {
      if (!(kDrop & kDropGather)) __syncthreads();
      go = done < n_chunks;
    }
  }

  float* out = acc_out + static_cast<long long>(t) * kChPad * kPixels + p;
#pragma unroll
  for (int k = 0; k < kColours; ++k) out[k * kPixels] = acc[k];
  out[kColours * kPixels] = 0.0f;
  out[(kColours + 1) * kPixels] = 0.0f;
  trans_out[static_cast<long long>(t) * kPixels + p] = trans;
  if (p == 0) nproc_out[t] = done;
}

}  // namespace composite
