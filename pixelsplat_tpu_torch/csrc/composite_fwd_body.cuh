// The forward compositing loop of one 16x16 tile, shared by the production
// kernel (composite_fwd.cu) and the stage-ablation kernel
// (composite_fwd_ablation.cu), so that the ablation's `full` variant is the
// production kernel's own code whenever that code changes.
//
// composite_tile<kDrop, kExitVote> is called by every thread of a
// 256-thread block (one thread per pixel) with `rows`, a shared-memory
// buffer of kRowsShared float4s: two stages of kMaxChunk * kRowVec.
// kDrop = 0 and kExitVote = true give the production function. Each bit of
// kDrop replaces one stage of the per-slot work by a stub of the same
// shape, numerically wrong on purpose, to cost that stage; kExitVote =
// false walks all of a tile's chunks with a plain barrier and no exit vote.
//
// The gather is a two-stage pipeline. While the block composites chunk i
// from one stage, each thread has its 16-byte cp.async copies of chunk
// i+1's rows in flight into the other stage, and plain loads of chunk
// i+2's ids in flight into registers (a row's address depends on its id,
// so the ids run one chunk further ahead). Before the chunk's barrier each
// thread waits for its own copies; the barrier (the exit vote) then makes
// chunk i+1's rows visible to the block and frees chunk i's stage for
// chunk i+2. So there is one barrier per chunk, as without the pipeline.
// A tile that exits after chunk i has fetched chunk i+1's rows for
// nothing: 6 KB.

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
constexpr int kChunkVecs = kMaxChunk * kRowVec;  // float4s of one chunk's rows
constexpr int kRowsShared = 2 * kChunkVecs;      // two pipeline stages
// Row copies per thread and chunk: 128 rows x 3 float4s over 256 threads.
constexpr int kCopies = (kChunkVecs + kPixels - 1) / kPixels;

// Stages that the ablation kernel can drop.
constexpr unsigned kDropGather = 1u;         // no staging of the chunk's rows: every slot reads row 0
constexpr unsigned kDropPower = 2u;          // no quadratic form
constexpr unsigned kDropExpPower = 4u;       // no expf, no alpha tests
constexpr unsigned kDropTransmittance = 8u;  // no running product
constexpr unsigned kDropColours = 16u;       // no colour reads or FMAs
constexpr unsigned kDropEverything = 31u;

// 16-byte copy from device to shared memory that bypasses L1 and does not
// block the thread (cp.async.cg); waited for by cp_async_wait_all.
__device__ __forceinline__ void cp_async_16(float4* smem, const float4* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This thread's share of one chunk's row gather: element e = p + k * 256
// of the chunk's float4s is part e % 3 of slot e / 3's row.
struct ChunkCopies {
  int id[kCopies];

  // Starts the loads of the ids this thread's copies of chunk `i` need.
  __device__ __forceinline__ void load_ids(const int* __restrict__ flat, long long base, int i,
                                           int chunk, int p) {
    const int* ids = flat + base + static_cast<long long>(i) * chunk;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int e = p + k * kPixels;
      id[k] = e < chunk * kRowVec ? __ldg(ids + e / kRowVec) : 0;
    }
  }

  // Issues the copies of those rows into `stage`.
  __device__ __forceinline__ void copy_rows(const float4* __restrict__ table, float4* stage, int chunk,
                                            int p) const {
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int e = p + k * kPixels;
      if (e < chunk * kRowVec)
        cp_async_16(stage + e, table + static_cast<long long>(id[k]) * kRowVec + (e % kRowVec));
    }
  }
};

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

  ChunkCopies next;  // ids of the chunk whose rows are copied next
  if (!(kDrop & kDropGather) && n_chunks > 0) {
    // Prologue: chunk 0's rows into stage 0, chunk 1's ids on their way.
    next.load_ids(flat, base, 0, chunk, p);
    next.copy_rows(table, rows, chunk, p);
    if (n_chunks > 1) next.load_ids(flat, base, 1, chunk, p);
    cp_async_wait_all();
    __syncthreads();
  }

  int done = 0;
  bool go = n_chunks > 0;
  while (go) {
    const float4* stage = rows;
    if (!(kDrop & kDropGather)) {
      stage = rows + (done & 1) * kChunkVecs;
      if (done + 1 < n_chunks) {
        // Chunk done+1's rows into the other stage, chunk done+2's ids
        // into registers, both while this chunk composites.
        next.copy_rows(table, rows + ((done + 1) & 1) * kChunkVecs, chunk, p);
        if (done + 2 < n_chunks) next.load_ids(flat, base, done + 2, chunk, p);
      }
    }

    const float* r = reinterpret_cast<const float*>(stage);
    for (int c = 0; c < chunk; ++c) {
      const float* g = (kDrop & kDropGather) ? r : r + c * kRow;
      float power;
      if (kDrop & kDropPower) {
        power = -(g[2] + g[3] + g[4]);
      } else {
        const float dx = px - g[0];
        const float dy = py - g[1];
        // Rounded op by op, as the plain version rounds it: a contracted
        // multiply-add moves alpha across 1/255 for pairs within rounding
        // of it, and such a pair changes the pixel by up to T / 255.
        power = __fsub_rn(
            __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(g[2], dx), dx), __fmul_rn(__fmul_rn(g[4], dy), dy))),
            __fmul_rn(__fmul_rn(g[3], dx), dy));
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
    // This thread's copies of the next chunk have landed; the barrier below
    // shows them to the block and frees this chunk's stage.
    if (!(kDrop & kDropGather)) cp_async_wait_all();
    if (kExitVote) {
      // Block-wide vote; also the chunk's barrier.
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
