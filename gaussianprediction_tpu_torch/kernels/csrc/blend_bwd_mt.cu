// blend_bwd_mt: the backward blend of blend_bwd.cu (same outputs, bit for
// bit) with the block geometry of blend_fwd_mt.cu: one block per tpb
// consecutive tiles, 256 threads per owned tile, at most four at a time.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _bwd_kernel_mt (GPT_BLEND_MT=1). There the program keeps each owned
// tile's (T, done, S) in scratch while it streams the tiles' union window,
// and read-modify-writes the head gradient block it shares with the
// previous program, which the TPU's sequential grid makes safe. Here the
// block stages each 256-lane block of the window into shared memory once,
// and each tile's 256 threads run gpt::bwd_walk over the lanes in their
// segment, with their own reduction buffer and their own named barrier
// (gpt::GroupBarrier, ids 1-4), since the tiles' sub-batches of 32 ranks
// end at different lanes. Every instance lies in exactly one tile's
// segment, so each column is written once, by its own tile: no atomics,
// no read-back, two launches bit-identical, and the same columns and bits
// as blend_bwd.cu. A tile whose pixels are all done at the end of a
// sub-batch stops there; the block leaves the window once every tile has
// stopped or passed its segment.
//
// Shared memory: the staged block (12 KB) and two reduction buffers
// (gpt::Reduce, 10,280 bytes each) per tile walked at once, 94,528 bytes
// for four: dynamic shared memory, over the 48 KB static limit.
//
// Bound on the H100: the same pairs and gradient terms as blend_bwd, so
// the same f32 operation bound.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;
constexpr int kMaxGroups = 4;  // tiles a block walks at once

size_t smem_bytes(int groups) {
  return sizeof(float) * (kCh * kPix) +
         sizeof(gpt::Reduce) * 2 * groups;
}

__global__ void __launch_bounds__(kPix * kMaxGroups)
blend_bwd_mt_kernel(const float* __restrict__ inst, long long P,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_end, int num_tiles,
                    int grid_x, int tpb, const float* __restrict__ dpix,
                    float* __restrict__ dinst) {
  extern __shared__ float smem[];
  gpt::Staged* s = reinterpret_cast<gpt::Staged*>(smem);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int groups = nthreads / kPix;
  const int grp = tid / kPix;
  const int lin = tid - grp * kPix;
  gpt::Reduce* red =
      reinterpret_cast<gpt::Reduce*>(smem + kCh * kPix) + 2 * grp;
  const gpt::GroupBarrier bar{1 + grp};
  const int t0 = blockIdx.x * tpb;
  const int tlast = min(t0 + tpb, num_tiles);
  for (int g0 = t0; g0 < tlast; g0 += groups) {
    const int g1 = min(g0 + groups, tlast);
    int ws = INT_MAX, we = INT_MIN;  // the pass's window
    for (int u = g0; u < g1; ++u) {
      if (tile_end[u] > tile_start[u]) {
        ws = min(ws, tile_start[u]);
        we = max(we, tile_end[u]);
      }
    }
    const int t = g0 + grp;
    const bool valid = t < g1;
    const int start = valid ? tile_start[t] : 0;
    const int end = valid ? tile_end[t] : 0;
    gpt::BwdPixel p = gpt::bwd_pixel(valid ? t : 0, grid_x, lin, dpix);
    bool stopped = false;  // the tile's pixels all done (group-uniform)
    for (long long base = ws; base < we; base += kPix) {
      // every tile stopped or past its segment -> leave; also the barrier
      // before reusing s[][] (each walk's last reads of it precede it)
      const int fin = !valid || stopped || end <= base;
      if (__syncthreads_count(fin) == nthreads) break;
      const int nb = (int)min(we - base, (long long)kPix);
      gpt::stage_block(s, inst, P, base, nb, tid, nthreads);
      __syncthreads();
      if (valid && !stopped) {
        const int lo = (int)max((long long)start - base, 0LL);
        const int hi = (int)min((long long)end - base, (long long)kPix);
        if (lo < hi) {
          stopped = gpt::bwd_walk(s, red, inst, base, lo, hi, start, end, p,
                                  dinst, P, lin, bar);
        }
      }
    }
  }
}

}  // namespace

extern "C" int gpt_blend_bwd_mt(const void* inst, long long P,
                                const void* tile_start, const void* tile_end,
                                int num_tiles, int grid_x, int tpb,
                                const void* dpix, void* dinst, void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0 || tpb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const int groups = min(tpb, kMaxGroups);
  const size_t smem = smem_bytes(groups);
  cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_mt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxGroups));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (num_tiles + tpb - 1) / tpb;
  blend_bwd_mt_kernel<<<blocks, kPix * groups, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), num_tiles, grid_x, tpb,
      static_cast<const float*>(dpix), static_cast<float*>(dinst));
  return (int)cudaGetLastError();
}
