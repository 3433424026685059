// blend_bwd_flat: the backward blend of blend_bwd.cu (same outputs, bit
// for bit) driven by the flat work list of blend_fwd_flat.cu.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _bwd_kernel_flat (GPT_BLEND_FLAT=1). There each grid step carries its
// tile's (T, done, S) in scratch to the next step, and a gradient block
// that two tiles share is accumulated across the two steps that visit it:
// both need the TPU's sequential grid. Here, as in blend_fwd_flat.cu, one
// block of 256 threads takes each contiguous range of the list (cut only
// where a tile's items begin) and walks its tiles and their items in order,
// the tile's (T, done, S) in registers; each item's 256-instance block is
// staged into shared memory and gpt::bwd_walk runs over the lanes in the
// tile's segment. Every instance lies in exactly one tile's segment, so
// each column is written once, by its own tile, with no atomics and no
// read-back: the TPU's shared-block accumulation has no counterpart, and
// two launches are bit-identical. The sums run in sub-batches of 32 ranks
// of the tile's segment, as blend_bwd.cu's do (bwd_walk cuts a sub-batch
// at an item's edge and goes on in the next item), and a tile stops at the
// end of the sub-batch in which its last pixel latched, so the same columns
// are written with the same bits. Padding items (i >= nwork) are never
// reached.
//
// Bound on the H100: the same pairs and gradient terms as blend_bwd, so
// the same f32 operation bound; the list adds 4 bytes per item and tile.
#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;

__global__ void __launch_bounds__(kPix)
blend_bwd_flat_kernel(const float* __restrict__ inst, long long P,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_end, int num_tiles,
                      int grid_x, const int* __restrict__ woff,
                      const int* __restrict__ ft,
                      const int* __restrict__ nwork,
                      const int* __restrict__ tile_cut,
                      const float* __restrict__ dpix,
                      float* __restrict__ dinst) {
  __shared__ float s[kCh][kPix];
  __shared__ gpt::Reduce red[2];
  const int lin = threadIdx.x;
  const int nw = nwork[0];
  const int t1 = tile_cut[blockIdx.x + 1];
  for (int t = tile_cut[blockIdx.x]; t < t1; ++t) {
    const int start = tile_start[t];
    const int end = tile_end[t];
    const int i1 = min(t + 1 < num_tiles ? ft[t + 1] : nw, nw);
    gpt::BwdPixel p = gpt::bwd_pixel(t, grid_x, lin, dpix);
    // each walk's last read of s[][] precedes its last barrier
    for (int i = ft[t]; i < i1; ++i) {
      const long long base = (long long)woff[i] * kPix;
      const int lo = (int)max((long long)start - base, 0LL);
      const int hi = (int)min((long long)end - base, (long long)kPix);
      gpt::stage_lane(s, inst, P, base, lo, hi, lin);
      __syncthreads();
      if (gpt::bwd_walk(s, red, inst, base, lo, hi, start, end, p, dinst,
                        P, lin, gpt::BlockBarrier{})) {
        break;
      }
    }
  }
}

}  // namespace

extern "C" int gpt_blend_bwd_flat(const void* inst, long long P,
                                  const void* tile_start,
                                  const void* tile_end, int num_tiles,
                                  int grid_x, const void* woff,
                                  const void* ft, const void* nwork,
                                  const void* tile_cut, int num_ranges,
                                  const void* dpix, void* dinst,
                                  void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0 || num_ranges < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  blend_bwd_flat_kernel<<<num_ranges, kPix, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), num_tiles, grid_x,
      static_cast<const int*>(woff), static_cast<const int*>(ft),
      static_cast<const int*>(nwork), static_cast<const int*>(tile_cut),
      static_cast<const float*>(dpix), static_cast<float*>(dinst));
  return (int)cudaGetLastError();
}
