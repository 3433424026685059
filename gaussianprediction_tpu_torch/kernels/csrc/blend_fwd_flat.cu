// blend_fwd_flat: the forward blend of blend_fwd.cu (same outputs, bit for
// bit) driven by a flat work list of (tile, 256-instance block) items.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _fwd_kernel_flat (GPT_BLEND_FLAT=1). There the grid runs over the work
// items in order, one 256-lane block of the instance SoA per item, and
// each tile's blend state waits in its output block from one grid step to
// the next: correct only because the TPU runs its grid in sequence. Blocks
// of a CUDA grid run in no order, so here nothing is carried between them:
// the wrapper cuts the work list into contiguous ranges of about equal item
// counts, cut only where a tile's items begin (tile_cut, from the list's
// ft), and one block of 256 threads (one per pixel) takes each range. A
// loop inside the block walks the range's tiles, and each tile's items
// (ft[t] .. ft[t+1]-1, block woff[i] of the SoA) in order: it stages the
// item's block into shared memory and runs gpt::fwd_walk over the lanes
// that lie in the tile's segment (lo = start - base may be negative: lanes
// before it belong to the previous tile). The tile's state stays in
// registers across its items; its output row is written after its last
// item. A tile with no items (an empty segment) gets the init row
// (0, 0, 0, 0, 1, 0, -1, 0), which the TPU wrapper back-fills. Once every
// pixel of the tile is done the block skips its remaining items. The tile
// of each item is implicit in the tile loop, so the list's wt (the TPU
// grid's output-block map) is not read; padding items (i >= nwork) are
// never reached.
//
// The walk is gpt::fwd_walk with its warp cull (see blend_fwd.cu), called
// by the whole block for one item at a time.
//
// Bound on the H100: the same (pixel, instance) pairs as blend_fwd, so the
// same f32 operation bound; the list adds 4 bytes per item and tile.
#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;

__global__ void __launch_bounds__(kPix)
blend_fwd_flat_kernel(const float* __restrict__ inst, long long P,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_end, int num_tiles,
                      int grid_x, const int* __restrict__ woff,
                      const int* __restrict__ ft,
                      const int* __restrict__ nwork,
                      const int* __restrict__ tile_cut, int with_tidx,
                      float* __restrict__ out) {
  __shared__ float s[kCh][kPix];
  const int lin = threadIdx.x;
  const int nw = nwork[0];
  const int t1 = tile_cut[blockIdx.x + 1];
  for (int t = tile_cut[blockIdx.x]; t < t1; ++t) {
    float px, py;
    gpt::WarpRect rect;
    const int pix = gpt::fwd_tile_pixel(t, grid_x, lin, px, py, rect);
    const int start = tile_start[t];
    const int end = tile_end[t];
    const int i1 = min(t + 1 < num_tiles ? ft[t + 1] : nw, nw);
    gpt::FwdPixel p = gpt::fwd_pixel();
    for (int i = ft[t]; i < i1; ++i) {
      // every pixel done -> skip the tile's other items; also the barrier
      // before reusing s[][]
      if (__syncthreads_count(p.done) == kPix) break;
      const long long base = (long long)woff[i] * kPix;
      const int lo = (int)max((long long)start - base, 0LL);
      const int hi = (int)min((long long)end - base, (long long)kPix);
      gpt::stage_lane(s, inst, P, base, lo, hi, lin);
      __syncthreads();
      gpt::fwd_walk(s, lo, hi, px, py, rect, with_tidx, p);
    }
    gpt::fwd_store(out + ((long long)t * kPix + pix) * 8, p);
  }
}

}  // namespace

extern "C" int gpt_blend_fwd_flat(const void* inst, long long P,
                                  const void* tile_start,
                                  const void* tile_end, int num_tiles,
                                  int grid_x, const void* woff,
                                  const void* ft, const void* nwork,
                                  const void* tile_cut, int num_ranges,
                                  int with_tidx, void* out, void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0 || num_ranges < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  blend_fwd_flat_kernel<<<num_ranges, kPix, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), num_tiles, grid_x,
      static_cast<const int*>(woff), static_cast<const int*>(ft),
      static_cast<const int*>(nwork), static_cast<const int*>(tile_cut),
      with_tidx, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
