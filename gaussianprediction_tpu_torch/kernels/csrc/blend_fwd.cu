// blend_fwd: per 16x16 tile, front-to-back alpha blend of the tile's
// depth-sorted instance segment [tile_start, tile_end) of the [16, P]
// instance SoA. Output [T, 256, 8]: r, g, b, depth, T_final, w_max,
// best gid (tidx), pad.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _fwd_kernel (the classic branch of _rasterize_fwd_impl). The Pallas
// kernel turns the sequential blend into lane-wise product scans over
// 256-instance chunks; this kernel keeps the reference CUDA rasterizer's
// shape instead: one block per tile, one thread per pixel, the segment
// staged through shared memory in batches of 256 instances, and each pixel
// walking the batch in order with the exact CUDA semantics (sequential
// T *= 1-alpha, done latch at T < 1e-4, tidx = first strict maximum of the
// blend weight). The block leaves early once every pixel is done.
//
// The per-pixel walk is gpt::fwd_walk (common.cuh), which the flat
// work-list, multi-tile and sequential-tile kernels share: the _rn
// intrinsics of gpt::pair_power, pair_opacity and pair_T (never contracted
// into FMAs; the backward's pair_terms is built of the same three) in the
// order of the plain PyTorch version, and IEEE expf. Each warp covers an 8 x 4 patch of the
// tile (gpt::fwd_tile_pixel) and skips, 32 instances at a time, every
// instance whose support box (widened to cover f32 rounding) misses its
// patch: no pixel of the warp could pass the alpha test there, so the
// outputs keep their bits. On the card it keeps about half of the (warp,
// instance) pairs, and the walk evaluates the kept ones two at a time.
//
// Bound on the H100: by the f32 arithmetic of the (pixel, instance) pairs
// evaluated up to each pixel's done latch (11 to 24 operations a pair,
// by how far the pair gets), against 67 TFLOP/s, beside the instances
// read up to each tile's last done pixel (12 channels x 4 bytes) and the
// output written once. The kernel is bound by instruction issue instead:
// ~75 instructions per kept (warp, instance) pair, each warp evaluating
// all 32 pixels of a kept pair. Not yet done: pipelining the next batch's
// loads.
#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;

__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ inst, long long P,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int grid_x, int with_tidx,
                 float* __restrict__ out) {
  __shared__ float s[kCh][kPix];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  float px, py;
  gpt::WarpRect rect;
  const int pix = gpt::fwd_tile_pixel(t, grid_x, lin, px, py, rect);
  const int start = tile_start[t];
  const int end = tile_end[t];

  gpt::FwdPixel p = gpt::fwd_pixel();
  for (int base = start; base < end; base += kPix) {
    // every pixel done -> leave; also the barrier before reusing s[][]
    if (__syncthreads_count(p.done) == kPix) break;
    const int nb = min(kPix, end - base);
    gpt::stage_lane(s, inst, P, base, 0, nb, lin);
    __syncthreads();
    gpt::fwd_walk(s, 0, nb, px, py, rect, with_tidx, p);
  }
  gpt::fwd_store(out + ((long long)t * kPix + pix) * 8, p);
}

}  // namespace

extern "C" int gpt_blend_fwd(const void* inst, long long P,
                             const void* tile_start, const void* tile_end,
                             int num_tiles, int grid_x, int with_tidx,
                             void* out, void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  blend_fwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), grid_x, with_tidx,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
