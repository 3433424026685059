// blend_fwd_smt: the forward blend of blend_fwd.cu (same outputs, bit for
// bit) with one block per smt consecutive tiles, which it blends one after
// another.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _fwd_kernel_smt (GPT_BLEND_SMT=smt). There one grid program runs smt
// complete per-tile loops in sequence, each tile with its own fresh state,
// to spread the TPU's fixed cost of a grid program over smt tiles; the
// tile arrays are padded to a multiple of smt with empty segments. Here
// the block of 256 threads (one per pixel) walks each owned tile exactly as
// blend_fwd.cu walks its one tile: the segment staged through shared
// memory in blocks of 256 instances, gpt::fwd_walk per pixel, the tile left
// early once every pixel is done, the state reset for the next tile. The
// last block may own fewer than smt tiles: the tile index is bound-checked
// and nothing is padded on the card. Any smt >= 1 works.
//
// The H100 has no per-block cost of that size to hide, and the card holds
// smt times fewer blocks, each walking its tiles in turn: expect it no
// faster than blend_fwd.cu. It is the function the JAX package offers
// under that variable, ported as it is.
//
// The walk is gpt::fwd_walk with its warp cull (see blend_fwd.cu), called
// by the whole block for one tile at a time.
//
// Bound on the H100: the same (pixel, instance) pairs as blend_fwd, so the
// same f32 operation bound.
#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;

__global__ void __launch_bounds__(kPix)
blend_fwd_smt_kernel(const float* __restrict__ inst, long long P,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end, int num_tiles,
                     int grid_x, int smt, int with_tidx,
                     float* __restrict__ out) {
  __shared__ float s[kCh][kPix];
  const int lin = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * smt;
  const int tlast = (int)min(t0 + smt, (long long)num_tiles);
  for (int t = (int)t0; t < tlast; ++t) {
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
    __syncthreads();  // the tile's last reads of s[][] before the next's
  }
}

}  // namespace

extern "C" int gpt_blend_fwd_smt(const void* inst, long long P,
                                 const void* tile_start, const void* tile_end,
                                 int num_tiles, int grid_x, int smt,
                                 int with_tidx, void* out, void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0 || smt < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const long long blocks = ((long long)num_tiles + smt - 1) / smt;
  blend_fwd_smt_kernel<<<(unsigned)blocks, kPix, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), num_tiles, grid_x, smt, with_tidx,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
