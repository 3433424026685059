// blend_bwd_smt: the backward blend of blend_bwd.cu (same outputs, bit for
// bit) with the block geometry of blend_fwd_smt.cu: one block of 256
// threads per smt consecutive tiles, walked one after another.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _bwd_kernel_smt (GPT_BLEND_SMT=smt), which runs smt complete per-tile
// backward loops in sequence in one grid program, with dpix zero-padded
// to the padded tile count. Here each owned tile is walked as blend_bwd.cu
// walks its one tile: the recomputed forward state (T, the done latch, the
// running S) fresh per tile in registers, gpt::bwd_walk over the segment
// in staged blocks of 256, its ten products summed over the pixels in one
// fixed order and each column's rows written once by the block's folds;
// the tile stops at the end of the sub-batch of 32 ranks in which its last
// pixel latched done. Every instance lies in one tile's segment, so no
// column is written twice and there are no atomics: two launches are
// bit-identical and equal to blend_bwd.cu's. The last block may own fewer
// than smt tiles (bound-checked; nothing is padded on the card).
//
// Bound on the H100: the same pairs and gradient terms as blend_bwd, so
// the same f32 operation bound.
#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;

__global__ void __launch_bounds__(kPix)
blend_bwd_smt_kernel(const float* __restrict__ inst, long long P,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end, int num_tiles,
                     int grid_x, int smt, const float* __restrict__ dpix,
                     float* __restrict__ dinst) {
  __shared__ float s[kCh][kPix];
  __shared__ gpt::Reduce red[2];
  const int lin = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * smt;
  const int tlast = (int)min(t0 + smt, (long long)num_tiles);
  for (int t = (int)t0; t < tlast; ++t) {
    const int start = tile_start[t];
    const int end = tile_end[t];
    gpt::BwdPixel p = gpt::bwd_pixel(t, grid_x, lin, dpix);
    // each walk's last read of s[][] precedes its last barrier
    for (int base = start; base < end; base += kPix) {
      const int nb = min(kPix, end - base);
      gpt::stage_lane(s, inst, P, base, 0, nb, lin);
      __syncthreads();
      if (gpt::bwd_walk(s, red, inst, base, 0, nb, start, end, p, dinst, P,
                        lin, gpt::BlockBarrier{})) {
        break;
      }
    }
    __syncthreads();  // between tiles: s[][] and red are reused
  }
}

}  // namespace

extern "C" int gpt_blend_bwd_smt(const void* inst, long long P,
                                 const void* tile_start, const void* tile_end,
                                 int num_tiles, int grid_x, int smt,
                                 const void* dpix, void* dinst, void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0 || smt < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const long long blocks = ((long long)num_tiles + smt - 1) / smt;
  blend_bwd_smt_kernel<<<(unsigned)blocks, kPix, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), num_tiles, grid_x, smt,
      static_cast<const float*>(dpix), static_cast<float*>(dinst));
  return (int)cudaGetLastError();
}
