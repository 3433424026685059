// blend_bwd: per 16x16 tile, the gradient of the front-to-back blend with
// respect to every instance of the tile's segment [tile_start, tile_end) of
// the [16, P] instance SoA. Input dpix [T, 256, 8]: per pixel d(r, g, b, z)
// and Q = sum_c d_c * acc_c + dT * T_final. Output rows 0-9 of dinst
// [16, P]: d(mx, my, ca, cb, cc, op, r, g, b, z); rows 10-15 and every
// column outside a segment, or past the point where the tile's pixels are
// all done, stay as the caller allocated them (zero).
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _bwd_kernel (the classic branch of _rasterize_bwd_rule). Its math: one
// front-to-back sweep per pixel, recomputing alpha, T and the done latch as
// the forward did; with v = c . d_rgb + z * d_z and the running inclusive
// S += w * v, dalpha = T * v - (Q - S) / (1 - alpha); the gradient flows
// through the unclamped alpha: dpower = op * G * dalpha, dop = sum G *
// dalpha. The Pallas kernel does this with lane scans, a pixel-moment
// matrix and bf16x3 MXU splits; here, as in the reference CUDA rasterizer,
// one block per tile and one thread per pixel keep T, the done latch and S
// in registers (the dependency is per pixel, so no scan is needed), and the
// ten per-pixel products of each instance are summed over the tile's 256
// pixels: a reduce-scatter across each warp (12 shuffles; skipped by a warp
// none of whose pixels the instance touches), then the eight warps' sums in
// order from a double-buffered shared-memory array, folded by all 256
// threads a sub-batch of 32 instances at a time, each gradient row of the
// sub-batch's columns written once, coalesced.
//
// The TPU kernel read-modify-writes gradient blocks that neighbouring
// tiles share, which is race-free only because the TPU grid runs in order.
// Here every instance lies in exactly one tile's segment, each block writes
// only columns inside its own segment, nothing is read back and there are
// no atomics: the output is deterministic, bit for bit.
//
// The per-pixel arithmetic, the reduction and the column writes are
// gpt::bwd_walk (common.cuh), which the flat work-list and multi-tile
// kernels share, so all three write the same bits. alpha, T and the latch
// come from gpt::pair_terms, built of the same helpers as blend_fwd's walk
// (pair_power, pair_opacity, pair_T), so the latch fires on the same
// instance. Every other operation is an _rn intrinsic in the
// plain version's order.
//
// Bound on the H100: by the f32 arithmetic of the (pixel, instance) pairs
// up to each pixel's done latch, as the forward's, plus the gradient terms
// of the contributing pairs, against 67 TFLOP/s; beside the instances read
// (12 channels), dpix, and the 10 gradient rows written. The walk is a
// chain per pixel; what the reduction adds to it is one block barrier per
// 32 instances, 12 shuffles per instance a warp touches, and one shared
// store per warp and instance.
#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;

__global__ void __launch_bounds__(kPix)
blend_bwd_kernel(const float* __restrict__ inst, long long P,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int grid_x,
                 const float* __restrict__ dpix, float* __restrict__ dinst) {
  __shared__ float s[kCh][kPix];
  __shared__ gpt::Reduce red[2];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
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
}

}  // namespace

extern "C" int gpt_blend_bwd(const void* inst, long long P,
                             const void* tile_start, const void* tile_end,
                             int num_tiles, int grid_x, const void* dpix,
                             void* dinst, void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  blend_bwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), grid_x,
      static_cast<const float*>(dpix), static_cast<float*>(dinst));
  return (int)cudaGetLastError();
}
