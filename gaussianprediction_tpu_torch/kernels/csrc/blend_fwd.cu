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
// The per-(pixel, instance) arithmetic is gpt::pair_terms (common.cuh),
// which the backward kernel shares: _rn intrinsics (never contracted into
// FMAs) in the order of the plain PyTorch version, and IEEE expf.
//
// Bound on the H100: by the f32 arithmetic of the (pixel, instance) pairs
// evaluated up to each pixel's done latch (11 to 24 operations a pair,
// by how far the pair gets), against 67 TFLOP/s, beside the instances
// read up to each tile's last done pixel (12 channels x 4 bytes) and the
// output written once. Simple and right first: no warp-level culling, no
// pipelining of the next batch's loads.
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
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const float px = (float)(tx * 16 + (lin & 15));
  const float py = (float)(ty * 16 + (lin >> 4));
  const int start = tile_start[t];
  const int end = tile_end[t];

  float T = 1.0f;
  int done = 0;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, az = 0.0f;
  float wmax = 0.0f, bgid = -1.0f;

  for (int base = start; base < end; base += kPix) {
    // every pixel done -> leave; also the barrier before reusing s[][]
    if (__syncthreads_count(done) == kPix) break;
    const int idx = base + lin;
    if (idx < end) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) s[c][lin] = inst[c * P + idx];
    }
    __syncthreads();
    const int nb = min(kPix, end - base);
    for (int i = 0; i < nb && !done; ++i) {
      gpt::PairTerms q;
      if (!gpt::pair_terms(&s[0][i], kPix, px, py, T, q)) continue;
      if (q.test_T < gpt::kTEps) {
        done = 1;
        break;
      }
      const float w = __fmul_rn(q.alpha, T);
      ar = __fadd_rn(ar, __fmul_rn(w, s[6][i]));
      ag = __fadd_rn(ag, __fmul_rn(w, s[7][i]));
      ab = __fadd_rn(ab, __fmul_rn(w, s[8][i]));
      az = __fadd_rn(az, __fmul_rn(w, s[9][i]));
      T = q.test_T;
      if (with_tidx && w > wmax) {
        wmax = w;
        bgid = s[10][i];
      }
    }
  }
  float* o = out + ((long long)t * kPix + lin) * 8;
  o[0] = ar;
  o[1] = ag;
  o[2] = ab;
  o[3] = az;
  o[4] = T;
  o[5] = wmax;
  o[6] = bgid;
  o[7] = 0.0f;
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
