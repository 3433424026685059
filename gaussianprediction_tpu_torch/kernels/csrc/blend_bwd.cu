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
// pixels: warp shuffles (skipped by a warp none of whose pixels the
// instance touches), then an [instances][8 warps][10] shared-memory pass
// over sub-batches of 32 instances, and one thread per instance writes its
// column once.
//
// The TPU kernel read-modify-writes gradient blocks that neighbouring
// tiles share, which is race-free only because the TPU grid runs in order.
// Here every instance lies in exactly one tile's segment, each block writes
// only columns inside its own segment, nothing is read back and there are
// no atomics: the output is deterministic, bit for bit.
//
// alpha, T and the latch come from gpt::pair_terms (common.cuh), the same
// code as blend_fwd, so the latch fires on the same instance. Every other
// operation is an _rn intrinsic in the plain version's order.
//
// Bound on the H100: by the f32 arithmetic of the (pixel, instance) pairs
// up to each pixel's done latch, as the forward's, plus the gradient terms
// of the contributing pairs, against 67 TFLOP/s; beside the instances read
// (12 channels), dpix, and the 10 gradient rows written. Simple and right
// first: two block barriers per 32 instances.
#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;
constexpr int kWarps = kPix / 32;
constexpr int kSub = 32;   // instances per reduction sub-batch
constexpr int kGrad = 10;  // gradient rows written per instance

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__global__ void __launch_bounds__(kPix)
blend_bwd_kernel(const float* __restrict__ inst, long long P,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int grid_x,
                 const float* __restrict__ dpix, float* __restrict__ dinst) {
  __shared__ float s[kCh][kPix];
  __shared__ float red[kSub][kWarps][kGrad];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const float px = (float)(tx * 16 + (lin & 15));
  const float py = (float)(ty * 16 + (lin >> 4));
  const int start = tile_start[t];
  const int end = tile_end[t];
  const float* dp = dpix + ((long long)t * kPix + lin) * 8;
  const float d0 = dp[0], d1 = dp[1], d2 = dp[2], d3 = dp[3], Q = dp[4];

  float T = 1.0f;
  float S = 0.0f;
  int done = 0;
  bool all_done = false;

  for (int base = start; base < end && !all_done; base += kPix) {
    // every pixel done -> leave; also the barrier before reusing s[][]
    if (__syncthreads_count(done) == kPix) break;
    const int idx = base + lin;
    if (idx < end) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) s[c][lin] = inst[c * P + idx];
    }
    __syncthreads();
    const int nb = min(kPix, end - base);
    for (int sub = 0; sub < nb; sub += kSub) {
      const int ns = min(kSub, nb - sub);
      for (int j = 0; j < ns; ++j) {
        const int i = sub + j;
        float g[kGrad];
#pragma unroll
        for (int k = 0; k < kGrad; ++k) g[k] = 0.0f;
        bool contrib = false;
        gpt::PairTerms q;
        if (!done && gpt::pair_terms(&s[0][i], kPix, px, py, T, q)) {
          if (q.test_T < gpt::kTEps) {
            done = 1;
          } else {
            contrib = true;
            const float w = __fmul_rn(q.alpha, T);
            const float v = __fadd_rn(
                __fadd_rn(__fadd_rn(__fmul_rn(s[6][i], d0),
                                    __fmul_rn(s[7][i], d1)),
                          __fmul_rn(s[8][i], d2)),
                __fmul_rn(s[9][i], d3));
            S = __fadd_rn(S, __fmul_rn(w, v));
            const float dalpha = __fsub_rn(
                __fmul_rn(T, v),
                __fdiv_rn(__fsub_rn(Q, S), __fsub_rn(1.0f, q.alpha)));
            const float dpower = __fmul_rn(__fmul_rn(s[5][i], q.G), dalpha);
            const float gdx = __fmul_rn(dpower, q.dx);
            const float gdy = __fmul_rn(dpower, q.dy);
            g[0] = gdx;
            g[1] = gdy;
            g[2] = __fmul_rn(gdx, q.dx);
            g[3] = __fmul_rn(gdx, q.dy);
            g[4] = __fmul_rn(gdy, q.dy);
            g[5] = __fmul_rn(q.G, dalpha);
            g[6] = __fmul_rn(d0, w);
            g[7] = __fmul_rn(d1, w);
            g[8] = __fmul_rn(d2, w);
            g[9] = __fmul_rn(d3, w);
            T = q.test_T;
          }
        }
        if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
          for (int k = 0; k < kGrad; ++k) g[k] = warp_sum(g[k]);
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < kGrad; ++k) red[j][warp][k] = g[k];
        }
      }
      __syncthreads();
      if (lin < ns) {
        const int i = sub + lin;
        float a[kGrad];
#pragma unroll
        for (int k = 0; k < kGrad; ++k) {
          float x = red[lin][0][k];
#pragma unroll
          for (int wi = 1; wi < kWarps; ++wi) x = __fadd_rn(x, red[lin][wi][k]);
          a[k] = x;
        }
        const float ca = s[2][i], cb = s[3][i], cc = s[4][i];
        float* o = dinst + (base + i);
        o[0 * P] = __fadd_rn(__fmul_rn(ca, a[0]), __fmul_rn(cb, a[1]));
        o[1 * P] = __fadd_rn(__fmul_rn(cb, a[0]), __fmul_rn(cc, a[1]));
        o[2 * P] = __fmul_rn(-0.5f, a[2]);
        o[3 * P] = -a[3];
        o[4 * P] = __fmul_rn(-0.5f, a[4]);
        o[5 * P] = a[5];
        o[6 * P] = a[6];
        o[7 * P] = a[7];
        o[8 * P] = a[8];
        o[9 * P] = a[9];
      }
      // barrier before red[][] is refilled; leave once every pixel is done
      if (__syncthreads_count(done) == kPix) {
        all_done = true;
        break;
      }
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
