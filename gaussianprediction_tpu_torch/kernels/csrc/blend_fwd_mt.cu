// blend_fwd_mt: the forward blend of blend_fwd.cu (same outputs, bit for
// bit) with one block per tpb consecutive tiles, streaming their union
// window of the instance SoA once.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/rasterize_pallas.py
// _fwd_kernel_mt (GPT_BLEND_MT=1, GPT_BLEND_TPB=tpb). There one program
// owns tpb tiles, DMAs the window [start[t0], end[t0+tpb-1]) chunk by chunk
// and applies each chunk to every owned tile it intersects, the tiles'
// state kept in their output blocks. Here the block has 256 threads per
// owned tile (one per pixel), at most four tiles (1024 threads) at a time:
// tpb > 4 takes the owned tiles in passes of four, each over the part of
// the window that its tiles' segments span. The block stages each 256-lane
// block of that window into shared memory once, with all its threads, and
// each thread walks (gpt::fwd_walk) only the lanes in its own tile's
// segment, its state in registers. The block leaves the window once every
// thread's pixel is done or past its segment. Tiles past the last
// (num_tiles not a multiple of tpb) do nothing: the TPU's empty padding
// segments (_pad_tiles) have no work either.
//
// Each thread's walk is gpt::fwd_walk with its warp cull (see blend_fwd.cu):
// valid, lo and hi below are the same for the 256 threads of a tile group,
// and a warp lies in one group, so every warp votes whole.
//
// Bound on the H100: the same (pixel, instance) pairs as blend_fwd, so the
// same f32 operation bound.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kPix = gpt::kBlendPix;
constexpr int kCh = gpt::kBlendCh;
constexpr int kMaxGroups = 4;  // tiles a block walks at once

// Two blocks an SM (32 registers, some spilled): at one, as the cull's
// 56 registers would give, the kernel ran slower on an H100.
__global__ void __launch_bounds__(kPix * kMaxGroups, 2)
blend_fwd_mt_kernel(const float* __restrict__ inst, long long P,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_end, int num_tiles,
                    int grid_x, int tpb, int with_tidx,
                    float* __restrict__ out) {
  __shared__ float s[kCh][kPix];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int groups = nthreads / kPix;
  const int grp = tid / kPix;
  const int lin = tid - grp * kPix;
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
    float px, py;
    gpt::WarpRect rect;
    const int pix =
        gpt::fwd_tile_pixel(valid ? t : 0, grid_x, lin, px, py, rect);
    gpt::FwdPixel p = gpt::fwd_pixel();
    for (long long base = ws; base < we; base += kPix) {
      // every pixel done or past its segment -> leave; also the barrier
      // before reusing s[][]
      const int fin = !valid || p.done || end <= base;
      if (__syncthreads_count(fin) == nthreads) break;
      const int nb = (int)min(we - base, (long long)kPix);
      gpt::stage_block(s, inst, P, base, nb, tid, nthreads);
      __syncthreads();
      if (valid) {
        const int lo = (int)max((long long)start - base, 0LL);
        const int hi = (int)min((long long)end - base, (long long)kPix);
        gpt::fwd_walk(s, lo, hi, px, py, rect, with_tidx, p);
      }
    }
    if (valid) gpt::fwd_store(out + ((long long)t * kPix + pix) * 8, p);
  }
}

}  // namespace

extern "C" int gpt_blend_fwd_mt(const void* inst, long long P,
                                const void* tile_start, const void* tile_end,
                                int num_tiles, int grid_x, int tpb,
                                int with_tidx, void* out, void* stream) {
  if (num_tiles < 0 || grid_x < 1 || P < 0 || tpb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const int blocks = (num_tiles + tpb - 1) / tpb;
  const int threads = kPix * min(tpb, kMaxGroups);
  blend_fwd_mt_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(inst), P, static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), num_tiles, grid_x, tpb, with_tidx,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
