// Shared helpers of the port's CUDA kernels (plain C interface, no PyTorch
// headers: the library is built by one nvcc call and loaded with ctypes).
#pragma once
#include <cuda_runtime.h>

namespace gpt {

// Up to 16 row pointers passed by value as one kernel parameter. Kernels
// take it as `const __grid_constant__`, so the block-uniform dynamic index
// rows.p[c] reads the parameter bank in place instead of first copying the
// whole struct to each thread's local memory.
struct RowPtrs {
  const float* p[16];
};

inline RowPtrs make_row_ptrs(const void* const* ptrs, int k) {
  RowPtrs r;
  for (int c = 0; c < 16; ++c) {
    r.p[c] = c < k ? static_cast<const float*>(ptrs[c]) : nullptr;
  }
  return r;
}

// ---------------------------------------------------------------- blend
// Packed instance channels of the [16, P] SoA the blend kernels read.
constexpr int kBlendPix = 256;  // pixels per 16x16 tile, one thread each
constexpr int kBlendCh = 12;    // mx, my, ca, cb, cc, op, r, g, b, z, gid, valid

constexpr float kTEps = (float)1e-4;  // the done latch: T would drop below

struct PairTerms {
  float dx, dy, G, alpha, test_T;
};

// The per-(pixel, instance) blend arithmetic, shared by the forward and
// backward kernels so that the backward recomputes alpha, T and the done
// latch bit for bit as the forward did. s[c * st] is the instance's
// channel c (st: the stride of the SoA staged in shared memory), (px, py)
// the pixel centre, T the pixel's transmittance before the instance. Every
// operation is an _rn intrinsic (nvcc never contracts those into FMAs) in
// the plain PyTorch version's order, and expf is the IEEE one (no fast
// math). Returns false where the pair is skipped (invalid instance,
// power > 0 or alpha < 1/255); else q.test_T = T * (1 - alpha), and the
// caller latches the pixel done (this instance not contributing) where
// q.test_T < kTEps. The early returns let the compiler branch straight to
// the caller's `continue`, as the forward did before it shared this code.
__device__ __forceinline__ bool pair_terms(const float* s, int st, float px,
                                           float py, float T, PairTerms& q) {
  if (!(s[11 * st] > 0.5f)) return false;
  q.dx = __fsub_rn(px, s[0 * st]);
  q.dy = __fsub_rn(py, s[1 * st]);
  const float qa = __fmul_rn(__fmul_rn(s[2 * st], q.dx), q.dx);
  const float qc = __fmul_rn(__fmul_rn(s[4 * st], q.dy), q.dy);
  const float qb = __fmul_rn(__fmul_rn(s[3 * st], q.dx), q.dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  if (!(power <= 0.0f)) return false;
  q.G = expf(power);
  const float a = __fmul_rn(s[5 * st], q.G);
  q.alpha = a > 0.99f ? 0.99f : a;  // NaN stays NaN
  if (!(q.alpha >= (float)(1.0 / 255.0))) return false;
  q.test_T = __fmul_rn(T, __fsub_rn(1.0f, q.alpha));
  return true;
}

// ------------------------------------------------ blend: the tile walks
// Every blend kernel (classic, flat work list, multi-tile) stages blocks of
// up to 256 consecutive instances into a [12][256] shared array and walks
// the lanes of a block that lie in one tile's segment, each thread one
// pixel of that tile, in segment order. The walks below are the only
// per-pixel code of the six kernels, so any launch geometry that hands
// each tile its segment in order gives the classic kernels' outputs bit for
// bit.
typedef float Staged[kBlendPix];  // s[c][i]: channel c of lane i

__device__ __forceinline__ void tile_pixel(int t, int grid_x, int lin,
                                           float& px, float& py) {
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  px = (float)(tx * 16 + (lin & 15));
  py = (float)(ty * 16 + (lin >> 4));
}

// s[c][lin] = inst[c * P + base + lin] where lane lin lies in [lo, hi),
// for a block of 256 threads (one tile): the thread's 12 loads are issued
// together (the rolled loop of stage_block costs the one-tile kernels a few
// per cent: their blocks are many, and short on independent loads).
__device__ __forceinline__ void stage_lane(Staged* s, const float* inst,
                                           long long P, long long base,
                                           int lo, int hi, int lin) {
  if (lin < lo || lin >= hi) return;
#pragma unroll
  for (int c = 0; c < kBlendCh; ++c) s[c][lin] = inst[c * P + base + lin];
}

// The same for lanes [0, hi) by the nthreads threads of a multi-tile
// block, element by element (lane-contiguous, so the loads coalesce). A
// loop the compiler keeps rolled: the unrolled form costs the 1024-thread
// blocks registers enough to halve their occupancy.
__device__ __forceinline__ void stage_block(Staged* s, const float* inst,
                                            long long P, long long base,
                                            int hi, int tid, int nthreads) {
  for (int k = tid; k < kBlendCh * kBlendPix; k += nthreads) {
    const int c = k / kBlendPix;
    const int i = k - c * kBlendPix;
    if (i < hi) s[c][i] = inst[c * P + base + i];
  }
}

// One pixel's forward state: accumulated r, g, b, depth, T, the done
// latch, and the first strict maximum of the blend weight with its gid.
struct FwdPixel {
  float T, ar, ag, ab, az, wmax, bgid;
  int done;
};

__device__ __forceinline__ FwdPixel fwd_pixel() {
  FwdPixel q;
  q.T = 1.0f;
  q.ar = q.ag = q.ab = q.az = 0.0f;
  q.wmax = 0.0f;
  q.bgid = -1.0f;
  q.done = 0;
  return q;
}

// Blend lanes [lo, hi) of the staged block into pixel (px, py) in order;
// stops at the done latch.
__device__ __forceinline__ void fwd_walk(const Staged* s, int lo, int hi,
                                         float px, float py, int with_tidx,
                                         FwdPixel& p) {
  for (int i = lo; i < hi && !p.done; ++i) {
    PairTerms q;
    if (!pair_terms(&s[0][i], kBlendPix, px, py, p.T, q)) continue;
    if (q.test_T < kTEps) {
      p.done = 1;
      break;
    }
    const float w = __fmul_rn(q.alpha, p.T);
    p.ar = __fadd_rn(p.ar, __fmul_rn(w, s[6][i]));
    p.ag = __fadd_rn(p.ag, __fmul_rn(w, s[7][i]));
    p.ab = __fadd_rn(p.ab, __fmul_rn(w, s[8][i]));
    p.az = __fadd_rn(p.az, __fmul_rn(w, s[9][i]));
    p.T = q.test_T;
    if (with_tidx && w > p.wmax) {
      p.wmax = w;
      p.bgid = s[10][i];
    }
  }
}

// The pixel's output row: r, g, b, depth, T_final, w_max, gid, pad.
__device__ __forceinline__ void fwd_store(float* o, const FwdPixel& p) {
  o[0] = p.ar;
  o[1] = p.ag;
  o[2] = p.ab;
  o[3] = p.az;
  o[4] = p.T;
  o[5] = p.wmax;
  o[6] = p.bgid;
  o[7] = 0.0f;
}

// --------------------------------------------- blend backward: the walk
constexpr int kBlendWarps = kBlendPix / 32;
constexpr int kBlendSub = 32;   // instances per reduction sub-batch
constexpr int kBlendGrad = 10;  // gradient rows written per instance
typedef float Reduce[kBlendWarps][kBlendGrad];  // red[j][warp][k]

// One pixel's backward state: its centre, d(r, g, b, z) and Q from dpix,
// the recomputed T and done latch, and the running inclusive S of w * v.
struct BwdPixel {
  float px, py, d0, d1, d2, d3, Q, T, S;
  int done;
};

__device__ __forceinline__ BwdPixel bwd_pixel(int t, int grid_x, int lin,
                                              const float* dpix) {
  BwdPixel p;
  tile_pixel(t, grid_x, lin, p.px, p.py);
  const float* dp = dpix + ((long long)t * kBlendPix + lin) * 8;
  p.d0 = dp[0];
  p.d1 = dp[1];
  p.d2 = dp[2];
  p.d3 = dp[3];
  p.Q = dp[4];
  p.T = 1.0f;
  p.S = 0.0f;
  p.done = 0;
  return p;
}

// The ten per-pixel products of lane i for this pixel (g, zero on entry,
// stays zero where the pair does not contribute); advances T, S and the
// latch as the forward did. Returns whether the pair contributes.
__device__ __forceinline__ bool bwd_terms(const Staged* s, int i,
                                          BwdPixel& p, float* g) {
  PairTerms q;
  if (p.done || !pair_terms(&s[0][i], kBlendPix, p.px, p.py, p.T, q)) {
    return false;
  }
  if (q.test_T < kTEps) {
    p.done = 1;
    return false;
  }
  const float w = __fmul_rn(q.alpha, p.T);
  const float v = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(s[6][i], p.d0), __fmul_rn(s[7][i], p.d1)),
                __fmul_rn(s[8][i], p.d2)),
      __fmul_rn(s[9][i], p.d3));
  p.S = __fadd_rn(p.S, __fmul_rn(w, v));
  const float dalpha = __fsub_rn(
      __fmul_rn(p.T, v),
      __fdiv_rn(__fsub_rn(p.Q, p.S), __fsub_rn(1.0f, q.alpha)));
  const float dpower = __fmul_rn(__fmul_rn(s[5][i], q.G), dalpha);
  const float gdx = __fmul_rn(dpower, q.dx);
  const float gdy = __fmul_rn(dpower, q.dy);
  g[0] = gdx;
  g[1] = gdy;
  g[2] = __fmul_rn(gdx, q.dx);
  g[3] = __fmul_rn(gdx, q.dy);
  g[4] = __fmul_rn(gdy, q.dy);
  g[5] = __fmul_rn(q.G, dalpha);
  g[6] = __fmul_rn(p.d0, w);
  g[7] = __fmul_rn(p.d1, w);
  g[8] = __fmul_rn(p.d2, w);
  g[9] = __fmul_rn(p.d3, w);
  p.T = q.test_T;
  return true;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// The barriers of one tile's 256 threads: the whole block where a block
// is one tile, else named barrier `id` (1-15) of 256 threads, so that the
// tile groups of a multi-tile block synchronise apart.
struct BlockBarrier {
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ int count(int pred) const {
    return __syncthreads_count(pred);
  }
};

struct GroupBarrier {
  int id;
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kBlendPix) : "memory");
  }
  __device__ __forceinline__ int count(int pred) const {
    int r;
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %1, 0;\n\t"
        "bar.red.popc.u32 %0, %2, %3, p;\n\t}"
        : "=r"(r)
        : "r"(pred), "r"(id), "n"(kBlendPix)
        : "memory");
    return r;
  }
};

// The backward walk of lanes [lo, hi) of the staged block (its lane 0 is
// instance `base`) for a tile whose segment is [start, end), by the tile's
// 256 threads (lin: this thread's pixel). Each instance's ten products are
// summed over the tile's pixels in one fixed order: warp shuffles (skipped
// by a warp none of whose pixels the instance touches), then the eight
// warps in order through red[][][]; one thread per instance then writes
// rows 0-9 of its column of dinst once. Sums go by sub-batches of 32
// instances of the tile's segment (ranks 32k .. 32k+31 from `start`), cut
// short at the block's edge; at the end of a whole sub-batch (or of the
// segment) the walk returns true if every pixel of the tile is done, and
// the tile stops there. So every launch geometry writes the same columns
// as the classic kernel: the segment up to the end of the sub-batch in
// which its last pixel latched.
template <class Bar>
__device__ __forceinline__ bool bwd_walk(const Staged* s, Reduce* red,
                                         long long base, int lo, int hi,
                                         int start, int end, BwdPixel& p,
                                         float* dinst, long long P, int lin,
                                         const Bar& bar) {
  const int lane = lin & 31;
  const int warp = lin >> 5;
  for (int i = lo; i < hi;) {
    const int r = (int)(base + i - start);  // rank in the segment
    const int n = min(hi - i, kBlendSub - (r & (kBlendSub - 1)));
    for (int j = 0; j < n; ++j) {
      float g[kBlendGrad];
#pragma unroll
      for (int k = 0; k < kBlendGrad; ++k) g[k] = 0.0f;
      const bool contrib = bwd_terms(s, i + j, p, g);
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int k = 0; k < kBlendGrad; ++k) g[k] = warp_sum(g[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kBlendGrad; ++k) red[j][warp][k] = g[k];
      }
    }
    bar.sync();
    if (lin < n) {
      const int c = i + lin;
      float a[kBlendGrad];
#pragma unroll
      for (int k = 0; k < kBlendGrad; ++k) {
        float x = red[lin][0][k];
#pragma unroll
        for (int wi = 1; wi < kBlendWarps; ++wi) {
          x = __fadd_rn(x, red[lin][wi][k]);
        }
        a[k] = x;
      }
      const float ca = s[2][c], cb = s[3][c], cc = s[4][c];
      float* o = dinst + (base + c);
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
    i += n;
    // the barrier before red[][][] is refilled; at a sub-batch's end, also
    // the all-done test
    if (((r + n) & (kBlendSub - 1)) == 0 || base + i == end) {
      if (bar.count(p.done) == kBlendPix) return true;
    } else {
      bar.sync();
    }
  }
  return false;
}

}  // namespace gpt
