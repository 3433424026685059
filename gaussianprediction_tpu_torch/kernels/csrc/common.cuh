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

// ------------------------------------------------- 16-byte row copies
// The copy kernels (stack_rows, interleave_rows) move 4 consecutive
// positions of a row at a time: one float4 where the row's base is 16-byte
// aligned (`vec`), else 4 scalars.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void store4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

// ---------------------------------------------------------------- blend
// Packed instance channels of the [16, P] SoA the blend kernels read.
constexpr int kBlendPix = 256;  // pixels per 16x16 tile, one thread each
constexpr int kBlendCh = 12;    // mx, my, ca, cb, cc, op, r, g, b, z, gid, valid

constexpr float kTEps = (float)1e-4;  // the done latch: T would drop below

struct PairTerms {
  float dx, dy, G, alpha, test_T;
};

constexpr float kAlphaMin = (float)(1.0 / 255.0);  // alpha's skip test

// The per-(pixel, instance) blend arithmetic, shared by the forward and
// backward kernels so that the backward recomputes alpha, T and the done
// latch bit for bit as the forward did. s[c * st] is the instance's
// channel c (st: the stride of the SoA staged in shared memory), (px, py)
// the pixel centre, T the pixel's transmittance. Every operation is an _rn
// intrinsic (nvcc never contracts those into FMAs) in the plain PyTorch
// version's order, and expf is the IEEE one (no fast math).

// The pair's power; sets q.dx, q.dy.
__device__ __forceinline__ float pair_power(const float* s, int st, float px,
                                            float py, PairTerms& q) {
  q.dx = __fsub_rn(px, s[0 * st]);
  q.dy = __fsub_rn(py, s[1 * st]);
  const float qa = __fmul_rn(__fmul_rn(s[2 * st], q.dx), q.dx);
  const float qc = __fmul_rn(__fmul_rn(s[4 * st], q.dy), q.dy);
  const float qb = __fmul_rn(__fmul_rn(s[3 * st], q.dx), q.dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
}

// q.G and q.alpha from the pair's power.
__device__ __forceinline__ void pair_opacity(const float* s, int st,
                                             float power, PairTerms& q) {
  q.G = expf(power);
  const float a = __fmul_rn(s[5 * st], q.G);
  q.alpha = a > 0.99f ? 0.99f : a;  // NaN stays NaN
}

// T after a contributing pair of opacity alpha.
__device__ __forceinline__ float pair_T(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// The backward's pair: returns false where the pair is skipped (invalid
// instance, power > 0 or alpha < 1/255); else q.test_T = T * (1 - alpha)
// with T the pixel's transmittance before the instance, and the caller
// latches the pixel done (this instance not contributing) where q.test_T <
// kTEps. The early returns let the compiler branch straight to the
// caller's `continue`. The forward takes the same helpers without the
// early returns (pair_alpha, fwd_apply).
__device__ __forceinline__ bool pair_terms(const float* s, int st, float px,
                                           float py, float T, PairTerms& q) {
  if (!(s[11 * st] > 0.5f)) return false;
  const float power = pair_power(s, st, px, py, q);
  if (!(power <= 0.0f)) return false;
  pair_opacity(s, st, power, q);
  if (!(q.alpha >= kAlphaMin)) return false;
  q.test_T = pair_T(T, q.alpha);
  return true;
}

// ------------------------------------------------ blend: the tile walks
// Every blend kernel (classic, flat work list, multi-tile) stages blocks of
// up to 256 consecutive instances into a [12][256] shared array and walks
// the lanes of a block that lie in one tile's segment, each thread one
// pixel of that tile, in segment order. The walks below are the only
// per-pixel code of the eight kernels, so any launch geometry that hands
// each tile its segment in order gives the classic kernels' outputs bit for
// bit.
typedef float Staged[kBlendPix];  // s[c][i]: channel c of lane i

// The backward kernels' pixel of thread lin: two rows of 16 a warp.
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

// ------------------------------------- blend forward: the warp's footprint
// The forward kernels map a tile's 256 threads to its pixels so that each
// warp covers an 8 x 4 patch of pixel centres (integers), which the walk
// culls instances against: a patch lets both the x and the y extent of a
// footprint cull, where two rows of 16 let only y (on an H100 the patches
// ran faster). The output row of each pixel stays at its own index
// (row * 16 + column). The backward keeps tile_pixel's map: its warp sums
// pair lanes by pixel, and their bits depend on it.
struct WarpRect {
  float x0, x1, y0, y1;  // the warp's pixel centres span [x0, x1] x [y0, y1]
};

// Thread lin's pixel (px, py) of tile t and its warp's rectangle; returns
// the pixel's index in the tile. Warp w covers columns 8 (w & 1) .. +7 and
// rows 4 (w >> 1) .. +3; its lane l sits at (l & 7, l >> 3) in them.
__device__ __forceinline__ int fwd_tile_pixel(int t, int grid_x, int lin,
                                              float& px, float& py,
                                              WarpRect& r) {
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const int w = lin >> 5;
  const int c0 = (w & 1) * 8, r0 = (w >> 1) * 4;
  const int col = c0 + (lin & 7), row = r0 + ((lin & 31) >> 3);
  r.x0 = (float)(tx * 16 + c0);
  r.x1 = r.x0 + 7.0f;
  r.y0 = (float)(ty * 16 + r0);
  r.y1 = r.y0 + 3.0f;
  px = (float)(tx * 16 + col);
  py = (float)(ty * 16 + row);
  return row * 16 + col;
}

// The cull's margins. A pixel passes pair_terms only if its f32 power
// satisfies -2 power <= 2 ln(op / a_min), a_min = (float)(1/255), up to
// the rounding of the opacity product (2^-24) and expf's error (at most
// 2 ulp): kCullR2Abs (1e-4) on r2 = 2 ln(op / a_min) covers both, and the
// f32 logf that computes r2 (1 ulp, at most ~1e-5 absolute for any finite
// op). The f32 power (dx, dy and five rounded operations) differs from
// the exact quadratic form Q at the pixel by at most 12 u S, u = 2^-24,
// S = ca dx^2 + cc dy^2 <= K Q with K = (ca + cc)^2 / det; so Q <= r2 (1 +
// 24 u K) while 12 u K <= 1/2, and the support is widened to Q <= R^2 =
// r2 ((1 + kCullRel)^2 + 64 u K) (kCullThin = 64 u, a factor 2.7 of room),
// its bounding box then by kCullPx pixels. The test's own f32 operations
// (at most ~6 roundings on either side of a compare) are covered by
// kCullRel's 2e-3 on R^2 many times over; det alone is taken in double,
// where ca * cc and cb * cb are exact, because in f32 it cancels. No
// instance is culled where K >= 1 / (2 kCullThin) (about 1.3e5: a
// footprint that thin is rare), op <= kCullOpMin (an empty or point
// support), det <= 1e-30 (not positive definite, or so small that f32
// products underflow) or a channel read is not finite. f32 overflow in
// pair_terms only ever fails a pair. The same test in double ran slower on
// an H100 (56 registers against 40).
constexpr float kCullOpMin = kAlphaMin * 1.001f;
constexpr float kCullR2Abs = 1e-4f;
constexpr float kCullRel2 = 1.002001f;  // (1 + kCullRel)^2, kCullRel = 1e-3
constexpr float kCullThin = 64.0f / 16777216.0f;
constexpr float kCullPx = 1e-2f;

// Whether some pixel centre of rectangle r may pass pair_terms against
// the instance whose channel c is s[c * st]: false only where none can
// (an invalid instance, or one whose widened support box misses r). The
// box's half extents are R sqrt(cc / det) and R sqrt(ca / det) (the
// conic's inverse is the 2-d covariance); the test squares both sides.
__device__ __forceinline__ bool warp_keeps(const float* s, int st,
                                           const WarpRect& r) {
  if (!(s[11 * st] > 0.5f)) return false;  // pair_terms rejects it first
  const float mx = s[0], my = s[st], ca = s[2 * st], cb = s[3 * st],
              cc = s[4 * st], op = s[5 * st];
  // a NaN or inf channel makes the sum NaN or inf (as may a huge finite
  // one: kept too)
  if (!(fabsf(mx + my + ca + cb + cc + op) < 1e38f)) return true;
  if (!(op > kCullOpMin) || !(ca > 0.0f)) return true;
  const float det = (float)((double)ca * cc - (double)cb * cb);
  if (!(det > 1e-30f)) return true;
  const float tr = ca + cc;
  const float thin = kCullThin * tr * tr;
  if (!(2.0f * thin < det)) return true;
  const float rr = (2.0f * logf(op / kAlphaMin) + kCullR2Abs) *
                   (kCullRel2 + thin / det);  // R^2
  const float dx = fmaxf(fmaxf(r.x0 - mx, mx - r.x1) - kCullPx, 0.0f);
  const float dy = fmaxf(fmaxf(r.y0 - my, my - r.y1) - kCullPx, 0.0f);
  return dx * dx * det <= rr * cc && dy * dy * det <= rr * ca;
}

// pair_terms' tests for an instance the cull kept (so valid > 0.5),
// without its early returns: q.dx, q.dy, q.G and q.alpha have pair_terms'
// bits where it returns true, and this returns true exactly there. With no
// branch the walk evaluates two pairs side by side.
__device__ __forceinline__ bool pair_alpha(const float* s, int st, float px,
                                           float py, PairTerms& q) {
  const float power = pair_power(s, st, px, py, q);
  pair_opacity(s, st, power, q);
  return power <= 0.0f && q.alpha >= kAlphaMin;
}

// Blend a passing pair (q from pair_alpha, staged lane i) into p: T's
// step and the done latch as pair_terms and the backward take them, the
// weight, the four sums and the top weight.
__device__ __forceinline__ void fwd_apply(const Staged* s, int i,
                                          const PairTerms& q, int with_tidx,
                                          FwdPixel& p) {
  const float test_T = pair_T(p.T, q.alpha);
  if (test_T < kTEps) {
    p.done = 1;
    return;
  }
  const float w = __fmul_rn(q.alpha, p.T);
  p.ar = __fadd_rn(p.ar, __fmul_rn(w, s[6][i]));
  p.ag = __fadd_rn(p.ag, __fmul_rn(w, s[7][i]));
  p.ab = __fadd_rn(p.ab, __fmul_rn(w, s[8][i]));
  p.az = __fadd_rn(p.az, __fmul_rn(w, s[9][i]));
  p.T = test_T;
  if (with_tidx && w > p.wmax) {
    p.wmax = w;
    p.bgid = s[10][i];
  }
}

// Blend lanes [lo, hi) of the staged block into pixel (px, py) in order,
// up to the done latch. The warp takes the lanes 32 at a time: lane j
// tests lane lo + 32 k + j against the warp's rectangle r (warp_keeps), a
// ballot gathers the chunk's keep mask, and the warp walks its set bits in
// order, so the pairs of a culled instance cost nothing. A culled pair is
// one whose pair_terms would have returned false for every pixel of the
// warp, which changes no state, so the outputs keep their bits. The set
// bits go two at a time: both pairs' alpha first (independent of T), then
// each applied in order, so two dependent chains overlap. The warp leaves
// once all its pixels are done; a done lane still votes. Callers call
// this warp-uniformly: lo and hi are the same for every thread of a tile,
// and a warp never straddles two tiles (the ballots need whole warps).
__device__ __forceinline__ void fwd_walk(const Staged* s, int lo, int hi,
                                         float px, float py,
                                         const WarpRect& r, int with_tidx,
                                         FwdPixel& p) {
  const int lane = threadIdx.x & 31;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    if (__all_sync(0xffffffffu, p.done)) return;
    const int j = c0 + lane;
    const bool keep = j < hi && warp_keeps(&s[0][j], kBlendPix, r);
    unsigned m = __ballot_sync(0xffffffffu, keep);
    while (m) {
      const int i = c0 + __ffs(m) - 1;
      m &= m - 1;
      const int i2 = m ? c0 + __ffs(m) - 1 : -1;  // warp-uniform
      m &= m - 1;
      PairTerms a, b;
      const bool ka = pair_alpha(&s[0][i], kBlendPix, px, py, a);
      const bool kb = i2 >= 0 && pair_alpha(&s[0][i2], kBlendPix, px, py, b);
      if (ka && !p.done) fwd_apply(s, i, a, with_tidx, p);
      if (kb && !p.done) fwd_apply(s, i2, b, with_tidx, p);
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

// One sub-batch's warp sums: product k of instance j from warp w at
// v[k * kRedRow + w * 32 + j]. The row stride is odd, so the ten lanes that
// write one instance's ten products hit ten banks, and the 32 lanes that
// read one (product, warp) row read 32 consecutive words. The walks keep
// two, one filled while the other is folded.
constexpr int kRedRow = kBlendWarps * kBlendSub + 1;
struct Reduce {
  float v[kBlendGrad * kRedRow];
};

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

// ------------------------------- blend backward: the warp's ten sums
// The ten products of an instance are summed over a warp's 32 pixels by a
// reduce-scatter: at xor offsets 16, 8, 4, 2, 1 the two lanes of a pair
// hold the partial sums of the same n products; the lane whose offset bit
// is clear keeps the first h = ceil(n / 2), its partner the rest, and each
// adds the partner's partial to its own. That is 5 + 3 + 2 + 1 + 1 = 12
// shuffles, where a butterfly of each product takes 50. Every partial adds
// the same two lanes' values as the butterfly x + shfl_xor(x, o) does (f32
// addition commutes), so each product's sum has the butterfly's bits: over
// lanes [0, 32) it is the sum of halves, (x[l] + x[l + 16]) and so on down
// to offset 1, the order the plain version takes with sums="kernel"
// (ops/rasterize_kernels.py:_pixel_sums). Which lane ends with
// which product depends on the lane alone (product k at lane 0, 2, 4, 8,
// 12, 16, 18, 20, 24, 28): `ScatterPlan` is that split, made once.
constexpr int kScatterSteps = 5;

struct ScatterPlan {
  int h[kScatterSteps];  // products kept by the lower lane at each offset
  int k;                 // the product this lane ends with; -1: none
};

__device__ __forceinline__ ScatterPlan scatter_plan(int lane) {
  ScatterPlan s;
  int n = kBlendGrad, k = 0;
#pragma unroll
  for (int l = 0; l < kScatterSteps; ++l) {
    const bool up = (lane >> (kScatterSteps - 1 - l)) & 1;
    const int h = (n + 1) >> 1;
    s.h[l] = h;
    k = up ? k + h : k;
    n = up ? n - h : h;
  }
  s.k = n == 1 ? k : -1;
  return s;
}

// v[idx] for an index that differs between lanes, as selects (a register
// array indexed at run time would go to local memory).
template <int M>
__device__ __forceinline__ float pick(const float (&v)[M], int idx) {
  float r = 0.0f;
#pragma unroll
  for (int u = 0; u < M; ++u) r = idx == u ? v[u] : r;
  return r;
}

// One step at xor offset o: v holds this lane's partials (the first n of
// M), w receives the h (lower lane) or n - h (upper lane) it keeps.
template <int M>
__device__ __forceinline__ void scatter_step(const float (&v)[M],
                                             float (&w)[(M + 1) / 2], int h,
                                             int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int j = 0; j < (M + 1) / 2; ++j) {
    const float hi = pick(v, h + j);
    const float keep = up ? hi : v[j];
    const float give = up ? v[j] : hi;
    w[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, give, o));
  }
}

// The warp's sum of product plan.k (meaningless where plan.k < 0).
__device__ __forceinline__ float warp_scatter(const float (&g)[kBlendGrad],
                                              const ScatterPlan& plan,
                                              int lane) {
  float a[5], b[3], c[2], d[1], e[1];
  scatter_step(g, a, plan.h[0], lane, 16);
  scatter_step(a, b, plan.h[1], lane, 8);
  scatter_step(b, c, plan.h[2], lane, 4);
  scatter_step(c, d, plan.h[3], lane, 2);
  scatter_step(d, e, plan.h[4], lane, 1);
  return e[0];
}

// Sum of product k of instance j over the eight warps, left to right.
__device__ __forceinline__ float fold_warps(const Reduce& rb, int k, int j) {
  const float* q = rb.v + k * kRedRow + j;
  float x = q[0];
#pragma unroll
  for (int w = 1; w < kBlendWarps; ++w) x = __fadd_rn(x, q[w * kBlendSub]);
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
// summed over the tile's pixels in one fixed order: the warp's
// reduce-scatter (warp_scatter; skipped by a warp none of whose pixels the
// instance touches), then the eight warps left to right (fold_warps).
// Sums go by sub-batches of 32 instances of the tile's segment (ranks
// 32k .. 32k+31 from `start`), cut short at the block's edge. In a
// sub-batch each warp's ten sums of each instance go to red[buf]; then one
// barrier, and all 256 threads fold: for instance j = lane, warp 0 writes
// rows 0-1 of its column of dinst, warp 1 rows 2 and 9, warps 2-7 rows
// 3-8, each row's 32 columns in one coalesced store. The next sub-batch
// fills red[buf ^ 1] meanwhile; its barrier is the one that frees red[buf]
// again, so one barrier a sub-batch suffices. The fold reads ca, cb, cc
// from `inst`, not from the staged block: a thread may fold after its
// partners have returned and begun staging the next block (the caller's
// barrier after staging orders both buffers for the next call). At the
// end of a whole sub-batch (or of the segment) that barrier also counts
// the done pixels; when all are done, the walk folds the sub-batch and
// returns true, and the tile stops there. So every launch geometry writes
// the same columns as the classic kernel: the segment up to the end of
// the sub-batch in which its last pixel latched.
template <class Bar>
__device__ __forceinline__ bool bwd_walk(const Staged* s, Reduce* red,
                                         const float* __restrict__ inst,
                                         long long base, int lo, int hi,
                                         int start, int end, BwdPixel& p,
                                         float* __restrict__ dinst,
                                         long long P, int lin,
                                         const Bar& bar) {
  const int lane = lin & 31;
  const int warp = lin >> 5;
  const ScatterPlan plan = scatter_plan(lane);
  int buf = 0;
  for (int i = lo; i < hi;) {
    const int r = (int)(base + i - start);  // rank in the segment
    const int n = min(hi - i, kBlendSub - (r & (kBlendSub - 1)));
    float* rb = red[buf].v + max(plan.k, 0) * kRedRow + warp * kBlendSub;
    for (int j = 0; j < n; ++j) {
      float g[kBlendGrad];
#pragma unroll
      for (int k = 0; k < kBlendGrad; ++k) g[k] = 0.0f;
      const bool contrib = bwd_terms(s, i + j, p, g);
      const float x = __any_sync(0xffffffffu, contrib)
                          ? warp_scatter(g, plan, lane)
                          : 0.0f;
      if (plan.k >= 0) rb[j] = x;
    }
    // the barrier; at a sub-batch's end, also the all-done test
    bool all_done = false;
    if (((r + n) & (kBlendSub - 1)) == 0 || base + i + n == end) {
      all_done = bar.count(p.done) == kBlendPix;
    } else {
      bar.sync();
    }
    if (lane < n) {
      const Reduce& f = red[buf];
      const long long c = base + i + lane;
      float* o = dinst + c;
      if (warp == 0) {
        const float a0 = fold_warps(f, 0, lane);
        const float a1 = fold_warps(f, 1, lane);
        const float ca = inst[2 * P + c], cb = inst[3 * P + c],
                    cc = inst[4 * P + c];
        o[0] = __fadd_rn(__fmul_rn(ca, a0), __fmul_rn(cb, a1));
        o[P] = __fadd_rn(__fmul_rn(cb, a0), __fmul_rn(cc, a1));
      } else if (warp == 1) {
        o[2 * P] = __fmul_rn(-0.5f, fold_warps(f, 2, lane));
        o[9 * P] = fold_warps(f, 9, lane);
      } else {
        const int k = warp + 1;
        const float a = fold_warps(f, k, lane);
        o[k * P] = k == 3 ? -a : k == 4 ? __fmul_rn(-0.5f, a) : a;
      }
    }
    buf ^= 1;
    i += n;
    if (all_done) return true;
  }
  return false;
}

}  // namespace gpt
