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

}  // namespace gpt
