// interleave_rows: 11 x [n] f32 rows (feat0..9, gid) -> the [16, n] instance
// SoA the blend reads: rows 0-9 feat, 10 gid, 11 valid = (gid >= 0),
// 12-15 zero.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/expand_pallas.py
// _interleave_kernel (pallas_call in interleave_rows). Bound on the H100:
// bytes, 11*n*4 read and 16*n*4 written. One thread per element, one grid
// row per output channel: coalesced 128-byte transactions on both sides.
#include "common.cuh"

namespace {

__global__ void interleave_rows_kernel(
    const __grid_constant__ gpt::RowPtrs rows, long long n,
    float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = blockIdx.y;
  float v;
  if (c <= 10) {
    v = rows.p[c][i];
  } else if (c == 11) {
    v = rows.p[10][i] >= 0.0f ? 1.0f : 0.0f;
  } else {
    v = 0.0f;
  }
  out[c * n + i] = v;
}

}  // namespace

extern "C" int gpt_interleave_rows(const void* const* rows, long long n,
                                   void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), 16u);
  interleave_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      gpt::make_row_ptrs(rows, 11), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
