// stack_rows: k x [n] f32 rows -> [nch, n] channel-major matrix, rows k..nch-1
// zeroed (the per-Gaussian "permat" of the instance stream).
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/expand_pallas.py:410
// _stack_kernel (pallas_call in stack_rows). On the TPU it existed because
// XLA's stack emitter had ms-class fixed costs; here it is a plain copy.
// Bound on the H100: bytes, k*n*4 read and nch*n*4 written (15 + 16 rows of
// 200,000 at the dnerf render: 24.8 MB, 0.0074 ms at 3.35 TB/s; in a warm
// window they sit in the 50 MB L2, which copies them faster).
//
// Design (interleave_rows.cu's): one thread owns 4 consecutive positions of
// 4 consecutive rows, so it issues its 16-byte loads together and then its
// 16-byte stores; the zero rows are stored as float4 zeros. grid.y is the
// group of 4 rows and a block holds 128 threads, so a block moves 8 KB in
// and 8 KB out, and at n = 200,000 all 1,564 blocks are resident at once
// (at most 12 of 16 a SM).
//
// Rows need not be 16-byte aligned: the launcher passes a mask of the input
// rows whose base is 16-byte aligned and whether the output rows are (base
// aligned and n % 4 == 0); a row that is not is read (or written) as 4
// scalars inside the same kernel, and the positions past the last full
// group of 4 take the scalar path.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // rows a thread copies

__global__ void __launch_bounds__(kThreads) stack_rows_kernel(
    const __grid_constant__ gpt::RowPtrs rows, int k, int nch, long long n,
    int vec_rows, int vec_out, float* __restrict__ out) {
  const long long i = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
  if (i >= n) return;
  const int c0 = blockIdx.y * kRows;
  if (i + 4 <= n) {
    float4 v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int c = c0 + u;
      v[u] = c < k ? gpt::load4(rows.p[c] + i, (vec_rows >> c) & 1)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (c0 + u < nch) gpt::store4(out + (c0 + u) * n + i, v[u], vec_out);
    }
    return;
  }
  for (long long j = i; j < n; ++j) {  // the tail: fewer than 4 positions
    for (int c = c0; c < c0 + kRows && c < nch; ++c) {
      out[c * n + j] = c < k ? rows.p[c][j] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int gpt_stack_rows(const void* const* rows, int k, int nch,
                              long long n, void* out, void* stream) {
  if (k < 1 || k > nch || nch > 16 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int vec_rows = 0;
  for (int c = 0; c < k; ++c) vec_rows |= gpt::aligned16(rows[c]) ? 1 << c : 0;
  const int vec_out = gpt::aligned16(out) && n % 4 == 0;
  const long long groups = (n + 3) / 4;
  dim3 grid((unsigned)((groups + kThreads - 1) / kThreads),
            (unsigned)((nch + kRows - 1) / kRows));
  stack_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      gpt::make_row_ptrs(rows, k), k, nch, n, vec_rows, vec_out,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
