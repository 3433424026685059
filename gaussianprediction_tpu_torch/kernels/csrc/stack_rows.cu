// stack_rows: k x [n] f32 rows -> [nch, n] channel-major matrix, rows k..nch-1
// zeroed (the per-Gaussian "permat" of the instance stream).
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/expand_pallas.py
// _stack_kernel (pallas_call in stack_rows). On the TPU it existed because
// XLA's stack emitter had ms-class fixed costs; here it is a plain copy.
// Bound on the H100: bytes. It reads k*n*4 bytes and writes nch*n*4; one
// thread per element, one grid row per output channel, so every warp reads
// and writes 128 contiguous bytes.
#include "common.cuh"

namespace {

__global__ void stack_rows_kernel(const __grid_constant__ gpt::RowPtrs rows,
                                  int k, long long n,
                                  float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = blockIdx.y;
  out[c * n + i] = c < k ? rows.p[c][i] : 0.0f;
}

}  // namespace

extern "C" int gpt_stack_rows(const void* const* rows, int k, int nch,
                              long long n, void* out, void* stream) {
  if (k < 1 || k > nch || nch > 16 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)nch);
  stack_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      gpt::make_row_ptrs(rows, k), k, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
