// interleave_rows: 11 x [n] f32 rows (feat0..9, gid) -> the [16, n] instance
// SoA the blend reads: rows 0-9 feat, 10 gid, 11 valid = (gid >= 0),
// 12-15 zero.
//
// Replaces the TPU kernel gaussianprediction_tpu/ops/expand_pallas.py:355
// _interleave_kernel (pallas_call in interleave_rows). Bound on the H100:
// bytes, 11*n*4 read and 16*n*4 written (1.21M instances at the dnerf
// render: 131 MB, 0.039 ms at 3.35 TB/s).
//
// Design: one thread owns 4 consecutive positions of every row, so it
// issues 11 16-byte loads and 16 16-byte stores, all independent (176
// bytes of loads in flight a thread); gid is read once for rows 10 and 11
// and the zero rows are stored as float4 too. Blocks of 128 threads: at
// n = 1.21M that is 2,365 blocks, many more than the 132 SMs hold at once,
// so the block scheduler keeps every SM busy to the end of the copy.
//
// Rows need not be 16-byte aligned: on the backward path they are rows of a
// [10, P] tensor and a fresh gid row, in the tests views at any offset. The
// launcher passes a mask of the input rows whose base is 16-byte aligned
// and whether the output rows are (base aligned and n % 4 == 0); a row that
// is not is read (or written) as 4 scalars inside the same kernel, and the
// positions past the last full group of 4 take the scalar path.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float valid_of(float g) {
  return g >= 0.0f ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads) interleave_rows_kernel(
    const __grid_constant__ gpt::RowPtrs rows, long long n, int vec_rows,
    int vec_out, float* __restrict__ out) {
  const long long i = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
  if (i >= n) return;
  if (i + 4 <= n) {
    float4 v[11];
#pragma unroll
    for (int c = 0; c < 11; ++c) {
      v[c] = gpt::load4(rows.p[c] + i, (vec_rows >> c) & 1);
    }
    const float4 g = v[10];
    const float4 valid = make_float4(valid_of(g.x), valid_of(g.y),
                                     valid_of(g.z), valid_of(g.w));
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < 11; ++c) gpt::store4(out + c * n + i, v[c], vec_out);
    gpt::store4(out + 11 * n + i, valid, vec_out);
#pragma unroll
    for (int c = 12; c < 16; ++c) gpt::store4(out + c * n + i, zero, vec_out);
    return;
  }
  for (long long j = i; j < n; ++j) {  // the tail: fewer than 4 positions
#pragma unroll
    for (int c = 0; c < 11; ++c) out[c * n + j] = rows.p[c][j];
    out[11 * n + j] = valid_of(rows.p[10][j]);
#pragma unroll
    for (int c = 12; c < 16; ++c) out[c * n + j] = 0.0f;
  }
}

}  // namespace

extern "C" int gpt_interleave_rows(const void* const* rows, long long n,
                                   void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int vec_rows = 0;
  for (int c = 0; c < 11; ++c) {
    vec_rows |= gpt::aligned16(rows[c]) ? 1 << c : 0;
  }
  const int vec_out = gpt::aligned16(out) && n % 4 == 0;
  const long long groups = (n + 3) / 4;
  const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
  interleave_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      gpt::make_row_ptrs(rows, 11), n, vec_rows, vec_out,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
