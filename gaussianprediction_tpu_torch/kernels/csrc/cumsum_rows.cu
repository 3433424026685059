// cumsum_rows: k <= 16 rows of [n] f32 -> the [16, n] inclusive cumsums
// along each row; rows k..15 of the output are zero.
//
// Replaces two TPU kernels of gaussianprediction_tpu/ops/scan_pallas.py:
// _cumsum_ch_kernel (cumsum_channels: the stack of k channel rows fused
// with the scan, used by the instance stream's backward reduction under
// GPT_BWD_REDUCE=pallas) and _cumsum_kernel (cumsum_rows: the same scan of
// an assembled [16, n] matrix). The Pallas kernels walk lane blocks in a
// sequential grid and carry each row's running total in VMEM scratch; on
// Hopper the blocks run in parallel, so the carry becomes a plain two-pass
// scan: (1) each block sums its 2048 elements of one row, (2) one block per
// row scans those block sums, (3) each block scans its elements again and
// adds its row prefix. The association is fixed, so the result is
// deterministic; it matches torch.cumsum to f32 roundoff, not bit for bit.
//
// Bound on the H100: bytes, k*n*4 read and 16*n*4 written (pass 3 reads
// the rows a second time). Global loads and stores are coalesced through
// shared memory; each thread scans 8 consecutive elements.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kBlk = kThreads * kPer;  // elements of one row per block
constexpr int kScanThreads = 1024;

__device__ __forceinline__ float block_sum(float x, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  float tot = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += sh[w];
  }
  return tot;  // valid in thread 0
}

// exclusive prefix of x over the block (in thread order) and the total
__device__ __forceinline__ float block_exclusive_scan(float x, float* sh,
                                                      float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl_w = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl_w = 0.0f;
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.0f;
    for (int w = 0; w < nw; ++w) {
      const float v = sh[w];
      sh[w] = run;
      run += v;
    }
    sh[nw] = run;
  }
  __syncthreads();
  const float excl = sh[warp] + excl_w;
  *total = sh[nw];
  return excl;
}

__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const __grid_constant__ gpt::RowPtrs rows, int k,
                  long long n, float* __restrict__ sums, int nblk) {
  __shared__ float sh[kThreads / 32];
  const int c = blockIdx.y;
  const long long b0 = (long long)blockIdx.x * kBlk;
  float x = 0.0f;
  if (c < k) {
    const float* row = rows.p[c];
    for (int e = threadIdx.x; e < kBlk; e += kThreads) {
      const long long i = b0 + e;
      if (i < n) x += row[i];
    }
  }
  const float tot = block_sum(x, sh);
  if (threadIdx.x == 0) sums[(long long)c * nblk + blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kScanThreads)
scan_sums_kernel(float* __restrict__ sums, int nblk) {
  __shared__ float sh[kScanThreads / 32 + 1];
  float* row = sums + (long long)blockIdx.x * nblk;
  float carry = 0.0f;
  for (int b0 = 0; b0 < nblk; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const float x = b < nblk ? row[b] : 0.0f;
    float total;
    const float excl = block_exclusive_scan(x, sh, &total);
    if (b < nblk) row[b] = carry + excl;
    carry += total;
    __syncthreads();  // sh[] is reused by the next chunk
  }
}

__global__ void __launch_bounds__(kThreads)
scan_rows_kernel(const __grid_constant__ gpt::RowPtrs rows, int k,
                 long long n, const float* __restrict__ prefix, int nblk,
                 float* __restrict__ out) {
  __shared__ float buf[kBlk];
  __shared__ float sh[kThreads / 32 + 1];
  const int c = blockIdx.y;
  const long long b0 = (long long)blockIdx.x * kBlk;
  float* orow = out + (long long)c * n;
  if (c >= k) {
    for (int e = threadIdx.x; e < kBlk; e += kThreads) {
      const long long i = b0 + e;
      if (i < n) orow[i] = 0.0f;
    }
    return;
  }
  const float* row = rows.p[c];
  for (int e = threadIdx.x; e < kBlk; e += kThreads) {
    const long long i = b0 + e;
    buf[e] = i < n ? row[i] : 0.0f;
  }
  __syncthreads();
  float v[kPer];
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    run += buf[threadIdx.x * kPer + j];
    v[j] = run;
  }
  float total;
  const float excl = block_exclusive_scan(run, sh, &total);
  const float base = prefix[(long long)c * nblk + blockIdx.x] + excl;
#pragma unroll
  for (int j = 0; j < kPer; ++j) buf[threadIdx.x * kPer + j] = base + v[j];
  __syncthreads();
  for (int e = threadIdx.x; e < kBlk; e += kThreads) {
    const long long i = b0 + e;
    if (i < n) orow[i] = buf[e];
  }
}

}  // namespace

// scratch: at least 16 * ceil(n / 2048) floats
extern "C" int gpt_cumsum_rows(const void* const* rows, int k, long long n,
                               void* out, void* scratch, void* stream) {
  if (k < 1 || k > 16 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long nblk = (n + kBlk - 1) / kBlk;
  if (nblk > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const gpt::RowPtrs rp = gpt::make_row_ptrs(rows, k);
  float* sums = static_cast<float*>(scratch);
  dim3 grid((unsigned)nblk, 16u);
  block_sums_kernel<<<grid, kThreads, 0, s>>>(rp, k, n, sums, (int)nblk);
  scan_sums_kernel<<<16, kScanThreads, 0, s>>>(sums, (int)nblk);
  scan_rows_kernel<<<grid, kThreads, 0, s>>>(rp, k, n, sums, (int)nblk,
                                             static_cast<float*>(out));
  return (int)cudaGetLastError();
}
