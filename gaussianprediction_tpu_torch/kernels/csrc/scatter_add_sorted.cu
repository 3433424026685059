// scatter_add_sorted: the Σ of slot-sorted contributions into a table,
//   out[f, s] = Σ vals[f, i] over every i with keys[i] == s,
// keys [m] int32 ascending in [0, n_slots), vals [F, m] f32, out
// [F, n_slots] f32; a slot that receives nothing is exactly 0.
//
// Replaces gaussianprediction_tpu/ops/hashgrid_pallas.py:49 _accum_kernel
// (through scatter_add_sorted): the table gradient of the hash-grid weight
// encoder, m = 8 corners x levels x points. The TPU kernel turns the sum
// into one-hot matmuls per 8192-slot block because Mosaic has no scatter;
// that is a workaround, not the contract. What is kept is the contract:
// each output slot is written once, nothing is read back, no atomics, and
// the summation order is fixed (two launches are bit-identical).
//
// Design: a segmented reduction over the sorted stream in two passes.
//   1. mark_heads: one thread per contribution; where keys[i] starts a run
//      (i == 0 or keys[i-1] != keys[i]) it writes i to starts[keys[i]].
//      Each slot has at most one head, so every write has one writer;
//      starts is -1 (memset) where no run begins.
//   2. reduce_runs: one thread per slot walks its run from its head while
//      the key stays the same and sums each channel in stream order from
//      0, the order of the plain version's serial index_add_ (so on the
//      same inputs the two agree bit for bit), then writes its F values
//      once (coalesced: neighbouring threads, neighbouring slots).
//
// Bound on the H100: bytes. The function reads m * (4 + 4F) bytes and
// writes F * n_slots * 4 (at dnerf width m = 26,214,400, F = 4 and
// n_slots = 6,101,902: 622 MB, 0.19 ms at 3.35 TB/s). One thread per slot
// is unbalanced where runs are long: the dense coarse levels take ~330
// contributions a slot against ~3 on the hashed fine levels, so the warps
// of level 0 loop a hundred times longer than the rest, and each of their
// loads touches its own sector (neighbouring threads sit a run apart).
// Balancing it (a warp or block per long run, a fixed-order tree across
// lanes) is left for a later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxF = 8;

__global__ void mark_heads_kernel(const int* __restrict__ keys, long long m,
                                  int n_slots, int* __restrict__ starts) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int k = keys[i];
  if (k < 0 || k >= n_slots) return;  // outside the contract: dropped
  if (i == 0 || keys[i - 1] != k) starts[k] = (int)i;
}

template <int F>
__global__ void reduce_runs_kernel(const int* __restrict__ keys,
                                   const float* __restrict__ vals,
                                   long long m, int n_slots,
                                   const int* __restrict__ starts,
                                   float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  long long i = starts[s];
  if (i >= 0) {
    for (; i < m && keys[i] == s; ++i) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], vals[f * m + i]);
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[(long long)f * n_slots + s] = acc[f];
}

template <int F>
void launch_reduce(const int* keys, const float* vals, long long m,
                   int n_slots, const int* starts, float* out,
                   cudaStream_t stream) {
  const int blocks = (n_slots + kThreads - 1) / kThreads;
  reduce_runs_kernel<F><<<blocks, kThreads, 0, stream>>>(keys, vals, m,
                                                         n_slots, starts, out);
}

}  // namespace

// keys [m] int32 ascending, vals [F, m] f32, starts [n_slots] int32
// scratch, out [F, n_slots] f32; 1 <= F <= 8, m < 2^31.
extern "C" int gpt_scatter_add_sorted(const void* keys, const void* vals,
                                      long long m, int F, int n_slots,
                                      void* starts, void* out, void* stream) {
  if (F < 1 || F > kMaxF) return (int)cudaErrorInvalidValue;
  if (n_slots <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(starts, 0xff, sizeof(int) * n_slots, st);
  if (err != cudaSuccess) return (int)err;
  const int* k = static_cast<const int*>(keys);
  const float* v = static_cast<const float*>(vals);
  int* sp = static_cast<int*>(starts);
  float* o = static_cast<float*>(out);
  if (m > 0) {
    const long long blocks = (m + kThreads - 1) / kThreads;
    mark_heads_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(k, m, n_slots,
                                                             sp);
  }
  switch (F) {
    case 1: launch_reduce<1>(k, v, m, n_slots, sp, o, st); break;
    case 2: launch_reduce<2>(k, v, m, n_slots, sp, o, st); break;
    case 3: launch_reduce<3>(k, v, m, n_slots, sp, o, st); break;
    case 4: launch_reduce<4>(k, v, m, n_slots, sp, o, st); break;
    case 5: launch_reduce<5>(k, v, m, n_slots, sp, o, st); break;
    case 6: launch_reduce<6>(k, v, m, n_slots, sp, o, st); break;
    case 7: launch_reduce<7>(k, v, m, n_slots, sp, o, st); break;
    default: launch_reduce<8>(k, v, m, n_slots, sp, o, st); break;
  }
  return (int)cudaGetLastError();
}
