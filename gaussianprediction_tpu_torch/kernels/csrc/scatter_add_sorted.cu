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
// each slot's sum is written once, nothing is read back, no atomics, and
// the summation order is fixed (two launches are bit-identical).
//
// The order, which ops/hashgrid_kernels.py:scatter_add_sorted_plain
// reproduces bit for bit on the CPU: the stream is cut into tiles of kTile
// (= TILE there) consecutive positions; each run of one key is cut at the
// tile boundaries into pieces; each piece is summed from 0.0 in stream
// order; a slot's value is its pieces' sums added from 0.0 in tile order. A
// run that lies inside one tile is thus its serial sum in stream order.
//
// Bound on the H100: bytes. The function reads m * (4 + 4F) bytes and
// writes F * n_slots * 4 (at dnerf width m = 26,214,400, F = 4 and
// n_slots = 6,101,902: 622 MB, 0.19 ms at 3.35 TB/s). Runs are anything
// but even: ~3 contributions a slot on the hashed levels, ~330 on the
// dense coarse ones, and in the Trainer eight runs of ~100k in every level
// (the dead capacity rows, all at one xyz). So the work is cut by stream
// position, never by slot, and no thread's loop is longer than a tile:
//   1. scatter_tiles, one block of 128 threads a tile: the tile's keys and
//      F value rows are staged in shared memory with 16-byte loads (all of
//      a thread's loads issued before the first is stored). Each thread
//      takes the pieces that start among its 8 positions, finds a piece's
//      end from its own keys or by a galloping search, and folds it from
//      0.0 in stream order with F independent chains, reading 4 positions
//      of a row a load. A piece that is a whole run leaves its sum in
//      shared memory; the tile's first piece, when its run began in an
//      earlier tile, and its last, when its run goes on, go to carry
//      [n_tiles, 2, F]. After a barrier the block writes the whole runs,
//      neighbouring threads on neighbouring slots. The zero fill is shared
//      out the same way: each tile zeroes the slots from its first key up
//      to the next tile's first key before its runs land there, so empty
//      slots cost no pass of their own (a tile facing a long gap of empty
//      slots zeroes it alone: the hash grid's streams have short gaps).
//   2. scatter_carries, one warp a tile: the tile in which a crossing run
//      starts adds the run's carries in tile order from 0.0, 32 tiles'
//      carries loaded at once, and writes the slot (a run of ~100k is ~100
//      adds).
// Tiles of 1024 (not 2048) halve the longest fold, which a dead-row tile
// does alone, and let ten blocks share an SM.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 1024;  // stream positions a tile (TILE in the wrapper)
constexpr int kThreads = 128;
constexpr int kPerThread = kTile / kThreads;
constexpr int kRounds = kTile / (4 * kThreads);  // 16-byte loads a row
constexpr int kMaxF = 8;

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// The first position >= lo whose key is not k, or len (sk[lo - 1] == k): a
// galloping search, then a binary one (keys ascend).
__device__ __forceinline__ int run_end(const int* sk, int lo, int len,
                                       int k) {
  int hi = lo;
  int step = 1;
  while (hi < len && sk[hi] == k) {
    lo = hi + 1;
    hi = lo + step;
    step <<= 1;
  }
  if (hi > len) hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] == k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// acc[f] += sv[f][j] for j in [i, end), in stream order; between the ragged
// ends the loop reads 4 positions of a row a load.
template <int F>
__device__ __forceinline__ void fold(const float* sv, int i, int end,
                                     float (&acc)[F]) {
  int j = i;
  for (; j < end && (j & 3); ++j) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], sv[f * kTile + j]);
  }
#pragma unroll 2
  for (; j + 4 <= end; j += 4) {
    float4 x[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      x[f] = *reinterpret_cast<const float4*>(sv + f * kTile + j);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc[f], x[f].x),
                                             x[f].y), x[f].z), x[f].w);
    }
  }
  for (; j < end; ++j) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], sv[f * kTile + j]);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads) scatter_tiles_kernel(
    const int* __restrict__ keys, const float* __restrict__ vals, long long m,
    int n_slots, int vec, float* __restrict__ carry,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sk = reinterpret_cast<int*>(smem);            // [kTile]
  float* sv = reinterpret_cast<float*>(sk + kTile);  // [F][kTile]
  unsigned char* whole = reinterpret_cast<unsigned char*>(sv + F * kTile);
  const long long t0 = (long long)blockIdx.x * kTile;
  const int len = (int)min((long long)kTile, m - t0);
  if (vec && len == kTile) {
    int4 kq[kRounds];
    float4 vq[kRounds][F];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = 4 * (threadIdx.x + r * kThreads);
      kq[r] = *reinterpret_cast<const int4*>(keys + t0 + j);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        vq[r][f] = *reinterpret_cast<const float4*>(vals + f * m + t0 + j);
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = 4 * (threadIdx.x + r * kThreads);
      *reinterpret_cast<int4*>(sk + j) = kq[r];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        *reinterpret_cast<float4*>(sv + f * kTile + j) = vq[r][f];
      }
    }
  } else {  // the stream's last tile, or rows not 16-byte aligned
    for (int q = threadIdx.x; q < len; q += kThreads) {
      sk[q] = keys[t0 + q];
#pragma unroll
      for (int f = 0; f < F; ++f) sv[f * kTile + q] = vals[f * m + t0 + q];
    }
  }
  __syncthreads();
  // the tile's first run began in the previous tile; its last goes on
  const bool joins_prev = t0 > 0 && keys[t0 - 1] == sk[0];
  const int next_key = t0 + len < m ? keys[t0 + len] : n_slots;
  const bool joins_next = t0 + len < m && next_key == sk[len - 1];
  // the tile's share of the zero fill: its whole runs' slots lie inside it,
  // and no other tile's do
  const int z_lo = t0 == 0 ? 0 : max(sk[0], 0);
  const int z_hi = min(next_key, n_slots);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    for (int s = z_lo + threadIdx.x; s < z_hi; s += kThreads) {
      out[(long long)f * n_slots + s] = 0.0f;
    }
  }
  const int first = threadIdx.x * kPerThread;
  const int n_here = max(0, min(kPerThread, len - first));
  int kk[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) kk[q] = q < n_here ? sk[first + q] : 0;
  const int before = first > 0 && n_here > 0 ? sk[first - 1] : 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    if (q >= n_here) break;
    const int i = first + q;
    const int k = kk[q];
    whole[i] = 0;
    if (i > 0 && (q == 0 ? before : kk[q > 0 ? q - 1 : 0]) == k) continue;
    int end = -1;  // where the piece that starts at i ends
#pragma unroll
    for (int r = q + 1; r < kPerThread; ++r) {
      if (end < 0 && r < n_here && kk[r] != k) end = first + r;
    }
    if (end < 0) end = run_end(sk, first + n_here, len, k);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    fold<F>(sv, i, end, acc);
    const bool head = i > 0 || !joins_prev;
    const bool tail = end < len || !joins_next;
    if (head && tail) {
      // [i, end) is this thread's alone: its sum takes its first value's
      // place until the block writes the tile's whole runs
      whole[i] = 1;
#pragma unroll
      for (int f = 0; f < F; ++f) sv[f * kTile + i] = acc[f];
    } else {
      float* c = carry + (long long)blockIdx.x * 2 * F;
      if (!head) {
#pragma unroll
        for (int f = 0; f < F; ++f) c[f] = acc[f];
      }
      if (!tail) {
#pragma unroll
        for (int f = 0; f < F; ++f) c[F + f] = acc[f];
      }
    }
  }
  __syncthreads();  // the sums are in place and the zeros before them
  for (int p = threadIdx.x; p < len; p += kThreads) {
    const int k = sk[p];
    if (whole[p] && k >= 0 && k < n_slots) {  // outside the contract: dropped
#pragma unroll
      for (int f = 0; f < F; ++f) {
        out[(long long)f * n_slots + k] = sv[f * kTile + p];
      }
    }
  }
}

template <int F>
__global__ void scatter_carries_kernel(const int* __restrict__ keys,
                                       long long m, long long n_tiles,
                                       int n_slots,
                                       const float* __restrict__ carry,
                                       float* __restrict__ out) {
  const long long t = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles - 1) return;  // warp-uniform: the last tile ends the stream
  const long long end = (t + 1) * kTile;
  const int k = keys[end - 1];
  if (keys[end] != k) return;  // the tile's last run ends inside it
  if (t > 0 && keys[t * kTile - 1] == k) return;  // it began in an earlier tile
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    acc[f] = __fadd_rn(0.0f, carry[(t * 2 + 1) * F + f]);
  }
  for (long long u0 = t + 1;; u0 += 32) {
    const long long u = u0 + lane;
    float piece[F];
    bool ends = true;
#pragma unroll
    for (int f = 0; f < F; ++f) piece[f] = 0.0f;
    if (u < n_tiles) {
#pragma unroll
      for (int f = 0; f < F; ++f) piece[f] = carry[u * 2 * F + f];
      const long long next = (u + 1) * kTile;
      ends = !(next < m && keys[next] == k);
    }
    const unsigned stop = __ballot_sync(0xffffffffu, ends);
    const int upto = stop ? __ffs(stop) - 1 : 31;
    for (int l = 0; l <= upto; ++l) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        acc[f] = __fadd_rn(acc[f], __shfl_sync(0xffffffffu, piece[f], l));
      }
    }
    if (stop) {
      if (lane == 0 && k >= 0 && k < n_slots) {
#pragma unroll
        for (int f = 0; f < F; ++f) out[(long long)f * n_slots + k] = acc[f];
      }
      return;
    }
  }
}

template <int F>
cudaError_t launch(const int* keys, const float* vals, long long m,
                   int n_slots, float* carry, float* out, cudaStream_t st) {
  const long long n_tiles = (m + kTile - 1) / kTile;
  const int smem = (int)((1 + F) * kTile * sizeof(float) + kTile);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_tiles_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(keys) && aligned16(vals) && m % 4 == 0;
  scatter_tiles_kernel<F><<<(unsigned)n_tiles, kThreads, smem, st>>>(
      keys, vals, m, n_slots, vec, carry, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles < 2) return err;
  const long long warps_per_block = kThreads / 32;
  const long long blocks = (n_tiles + warps_per_block - 1) / warps_per_block;
  scatter_carries_kernel<F><<<(unsigned)blocks, kThreads, 0, st>>>(
      keys, m, n_tiles, n_slots, carry, out);
  return cudaGetLastError();
}

}  // namespace

// keys [m] int32 ascending, vals [F, m] f32, carry [ceil(m / 1024), 2, F]
// f32 scratch, out [F, n_slots] f32; 1 <= F <= 8, m < 2^31.
extern "C" int gpt_scatter_add_sorted(const void* keys, const void* vals,
                                      long long m, int F, int n_slots,
                                      void* carry, void* out, void* stream) {
  if (F < 1 || F > kMaxF || m < 0) return (int)cudaErrorInvalidValue;
  if (n_slots <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0) {
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * F * (size_t)n_slots,
                                st);
  }
  const int* k = static_cast<const int*>(keys);
  const float* v = static_cast<const float*>(vals);
  float* c = static_cast<float*>(carry);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  switch (F) {
    case 1: err = launch<1>(k, v, m, n_slots, c, o, st); break;
    case 2: err = launch<2>(k, v, m, n_slots, c, o, st); break;
    case 3: err = launch<3>(k, v, m, n_slots, c, o, st); break;
    case 4: err = launch<4>(k, v, m, n_slots, c, o, st); break;
    case 5: err = launch<5>(k, v, m, n_slots, c, o, st); break;
    case 6: err = launch<6>(k, v, m, n_slots, c, o, st); break;
    case 7: err = launch<7>(k, v, m, n_slots, c, o, st); break;
    default: err = launch<8>(k, v, m, n_slots, c, o, st); break;
  }
  return (int)err;
}
