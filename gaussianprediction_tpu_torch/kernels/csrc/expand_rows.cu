// expand_rows: slot -> Gaussian expansion of the per-Gaussian permat into
// the per-instance stream. Slot j takes the column of the Gaussian g with
// offs[g] <= j < offs[g+1].
//
// Replaces the TPU kernels gaussianprediction_tpu/ops/expand_pallas.py
// _expand_kernel_res (permat resident in VMEM) and _expand_kernel (windowed,
// large N), both behind expand_rows_raw. Their one-hot matmuls and
// candidate windows are TPU mechanisms; here one thread per slot finds g by
// binary search over offs (log2 N probes, L1/L2-resident) and copies the
// column. It is pure selection, so the output is bit-exact.
//
// With emit != 0 the kernel also fuses emit_from_raw (an XLA pass in the
// JAX package): the rect walk that turns the slot's rank k inside its
// Gaussian into a tile key, and the invalid-slot masking. It uses IEEE
// division and the _rn intrinsics, which nvcc never contracts into FMAs,
// so keys equal the plain version's bit for bit. Output rows then are
// feat0..9 (zeroed when invalid), gid (-1 when invalid), key (sentinel when
// invalid).
//
// Bound on the H100: bytes. Reads offs (N*4) and the permat once: all 16
// rows in raw mode, rows 0-14 in emit mode (row 15 is pad); writes 16 (raw)
// or 12 (emit) rows of `cap` slots. Neighbouring threads read the same or
// neighbouring permat columns and write neighbouring slots.
#include "common.cuh"

namespace {

__global__ void expand_rows_kernel(const float* __restrict__ permat,
                                   const int* __restrict__ offs, int n_g,
                                   const int* __restrict__ total_p,
                                   long long cap, int emit, float grid_x,
                                   float sentinel, float* __restrict__ out) {
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= cap) return;
  // largest g with offs[g] <= j (offs[0] == 0, nondecreasing)
  int lo = 0, hi = n_g - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((long long)offs[mid] <= j) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long g = lo;
  const long long ng = n_g;
  if (!emit) {
#pragma unroll
    for (int c = 0; c < 16; ++c) out[c * cap + j] = permat[c * ng + g];
    return;
  }
  const float offs_sel = permat[10 * ng + g];
  const float tminx = permat[11 * ng + g];
  const float tminy = permat[12 * ng + g];
  const float rw = permat[13 * ng + g];
  const float gid = permat[14 * ng + g];
  const float k = __fsub_rn((float)j, offs_sel);
  const float rwm = fmaxf(rw, 1.0f);
  const float q = floorf(__fdiv_rn(k, rwm));
  const float rem = __fsub_rn(k, __fmul_rn(q, rwm));
  const float keyf = __fadd_rn(__fmul_rn(__fadd_rn(tminy, q), grid_x),
                               __fadd_rn(tminx, rem));
  const bool ok = (j < (long long)(*total_p)) && (rw > 0.5f);
  const float okf = ok ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < 10; ++c) out[c * cap + j] = __fmul_rn(permat[c * ng + g], okf);
  out[10 * cap + j] = ok ? gid : -1.0f;
  out[11 * cap + j] = ok ? keyf : sentinel;
}

}  // namespace

extern "C" int gpt_expand_rows(const void* permat, const void* offs, int n_g,
                               const void* total, long long cap, int emit,
                               float grid_x, float sentinel, void* out,
                               void* stream) {
  if (n_g < 1 || cap < 0) return (int)cudaErrorInvalidValue;
  if (cap == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((cap + threads - 1) / threads);
  expand_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(permat), static_cast<const int*>(offs), n_g,
      static_cast<const int*>(total), cap, emit, grid_x, sentinel,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
