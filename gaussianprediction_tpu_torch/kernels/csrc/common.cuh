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

}  // namespace gpt
