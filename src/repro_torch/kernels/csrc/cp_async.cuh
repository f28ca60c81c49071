// Asynchronous copies from device memory into shared memory (cp.async),
// shared by the kernels that double-buffer their operand tiles.
//
// cp_async<N>(dst, src, src_bytes) copies N bytes (4, 8 or 16), of which
// the first src_bytes are read from src and the rest filled with zeros:
// src_bytes = 0 reads nothing, so a tile's edge is zero-filled without a
// branch.  Both addresses must be N-byte aligned, also when src_bytes < N.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 B");
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
