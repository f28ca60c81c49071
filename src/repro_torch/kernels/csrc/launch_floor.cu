// launch_floor: an empty kernel, launched to time the card's floor for one
// launch of this repository's kernels (ctypes binding, one block of 256
// threads, nothing read or written).  Replaces no TPU kernel; no path of
// the port runs it.  Bound: none, it does no work.

#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int launch_floor_empty(void* stream) {
  launch_floor_kernel<<<1, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
