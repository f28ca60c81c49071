// axis_operator: (de)hierarchization along axis 0 of an (n, b) bundle as
// one dense operator product, out = H . x (forward) or H^-1 . x (inverse).
//
// Replaces apply_axis_matmul_pallas -> _matmul_kernel
// (repro/kernels/hierarchize.py:259, :254), which the TPU runs on its
// matrix unit.  Here it is a shared-memory tiled product on CUDA cores
// (operator_gemm.cuh), one 64 x 64 output tile per block, at the true
// extents.  The wrapper builds H at the true n (from the port's
// ref.operator_matrix / ref.dehier_operator_matrix) in the accumulator's
// type: f64 for f64 input, f32 for f32 and for bf16 input, which is widened
// on load, summed in f32 and written back as bf16.
//
// Bound: operations.  The product does 2 n^2 b flops on 2 n b elements
// moved, so at n = 511 it sits above the card's ridge point; the dense
// operator does about n/3 times the flops of the 3-term stencil it
// replaces (an open question, as are wgmma and TMA).

#include "operator_gemm.cuh"

template <typename T, typename Acc>
__global__ void __launch_bounds__(kGemmThreads)
    axis_operator_kernel(const Acc* __restrict__ h, const T* __restrict__ x,
                         T* __restrict__ out, int64_t n, int64_t b) {
  __shared__ GemmSmem<Acc> sm;
  operator_tile<Acc, T, T>(h, x, b, 1, out, b, 1, n, b,
                           int64_t(blockIdx.y) * kTile,
                           int64_t(blockIdx.x) * kTile, sm);
}

template <typename T, typename Acc>
static int launch(const void* h, const void* x, void* out, int64_t n,
                  int64_t b, void* stream) {
  if (n > 0 && b > 0) {
    const dim3 grid((unsigned int)((b + kTile - 1) / kTile),
                    (unsigned int)((n + kTile - 1) / kTile));
    axis_operator_kernel<T, Acc><<<grid, kGemmThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const Acc*)h, (const T*)x, (T*)out, n, b);
  }
  return (int)cudaGetLastError();
}

extern "C" int axis_operator_f64(const void* h, const void* x, void* out,
                                 int64_t n, int64_t b, void* stream) {
  return launch<double, double>(h, x, out, n, b, stream);
}

extern "C" int axis_operator_f32(const void* h, const void* x, void* out,
                                 int64_t n, int64_t b, void* stream) {
  return launch<float, float>(h, x, out, n, b, stream);
}

extern "C" int axis_operator_bf16(const void* h, const void* x, void* out,
                                  int64_t n, int64_t b, void* stream) {
  return launch<__nv_bfloat16, float>(h, x, out, n, b, stream);
}
