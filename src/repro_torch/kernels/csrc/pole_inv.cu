// pole_inv: dehierarchization along axis 0 of an (n, b) pole bundle, the
// coarse-to-fine level loop, one thread per pole.
//
// Replaces dehier_pole_pallas -> _dehier_pole_kernel
// (repro/kernels/hierarchize.py:225, :206).  The layout is pole_fwd's: the
// row-major (n, b) bundle, one thread per column, so a warp's accesses are
// coalesced, at the true extents.
//
// Unlike the forward transform, the inverse is sequential in level: a
// node's value needs its two parents' FINAL values.  The thread writes the
// root first, then each level from coarse to fine, reading the parents
// back from the output it has already written (same thread, so program
// order makes them visible) and the node itself from the input:
//   out[i] = a[i] + 0.5 * (l + r)
// rounded step by step (add_rn/mul_rn, no FMA) in the reference's order,
// an absent (boundary) parent entering as +0.0.  Bitwise the reference's.
//
// Bound: bytes, as pole_fwd.  A bundle with few columns runs on few
// threads (one for b = 1); that case is left slow on purpose.

#include "hier3.cuh"

template <typename T>
__global__ void pole_inv_kernel(const T* __restrict__ a, T* __restrict__ out,
                                int64_t n, int64_t b, int level) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= b) return;
  const T half = T(0.5);
  const int64_t root = (int64_t(1) << (level - 1)) - 1;
  out[root * b + col] = a[root * b + col];
  for (int lam = 2; lam <= level; ++lam) {
    const int64_t s = int64_t(1) << (level - lam);
    for (int64_t i = s - 1; i < n; i += 2 * s) {
      const T l = i >= s ? out[(i - s) * b + col] : T(0);
      const T r = i + s < n ? out[(i + s) * b + col] : T(0);
      out[i * b + col] = add_rn(a[i * b + col], mul_rn(half, add_rn(l, r)));
    }
  }
}

template <typename T>
static int launch(const void* a, void* out, int64_t n, int64_t b,
                  int64_t level, void* stream) {
  if (b > 0) {
    const unsigned int blocks = (unsigned int)((b + kThreads - 1) / kThreads);
    pole_inv_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)a, (T*)out, n, b, (int)level);
  }
  return (int)cudaGetLastError();
}

extern "C" int pole_inv_f64(const void* a, void* out, int64_t n, int64_t b,
                            int64_t level, void* stream) {
  return launch<double>(a, out, n, b, level, stream);
}

extern "C" int pole_inv_f32(const void* a, void* out, int64_t n, int64_t b,
                            int64_t level, void* stream) {
  return launch<float>(a, out, n, b, level, stream);
}
