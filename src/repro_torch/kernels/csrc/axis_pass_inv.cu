// axis_pass_inv: one dehierarchization pass along one axis of a bucket
// stack (G members, all of the bucket's padded shape), each member at its
// own level along the axis.
//
// Replaces the inverse bodies of two TPU kernels in
// repro/kernels/hierarchize.py:
//   * hier_tail_batched_pallas -> _batched_tail_kernel (axes 1..d-1; the
//     wrapper issues one launch per tail axis of extent > 1);
//   * hier_axis0_batched_pallas -> _batched_matmul_kernel (axis 0).
// The TPU kernels apply each member's dense padded operator H^-1 (+) I as a
// matmul on the MXU.  That operator does about n/3 times the stencil's
// flops, which a card without an f64 matrix unit at that shape cannot
// afford, so this kernel computes the same function as pole_inv.cu: the
// coarse-to-fine level loop.
//
// The stack is viewed as (G, outer, n, inner): the pass runs along n, and
// one thread owns one (g, outer, inner) column.  Member g's level L_g
// (int32, shape (G,)) gives its own head of n_g = 2**L_g - 1 nodes.  The
// thread writes the root first, then each level from coarse to fine,
// reading the parents back from the output it has already written (same
// thread, program order) and the node itself from the input:
//   out[i] = a[i] + 0.5 * (l + r)
// rounded step by step (add_rn/mul_rn, no FMA), an absent (boundary)
// parent entering as +0.0 -- the order of ref.dehierarchize_1d_ref, so the
// result is bitwise the plain version's.  Positions >= n_g are copied
// unchanged: that is the identity on the padding that merged buckets'
// below-target members rely on.
//
// Bound: bytes.  A pass does 3 flops per element and must read and write
// each element once.  Neighbouring threads own neighbouring inner
// positions, so a warp's accesses are coalesced whenever inner >= 32.  A
// pass along the last axis (inner = 1) makes each thread walk a contiguous
// row of its own, so a warp's loads are strided by the row length; that
// case is left slow on purpose (PERF.md records its time).

#include "hier3.cuh"

template <typename T>
__global__ void axis_pass_inv_kernel(const T* __restrict__ a,
                                     T* __restrict__ out,
                                     const int32_t* __restrict__ levels,
                                     int64_t outer, int64_t n, int64_t inner,
                                     int64_t columns) {
  const T half = T(0.5);
  for (int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       c < columns; c += int64_t(gridDim.x) * blockDim.x) {
    const int64_t g = c / (outer * inner);
    const int64_t rest = c - g * outer * inner;
    const int64_t o = rest / inner;
    const int64_t base = (g * outer + o) * n * inner + (rest - o * inner);
    const T* __restrict__ src = a + base;
    T* __restrict__ dst = out + base;
    const int level = levels[g];
    const int64_t head = (int64_t(1) << level) - 1;
    for (int64_t i = head; i < n; ++i) dst[i * inner] = src[i * inner];
    const int64_t root = (int64_t(1) << (level - 1)) - 1;
    dst[root * inner] = src[root * inner];
    for (int lam = 2; lam <= level; ++lam) {
      const int64_t s = int64_t(1) << (level - lam);
      for (int64_t i = s - 1; i < head; i += 2 * s) {
        const T l = i >= s ? dst[(i - s) * inner] : T(0);
        const T r = i + s < head ? dst[(i + s) * inner] : T(0);
        dst[i * inner] = add_rn(src[i * inner], mul_rn(half, add_rn(l, r)));
      }
    }
  }
}

template <typename T>
static int launch(const void* a, void* out, const void* levels, int64_t g,
                  int64_t outer, int64_t n, int64_t inner, void* stream) {
  const int64_t columns = g * outer * inner;
  if (columns > 0 && n > 0) {
    axis_pass_inv_kernel<T><<<blocks_for(columns), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const T*)a, (T*)out, (const int32_t*)levels, outer, n, inner,
        columns);
  }
  return (int)cudaGetLastError();
}

extern "C" int axis_pass_inv_f64(const void* a, void* out, const void* levels,
                                 int64_t g, int64_t outer, int64_t n,
                                 int64_t inner, void* stream) {
  return launch<double>(a, out, levels, g, outer, n, inner, stream);
}

extern "C" int axis_pass_inv_f32(const void* a, void* out, const void* levels,
                                 int64_t g, int64_t outer, int64_t n,
                                 int64_t inner, void* stream) {
  return launch<float>(a, out, levels, g, outer, n, inner, stream);
}
