// axis_pass_fwd: one forward hierarchization pass along one axis of a
// bucket stack (G members, all of the bucket's padded shape).
//
// Replaces the forward bodies of two TPU kernels in
// repro/kernels/hierarchize.py:
//   * hier_tail_batched_pallas -> _batched_tail_fwd_kernel (axes 1..d-1;
//     the wrapper issues one launch per tail axis, ping-ponging buffers);
//   * hier_axis0_batched_pallas -> _batched_axis0_fwd_kernel (axis 0).
// The TPU kernels fuse all tail axes while a block sits in VMEM; here each
// pass is a separate launch at the true extents (no sublane/lane padding).
//
// The stack is viewed as (G, outer, n, inner): the pass runs along n.
// Member g's predecessors along the axis are lp/rp (int32) and lm/rm
// (uint8 masks), each of shape (G, n).  Each thread writes one output
// element into a separate buffer, so no element is read after it is
// written and the result does not depend on scheduling.
//
// Bound: bytes.  A pass does 4 flops per element and moves one read and
// one write of the element (the two predecessor reads mostly hit L1/L2),
// far below the card's ridge point, so the design keeps the loads of
// neighbouring threads on neighbouring addresses (inner is the fastest
// axis) and does nothing else.

#include "hier3.cuh"

template <typename T>
__global__ void axis_pass_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                                     const int32_t* __restrict__ lp,
                                     const int32_t* __restrict__ rp,
                                     const uint8_t* __restrict__ lm,
                                     const uint8_t* __restrict__ rm,
                                     int64_t outer, int64_t n, int64_t inner,
                                     int64_t total) {
  const int64_t member = outer * n * inner;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int64_t g = e / member;
    const int64_t node = (e / inner) % n;
    const int64_t row = g * n;
    out[e] = hier3<T>(x + g * member, e - g * member, node, inner, lp + row,
                      rp + row, lm + row, rm + row);
  }
}

template <typename T>
static int launch(const void* x, void* out, const void* lp, const void* rp,
                  const void* lm, const void* rm, int64_t g, int64_t outer,
                  int64_t n, int64_t inner, void* stream) {
  const int64_t total = g * outer * n * inner;
  if (total > 0) {
    axis_pass_fwd_kernel<T><<<blocks_for(total), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const T*)x, (T*)out, (const int32_t*)lp, (const int32_t*)rp,
        (const uint8_t*)lm, (const uint8_t*)rm, outer, n, inner, total);
  }
  return (int)cudaGetLastError();
}

extern "C" int axis_pass_fwd_f64(const void* x, void* out, const void* lp,
                                 const void* rp, const void* lm, const void* rm,
                                 int64_t g, int64_t outer, int64_t n,
                                 int64_t inner, void* stream) {
  return launch<double>(x, out, lp, rp, lm, rm, g, outer, n, inner, stream);
}

extern "C" int axis_pass_fwd_f32(const void* x, void* out, const void* lp,
                                 const void* rp, const void* lm, const void* rm,
                                 int64_t g, int64_t outer, int64_t n,
                                 int64_t inner, void* stream) {
  return launch<float>(x, out, lp, rp, lm, rm, g, outer, n, inner, stream);
}
