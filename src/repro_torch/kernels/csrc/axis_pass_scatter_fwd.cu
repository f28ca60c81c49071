// axis_pass_scatter_fwd: the last forward hierarchization pass of a bucket
// stack fused with the coefficient-weighted scatter-add into the flat fine
// grid:  acc[idx[g, p]] = acc[idx[g, p]] + c[g] * alpha[g, p].
//
// Replaces repro/kernels/hierarchize.py: hier_axis0_scatter_batched_pallas
// -> _axis0_scatter_kernel.  The TPU kernel keeps the whole fine buffer as
// a VMEM-resident output block; a Hopper SM has no such room, so here the
// fine buffer stays in device memory and each member's finished surpluses
// are added straight into it.  The pass axis is a parameter (the stack is
// viewed as (G, outer, n, inner)), so the same kernel serves axis 0 of
// buckets the reference runs on its Pallas path and axis d-1 of buckets it
// runs on its jnp path, and the bits match either way.
//
// Deterministic, with no atomics: the host function launches the kernel
// once per member, in member order, on one stream.  Stream order makes the
// adds into each fine slot a left fold in member order -- the fold of the
// reference's unfused `full.at[idx].add(cs * alpha)`.  Inside one launch a
// member's index map is injective except at pad positions, which all point
// at the dump slot; they are skipped, so no two threads of a launch write
// the same slot and the dump slot is never written.  The product and the
// sum are rounded separately (mul_rn/add_rn), as in the reference, since a
// coefficient of +-3 would otherwise show an FMA in the last bit.
//
// Bound: bytes.  Each element is read once (plus L1/L2-resident
// predecessor reads), its index read once, and one fine slot read and
// written; the fine buffer is touched only at the member's own slots.

#include "hier3.cuh"

template <typename T>
__global__ void axis_pass_scatter_fwd_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    const T* __restrict__ coeff, T* __restrict__ acc, int64_t dump,
    const int32_t* __restrict__ lp, const int32_t* __restrict__ rp,
    const uint8_t* __restrict__ lm, const uint8_t* __restrict__ rm,
    int64_t n, int64_t inner, int64_t total) {
  const T c = *coeff;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int64_t slot = idx[e];
    if (slot == dump) continue;
    const int64_t node = (e / inner) % n;
    const T alpha = hier3<T>(x, e, node, inner, lp, rp, lm, rm);
    acc[slot] = add_rn(acc[slot], mul_rn(c, alpha));
  }
}

template <typename T>
static int launch(const void* x, const void* idx, const void* coeffs, void* acc,
                  int64_t dump, const void* lp, const void* rp, const void* lm,
                  const void* rm, int64_t g, int64_t outer, int64_t n,
                  int64_t inner, void* stream) {
  const int64_t member = outer * n * inner;
  for (int64_t m = 0; m < g && member > 0; ++m) {
    axis_pass_scatter_fwd_kernel<T><<<blocks_for(member), kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const T*)x + m * member, (const int32_t*)idx + m * member,
        (const T*)coeffs + m, (T*)acc, dump, (const int32_t*)lp + m * n,
        (const int32_t*)rp + m * n, (const uint8_t*)lm + m * n,
        (const uint8_t*)rm + m * n, n, inner, member);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int axis_pass_scatter_fwd_f64(const void* x, const void* idx,
                                         const void* coeffs, void* acc,
                                         int64_t dump, const void* lp,
                                         const void* rp, const void* lm,
                                         const void* rm, int64_t g,
                                         int64_t outer, int64_t n,
                                         int64_t inner, void* stream) {
  return launch<double>(x, idx, coeffs, acc, dump, lp, rp, lm, rm, g, outer, n,
                        inner, stream);
}

extern "C" int axis_pass_scatter_fwd_f32(const void* x, const void* idx,
                                         const void* coeffs, void* acc,
                                         int64_t dump, const void* lp,
                                         const void* rp, const void* lm,
                                         const void* rm, int64_t g,
                                         int64_t outer, int64_t n,
                                         int64_t inner, void* stream) {
  return launch<float>(x, idx, coeffs, acc, dump, lp, rp, lm, rm, g, outer, n,
                       inner, stream);
}
