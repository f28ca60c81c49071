// The forward 3-term hierarchization update shared by both kernels.
//
// x' = x - 0.5 * (lm ? x[lp] : 0) - 0.5 * (rm ? x[rp] : 0), evaluated in
// exactly that order with round-to-nearest intrinsics, so nvcc cannot
// contract any multiply-add into an FMA.  This is the order of `_hier3`
// in repro/kernels/hierarchize.py, which keeps every result bitwise equal
// to the reference.  A masked ancestor is SELECTED to zero, never
// multiplied by the mask, so an Inf or NaN in a masked neighbour (a pad
// slot or the absent boundary) does not leak into the result.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// One element of a pass along an axis viewed as (outer, n, inner) per
// member.  `e` is the element's flat offset inside its member, `node` its
// row of the member's (n,) predecessor arrays along the axis.  `x` may be
// shared memory, or device memory that this block wrote before a barrier,
// so it is not declared __restrict__ (no read-only cache path).
template <typename T>
__device__ __forceinline__ T hier3(const T* x, int64_t e,
                                   int64_t node, int64_t inner,
                                   const int32_t* __restrict__ lp,
                                   const int32_t* __restrict__ rp,
                                   const uint8_t* __restrict__ lm,
                                   const uint8_t* __restrict__ rm) {
  const T half = T(0.5);
  const int64_t pole = e - node * inner;  // offset of node 0 of this pole
  const T xl = lm[node] ? x[pole + int64_t(lp[node]) * inner] : T(0);
  const T xr = rm[node] ? x[pole + int64_t(rp[node]) * inner] : T(0);
  return sub_rn(sub_rn(x[e], mul_rn(half, xl)), mul_rn(half, xr));
}

// Launch shape of a grid-stride loop over elements, capped so a launch
// never asks for more blocks than useful.
constexpr int kThreads = 256;
// Streaming multiprocessors of an H100 SXM, which the launch shapes assume.
constexpr int64_t kSMs = 132;

inline unsigned int blocks_for(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = kSMs * 16;  // 16 blocks of 256 threads on each SM
  return (unsigned int)(want < cap ? want : cap);
}
