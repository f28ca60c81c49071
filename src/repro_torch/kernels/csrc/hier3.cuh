// The forward 3-term hierarchization update shared by the forward kernels,
// and the ordered slot-owner fold shared by the scatter and the owner fold.
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

// The ordered fold of a slot-owner table: for every owner o,
// acc[slots[o]] = acc[slots[o]] + v[0] + v[1] + ... one rounded add at a
// time (add_rn, so nvcc cannot reassociate or contract), down the run
// offsets[o] .. offsets[o + 1], where the run's j-th value is values[j], or
// values[entries[j]] when `entries` is not null.  Thread t of the launch
// folds one owner; the first long_owners owners (runs longer than 32) take
// a whole warp each, which loads 32 values of the run at once and folds
// them in order through shuffles, so a long run is a chain of dependent
// adds and not of dependent loads.  No atomics, and no two threads write
// one slot.  The caller launches long_owners * 32 + (owners - long_owners)
// threads, the warps' first.
template <typename T>
__device__ __forceinline__ void fold_owner_runs(
    const int32_t* __restrict__ slots, const int64_t* __restrict__ offsets,
    int64_t owners, int64_t long_owners, const int32_t* __restrict__ entries,
    const T* __restrict__ values, T* __restrict__ acc) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t warp_threads = long_owners * 32;  // whole warps
  if (t < warp_threads) {
    const int64_t o = t / 32;
    const int lane = int(t % 32);
    const int64_t s = slots[o], begin = offsets[o], end = offsets[o + 1];
    T v = acc[s];
    for (int64_t base = begin; base < end; base += 32) {
      const int64_t j = base + lane;
      const T pv = j < end ? values[entries ? int64_t(entries[j]) : j] : T(0);
      const int run = int(end - base < 32 ? end - base : 32);
      for (int k = 0; k < run; ++k)
        v = add_rn(v, __shfl_sync(0xffffffffu, pv, k));
    }
    if (lane == 0) acc[s] = v;
    return;
  }
  const int64_t o = long_owners + (t - warp_threads);
  if (o >= owners) return;
  const int64_t s = slots[o];
  T v = acc[s];
  for (int64_t j = offsets[o]; j < offsets[o + 1]; ++j)
    v = add_rn(v, values[entries ? int64_t(entries[j]) : j]);
  acc[s] = v;
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
