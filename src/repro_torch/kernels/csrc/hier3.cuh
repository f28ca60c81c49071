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

// The staged fold below: values a block of short owners stages in shared
// memory; the warps of a block of long owners, and the values a lane of
// such a warp loads at once.
constexpr int kFoldSpan = 2048;
constexpr int kFoldWarps = kThreads / 32;
constexpr int kLongWindow = 8;

// Blocks of a fold launch: a block each kFoldWarps long owners, then one a
// range of short owners.
inline int64_t fold_blocks(int64_t long_owners, int64_t ranges) {
  return (long_owners + kFoldWarps - 1) / kFoldWarps + ranges;
}

// The ordered fold of a slot-owner table: for every owner o,
// acc[slots[o]] = acc[slots[o]] + v[0] + v[1] + ... one rounded add at a
// time (add_rn, so nvcc cannot reassociate or contract), down the run
// offsets[o] .. offsets[o + 1], where the run's j-th value is values[j], or
// values[entries[j]] when `entries` is not null.  No atomics, and no two
// threads write one slot.  Launched on kThreads threads and fold_blocks()
// blocks:
//
// * The first long_owners owners (runs longer than 32) take a warp each,
//   kFoldWarps a block: each lane loads kLongWindow values of the run at
//   once (a window of 256), and the warp folds them in run order through
//   shuffles, a whole 32 of them unrolled, so a long run is a chain of
//   dependent adds and not of dependent loads or shuffles.
// * Every further block takes one range of consecutive short owners
//   (kernels/hierarchize.py: _fold_ranges; at most kThreads owners whose
//   runs hold at most kFoldSpan values), given as bounds[2r], bounds[2r+2]
//   (its first owner and the next range's) and bounds[2r+1], bounds[2r+3]
//   (their runs' first entries).  Owners are sorted longest first, so
//   their runs lie one after the other: the block loads the span's entries
//   coalesced, and with them each thread its owner's run bounds and slot;
//   then the values into `staged` (the calling kernel's kFoldSpan values of
//   shared memory) and its slot's accumulator, every load of a thread in
//   flight; after one barrier each thread folds its owner's run from
//   shared memory in run order.  Three rounds of dependent loads in all.
//
// The adds and their order are those of one thread walking the run, so the
// bits do not depend on the staging.
template <typename T>
__device__ __forceinline__ void fold_owner_runs(
    const int32_t* __restrict__ slots, const int64_t* __restrict__ offsets,
    int64_t long_owners, const int64_t* __restrict__ bounds,
    const int32_t* __restrict__ entries, const T* __restrict__ values,
    T* __restrict__ acc, T* staged) {
  const int64_t long_blocks = (long_owners + kFoldWarps - 1) / kFoldWarps;
  if (blockIdx.x < long_blocks) {
    const int64_t o = int64_t(blockIdx.x) * kFoldWarps + threadIdx.x / 32;
    const int lane = int(threadIdx.x % 32);
    if (o >= long_owners) return;          // a whole warp
    const int64_t s = slots[o], begin = offsets[o], end = offsets[o + 1];
    T v = acc[s];
    for (int64_t base = begin; base < end; base += 32 * kLongWindow) {
      T pv[kLongWindow];
#pragma unroll
      for (int w = 0; w < kLongWindow; ++w) {
        const int64_t j = base + 32 * w + lane;
        pv[w] = j < end ? values[entries ? int64_t(entries[j]) : j] : T(0);
      }
#pragma unroll
      for (int w = 0; w < kLongWindow; ++w) {
        const int64_t left = end - (base + 32 * w);
        if (left >= 32) {
          // a whole 32: every shuffle issued ahead of the chain of adds
#pragma unroll
          for (int k = 0; k < 32; ++k)
            v = add_rn(v, __shfl_sync(0xffffffffu, pv[w], k));
        } else {
          for (int k = 0; k < int(left); ++k)
            v = add_rn(v, __shfl_sync(0xffffffffu, pv[w], k));
        }
      }
    }
    if (lane == 0) acc[s] = v;
    return;
  }
  constexpr int kPer = kFoldSpan / kThreads;
  const int64_t r = int64_t(blockIdx.x) - long_blocks;
  const int64_t o0 = bounds[2 * r], first = bounds[2 * r + 1];
  const int64_t o1 = bounds[2 * r + 2];
  const int span = int(bounds[2 * r + 3] - first);
  const int64_t o = o0 + threadIdx.x;
  const bool mine = o < o1;
  int64_t begin = 0, end = 0, s = 0;
  if (mine) {
    begin = offsets[o];
    end = offsets[o + 1];
    s = slots[o];
  }
  int64_t at[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = int(threadIdx.x) + k * kThreads;
    at[k] = i < span ? (entries ? int64_t(entries[first + i]) : first + i)
                     : -1;
  }
  T v = mine ? acc[s] : T(0);
  T got[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) got[k] = at[k] >= 0 ? values[at[k]] : T(0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = int(threadIdx.x) + k * kThreads;
    if (i < span) staged[i] = got[k];
  }
  __syncthreads();
  if (!mine) return;
#pragma unroll 4
  for (int j = int(begin - first); j < int(end - first); ++j)
    v = add_rn(v, staged[j]);
  acc[s] = v;
}
