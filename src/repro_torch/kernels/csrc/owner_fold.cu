// owner_fold: the ordered fold of ready values into a flat buffer,
// acc[slot] = acc[slot] + v[e0] + v[e1] + ... one rounded add at a time,
// the run (e0, e1, ...) of each slot given by a slot-owner table.
//
// Replaces no TPU kernel.  It is the slab owner's fold of the 2-D
// (member x slab) ingest, repro/core/distributed.py:
// gather_slab_scatter_2d, whose `buf.at[dst].add(payload)` XLA runs as one
// scatter-add that adds in the order of the payload.  A group's payload
// holds several members, so one fine slot appears in it more than once,
// and the payloads of all groups arrive in global member order: the
// per-slot sum is a left fold in member order, which is what makes the
// sharded surplus bitwise the single-device one.  index_add_, scatter_add_
// and atomics on the card add in no fixed order and would break those
// bits.  Here the order is data: a slot-owner table built on the host
// once per sharded plan (repro_torch/kernels/hierarchize.py: owner_table)
// lists for every slot the payload positions that land on it, in payload
// order, in CSR form, the owners with the longest runs first.
//
// v = acc[s]; v = add_rn(v, values[entries[j]]) down each owner's run;
// acc[s] = v.  It is the staged fold of phase 2 of axis_pass_scatter_fwd.cu
// (fold_owner_runs in hier3.cuh), reading through the entry list instead
// of a product array: a block takes a range of consecutive short owners,
// loads their span of entries coalesced, gathers the values into shared
// memory with every load in flight and folds each run from there; an owner
// whose run is longer than 32 keeps a warp of its own.  No atomics, and no
// two threads write one slot.  Every add is rounded on its own (add_rn), so
// nvcc cannot reassociate or contract anything.
//
// Bound: bytes.  Each value and its entry read once, each slot and its
// offsets read once and written once.  At the 2-D prod_3d ingest (73,915
// listed values onto 18,943 slots a slab pair) that is about 0.4 us of
// traffic: the launch and two rounds of dependent loads (entry, value)
// are the time, which the staging keeps to one round each per thread.

#include "hier3.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
    owner_fold_kernel(const int32_t* __restrict__ entries,
                      const int32_t* __restrict__ slots,
                      const int64_t* __restrict__ offsets,
                      int64_t long_owners,
                      const int64_t* __restrict__ bounds,
                      const T* __restrict__ values, T* __restrict__ acc) {
  __shared__ T staged[kFoldSpan];
  fold_owner_runs<T>(slots, offsets, long_owners, bounds, entries, values,
                     acc, staged);
}

template <typename T>
static int launch(const void* entries, const void* slots,
                  const void* offsets, int64_t owners, int64_t long_owners,
                  const void* ranges, int64_t nranges, const void* values,
                  int64_t count, void* acc, void* stream) {
  if (owners <= 0) return (int)cudaGetLastError();
  if (count <= 0 || long_owners < 0 || long_owners > owners || nranges < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t grid = fold_blocks(long_owners, nranges);
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  owner_fold_kernel<T><<<(unsigned int)grid, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)entries, (const int32_t*)slots,
      (const int64_t*)offsets, long_owners, (const int64_t*)ranges,
      (const T*)values, (T*)acc);
  return (int)cudaGetLastError();
}

#define FOLD_ENTRY(tag, T)                                                   \
  extern "C" int owner_fold_##tag(                                           \
      const void* entries, const void* slots, const void* offsets,           \
      int64_t owners, int64_t long_owners, const void* ranges,               \
      int64_t nranges, const void* values, int64_t count, void* acc,         \
      void* stream) {                                                        \
    return launch<T>(entries, slots, offsets, owners, long_owners, ranges,   \
                     nranges, values, count, acc, stream);                   \
  }

FOLD_ENTRY(f64, double)
FOLD_ENTRY(f32, float)
