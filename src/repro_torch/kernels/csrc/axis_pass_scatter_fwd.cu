// axis_pass_scatter_fwd: the last forward hierarchization pass of one or
// more bucket stacks fused with the coefficient-weighted scatter-add into
// the flat fine grid, acc[slot] = acc[slot] + c[m] * alpha[m, p], for every
// member of every stack in two launches.
//
// Replaces repro/kernels/hierarchize.py: hier_axis0_scatter_batched_pallas
// -> _axis0_scatter_kernel.  The TPU kernel keeps the whole fine buffer as
// a VMEM-resident output block and walks the members in order, so the
// adds into each fine slot are a left fold in member order -- the fold of
// the reference's unfused `full.at[idx].add(cs * alpha)`, which is why
// fused and unfused ingest give the same bits.  A Hopper SM has no such
// room, and launching once per member to keep that order (109 launches at
// prod_3d, each a few KB of work) made the scatter launch-bound.  Here the
// order is data instead: a slot-owner table, built on the host once per
// plan, lists for every fine slot the plan's index maps touch (pad
// positions excluded) its entries (global member, position) in global
// member order -- plan bucket order, then member order -- in CSR form, the
// owners with the longest runs first.  Entries are int32 element offsets
// into the concatenation of the stacks.
//
//   Phase 1 (one thread an entry): the entry's last-axis update (hier3) and
//     its product with the member's coefficient, mul_rn(c[m], alpha),
//     written in CSR order.
//   Phase 2 (the staged fold, fold_owner_runs in hier3.cuh): v = acc[s];
//     v = add_rn(v, prod[j]) down the run; acc[s] = v.  A block takes a
//     range of consecutive short owners, loads their span of products
//     coalesced into shared memory and folds each run from there; an owner
//     whose run is longer than 32 keeps a warp, which loads 32 products of
//     its run at once and folds them in order through shuffles, so the
//     109-long run of the centre slot is a chain of dependent adds and not
//     of dependent loads.
//
// The result is bitwise the left fold of per-member launches, from any
// starting acc, in f64 and f32: every product and sum is rounded on its own
// (a coefficient of +-3 would otherwise show an FMA in the last bit), and
// every slot's adds run in the same order.  No atomics, and no two threads
// write one slot.  The per-member bucket data (start, member size, first
// global member, the last axis's view and predecessor arrays) is a small
// table that phase 1 searches by an entry's offset.
//
// Bound: bytes.  Each stack element is read once, each entry's index and
// product once, and each touched slot read and written once.

#include "hier3.cuh"

struct ScatterBucket {
  int64_t start;      // element offset of the stack in the concatenation
  int64_t member;     // elements of one member
  int64_t first;      // global index of its first member (coefficients)
  int64_t n, inner;   // the last pass's view inside a member
  // device addresses of the last axis's predecessor arrays, each (g, n)
  int64_t lp, rp, lm, rm;
};

template <typename T>
__global__ void scatter_products_kernel(const ScatterBucket* __restrict__ bk,
                                        int64_t nbuckets,
                                        const int32_t* __restrict__ entries,
                                        int64_t count,
                                        const T* __restrict__ y,
                                        const T* __restrict__ coeffs,
                                        T* __restrict__ prod) {
  for (int64_t j = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; j < count;
       j += int64_t(gridDim.x) * blockDim.x) {
    const int64_t e = entries[j];
    int64_t lo = 0, hi = nbuckets - 1;   // the last bucket starting <= e
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) / 2;
      if (bk[mid].start <= e) lo = mid; else hi = mid - 1;
    }
    const ScatterBucket& b = bk[lo];
    const int64_t off = e - b.start, m = off / b.member;
    const int64_t p = off - m * b.member, row = m * b.n;
    const T alpha = hier3<T>(
        y + b.start + m * b.member, p, (p / b.inner) % b.n, b.inner,
        reinterpret_cast<const int32_t*>(b.lp) + row,
        reinterpret_cast<const int32_t*>(b.rp) + row,
        reinterpret_cast<const uint8_t*>(b.lm) + row,
        reinterpret_cast<const uint8_t*>(b.rm) + row);
    prod[j] = mul_rn(coeffs[b.first + m], alpha);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_fold_kernel(const int32_t* __restrict__ slots,
                        const int64_t* __restrict__ offsets,
                        int64_t long_owners,
                        const int64_t* __restrict__ bounds,
                        const T* __restrict__ prod, T* __restrict__ acc) {
  __shared__ T staged[kFoldSpan];
  fold_owner_runs<T>(slots, offsets, long_owners, bounds, nullptr, prod, acc,
                     staged);
}

template <typename T>
static int launch(const void* buckets, int64_t nbuckets, const void* entries,
                  int64_t count, const void* slots, const void* offsets,
                  int64_t owners, int64_t long_owners, const void* ranges,
                  int64_t nranges, const void* y, const void* coeffs,
                  void* prod, void* acc, void* stream) {
  if (count <= 0 || owners <= 0) return (int)cudaGetLastError();
  if (nbuckets <= 0 || long_owners < 0 || long_owners > owners ||
      nranges < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  scatter_products_kernel<T><<<blocks_for(count), kThreads, 0, st>>>(
      (const ScatterBucket*)buckets, nbuckets, (const int32_t*)entries, count,
      (const T*)y, (const T*)coeffs, (T*)prod);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = fold_blocks(long_owners, nranges);
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  scatter_fold_kernel<T><<<(unsigned int)grid, kThreads, 0, st>>>(
      (const int32_t*)slots, (const int64_t*)offsets, long_owners,
      (const int64_t*)ranges, (const T*)prod, (T*)acc);
  return (int)cudaGetLastError();
}

#define SCATTER_ENTRY(tag, T)                                                \
  extern "C" int axis_pass_scatter_fwd_##tag(                                \
      const void* buckets, int64_t nbuckets, const void* entries,            \
      int64_t count, const void* slots, const void* offsets, int64_t owners, \
      int64_t long_owners, const void* ranges, int64_t nranges,              \
      const void* y, const void* coeffs, void* prod, void* acc,              \
      void* stream) {                                                        \
    return launch<T>(buckets, nbuckets, entries, count, slots, offsets,      \
                     owners, long_owners, ranges, nranges, y, coeffs, prod,  \
                     acc, stream);                                           \
  }

SCATTER_ENTRY(f64, double)
SCATTER_ENTRY(f32, float)
