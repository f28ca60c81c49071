// pole_inv: dehierarchization along one axis of a contiguous grid, viewed
// as (outer, n, inner), n = 2**level - 1: the coarse-to-fine level loop,
// one HBM round trip for each element.
//
// Replaces dehier_pole_pallas -> _dehier_pole_kernel
// (repro/kernels/hierarchize.py:225, :206).  The (N, B) bundle the TPU
// kernel takes is the view with outer = 1; every other axis of a grid is
// passed in place.
//
// Unlike the forward transform, the inverse is sequential in level: a
// node's value needs its two parents' FINAL values,
//   out[p] = a[p] + 0.5 * (l + r)
// rounded step by step (add_rn/mul_rn, no FMA) in the reference's order,
// an absent (boundary) parent entering as +0.0; the root is a[root].  A
// block stages a tile in shared memory (pole_tile.cuh), runs the level loop
// across its threads with one barrier a level (inverse_levels, shared with
// axis_pass_inv.cu) and writes the tile back coalesced.
//
// A pole too long for one tile (or spread over blocks because the view is
// narrow) is split at stride P: span m holds positions m P + 1 .. (m + 1) P.
// Its nodes below stride P depend only on one another and on the final
// values at its two ends, m P and (m + 1) P, both coarse nodes.  The chosen
// design computes those two ends in the same block, while the tile loads:
// a thread a column descends from the root to the end, each step one value
// of the path read from device memory (at most level - log2(P) of them,
// shared by every block of the column and so held in L2) and one rounded
// update in the reference's order.  That keeps one launch a pass and needs
// no second pass over a coarse sub-pole and no cluster: the ends cost
// 2 (level - log2 P) reads a column against P for the span.  Each end is
// computed by the two blocks that share it, with the same operations, so
// they agree bitwise.
//
// Bound: bytes (3 flops per element), the grid read once and written once.

#include "pole_tile.cuh"

// The final (nodal) value at 1-based position p of the pole whose
// hierarchical values lie at pole[(p - 1) * inner]: the descent from the
// root through the intervals that hold p, each midpoint from its interval's
// two final ends.
template <typename T>
__device__ T nodal_value(const T* __restrict__ pole, int64_t inner, int level,
                         int64_t p) {
  const T half = T(0.5);
  int64_t lo = 0, hi = int64_t(1) << level, mid = hi >> 1;
  T flo = T(0), fhi = T(0);
  T f = pole[(mid - 1) * inner];            // the root is never updated
  while (mid != p) {
    if (p < mid) {
      hi = mid;
      fhi = f;
    } else {
      lo = mid;
      flo = f;
    }
    mid = (lo + hi) >> 1;
    f = add_rn(pole[(mid - 1) * inner], mul_rn(half, add_rn(flo, fhi)));
  }
  return f;
}

template <typename T, bool kSwizzled>
__global__ void __launch_bounds__(kPoleInvThreads)
    pole_inv_kernel(const T* __restrict__ a, T* __restrict__ out,
                    const PoleGrid g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  int64_t r0;
  const Tile t = pole_tile(g, &r0);
  T* lo = tile + g.slots;   // a split span's left ends,
  T* hi = lo + t.nj;                      // then its right ends
  load_tile<T, kSwizzled>(tile, a, t);

  // A split span (no == 1) descends to its two ends, a column's left end
  // and right end each, while the tile loads.
  const bool split = t.rows < t.n;
  const int P = split ? t.rows : int(t.n + 1);
  if (split) {
    for (int k = threadIdx.x; k < 2 * t.nj; k += blockDim.x) {
      const int j = k < t.nj ? k : k - t.nj;
      const int64_t p = k < t.nj ? r0 : r0 + P;
      lo[k] = j < t.nj_eff && p >= 1 && p <= t.n
                  ? nodal_value(a + (t.base - r0 * t.inner) + j, t.inner,
                                g.level, p)
                  : T(0);
    }
  }
  copy_async_wait();
  __syncthreads();
  if (split && r0 + P <= t.n) {           // the right end is the last row
    for (int j = threadIdx.x; j < t.nj; j += blockDim.x)
      tile[slot<T, kSwizzled>((P - 1) * t.nj + j)] = hi[j];
  }
  __syncthreads();

  const int lp = __ffs(P) - 1;            // P = 2**lp
  inverse_levels<T, kSwizzled>(tile, t, lp, split ? lp - 1 : lp - 2,
                               t.rows_eff, split ? (const T*)lo : nullptr);
  store_tile<T, kSwizzled>(tile, out, t);
}

template <typename T>
static int launch(const void* a, void* out, int64_t outer, int64_t n,
                  int64_t inner, int64_t level, void* stream) {
  if (level < 2 || level > 30 || n != (int64_t(1) << level) - 1)
    return (int)cudaErrorInvalidValue;
  if (outer <= 0 || inner <= 0) return (int)cudaGetLastError();
  const PoleGrid g =
      pole_grid(outer, n, inner, (int)level, sizeof(T), kPoleInvThreads);
  auto kernel = g.swizzled ? pole_inv_kernel<T, true>
                           : pole_inv_kernel<T, false>;
  if (g.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned int)g.blocks, g.threads, (size_t)g.bytes,
           (cudaStream_t)stream>>>((const T*)a, (T*)out, g);
  return (int)cudaGetLastError();
}

extern "C" int pole_inv_f64(const void* a, void* out, int64_t outer,
                            int64_t n, int64_t inner, int64_t level,
                            void* stream) {
  return launch<double>(a, out, outer, n, inner, level, stream);
}

extern "C" int pole_inv_f32(const void* a, void* out, int64_t outer,
                            int64_t n, int64_t inner, int64_t level,
                            void* stream) {
  return launch<float>(a, out, outer, n, inner, level, stream);
}
