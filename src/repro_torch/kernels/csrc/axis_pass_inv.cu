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
// flops, so this kernel computes the same function as pole_inv.cu: the
// coarse-to-fine level loop.
//
// The stack is viewed as (G, outer, n, inner): the pass runs along n, and
// a column is one (g, outer, inner) position.  Member g's level L_g (int32,
// shape (G,)) gives its own head of n_g = 2**L_g - 1 nodes.  Each node is
//   out[i] = a[i] + 0.5 * (l + r)
// rounded step by step (add_rn/mul_rn, no FMA) from its two parents, which
// are final before it is computed, an absent (boundary) parent entering as
// +0.0 -- the order of ref.dehierarchize_1d_ref, so the result is bitwise
// the plain version's.  Positions >= n_g are copied unchanged: that is the
// identity on the padding that merged buckets' below-target members rely
// on.
//
// Bound: bytes (3 flops per element, each element read and written once).
// The level loop is a chain of L dependent steps per column, so the design
// keeps the chain in shared memory and spreads each step over a block:
//   * one block owns a tile of columns of one member, chosen on the host
//     (fewer columns when the stack is too small to give every SM two
//     blocks).  Where inner allows, the tile is one outer position's inner
//     range [j0, j0 + nj), a run of nj contiguous values per node, nj a
//     power of two up to 256 bytes (32 f64 columns at n = 511: 131 KB);
//     otherwise it is `no` whole outer positions, one contiguous range of
//     memory of at most 64 KB.  Neighbouring threads copy neighbouring
//     addresses in both layouts (cp.async, no registers), so the inner = 1
//     pass along a last axis is coalesced too;
//   * level l's 2**(l-1) nodes of every column are independent: the block
//     runs the level loop across its threads, in place in shared memory,
//     with one barrier between levels -- L <= 9 shared-memory steps for a
//     511-long axis instead of 511 dependent global ones;
//   * the tile is written back with the same coalesced mapping.
// A column longer than one block's shared memory (n * sizeof(T) > 227 KB,
// n > 29,056 in f64) takes the per-thread branch of the same kernel: one
// thread walks one whole column's level loop in device memory.

#include <algorithm>

#include "hier3.cuh"

constexpr int64_t kTileBytes = 64 * 1024;      // a tile of whole rows
constexpr int64_t kRunBytes = 256;             // a node's run in a tile
constexpr int64_t kMaxTileBytes = 232448;      // 227 KB: one block's limit
constexpr int kTileThreads = 512;

template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}

// The per-thread branch: one thread owns one whole column and walks its
// level loop in device memory, reading the parents back from the output it
// has already written (same thread, program order).
template <typename T>
__device__ void column_loop(const T* __restrict__ a, T* __restrict__ out,
                            const int32_t* __restrict__ levels, int64_t outer,
                            int64_t n, int64_t inner, int64_t columns) {
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

// One tile: `nj` values per node and outer position (nj = cols when inner
// >= cols, else inner), `no` outer positions (1, or cols / inner).  Shared
// memory holds the tile in its device-memory order, [o][i][j] with pitch
// nj, so a column (o, j) has its node i at (o * n + i) * nj + j.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    axis_pass_inv_kernel(const T* __restrict__ a, T* __restrict__ out,
                         const int32_t* __restrict__ levels, int64_t outer,
                         int64_t n, int64_t inner, int64_t columns, int no,
                         int nj) {
  if (nj == 0) {
    column_loop(a, out, levels, outer, n, inner, columns);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // Which tile: member g, outer positions [o0, o0 + no), inner [j0, j0 + nj).
  const int64_t jt = (inner + nj - 1) / nj;           // tiles across inner
  const int64_t per_member = (outer + no - 1) / no * jt;
  const int64_t g = int64_t(blockIdx.x) / per_member;
  const int64_t r = int64_t(blockIdx.x) - g * per_member;
  const int64_t o0 = r / jt * no, j0 = r % jt * nj;
  const int no_eff = (int)min(int64_t(no), outer - o0);
  const int nj_eff = (int)min(int64_t(nj), inner - j0);
  const int nn = (int)n;
  const int elems = no * nn * nj;
  const int64_t base = ((g * outer + o0) * n) * inner + j0;

  // Load: whole outer positions are one contiguous range; an inner range
  // is nj contiguous values per node (nj a power of two).  Slots past the
  // stack's edge are zero-filled and never stored.
  if (nj == inner) {
    const int valid = no_eff * nn * nj;
    for (int e = tid; e < elems; e += nthreads) {
      if (e < valid) copy_async(tile + e, a + base + e);
      else tile[e] = T(0);
    }
  } else {                                  // nj is a power of two here
    const int shift = __ffs(nj) - 1;
    for (int e = tid; e < elems; e += nthreads) {
      const int i = e >> shift, j = e & (nj - 1);
      if (j < nj_eff) copy_async(tile + e, a + base + int64_t(i) * inner + j);
      else tile[e] = T(0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The level loop, coarse to fine, across the block: work item w is node
  // t of column c at this level, columns fastest (n is odd, so neighbouring
  // columns of an inner = 1 tile fall in different banks).
  const int level = levels[g];
  const int head = (1 << level) - 1;
  const int ncols = no * nj;
  // ncols is a power of two unless whole outer positions of an inner that
  // is not one make the tile (small stacks only).
  const bool pow2 = (ncols & (ncols - 1)) == 0;
  const int cshift = __ffs(ncols) - 1;
  const T half = T(0.5);
  for (int lam = 2; lam <= level; ++lam) {
    const int s = 1 << (level - lam);
    const int work = (1 << (lam - 1)) * ncols;
    for (int w = tid; w < work; w += nthreads) {
      const int t = pow2 ? w >> cshift : w / ncols, c = w - t * ncols;
      const int col = no == 1 ? c
                      : nj == 1 ? c * nn
                                : (c / nj) * nn * nj + c % nj;
      const int i = s - 1 + 2 * s * t;
      const int at = col + i * nj;
      const T l = i >= s ? tile[at - s * nj] : T(0);
      const T rr = i + s < head ? tile[at + s * nj] : T(0);
      tile[at] = add_rn(tile[at], mul_rn(half, add_rn(l, rr)));
    }
    __syncthreads();
  }

  // Store with the load's mapping.
  if (nj == inner) {
    const int valid = no_eff * nn * nj;
    for (int e = tid; e < valid; e += nthreads) out[base + e] = tile[e];
  } else {
    const int shift = __ffs(nj) - 1;
    for (int e = tid; e < elems; e += nthreads) {
      const int i = e >> shift, j = e & (nj - 1);
      if (j < nj_eff) out[base + int64_t(i) * inner + j] = tile[e];
    }
  }
}

static int64_t floor_pow2(int64_t v) {
  int64_t p = 1;
  while (p * 2 <= v) p *= 2;
  return p;
}

template <typename T>
static int launch(const void* a, void* out, const void* levels, int64_t g,
                  int64_t outer, int64_t n, int64_t inner, void* stream) {
  const int64_t columns = g * outer * inner;
  if (columns <= 0 || n <= 0) return (int)cudaGetLastError();
  const int64_t column_bytes = n * int64_t(sizeof(T));
  if (column_bytes > kMaxTileBytes) {      // the per-thread branch
    axis_pass_inv_kernel<T><<<blocks_for(columns), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const T*)a, (T*)out, (const int32_t*)levels, outer, n, inner,
        columns, 0, 0);
    return (int)cudaGetLastError();
  }
  // Columns per tile, fewer when the stack is too narrow to give every SM
  // two blocks.  A tile of strided inner runs takes runs of kRunBytes (as
  // far as one block's shared memory allows): DRAM serves short runs spread
  // over n rows far below its rate.  A tile of whole outer positions is one
  // contiguous range and stays within kTileBytes, so that three blocks
  // share an SM.
  const int64_t spread =
      floor_pow2(std::max<int64_t>(1, columns / (2 * kSMs)));
  const int64_t run = std::min<int64_t>(
      spread, std::min<int64_t>(floor_pow2(kMaxTileBytes / column_bytes),
                                kRunBytes / int64_t(sizeof(T))));
  int64_t nj = run, no = 1;
  if (inner < run) {
    const int64_t fit =
        floor_pow2(std::max<int64_t>(1, kTileBytes / column_bytes));
    nj = inner;
    no = std::max<int64_t>(1, std::min(fit, spread) / inner);
  }
  const int64_t blocks = g * ((outer + no - 1) / no) * ((inner + nj - 1) / nj);
  const int64_t bytes = no * n * nj * int64_t(sizeof(T));
  // Threads: about one per node of the finest level, in whole warps.
  const int64_t finest = no * nj * ((n + 1) / 2);
  const int threads = (int)std::min<int64_t>(
      kTileThreads, std::max<int64_t>(32, (finest + 31) / 32 * 32));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        axis_pass_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxTileBytes);
    if (e != cudaSuccess) return (int)e;
  }
  axis_pass_inv_kernel<T><<<(unsigned int)blocks, threads, (size_t)bytes,
                            (cudaStream_t)stream>>>(
      (const T*)a, (T*)out, (const int32_t*)levels, outer, n, inner, columns,
      (int)no, (int)nj);
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
