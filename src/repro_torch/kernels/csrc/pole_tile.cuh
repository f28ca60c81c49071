// Level-parallel tiles in shared memory for a pass along the middle axis of
// an (outer, n, inner) view: the loader, the store and the inverse level
// loop shared by pole_fwd.cu, pole_inv.cu and axis_pass_inv.cu.
//
// A tile is `no` outer positions x `rows` rows along the axis x `nj` inner
// values, held in shared memory in device-memory order [o][i][j] (pitch nj;
// rows per outer position `rows`).  Two shapes:
//   * nj == inner: each outer position's rows are one contiguous range, and
//     whole poles (rows == n) of `no` outer positions are one contiguous
//     range too (no > 1 only then);
//   * nj < inner, nj a power of two, no == 1: a run of nj contiguous values
//     on each row, rows `inner` apart.
// Neighbouring threads copy neighbouring addresses in both (cp.async, no
// registers), so every pass is coalesced, also the inner = 1 pass along a
// last axis.  Slots past the view's edge are zero-filled and never stored.
//
// Node positions are 1-based inside a pole: node p sits in row p - 1, its
// level's stride is s = p & -p, its parents are p - s and p + s, and
// position 0 and 2**L are the (absent) boundary, which enters as +0.0.
#pragma once

#include <algorithm>

#include "hier3.cuh"

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

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where a tile lies in the view, and how much of it lies inside.
struct Tile {
  int64_t base;                   // offset of value (o0, r0, j0)
  int64_t n, inner;               // the view's pole length and row stride
  int no, rows, nj;               // shared-memory extents [no][rows][nj]
  int no_eff, rows_eff, nj_eff;   // the part inside the view
};

// The shared-memory slot of tile value e.  A tile of one column (one span
// of a contiguous pole) is swizzled (kSwizzled): the level loop's work
// items are its nodes at stride 2 s, whose unswizzled slots share a bank
// 2 s ways at a time.  XOR-ing every higher group of B bits of e into its
// lowest B bits (B = 4 for 8-byte values, whose 16 fill a 128-byte
// wavefront; 5 for 4-byte ones) keeps each group of 2**B values in place
// as a whole and gives the 2**B nodes of any power-of-two stride distinct
// banks; runs of neighbouring values stay conflict-free too.  Other tiles,
// whose work items are neighbouring columns, keep the identity, compiled
// apart so that they pay nothing for it.
template <typename T, bool kSwizzled>
__device__ __forceinline__ int slot(int e) {
  constexpr int B = sizeof(T) == 8 ? 4 : 5, M = (1 << B) - 1;
  if constexpr (kSwizzled)
    return e ^ (((e >> B) ^ (e >> 2 * B) ^ (e >> 3 * B)) & M);
  return e;
}

// Starts the asynchronous copy of the tile into shared memory; the caller
// waits (copy_async_wait) and synchronises before reading it.
template <typename T, bool kSwizzled = false>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ src,
                                          const Tile& t) {
  const int elems = t.no * t.rows * t.nj;
  if (t.nj == t.inner) {
    const int valid = t.no_eff * t.rows_eff * t.nj;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      if (e < valid)
        copy_async(tile + slot<T, kSwizzled>(e), src + t.base + e);
      else
        tile[slot<T, kSwizzled>(e)] = T(0);
    }
  } else {
    const int shift = __ffs(t.nj) - 1;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int i = e >> shift, j = e & (t.nj - 1);
      if (i < t.rows_eff && j < t.nj_eff)
        copy_async(tile + slot<T, kSwizzled>(e),
                   src + t.base + int64_t(i) * t.inner + j);
      else
        tile[slot<T, kSwizzled>(e)] = T(0);
    }
  }
}

// Writes the tile's part inside the view back with the load's mapping.
template <typename T, bool kSwizzled = false>
__device__ __forceinline__ void store_tile(const T* tile, T* __restrict__ dst,
                                           const Tile& t) {
  if (t.nj == t.inner) {
    const int valid = t.no_eff * t.rows_eff * t.nj;
    for (int e = threadIdx.x; e < valid; e += blockDim.x)
      dst[t.base + e] = tile[slot<T, kSwizzled>(e)];
  } else {
    const int shift = __ffs(t.nj) - 1;
    const int elems = t.rows * t.nj;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int i = e >> shift, j = e & (t.nj - 1);
      if (i < t.rows_eff && j < t.nj_eff)
        dst[t.base + int64_t(i) * t.inner + j] =
            tile[slot<T, kSwizzled>(e)];
    }
  }
}

// Shared-memory offset of row 0 of tile column c (c = o * nj + j).
__device__ __forceinline__ int column_offset(const Tile& t, int c) {
  return t.no == 1 ? c
         : t.nj == 1 ? c * t.rows
                     : (c / t.nj) * t.rows * t.nj + c % t.nj;
}

// The coarse-to-fine level loop of the inverse, across the block, in place
// in shared memory, one barrier a level.  Tile-local node q (1-based, row
// q - 1 of every column) at stride s becomes
//   a[q] + 0.5 * (l + r)
// rounded step by step (add_rn/mul_rn, no FMA) from its final parents
// q - s and q + s, the order of ref.dehierarchize_1d_ref, so the result is
// bitwise the plain version's.  The strides run from 2**top down to 1, P /
// (2 s) nodes a column at stride s, P = 2**lp the tile's span.  A right
// parent past row lim - 1 enters as +0.0; the left parent q - s = 0 is
// lo[c], or +0.0 when lo is null.  Columns are the fastest index of the
// work (n is odd, so neighbouring columns of an inner = 1 tile fall in
// different banks).
template <typename T, bool kSwizzled = false>
__device__ __forceinline__ void inverse_levels(T* tile, const Tile& t,
                                               int lp, int top, int lim,
                                               const T* lo) {
  const int ncols = t.no * t.nj;
  const bool pow2 = (ncols & (ncols - 1)) == 0;
  const int cshift = __ffs(ncols) - 1;
  const T half = T(0.5);
  for (int e = top; e >= 0; --e) {
    const int s = 1 << e;
    const int work = ncols << (lp - e - 1);
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      const int k = pow2 ? w >> cshift : w / ncols, c = w - k * ncols;
      const int q = s * (2 * k + 1);
      const int at = column_offset(t, c) + (q - 1) * t.nj;
      const T l = q > s  ? tile[slot<T, kSwizzled>(at - s * t.nj)]
                  : lo ? lo[c]
                       : T(0);
      const T r = q + s <= lim ? tile[slot<T, kSwizzled>(at + s * t.nj)]
                               : T(0);
      T& node = tile[slot<T, kSwizzled>(at)];
      node = add_rn(node, mul_rn(half, add_rn(l, r)));
    }
    __syncthreads();
  }
}

inline int64_t floor_pow2(int64_t v) {
  int64_t p = 1;
  while (p * 2 <= v) p *= 2;
  return p;
}

// ---------------------------------------------------------------------------
// The tiling of a pole pass (pole_fwd.cu, pole_inv.cu) over an (outer, n,
// inner) view of a contiguous grid, n = 2**level - 1.
//
// A tile holds whole poles where they fit in kPoleTileBytes (rows == n; of
// several outer positions when inner is small), else rows = P of each
// pole, P a power of two: the pole is split into spans of P rows, span m
// holding positions m P + 1 .. (m + 1) P, whose nodes below stride P have
// both parents inside the span or at its left end m P (the previous
// span's last row), and whose last row is a coarse node, a multiple of P.
// Tiles of kPoleTileBytes leave room for several blocks on an SM, so some
// blocks' loads overlap others' level loops and stores; a strided tile
// reads runs of kPoleRunBytes on each row (DRAM serves short runs spread
// over many rows far below its rate), so a span of a strided view is short
// (32 rows in f64) and a pole is split even where it would fit whole.
// Where the view is too small to give every SM four blocks, tiles get
// fewer outer positions, then shorter spans (down to kPoleMinRows), then
// fewer inner values: a single pole is spread over many blocks.
// ---------------------------------------------------------------------------

constexpr int64_t kPoleTileBytes = 32 * 1024;
constexpr int64_t kPoleRunBytes = 1024;        // a row's run of inner values
constexpr int64_t kPoleMinRows = 64;
// Threads a block: the forward's stores come straight from its stencil, so
// more threads keep more of them in flight; the inverse, a barrier a level,
// ran slower with 512 than with 256 on the card.
constexpr int kPoleFwdThreads = 512;
constexpr int kPoleInvThreads = 256;

struct PoleGrid {
  int64_t outer, n, inner;
  int level;
  int no, rows, nj;               // tile extents; rows < n: spans of P = rows
  int64_t tiles_r, tiles_j;       // tiles along the pole and along inner
  int64_t blocks;
  int threads;
  bool swizzled;                  // a tile of one column (slot)
  int slots;                      // the tile's values, rounded up to 32
  int64_t bytes;                  // its slots and two values a tile column
};

inline PoleGrid pole_grid(int64_t outer, int64_t n, int64_t inner, int level,
                          int64_t elem, int max_threads) {
  int64_t nj = std::min(inner, kPoleRunBytes / elem), no = 1;
  bool whole = n * nj * elem <= kPoleTileBytes;
  int64_t P = whole ? n + 1 : floor_pow2(kPoleTileBytes / (nj * elem));
  if (whole && nj == inner)
    no = floor_pow2(std::max<int64_t>(1, kPoleTileBytes / (n * inner * elem)));
  auto blocks = [&] {
    return (outer + no - 1) / no * (whole ? 1 : (n + 1) / P) *
           ((inner + nj - 1) / nj);
  };
  while (blocks() < 4 * kSMs) {
    if (no > 1) {
      no /= 2;
    } else if (P / 2 >= kPoleMinRows) {
      P /= 2;
      whole = false;
    } else if (nj < inner && nj > 1) {
      nj /= 2;
    } else {
      break;
    }
  }
  PoleGrid g;
  g.outer = outer;
  g.n = n;
  g.inner = inner;
  g.level = level;
  g.no = (int)no;
  g.rows = (int)(whole ? n : P);
  g.nj = (int)nj;
  g.tiles_r = whole ? 1 : (n + 1) / P;
  g.tiles_j = (inner + nj - 1) / nj;
  g.blocks = blocks();
  const int64_t elems = no * g.rows * nj;
  // About four values a thread, in whole warps, at most max_threads.
  g.threads = (int)std::min<int64_t>(
      max_threads, std::max<int64_t>(32, (elems / 4 + 31) / 32 * 32));
  g.swizzled = no == 1 && nj == 1;
  // A swizzled slot stays inside the tile's group of 32 values.
  g.slots = (int)((elems + 31) / 32 * 32);
  g.bytes = (g.slots + 2 * no * nj) * elem;
  return g;
}

// The tile of this block and the row r0 where its span starts.
__device__ __forceinline__ Tile pole_tile(const PoleGrid& g, int64_t* r0) {
  const int64_t b = blockIdx.x;
  const int64_t tj = b % g.tiles_j, rest = b / g.tiles_j;
  const int64_t tr = rest % g.tiles_r, to = rest / g.tiles_r;
  const int64_t o0 = to * g.no, j0 = tj * g.nj;
  *r0 = tr * g.rows;
  Tile t;
  t.base = (o0 * g.n + *r0) * g.inner + j0;
  t.n = g.n;
  t.inner = g.inner;
  t.no = g.no;
  t.rows = g.rows;
  t.nj = g.nj;
  t.no_eff = (int)min(int64_t(g.no), g.outer - o0);
  t.rows_eff = (int)min(int64_t(g.rows), g.n - *r0);
  t.nj_eff = (int)min(int64_t(g.nj), g.inner - j0);
  return t;
}
