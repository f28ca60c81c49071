// fused_tail: (de)hierarchization along every tail axis 1..d-1 of a
// (N0, N1, ..., N_{d-1}) grid, one launch per axis of extent > 1.
//
// Replaces hier_fused_tail_pallas -> _fused_tail_kernel
// (repro/kernels/hierarchize.py:315, :293).  The TPU kernel holds a tile
// of axis-0 rows in VMEM and contracts each tail axis with its dense
// operator while the tile stays resident.  A 511 x 511 f64 slab (2 MB)
// does not fit in a block's shared memory, so that residency is not
// carried over: each axis is one pass over the whole grid, reading one
// buffer and writing another in device memory,
//   x -> ws0 -> ws1 -> ws0 -> ... -> out,
// and stream order separates the passes.  The workspaces hold the
// accumulator's type, so a bf16 grid is summed in f32 across all axes and
// rounded to bf16 once, as the reference's f32 tensordots are.
//
// A pass views its axis as (outer, n, inner) of the whole grid and
// multiplies only the operator's nonzero 64 x 16 tiles, on row 3's slab
// list and packed tiles (operator_slab_tile.cuh):
// * inner > 1: C[o] = H . X[o], X[o] an (n, inner) row-major block; one
//   block per (row tile, 64-column tile, o), the row tile fastest so that
//   the row tiles of one column strip share its slabs through L2;
// * inner = 1 (the last axis): C = X . H^T with X (outer, n) row-major, the
//   same slab list with the operand roles swapped, so that X is read along
//   its contiguous rows; one block per (H's row tile, 64 rows of X).
// f64 runs on DMMA, f32 and bf16 on the CUDA cores.  On the 511^3 cube a
// pass has 8 x 8 x 511 (axis 1) or 8 x 4,080 (axis 2) blocks.  Each pass's
// tile launch is followed by its repair launch (see the tile's header),
// which gives the lines that held a NaN or Inf the dense product's pattern
// before the next pass reads them; the passes' launch count counts the
// tile launches.
//
// Bound: bytes.  The function reads x once and writes out once (0.637 ms
// at 511^3 f64 on 3.35 TB/s); each extra axis adds a workspace round trip,
// and the listed tiles' flops are about a fifth of the dense operators'.

#include <type_traits>

#include "operator_slab_tile.cuh"

constexpr int kMaxTail = 9;  // d <= 10

template <bool kSwap>
__global__ void __launch_bounds__(kMmaThreads)
    fused_tail_f64_kernel(const double* __restrict__ tiles,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ slabs,
                          const double* __restrict__ src,
                          double* __restrict__ dst, int64_t outer, int64_t n,
                          int64_t inner, int64_t row_tiles,
                          int64_t col_tiles, NonFinite nf) {
  __shared__ __align__(16) MmaSmem<kSwap> sm;
  const int64_t r = int64_t(blockIdx.x) % row_tiles;
  const int64_t rest = int64_t(blockIdx.x) / row_tiles;
  if constexpr (kSwap) {
    operator_slab_tile_f64<true>(tiles, offsets, slabs, src, dst, n, outer,
                                 r, rest * kOpN, sm, nf, rest);
  } else {
    const int64_t base = rest / col_tiles * n * inner;
    operator_slab_tile_f64<false>(tiles, offsets, slabs, src + base,
                                  dst + base, n, inner, r,
                                  rest % col_tiles * kOpN, sm, nf, rest);
  }
}

template <typename TS, typename TD, bool kSwap>
__global__ void __launch_bounds__(kCoreThreads)
    fused_tail_core_kernel(const float* __restrict__ tiles,
                           const int32_t* __restrict__ offsets,
                           const int32_t* __restrict__ slabs,
                           const TS* __restrict__ src, TD* __restrict__ dst,
                           int64_t outer, int64_t n, int64_t inner,
                           int64_t row_tiles, int64_t col_tiles,
                           NonFinite nf) {
  __shared__ CoreSmem<float> sm;
  const int64_t r = int64_t(blockIdx.x) % row_tiles;
  const int64_t rest = int64_t(blockIdx.x) / row_tiles;
  if constexpr (kSwap) {
    operator_slab_tile_core<TS, TD, float, true>(
        tiles, offsets, slabs, src, dst, n, outer, r, rest * kOpN, sm, nf,
        rest);
  } else {
    const int64_t base = rest / col_tiles * n * inner;
    operator_slab_tile_core<TS, TD, float, false>(
        tiles, offsets, slabs, src + base, dst + base, n, inner, r,
        rest % col_tiles * kOpN, sm, nf, rest);
  }
}

struct Pass {
  const void* tiles;
  const int32_t* offsets;
  const int32_t* slabs;
  int64_t outer, n, inner;
};

// One pass src -> dst; returns the launch's error.
template <typename TS, typename TD>
static int launch_pass(const Pass& p, const TS* src, TD* dst, NonFinite nf,
                       cudaStream_t stream) {
  const int64_t row_tiles = (p.n + kOpM - 1) / kOpM;
  const bool swap = p.inner == 1;
  const int64_t col_tiles = swap ? 1 : (p.inner + kOpN - 1) / kOpN;
  const int64_t blocks =
      row_tiles * (swap ? (p.outer + kOpN - 1) / kOpN : col_tiles * p.outer);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  if constexpr (std::is_same<TS, double>::value) {
    auto kernel = swap ? fused_tail_f64_kernel<true>
                       : fused_tail_f64_kernel<false>;
    kernel<<<(unsigned int)blocks, kMmaThreads, 0, stream>>>(
        (const double*)p.tiles, p.offsets, p.slabs, src, dst, p.outer, p.n,
        p.inner, row_tiles, col_tiles, nf);
  } else {
    auto kernel = swap ? fused_tail_core_kernel<TS, TD, true>
                       : fused_tail_core_kernel<TS, TD, false>;
    kernel<<<(unsigned int)blocks, kCoreThreads, 0, stream>>>(
        (const float*)p.tiles, p.offsets, p.slabs, src, dst, p.outer, p.n,
        p.inner, row_tiles, col_tiles, nf);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_repair(nf, src, dst, p.outer, p.n, p.inner, p.offsets,
                       p.slabs, stream);
}

template <typename T, typename Acc>
static int launch(const void* x, void* ws0, void* ws1, void* out, void* state,
                  int64_t count, const int64_t* outer, const int64_t* n,
                  const int64_t* inner, const void* const* tiles,
                  const void* const* offsets, const void* const* slabs,
                  int64_t tile_m, int64_t tile_k, void* stream) {
  if (count < 1 || count > kMaxTail || !tile_is_ours(tile_m, tile_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const NonFinite nf{(unsigned int*)state};   // shared by the passes in turn
  Acc* ws[2] = {(Acc*)ws0, (Acc*)ws1};
  for (int a = 0; a < count; ++a) {
    const Pass p{tiles[a], (const int32_t*)offsets[a],
                 (const int32_t*)slabs[a], outer[a], n[a], inner[a]};
    const bool first = a == 0, last = a == count - 1;
    int err;
    if (first && last) {
      err = launch_pass<T, T>(p, (const T*)x, (T*)out, nf, st);
    } else if (first) {
      err = launch_pass<T, Acc>(p, (const T*)x, ws[0], nf, st);
    } else if (last) {
      err = launch_pass<Acc, T>(p, ws[(a - 1) % 2], (T*)out, nf, st);
    } else {
      err = launch_pass<Acc, Acc>(p, ws[(a - 1) % 2], ws[a % 2], nf, st);
    }
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

#define FUSED_TAIL_ENTRY(tag, T, Acc)                                        \
  extern "C" int fused_tail_##tag(                                           \
      const void* x, void* ws0, void* ws1, void* out, void* state,           \
      int64_t count, const int64_t* outer, const int64_t* n,                 \
      const int64_t* inner, const void* const* tiles,                        \
      const void* const* offsets, const void* const* slabs, int64_t tile_m,  \
      int64_t tile_k, void* stream) {                                        \
    return launch<T, Acc>(x, ws0, ws1, out, state, count, outer, n, inner,   \
                          tiles, offsets, slabs, tile_m, tile_k, stream);    \
  }

FUSED_TAIL_ENTRY(f64, double, double)
FUSED_TAIL_ENTRY(f32, float, float)
FUSED_TAIL_ENTRY(bf16, __nv_bfloat16, float)
