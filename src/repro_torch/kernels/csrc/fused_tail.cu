// fused_tail: (de)hierarchization along every tail axis 1..d-1 of a
// (N1, N2, ..., Nd) grid in ONE launch.
//
// Replaces hier_fused_tail_pallas -> _fused_tail_kernel
// (repro/kernels/hierarchize.py:315, :293).  The TPU kernel holds a tile
// of axis-0 rows in VMEM and contracts each tail axis with its dense
// operator while the tile stays resident.  A 511 x 511 f64 slab (2 MB)
// does not fit in a block's shared memory, so here one block owns one
// axis-0 row (its slab of N2 * ... * Nd elements) and contracts the tail
// axes in turn, each a dense operator product (operator_gemm.cuh),
// reading one buffer and writing another in device memory:
//   x -> ws0 -> ws1 -> ws0 -> ... -> out,
// with a block-wide barrier between axes.  No block reads another's row,
// so the axes need no grid-wide synchronisation.  The workspaces hold the
// accumulator's type, so a bf16 grid is summed in f32 across all axes and
// rounded to bf16 once, as the reference's f32 tensordots are.
//
// An axis is viewed as (outer, n, inner) inside the slab.  With inner > 1
// each of the outer blocks is one product H . (n x inner); with inner = 1
// (the last axis) the whole slab is one product whose operand columns are
// the slab's rows.  Tail axes of extent 1 are the identity: the wrapper
// passes only the others.
//
// Bound: operations (2 n_k flops per element per axis, above the ridge at
// n = 511); one block per row leaves 511 blocks for a 511^3 grid, under
// four per SM.

#include "operator_gemm.cuh"

constexpr int kMaxTail = 9;  // d <= 10

struct TailAxes {
  int64_t outer[kMaxTail];
  int64_t n[kMaxTail];
  int64_t inner[kMaxTail];
  const void* op[kMaxTail];
  int count;
};

template <typename Acc, typename TS, typename TD>
__device__ void apply_axis(const Acc* __restrict__ h, const TS* src, TD* dst,
                           int64_t outer, int64_t n, int64_t inner,
                           GemmSmem<Acc>& sm) {
  if (inner == 1) {
    for (int64_t i0 = 0; i0 < n; i0 += kTile)
      for (int64_t j0 = 0; j0 < outer; j0 += kTile)
        operator_tile<Acc, TS, TD>(h, src, 1, n, dst, 1, n, n, outer, i0, j0,
                                   sm);
    return;
  }
  for (int64_t o = 0; o < outer; ++o) {
    const TS* s = src + o * n * inner;
    TD* d = dst + o * n * inner;
    for (int64_t i0 = 0; i0 < n; i0 += kTile)
      for (int64_t j0 = 0; j0 < inner; j0 += kTile)
        operator_tile<Acc, TS, TD>(h, s, inner, 1, d, inner, 1, n, inner, i0,
                                   j0, sm);
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kGemmThreads)
    fused_tail_kernel(const T* __restrict__ x, Acc* ws0, Acc* ws1,
                      T* __restrict__ out, int64_t slab, TailAxes axes) {
  __shared__ GemmSmem<Acc> sm;
  const int64_t base = int64_t(blockIdx.x) * slab;
  Acc* ws[2] = {ws0 ? ws0 + base : nullptr, ws1 ? ws1 + base : nullptr};
  for (int a = 0; a < axes.count; ++a) {
    const Acc* h = (const Acc*)axes.op[a];
    const int64_t outer = axes.outer[a], n = axes.n[a], inner = axes.inner[a];
    const bool first = a == 0, last = a == axes.count - 1;
    if (first && last) {
      apply_axis<Acc, T, T>(h, x + base, out + base, outer, n, inner, sm);
    } else if (first) {
      apply_axis<Acc, T, Acc>(h, x + base, ws[0], outer, n, inner, sm);
    } else if (last) {
      apply_axis<Acc, Acc, T>(h, ws[(a - 1) % 2], out + base, outer, n, inner,
                              sm);
    } else {
      apply_axis<Acc, Acc, Acc>(h, ws[(a - 1) % 2], ws[a % 2], outer, n,
                                inner, sm);
    }
    __syncthreads();  // this axis's output is the next one's input
  }
}

template <typename T, typename Acc>
static int launch(const void* x, void* ws0, void* ws1, void* out,
                  int64_t rows, int64_t slab, int64_t count,
                  const int64_t* outer, const int64_t* n,
                  const int64_t* inner, const void* const* ops,
                  void* stream) {
  if (count < 1 || count > kMaxTail) return (int)cudaErrorInvalidValue;
  TailAxes axes{};
  axes.count = (int)count;
  for (int a = 0; a < count; ++a) {
    axes.outer[a] = outer[a];
    axes.n[a] = n[a];
    axes.inner[a] = inner[a];
    axes.op[a] = ops[a];
  }
  if (rows > 0 && slab > 0) {
    fused_tail_kernel<T, Acc><<<(unsigned int)rows, kGemmThreads, 0,
                                (cudaStream_t)stream>>>(
        (const T*)x, (Acc*)ws0, (Acc*)ws1, (T*)out, slab, axes);
  }
  return (int)cudaGetLastError();
}

#define FUSED_TAIL_ENTRY(tag, T, Acc)                                        \
  extern "C" int fused_tail_##tag(                                           \
      const void* x, void* ws0, void* ws1, void* out, int64_t rows,          \
      int64_t slab, int64_t count, const int64_t* outer, const int64_t* n,   \
      const int64_t* inner, const void* const* ops, void* stream) {          \
    return launch<T, Acc>(x, ws0, ws1, out, rows, slab, count, outer, n,     \
                          inner, ops, stream);                               \
  }

FUSED_TAIL_ENTRY(f64, double, double)
FUSED_TAIL_ENTRY(f32, float, float)
FUSED_TAIL_ENTRY(bf16, __nv_bfloat16, float)
