// One output tile of C = H . B on CUDA cores, shared by axis_operator.cu
// and fused_tail.cu: a dense 1-D (de)hierarchization operator H (m x m,
// row-major, in the accumulator's type) applied to a strided operand B.
//
// Element (k, j) of B lies at B[k * b_ks + j * b_ns] and element (i, j) of
// C at C[i * c_ms + j * c_ns], so one routine serves both layouts a pass
// meets: the transformed axis with a contiguous trailing run
// (b_ns = c_ns = 1), and the transformed axis LAST in memory (b_ks =
// c_ms = 1), where the columns of B are the rows of the operand.  The
// loads and stores pick their thread mapping from whichever stride is 1,
// so the neighbouring threads of a warp touch neighbouring addresses in
// both layouts.
//
// The tile is kTile x kTile outputs, 256 threads, 4 x 4 outputs each;
// K runs in steps of kDepth through two shared-memory tiles (padded by one
// column against bank conflicts).  Sums run over k in order with
// fused multiply-adds: the result is held to a tolerance, not to bits.
// bf16 operands are widened to float on load and the sum is written back
// rounded to nearest even, as a float32-accumulating dot would.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kGemmThreads = 256;

template <typename Acc, typename T>
__device__ __forceinline__ Acc widen(T v) { return static_cast<Acc>(v); }
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename Acc>
__device__ __forceinline__ T narrow(Acc v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}

template <typename Acc>
struct GemmSmem {
  Acc a[kDepth][kTile + 1];
  Acc b[kDepth][kTile + 1];
};

// C[i0:i0+kTile, j0:j0+kTile] = H[i0:, :] . B[:, j0:], masked to (m, ncols).
// Every thread of the block must call it (it synchronises the block).
template <typename Acc, typename TB, typename TC>
__device__ void operator_tile(const Acc* __restrict__ h, const TB* bsrc,
                              int64_t b_ks, int64_t b_ns, TC* c, int64_t c_ms,
                              int64_t c_ns, int64_t m, int64_t ncols,
                              int64_t i0, int64_t j0, GemmSmem<Acc>& sm) {
  const int tid = threadIdx.x;
  const bool row_major_c = c_ns == 1;
  // thread's output rows fast index and column fast index
  const int ri = row_major_c ? tid / 16 : tid % 16;
  const int ci = row_major_c ? tid % 16 : tid / 16;
  Acc acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = Acc(0);

  for (int64_t k0 = 0; k0 < m; k0 += kDepth) {
#pragma unroll
    for (int q = 0; q < kTile * kDepth / kGemmThreads; ++q) {
      const int e = tid + q * kGemmThreads;
      {  // operator tile: consecutive threads along k (H is row-major)
        const int kk = e % kDepth, ii = e / kDepth;
        const int64_t gi = i0 + ii, gk = k0 + kk;
        sm.a[kk][ii] = (gi < m && gk < m) ? h[gi * m + gk] : Acc(0);
      }
      {  // operand tile: consecutive threads along the unit stride
        const int kk = b_ns == 1 ? e / kTile : e % kDepth;
        const int jj = b_ns == 1 ? e % kTile : e / kDepth;
        const int64_t gk = k0 + kk, gj = j0 + jj;
        sm.b[kk][jj] = (gk < m && gj < ncols)
                           ? widen<Acc>(bsrc[gk * b_ks + gj * b_ns])
                           : Acc(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      Acc av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) av[u] = sm.a[kk][ri + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = sm.b[kk][ci + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * bv[v];
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int64_t gi = i0 + ri + 16 * u, gj = j0 + ci + 16 * v;
      if (gi < m && gj < ncols) c[gi * c_ms + gj * c_ns] = narrow<TC>(acc[u][v]);
    }
  }
}
