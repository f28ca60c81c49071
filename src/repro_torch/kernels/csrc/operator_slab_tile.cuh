// One output tile of C = H . X that walks only the k-slabs where the tile's
// rows of H are nonzero, for axis_operator.cu.
//
// H is a 1-D (de)hierarchization operator (m x m): at most 3 nonzeros a
// row for H, at most `level` for H^-1, so most of its kOpM x kOpK tiles are
// zero.  The host lists, for each row tile r, the k-slabs s whose tile
// H[r*kOpM:, s*kOpK:] has a nonzero, in CSR form (offsets[r] ..
// offsets[r+1] index `slabs`), and packs those tiles row-major and
// zero-padded past m, one kOpM x kOpK block each, in the same order
// (`tiles`).  X is (m, ncols) row-major.
//
// Skipped tiles are exact zeros, so for finite X the sum loses only +0.0
// terms.  A NaN or Inf in X now stays in the row tiles whose listed slabs
// cover it: the rows whose operator entries touch it and the rest of their
// 64-row tiles (0 * Inf is NaN there), where the dense product spreads it
// to the whole column.
//
// f64 runs on the tensor cores (DMMA, mma.sync.aligned.m8n8k4 .f64; Hopper
// keeps them, wgmma has no f64): 128 threads, a 64 x 64 output tile, each
// warp 32 x 32 as 4 x 4 mma tiles of 8 x 8, K in slabs of 16 (four k-steps
// of 4).  Both operand tiles are double-buffered in shared memory by
// cp.async, the operator tile by 16-byte copies (its packed tiles are
// aligned), X by 8-byte copies zero-filled past the edges; the pitches
// (kOpK + 4, kOpN + 4 doubles) put the 16 lanes of a half-warp on 16
// different banks for every fragment load.
//
// f32 and bf16 run on the CUDA cores over the same slab list: 256 threads,
// 4 x 4 outputs each, one slab at a time; bf16 is widened on load, summed
// in f32 and rounded to bf16 once.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kOpM = 64;   // rows of an output tile (and of an H tile)
constexpr int kOpN = 64;   // columns of an output tile
constexpr int kOpK = 16;   // depth of a slab
constexpr int kMmaThreads = 128;
constexpr int kCoreThreads = 256;
constexpr int kApitch = kOpK + 4;
constexpr int kBpitch = kOpN + 4;

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// 8 bytes, or 8 zero bytes when !valid (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d += a . b for one 8 x 8 x 4 f64 product: a = A[lane / 4][lane % 4],
// b = B[lane % 4][lane / 4], d = D[lane / 4][2 * (lane % 4) + {0, 1}].
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a,
                                           double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

struct MmaSmem {
  double a[2][kOpM * kApitch];
  double b[2][kOpK * kBpitch];
};

// C[i0:i0+kOpM, j0:j0+kOpN] in f64 on DMMA.  Every thread of the
// 128-thread block calls it.
__device__ void operator_slab_tile_f64(
    const double* __restrict__ tiles, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ slabs, const double* __restrict__ x,
    double* __restrict__ c, int64_t m, int64_t ncols, int64_t row_tile,
    int64_t j0, MmaSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gr = lane >> 2, q = lane & 3;
  const int begin = offsets[row_tile], end = offsets[row_tile + 1];
  const int64_t i0 = row_tile * kOpM;

  auto load = [&](int slot, int t) {
    const double* h = tiles + int64_t(t) * kOpM * kOpK;
#pragma unroll
    for (int u = 0; u < kOpM * kOpK / 2 / kMmaThreads; ++u) {
      const int e = tid + u * kMmaThreads;        // 16-byte chunk
      const int row = e / (kOpK / 2), col = (e % (kOpK / 2)) * 2;
      cp_async16(&sm.a[slot][row * kApitch + col], h + row * kOpK + col);
    }
    const int64_t k0 = int64_t(slabs[t]) * kOpK;
#pragma unroll
    for (int u = 0; u < kOpK * kOpN / kMmaThreads; ++u) {
      const int e = tid + u * kMmaThreads;
      const int kk = e / kOpN, jj = e % kOpN;
      const int64_t gk = k0 + kk, gj = j0 + jj;
      const bool valid = gk < m && gj < ncols;
      cp_async8(&sm.b[slot][kk * kBpitch + jj],
                valid ? x + gk * ncols + gj : x, valid);
    }
  };

  double acc[4][4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v][0] = acc[u][v][1] = 0.0;

  if (begin < end) load(0, begin);
  cp_async_commit();
  for (int t = begin; t < end; ++t) {
    const int slot = (t - begin) & 1;
    if (t + 1 < end) load(slot ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait_one();          // slab t's copies have landed
    __syncthreads();
    const double* sa = sm.a[slot];
    const double* sb = sm.b[slot];
#pragma unroll
    for (int kk = 0; kk < kOpK; kk += 4) {
      double af[4], bf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        af[u] = sa[(wm + u * 8 + gr) * kApitch + kk + q];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        bf[v] = sb[(kk + q) * kBpitch + wn + v * 8 + gr];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          dmma_8x8x4(acc[u][v][0], acc[u][v][1], af[u], bf[v]);
    }
    __syncthreads();              // the slot is refilled next iteration
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t row = i0 + wm + u * 8 + gr;
    if (row >= m) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int64_t col = j0 + wn + v * 8 + 2 * q;
      if (col < ncols) c[row * ncols + col] = acc[u][v][0];
      if (col + 1 < ncols) c[row * ncols + col + 1] = acc[u][v][1];
    }
  }
}

template <typename Acc, typename T>
__device__ __forceinline__ Acc widen_to(T v) { return static_cast<Acc>(v); }
template <>
__device__ __forceinline__ float widen_to<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename Acc>
__device__ __forceinline__ T narrow_to(Acc v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow_to<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16(v);
}

template <typename Acc>
struct CoreSmem {
  Acc a[kOpK][kOpM + 1];
  Acc b[kOpK][kOpN + 1];
};

// The same tile on the CUDA cores (f32, or bf16 summed in f32).  Every
// thread of the 256-thread block calls it.
template <typename T, typename Acc>
__device__ void operator_slab_tile_core(
    const Acc* __restrict__ tiles, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ slabs, const T* __restrict__ x,
    T* __restrict__ c, int64_t m, int64_t ncols, int64_t row_tile,
    int64_t j0, CoreSmem<Acc>& sm) {
  const int tid = threadIdx.x;
  const int ri = tid / 16, ci = tid % 16;
  const int begin = offsets[row_tile], end = offsets[row_tile + 1];
  const int64_t i0 = row_tile * kOpM;
  Acc acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = Acc(0);

  for (int t = begin; t < end; ++t) {
    const Acc* h = tiles + int64_t(t) * kOpM * kOpK;
    const int64_t k0 = int64_t(slabs[t]) * kOpK;
#pragma unroll
    for (int u = 0; u < kOpM * kOpK / kCoreThreads; ++u) {
      const int e = tid + u * kCoreThreads;
      {  // operator tile, row-major: consecutive threads along k
        const int kk = e % kOpK, ii = e / kOpK;
        sm.a[kk][ii] = h[e];
      }
      {  // operand tile: consecutive threads along the columns
        const int kk = e / kOpN, jj = e % kOpN;
        const int64_t gk = k0 + kk, gj = j0 + jj;
        sm.b[kk][jj] = (gk < m && gj < ncols)
                           ? widen_to<Acc>(x[gk * ncols + gj])
                           : Acc(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kOpK; ++kk) {
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
      if (gi < m && gj < ncols) c[gi * ncols + gj] = narrow_to<T>(acc[u][v]);
    }
  }
}
