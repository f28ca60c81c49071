// One 64 x 64 output tile of an operator product that walks only the
// k-slabs where the operator is nonzero, for axis_operator.cu (row 3) and
// fused_tail.cu (row 4).
//
// H is a 1-D (de)hierarchization operator (m x m): at most 3 nonzeros a
// row for H, at most `level` for H^-1, so most of its kOpM x kOpK tiles are
// zero.  The host lists, for each row tile r, the k-slabs s whose tile
// H[r*kOpM:, s*kOpK:] has a nonzero, in CSR form (offsets[r] ..
// offsets[r+1] index `slabs`), and packs those tiles row-major and
// zero-padded past m, one kOpM x kOpK block each, in the same order
// (`tiles`).
//
// The operand takes one of two roles (kSwap):
// * kSwap = false, C = H . X with X and C (m x other) row-major: the tile
//   holds rows r*kOpM.. of C (H's row tile r) and columns start..start+63;
//   the A operand is H's packed tile, the B operand X's slab rows.
// * kSwap = true, C = X . H^T with X and C (other x m) row-major, the
//   transform along the LAST axis: the tile holds rows start..start+63 of C
//   and columns r*kOpM.. (H's row tile r again, so the same slab list
//   serves); the A operand is X[rows, k-slab], contiguous along k, and the
//   B operand H's packed tile read transposed from shared memory.  Every
//   load and store runs along a contiguous row: no strided gather of X^T.
//
// Skipped tiles are exact zeros, so for finite X the sum loses only +0.0
// terms.  A NaN or Inf in X is another matter: the dense product spreads it
// along the whole transformed line (0 * Inf is NaN), the listed tiles alone
// would keep it inside the tiles whose slabs cover it.  The repair has two
// parts.  A tile block marks each line of its tile whose outputs are not
// finite (NonFinite, 64 lines a column strip).  H's diagonal is 1 (for
// H^-1 too), so the row tile r of a non-finite x[k] lists k's slab, and
// that slab's product (0 * Inf included) makes every output of the line in
// r's tile non-finite: the line is marked by r, which checks one output a
// line.  A mark without a non-finite x (a finite sum that overflowed)
// repairs nothing.  Then a second launch on the same stream
// (repair_nonfinite_kernel, one block a strip) returns at once for a strip
// with no mark, and otherwise gives the marked lines the dense product's
// pattern: an output of row tile r becomes NaN when its line holds a
// non-finite value in a slab that r does not list (the dense product's
// 0 * NaN or 0 * Inf term there), and keeps its tile sum otherwise (whose
// own terms give the dense product's NaN / +-Inf pattern).  On finite input
// that costs a few integer operations a thread and the repair launch's few
// microseconds; no host synchronisation.
//
// f64 runs on the tensor cores (DMMA, mma.sync.aligned.m8n8k4 .f64; Hopper
// keeps them, wgmma has no f64): 128 threads, each warp 32 x 32 of the
// tile as 4 x 4 mma tiles of 8 x 8, K in slabs of 16 (four k-steps of 4).
// Both operand tiles are double-buffered in shared memory by cp.async, the
// operator tile by 16-byte copies (its packed tiles are aligned), X by
// 8-byte copies zero-filled past the edges; the pitches (kOpK + 4, kOpN +
// 4 doubles) put the 16 lanes of a half-warp on 16 different banks for
// every fragment load, in both roles.
//
// f32 and bf16 run on the CUDA cores over the same slab list: 256 threads,
// 4 x 4 outputs each, one slab at a time; bf16 is widened on load and
// summed in f32.  Input and output types are separate (TS, TD), so a chain
// of passes can keep f32 sums between them and round to bf16 once.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

constexpr int kOpM = 64;   // rows of an operator tile (and of an output tile)
constexpr int kOpN = 64;   // the other side of an output tile
constexpr int kOpK = 16;   // depth of a slab
constexpr int kMmaThreads = 128;
constexpr int kCoreThreads = 256;
constexpr int kApitch = kOpK + 4;
constexpr int kBpitch = kOpN + 4;

// The caller packs the operator in (tile_m, tile_k) tiles; any tile but
// these kernels' own would be read wrongly, so the entry points refuse it.
inline bool tile_is_ours(int64_t tile_m, int64_t tile_k) {
  return tile_m == kOpM && tile_k == kOpK;
}

// The exponent field of v in place: kInfExponent for an Inf or a NaN.
__device__ __forceinline__ int exponent_bits(double v) {
  return __double2hiint(v) & 0x7ff00000;
}
__device__ __forceinline__ int exponent_bits(float v) {
  return __float_as_int(v) & 0x7f800000;
}
template <typename T>
constexpr int kInfExponent = sizeof(T) == 8 ? 0x7ff00000 : 0x7f800000;

__device__ __forceinline__ bool nonfinite(double v) {
  return (__double2hiint(v) & 0x7ff00000) == 0x7ff00000;
}
__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ bool nonfinite(__nv_bfloat16 v) {
  return nonfinite(__bfloat162float(v));
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ __nv_bfloat16 quiet_nan<__nv_bfloat16>() {
  return __float2bfloat16(__int_as_float(0x7fc00000));
}

// The marks of the non-finite repair, in device memory, zero between
// calls (the repair launch zeroes what it reads): a 64-line mask, two
// words, per column strip of a pass.  A pass views X as (outer, m, inner);
// line c = o * inner + j is X[o, :, j] (inner = 1: row o of an (outer, m)
// X), and strip t holds the 64 lines of one block column's tile:
// lines 64 t .. for inner = 1, else lines o * inner + 64 u .. of strip
// t = o * ceil(inner / 64) + u.
struct NonFinite {
  unsigned int* ws;

  __device__ __forceinline__ void mark(int64_t strip, uint64_t lines) const {
    if (lines & 0xffffffffull)
      atomicOr(&ws[2 * strip], unsigned(lines));
    if (lines >> 32) atomicOr(&ws[2 * strip + 1], unsigned(lines >> 32));
  }
};

constexpr int kRepairThreads = 128;
constexpr int64_t kRepairBlocks = 132 * 8;

// Line c of the pass: its element at node k of the transformed axis.
__device__ __forceinline__ int64_t line_elem(int64_t c, int64_t k, int64_t m,
                                             int64_t inner) {
  return c / inner * m * inner + k * inner + c % inner;
}

template <typename TS, typename TD>
__global__ void __launch_bounds__(kRepairThreads) repair_nonfinite_kernel(
    unsigned int* ws, int64_t strips, const TS* __restrict__ x, TD* out,
    int64_t m, int64_t inner, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ slabs) {
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row_tiles = (m + kOpM - 1) / kOpM;
  const int64_t col_tiles = inner == 1 ? 1 : (inner + kOpN - 1) / kOpN;
  for (int64_t strip = blockIdx.x; strip < strips; strip += gridDim.x) {
    const uint64_t lines =
        uint64_t(ws[2 * strip]) | uint64_t(ws[2 * strip + 1]) << 32;
    if (!lines) continue;
    const int64_t first = inner == 1 ? strip * kOpN
                                     : strip / col_tiles * inner +
                                           strip % col_tiles * kOpN;
    for (int bit = warp; bit < 64; bit += kRepairThreads / 32) {
      if (!((lines >> bit) & 1u)) continue;
      const int64_t c = first + bit;
      unsigned int total = 0;
      for (int64_t k = lane; k < m; k += 32)
        total += nonfinite(x[line_elem(c, k, m, inner)]);
      total = __reduce_add_sync(full, total);
      for (int64_t r = 0; total && r < row_tiles; ++r) {
        const int64_t b = offsets[r], e = offsets[r + 1];
        unsigned int seen = 0;
        for (int64_t i = lane; i < (e - b) * kOpK; i += 32) {
          const int64_t k = int64_t(slabs[b + i / kOpK]) * kOpK + i % kOpK;
          if (k < m) seen += nonfinite(x[line_elem(c, k, m, inner)]);
        }
        seen = __reduce_add_sync(full, seen);
        if (seen == total) continue;     // every one inside r's slabs
        const int64_t end = (r + 1) * kOpM < m ? (r + 1) * kOpM : m;
        for (int64_t k = r * kOpM + lane; k < end; k += 32)
          out[line_elem(c, k, m, inner)] = quiet_nan<TD>();
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      ws[2 * strip] = 0;
      ws[2 * strip + 1] = 0;
    }
  }
}

// The repair launch after a tile launch over an (outer, m, inner) view,
// on the same stream; returns its launch error.
template <typename TS, typename TD>
inline int launch_repair(const NonFinite& nf, const TS* x, TD* out,
                         int64_t outer, int64_t m, int64_t inner,
                         const int32_t* offsets, const int32_t* slabs,
                         cudaStream_t stream) {
  const int64_t strips =
      inner == 1 ? (outer + kOpN - 1) / kOpN
                 : outer * ((inner + kOpN - 1) / kOpN);
  if (strips <= 0) return (int)cudaSuccess;
  const int64_t grid = strips < kRepairBlocks ? strips : kRepairBlocks;
  repair_nonfinite_kernel<TS, TD><<<(unsigned int)grid, kRepairThreads, 0,
                                    stream>>>(nf.ws, strips, x, out, m,
                                              inner, offsets, slabs);
  return (int)cudaGetLastError();
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

// a: the A operand's 64 x 16 slab, [row][k].  b: the B operand, [k][col]
// (16 x 64) for kSwap = false, [col][k] (64 x 16) for kSwap = true.
template <bool kSwap>
struct MmaSmem {
  double a[2][kOpM * kApitch];
  double b[2][kSwap ? kOpN * kApitch : kOpK * kBpitch];
};

// One output tile in f64 on DMMA.  `tile` is H's row tile, `other` the
// extent of X's other axis and `start` the tile's first index along it
// (see the header for the two roles).  Every thread of the 128-thread
// block calls it.
// Lines of the tile with a non-finite output are marked in `nf` under
// `strip` (see NonFinite).
template <bool kSwap>
__device__ void operator_slab_tile_f64(
    const double* __restrict__ tiles, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ slabs, const double* __restrict__ x,
    double* __restrict__ c, int64_t m, int64_t other, int64_t tile,
    int64_t start, MmaSmem<kSwap>& sm, const NonFinite& nf, int64_t strip) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gr = lane >> 2, q = lane & 3;
  const int begin = offsets[tile], end = offsets[tile + 1];

  auto load = [&](int slot, int t) {
    // H's packed tile, row-major (64 x 16): the A operand, or B as [col][k]
    double* hs = kSwap ? sm.b[slot] : sm.a[slot];
    const double* h = tiles + int64_t(t) * kOpM * kOpK;
#pragma unroll
    for (int u = 0; u < kOpM * kOpK / 2 / kMmaThreads; ++u) {
      const int e = tid + u * kMmaThreads;        // 16-byte chunk
      const int row = e / (kOpK / 2), col = (e % (kOpK / 2)) * 2;
      cp_async<16>(&hs[row * kApitch + col], h + row * kOpK + col, 16);
    }
    const int64_t k0 = int64_t(slabs[t]) * kOpK;
    if constexpr (kSwap) {   // X[start + i][k0 + kk], threads along k
#pragma unroll
      for (int u = 0; u < kOpN * kOpK / kMmaThreads; ++u) {
        const int e = tid + u * kMmaThreads;
        const int ii = e / kOpK, kk = e % kOpK;
        const int64_t gi = start + ii, gk = k0 + kk;
        const bool valid = gi < other && gk < m;
        cp_async<8>(&sm.a[slot][ii * kApitch + kk],
                    valid ? x + gi * m + gk : x, valid ? 8 : 0);
      }
    } else {                 // X[k0 + kk][start + jj], threads along j
#pragma unroll
      for (int u = 0; u < kOpK * kOpN / kMmaThreads; ++u) {
        const int e = tid + u * kMmaThreads;
        const int kk = e / kOpN, jj = e % kOpN;
        const int64_t gk = k0 + kk, gj = start + jj;
        const bool valid = gk < m && gj < other;
        cp_async<8>(&sm.b[slot][kk * kBpitch + jj],
                    valid ? x + gk * other + gj : x, valid ? 8 : 0);
      }
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
    cp_async_wait<1>();           // slab t's copies have landed
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
        bf[v] = kSwap ? sb[(wn + v * 8 + gr) * kApitch + kk + q]
                      : sb[(kk + q) * kBpitch + wn + v * 8 + gr];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          dmma_8x8x4(acc[u][v][0], acc[u][v][1], af[u], bf[v]);
    }
    __syncthreads();              // the slot is refilled next iteration
  }
  // C's tile origin, extents and row stride in either role
  const int64_t i0 = kSwap ? start : tile * kOpM;
  const int64_t j0 = kSwap ? tile * kOpM : start;
  const int64_t rows = kSwap ? other : m, cols = kSwap ? m : other;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t row = i0 + wm + u * 8 + gr;
    if (row >= rows) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int64_t col = j0 + wn + v * 8 + 2 * q;
      if (col < cols) c[row * cols + col] = acc[u][v][0];
      if (col + 1 < cols) c[row * cols + col + 1] = acc[u][v][1];
    }
  }
  // A non-finite x in the diagonal slabs reaches every output of its line
  // in this tile (each listed slab's product reaches every row), so one
  // output per line is checked: row 0 of each thread's columns, or column
  // 0 of its rows in kSwap.  An exponent maximum first, then the lines.
  int top = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    top = max(top, exponent_bits(kSwap ? acc[u][0][0] : acc[0][u][0]));
  if constexpr (!kSwap) {
#pragma unroll
    for (int v = 0; v < 4; ++v) top = max(top, exponent_bits(acc[0][v][1]));
  }
  if (top == kInfExponent<double>) {
    uint64_t bad = 0;   // the tile's lines (C's columns, or rows in kSwap)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kSwap && h) continue;
        const int line = kSwap ? wm + u * 8 + gr : wn + u * 8 + 2 * q + h;
        const double v = kSwap ? acc[u][0][0] : acc[0][u][h];
        if (start + line < other && nonfinite(v)) bad |= 1ull << line;
      }
    if (bad) nf.mark(strip, bad);
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

// a: the A operand's slab, b: the B operand's, both [k][index].
template <typename Acc>
struct CoreSmem {
  Acc a[kOpK][kOpM + 1];
  Acc b[kOpK][kOpN + 1];
};

// The same tile on the CUDA cores (f32, or bf16 summed in f32), reading X
// as TS and writing C as TD.  Every thread of the 256-thread block calls
// it.
template <typename TS, typename TD, typename Acc, bool kSwap>
__device__ void operator_slab_tile_core(
    const Acc* __restrict__ tiles, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ slabs, const TS* __restrict__ x,
    TD* __restrict__ c, int64_t m, int64_t other, int64_t tile,
    int64_t start, CoreSmem<Acc>& sm, const NonFinite& nf, int64_t strip) {
  const int tid = threadIdx.x;
  const int ri = tid / 16, ci = tid % 16;
  const int begin = offsets[tile], end = offsets[tile + 1];
  Acc acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = Acc(0);

  for (int t = begin; t < end; ++t) {
    const Acc* h = tiles + int64_t(t) * kOpM * kOpK;
    const int64_t k0 = int64_t(slabs[t]) * kOpK;
    Acc(*hs)[kOpM + 1] = kSwap ? sm.b : sm.a;
#pragma unroll
    for (int u = 0; u < kOpM * kOpK / kCoreThreads; ++u) {
      const int e = tid + u * kCoreThreads;
      {  // operator tile, row-major: consecutive threads along k
        const int kk = e % kOpK, ii = e / kOpK;
        hs[kk][ii] = h[e];
      }
      if constexpr (kSwap) {  // X[start + ii][k0 + kk], threads along k
        const int kk = e % kOpK, ii = e / kOpK;
        const int64_t gi = start + ii, gk = k0 + kk;
        sm.a[kk][ii] = (gi < other && gk < m)
                           ? widen_to<Acc>(x[gi * m + gk])
                           : Acc(0);
      } else {                // X[k0 + kk][start + jj], threads along j
        const int kk = e / kOpN, jj = e % kOpN;
        const int64_t gk = k0 + kk, gj = start + jj;
        sm.b[kk][jj] = (gk < m && gj < other)
                           ? widen_to<Acc>(x[gk * other + gj])
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
  const int64_t i0 = kSwap ? start : tile * kOpM;
  const int64_t j0 = kSwap ? tile * kOpM : start;
  const int64_t rows = kSwap ? other : m, cols = kSwap ? m : other;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int64_t gi = i0 + ri + 16 * u, gj = j0 + ci + 16 * v;
      if (gi < rows && gj < cols)
        c[gi * cols + gj] = narrow_to<TD>(acc[u][v]);
    }
  }
  // One output per line, as in the f64 tile: row 0 of each thread's
  // columns, or column 0 of its rows in kSwap.
  int top = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    top = max(top, exponent_bits(kSwap ? acc[u][0] : acc[0][u]));
  if (top == kInfExponent<Acc>) {
    uint64_t bad = 0;   // the tile's lines (C's columns, or rows in kSwap)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int line = kSwap ? ri + 16 * u : ci + 16 * u;
      if (start + line < other && nonfinite(kSwap ? acc[u][0] : acc[0][u]))
        bad |= 1ull << line;
    }
    if (bad) nf.mark(strip, bad);
  }
}
