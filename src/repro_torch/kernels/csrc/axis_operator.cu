// axis_operator: (de)hierarchization along axis 0 of an (n, b) bundle as
// one operator product, out = H . x (forward) or H^-1 . x (inverse).
//
// Replaces apply_axis_matmul_pallas -> _matmul_kernel
// (repro/kernels/hierarchize.py:259, :254), which the TPU runs on its
// matrix unit.  Here one block computes one 64 x 64 output tile
// (operator_slab_tile.cuh) and walks only the 16-deep k-slabs where its 64
// rows of the operator are nonzero: H has at most 3 nonzeros a row and
// H^-1 at most `level`, so at n = 511 a row tile walks 5.5 (H) or 6.1
// (H^-1) of the 32 slabs.  The wrapper builds the slab list and the packed
// nonzero tiles on the host, once per (level, inverse, dtype, device),
// from the port's ref.operator_matrix / ref.dehier_operator_matrix, in the
// accumulator's type: f64 for f64 input (summed on the f64 tensor cores,
// DMMA), f32 for f32 and for bf16 input (CUDA cores; bf16 widened on load,
// summed in f32 and written back as bf16).  A NaN or Inf in x reaches
// what the dense product's would: the tile blocks mark the columns that
// hold one and a repair launch on the same stream gives them the dense
// product's pattern (see the header).
//
// Bound: bytes.  The function reads x once and writes out once; the listed
// slabs do about 17-19% of the dense product's flops at n = 511, about
// 0.35-0.39 ms of DMMA at 67 TFLOP/s on a 511^3 grid beside its 0.637 ms of
// bytes.  The row tile is the fastest-varying block index, so the row tiles
// of one column strip run together and share its slabs of x through L2.

#include "operator_slab_tile.cuh"

__global__ void __launch_bounds__(kMmaThreads)
    axis_operator_f64_kernel(const double* __restrict__ tiles,
                             const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ slabs,
                             const double* __restrict__ x,
                             double* __restrict__ out, int64_t n, int64_t b,
                             int64_t row_tiles, NonFinite nf) {
  __shared__ __align__(16) MmaSmem<false> sm;
  const int64_t r = int64_t(blockIdx.x) % row_tiles;
  const int64_t j0 = int64_t(blockIdx.x) / row_tiles * kOpN;
  operator_slab_tile_f64<false>(tiles, offsets, slabs, x, out, n, b, r, j0,
                                sm, nf, int64_t(blockIdx.x) / row_tiles);
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kCoreThreads)
    axis_operator_kernel(const Acc* __restrict__ tiles,
                         const int32_t* __restrict__ offsets,
                         const int32_t* __restrict__ slabs,
                         const T* __restrict__ x, T* __restrict__ out,
                         int64_t n, int64_t b, int64_t row_tiles,
                         NonFinite nf) {
  __shared__ CoreSmem<Acc> sm;
  const int64_t r = int64_t(blockIdx.x) % row_tiles;
  const int64_t j0 = int64_t(blockIdx.x) / row_tiles * kOpN;
  operator_slab_tile_core<T, T, Acc, false>(tiles, offsets, slabs, x, out, n,
                                            b, r, j0, sm, nf,
                                            int64_t(blockIdx.x) / row_tiles);
}

static int64_t blocks_of(int64_t n, int64_t b, int64_t* row_tiles) {
  *row_tiles = (n + kOpM - 1) / kOpM;
  return *row_tiles * ((b + kOpN - 1) / kOpN);
}

extern "C" int axis_operator_f64(const void* tiles, const void* offsets,
                                 const void* slabs, const void* x, void* out,
                                 void* ws, int64_t n, int64_t b,
                                 int64_t tile_m, int64_t tile_k,
                                 void* stream) {
  if (!tile_is_ours(tile_m, tile_k)) return (int)cudaErrorInvalidValue;
  if (n > 0 && b > 0) {
    int64_t row_tiles;
    const int64_t blocks = blocks_of(n, b, &row_tiles);
    axis_operator_f64_kernel<<<(unsigned int)blocks, kMmaThreads, 0,
                               (cudaStream_t)stream>>>(
        (const double*)tiles, (const int32_t*)offsets,
        (const int32_t*)slabs, (const double*)x, (double*)out, n, b,
        row_tiles, NonFinite{(unsigned int*)ws});
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    return launch_repair(NonFinite{(unsigned int*)ws}, (const double*)x,
                         (double*)out, 1, n, b, (const int32_t*)offsets,
                         (const int32_t*)slabs, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_core(const void* tiles, const void* offsets,
                       const void* slabs, const void* x, void* out, void* ws,
                       int64_t n, int64_t b, int64_t tile_m, int64_t tile_k,
                       void* stream) {
  if (!tile_is_ours(tile_m, tile_k)) return (int)cudaErrorInvalidValue;
  if (n > 0 && b > 0) {
    int64_t row_tiles;
    const int64_t blocks = blocks_of(n, b, &row_tiles);
    axis_operator_kernel<T, float><<<(unsigned int)blocks, kCoreThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const float*)tiles, (const int32_t*)offsets, (const int32_t*)slabs,
        (const T*)x, (T*)out, n, b, row_tiles, NonFinite{(unsigned int*)ws});
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    return launch_repair(NonFinite{(unsigned int*)ws}, (const T*)x, (T*)out,
                         1, n, b, (const int32_t*)offsets,
                         (const int32_t*)slabs, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int axis_operator_f32(const void* tiles, const void* offsets,
                                 const void* slabs, const void* x, void* out,
                                 void* ws, int64_t n, int64_t b,
                                 int64_t tile_m, int64_t tile_k,
                                 void* stream) {
  return launch_core<float>(tiles, offsets, slabs, x, out, ws, n, b, tile_m,
                            tile_k, stream);
}

extern "C" int axis_operator_bf16(const void* tiles, const void* offsets,
                                  const void* slabs, const void* x, void* out,
                                  void* ws, int64_t n, int64_t b,
                                  int64_t tile_m, int64_t tile_k,
                                  void* stream) {
  return launch_core<__nv_bfloat16>(tiles, offsets, slabs, x, out, ws, n, b,
                                    tile_m, tile_k, stream);
}
