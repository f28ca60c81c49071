// pole_fwd: hierarchization along one axis of a contiguous grid, viewed as
// (outer, n, inner), n = 2**level - 1: the paper's fine-to-coarse level
// loop, one HBM round trip for each element.
//
// Replaces hier_pole_pallas -> _pole_kernel (repro/kernels/hierarchize.py:
// :176, :152).  The TPU kernel stages a (pole length x 128 lanes) block in
// VMEM and runs the unrolled level loop on it.  The (N, B) bundle it takes
// is the view with outer = 1; every other axis of a grid is passed in
// place, without moving it to the front.
//
// A level updates only its odd nodes and reads only even nodes, which no
// finer level writes: every value the loop reads is still the input's.  So
// the transform is a stencil, out[p] = f(x[p - s], x[p], x[p + s]) with s
// = p & -p (1-based positions), and nothing orders one node after another.
// A block stages a tile of the view in shared memory (pole_tile.cuh: whole
// poles, or a span of P rows of 1 KB runs), then computes every node of
// it from shared memory and writes it out coalesced.  A split span's nodes
// read one more value, the span's left end (the previous span's last row),
// loaded beside the tile; its last row, a coarse node, reads its two
// parents from device memory (L2).  So each element is read about once and
// written once, and a pole of one column is spread over many blocks.
//
// Rounding: every sum, difference and product is rounded on its own
// (mul_rn/add_rn/sub_rn, so no FMA), in the reference's order:
//   reduced_op:   odd - 0.5 * (l + r)
//   otherwise:    odd - 0.5 * l - 0.5 * r
// with an absent (boundary) neighbour entering as +0.0, as the reference's
// zero-padded concatenation does; the root is copied.  The results are
// bitwise the reference's.
//
// Bound: bytes (a handful of flops per element): the grid read once and
// written once.

#include "pole_tile.cuh"

template <typename T, bool kReduced, bool kSwizzled>
__global__ void __launch_bounds__(kPoleFwdThreads)
    pole_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const PoleGrid g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  int64_t r0;
  const Tile t = pole_tile(g, &r0);
  T* lo = tile + g.slots;
  load_tile<T, kSwizzled>(tile, x, t);
  if (r0 > 0) {                 // a split span (no == 1): its left end
    for (int j = threadIdx.x; j < t.nj; j += blockDim.x)
      lo[j] = j < t.nj_eff ? x[t.base - t.inner + j] : T(0);
  }
  copy_async_wait();
  __syncthreads();

  const T half = T(0.5);
  const int64_t root = int64_t(1) << (g.level - 1);
  const bool pow2 = (t.nj & (t.nj - 1)) == 0;
  const int shift = __ffs(t.nj) - 1;
  const int span = t.rows * t.nj;
  for (int o = 0; o < t.no_eff; ++o) {
    for (int e = threadIdx.x; e < span; e += blockDim.x) {
      const int i = pow2 ? e >> shift : e / t.nj, j = e - i * t.nj;
      if (i >= t.rows_eff || j >= t.nj_eff) continue;
      const int at = o * span + e;
      const int64_t gat = t.base + (int64_t(o) * t.n + i) * t.inner + j;
      const T v = tile[slot<T, kSwizzled>(at)];
      const int64_t p = r0 + i + 1, q = i + 1;
      if (p == root) {
        out[gat] = v;
        continue;
      }
      const int64_t s = p & -p;
      T l, r;
      if (q > s) l = tile[slot<T, kSwizzled>(at - int(s) * t.nj)];
      else if (p == s) l = T(0);          // the pole's left boundary
      else if (q == s) l = lo[j];
      else l = x[gat - s * t.inner];      // a coarse node's parent
      if (q + s <= t.rows_eff)
        r = tile[slot<T, kSwizzled>(at + int(s) * t.nj)];
      else if (p + s <= t.n)
        r = x[gat + s * t.inner];
      else
        r = T(0);                         // the pole's right boundary
      out[gat] = kReduced
                     ? sub_rn(v, mul_rn(half, add_rn(l, r)))
                     : sub_rn(sub_rn(v, mul_rn(half, l)), mul_rn(half, r));
    }
  }
}

template <typename T, bool kReduced, bool kSwizzled>
static int launch_grid(const T* x, T* out, const PoleGrid& g,
                       void* stream) {
  auto kernel = pole_fwd_kernel<T, kReduced, kSwizzled>;
  if (g.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned int)g.blocks, g.threads, (size_t)g.bytes,
           (cudaStream_t)stream>>>(x, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, void* out, int64_t outer, int64_t n,
                  int64_t inner, int64_t level, int64_t reduced,
                  void* stream) {
  if (level < 2 || level > 30 || n != (int64_t(1) << level) - 1)
    return (int)cudaErrorInvalidValue;
  if (outer <= 0 || inner <= 0) return (int)cudaGetLastError();
  const PoleGrid g =
      pole_grid(outer, n, inner, (int)level, sizeof(T), kPoleFwdThreads);
  const T* src = (const T*)x;
  T* dst = (T*)out;
  if (g.swizzled)
    return reduced ? launch_grid<T, true, true>(src, dst, g, stream)
                   : launch_grid<T, false, true>(src, dst, g, stream);
  return reduced ? launch_grid<T, true, false>(src, dst, g, stream)
                 : launch_grid<T, false, false>(src, dst, g, stream);
}

extern "C" int pole_fwd_f64(const void* x, void* out, int64_t outer,
                            int64_t n, int64_t inner, int64_t level,
                            int64_t reduced, void* stream) {
  return launch<double>(x, out, outer, n, inner, level, reduced, stream);
}

extern "C" int pole_fwd_f32(const void* x, void* out, int64_t outer,
                            int64_t n, int64_t inner, int64_t level,
                            int64_t reduced, void* stream) {
  return launch<float>(x, out, outer, n, inner, level, reduced, stream);
}
