// pole_fwd: hierarchization along axis 0 of an (n, b) pole bundle, the
// paper's fine-to-coarse level loop, one thread per pole.
//
// Replaces hier_pole_pallas -> _pole_kernel (repro/kernels/hierarchize.py:
// :176, :152).  The TPU kernel stages a (pole length x 128 lanes) block in
// VMEM and runs the unrolled level loop on it; here each thread owns one
// column of the row-major (n, b) bundle, so the 32 threads of a warp touch
// 32 neighbouring columns of one row on every access (coalesced), and the
// loop runs at the true extents (no sublane or lane padding).
//
// A level updates only its odd nodes and reads only even nodes, which no
// finer level writes: every value the loop reads is still the input's.
// The kernel therefore reads the input bundle and writes a separate
// output, and copies the root, the one node no level writes.
//
// Rounding: every sum, difference and product is rounded on its own
// (mul_rn/add_rn/sub_rn, so no FMA), in the reference's order:
//   reduced_op:   odd - 0.5 * (l + r)
//   otherwise:    odd - 0.5 * l - 0.5 * r
// with an absent (boundary) neighbour entering as +0.0, as the reference's
// zero-padded concatenation does.  The results are bitwise the reference's.
//
// Bound: bytes (a handful of flops per element).  Each element is read up
// to three times (as a node and as the neighbour of two finer nodes) and
// written once; the neighbour reads hit the caches only while a warp's
// rows stay resident.  A bundle with few columns (b = 1 for a 1-D grid)
// runs on few threads: that case is left slow on purpose.

#include "hier3.cuh"

template <typename T, bool kReduced>
__global__ void pole_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int64_t n, int64_t b, int level) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= b) return;
  const T half = T(0.5);
  for (int lam = level; lam >= 2; --lam) {
    const int64_t s = int64_t(1) << (level - lam);
    for (int64_t i = s - 1; i < n; i += 2 * s) {
      const T l = i >= s ? x[(i - s) * b + col] : T(0);
      const T r = i + s < n ? x[(i + s) * b + col] : T(0);
      const T odd = x[i * b + col];
      out[i * b + col] =
          kReduced ? sub_rn(odd, mul_rn(half, add_rn(l, r)))
                   : sub_rn(sub_rn(odd, mul_rn(half, l)), mul_rn(half, r));
    }
  }
  const int64_t root = (int64_t(1) << (level - 1)) - 1;
  out[root * b + col] = x[root * b + col];
}

template <typename T>
static int launch(const void* x, void* out, int64_t n, int64_t b,
                  int64_t level, int64_t reduced, void* stream) {
  if (b > 0) {
    const unsigned int blocks = (unsigned int)((b + kThreads - 1) / kThreads);
    if (reduced) {
      pole_fwd_kernel<T, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)x, (T*)out, n, b, (int)level);
    } else {
      pole_fwd_kernel<T, false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)x, (T*)out, n, b, (int)level);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int pole_fwd_f64(const void* x, void* out, int64_t n, int64_t b,
                            int64_t level, int64_t reduced, void* stream) {
  return launch<double>(x, out, n, b, level, reduced, stream);
}

extern "C" int pole_fwd_f32(const void* x, void* out, int64_t n, int64_t b,
                            int64_t level, int64_t reduced, void* stream) {
  return launch<float>(x, out, n, b, level, reduced, stream);
}
