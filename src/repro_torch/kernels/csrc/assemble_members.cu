// assemble_members: every member grid of a CT ingest, permuted to its
// bucket's canonical axis order and zero-padded to the bucket shape, written
// into its slot of the flat concatenation of the bucket stacks, in ONE
// launch.
//
// Replaces no TPU kernel: the reference assembles the stacks inside its
// jitted ingest executable (repro/core/executor.py: _assemble_members, a
// transpose and a pad per member that XLA fuses).  Eager torch did it with
// a zero fill per stack and a strided copy per member, about 110 device ops
// at prod_3d (109 members), each launched from Python.
//
// Work table (AsmMember, one per member, built on the host at each ingest
// and copied to the device from pinned memory): the member's device
// address, its slot's element offset in dst and volume, the bucket shape
// (the slot's extents), and the member's extents and element strides with
// its axes permuted to canonical order.  Strides are the source tensor's
// own, so a non-contiguous or permuted view is read in place.
//
// Block (m, c) takes member m, chunk c of its slot: each thread walks slot
// elements e with a stride of the chunks' threads, splits e into the
// canonical multi-index over the bucket shape and writes the source element
// at that index, or 0 where the index lies past the member's extents.  The
// padding is written here, so dst needs no fill.  A copy, so bitwise.
//
// Bound: bytes.  Each member element is read once and each slot element
// written once (at prod_3d 73,915 values of 0.59 MB in f64: launch
// latency).

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxDims = 10;          // grids of up to 10 dimensions
constexpr int kAsmThreads = 256;

struct AsmMember {
  int64_t src;                  // device address of the member grid
  int64_t dst;                  // element offset of its slot in dst
  int64_t size;                 // elements of the slot
  int64_t ndim;
  int64_t shape[kMaxDims];      // bucket shape: the slot's extents
  int64_t ext[kMaxDims];        // member extents, canonical order
  int64_t stride[kMaxDims];     // member element strides, canonical order
};

template <typename T>
__global__ void __launch_bounds__(kAsmThreads)
    assemble_members_kernel(const AsmMember* __restrict__ members,
                            T* __restrict__ dst) {
  const AsmMember& m = members[blockIdx.x];
  const T* src = reinterpret_cast<const T*>(m.src);
  T* out = dst + m.dst;
  const int ndim = int(m.ndim);
  const int64_t step = int64_t(gridDim.y) * blockDim.x;
  for (int64_t e = int64_t(blockIdx.y) * blockDim.x + threadIdx.x;
       e < m.size; e += step) {
    int64_t rem = e, off = 0;
    bool inside = true;
    for (int k = ndim - 1; k >= 0; --k) {
      const int64_t i = rem % m.shape[k];
      rem /= m.shape[k];
      inside = inside && i < m.ext[k];
      off += i * m.stride[k];
    }
    out[e] = inside ? src[off] : T(0);
  }
}

template <typename T>
static int launch(const void* members, int64_t count, int64_t chunks,
                  void* dst, void* stream) {
  if (count > INT32_MAX || chunks < 1 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  if (count > 0) {
    const dim3 grid((unsigned int)count, (unsigned int)chunks);
    assemble_members_kernel<T><<<grid, kAsmThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const AsmMember*)members, (T*)dst);
  }
  return (int)cudaGetLastError();
}

extern "C" int assemble_members_f64(const void* members, int64_t count,
                                    int64_t chunks, void* dst, void* stream) {
  return launch<double>(members, count, chunks, dst, stream);
}

extern "C" int assemble_members_f32(const void* members, int64_t count,
                                    int64_t chunks, void* dst, void* stream) {
  return launch<float>(members, count, chunks, dst, stream);
}
