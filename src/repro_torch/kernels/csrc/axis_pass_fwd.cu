// axis_pass_fwd: forward hierarchization passes over the members of one or
// more bucket stacks, every pass of a member in one block, every member of
// every stack in ONE launch.
//
// Replaces the forward bodies of two TPU kernels in
// repro/kernels/hierarchize.py:
//   * hier_tail_batched_pallas -> _batched_tail_fwd_kernel (axes 1..d-1);
//   * hier_axis0_batched_pallas -> _batched_axis0_fwd_kernel (axis 0).
// The TPU kernels keep a block of one member in VMEM while it passes over
// its tail axes.  Here a block keeps one whole member in shared memory
// while it passes over every axis it is given, in order, and the host
// lists every member of every stack of a CT ingest in one work table: the
// ingest's passes before each bucket's last (the last rides on the
// scatter, axis_pass_scatter_fwd.cu) are one launch, where one launch per
// axis per bucket made them 47 launches of about 2 us each at prod_3d.
//
// Work table (FwdItem, one per stack): the stack's element offsets in src
// and dst, its member size and count, and its passes: per pass the axis's
// view (n, inner) inside a member and the member-major predecessor arrays
// lp/rp (int32) and lm/rm (uint8) of the axis, each (G, n).  The host also
// lists the blocks, one per (item, member), heaviest member first.
//
// A block copies its member into shared memory with cp.async and applies
// the passes in order between two shared buffers, a barrier between
// passes: each pass reads its neighbours' values from before the pass, so
// an in-place buffer would change the bits.  The last pass writes device
// memory directly.  The same hier3 (rounded step by step, masked ancestors
// selected away) in the same order keeps every result bitwise the plain
// version's.  A member too large for two shared buffers (two times
// 116,224 bytes is a block's 227 KB; a 32767-long f64 column is 262 KB)
// walks its passes in device memory instead, in the same block, ping-
// ponging between dst and a scratch region (chosen so that the last pass
// lands in dst), the block's barrier ordering the passes.  A stack with no
// pass is copied.
//
// Bound: bytes, and at CT sizes launch latency.  A pass does 4 flops an
// element; the member is read once and written once whatever its passes.

#include "cp_async.cuh"
#include "hier3.cuh"

constexpr int kMaxPasses = 10;        // grids of up to 10 dimensions
constexpr int kFwdThreads = 256;
constexpr int64_t kMaxSmemBytes = 232448;   // 227 KB: one block's limit

struct FwdItem {
  int64_t src, dst;   // element offsets of the stack in src and dst
  int64_t scratch;    // element offset of its scratch region, or -1
  int64_t member;     // elements of one member
  int64_t g;          // members
  int64_t passes;
  int64_t n[kMaxPasses], inner[kMaxPasses];
  // device addresses of the pass axes' predecessor arrays, each (g, n)
  int64_t lp[kMaxPasses], rp[kMaxPasses], lm[kMaxPasses], rm[kMaxPasses];
};

// Pass p of member g of `it`: in -> out (in and out distinct).
template <typename T>
__device__ __forceinline__ void fwd_pass(const FwdItem& it, int p, int64_t g,
                                         const T* in, T* out) {
  const int64_t n = it.n[p], inner = it.inner[p], row = g * n;
  const int32_t* lp = reinterpret_cast<const int32_t*>(it.lp[p]) + row;
  const int32_t* rp = reinterpret_cast<const int32_t*>(it.rp[p]) + row;
  const uint8_t* lm = reinterpret_cast<const uint8_t*>(it.lm[p]) + row;
  const uint8_t* rm = reinterpret_cast<const uint8_t*>(it.rm[p]) + row;
  for (int64_t e = threadIdx.x; e < it.member; e += blockDim.x)
    out[e] = hier3<T>(in, e, (e / inner) % n, inner, lp, rp, lm, rm);
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    axis_pass_fwd_kernel(const FwdItem* __restrict__ items,
                         const int32_t* __restrict__ blocks,
                         const T* __restrict__ src, T* dst, T* scratch,
                         int64_t smem_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdItem& it = items[blocks[2 * blockIdx.x]];
  const int64_t g = blocks[2 * blockIdx.x + 1];
  const int64_t member = it.member;
  const int passes = int(it.passes);
  const T* x = src + it.src + g * member;
  T* y = dst + it.dst + g * member;
  if (passes == 0) {
    for (int64_t e = threadIdx.x; e < member; e += blockDim.x) y[e] = x[e];
    return;
  }
  if (member <= smem_elems) {
    T* buf[2] = {reinterpret_cast<T*>(smem),
                 reinterpret_cast<T*>(smem) + smem_elems};
    for (int64_t e = threadIdx.x; e < member; e += blockDim.x)
      cp_async<sizeof(T)>(buf[0] + e, x + e, sizeof(T));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int p = 0; p < passes; ++p) {
      fwd_pass<T>(it, p, g, buf[p & 1], p == passes - 1 ? y : buf[~p & 1]);
      __syncthreads();
    }
    return;
  }
  // Too large for shared memory: the passes walk device memory, ping-
  // ponging so that the last one writes y.
  T* sc = passes > 1 ? scratch + it.scratch + g * member : nullptr;
  const T* in = x;
  for (int p = 0; p < passes; ++p) {
    T* out = ((passes - 1 - p) & 1) ? sc : y;
    fwd_pass<T>(it, p, g, in, out);
    __syncthreads();
    in = out;
  }
}

template <typename T>
static int launch(const void* items, const void* blocks, int64_t nblocks,
                  const void* src, void* dst, void* scratch,
                  int64_t smem_elems, void* stream) {
  const int64_t smem = 2 * smem_elems * int64_t(sizeof(T));
  if (nblocks > INT32_MAX || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaGetLastError();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        axis_pass_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return (int)err;
  }
  axis_pass_fwd_kernel<T><<<(unsigned int)nblocks, kFwdThreads, size_t(smem),
                            (cudaStream_t)stream>>>(
      (const FwdItem*)items, (const int32_t*)blocks, (const T*)src, (T*)dst,
      (T*)scratch, smem_elems);
  return (int)cudaGetLastError();
}

extern "C" int axis_pass_fwd_f64(const void* items, const void* blocks,
                                 int64_t nblocks, const void* src, void* dst,
                                 void* scratch, int64_t smem_elems,
                                 void* stream) {
  return launch<double>(items, blocks, nblocks, src, dst, scratch, smem_elems,
                        stream);
}

extern "C" int axis_pass_fwd_f32(const void* items, const void* blocks,
                                 int64_t nblocks, const void* src, void* dst,
                                 void* scratch, int64_t smem_elems,
                                 void* stream) {
  return launch<float>(items, blocks, nblocks, src, dst, scratch, smem_elems,
                       stream);
}
