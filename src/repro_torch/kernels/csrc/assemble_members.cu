// assemble_members: every member grid of a CT ingest, permuted to its
// bucket's canonical axis order and zero-padded to the bucket shape, written
// into its slot of the flat concatenation of the bucket stacks.
//
// Replaces no TPU kernel: the reference assembles the stacks inside its
// jitted ingest executable (repro/core/executor.py: _assemble_members, a
// transpose and a pad per member that XLA fuses).  Eager torch did it with
// a zero fill per stack and a strided copy per member, about 110 device ops
// at prod_3d (109 members), each launched from Python.
//
// Bound: bytes.  Each member element is read once and each slot element
// written once; at prod_3d 73,915 values, 0.59 MB in f64, so the launch
// and one round of dependent loads are the whole time.  The design keeps
// that to one launch with no host-to-device copy and little index math:
//
// * What the plan fixes is a device table built once per plan signature
//   and device (kernels/hierarchize.py: _assembly_table): one AsmDesc a
//   member, with the copy from member to slot collapsed into its fewest
//   axes (extent-1 axes dropped; neighbouring axes merged where both the
//   member, at its default contiguous strides, and the slot are contiguous
//   across them: most prod_3d members become one contiguous run), and a
//   block map of (member, first element) pairs, every block inside one
//   member, the heaviest first.  Each axis carries the multiply-shift
//   constants of a 32-bit division by its slot extent.
// * Per call only the member addresses cross to the card, as the kernel's
//   parameter (AsmCall, __grid_constant__, under 4 KB), filled here from a
//   host array.  A member whose strides are not its default ones is read in
//   place through its uncollapsed axes (AsmDesc::full); its strides ride in
//   the same parameter block.  A plan with more members than one block holds
//   is split into several launches of this kernel: the table's groups of
//   at most 400 members, each launched again on its block map for a further
//   run of its members where their strides overflow the block.
// * A block walks its elements with consecutive elements on consecutive
//   lanes (the innermost collapsed axis across lanes: coalesced writes,
//   and coalesced reads wherever the member's inner stride is 1), splits
//   each slot index by fast divmod, writes 16-byte vectors where they lie
//   aligned inside its range, and writes the pad zeros itself, so dst needs
//   no fill.  Index math is 32-bit for slots and members under 2^31
//   elements; kWide, compiled apart, is the 64-bit instantiation for larger
//   ones.  A copy, so bitwise the plain version.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

constexpr int kMaxDims = 10;          // grids of up to 10 dimensions
constexpr int kAsmThreads = 256;
constexpr int kCallWords = 500;       // AsmCall: 4040 bytes in all

struct AsmAxis {
  int64_t slot;       // slot extent along the axis
  int64_t member;     // member extent (<= slot)
  int64_t stride;     // member element stride at its default strides
  uint32_t mul;       // q = (n * mul) >> shift is n / slot for n < 2^31
  uint32_t shift;
};

struct AsmDesc {
  int64_t offset;            // element offset of the slot in dst
  int64_t size;              // slot elements
  int32_t ndim;              // collapsed axes (the default strides)
  int32_t nfull;             // every axis of slot extent > 1
  AsmAxis axis[kMaxDims];    // collapsed, outermost first
  AsmAxis full[kMaxDims];    // uncollapsed; strides come from the call
};

struct AsmBlock {
  int64_t member;     // global member index
  int64_t start;      // first slot element of the block
};

// The kernel's parameter.  word[0 .. count) are the members' addresses;
// then count uint16 (packed four a word), each 0 for a member read at its
// default strides, else the word index of its strides further on.
struct AsmCall {
  int64_t dst;        // device address of the flat stacks
  int64_t desc;       // device address of the AsmDesc table
  int64_t blocks;     // device address of this launch's block map
  int64_t chunk;      // slot elements a block walks
  int32_t first;      // global index of the launch's first member
  int32_t count;      // members of the launch
  int64_t word[kCallWords];
};

__device__ __forceinline__ uint32_t fast_div(uint32_t n, uint32_t mul,
                                             uint32_t shift) {
  return uint32_t((uint64_t(n) * mul) >> shift);
}

// The 16-byte store of V = 16 / sizeof(T) values.
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The source element at slot element e, or 0 in the padding.  I is uint32_t
// (fast divmod) or int64_t (kWide).
template <typename T, typename I>
__device__ __forceinline__ T element(const T* __restrict__ src, I e, int nd,
                                     const int64_t* s_slot,
                                     const int64_t* s_member,
                                     const int64_t* s_stride,
                                     const uint32_t* s_mul,
                                     const uint32_t* s_shift) {
  I off = 0;
  bool inside = true;
  for (int k = nd - 1; k > 0; --k) {
    I q;
    if constexpr (sizeof(I) == 4) q = fast_div(e, s_mul[k], s_shift[k]);
    else q = e / I(s_slot[k]);
    const I i = e - q * I(s_slot[k]);
    inside = inside && i < I(s_member[k]);
    off += i * I(s_stride[k]);
    e = q;
  }
  inside = inside && e < I(s_member[0]);
  off += e * I(s_stride[0]);
  return inside ? src[off] : T(0);
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kAsmThreads)
    assemble_members_kernel(__grid_constant__ const AsmCall call) {
  using I = typename std::conditional<kWide, int64_t, uint32_t>::type;
  constexpr int V = 16 / sizeof(T);
  __shared__ int64_t s_slot[kMaxDims], s_member[kMaxDims], s_stride[kMaxDims];
  __shared__ uint32_t s_mul[kMaxDims], s_shift[kMaxDims];

  const AsmBlock b = reinterpret_cast<const AsmBlock*>(call.blocks)[blockIdx.x];
  const AsmDesc* d = reinterpret_cast<const AsmDesc*>(call.desc) + b.member;
  const int local = int(b.member) - call.first;
  if (local < 0 || local >= call.count) return;   // another launch's member
  const T* src = reinterpret_cast<const T*>(call.word[local]);
  const int rec = reinterpret_cast<const uint16_t*>(call.word + call.count)[local];
  const int nd = rec ? d->nfull : d->ndim;
  if (threadIdx.x < nd) {
    const AsmAxis& a = rec ? d->full[threadIdx.x] : d->axis[threadIdx.x];
    s_slot[threadIdx.x] = a.slot;
    s_member[threadIdx.x] = a.member;
    s_stride[threadIdx.x] = rec ? call.word[rec + threadIdx.x] : a.stride;
    s_mul[threadIdx.x] = a.mul;
    s_shift[threadIdx.x] = a.shift;
  }
  __syncthreads();

  const int64_t base = d->offset;
  const int64_t lo = b.start;
  const int64_t hi = lo + call.chunk < d->size ? lo + call.chunk : d->size;
  T* out = reinterpret_cast<T*>(call.dst);
  // groups of V elements aligned in dst, the block's range [lo, hi) cut
  // out of the first and the last
  const int64_t g_end = (base + hi + V - 1) / V;
  for (int64_t g = (base + lo) / V + threadIdx.x; g < g_end; g += blockDim.x) {
    const int64_t q0 = g * V - base;      // slot element of the group's first
    T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int64_t e = q0 + j;
      v[j] = e >= lo && e < hi
                 ? element<T, I>(src, I(e), nd, s_slot, s_member, s_stride,
                                 s_mul, s_shift)
                 : T(0);
    }
    if (q0 >= lo && q0 + V <= hi) {
      store16(out + g * V, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (q0 + j >= lo && q0 + j < hi) out[g * V + j] = v[j];
    }
  }
}

// The words a launch's parameter needs for `count` members, `strides` of
// them the strides of members read through their uncollapsed axes.
static int64_t call_words(int64_t count, int64_t strides) {
  return count + (count + 3) / 4 + strides;
}

// groups: 4 int64 a group of the table (first member, members, first block,
// blocks).  src: every member's address.  over: for each member read
// through its uncollapsed axes, in member order, (member, n, its n
// strides).  A group whose members' strides do not all fit one parameter
// block is launched more than once on its block map, each launch for a run
// of its members (the other members' blocks exit at once).  wide: the
// 64-bit instantiation.  Returns the launches made through `launches`.
template <typename T>
static int launch(const int64_t* groups, int64_t ngroups, const int64_t* src,
                  const int64_t* over, int64_t nover, const void* desc,
                  const void* blocks, int64_t chunk, void* dst, int64_t wide,
                  int64_t* launches, void* stream) {
  *launches = 0;
  if (ngroups < 0 || nover < 0 || chunk < 1 ||
      reinterpret_cast<uintptr_t>(dst) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  AsmCall call;
  int64_t r = 0;                             // cursor in over
  for (int64_t l = 0; l < ngroups; ++l) {
    const int64_t first = groups[4 * l], members = groups[4 * l + 1];
    const int64_t block0 = groups[4 * l + 2], nblocks = groups[4 * l + 3];
    if (members < 1 || call_words(members, 0) > kCallWords ||
        first + members > INT32_MAX || nblocks < 1 || nblocks > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    for (int64_t m0 = first; m0 < first + members;) {
      // the longest run of members from m0 whose strides fit
      int64_t m1 = m0, strides = 0, q = r;
      while (m1 < first + members) {
        const bool own = q < nover && over[q] == m1;
        const int64_t n = own ? over[q + 1] : 0;
        if (own && (n < 1 || n > kMaxDims || q + 2 + n > nover))
          return (int)cudaErrorInvalidValue;
        if (call_words(m1 + 1 - m0, strides + n) > kCallWords) break;
        strides += n;
        q += own ? 2 + n : 0;
        ++m1;
      }
      if (m1 == m0) return (int)cudaErrorInvalidValue;
      const int64_t count = m1 - m0;
      memset(&call, 0, sizeof(call));
      call.dst = reinterpret_cast<int64_t>(dst);
      call.desc = reinterpret_cast<int64_t>(desc);
      call.blocks = reinterpret_cast<int64_t>(blocks) +
                    block0 * int64_t(sizeof(AsmBlock));
      call.chunk = chunk;
      call.first = int32_t(m0);
      call.count = int32_t(count);
      memcpy(call.word, src + m0, count * sizeof(int64_t));
      uint16_t* rec = reinterpret_cast<uint16_t*>(call.word + count);
      int64_t w = call_words(count, 0);
      for (; r < q; r += 2 + over[r + 1]) {
        rec[over[r] - m0] = uint16_t(w);
        memcpy(call.word + w, over + r + 2, over[r + 1] * sizeof(int64_t));
        w += over[r + 1];
      }
      cudaStream_t st = (cudaStream_t)stream;
      if (wide)
        assemble_members_kernel<T, true><<<(unsigned int)nblocks,
                                           kAsmThreads, 0, st>>>(call);
      else
        assemble_members_kernel<T, false><<<(unsigned int)nblocks,
                                            kAsmThreads, 0, st>>>(call);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      ++*launches;
      m0 = m1;
    }
  }
  return r == nover ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

#define ASM_ENTRY(tag, T)                                                    \
  extern "C" int assemble_members_##tag(                                     \
      const int64_t* groups, int64_t ngroups, const int64_t* src,            \
      const int64_t* over, int64_t nover, const void* desc,                  \
      const void* blocks, int64_t chunk, void* dst, int64_t wide,            \
      int64_t* launches, void* stream) {                                     \
    return launch<T>(groups, ngroups, src, over, nover, desc, blocks, chunk, \
                     dst, wide, launches, stream);                           \
  }

ASM_ENTRY(f64, double)
ASM_ENTRY(f32, float)
