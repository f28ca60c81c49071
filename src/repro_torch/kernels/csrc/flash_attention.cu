// flash_attention: forward attention, causal or full, with an online
// softmax and grouped-query heads, o = softmax(q k^T * hd^-0.5) v.
//
// Replaces flash_attention_bhsd -> _kernel
// (repro/kernels/flash_attention.py:79, its pallas_call at :108 and its
// kernel body at :38).  The function is the TPU kernel's: f32 scores of q
// against k scaled by hd^-0.5, filled with -1e30 where a key lies past the
// keys' length or, with `causal`, past the query's position (q_pos +
// q_offset < k_pos, absolute indices), (m, l, acc) kept in f32 across the
// whole key sweep and the result acc / max(l, 1e-30) rounded to the
// output's type.  The TPU's grid walks the key blocks in order with the
// state in VMEM scratch; here one block owns a query tile of one (batch,
// head) and walks the key tiles in a loop, the state in registers.  The
// TPU wrapper copies each KV head to its query heads (jnp.repeat); these
// kernels read query head h's KV head h / (H / KV) in place, and take q, k
// and v through their strides in the model's (B, S, heads, hd) layout.
// Key tiles wholly past a causal tile's last query are skipped, and the
// tiles with the most keys are scheduled first.  head_dim is at most 128:
// each kernel is built for 64 or 128 channels and the channels past hd are
// zero.
//
// Which type runs where: the entry point by type is the dispatch.
// * flash_attention_bf16 (flash_kernel_wgmma) runs both products on the
//   warpgroup products (wgmma.mma_async, bf16 in, f32 sums; wgmma_tma.cuh),
//   the FlashAttention-3 structure.  The grid is persistent, a block an SM,
//   each block walking its share of the (batch, head, query tile) items,
//   the tiles with the most keys first, in rounds that go back and forth
//   over the blocks so that the shares even out.  A block is a producer
//   warpgroup and C consumer warpgroups of 64 query rows each: C = 2 (128
//   rows, 384 threads at 168 registers on entry, the consumers up to 240)
//   or, at head_dim 64, C = 3 (192 rows, 512 threads at 128, up to 160)
//   where the rows left idle past Sq and the last round's empty SMs cost
//   less than the third warpgroup gains (consumers_hd64).  The producer
//   gives back its registers (setmaxnreg, down to 24) and one of its
//   threads brings in each item's Q tile, as soon as the last one's scores
//   are taken, and its K and V tiles of 128 keys into two rings of two
//   slots that run on across items (full and empty mbarriers, K and V
//   apart, so that a K slot is refilled as soon as its scores are taken),
//   all by TMA from tensor maps built on the operands' own strides: tiles
//   land 128-byte swizzled, zero past the rows' end and past hd.  So the
//   next item's loads overlap this one's last products and epilogue.
//   S = Q K^T reads both operands from shared memory (m64n128k16, K-major).
//   The online softmax runs in registers on the accumulator's layout (per
//   warp the m16n8k16 C layout: a row's values over the 4 lanes that share
//   it) in base 2: m = max(m, max(s) * hd^-0.5 * log2(e)) from the raw
//   scores' row maxima, P = 2^(s * hd^-0.5 * log2(e) - m) in one fused
//   multiply-add and ex2.approx (about 2 ulp); the mask (keys past skv, or
//   with `causal` past the row's position) is applied only on the tiles it
//   cuts.  P is rounded to bf16 in registers as the A operand of O += P V
//   (m64n64k16 or m64n128k16 from registers, V read MN-major); l sums the
//   f32 probabilities.  The consumers take turns on the tensor cores, round
//   robin on named barriers: a turn issues one warpgroup's S of its next
//   tile and then its P V of the last, each its own wgmma group, and hands
//   the turn on; the warpgroup waits for S alone and runs its softmax
//   while its P V and the next warpgroups' products run, then waits for
//   the P V before it rescales O and writes P.  No register of a product
//   in flight is touched until its group has landed (ptxas reports no
//   serialized wgmma, C7515).  At head_dim 64 the softmax's 2^x, on the
//   special-function units, takes longer than the products of its scores:
//   the overlap is what the turns are for.  Tiles: 128 keys, the widest S
//   tile (64 registers a thread) that leaves room for O (32 or 64) and P
//   (32); two slots each; with an output tile a consumer (two with the
//   log-sum-exp, the residual's beside it), 192 KB of shared memory at
//   head_dim 128, 225 KB with the lse.  Rounding P to bf16 is a deviation
//   from the reference, which multiplies f32 probabilities: it stays
//   inside the reference's bf16 bar (2e-2).  The epilogue multiplies O by
//   each row's 1 / max(l, 1e-30) (one division a row, not one a value: an
//   item's epilogue is paid once on its SM, and items are short), stages
//   the bf16 output swizzled and stores it in 16-byte runs.  TMA needs
//   16-byte aligned bases and strides, so the wrapper
//   (kernels/flash_attention.py, _tma_rows) passes such operands as they
//   are and copies any other into an aligned tensor, its channels
//   zero-padded to a multiple of 8, which the maps read (hd stays the true
//   one, for the scale and the output).
// * flash_attention_f32 keeps both products on the CUDA cores in f32:
//   thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4 ty .. 4 ty + 3,
//   key columns tx + 8 j of each 64-key tile and output channels tx + 8 c;
//   q (scaled by hd^-0.5 on load), k and v are staged in shared memory, rows
//   padded to hd + 1 floats, and the probabilities go through shared memory
//   between the two products.  Its bar is 2e-5 against the plain version,
//   which neither bf16 nor TF32 operands (about 1e-3 relative) can meet.
//
// With a non-null `lse` pointer each kernel also writes the f32 natural
// log-sum-exp of every row's scaled scores, lse = m + log(l), into an
// (B, H, Sq) array: the state the backward (flash_attention_bwd.cu) needs
// to recompute the probabilities.  It is a template flag (kLse), so the
// kernels the serving path launches without it only leave those stores
// out: the output is the same bits.  With it, the bf16 kernel also writes
// the output's rounding residual o_lo = bf16(acc / l - o) in the layout of
// o: o + o_lo holds the f32 output to about 2^-17, from which the backward
// takes D = rowsum(do * o).  Where the rows of o share a large common
// part (whisper's decoder, whose cross-attention over 1500 frames gives
// every query nearly the mean of V), D from the bf16 o alone carries an
// error of about 2^-9 |o| |do| that dS = P (dP - D) does not cancel, and
// the gradients of the layers below drift 3-4% (relative L2) from the
// f32 ones, as those of FlashAttention-2-style backwards that keep only
// the bf16 output do.
//
// Bound (NVIDIA H100 SXM): operations.  The two products do 4 BH Sq Skv hd
// flops (about half with `causal`: the pairs q_pos >= k_pos) against the
// bytes of q, k, v and o read or written once.  At the prefill of
// smollm_360m (BH = 60, S = 2048, hd = 64, bf16) that is 3.2e10 flops,
// 0.033 ms at the 989 TFLOP/s of the bf16 tensor cores (reached only by
// wgmma), against 42 MB, 0.013 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockQ = 64;          // f32: query rows of a block
constexpr int kBlockK = 64;          // f32: keys of a tile
constexpr int kThreads = 128;        // f32: 16 row groups x 8 column lanes
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask fill

struct Shape {
  int64_t b, h, kvh, sq, skv, hd;
  int64_t qs[3], ks[3], vs[3];       // strides of dims 0..2 (the last is 1)
  int64_t causal, q_offset;
  float scale;                       // hd^-0.5 (f32 kernel)
  float scale_log2;                  // hd^-0.5 * log2(e) (bf16 kernel)
  void* o_lo;                        // bf16 kLse: o's residual
  int64_t n_qt, n_items;             // bf16: query tiles, (b, h, tile)s
};

// ---------------------------------------------------------------------------
// flash_attention_f32: the CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) *
         (size_t(kBlockQ + 2 * kBlockK) * (HD + 1) + kBlockQ * (kBlockK + 1));
}

template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Shape s) {
  constexpr int LD = HD + 1;           // padded row stride of q, k, v tiles
  constexpr int LDP = kBlockK + 1;     // of the probabilities
  constexpr int NC = HD / 8;           // output channels per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * LD;
  float* vs = ks + kBlockK * LD;
  float* ps = vs + kBlockK * LD;

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int64_t bi = int64_t(blockIdx.x) / s.h;
  const int64_t hi = int64_t(blockIdx.x) % s.h;
  const int64_t kv_head = hi / (s.h / s.kvh);
  const int64_t tile = s.causal ? int64_t(gridDim.y) - 1 - blockIdx.y
                                : int64_t(blockIdx.y);
  const int64_t q0 = tile * kBlockQ;
  const float* qb = q + bi * s.qs[0] + hi * s.qs[2];
  const float* kb = k + bi * s.ks[0] + kv_head * s.ks[2];
  const float* vb = v + bi * s.vs[0] + kv_head * s.vs[2];

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int64_t row = q0 + r;
    qs[r * LD + c] =
        (row < s.sq && c < s.hd) ? qb[row * s.qs[1] + c] * s.scale : 0.f;
  }

  // Keys a causal tile can see end at its last query's position.
  int64_t kv_end = s.skv;
  if (s.causal) {
    const int64_t last = (q0 + kBlockQ < s.sq ? q0 + kBlockQ : s.sq);
    if (last + s.q_offset < kv_end) kv_end = last + s.q_offset;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int64_t k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();                   // the last tile's readers are done
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const int64_t key = k0 + r;
      const bool in = key < s.skv && c < s.hd;
      ks[r * LD + c] = in ? kb[key * s.ks[1] + c] : 0.f;
      vs[r * LD + c] = in ? vb[key * s.vs[1] + c] : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < s.hd; ++d) {
      float qr[4], kc[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kc[j] = ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qr[i], kc[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t key = k0 + tx + 8 * j;
        if (key >= s.skv || (s.causal && row + s.q_offset < key))
          sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty * 4 + i) * LDP + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * LD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= s.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if constexpr (kLse) {
      if (tx == 0) lse[(bi * s.h + hi) * s.sq + row] = m[i] + logf(l[i]);
    }
    float* out = o + ((bi * s.sq + row) * s.h + hi) * s.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = tx + 8 * c;
      if (ch < s.hd) out[ch] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// flash_attention_bf16: the warpgroup products (wgmma) on TMA-fed tiles
// ---------------------------------------------------------------------------

constexpr int kWarpgroup = 128;
constexpr int kTileK = 128;                     // keys of a tile
constexpr int kStages = 2;                      // slots of the K and V rings
constexpr int kProducerRegs = 24;
constexpr int kOBlock = 64 * 128;  // a 64-channel block of a staged output
// Named barriers: consumer w's turn on the tensor cores is kTurnBar + w;
// Cfg::kGroupBar + w syncs consumer w's own 128 threads.
constexpr int kTurnBar = 1;

// A launch's shape: C consumer warpgroups of 64 query rows each, and what
// follows from it.
template <int HD, int C>
struct Cfg {
  static constexpr int kConsumers = C;
  static constexpr int kTileQ = 64 * C;          // query rows of an item
  static constexpr int kBlockThreads = (C + 1) * kWarpgroup;
  // The registers a thread at entry (one block an SM) and what the
  // consumers take from the producer (setmaxnreg): 168 and 240 with two
  // consumers, 128 and 160 with three.
  static constexpr int kEntryRegs = 65536 / kBlockThreads / 8 * 8;
  static constexpr int kConsumerRegs =
      (kEntryRegs * kBlockThreads - kProducerRegs * kWarpgroup) /
      (C * kWarpgroup) / 8 * 8;
  static_assert(kConsumerRegs <= 255, "setmaxnreg takes at most 255");
  static constexpr int kGroupBar = kTurnBar + C;
  // Shared memory: Q, the K and V rings, an output tile a consumer (two
  // with kLse: the residual's beside the output's).
  static constexpr int kQBlock = kTileQ * 128;   // a 64-channel block of Q
  static constexpr int kKVBlock = kTileK * 128;  // of a K or V slot
  static constexpr int kQ = kQBlock * (HD / 64);
  static constexpr int kKV = kKVBlock * (HD / 64);
  static constexpr int kO = kOBlock * (HD / 64);
  static constexpr size_t bytes(bool lse) {
    return 1024 + kQ + 2 * kStages * size_t(kKV) +
           (lse ? 2 : 1) * C * size_t(kO) + 8 * (2 + 4 * kStages);
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// A block's work: one (batch, head, query tile) at a time.
struct Item {
  int64_t bi, hi, q0;
  int n_tiles;                       // key tiles its queries see
};

// Item i of a launch (query tiles of tile_q rows), the tiles with the
// most keys first.
__device__ __forceinline__ Item item_at(int64_t i, const Shape& s,
                                        int tile_q) {
  const int64_t bh = s.b * s.h, r = i / bh, c = i % bh;
  const int64_t q0 = (s.causal ? s.n_qt - 1 - r : r) * tile_q;
  // Keys a causal tile can see end at its last query's position.
  int64_t kv_end = s.skv;
  if (s.causal) {
    const int64_t last = (q0 + tile_q < s.sq ? q0 + tile_q : s.sq);
    if (last + s.q_offset < kv_end) kv_end = last + s.q_offset;
  }
  return Item{c / s.h, c % s.h, q0, int((kv_end + kTileK - 1) / kTileK)};
}

// The index of block b's n-th item among G blocks: the rounds go back and
// forth over the blocks, so that with the items in falling cost each
// block's share is close to the mean.
__device__ __forceinline__ int64_t item_index(int n) {
  const int b = blockIdx.x, g = gridDim.x;
  return int64_t(n) * g + ((n & 1) ? g - 1 - b : b);
}

// d (64 x HD) += A . B: A (64 x 16) from registers, B rows 16 kk .. of a
// swizzled V slot read MN-major (`tile` its descriptor).
template <int HD>
__device__ __forceinline__ void pv_step(float (&d)[HD / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t tile, int kk) {
  if constexpr (HD == 64)
    wg::rs_m64n64k16(d, a, tile + wg::mn_major_step(kk));
  else
    wg::rs_m64n128k16(d, a, tile + wg::mn_major_step(kk));
}

// Rows g and g + 8 of this thread's warp of the consumer's (64 x HD)
// accumulator times `inv` (1 / max(l, 1e-30) of each row) into the
// consumer's staging tile `os` as bf16, in TMA's swizzled layout
// (64-channel blocks of 64 rows x 128 bytes); with `os_lo`, what that
// rounding left out into it, laid out alike.
template <int HD>
__device__ __forceinline__ void stage_rows(unsigned char* os,
                                           unsigned char* os_lo,
                                           const float (&acc)[HD / 2],
                                           const float (&inv)[2]) {
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float a = acc[4 * j + 2 * r] * inv[r];
      const float b = acc[4 * j + 2 * r + 1] * inv[r];
      const int at = (j >> 3) * kOBlock + row * 128 +
                     (((j & 7) ^ (row & 7)) << 4) + 4 * t4;
      const uint32_t x = pack_bf16(a, b);
      *reinterpret_cast<uint32_t*>(os + at) = x;
      if (os_lo != nullptr) {
        const float2 h = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&x));
        *reinterpret_cast<uint32_t*>(os_lo + at) = pack_bf16(a - h.x, b - h.y);
      }
    }
  }
}

// The consumer's staged rows [0, rows) into dst (row r at dst + r *
// stride, channels [0, hd)): 16-byte runs where hd % 8 == 0.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t stride,
                                           const unsigned char* os, int rows,
                                           int hd) {
  const int tid = threadIdx.x % kWarpgroup;
  auto runs = [&](int cpr) {             // 16-byte runs, cpr a row
    for (int e = tid; e < 64 * cpr; e += kWarpgroup) {
      const int r = e / cpr, c = e % cpr;
      if (r < rows)
        *reinterpret_cast<uint4*>(dst + r * stride + 8 * c) =
            *reinterpret_cast<const uint4*>(
                os + (c >> 3) * kOBlock + r * 128 +
                (((c & 7) ^ (r & 7)) << 4));
    }
  };
  if (hd == HD) {
    runs(HD / 8);                        // the divisions by a constant
  } else if (hd % 8 == 0) {
    runs(hd / 8);
  } else {
    for (int e = tid; e < 64 * hd; e += kWarpgroup) {
      const int r = e / hd, ch = e % hd;
      if (r < rows)
        dst[r * stride + ch] = *reinterpret_cast<const bf16*>(
            os + (ch >> 6) * kOBlock + r * 128 +
            ((((ch >> 3) & 7) ^ (r & 7)) << 4) + 2 * (ch & 7));
    }
  }
}

// o (B, Sq, H, hd), and lse with kLse, of the items item_index(0),
// item_index(1), ... of this block.  Warpgroups 0 .. C - 1 multiply, 64
// rows of an item each; warpgroup C gives back its registers and one of
// its threads loads each item's Q once, as soon as the last one's is
// read, and its K and V tile by tile into their rings, which run on
// across items.
template <int HD, int C, bool kLse>
__global__ void __launch_bounds__(Cfg<HD, C>::kBlockThreads, 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       Shape s) {
  using L = Cfg<HD, C>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + L::kQ;                   // kStages slots
  unsigned char* vs = ks + kStages * L::kKV;        // kStages slots
  unsigned char* ost = vs + kStages * L::kKV;       // a tile a consumer
  unsigned char* ost_lo = ost + C * L::kO;          // kLse: as many more
  uint64_t* bar_q =
      reinterpret_cast<uint64_t*>(ost_lo + (kLse ? C * L::kO : 0));
  uint64_t* free_q = bar_q + 1;
  uint64_t* full_k = free_q + 1;
  uint64_t* empty_k = full_k + kStages;
  uint64_t* full_v = empty_k + kStages;
  uint64_t* empty_v = full_v + kStages;

  if (threadIdx.x == 0) {
    wg::mbar_init(bar_q, 1);
    wg::mbar_init(free_q, C * 4);          // a warp each
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(full_k + i, 1);
      wg::mbar_init(full_v + i, 1);
      wg::mbar_init(empty_k + i, C * 4);
      wg::mbar_init(empty_v + i, C * 4);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= C * kWarpgroup) {
    wg::regs_dec<kProducerRegs>();
    if (threadIdx.x == C * kWarpgroup) {
      int it = 0;                                   // ring position
      for (int n = 0; item_index(n) < s.n_items; ++n) {
        const Item w = item_at(item_index(n), s, L::kTileQ);
        const int kv = int(w.hi / (s.h / s.kvh));
        if (n > 0) wg::mbar_wait(free_q, (n - 1) & 1);
        wg::mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          wg::tma_load_4d(qs + c * L::kQBlock, &tq, bar_q, 64 * c, int(w.hi),
                          int(w.q0), int(w.bi));
        for (int t = 0; t < w.n_tiles; ++t, ++it) {
          const int slot = it % kStages;
          const uint32_t parity = (it / kStages - 1) & 1;
          if (it >= kStages) wg::mbar_wait(empty_k + slot, parity);
          wg::mbar_expect_tx(full_k + slot, L::kKV);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c)
            wg::tma_load_4d(ks + slot * L::kKV + c * L::kKVBlock, &tk,
                            full_k + slot, 64 * c, kv, t * kTileK,
                            int(w.bi));
          if (it >= kStages) wg::mbar_wait(empty_v + slot, parity);
          wg::mbar_expect_tx(full_v + slot, L::kKV);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c)
            wg::tma_load_4d(vs + slot * L::kKV + c * L::kKVBlock, &tv,
                            full_v + slot, 64 * c, kv, t * kTileK,
                            int(w.bi));
        }
      }
    }
  } else {
    wg::regs_inc<L::kConsumerRegs>();
    const int cw = threadIdx.x / kWarpgroup;       // this consumer
    const int tid = threadIdx.x % kWarpgroup, warp = tid >> 5;
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const uint64_t qd = wg::desc_k_major(qs + cw * 64 * 128);
    unsigned char* os = ost + cw * L::kO;
    unsigned char* os_lo = kLse ? ost_lo + cw * L::kO : nullptr;

    float acc[HD / 2], sc[kTileK / 2], m[2], l[2];
    uint32_t p[kTileK / 16][4];
#pragma unroll
    for (int i = 0; i < kTileK / 2; ++i) sc[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      p[kk][0] = p[kk][1] = p[kk][2] = p[kk][3] = 0u;
    int it = 0;                  // ring position of the item's first tile
    int n_tiles = 0;
    bool last_item = false;

    // The last P V issued has landed: O and P may be written again, and
    // V's slot is free.
    auto pv_done = [&](int slot) {
      wg::wait<0>();
      wg::fence_regs(acc);
      wg::fence_regs(p);
      if (lane == 0) wg::mbar_arrive(empty_v + slot);
    };

    // One turn on the tensor cores: S = Q K^T of tile t (with_s) and O +=
    // P V of tile t - 1 (with_pv) issued in that order, each its own
    // group; the turn passed on; S waited for, P V left to run under the
    // softmax of S until pv_done.  with_pv and with_s are constants of the
    // call, so no branch lies between a turn's products.  The turns go
    // round the consumers, consumer 0 first; the last consumer keeps its
    // very last turn, once the others have taken all of theirs.
    auto turn = [&](int t, auto with_pv, auto with_s) {
      constexpr bool kPv = decltype(with_pv)::value;
      constexpr bool kS = decltype(with_s)::value;
      const int slot = (it + t) % kStages, prev = (it + t + 1) % kStages;
      if (kS) wg::mbar_wait(full_k + slot, ((it + t) / kStages) & 1);
      if (kPv) wg::mbar_wait(full_v + prev, ((it + t - 1) / kStages) & 1);
      wg::bar_sync(kTurnBar + cw, 2 * kWarpgroup);
      wg::fence();
      if constexpr (kS) {
        const uint64_t kd = wg::desc_k_major(ks + slot * L::kKV);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wg::ss_m64n128k16(sc, qd + wg::k_major_step(kk, L::kQBlock),
                            kd + wg::k_major_step(kk, L::kKVBlock), kk > 0);
        wg::commit();
      }
      if constexpr (kPv) {
        const uint64_t vd =
            wg::desc_mn_major(vs + prev * L::kKV, L::kKVBlock);
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)
          pv_step<HD>(acc, p[kk], vd, kk);
        wg::commit();
      }
      if (cw < C - 1 || kS || !last_item)
        wg::bar_arrive(kTurnBar + (cw + 1) % C, 2 * kWarpgroup);
      if constexpr (kS) {
        if constexpr (kPv) wg::wait<1>(); else wg::wait<0>();
        wg::fence_regs(sc);
        if (lane == 0) {   // the wait is warp-collective
          wg::mbar_arrive(empty_k + slot);
          if (t == n_tiles - 1) wg::mbar_arrive(free_q);
        }
      } else {
        pv_done(prev);
      }
    };
    static_assert(kStages == 2, "prev is the other slot");

    constexpr std::true_type on{};
    constexpr std::false_type off{};
    if (cw == C - 1) wg::bar_arrive(kTurnBar, 2 * kWarpgroup);
    for (int n = 0; item_index(n) < s.n_items; ++n) {
      const Item w = item_at(item_index(n), s, L::kTileQ);
      last_item = item_index(n + 1) >= s.n_items;
      n_tiles = w.n_tiles;
      const int64_t q0w = w.q0 + 64 * cw;         // this consumer's rows
      // This thread's rows g and g + 8 of its warp: the end of the keys
      // each sees.
      int64_t key_end[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t row = q0w + warp * 16 + g + 8 * i;
        key_end[i] = s.causal && row + s.q_offset + 1 < s.skv
                         ? row + s.q_offset + 1
                         : s.skv;
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;

      // The online softmax of tile t: this thread's rows g and g + 8 over
      // keys k0 + 8 j + 2 t4 + {0, 1}; P into p, O rescaled.
      auto softmax = [&](int t, auto pv_in_flight) {
        const int64_t k0 = int64_t(t) * kTileK;
        if (k0 + kTileK > s.skv ||
            (s.causal && k0 + kTileK - 1 > q0w + s.q_offset)) {
#pragma unroll
          for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + 8 * j + 2 * t4 + (e & 1) >= key_end[e >> 1])
                sc[4 * j + e] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY}, neg[2], alpha[2];
#pragma unroll
        for (int j = 0; j < kTileK / 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * s.scale_log2);
          alpha[r] = exp2_approx(m[r] - m_new);
          m[r] = m_new;
          neg[r] = -m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kTileK / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2_approx(fmaf(sc[i], s.scale_log2, neg[r]));
          sum[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
        if constexpr (decltype(pv_in_flight)::value)
          pv_done((it + t + 1) % kStages);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      };

      // n_tiles + 1 turns, the first S alone, the last P V alone.
      wg::mbar_wait(bar_q, n & 1);
      turn(0, off, on);
      softmax(0, off);
      for (int t = 1; t < n_tiles; ++t) {
        turn(t, on, on);
        softmax(t, on);
      }
      turn(n_tiles, on, off);
      it += n_tiles;

      // Epilogue: acc / max(l, 1e-30) in bf16 (and its residual), as a
      // product with the row's reciprocal, staged in this consumer's
      // output tile.
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = l[r];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        inv[r] = 1.f / fmaxf(lt, 1e-30f);
        if constexpr (kLse) {              // m is in log2 units
          const int64_t row = q0w + warp * 16 + g + 8 * r;
          if (t4 == 0 && row < s.sq)
            lse[(w.bi * s.h + w.hi) * s.sq + row] =
                (m[r] + log2f(lt)) * 0.69314718055994531f;
        }
      }
      const int64_t ostride = s.h * s.hd;  // o is contiguous (B, Sq, H, hd)
      const int64_t o_at = ((w.bi * s.sq + q0w) * s.h + w.hi) * s.hd;
      const int rows = int(s.sq - q0w < 64 ? s.sq - q0w : 64);
      wg::bar_sync(L::kGroupBar + cw, kWarpgroup);   // the last stores
      stage_rows<HD>(os, os_lo, acc, inv);
      wg::bar_sync(L::kGroupBar + cw, kWarpgroup);
      store_rows<HD>(o + o_at, ostride, os, rows, int(s.hd));
      if constexpr (kLse)
        store_rows<HD>(reinterpret_cast<bf16*>(s.o_lo) + o_at, ostride,
                       os_lo, rows, int(s.hd));
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int HD, bool kLse>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Shape& s, cudaStream_t stream) {
  const size_t bytes = smem_bytes_f32<HD>();
  auto kernel = flash_kernel_f32<HD, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(s.b * s.h),
                  (unsigned int)((s.sq + kBlockQ - 1) / kBlockQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, s);
  return (int)cudaGetLastError();
}

// The consumers' setmaxnreg.inc waits for the registers the producer
// warpgroup gives back: true when the kernel's entry count pays for it.
template <typename L, typename K>
bool pool_balances(K kernel) {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kernel) == cudaSuccess &&
         a.numRegs * L::kBlockThreads >=
             (L::kConsumers * L::kConsumerRegs + kProducerRegs) * kWarpgroup;
}

// The card's streaming multiprocessors: the persistent grid's size.
int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

template <int HD, int C, bool kLse>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, Shape s, cudaStream_t stream) {
  using L = Cfg<HD, C>;
  // Runtime calls first: they make the device's context current in this
  // thread, which cuTensorMapEncodeTiled needs.
  auto kernel = flash_kernel_wgmma<HD, C, kLse>;
  static const bool balanced = pool_balances<L>(kernel);
  if (!balanced) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes(kLse));
  if (err != cudaSuccess) return (int)err;
  // The maps read hd rounded up to whole 16 bytes: the wrapper's copies
  // zero those channels.
  const int64_t hd8 = (s.hd + 7) / 8 * 8;
  CUtensorMap mq{}, mk{}, mv{};
  if (!wg::strided_rows_map(&mq, q, s.b, s.sq, s.h, hd8, s.qs[0], s.qs[1],
                            s.qs[2], L::kTileQ) ||
      !wg::strided_rows_map(&mk, k, s.b, s.skv, s.kvh, hd8, s.ks[0],
                            s.ks[1], s.ks[2], kTileK) ||
      !wg::strided_rows_map(&mv, v, s.b, s.skv, s.kvh, hd8, s.vs[0],
                            s.vs[1], s.vs[2], kTileK))
    return (int)cudaErrorInvalidValue;
  s.n_qt = (s.sq + L::kTileQ - 1) / L::kTileQ;
  s.n_items = s.b * s.h * s.n_qt;
  const int64_t grid = s.n_items < sm_count() ? s.n_items : sm_count();
  kernel<<<(unsigned int)grid, L::kBlockThreads, L::bytes(kLse),
           stream>>>(mq, mk, mv, (bf16*)o, lse, s);
  return (int)cudaGetLastError();
}

// The consumer warpgroups a head_dim-64 launch takes: three (192-row
// items: more warps to overlap the softmax's 2^x with the products) unless
// the rows they leave idle past Sq, or a last round of items that fills
// fewer SMs, cost more than that gains.  The estimate is the rounds of
// items times their rows, with three consumers' rows 1.1 times as fast
// (measured at head_dim 64).
int consumers_hd64(const Shape& s) {
  auto cost = [&](int64_t c) {
    const int64_t items = s.b * s.h * ((s.sq + 64 * c - 1) / (64 * c));
    return (items + sm_count() - 1) / sm_count() * 64 * c * (c == 3 ? 10 : 11);
  };
  return cost(3) < cost(2) ? 3 : 2;
}

template <bool kLse>
int launch_bf16_hd(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Shape& s, cudaStream_t stream) {
  if (s.skv < 1) return (int)cudaErrorInvalidValue;
  if (s.hd > 64) return launch_bf16<128, 2, kLse>(q, k, v, o, lse, s, stream);
  return consumers_hd64(s) == 3
             ? launch_bf16<64, 3, kLse>(q, k, v, o, lse, s, stream)
             : launch_bf16<64, 2, kLse>(q, k, v, o, lse, s, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           void* o_lo, int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t skv,
           int64_t hd,
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
           int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
           int64_t v_sh, int64_t causal, int64_t q_offset, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (b * h == 0 || sq == 0) return (int)cudaGetLastError();
  if (hd < 1 || hd > 128 || kvh < 1 || h % kvh != 0 || q_offset < 0 ||
      b * h > INT32_MAX || sq > INT32_MAX || skv > INT32_MAX ||
      (sq + kBlockQ - 1) / kBlockQ > 65535 ||
      (o_lo != nullptr) != (lse != nullptr && kBf16))
    return (int)cudaErrorInvalidValue;
  if (kBf16) {
    // TMA reads 16-byte aligned bases at strides of whole 16 bytes.
    const int64_t strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
    uint64_t bits = uint64_t(uintptr_t(q)) | uint64_t(uintptr_t(k)) |
                    uint64_t(uintptr_t(v));
    for (int i = 0; i < 9; ++i) bits |= uint64_t(strides[i] * 2);
    if (bits & 15) return (int)cudaErrorInvalidValue;
  }
  const double scale = pow((double)hd, -0.5);
  const Shape s{b, h, kvh, sq, skv, hd, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                {v_sb, v_ss, v_sh}, causal, q_offset, (float)scale,
                (float)(scale * 1.4426950408889634), o_lo, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if constexpr (kBf16) {
    return l == nullptr ? launch_bf16_hd<false>(q, k, v, o, l, s, st)
                        : launch_bf16_hd<true>(q, k, v, o, l, s, st);
  } else {
    if (l == nullptr)
      return hd <= 64 ? launch_f32<64, false>(q, k, v, o, l, s, st)
                      : launch_f32<128, false>(q, k, v, o, l, s, st);
    return hd <= 64 ? launch_f32<64, true>(q, k, v, o, l, s, st)
                    : launch_f32<128, true>(q, k, v, o, l, s, st);
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd) through their strides (in
// values, the channels contiguous; in bf16 16-byte aligned bases, strides
// of whole 16 bytes, and the channels past hd up to a multiple of 8 zero);
// o: contiguous (B, Sq, H, hd); `lse`: an f32 (B, H, Sq) array for the
// rows' log-sum-exp, or null; `o_lo`: with `lse` in bf16, o's rounding
// residual, contiguous as o; null otherwise.
#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      void* lse, void* o_lo, int64_t b, int64_t h,          \
                      int64_t kvh, int64_t sq, int64_t skv, int64_t hd,     \
                      int64_t q_sb, int64_t q_ss, int64_t q_sh,             \
                      int64_t k_sb, int64_t k_ss, int64_t k_sh,             \
                      int64_t v_sb, int64_t v_ss, int64_t v_sh,             \
                      int64_t causal, int64_t q_offset, void* stream) {     \
    return launch<T>(q, k, v, o, lse, o_lo, b, h, kvh, sq, skv, hd, q_sb,  \
                     q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,        \
                     causal, q_offset, stream);                             \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, bf16)

// The dynamic shared memory (bytes) of the bf16 kernel for head_dim hd
// with `consumers` consumer warpgroups (2 or 3; 3 only at head_dim 64),
// with its log-sum-exp output (lse != 0) or without.
extern "C" int flash_attention_smem(int64_t hd, int64_t consumers,
                                    int64_t lse) {
  if (hd > 64) return int(Cfg<128, 2>::bytes(lse != 0));
  return int(consumers == 3 ? Cfg<64, 3>::bytes(lse != 0)
                            : Cfg<64, 2>::bytes(lse != 0));
}
