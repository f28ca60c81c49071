// flash_attention_bwd: the gradient of row 10's attention,
// o = softmax(q k^T * hd^-0.5) v, causal or full, with grouped-query heads:
// dq, dk and dv from q, k, v, the forward's output o, its f32 log-sum-exp
// lse (flash_attention.cu with a non-null `lse`) and the output's
// gradient do.
//
// Replaces no TPU kernel: the reference differentiates attention_chunked
// (repro/models/attention.py:42) with JAX's autodiff, through the
// chunked online softmax that flash_attention_bhsd
// (repro/kernels/flash_attention.py:79, pallas_call at :108) computes in
// one kernel.  Training on the card needs the backward of row 10's kernel;
// autograd through the plain version would put the plain version on the
// main path.
//
// The math (FlashAttention-2): with s = q k^T * scale (scale = hd^-0.5)
// masked as the forward masks it (keys past skv, and with `causal` the
// keys past the query's position, row + q_offset < key),
//   P = exp(s - lse),  D = rowsum(do * o),
//   dv = P^T do,  dS = P * (do v^T - D),  dq = dS k * scale,
//   dk = dS^T q * scale.
// Two launches, each writing every element of its outputs once, with no
// atomic operation at all, so the gradient is the same bits from run to
// run (the analysis linter scans this file for atomic adds):
// * the dq launch first: one block per (batch, head, 64-row query tile),
//   looping over the key tiles its rows can see (the forward's kv_end), dq
//   in registers.  It computes D of its rows once and writes it to `dsum`
//   (f32, (B, H, Sq) at a pitch the wrapper chooses, scratch).  In bf16
//   it takes the forward's output residual `o_lo` (flash_attention.cu): D =
//   rowsum(do * (o + o_lo)): o + o_lo is the f32 output to about 2^-17,
//   where the bf16 o alone leaves D an error of about 2^-9 |o| |do| that
//   dS = P (dP - D) does not cancel when the rows of o share a large
//   common part.
// * the dk/dv launch then: one block per (batch, KV head, 64-key tile).  It
//   loops over the group's query heads and, for each, over the 64-row
//   query tiles that the mask lets see the key tile, recomputing P^T and
//   dS^T tile by tile from the tile's lse and D; dk and dv of its keys stay
//   in registers across the whole loop.
// head_dim is at most 128; each kernel is built for 64 or 128 channels,
// the channels past hd zero.  Which type runs where:
// * bf16 (flash_attention_bwd_bf16), for Hopper (bwd_dq_wgmma,
//   bwd_dkdv_wgmma): every product on the warpgroup products
//   (wgmma.mma_async m64nNk16, bf16 in, f32 sums; wgmma_tma.cuh).  A block
//   is two warpgroups.  The producer warpgroup gives back its registers
//   (setmaxnreg, down to 24) and one of its threads brings every tile in
//   by TMA (cp.async.bulk.tensor from the wrapper's tensor maps): the
//   block's own tiles once (Q, dO, O and O's residual, or K and V), the
//   tiles it loops
//   over (K and V, or Q, dO, lse and D) into a two-slot ring of full and
//   empty mbarriers.  Tiles land 128-byte swizzled, zero past the rows'
//   end and past hd.  The consumer warpgroup (registers up to 232, or 240
//   at 128 channels) owns the block's 64 rows: the score-side products
//   (S and dO V^T, or their transposes) read both operands from shared
//   memory through descriptors (m64n64k16, K-major); P and dS are
//   computed in f32 registers (2^x on the special-function unit against
//   lse in log2 units; the mask tested only on the tiles it cuts, against
//   per-row bounds) and rounded to bf16 as the A operands of the
//   value-side products, from registers (the accumulator's layout is the
//   A layout), whose B operands (K, or dO and Q) are read MN-major (the
//   transpose flag).  Rounding P and dS to bf16 is what FlashAttention-2
//   does; it stays inside the reference's bf16 bar.  Two blocks an SM at
//   64 channels.  TMA needs 16-byte aligned operands with rows of whole
//   16-byte units: the wrapper prepares them (kernels/flash_attention.py,
//   _tma_operands: aligned contiguous copies, hd padded to a multiple of
//   8, lse lines to a multiple of 4 values) and the scale comes from the
//   true hd (scale_hd).
// * f32 (flash_attention_bwd_f32): every product on the CUDA cores in
//   f32, 256 threads, (ty, tx) = (tid / 16, tid % 16): a thread owns rows
//   4 ty .. 4 ty + 3 of its block's tile, columns tx + 16 j (j < 4) of the
//   64 x 64 score tiles and channels tx + 16 c of its outputs; tiles in
//   shared memory as f32 rows padded to hd + 1.
// The outputs are rounded to the inputs' type once.
//
// Bound (NVIDIA H100 SXM): operations.  The gradient needs five products
// of the visible (query, key) pairs, 10 B H pairs hd flops (2.5 times the
// forward's), against q, k, v, o, do, lse read once and dq, dk, dv written
// once.  At smollm_360m's training shape (B = 4, H = 15, S = 2048, hd =
// 64, causal, bf16) that is 8.1e10 flops, 0.082 ms at the 989 TFLOP/s of
// the bf16 tensor cores, against 0.11 GB, 0.034 ms at 3.35 TB/s.  Without
// atomics the kernels do seven products (the dq launch recomputes S and
// do v^T), 1.13e11 flops, 0.114 ms at that rate: this design's floor
// (1.16e11 counting the diagonal tiles whole).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;            // query rows and keys of a tile
constexpr int kThreads = 256;        // f32: 16 row groups x 16 column lanes
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int64_t b, h, kvh, sq, skv, hd, causal, q_offset;
  int64_t stat_pitch;                // lse and dsum: values between lines
  float scale;                       // scale_hd^-0.5
  float scale_log2;                  // the scale times log2(e) (bf16)
};

__device__ __forceinline__ bool visible(int64_t row, int64_t key,
                                        const Shape& s) {
  return row < s.sq && key < s.skv && !(s.causal && row + s.q_offset < key);
}

// The first 64-row query tile whose rows see a key of the tile at k0.
__device__ __forceinline__ int64_t first_q_tile(int64_t k0, const Shape& s) {
  return (s.causal && k0 > s.q_offset) ? (k0 - s.q_offset) / kTile * kTile
                                       : 0;
}

// The end of the keys that the query tile at q0 sees.
__device__ __forceinline__ int64_t kv_end(int64_t q0, const Shape& s) {
  int64_t end = s.skv;
  if (s.causal) {
    const int64_t last = (q0 + kTile < s.sq ? q0 + kTile : s.sq);
    if (last + s.q_offset < end) end = last + s.q_offset;
  }
  return end;
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

// Rows r0 .. r0 + 63 of one head of a contiguous (rows, heads, hd) slab
// whose row r starts at base + r * stride, at a pitch of HD + 1; rows past
// n_rows and channels past hd are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int64_t stride, int64_t r0,
                                          int64_t n_rows, int hd) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int64_t row = r0 + r;
    dst[r * (HD + 1) + c] =
        (row < n_rows && c < hd) ? base[row * stride + c] : 0.f;
  }
}

template <int HD>
constexpr size_t smem_bytes() {      // four tiles, two score tiles, stats
  return sizeof(float) * (4 * size_t(kTile) * (HD + 1) +
                          2 * size_t(kTile) * (kTile + 1) + 2 * kTile);
}

// dq of one (batch, head, query tile); D of its rows into dsum.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ dsum, float* __restrict__ dq, Shape s) {
  constexpr int LD = HD + 1, LDP = kTile + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;        // dS: queries x keys
  float* lse_s = dss + 2 * kTile * LDP;
  float* d_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bi = int64_t(blockIdx.x) / s.h;
  const int64_t hi = int64_t(blockIdx.x) % s.h;
  const int64_t kv = hi / (s.h / s.kvh);
  const int64_t tile = s.causal ? int64_t(gridDim.y) - 1 - blockIdx.y
                                : int64_t(blockIdx.y);
  const int64_t q0 = tile * kTile;
  const int64_t kstride = s.kvh * s.hd, qstride = s.h * s.hd;
  const int hd = int(s.hd);
  const int64_t q_off = (bi * s.sq * s.h + hi) * s.hd;
  const int64_t kv_off = (bi * s.skv * s.kvh + kv) * s.hd;
  const int64_t stat = (bi * s.h + hi) * s.stat_pitch;

  load_tile<HD>(qs, q + q_off, qstride, q0, s.sq, hd);
  load_tile<HD>(dos, dout + q_off, qstride, q0, s.sq, hd);
  load_tile<HD>(ks, o + q_off, qstride, q0, s.sq, hd);    // o, for D
  __syncthreads();
  if (tid < kTile) {
    float d = 0.f;
    for (int c = 0; c < hd; ++c) d += dos[tid * LD + c] * ks[tid * LD + c];
    const int64_t row = q0 + tid;
    d_s[tid] = d;
    lse_s[tid] = row < s.sq ? lse[stat + row] : 0.f;
    if (row < s.sq) dsum[stat + row] = d;
  }

  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  const int64_t end = kv_end(q0, s);
  for (int64_t k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();                   // the last tile's readers are done
    load_tile<HD>(ks, k + kv_off, kstride, k0, s.skv, hd);
    load_tile<HD>(vs, v + kv_off, kstride, k0, s.skv, hd);
    __syncthreads();

    // S and do v^T: rows 4 ty + i, keys tx + 16 j.
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qr[4], orow[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[i] = qs[(4 * ty + i) * LD + d];
        orow[i] = dos[(4 * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = ks[(tx + 16 * j) * LD + d];
        vc[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qr[i], kc[j], sc[i][j]);
          dp[i][j] = fmaf(orow[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const float p = visible(q0 + r, k0 + key, s)
                            ? expf(sc[i][j] * s.scale - lse_s[r])
                            : 0.f;
        dss[r * LDP + key] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    // dq += dS k over the tile's 64 keys.
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      float sr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sr[i] = dss[(4 * ty + i) * LDP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kvv = ks[key * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dq_acc[i][c] = fmaf(sr[i], kvv, dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + 4 * ty + i;
    if (row >= s.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = tx + 16 * c;
      if (ch < hd) dq[q_off + row * qstride + ch] = dq_acc[i][c] * s.scale;
    }
  }
}

// dk, dv of one (batch, KV head, key tile), from dsum.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             float* __restrict__ dk, float* __restrict__ dv, Shape s) {
  constexpr int LD = HD + 1, LDP = kTile + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* pt = dos + kTile * LD;        // P^T: keys x queries
  float* dst = pt + kTile * LDP;       // dS^T
  float* lse_s = dst + kTile * LDP;
  float* d_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bi = int64_t(blockIdx.x) / s.kvh;
  const int64_t kv = int64_t(blockIdx.x) % s.kvh;
  const int64_t k0 = int64_t(blockIdx.y) * kTile;
  const int64_t groups = s.h / s.kvh;
  const int64_t kstride = s.kvh * s.hd, qstride = s.h * s.hd;
  const int hd = int(s.hd);
  const int64_t kv_off = (bi * s.skv * s.kvh + kv) * s.hd;

  load_tile<HD>(ks, k + kv_off, kstride, k0, s.skv, hd);
  load_tile<HD>(vs, v + kv_off, kstride, k0, s.skv, hd);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int64_t g = 0; g < groups; ++g) {
    const int64_t hi = kv * groups + g;
    const int64_t q_off = (bi * s.sq * s.h + hi) * s.hd;
    const int64_t stat = (bi * s.h + hi) * s.stat_pitch;
    for (int64_t q0 = first_q_tile(k0, s); q0 < s.sq; q0 += kTile) {
      __syncthreads();                 // the last tile's readers are done
      load_tile<HD>(qs, q + q_off, qstride, q0, s.sq, hd);
      load_tile<HD>(dos, dout + q_off, qstride, q0, s.sq, hd);
      if (tid < kTile) {
        const int64_t row = q0 + tid;
        lse_s[tid] = row < s.sq ? lse[stat + row] : 0.f;
        d_s[tid] = row < s.sq ? dsum[stat + row] : 0.f;
      }
      __syncthreads();

      // S^T and (do v^T)^T: keys 4 ty + i, queries tx + 16 j.
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        float kr[4], vr[4], qc[4], oc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kr[i] = ks[(4 * ty + i) * LD + d];
          vr[i] = vs[(4 * ty + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qc[j] = qs[(tx + 16 * j) * LD + d];
          oc[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(kr[i], qc[j], sc[i][j]);
            dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float p = visible(q0 + r, k0 + 4 * ty + i, s)
                              ? expf(sc[i][j] * s.scale - lse_s[r])
                              : 0.f;
          pt[(4 * ty + i) * LDP + r] = p;
          dst[(4 * ty + i) * LDP + r] = p * (dp[i][j] - d_s[r]);
        }
      __syncthreads();

      // dv += P^T do, dk += dS^T q over the tile's 64 queries.
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pr[4], sr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = pt[(4 * ty + i) * LDP + r];
          sr[i] = dst[(4 * ty + i) * LDP + r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = dos[r * LD + tx + 16 * c];
          const float qv = qs[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pr[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(sr[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k0 + 4 * ty + i;
    if (key >= s.skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = tx + 16 * c;
      if (ch < hd) {
        dk[kv_off + key * kstride + ch] = dk_acc[i][c] * s.scale;
        dv[kv_off + key * kstride + ch] = dv_acc[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the warpgroup products (wgmma) on TMA-fed tiles
// ---------------------------------------------------------------------------

constexpr int kWarpgroup = 128;              // 64 rows of a product
constexpr int kStages = 2;                   // ring slots of the looped tiles
constexpr int kProducerRegs = 24;

// Threads: one consumer warpgroup (64 rows of every product) and one
// producer warpgroup a block.  Blocks an SM: two at 64 channels, one at
// 128, where dk and dv alone hold 128 registers a thread.  With them the
// registers a thread at entry (the launch bounds) and what the consumers
// take from the producer (setmaxnreg): 232 at 64 channels, 240 at 128.
constexpr int kBlockThreads = 2 * kWarpgroup;

template <int HD>
struct Budget {
  static constexpr int kBlocks = HD == 64 ? 2 : 1;
  static constexpr int kFree = 65536 / (kBlockThreads * kBlocks);
  static constexpr int kEntry = (kFree > 255 ? 255 : kFree) / 8 * 8;
  static constexpr int kSpare =
      (kEntry * kBlockThreads - kProducerRegs * kWarpgroup) / kWarpgroup /
      8 * 8;
  static constexpr int kConsumer = kSpare > 240 ? 240 : kSpare;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Whether a 64 x 64 (query, key) tile holds a pair the mask hides.
__device__ __forceinline__ bool needs_mask(int64_t q0, int64_t k0,
                                           const Shape& s) {
  return q0 + kTile > s.sq || k0 + kTile > s.skv ||
         (s.causal && k0 + kTile - 1 > q0 + s.q_offset);
}

// The consumer warpgroup's 128 threads (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarpgroup) : "memory");
}

// d (64 x HD) += A . B: A (64 x 16) from registers, B rows 16 kk .. of a
// swizzled tile read MN-major (`tile` its desc_mn_major).
template <int HD>
__device__ __forceinline__ void rs_rows(float (&d)[HD / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t tile, int kk) {
  if constexpr (HD == 64)
    wg::rs_m64n64k16(d, a, tile + wg::mn_major_step(kk));
  else
    wg::rs_m64n128k16(d, a, tile + wg::mn_major_step(kk));
}

// d (64 x 64) = A . B^T over hd: the rows of two swizzled tiles, both
// read K-major.
template <int HD>
__device__ __forceinline__ void ss_rows(float (&d)[32],
                                        const unsigned char* a,
                                        const unsigned char* b) {
  const uint64_t da = wg::desc_k_major(a), db = wg::desc_k_major(b);
  wg::ss_m64n64k16_first(d, da, db);
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    wg::ss_m64n64k16(d, da + wg::k_major_step(kk),
                        db + wg::k_major_step(kk));
}

// A 64 x 64 f32 accumulator rounded to bf16 as the A operands of the four
// 16-deep steps over its columns (the accumulator's layout is the A
// layout).
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Rows g and g + 8 of this thread's warp of a (64 x HD) accumulator,
// times `mul`, into the bf16 rows of `dst` (row r at dst + r * stride,
// row0 the warp's first row), rows past n_rows and channels past hd left
// out.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t stride,
                                           int64_t row0, int64_t n_rows,
                                           int hd, const float (&acc)[HD / 2],
                                           float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + g + 8 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int ch = 8 * j + 2 * t4;
      if (ch < hd)
        *reinterpret_cast<uint32_t*>(dst + row * stride + ch) =
            pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

template <int HD>
constexpr size_t smem_bytes_dq() {   // Q, dO, O, O_lo, the K, V ring, D, bars
  return 1024 + size_t(4 + 2 * kStages) * kTile * HD * 2 + 4 * kTile +
         8 * (1 + 2 * kStages);
}

template <int HD>
constexpr size_t smem_bytes_dkdv() {  // K, V, the Q and dO ring, lse and D
  return 1024 + size_t(2 + 2 * kStages) * kTile * HD * 2 +
         size_t(2 * kStages) * 4 * kTile + 8 * (1 + 2 * kStages);
}

// Barriers: one for the block's own tiles, a full and an empty one a slot
// (the empty one waits for every consumer thread).
__device__ __forceinline__ void init_ring(uint64_t* bars) {
  if (threadIdx.x == 0) {
    wg::mbar_init(bars, 1);
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(bars + 1 + i, 1);
      wg::mbar_init(bars + 1 + kStages + i, kWarpgroup);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
}

// dq of one (batch, head, 64-row query tile), D of its rows into dsum.
// Warpgroup 0 multiplies; warpgroup 1 gives back its registers and one of
// its threads loads Q, dO and O (and O's residual) once and K and V tile
// by tile into the ring.
template <int HD>
__global__ void __launch_bounds__(kBlockThreads, Budget<HD>::kBlocks)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap to,
                 const __grid_constant__ CUtensorMap tol,
                 const float* __restrict__ lse, float* __restrict__ dsum,
                 bf16* __restrict__ dq, Shape s) {
  constexpr int TB = kTile * HD * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + TB;
  unsigned char* os = dos + TB;
  unsigned char* ols = os + TB;                     // O's residual
  unsigned char* ks = ols + TB;                     // kStages slots
  unsigned char* vs = ks + kStages * TB;            // kStages slots
  float* d_s = reinterpret_cast<float*>(vs + kStages * TB);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(d_s + kTile);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int64_t bi = int64_t(blockIdx.x) / s.h;
  const int64_t hi = int64_t(blockIdx.x) % s.h;
  const int64_t kv = hi / (s.h / s.kvh);
  const int64_t tile = s.causal ? int64_t(gridDim.y) - 1 - blockIdx.y
                                : int64_t(blockIdx.y);
  const int64_t q0 = tile * kTile;
  const int n_tiles = int((kv_end(q0, s) + kTile - 1) / kTile);
  init_ring(bar_q);

  if (threadIdx.x >= kWarpgroup) {
    wg::regs_dec<kProducerRegs>();
    if (threadIdx.x == kWarpgroup) {
      wg::mbar_expect_tx(bar_q, 4 * TB);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        const int at = c * wg::kBlockBytes;
        wg::tma_load_4d(qs + at, &tq, bar_q, 64 * c, int(hi), int(q0),
                        int(bi));
        wg::tma_load_4d(dos + at, &tdo, bar_q, 64 * c, int(hi), int(q0),
                        int(bi));
        wg::tma_load_4d(os + at, &to, bar_q, 64 * c, int(hi), int(q0),
                        int(bi));
        wg::tma_load_4d(ols + at, &tol, bar_q, 64 * c, int(hi), int(q0),
                        int(bi));
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int slot = t % kStages;
        if (t >= kStages) wg::mbar_wait(empty + slot, (t / kStages - 1) & 1);
        wg::mbar_expect_tx(full + slot, 2 * TB);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          wg::tma_load_4d(ks + slot * TB + c * wg::kBlockBytes, &tk,
                          full + slot, 64 * c, int(kv), t * kTile, int(bi));
          wg::tma_load_4d(vs + slot * TB + c * wg::kBlockBytes, &tv,
                          full + slot, 64 * c, int(kv), t * kTile, int(bi));
        }
      }
    }
  } else {
    wg::regs_inc<Budget<HD>::kConsumer>();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int64_t qstride = s.h * s.hd;
    const int64_t q_off = (bi * s.sq * s.h + hi) * s.hd;
    const int64_t stat = (bi * s.h + hi) * s.stat_pitch;
    wg::mbar_wait(bar_q, 0);

    // D = rowsum(do * (o + o_lo)) of the tile's rows from the swizzled
    // tiles, two threads a row, each over every other
    // 16-byte chunk (the channels past hd and the rows past sq read as
    // zero).
    {
      const int r = tid >> 1, half = tid & 1;
      const int64_t row = q0 + r;
      float d = 0.f;
#pragma unroll
      for (int c = half; c < HD / 8; c += 2) {
        const int at = (c >> 3) * wg::kBlockBytes + r * 128 +
                       (((c & 7) ^ (r & 7)) << 4);
        const uint4 x = *reinterpret_cast<const uint4*>(dos + at);
        const uint4 y = *reinterpret_cast<const uint4*>(os + at);
        const uint4 z = *reinterpret_cast<const uint4*>(ols + at);
        const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
        const __nv_bfloat162* za = reinterpret_cast<const __nv_bfloat162*>(&z);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(xa[i]);
          const float2 b = __bfloat1622float2(ya[i]);
          const float2 e = __bfloat1622float2(za[i]);
          d = fmaf(a.x, b.x + e.x, d);
          d = fmaf(a.y, b.y + e.y, d);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (half == 0) {
        d_s[r] = d;
        if (row < s.sq) dsum[stat + row] = d;
      }
    }
    consumer_sync();
    // This thread's rows g and g + 8 of its warp: log2-scaled lse, D, and
    // the end of the keys each sees (0 past sq).
    float lse2[2], dd[2];
    int key_end[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      const int64_t row = q0 + r;
      lse2[i] = row < s.sq ? lse[stat + row] * kLog2e : 0.f;
      dd[i] = d_s[r];
      const int64_t end = s.causal && row + s.q_offset + 1 < s.skv
                              ? row + s.q_offset + 1
                              : s.skv;
      key_end[i] = row < s.sq ? int(end) : 0;
    }

    float dq_acc[HD / 2], sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      const unsigned char* kt = ks + slot * TB;
      wg::mbar_wait(full + slot, (t / kStages) & 1);
      // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys.
      wg::fence();
      ss_rows<HD>(sc, qs, kt);
      ss_rows<HD>(dp, dos, vs + slot * TB);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(sc);
      wg::fence_regs(dp);
      const int k0 = t * kTile;
      if (needs_mask(q0, k0, s)) {
        const int key = k0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float p =
                key + 8 * j + (e & 1) < key_end[e >> 1]
                    ? exp2_approx(sc[i] * s.scale_log2 - lse2[e >> 1])
                    : 0.f;
            sc[i] = p * (dp[i] - dd[e >> 1]);         // dS
          }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p =
              exp2_approx(sc[i] * s.scale_log2 - lse2[(i >> 1) & 1]);
          sc[i] = p * (dp[i] - dd[(i >> 1) & 1]);
        }
      }
      uint32_t a[4][4];
      to_a(a, sc);
      // dq += dS K over the tile's 64 keys.
      const uint64_t kd = wg::desc_mn_major(kt);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs_rows<HD>(dq_acc, a[kk], kd, kk);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dq_acc);
      wg::mbar_arrive(empty + slot);
    }
    store_rows<HD>(dq + q_off, qstride, q0 + warp * 16, s.sq, int(s.hd),
                   dq_acc, s.scale);
  }
}

// dk, dv of one (batch, KV head, 64-key tile), looping over the group's
// query heads and the query tiles the mask lets see the keys.  Warpgroup
// 0 multiplies; one thread of warpgroup 1 loads K and V once and Q, dO,
// lse and D tile by tile into the ring.
template <int HD>
__global__ void __launch_bounds__(kBlockThreads, Budget<HD>::kBlocks)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tlse,
                   const __grid_constant__ CUtensorMap tdsum,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s) {
  constexpr int TB = kTile * HD * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + TB;
  unsigned char* qs = vs + TB;                      // kStages slots
  unsigned char* dos = qs + kStages * TB;           // kStages slots
  float* lse_s = reinterpret_cast<float*>(dos + kStages * TB);  // slots
  float* d_s = lse_s + kStages * kTile;                          // slots
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(d_s + kStages * kTile);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int64_t bi = int64_t(blockIdx.x) / s.kvh;
  const int64_t kv = int64_t(blockIdx.x) % s.kvh;
  const int64_t k0 = int64_t(blockIdx.y) * kTile;
  const int64_t groups = s.h / s.kvh;
  const int64_t q_first = first_q_tile(k0, s);
  const int per_head = int((s.sq - q_first + kTile - 1) / kTile);
  const int n_tiles = int(groups) * (per_head > 0 ? per_head : 0);
  init_ring(bar_kv);

  if (threadIdx.x >= kWarpgroup) {
    wg::regs_dec<kProducerRegs>();
    if (threadIdx.x == kWarpgroup) {
      wg::mbar_expect_tx(bar_kv, 2 * TB);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        wg::tma_load_4d(ks + c * wg::kBlockBytes, &tk, bar_kv, 64 * c,
                        int(kv), int(k0), int(bi));
        wg::tma_load_4d(vs + c * wg::kBlockBytes, &tv, bar_kv, 64 * c,
                        int(kv), int(k0), int(bi));
      }
      // Tile t: query head kv * groups + t / per_head, rows from q_first
      // + 64 (t % per_head).
      for (int t = 0; t < n_tiles; ++t) {
        const int slot = t % kStages;
        const int hi = int(kv * groups) + t / per_head;
        const int q0 = int(q_first) + (t % per_head) * kTile;
        if (t >= kStages) wg::mbar_wait(empty + slot, (t / kStages - 1) & 1);
        wg::mbar_expect_tx(full + slot, 2 * TB + 2 * 4 * kTile);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          wg::tma_load_4d(qs + slot * TB + c * wg::kBlockBytes, &tq,
                          full + slot, 64 * c, hi, q0, int(bi));
          wg::tma_load_4d(dos + slot * TB + c * wg::kBlockBytes, &tdo,
                          full + slot, 64 * c, hi, q0, int(bi));
        }
        wg::tma_load_2d(lse_s + slot * kTile, &tlse, full + slot, q0,
                        int(bi * s.h) + hi);
        wg::tma_load_2d(d_s + slot * kTile, &tdsum, full + slot, q0,
                        int(bi * s.h) + hi);
      }
    }
  } else {
    wg::regs_inc<Budget<HD>::kConsumer>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int64_t kstride = s.kvh * s.hd;
    const int64_t kv_off = (bi * s.skv * s.kvh + kv) * s.hd;
    // This thread's keys g and g + 8 of its warp: the queries that see
    // each, [q_lo, q_hi) (empty past skv).
    int q_lo[2], q_hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t key = k0 + warp * 16 + g + 8 * i;
      q_lo[i] = s.causal && key > s.q_offset ? int(key - s.q_offset) : 0;
      q_hi[i] = key < s.skv ? int(s.sq) : 0;
    }

    float dk_acc[HD / 2], dv_acc[HD / 2], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    wg::mbar_wait(bar_kv, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int slot = t % kStages;
      const unsigned char* qt = qs + slot * TB;
      const unsigned char* dot = dos + slot * TB;
      wg::mbar_wait(full + slot, (t / kStages) & 1);
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries.
      wg::fence();
      ss_rows<HD>(st, ks, qt);
      ss_rows<HD>(dpt, vs, dot);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(st);
      wg::fence_regs(dpt);
      const float* lt = lse_s + slot * kTile;
      const float* dt = d_s + slot * kTile;
      const int q0 = int(q_first) + (t % per_head) * kTile;
      const bool edge = needs_mask(q0, k0, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + qc);
        const float lg[2] = {l2.x * kLog2e, l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, q = q0 + qc + (e & 1);
          float p = exp2_approx(st[i] * s.scale_log2 - lg[e & 1]);
          if (edge && !(q >= q_lo[e >> 1] && q < q_hi[e >> 1])) p = 0.f;
          st[i] = p;                                  // P^T
          dpt[i] = p * (dpt[i] - dl[e & 1]);          // dS^T
        }
      }
      uint32_t ap[4][4], ads[4][4];
      to_a(ap, st);
      to_a(ads, dpt);
      // dv += P^T dO, dk += dS^T Q over the tile's 64 queries.
      const uint64_t dod = wg::desc_mn_major(dot), qd = wg::desc_mn_major(qt);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        rs_rows<HD>(dv_acc, ap[kk], dod, kk);
        rs_rows<HD>(dk_acc, ads[kk], qd, kk);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dv_acc);
      wg::fence_regs(dk_acc);
      wg::mbar_arrive(empty + slot);
    }
    store_rows<HD>(dk + kv_off, kstride, k0 + warp * 16, s.skv, int(s.hd),
                   dk_acc, s.scale);
    store_rows<HD>(dv + kv_off, kstride, k0 + warp * 16, s.skv, int(s.hd),
                   dv_acc, 1.f);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T>
struct Kernels;

template <>
struct Kernels<float> {
  template <int HD>
  static int run(const float* q, const float* k, const float* v,
                 const float* o, const float* /* o_lo: bf16 only */,
                 const float* dout, const float* lse, float* dsum, float* dq,
                 float* dk, float* dv, const Shape& s, cudaStream_t stream) {
    const size_t bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (s.sq > 0) {
      bwd_dq<HD><<<dim3((unsigned int)(s.b * s.h),
                        (unsigned int)((s.sq + kTile - 1) / kTile)),
                   kThreads, bytes, stream>>>(q, k, v, o, dout, lse, dsum,
                                              dq, s);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (s.skv > 0)
      bwd_dkdv<HD><<<dim3((unsigned int)(s.b * s.kvh),
                          (unsigned int)((s.skv + kTile - 1) / kTile)),
                     kThreads, bytes, stream>>>(q, k, v, dout, lse, dsum,
                                                dk, dv, s);
    return (int)cudaGetLastError();
  }
};

template <>
struct Kernels<bf16> {
  // The consumers' setmaxnreg.inc waits for the registers the producer
  // warpgroup gives back: true when a kernel's entry count pays for it.
  template <int HD, typename K>
  static bool pool_balances(K kernel) {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, kernel) == cudaSuccess &&
           a.numRegs * kBlockThreads >=
               (Budget<HD>::kConsumer + kProducerRegs) * kWarpgroup;
  }

  template <int HD>
  static int run(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const bf16* o_lo, const bf16* dout, const float* lse,
                 float* dsum, bf16* dq, bf16* dk, bf16* dv, const Shape& s,
                 cudaStream_t stream) {
    CUtensorMap mq{}, mk{}, mv{}, mdo{}, mo{}, mol{}, mlse{}, mds{};
    bool ok = true;
    if (s.sq > 0)
      ok = wg::rows_map(&mq, q, s.b, s.sq, s.h, s.hd) &&
           wg::rows_map(&mdo, dout, s.b, s.sq, s.h, s.hd) &&
           wg::rows_map(&mo, o, s.b, s.sq, s.h, s.hd) &&
           wg::rows_map(&mol, o_lo, s.b, s.sq, s.h, s.hd) &&
           wg::stats_map(&mlse, lse, s.b * s.h, s.sq, s.stat_pitch) &&
           wg::stats_map(&mds, dsum, s.b * s.h, s.sq, s.stat_pitch);
    if (ok && s.skv > 0)
      ok = wg::rows_map(&mk, k, s.b, s.skv, s.kvh, s.hd) &&
           wg::rows_map(&mv, v, s.b, s.skv, s.kvh, s.hd);
    if (!ok) return (int)cudaErrorInvalidValue;
    auto dq_kernel = bwd_dq_wgmma<HD>;
    auto dkdv_kernel = bwd_dkdv_wgmma<HD>;
    static const bool balanced =
        pool_balances<HD>(dq_kernel) && pool_balances<HD>(dkdv_kernel);
    if (!balanced) return (int)cudaErrorInvalidConfiguration;
    const size_t dq_bytes = smem_bytes_dq<HD>();
    const size_t dkdv_bytes = smem_bytes_dkdv<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dq_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_bytes);
    if (err != cudaSuccess) return (int)err;
    if (s.sq > 0) {
      dq_kernel<<<dim3((unsigned int)(s.b * s.h),
                       (unsigned int)((s.sq + kTile - 1) / kTile)),
                  kBlockThreads, dq_bytes, stream>>>(mq, mk, mv, mdo, mo,
                                                     mol, lse, dsum, dq, s);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (s.skv > 0)
      dkdv_kernel<<<dim3((unsigned int)(s.b * s.kvh),
                         (unsigned int)((s.skv + kTile - 1) / kTile)),
                    kBlockThreads, dkdv_bytes, stream>>>(
          mq, mk, mv, mdo, mlse, mds, dk, dv, s);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* o_lo, const void* dout, const void* lse, void* dsum,
           void* dq, void* dk,
           void* dv, int64_t b, int64_t h, int64_t kvh, int64_t sq,
           int64_t skv, int64_t hd, int64_t causal, int64_t q_offset,
           int64_t scale_hd, int64_t stat_pitch, void* stream) {
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  if (hd < 1 || hd > 128 || kvh < 1 || h % kvh != 0 || q_offset < 0 ||
      scale_hd < 1 || stat_pitch < sq || b * h > INT32_MAX ||
      sq > INT32_MAX || skv > INT32_MAX ||
      (sq + kTile - 1) / kTile > 65535 || (skv + kTile - 1) / kTile > 65535 ||
      (o_lo != nullptr) != (sizeof(T) == 2))
    return (int)cudaErrorInvalidValue;
  if (sizeof(T) == 2) {
    // TMA boxes need hd % 8 == 0, 16-byte aligned bases and lse/dsum
    // lines at a pitch of whole 16 bytes (the wrapper's _tma_operands).
    const uint64_t bits = uint64_t(uintptr_t(q)) | uint64_t(uintptr_t(k)) |
                          uint64_t(uintptr_t(v)) | uint64_t(uintptr_t(o)) |
                          uint64_t(uintptr_t(o_lo)) |
                          uint64_t(uintptr_t(dout)) |
                          uint64_t(uintptr_t(lse)) | uint64_t(uintptr_t(dsum));
    if (hd % 8 != 0 || (bits & 15) != 0 || stat_pitch % 4 != 0)
      return (int)cudaErrorInvalidValue;
  }
  const double scale = pow((double)scale_hd, -0.5);
  const Shape s{b, h, kvh, sq, skv, hd, causal, q_offset, stat_pitch,
                (float)scale,
                (float)(scale * 1.4426950408889634)};
  cudaStream_t st = (cudaStream_t)stream;
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v,
          *to = (const T*)o, *tol = (const T*)o_lo, *tdo = (const T*)dout;
  const float* l = (const float*)lse;
  float* ds = (float*)dsum;
  T *tdq = (T*)dq, *tdk = (T*)dk, *tdv = (T*)dv;
  return hd <= 64 ? Kernels<T>::template run<64>(
                        tq, tk, tv, to, tol, tdo, l, ds, tdq, tdk, tdv, s,
                        st)
                  : Kernels<T>::template run<128>(
                        tq, tk, tv, to, tol, tdo, l, ds, tdq, tdk, tdv, s,
                        st);
}

}  // namespace

// q, o, do, dq: contiguous (B, Sq, H, hd); k, v, dk, dv: contiguous (B,
// Skv, KV, hd); o_lo: in bf16 o's rounding residual laid out as o, null
// in f32; lse and dsum (scratch for D = rowsum(do * o)): f32 (B, H, Sq)
// lines at a pitch of stat_pitch values.  The scale is scale_hd^-0.5 (the
// true head_dim where the wrapper padded the channels).  Two launches on
// `stream`: dq (writing dsum), then dk and dv.
#define FLASH_BWD_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* o_lo, const void* dout,    \
                      const void* lse, void* dsum, void* dq, void* dk,      \
                      void* dv, int64_t b, int64_t h, int64_t kvh,          \
                      int64_t sq, int64_t skv, int64_t hd, int64_t causal,  \
                      int64_t q_offset, int64_t scale_hd,                   \
                      int64_t stat_pitch, void* stream) {                   \
    return launch<T>(q, k, v, o, o_lo, dout, lse, dsum, dq, dk, dv, b, h,   \
                     kvh, sq, skv, hd, causal, q_offset, scale_hd,          \
                     stat_pitch, stream);                                   \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, bf16)

// The dynamic shared memory (bytes) of a bf16 kernel for head_dim hd:
// kernel 0 the dq launch's, 1 the dk/dv launch's.
extern "C" int flash_attention_bwd_smem(int64_t hd, int64_t kernel) {
  if (hd <= 64)
    return int(kernel == 0 ? smem_bytes_dq<64>() : smem_bytes_dkdv<64>());
  return int(kernel == 0 ? smem_bytes_dq<128>() : smem_bytes_dkdv<128>());
}
