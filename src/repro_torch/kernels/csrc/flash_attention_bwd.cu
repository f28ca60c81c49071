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
// atomics, so the gradient is the same bits from run to run:
// * bwd_dq first: one block per (batch, head, 64-row query tile), looping
//   over the key tiles its rows can see (the forward's kv_end), dq in
//   registers.  It computes D of its rows from do and o once and writes it
//   to `dsum` (f32, (B, H, Sq), scratch the wrapper allocates).
// * bwd_dkdv then: one block per (batch, KV head, 64-key tile).  It loops
//   over the group's query heads and, for each, over the 64-row query tiles
//   that the mask lets see the key tile, recomputing P and dS^T tile by
//   tile from the tile's lse and D; dk and dv of its keys stay in registers
//   across the whole loop.
// head_dim is at most 128; each kernel is built for 64 or 128 channels,
// the channels past hd zero.  Which type runs where, as in the forward:
// * bf16 (flash_attention_bwd_bf16): the five products on the bf16 tensor
//   cores (HMMA, mma.sync.aligned.m16n8k16, f32 sums; the forward's
//   fragments, hmma_bf16.cuh), 4 warps, each owning 16 rows of its block's
//   own tile (queries in bwd_dq_mma, keys in bwd_dkdv_mma).  Tiles sit in
//   shared memory as bf16 rows padded to hd + 8 values, and the tiles a
//   block loops over (K and V, or Q and dO with lse and D) are
//   double-buffered by cp.async, the next tile in flight while the current
//   one is multiplied.  The score-side products (S and do v^T, or their
//   transposes) come out in f32 registers, P and dS are computed there
//   (2^x on the special-function unit against lse in log2 units) and
//   rounded to bf16 as the A fragments of the value-side products (the C
//   layout of m16n8k16 is its A layout), whose B fragments come from
//   ldmatrix.trans.  Rounding P and dS to bf16 is what FlashAttention-2
//   does; it stays inside the reference's bf16 bar.
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
// the bf16 tensor cores (reached only by wgmma), against 0.11 GB, 0.034 ms
// at 3.35 TB/s.  The kernels do seven products (bwd_dq recomputes S and
// do v^T).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "hmma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;            // query rows and keys of a tile
constexpr int kThreads = 256;        // f32: 16 row groups x 16 column lanes
constexpr int kMmaThreads = 128;     // bf16: 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int64_t b, h, kvh, sq, skv, hd, causal, q_offset;
  float scale;                       // hd^-0.5
  float scale_log2;                  // hd^-0.5 * log2(e) (bf16 kernels)
  int vec;                           // bf16 rows copy in 16-byte runs
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
  const int64_t stat = (bi * s.h + hi) * s.sq;

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
    const int64_t stat = (bi * s.h + hi) * s.sq;
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
// bf16: the tensor cores (HMMA)
// ---------------------------------------------------------------------------

// Starts the copy of rows r0 .. r0 + 63 of a (rows, heads, hd) slab (row r
// at base + r * stride) into shared memory at a pitch of HD + 8 values,
// zero past n_rows and hd: by cp.async in 16-byte runs when `vec` (hd % 8
// == 0, 16-byte aligned rows), else by plain loads and stores.
template <int HD>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* base,
                                          int64_t stride, int64_t r0,
                                          int64_t n_rows, int hd, int vec) {
  constexpr int P = HD + 8, CH = HD / 8;
  if (vec) {
    for (int e = threadIdx.x; e < kTile * CH; e += kMmaThreads) {
      const int r = e / CH, c = (e % CH) * 8;
      const int64_t row = r0 + r;
      const bool in = row < n_rows && c < hd;
      cp_async<16>(dst + r * P + c, in ? base + row * stride + c : base,
                   in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * HD; e += kMmaThreads) {
      const int r = e / HD, c = e % HD;
      const int64_t row = r0 + r;
      dst[r * P + c] = (row < n_rows && c < hd) ? base[row * stride + c]
                                                : __float2bfloat16_rn(0.f);
    }
  }
}

// Starts the copy of 64 values of an f32 row vector from r0 (zero past n).
__device__ __forceinline__ void copy_stats(float* dst, const float* src,
                                           int64_t r0, int64_t n) {
  if (threadIdx.x < kTile) {
    const int64_t row = r0 + threadIdx.x;
    cp_async<4>(dst + threadIdx.x, row < n ? src + row : src,
                row < n ? 4 : 0);
  }
}

template <int HD>
constexpr size_t smem_bytes_mma() {  // six bf16 tiles, two stats slots
  return sizeof(bf16) * 6 * size_t(kTile) * (HD + 8) +
         sizeof(float) * 4 * kTile;
}

// acc (16 rows of the warp x 64 columns, C layout) += A . B^T over hd:
// A rows from `a` (this warp's 16 rows), B rows from `b` (64 rows), both
// in shared memory at a pitch of HD + 8.
template <int HD>
__device__ __forceinline__ void rows_by_rows(float (&acc)[kTile / 8][4],
                                             const bf16* a, const bf16* b) {
  constexpr int P = HD + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (warp * 16 + lr + (lm & 1) * 8) * P + kk * 16 +
                    (lm >> 1) * 8);
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (16 * np + lr + (lm >> 1) * 8) * P + kk * 16 +
                      (lm & 1) * 8);
      hmma_16x8x16(acc[2 * np], af, bf[0], bf[1]);
      hmma_16x8x16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out (16 rows x HD, C layout) += X . B over the tile's 64 columns: X this
// warp's 16 x 64 values in C layout (rounded to bf16 as A fragments), B
// rows from `b` (64 rows x HD) in shared memory at a pitch of HD + 8.
template <int HD>
__device__ __forceinline__ void c_by_rows(float (&out)[HD / 8][4],
                                          const float (&x)[kTile / 8][4],
                                          const bf16* b) {
  constexpr int P = HD + 8;
  const int lane = threadIdx.x & 31;
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int cp = 0; cp < HD / 16; ++cp) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (16 * kk + lr + (lm & 1) * 8) * P + 16 * cp +
                            (lm >> 1) * 8);
      hmma_16x8x16(out[2 * cp], af, bf[0], bf[1]);
      hmma_16x8x16(out[2 * cp + 1], af, bf[2], bf[3]);
    }
  }
}

// Rows row0 + g and row0 + g + 8 of a C-layout (16 x HD) block, times
// `mul`, into the bf16 rows of `dst` (row r at dst + r * stride), rows
// past n_rows and channels past hd left out.
template <int HD>
__device__ __forceinline__ void store_c(bf16* dst, int64_t stride,
                                        int64_t row0, int64_t n_rows, int hd,
                                        const float (&acc)[HD / 8][4],
                                        float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int ch = 8 * c + 2 * t4;
      if (ch < hd)
        dst[row * stride + ch] = __float2bfloat16_rn(acc[c][2 * r] * mul);
      if (ch + 1 < hd)
        dst[row * stride + ch + 1] =
            __float2bfloat16_rn(acc[c][2 * r + 1] * mul);
    }
  }
}

// dq of one (batch, head, query tile), warp w owning queries q0 + 16 w ..;
// D of its rows into dsum.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ dsum, bf16* __restrict__ dq, Shape s) {
  constexpr int P = HD + 8, NS = kTile / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile * P;
  bf16* ks = dos + kTile * P;          // two slots
  bf16* vs = ks + 2 * kTile * P;       // two slots
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kTile * P);
  float* d_s = lse_s + kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
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
  const int64_t stat = (bi * s.h + hi) * s.sq;
  const int n_tiles = int((kv_end(q0, s) + kTile - 1) / kTile);

  auto load_kv = [&](int slot, int t) {
    copy_tile<HD>(ks + slot * kTile * P, k + kv_off, kstride,
                  int64_t(t) * kTile, s.skv, hd, s.vec);
    copy_tile<HD>(vs + slot * kTile * P, v + kv_off, kstride,
                  int64_t(t) * kTile, s.skv, hd, s.vec);
  };

  // Q, dO and, in the second V slot (free until tile 1), o; then D.
  copy_tile<HD>(qs, q + q_off, qstride, q0, s.sq, hd, s.vec);
  copy_tile<HD>(dos, dout + q_off, qstride, q0, s.sq, hd, s.vec);
  copy_tile<HD>(vs + kTile * P, o + q_off, qstride, q0, s.sq, hd, s.vec);
  copy_stats(lse_s, lse + stat, q0, s.sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    // two threads a row, each over half the channels
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const bf16* os = vs + kTile * P;
    float d = 0.f;
    for (int c = half; c < hd; c += 2)
      d += __bfloat162float(dos[r * P + c]) * __bfloat162float(os[r * P + c]);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      d_s[r] = d;
      lse_s[r] *= kLog2e;
      if (q0 + r < s.sq) dsum[stat + q0 + r] = d;
    }
  }
  __syncthreads();                     // o's slot is refilled below
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  float dq_acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[c][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    if (t + 1 < n_tiles) load_kv(slot ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile t has landed
    __syncthreads();
    const bf16* kt = ks + slot * kTile * P;
    const int64_t k0 = int64_t(t) * kTile;

    // S = Q K^T and do v^T: queries of this warp x keys.
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    rows_by_rows<HD>(sc, qs, kt);
    rows_by_rows<HD>(dp, dos, vs + slot * kTile * P);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + 8 * (e >> 1);
        const int64_t key = k0 + 8 * j + 2 * t4 + (e & 1);
        const float p = visible(q0 + r, key, s)
                            ? exp2_approx(sc[j][e] * s.scale_log2 - lse_s[r])
                            : 0.f;
        sc[j][e] = p * (dp[j][e] - d_s[r]);          // dS
      }
    c_by_rows<HD>(dq_acc, sc, kt);     // dq += dS k over the tile's keys
    __syncthreads();                   // the slot is refilled next tile
  }
  cp_async_wait<0>();
  store_c<HD>(dq + q_off, qstride, q0 + warp * 16, s.sq, hd, dq_acc,
              s.scale);
}

// dk, dv of one (batch, KV head, key tile), warp w owning keys k0 + 16 w
// ..; the query tiles (Q, dO, lse, D) double-buffered.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Shape s) {
  constexpr int P = HD + 8, NS = kTile / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile * P;
  bf16* qs = vs + kTile * P;           // two slots
  bf16* dos = qs + 2 * kTile * P;      // two slots
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile * P);  // two
  float* d_s = lse_s + 2 * kTile;                                // two

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t bi = int64_t(blockIdx.x) / s.kvh;
  const int64_t kv = int64_t(blockIdx.x) % s.kvh;
  const int64_t k0 = int64_t(blockIdx.y) * kTile;
  const int64_t groups = s.h / s.kvh;
  const int64_t kstride = s.kvh * s.hd, qstride = s.h * s.hd;
  const int hd = int(s.hd);
  const int64_t kv_off = (bi * s.skv * s.kvh + kv) * s.hd;
  const int64_t q_first = first_q_tile(k0, s);
  const int per_head = int((s.sq - q_first + kTile - 1) / kTile);
  const int n_tiles = int(groups) * (per_head > 0 ? per_head : 0);

  // Tile t: query head kv * groups + t / per_head, rows from q_first +
  // 64 (t % per_head).
  auto load_q = [&](int slot, int t) {
    const int64_t hi = kv * groups + t / per_head;
    const int64_t q0 = q_first + int64_t(t % per_head) * kTile;
    const int64_t q_off = (bi * s.sq * s.h + hi) * s.hd;
    const int64_t stat = (bi * s.h + hi) * s.sq;
    copy_tile<HD>(qs + slot * kTile * P, q + q_off, qstride, q0, s.sq, hd,
                  s.vec);
    copy_tile<HD>(dos + slot * kTile * P, dout + q_off, qstride, q0, s.sq,
                  hd, s.vec);
    copy_stats(lse_s + slot * kTile, lse + stat, q0, s.sq);
    copy_stats(d_s + slot * kTile, dsum + stat, q0, s.sq);
  };

  copy_tile<HD>(ks, k + kv_off, kstride, k0, s.skv, hd, s.vec);
  copy_tile<HD>(vs, v + kv_off, kstride, k0, s.skv, hd, s.vec);
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();                   // K and V with the first query tile

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    if (t + 1 < n_tiles) load_q(slot ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile t (and K, V) have landed
    __syncthreads();
    const bf16* qt = qs + slot * kTile * P;
    const bf16* dot = dos + slot * kTile * P;
    const float* lt = lse_s + slot * kTile;
    const float* dt = d_s + slot * kTile;
    const int64_t q0 = q_first + int64_t(t % per_head) * kTile;

    // S^T = K Q^T and (do v^T)^T = V dO^T: keys of this warp x queries.
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    rows_by_rows<HD>(st, ks, qt);
    rows_by_rows<HD>(dpt, vs, dot);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t4 + (e & 1);
        const int64_t key = k0 + warp * 16 + g + 8 * (e >> 1);
        const float p = visible(q0 + qc, key, s)
                            ? exp2_approx(st[j][e] * s.scale_log2 -
                                          lt[qc] * kLog2e)
                            : 0.f;
        st[j][e] = p;                                // P^T
        dpt[j][e] = p * (dpt[j][e] - dt[qc]);        // dS^T
      }
    // dv += P^T do, dk += dS^T q over the tile's 64 queries.
    c_by_rows<HD>(dv_acc, st, dot);
    c_by_rows<HD>(dk_acc, dpt, qt);
    __syncthreads();                   // the slot is refilled next tile
  }
  cp_async_wait<0>();
  store_c<HD>(dk + kv_off, kstride, k0 + warp * 16, s.skv, hd, dk_acc,
              s.scale);
  store_c<HD>(dv + kv_off, kstride, k0 + warp * 16, s.skv, hd, dv_acc, 1.f);
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
                 const float* o, const float* dout, const float* lse,
                 float* dsum, float* dq, float* dk, float* dv,
                 const Shape& s, cudaStream_t stream) {
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
  template <int HD>
  static int run(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const bf16* dout, const float* lse, float* dsum, bf16* dq,
                 bf16* dk, bf16* dv, const Shape& s, cudaStream_t stream) {
    const size_t bytes = smem_bytes_mma<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        bwd_dkdv_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (s.sq > 0) {
      bwd_dq_mma<HD><<<dim3((unsigned int)(s.b * s.h),
                            (unsigned int)((s.sq + kTile - 1) / kTile)),
                       kMmaThreads, bytes, stream>>>(q, k, v, o, dout, lse,
                                                     dsum, dq, s);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (s.skv > 0)
      bwd_dkdv_mma<HD><<<dim3((unsigned int)(s.b * s.kvh),
                              (unsigned int)((s.skv + kTile - 1) / kTile)),
                         kMmaThreads, bytes, stream>>>(q, k, v, dout, lse,
                                                       dsum, dk, dv, s);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* dq, void* dk,
           void* dv, int64_t b, int64_t h, int64_t kvh, int64_t sq,
           int64_t skv, int64_t hd, int64_t causal, int64_t q_offset,
           void* stream) {
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  if (hd < 1 || hd > 128 || kvh < 1 || h % kvh != 0 || q_offset < 0 ||
      b * h > INT32_MAX || (sq + kTile - 1) / kTile > 65535 ||
      (skv + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  // bf16 rows copy in 16-byte runs when every base pointer and row stride
  // allows it (the rows are contiguous (rows, heads, hd) slabs).
  const uint64_t bits =
      uint64_t(uintptr_t(q)) | uint64_t(uintptr_t(k)) |
      uint64_t(uintptr_t(v)) | uint64_t(uintptr_t(o)) |
      uint64_t(uintptr_t(dout)) | uint64_t(h * hd * sizeof(T)) |
      uint64_t(kvh * hd * sizeof(T)) | uint64_t(hd * sizeof(T));
  const double scale = pow((double)hd, -0.5);
  const Shape s{b, h, kvh, sq, skv, hd, causal, q_offset, (float)scale,
                (float)(scale * 1.4426950408889634),
                int(hd % 8 == 0 && (bits & 15) == 0)};
  cudaStream_t st = (cudaStream_t)stream;
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v,
          *to = (const T*)o, *tdo = (const T*)dout;
  const float* l = (const float*)lse;
  float* ds = (float*)dsum;
  T *tdq = (T*)dq, *tdk = (T*)dk, *tdv = (T*)dv;
  return hd <= 64 ? Kernels<T>::template run<64>(tq, tk, tv, to, tdo, l, ds,
                                                 tdq, tdk, tdv, s, st)
                  : Kernels<T>::template run<128>(tq, tk, tv, to, tdo, l,
                                                  ds, tdq, tdk, tdv, s, st);
}

}  // namespace

// q, o, do, dq: contiguous (B, Sq, H, hd); k, v, dk, dv: contiguous (B,
// Skv, KV, hd); lse and dsum (scratch for D = rowsum(do * o)): f32 (B, H,
// Sq).  Two launches on `stream`: dq (writing dsum), then dk and dv.
#define FLASH_BWD_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, const void* lse,     \
                      void* dsum, void* dq, void* dk, void* dv, int64_t b,  \
                      int64_t h, int64_t kvh, int64_t sq, int64_t skv,      \
                      int64_t hd, int64_t causal, int64_t q_offset,         \
                      void* stream) {                                       \
    return launch<T>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, h, kvh,    \
                     sq, skv, hd, causal, q_offset, stream);                \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, bf16)
