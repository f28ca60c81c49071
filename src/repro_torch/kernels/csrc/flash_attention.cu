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
// state in VMEM scratch; here one block owns a 64-row query tile of one
// (batch, head) and walks the key tiles in a loop, the state in registers.
// The TPU wrapper copies each KV head to its query heads (jnp.repeat); this
// kernel reads query head h's KV head h / (H / KV) in place, and takes q, k
// and v through their strides in the model's (B, S, heads, hd) layout, so
// no operand is copied.  Key tiles wholly past a causal tile's last query
// are skipped, and the tiles with the most keys are scheduled first.
// head_dim is at most 128: each kernel is built for 64 or 128 channels and
// the channels past hd are zero.
//
// Which type runs where: the entry point by type is the dispatch.
// * flash_attention_bf16 runs both products on the bf16 tensor cores
//   (HMMA, mma.sync.aligned.m16n8k16 with f32 accumulators), the
//   FlashAttention-2 structure: 4 warps, each owning 16 query rows.  The Q
//   tile is copied once by cp.async and held in registers as mma A
//   fragments (ldmatrix), unscaled; the K and V tiles of 64 keys are
//   double-buffered by cp.async, the next tile in flight while the current
//   one is multiplied; rows are padded to hd + 8 values, so the 8 rows of
//   every ldmatrix phase fall on distinct bank groups.  S = Q K^T comes out
//   in f32 and is multiplied by hd^-0.5 * log2(e) (one f32 rounding), so
//   the softmax takes 2^x (ex2.approx, about 2 ulp) and keeps m in log2
//   units; the mask is applied only on tiles that cross the diagonal or
//   the keys' end.  Row maxima and sums reduce over the 4 lanes that share
//   a row (shuffles).  P is rounded to bf16 in registers and reused as the
//   A fragment of P V (the C layout of m16n8k16 is its A layout), with V's
//   B fragments from ldmatrix.trans; l sums the f32 probabilities.
//   Registers bound the occupancy: the kernel asks for 3 blocks an SM at
//   hd 64, 2 at 128.  Rounding P to bf16 is a deviation from
//   the reference, which multiplies f32 probabilities: it stays inside the
//   reference's bf16 bar (2e-2).  The output tile is staged in shared
//   memory and stored in 16-byte runs.  Where a base pointer or a row
//   stride is not a multiple of 16 bytes, the tiles are copied 8, 4 or 2
//   bytes at a time (2: plain loads) by the same kernel.
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
// kernels the serving path launches without it are the code they were.
// With it, the bf16 kernel also writes the
// output's rounding residual o_lo = bf16(acc / l - o) in the layout of o:
// o + o_lo holds the f32 output to about 2^-17, from which the backward
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
// wgmma; mma.sync reaches a fraction of it), against 42 MB, 0.013 ms at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "hmma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockQ = 64;          // query rows of a block, both kernels
constexpr int kBlockK = 64;          // keys of a tile, both kernels
constexpr int kThreads = 128;        // f32: 16 row groups x 8 column lanes;
                                     // bf16: 4 warps of 16 query rows
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask fill

struct Shape {
  int64_t b, h, kvh, sq, skv, hd;
  int64_t qs[3], ks[3], vs[3];       // strides of dims 0..2 (the last is 1)
  int64_t causal, q_offset;
  float scale;                       // hd^-0.5 (f32 kernel)
  float scale_log2;                  // hd^-0.5 * log2(e) (bf16 kernel)
  int align;                         // bf16 kernel's copy width, bytes
  void* o_lo;                        // bf16 kLse: o's residual
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
// flash_attention_bf16: the bf16 tensor cores (HMMA)
// ---------------------------------------------------------------------------

// Q, two K and two V tiles of 64 rows, each row padded to HD + 8 values.
template <int HD>
constexpr size_t smem_bytes_bf16() {
  return sizeof(bf16) * size_t(kBlockQ + 4 * kBlockK) * (HD + 8);
}

// Rows [0, rows) of a 64 x HD tile whose row r starts at src + r * stride,
// into shared memory at a pitch of HD + 8 values, by cp.async; rows past
// `rows` and channels past hd are zero-filled.  `align` (16, 8, 4 or 2) is
// the copy width in bytes that every row start allows; 2 takes plain loads
// and stores.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int rows, int hd,
                                          int align) {
  constexpr int P = HD + 8, CH = HD / 8;   // 16-byte chunks a row
#pragma unroll
  for (int u = 0; u < kBlockQ * CH / kThreads; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = e / CH, c = (e % CH) * 8;
    const int valid = r < rows ? max(0, min(8, hd - c)) : 0;   // values
    bf16* d = dst + r * P + c;
    const bf16* s = valid ? src + r * stride + c : src;
    if (align == 16) {
      cp_async<16>(d, s, 2 * valid);
    } else if (align == 8) {
#pragma unroll
      for (int w = 0; w < 8; w += 4)
        cp_async<8>(d + w, valid > w ? s + w : src,
                    2 * max(0, min(4, valid - w)));
    } else if (align == 4) {
#pragma unroll
      for (int w = 0; w < 8; w += 2)
        cp_async<4>(d + w, valid > w ? s + w : src,
                    2 * max(0, min(2, valid - w)));
    } else {
#pragma unroll
      for (int w = 0; w < 8; ++w)
        d[w] = w < valid ? s[w] : __float2bfloat16_rn(0.f);
    }
  }
}

// 3 blocks an SM at head_dim 64 (at most 170 registers a thread), 2 at
// 128: faster on the card than the compiler's own choice (185 registers,
// 2 blocks).
template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 3 : 2)
    flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Shape s) {
  constexpr int P = HD + 8;            // padded row pitch of every tile
  constexpr int KQ = HD / 16;          // k-steps of S = Q K^T
  constexpr int NS = kBlockK / 8;      // 8-key column tiles of S
  constexpr int NO = HD / 8;           // 8-channel column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBlockQ * P;         // two slots
  bf16* vs = ks + 2 * kBlockK * P;     // two slots

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment coordinates
  const int lr = lane & 7, lm = lane >> 3;      // ldmatrix row, matrix
  const int64_t bi = int64_t(blockIdx.x) / s.h;
  const int64_t hi = int64_t(blockIdx.x) % s.h;
  const int64_t kv_head = hi / (s.h / s.kvh);
  const int64_t tile = s.causal ? int64_t(gridDim.y) - 1 - blockIdx.y
                                : int64_t(blockIdx.y);
  const int64_t q0 = tile * kBlockQ;
  const bf16* kb = k + bi * s.ks[0] + kv_head * s.ks[2];
  const bf16* vb = v + bi * s.vs[0] + kv_head * s.vs[2];

  // Keys a causal tile can see end at its last query's position.
  int64_t kv_end = s.skv;
  if (s.causal) {
    const int64_t last = (q0 + kBlockQ < s.sq ? q0 + kBlockQ : s.sq);
    if (last + s.q_offset < kv_end) kv_end = last + s.q_offset;
  }
  const int n_tiles = int((kv_end + kBlockK - 1) / kBlockK);

  auto load_kv = [&](int slot, int t) {
    const int64_t k0 = int64_t(t) * kBlockK;
    const int rows = int(s.skv - k0 < kBlockK ? s.skv - k0 : kBlockK);
    load_tile<HD>(ks + slot * kBlockK * P, kb + k0 * s.ks[1], s.ks[1], rows,
                  int(s.hd), s.align);
    load_tile<HD>(vs + slot * kBlockK * P, vb + k0 * s.vs[1], s.vs[1], rows,
                  int(s.hd), s.align);
  };

  load_tile<HD>(qs, q + bi * s.qs[0] + hi * s.qs[2] + q0 * s.qs[1], s.qs[1],
                int(s.sq - q0 < kBlockQ ? s.sq - q0 : kBlockQ), int(s.hd),
                s.align);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();                   // Q with the first K, V tiles

  uint32_t qf[KQ][4];                  // this warp's 16 rows of Q
  float acc[NO][4];                    // O: rows g and g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NO; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  const int64_t row_g = q0 + warp * 16 + g;     // and row_g + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    if (t + 1 < n_tiles) load_kv(slot ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + lr + (lm & 1) * 8) * P + kk * 16 +
                            (lm >> 1) * 8);
    }
    const bf16* kt = ks + slot * kBlockK * P;
    const bf16* vt = vs + slot * kBlockK * P;

    float sc[NS][4];                   // S: rows g, g + 8 of 8-key tiles
#pragma unroll
    for (int j = 0; j < NS; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {   // keys 16 np .. 16 np + 15
        uint32_t b[4];
        ldsm_x4(b, kt + (16 * np + lr + (lm >> 1) * 8) * P + kk * 16 +
                       (lm & 1) * 8);
        hmma_16x8x16(sc[2 * np], qf[kk], b[0], b[1]);
        hmma_16x8x16(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    const int64_t k0 = int64_t(t) * kBlockK;
    const bool edge = k0 + kBlockK > s.skv ||
                      (s.causal && k0 + kBlockK - 1 > q0 + s.q_offset);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * s.scale_log2;
        if (edge) {
          const int64_t key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int64_t row = row_g + (e >> 1) * 8;
          if (key >= s.skv || (s.causal && row + s.q_offset < key))
            x = kNegInf;
        }
        sc[j][e] = x;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {      // rows g (r = 0) and g + 8
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2_approx(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2_approx(sc[j][2 * r] - mx);
        const float p1 = exp2_approx(sc[j][2 * r + 1] - mx);
        sc[j][2 * r] = p0;
        sc[j][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l[r] = l[r] * alpha + sum;       // this lane's share of the row
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        acc[c][2 * r] *= alpha;
        acc[c][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {   // keys 16 kk .. + 15
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int cp = 0; cp < NO / 2; ++cp) {       // channels 16 cp .. + 15
        uint32_t b[4];
        ldsm_x4_trans(b, vt + (16 * kk + lr + (lm & 1) * 8) * P + 16 * cp +
                             (lm >> 1) * 8);
        hmma_16x8x16(acc[2 * cp], a, b[0], b[1]);
        hmma_16x8x16(acc[2 * cp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                   // the slot is refilled next tile
  }

  // Epilogue: acc / max(l, 1e-30) in bf16, staged in the Q tile's rows.
  cp_async_wait<0>();
  __syncthreads();
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    denom[r] = fmaxf(lt, 1e-30f);
    if constexpr (kLse) {              // m is in log2 units
      const int64_t lrow = row_g + 8 * r;
      if (t4 == 0 && lrow < s.sq)
        lse[(bi * s.h + hi) * s.sq + lrow] =
            (m[r] + log2f(lt)) * 0.69314718055994531f;
    }
    bf16* row = qs + (warp * 16 + g + 8 * r) * P + 2 * t4;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) = __floats2bfloat162_rn(
          acc[c][2 * r] / denom[r], acc[c][2 * r + 1] / denom[r]);
  }
  __syncwarp();
  const int64_t ostride = s.h * s.hd;  // o is contiguous (B, Sq, H, hd)
  const int64_t o_at = ((bi * s.sq + q0) * s.h + hi) * s.hd;
  const int hd = int(s.hd);
  const int rows = int(s.sq - q0 < kBlockQ ? s.sq - q0 : kBlockQ);
  // This warp's 16 staged rows into dst (B, Sq, H, hd).
  auto store_rows = [&](bf16* ob) {
    if (hd % 8 == 0) {                 // 16-byte runs
      const int cpr = hd / 8;
      for (int e = lane; e < 16 * cpr; e += 32) {
        const int r = warp * 16 + e / cpr, c = (e % cpr) * 8;
        if (r < rows)
          *reinterpret_cast<uint4*>(ob + r * ostride + c) =
              *reinterpret_cast<const uint4*>(qs + r * P + c);
      }
    } else {
      for (int e = lane; e < 16 * hd; e += 32) {
        const int r = warp * 16 + e / hd, c = e % hd;
        if (r < rows) ob[r * ostride + c] = qs[r * P + c];
      }
    }
  };
  store_rows(o + o_at);
  if constexpr (kLse) {                // the residual, staged the same way
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* row = qs + (warp * 16 + g + 8 * r) * P + 2 * t4;
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const float a = acc[c][2 * r] / denom[r];
        const float b = acc[c][2 * r + 1] / denom[r];
        const float2 h =
            __bfloat1622float2(__floats2bfloat162_rn(a, b));
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) =
            __floats2bfloat162_rn(a - h.x, b - h.y);
      }
    }
    __syncwarp();
    store_rows(reinterpret_cast<bf16*>(s.o_lo) + o_at);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int HD, bool kLse>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, const Shape& s, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  const size_t bytes = kMma ? smem_bytes_bf16<HD>() : smem_bytes_f32<HD>();
  void (*kernel)(const T*, const T*, const T*, T*, float*, Shape);
  if constexpr (kMma) {
    kernel = flash_kernel_mma<HD, kLse>;
  } else {
    kernel = flash_kernel_f32<HD, kLse>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(s.b * s.h),
                  (unsigned int)((s.sq + kBlockQ - 1) / kBlockQ));
  kernel<<<grid, kThreads, bytes, stream>>>((const T*)q, (const T*)k,
                                            (const T*)v, (T*)o, lse, s);
  return (int)cudaGetLastError();
}

// The widest copy (16, 8, 4 or 2 bytes) that every row start of q, k and
// v allows: the base pointers and every stride in bytes.
int copy_align(const void* q, const void* k, const void* v,
               const int64_t* strides, int count) {
  uint64_t bits = uint64_t(uintptr_t(q)) | uint64_t(uintptr_t(k)) |
                  uint64_t(uintptr_t(v));
  for (int i = 0; i < count; ++i) bits |= uint64_t(strides[i] * 2);
  int align = 16;
  while (align > 2 && (bits & uint64_t(align - 1))) align >>= 1;
  return align;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           void* o_lo, int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t skv,
           int64_t hd,
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
           int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
           int64_t v_sh, int64_t causal, int64_t q_offset, void* stream) {
  if (b * h == 0 || sq == 0) return (int)cudaGetLastError();
  if (hd < 1 || hd > 128 || kvh < 1 || h % kvh != 0 || q_offset < 0 ||
      b * h > INT32_MAX || (sq + kBlockQ - 1) / kBlockQ > 65535 ||
      (o_lo != nullptr) != (lse != nullptr && sizeof(T) == 2))
    return (int)cudaErrorInvalidValue;
  const int64_t strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                              k_sh, v_sb, v_ss, v_sh};
  const double scale = pow((double)hd, -0.5);
  Shape s{b, h, kvh, sq, skv, hd, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
          {v_sb, v_ss, v_sh}, causal, q_offset, (float)scale,
          (float)(scale * 1.4426950408889634), copy_align(q, k, v, strides, 9),
          o_lo};
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (l == nullptr)
    return hd <= 64 ? launch_hd<T, 64, false>(q, k, v, o, l, s, st)
                    : launch_hd<T, 128, false>(q, k, v, o, l, s, st);
  return hd <= 64 ? launch_hd<T, 64, true>(q, k, v, o, l, s, st)
                  : launch_hd<T, 128, true>(q, k, v, o, l, s, st);
}

}  // namespace

// `lse`: an f32 (B, H, Sq) array for the rows' log-sum-exp, or null;
// `o_lo`: with `lse` in bf16, o's rounding residual, contiguous as o;
// null otherwise.
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
