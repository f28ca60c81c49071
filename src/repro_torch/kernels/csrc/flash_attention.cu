// flash_attention: forward attention, causal or full, with an online
// softmax and grouped-query heads, o = softmax(q k^T * hd^-0.5) v.
//
// Replaces flash_attention_bhsd -> _kernel
// (repro/kernels/flash_attention.py:79, its pallas_call at :108 and its
// kernel body at :38).  The function is the TPU kernel's: q is cast to f32
// and scaled by hd^-0.5, the scores are f32 and filled with -1e30 where a
// key lies past the keys' length or, with `causal`, past the query's
// position (q_pos + q_offset < k_pos, absolute indices), (m, l, acc) are
// kept in f32 across the whole key sweep and the result is
// acc / max(l, 1e-30) rounded to the output's type.  The TPU's grid walks
// the key blocks in order with the state in VMEM scratch; here one block
// owns a 64-row query tile of one (batch, head) and walks the key tiles
// in a loop, the state in registers.  The TPU wrapper copies each KV head
// to its query heads (jnp.repeat); this kernel reads query head h's KV head
// h / (H / KV) in place, and takes q, k and v through their strides in the
// model's (B, S, heads, hd) layout, so no operand is copied.
//
// Layout of a block (128 threads): thread (ty, tx) = (tid / 8, tid % 8)
// owns query rows 4 ty .. 4 ty + 3 of the tile, key columns tx + 8 j
// (j < 8) of each 64-key tile's scores, and output channels tx + 8 c.  The
// query tile and each key and value tile are staged in shared memory as
// f32 (bf16 widened on load), rows padded to hd + 1 floats so that the
// strided reads hit distinct banks; the probabilities go through shared
// memory between the two products.  Row maxima and sums reduce over the 8
// lanes of a row with shuffles.  Key tiles wholly past a causal tile's last
// query are skipped, and the tiles with the most keys are scheduled first.
// head_dim is at most 128: the tile is built for 64 or 128 channels and
// the channels past hd are zero.
//
// Bound (NVIDIA H100 SXM): operations.  The two products do 4 BH Sq Skv hd
// flops (about half with `causal`: the pairs q_pos >= k_pos) against the
// bytes of q, k, v and o read or written once.  At the prefill of
// smollm_360m (BH = 60, S = 2048, hd = 64, bf16) that is 3.2e10 flops,
// 0.033 ms at the 989 TFLOP/s of the bf16 tensor cores, against 42 MB,
// 0.013 ms at 3.35 TB/s.  This simple design runs both products on the
// CUDA cores in f32 from shared memory (at most 67 TFLOP/s, and less: each
// 32 fused multiply-adds of a thread wait on 12 shared-memory loads), so it
// leaves the tensor cores, asynchronous copies (TMA or cp.async) and
// overlap of loads with compute on the table: wgmma with bf16 operands, the
// key and value tiles double-buffered, is the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;        // 16 row groups x 8 column lanes
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask fill

struct Shape {
  int64_t b, h, kvh, sq, skv, hd;
  int64_t qs[3], ks[3], vs[3];       // strides of dims 0..2 (the last is 1)
  int64_t causal, q_offset;
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBlockQ + 2 * kBlockK) * (HD + 1) + kBlockQ * (kBlockK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Shape s) {
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
  const T* qb = q + bi * s.qs[0] + hi * s.qs[2];
  const T* kb = k + bi * s.ks[0] + kv_head * s.ks[2];
  const T* vb = v + bi * s.vs[0] + kv_head * s.vs[2];

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int64_t row = q0 + r;
    qs[r * LD + c] = (row < s.sq && c < s.hd)
                         ? widen(qb[row * s.qs[1] + c]) * s.scale
                         : 0.f;
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
      ks[r * LD + c] = in ? widen(kb[key * s.ks[1] + c]) : 0.f;
      vs[r * LD + c] = in ? widen(vb[key * s.vs[1] + c]) : 0.f;
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
    T* out = o + ((bi * s.sq + row) * s.h + hi) * s.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = tx + 8 * c;
      if (ch < s.hd) narrow(out + ch, acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              const Shape& s, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(s.b * s.h),
                  (unsigned int)((s.sq + kBlockQ - 1) / kBlockQ));
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t h, int64_t kvh, int64_t sq, int64_t skv, int64_t hd,
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
           int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
           int64_t v_sh, int64_t causal, int64_t q_offset, void* stream) {
  if (b * h == 0 || sq == 0) return (int)cudaGetLastError();
  if (hd < 1 || hd > 128 || kvh < 1 || h % kvh != 0 || q_offset < 0 ||
      b * h > INT32_MAX || (sq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  Shape s{b, h, kvh, sq, skv, hd, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
          {v_sb, v_ss, v_sh}, causal, q_offset,
          (float)pow((double)hd, -0.5)};
  cudaStream_t st = (cudaStream_t)stream;
  return hd <= 64 ? launch_hd<T, 64>(q, k, v, o, s, st)
                  : launch_hd<T, 128>(q, k, v, o, s, st);
}

}  // namespace

#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      int64_t b, int64_t h, int64_t kvh, int64_t sq,        \
                      int64_t skv, int64_t hd, int64_t q_sb, int64_t q_ss,  \
                      int64_t q_sh, int64_t k_sb, int64_t k_ss,             \
                      int64_t k_sh, int64_t v_sb, int64_t v_ss,             \
                      int64_t v_sh, int64_t causal, int64_t q_offset,       \
                      void* stream) {                                       \
    return launch<T>(q, k, v, o, b, h, kvh, sq, skv, hd, q_sb, q_ss, q_sh,  \
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, q_offset,  \
                     stream);                                               \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
