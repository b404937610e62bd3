// Prefill (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, pallas_call at :89, body `_flash_kernel` :24):
// softmax(q k^T * hd^-0.5) v over a whole prompt with a causal mask and an
// optional sliding window (rel < window), kv padding masked, fp32 online
// softmax. It reads grouped K/V (B, L, Hkv, hd) directly: query head h uses
// kv head h / (H / Hkv), so the expanded copy the TPU path builds
// (`_expand_kv`) never exists. Unlike the TPU kernel it takes optional
// per-row key lengths: keys at or past kv_len[b] are masked, as the
// reference's plain path masks them in a length-bucketed prefill
// (repro/models/transformer.py:324). Real rows of such a bucket never see
// those keys anyway; the pad rows then do not either, so their hidden
// states, which choose experts and compete for expert capacity in an MoE
// layer, equal the plain path's.
//
// What bounds it on an H100: operations. A 64-row query tile does
// 4 * 64 * hd FLOPs per key row it reads, well above the card's
// FLOP-per-byte balance at serving prompt lengths. This simple version
// runs those FLOPs on the fp32 CUDA cores (67 TFLOP/s peak), not the
// tensor cores; wgmma tiles fed by TMA are the next step.
//
// Design: one block of 256 threads per (64-row query tile, head, batch
// row). Key/value tiles of 64 rows stream through shared memory in fp32; a
// 16 x 16 thread grid holds a 4 x 4 score micro-tile per thread and a
// 4 x hd/16 slice of the output accumulator. Key tiles that the causal mask
// or the window removes entirely are never loaded.
#include "attention_common.cuh"

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;

template <int HD>
constexpr size_t flash_smem_bytes() {
  // Qs (BQ, HD+1) + Ks (BK, HD+1) + Vs (BK, HD) + Ps (BQ, BK), fp32
  return sizeof(float) *
         (FA_BQ * (HD + 1) + FA_BK * (HD + 1) + FA_BK * HD + FA_BQ * FA_BK);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             T* __restrict__ o, int L, int H, int Hkv, float scale,
             int causal, int window) {
  constexpr int QS = HD + 1;       // padded row strides: no bank conflicts
  constexpr int CW = HD / 16;      // output columns per thread
  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // 16 lanes of a half-warp share ty
  const int klen = kv_len ? min(L, kv_len[b]) : L;   // keys [0, klen) valid

  extern __shared__ float sm[];
  float* Qs = sm;                    // (BQ, QS) pre-scaled
  float* Ks = Qs + FA_BQ * QS;       // (BK, QS)
  float* Vs = Ks + FA_BK * QS;       // (BK, HD)
  float* Ps = Vs + FA_BK * HD;       // (BQ, BK)

  for (int i = tid; i < FA_BQ * HD; i += FA_THREADS) {
    const int r = i / HD, d = i - r * HD;
    const int qp = q0 + r;
    Qs[r * QS + d] =
        qp < L ? to_float(q[(((size_t)b * L + qp) * H + h) * HD + d]) * scale
               : 0.f;
  }

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  // key tiles that can hold an unmasked key for some query of this tile
  const int kend = causal ? min(klen, q0 + FA_BQ) : klen;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) / FA_BK * FA_BK : 0;

  for (int k0 = kbeg; k0 < kend; k0 += FA_BK) {
    __syncthreads();   // previous tile consumed (and Q stored on entry)
    for (int i = tid; i < FA_BK * HD; i += FA_THREADS) {
      const int r = i / HD, d = i - r * HD;
      const int kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < klen) {
        const size_t off = (((size_t)b * L + kp) * Hkv + hk) * HD + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx * 4 + j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float m_t = NEG_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        ok[j] = kp < klen && (!causal || qp >= kp) &&
                (window <= 0 || qp - kp < window);
        if (ok[j]) m_t = fmaxf(m_t, s[i][j]);
      }
      m_t = half_warp_max(m_t);
      const float m_new = fmaxf(m[i], m_t);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * FA_BK + tx * 4 + j] = p;
        psum += p;
      }
      psum = half_warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V: thread owns rows ty*4..+3 and columns c*16 + tx
#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * FA_BK + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vv = Vs[j * HD + c * 16 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= L) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* dst = o + (((size_t)b * L + qp) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < CW; ++c) dst[c * 16 + tx] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v,
                  const int* kv_len, void* out, int B, int L, int H, int Hkv,
                  int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + FA_BQ - 1) / FA_BQ, H, B);
  flash_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), L, H, Hkv,
      1.0f / sqrtf(static_cast<float>(HD)), causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_hd(const void* q, const void* k, const void* v,
                     const int* kl, void* out, int B, int L, int H, int Hkv,
                     int hd, int causal, int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, kl, out, B, L, H, Hkv, causal, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (B, L, H, hd); k/v: (B, L, Hkv, hd), Hkv | H; kv_len: (B,) int32 in
// [1, L], or null for all L keys; out like q. dtype: F32 or BF16; hd in
// {16, 32, 64, 128}. Returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, int B, int L,
                               int H, int Hkv, int hd, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  if (dtype == F32)
    return launch_hd<float>(q, k, v, kl, out, B, L, H, Hkv, hd, causal,
                            window, st);
  if (dtype == BF16)
    return launch_hd<__nv_bfloat16>(q, k, v, kl, out, B, L, H, Hkv, hd,
                                    causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
