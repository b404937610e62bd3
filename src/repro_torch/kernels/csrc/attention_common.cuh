// Shared pieces of the port's kernels: dtype codes, element conversions,
// warp reductions, and the one-query-token decode body that both decode
// kernels instantiate (dense cache: decode_attention.cu; paged pool:
// paged_decode_attention.cu). xmodal_score.cu uses the first three.
//
// Built for sm_90a by kernels/build.py with a plain C interface per .cu
// file; the Python wrappers in kernels/ops.py check shapes, dtypes and
// contiguity before they pass raw pointers here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with kernels/ops.py
enum DType { F32 = 0, BF16 = 1, I8 = 2, FP8E4M3 = 3 };

// The reference's masking constant (repro/kernels/*: NEG_INF = -1e30): the
// running max starts here, so a tile with no valid key leaves it in place
// and rescales the accumulator by exp(0) = 1.
#define NEG_INF_F (-1e30f)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --------------------------------------------------------------------------
// One query token against a run of KV rows (decode).
//
// One block per (kv head, batch row). The G = H / Hkv query heads of the kv
// head share every K/V tile the block reads, so the cache is read once per
// group, not once per query head. Rows stream through shared memory in
// tiles of DEC_TILE with an fp32 online softmax (running max m, sum l, and
// accumulator per query head). Invalid rows are never loaded and weigh
// exactly 0. `Rows` says how many rows a batch row has, which are valid,
// where row j lives, and its dequantization scales.
// --------------------------------------------------------------------------
constexpr int DEC_TILE = 16;
constexpr int DEC_THREADS = 128;
constexpr int DEC_MAX_G = 8;
constexpr int DEC_MAX_HD = 128;
constexpr int DEC_ACC = DEC_MAX_G * DEC_MAX_HD / DEC_THREADS;
constexpr int DEC_LOADS = DEC_TILE * DEC_MAX_HD / DEC_THREADS;

inline size_t decode_smem_bytes(int G, int hd) {
  return sizeof(float) * (G * hd + 2 * DEC_TILE * hd + G * DEC_TILE);
}

template <typename TQ, typename TKV, typename Rows>
__device__ void decode_body(const TQ* __restrict__ q,
                            const TKV* __restrict__ kc,
                            const TKV* __restrict__ vc, TQ* __restrict__ out,
                            const Rows& rows, int H, int Hkv, int hd,
                            float scale) {
  const int h = blockIdx.x;   // kv head
  const int b = blockIdx.y;   // batch row
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                       // (G, hd), pre-scaled
  float* ks = qs + G * hd;                // (DEC_TILE, hd)
  float* vs = ks + DEC_TILE * hd;         // (DEC_TILE, hd)
  float* ps = vs + DEC_TILE * hd;         // (G, DEC_TILE) scores, then p
  __shared__ float m_s[DEC_MAX_G], l_s[DEC_MAX_G], alpha_s[DEC_MAX_G];
  // per row of the tile: valid?, where its (kv head h) vector starts, and
  // its dequantization scales: resolved once per row, not per element
  __shared__ int valid_s[DEC_TILE];
  __shared__ size_t base_s[DEC_TILE];
  __shared__ float kscale_s[DEC_TILE], vscale_s[DEC_TILE];

  // q is (B, 1, H, hd): this group's heads are h*G .. h*G+G-1
  const size_t qbase = ((size_t)b * H + (size_t)h * G) * hd;
  for (int i = tid; i < G * hd; i += DEC_THREADS)
    qs[i] = to_float(q[qbase + i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG_INF_F;
    l_s[tid] = 0.f;
  }
  float acc[DEC_ACC];
#pragma unroll
  for (int a = 0; a < DEC_ACC; ++a) acc[a] = 0.f;

  const int nrows = rows.num_rows(b);
  for (int j0 = 0; j0 < nrows; j0 += DEC_TILE) {
    __syncthreads();   // previous tile fully consumed
    if (tid < DEC_TILE) {
      const int j = j0 + tid;
      const bool ok = j < nrows && rows.valid(b, j);
      valid_s[tid] = ok;
      if (ok) {
        base_s[tid] = rows.offset(b, h, j);
        kscale_s[tid] = rows.k_scale(b, h, j);
        vscale_s[tid] = rows.v_scale(b, h, j);
      }
    }
    __syncthreads();
    // every load of the tile is issued before any is stored, so the
    // thread waits on device memory once per tile, not once per element
    float kx[DEC_LOADS], vx[DEC_LOADS];
#pragma unroll
    for (int a = 0; a < DEC_LOADS; ++a) {
      const int i = tid + a * DEC_THREADS;
      kx[a] = vx[a] = 0.f;
      if (i < DEC_TILE * hd) {
        const int r = i / hd, d = i - r * hd;
        if (valid_s[r]) {
          kx[a] = to_float(kc[base_s[r] + d]) * kscale_s[r];
          vx[a] = to_float(vc[base_s[r] + d]) * vscale_s[r];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < DEC_LOADS; ++a) {
      const int i = tid + a * DEC_THREADS;
      if (i < DEC_TILE * hd) {
        ks[i] = kx[a];
        vs[i] = vx[a];
      }
    }
    __syncthreads();
    // scores: one warp per (head, row) pair, lanes split the head dim
    for (int p = warp; p < G * DEC_TILE; p += DEC_THREADS / 32) {
      const int g = p / DEC_TILE, r = p - g * DEC_TILE;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += qs[g * hd + d] * ks[r * hd + d];
      s = warp_sum(s);
      if (lane == 0) ps[p] = s;
    }
    __syncthreads();
    if (tid < G) {   // online softmax update, one thread per query head
      const int g = tid;
      const float m_old = m_s[g];
      float m_t = NEG_INF_F;
      for (int r = 0; r < DEC_TILE; ++r)
        if (valid_s[r]) m_t = fmaxf(m_t, ps[g * DEC_TILE + r]);
      const float m_new = fmaxf(m_old, m_t);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int r = 0; r < DEC_TILE; ++r) {
        const float pr =
            valid_s[r] ? expf(ps[g * DEC_TILE + r] - m_new) : 0.f;
        ps[g * DEC_TILE + r] = pr;
        sum += pr;
      }
      l_s[g] = alpha * l_s[g] + sum;
      m_s[g] = m_new;
      alpha_s[g] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < DEC_ACC; ++a) {
      const int idx = tid + a * DEC_THREADS;
      if (idx < G * hd) {
        const int g = idx / hd, d = idx - g * hd;
        float v = acc[a] * alpha_s[g];
#pragma unroll 4
        for (int r = 0; r < DEC_TILE; ++r)
          v += ps[g * DEC_TILE + r] * vs[r * hd + d];
        acc[a] = v;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < DEC_ACC; ++a) {
    const int idx = tid + a * DEC_THREADS;
    if (idx < G * hd) {
      const int g = idx / hd;
      out[qbase + idx] = from_float<TQ>(acc[a] / fmaxf(l_s[g], 1e-20f));
    }
  }
}
