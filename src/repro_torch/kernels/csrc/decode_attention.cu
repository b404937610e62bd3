// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// (`decode_attention`, pallas_call at :81, body `_decode_kernel` :25): one
// query token per batch row against a dense (B, S, Hkv, hd) KV cache under
// the caller's (B, S) validity mask (ring-buffer validity and window).
//
// What bounds it on an H100: bytes. Each K/V element read is used by G = H/Hkv
// query heads for 2 FLOPs each (4*G FLOPs per element pair), far below the
// ~20 FLOP/byte the card needs to be limited by fp32 arithmetic, so the
// floor is the valid K/V rows over 3.35 TB/s.
//
// Design: one block per (kv head, batch row) serving all G query heads of
// that kv head from each K/V tile it reads (decode_body in
// attention_common.cuh), so the cache is read once per group. Masked rows
// are never loaded. At the serving shapes (B = 8, Hkv = 8) that is only 64
// blocks for 132 SMs: splitting S across blocks (flash-decoding) is the
// next step for this kernel.
#include "attention_common.cuh"

struct DenseRows {
  const uint8_t* mask;   // (B, S) bool
  int S, Hkv, hd;
  __device__ int num_rows(int) const { return S; }
  __device__ bool valid(int b, int j) const {
    return mask[(size_t)b * S + j] != 0;
  }
  __device__ size_t offset(int b, int h, int j) const {
    return (((size_t)b * S + j) * Hkv + h) * hd;
  }
  __device__ float k_scale(int, int, int) const { return 1.f; }
  __device__ float v_scale(int, int, int) const { return 1.f; }
};

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const T* q, const T* k, const T* v, T* out, DenseRows rows,
              int H, float scale) {
  decode_body<T, T, DenseRows>(q, k, v, out, rows, H, rows.Hkv, rows.hd,
                               scale);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* mask, void* out, int B, int S, int H, int Hkv,
                  int hd, cudaStream_t stream) {
  DenseRows rows{static_cast<const uint8_t*>(mask), S, Hkv, hd};
  const dim3 grid(Hkv, B);
  const size_t smem = decode_smem_bytes(H / Hkv, hd);
  decode_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), rows, H,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

// q: (B, 1, H, hd); k/v: (B, S, Hkv, hd); mask: (B, S) uint8; out like q.
// dtype: F32 or BF16 (q, k, v and out alike). Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int B, int S,
                                int H, int Hkv, int hd, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch<float>(q, k, v, mask, out, B, S, H, Hkv, hd, st);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, S, H, Hkv, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
