// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_decode_attention.py
// (`_paged_decode_call`, pallas_call at :171, body `_paged_decode_kernel`
// :81): one query token per batch row against a shared pool of KV pages
// (P, ps, Hkv, hd) addressed through a (B, n) block table, positions at or
// past lengths[b] masked, page ids clipped to [0, P-1]. int8 and fp8-e4m3
// pools carry fp32 (P, ps, Hkv) scales and are dequantized in the kernel.
//
// What bounds it on an H100: bytes, as for dense decode: 4*G FLOPs per K/V
// element pair against 2-8 bytes read. The floor is the LIVE K/V rows
// (sum of lengths, not n*ps) over 3.35 TB/s, so quantized pools lower it.
//
// Design: one block per (kv head, batch row) serving the group's G query
// heads from each page read (decode_body in attention_common.cuh). The
// block walks only ceil(lengths[b] / 16) row tiles and reads each row's page
// id from the block table itself (the TPU kernel's scalar prefetch becomes
// a load of bt[b, j / ps]). 64 blocks at B = 8, Hkv = 8 leave most of the
// 132 SMs idle; splitting pages across blocks (flash-decoding plus a
// combine pass) is the next step for this kernel.
#include "attention_common.cuh"

struct PagedRows {
  const int32_t* bt;        // (B, n) page ids
  const int32_t* lengths;   // (B,) live tokens
  const float* ks;          // (P, ps, Hkv) or null
  const float* vs;
  int P, ps, n, Hkv, hd;
  __device__ int num_rows(int b) const {
    return max(0, min(n * ps, lengths[b]));
  }
  __device__ bool valid(int b, int j) const { return j < lengths[b]; }
  __device__ int slot(int b, int j) const {   // page * ps + offset
    const int page = min(max(bt[(size_t)b * n + j / ps], 0), P - 1);
    return page * ps + j % ps;
  }
  __device__ size_t offset(int b, int h, int j) const {
    return ((size_t)slot(b, j) * Hkv + h) * hd;
  }
  __device__ float k_scale(int b, int h, int j) const {
    return ks ? ks[(size_t)slot(b, j) * Hkv + h] : 1.f;
  }
  __device__ float v_scale(int b, int h, int j) const {
    return vs ? vs[(size_t)slot(b, j) * Hkv + h] : 1.f;
  }
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const TQ* q, const TKV* kp, const TKV* vp, TQ* out,
                    PagedRows rows, int H, float scale) {
  decode_body<TQ, TKV, PagedRows>(q, kp, vp, out, rows, H, rows.Hkv,
                                  rows.hd, scale);
}

template <typename TQ, typename TKV>
static int launch(const void* q, const void* kp, const void* vp,
                  PagedRows rows, void* out, int B, int H,
                  cudaStream_t stream) {
  const dim3 grid(rows.Hkv, B);
  const size_t smem = decode_smem_bytes(H / rows.Hkv, rows.hd);
  paged_decode_kernel<TQ, TKV><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<TQ*>(out), rows, H,
      1.0f / sqrtf(static_cast<float>(rows.hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
static int launch_q(const void* q, const void* kp, const void* vp,
                    PagedRows rows, void* out, int B, int H, int kv_dtype,
                    cudaStream_t st) {
  switch (kv_dtype) {
    case F32: return launch<TQ, float>(q, kp, vp, rows, out, B, H, st);
    case BF16: return launch<TQ, __nv_bfloat16>(q, kp, vp, rows, out, B, H, st);
    case I8: return launch<TQ, int8_t>(q, kp, vp, rows, out, B, H, st);
    case FP8E4M3:
      return launch<TQ, __nv_fp8_e4m3>(q, kp, vp, rows, out, B, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (B, 1, H, hd) F32|BF16; k_pages/v_pages: (P, ps, Hkv, hd) of kv_dtype;
// k_scale/v_scale: (P, ps, Hkv) fp32 or null; block_table: (B, n) int32;
// lengths: (B,) int32; out like q. Returns cudaGetLastError().
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* out, int B, int H, int Hkv, int hd, int P,
    int ps, int n, int q_dtype, int kv_dtype, void* stream) {
  PagedRows rows{static_cast<const int32_t*>(block_table),
                 static_cast<const int32_t*>(lengths),
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), P, ps, n, Hkv, hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == F32)
    return launch_q<float>(q, k_pages, v_pages, rows, out, B, H, kv_dtype,
                           st);
  if (q_dtype == BF16)
    return launch_q<__nv_bfloat16>(q, k_pages, v_pages, rows, out, B, H,
                                   kv_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
