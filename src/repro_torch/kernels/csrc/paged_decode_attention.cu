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
// Design: the split-KV body and launcher that the dense decode kernel
// runs (split_decode_body, launch_split_decode in attention_common.cuh),
// on a grid of (kv head, batch row, split). The TPU kernel walks a row's
// pages as a sequential grid axis with the block table as scalar
// prefetch; here the plan (ops.decode_splits over the block table's
// capacity n * ps) comes from shapes alone, since reading the lengths on
// the host would wait for the device at every decode step. Splits past a
// row's length copy nothing and weigh nothing in the combine; lengths past
// n * ps are clipped. Every block serves the G query heads of its kv head
// from each row it reads, or, where G > 8 (granite-34b: 48 over one kv
// head), a group of at most 8 of them (GroupedRows, launch_decode). With
// pages of a multiple of 16 rows a 16-row tile lies in one page, so the
// body loads each tile's page id from the block table a chunk of 32 tiles
// ahead, beside the validity words, and no copy waits on the table; other
// page sizes look the page up per row.
// int8/fp8 rows are hd bytes, copied in 16-, 4- or 1-byte units; their
// scales ride in the rows' cp.async group.
#include "attention_common.cuh"

struct PagedRows {
  const int32_t* bt;        // (B, n) page ids
  const int32_t* lengths;   // (B,) live tokens
  const float* ks;          // (P, ps, Hkv) or null
  const float* vs;
  int P, ps, n, Hkv, hd;
  static constexpr bool TILE_KEYS = true;
  __host__ __device__ int capacity() const { return n * ps; }
  __device__ int num_rows(int b) const {
    return max(0, min(n * ps, lengths[b]));
  }
  __device__ unsigned valid4(int b, int j, int jend) const {
    const int e = min(lengths[b], jend) - j;
    return e >= 4 ? 0xfu : e <= 0 ? 0u : (1u << e) - 1u;
  }
  __device__ int page(int b, int j) const {
    return min(max(bt[(size_t)b * n + j / ps], 0), P - 1);
  }
  // the slot (page * ps + offset) of the tile's first row j where the
  // tile lies in one page, else -1
  __device__ int tile_key(int b, int j) const {
    return ps % DEC_TILE == 0 ? page(b, j) * ps + j % ps : -1;
  }
  __device__ int slot(int b, int j, int key) const {
    return key >= 0 ? key + (j & (DEC_TILE - 1)) : page(b, j) * ps + j % ps;
  }
  __device__ size_t offset(int b, int h, int j, int key) const {
    return ((size_t)slot(b, j, key) * Hkv + h) * hd;
  }
  __device__ const float* k_scales() const { return ks; }
  __device__ const float* v_scales() const { return vs; }
  __device__ size_t scale_index(int b, int h, int j, int key) const {
    return (size_t)slot(b, j, key) * Hkv + h;
  }
};

template <typename TQ>
static int launch_q(const SplitLaunch& a, const PagedRows& rows,
                    int kv_dtype) {
  switch (kv_dtype) {
    case F32: return launch_decode<TQ, float>(a, rows);
    case BF16: return launch_decode<TQ, __nv_bfloat16>(a, rows);
    case I8: return launch_decode<TQ, int8_t>(a, rows);
    case FP8E4M3: return launch_decode<TQ, __nv_fp8_e4m3>(a, rows);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (B, 1, H, hd) F32|BF16; k_pages/v_pages: (P, ps, Hkv, hd) of kv_dtype;
// k_scale/v_scale: (P, ps, Hkv) fp32 or null; block_table: (B, n) int32;
// lengths: (B,) int32; out like q; work: fp32 (B, Hkv, n_split, H / Hkv,
// hd + 2) floats, unused (may be null) when n_split is 1 (laid out as in
// decode_attention.cu). The split plan comes from ops.decode_splits over
// n * ps and Hkv * ops.decode_groups(H / Hkv) heads: rows_per_split a
// multiple of 16, n_split * rows_per_split >= n * ps, n_split <= 64.
// Returns cudaGetLastError().
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* out, void* work, int B, int H, int Hkv,
    int hd, int P, int ps, int n, int n_split, int rows_per_split,
    int q_dtype, int kv_dtype, void* stream) {
  const SplitLaunch a{q, k_pages, v_pages, out, static_cast<float*>(work),
                      B, H, n_split, rows_per_split,
                      static_cast<cudaStream_t>(stream)};
  const PagedRows rows{static_cast<const int32_t*>(block_table),
                       static_cast<const int32_t*>(lengths),
                       static_cast<const float*>(k_scale),
                       static_cast<const float*>(v_scale), P, ps, n, Hkv, hd};
  if (q_dtype == F32) return launch_q<float>(a, rows, kv_dtype);
  if (q_dtype == BF16) return launch_q<__nv_bfloat16>(a, rows, kv_dtype);
  return static_cast<int>(cudaErrorInvalidValue);
}
