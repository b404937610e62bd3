// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// (`decode_attention`, pallas_call at :81, body `_decode_kernel` :25): one
// query token per batch row against a dense (B, S, Hkv, hd) KV cache under
// the caller's (B, S) validity mask (ring-buffer validity and window).
//
// What bounds it on an H100: bytes. Each K/V element read is used by G = H/Hkv
// query heads for 2 FLOPs each (4*G FLOPs per element pair: at most 32 per
// 8 bytes of fp32), far below the ~20 FLOP/byte the card needs to be
// limited by fp32 arithmetic, so the floor is the valid K/V rows over
// 3.35 TB/s. Tensor cores do not help: G <= 8 query rows per kv head
// would fill 8 of a wgmma tile's 64 rows, and the products are not what
// takes the time. A kv head with more query heads than that (granite-34b:
// 48 over one) runs them in groups of at most 8, a block each
// (GroupedRows, launch_decode): its rows are read once a group, all but
// the first group's mostly from the L2.
//
// Design: split-KV ("flash-decoding", split_decode_body and its launcher
// launch_split_decode in attention_common.cuh, which the paged kernel
// shares). The TPU kernel walks the cache axis as a
// sequential grid axis; one block per (kv head, batch row) doing the same
// gives 64 blocks for 132 SMs at the serving shape (B 8, Hkv 8), each
// waiting on its tiles in turn. Here the grid is (kv head, batch row,
// split), with the split count planned on the host (ops.decode_splits) so
// that the grid fills the card; every block still serves all G query
// heads of its kv head from each K/V row it reads, so the cache is read
// once per group. Each warp streams its rows through a double-buffered
// cp.async ring with 16-byte copies and keeps its online softmax in
// registers.
// With more than one split, split_combine_body merges the splits'
// partials from the fp32 workspace in split order in a second kernel.
// Masked rows are never read.
// Head dims above 128 (recurrentgemma-2b's local attention: hd 256, 10
// query heads over one kv head, run as 2 groups of 5) take the body's
// wide instantiation (split_decode_wide_kernel, MAXHD 256): 8 dims a lane
// of each query head in registers, 64 KB of stage rings at fp32, one
// block an SM's worth of registers. The hd <= 128 kernels are compiled as
// before.
#include "attention_common.cuh"

struct DenseRows {
  const uint8_t* mask;   // (B, S) bool
  int S, Hkv, hd;
  static constexpr bool TILE_KEYS = false;
  __host__ __device__ int capacity() const { return S; }
  __device__ int num_rows(int) const { return S; }
  // bits of rows j..j+3 that are valid and below jend: one 4-byte load of
  // the mask where the four bytes are whole and aligned
  __device__ unsigned valid4(int b, int j, int jend) const {
    const uint8_t* m = mask + (size_t)b * S + j;
    if (j + 4 <= jend && (reinterpret_cast<uintptr_t>(m) & 3) == 0) {
      const unsigned w = *reinterpret_cast<const unsigned*>(m);
      return ((w & 0xffu) ? 1u : 0u) | ((w & 0xff00u) ? 2u : 0u) |
             ((w & 0xff0000u) ? 4u : 0u) | ((w & 0xff000000u) ? 8u : 0u);
    }
    unsigned bits = 0;
    for (int r = 0; r < 4 && j + r < jend; ++r)
      if (m[r]) bits |= 1u << r;
    return bits;
  }
  __device__ size_t offset(int b, int h, int j, int) const {
    return (((size_t)b * S + j) * Hkv + h) * hd;
  }
  __device__ const float* k_scales() const { return nullptr; }
  __device__ const float* v_scales() const { return nullptr; }
  __device__ size_t scale_index(int, int, int, int) const { return 0; }
};

template <typename T>
static int launch_dense(const SplitLaunch& a, const DenseRows& rows) {
  if (rows.hd > DEC_MAX_HD) return launch_decode<T, T, DEC_WIDE_HD>(a, rows);
  return launch_decode<T, T>(a, rows);
}

// q: (B, 1, H, hd); k/v: (B, S, Hkv, hd), hd <= 256; mask: (B, S) uint8;
// out like q;
// work: fp32 (B, Hkv, n_split, H / Hkv, hd + 2) floats, unused (may be
// null) when n_split is 1 (grouped heads lay them out as (B, Hkv, groups,
// n_split, G / groups, hd + 2)). The split plan (n_split, rows_per_split)
// comes from ops.decode_splits over Hkv * ops.decode_groups(H / Hkv)
// heads: rows_per_split a multiple of 16, n_split * rows_per_split >= S,
// n_split <= 64. dtype: F32 or BF16 (q, k, v and out alike). Returns
// cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* work,
                                int B, int S, int H, int Hkv, int hd,
                                int n_split, int rows_per_split, int dtype,
                                void* stream) {
  const SplitLaunch a{q, k, v, out, static_cast<float*>(work), B, H,
                      n_split, rows_per_split,
                      static_cast<cudaStream_t>(stream)};
  const DenseRows rows{static_cast<const uint8_t*>(mask), S, Hkv, hd};
  if (dtype == F32) return launch_dense<float>(a, rows);
  if (dtype == BF16) return launch_dense<__nv_bfloat16>(a, rows);
  return static_cast<int>(cudaErrorInvalidValue);
}
