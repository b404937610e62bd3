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
// takes the time.
//
// Design: split-KV ("flash-decoding", split_decode_body in
// attention_common.cuh). The TPU kernel walks the cache axis as a
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
#include "attention_common.cuh"

struct DenseRows {
  const uint8_t* mask;   // (B, S) bool
  int S, Hkv, hd;
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
  __device__ size_t offset(int b, int h, int j) const {
    return (((size_t)b * S + j) * Hkv + h) * hd;
  }
  __device__ float k_scale(int, int, int) const { return 1.f; }
  __device__ float v_scale(int, int, int) const { return 1.f; }
};

// the registers must allow 6, 5 or 4 blocks per SM (the shared memory of
// hd 128 fp32 allows 6): the queries and accumulators take 8 * GP a thread
template <typename T, int GP, int U>
__global__ void __launch_bounds__(SPL_THREADS,
                                  (GP <= 2 ? 6 : GP == 4 ? 5 : 4))
decode_split_kernel(const T* q, const T* k, const T* v, T* out, float* part,
                    DenseRows rows, int H, int rows_per_split, float scale) {
  split_decode_body<GP, U, T, T, DenseRows>(q, k, v, out, part, rows, H,
                                            rows.Hkv, rows.hd,
                                            rows_per_split, scale);
}

template <typename T>
__global__ void __launch_bounds__(SPL_THREADS)
decode_combine_kernel(const float* part, T* out, int H, int Hkv, int hd,
                      int n_split) {
  split_combine_body<T>(part, out, H, Hkv, hd, n_split);
}

template <typename T, int GP, int U>
static int launch_split(const void* q, const void* k, const void* v,
                        void* out, float* part, DenseRows rows, int B, int H,
                        int n_split, int rows_per_split,
                        cudaStream_t stream) {
  auto kernel = decode_split_kernel<T, GP, U>;
  const size_t smem = split_smem_bytes(H / rows.Hkv, rows.hd, sizeof(T));
  const dim3 grid(rows.Hkv, B, n_split);
  kernel<<<grid, SPL_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part, rows, H,
      rows_per_split, 1.0f / sqrtf(static_cast<float>(rows.hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int U>
static int launch_g(const void* q, const void* k, const void* v, void* out,
                    float* part, DenseRows rows, int B, int H, int n_split,
                    int rows_per_split, cudaStream_t st) {
  const int G = H / rows.Hkv;
  if (G == 1)
    return launch_split<T, 1, U>(q, k, v, out, part, rows, B, H, n_split,
                                 rows_per_split, st);
  if (G == 2)
    return launch_split<T, 2, U>(q, k, v, out, part, rows, B, H, n_split,
                                 rows_per_split, st);
  if (G <= 4)
    return launch_split<T, 4, U>(q, k, v, out, part, rows, B, H, n_split,
                                 rows_per_split, st);
  return launch_split<T, 8, U>(q, k, v, out, part, rows, B, H, n_split,
                               rows_per_split, st);
}

static bool aligned(const void* p, unsigned n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* mask, void* out, void* work, int B, int S,
                  int H, int Hkv, int hd, int n_split, int rows_per_split,
                  cudaStream_t st) {
  if (H % Hkv != 0 || H / Hkv > DEC_MAX_G || hd > DEC_MAX_HD || n_split < 1 ||
      n_split > DEC_MAX_SPLIT || rows_per_split % DEC_TILE != 0 ||
      (long)n_split * rows_per_split < S || (n_split > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DenseRows rows{static_cast<const uint8_t*>(mask), S, Hkv, hd};
  float* part = n_split > 1 ? static_cast<float*>(work) : nullptr;
  // copy unit: 16 bytes where a row's byte length and both bases allow
  const int nb = hd * static_cast<int>(sizeof(T));
  int err;
  if (nb % 16 == 0 && aligned(k, 16) && aligned(v, 16))
    err = launch_g<T, 16>(q, k, v, out, part, rows, B, H, n_split,
                          rows_per_split, st);
  else if (nb % 4 == 0 && aligned(k, 4) && aligned(v, 4))
    err = launch_g<T, 4>(q, k, v, out, part, rows, B, H, n_split,
                         rows_per_split, st);
  else
    err = launch_g<T, 2>(q, k, v, out, part, rows, B, H, n_split,
                         rows_per_split, st);
  if (err != 0 || n_split == 1) return err;
  decode_combine_kernel<T><<<dim3(Hkv, B), SPL_THREADS, 0, st>>>(
      part, static_cast<T*>(out), H, Hkv, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

// q: (B, 1, H, hd); k/v: (B, S, Hkv, hd); mask: (B, S) uint8; out like q;
// work: fp32 (B, Hkv, n_split, H / Hkv, hd + 2), unused (may be null) when
// n_split is 1. The split plan (n_split, rows_per_split) comes from
// ops.decode_splits: rows_per_split a multiple of 16, n_split *
// rows_per_split >= S, n_split <= 64. dtype: F32 or BF16 (q, k, v and out
// alike). Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* work,
                                int B, int S, int H, int Hkv, int hd,
                                int n_split, int rows_per_split, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch<float>(q, k, v, mask, out, work, B, S, H, Hkv, hd, n_split,
                         rows_per_split, st);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, work, B, S, H, Hkv, hd,
                                 n_split, rows_per_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
