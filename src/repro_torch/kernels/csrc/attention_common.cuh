// Shared pieces of the port's kernels: dtype codes, element conversions,
// warp reductions, the TF32 tensor-core helpers of the prefill kernel and
// the cross-modal max, and the split-KV decode kernels with their
// launcher, which both decode kernels instantiate through a `Rows` type
// that says where a batch row's KV rows lie (dense cache:
// decode_attention.cu; paged pool: paged_decode_attention.cu).
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

inline bool aligned(const void* p, unsigned n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// --------------------------------------------------------------------------
// TF32 tensor-core products (mma.sync m16n8k8), fp32 as 3xTF32, and the
// fragment loads and quad reductions around them: the prefill kernel
// (flash_attention.cu) and the cross-modal max (xmodal_score.cu).
// --------------------------------------------------------------------------
// the smallest row stride >= hd elements that is r modulo m
__host__ __device__ constexpr int pad_to(int hd, int r, int m) {
  return hd + ((r - hd) % m + m) % m;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero), in two integer operations: cvt.rna compiles to
// about four, with checks for infinities and NaN that finite scores and
// inputs do not need
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x) and lo = x - hi (exact in fp32), which the tensor core reads
// as TF32 by ignoring its low 13 bits; with SPLIT false (bf16 inputs, exact
// in TF32) hi is x's own bits and lo is unused
template <bool SPLIT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = to_tf32(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
  }
}

// d += a b on one m16n8k8 tile: a (16 x 8, row) in 4 registers, b (8 x 8,
// col) in 2, d (16 x 8) in 4 fp32 registers
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 (small terms first), or in one pass without SPLIT
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (SPLIT) {
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
  }
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --------------------------------------------------------------------------
// Split-KV decode ("flash-decoding"): one query token against one split of
// a batch row's KV rows, for the G query heads of one kv head (G <= 8;
// launch_decode cuts a larger G into groups, GroupedRows).
//
// Grid (kv head, batch row, split). Split s takes rows [s * rows_per_split,
// min(num_rows, (s + 1) * rows_per_split)), whole DEC_TILE-row tiles but
// for a ragged last one. Each of the block's SPL_WARPS warps takes
// SPL_WROWS rows of every tile and runs on its own: it copies its rows of
// K and V into its own ring of SPL_STAGES shared-memory stages with
// cp.async (16-byte units where the row's byte length and the bases allow
// it), SPL_STAGES - 1 tiles ahead of the tile it computes, and keeps an
// fp32 online softmax (running max m and sum l of its lanes' head, and
// its lanes' head dims of each query head's accumulator) in registers. So
// no block-wide barrier runs per tile; the warps' (m, l, acc) are merged
// once at the end, in warp order. A lane holds head dims lane + 32 i of
// every query head; the 4 * GP dot products of a tile are summed across
// the warp with one reduce-scatter (31 shuffles for GP = 8), after which
// lane L holds the score of row L / 8 for head (L / (8 / GP)) % GP.
//
// Invalid rows are never read: their copies zero-fill the stage (cp.async
// with a source size of 0), and their weight is exactly 0. The validity
// of the warp's 4 rows of a tile comes from Rows::valid4 as one word; lane
// l holds the word of tile 32 c + l, and the next 32 tiles' words are
// loaded a whole chunk ahead. Where Rows::TILE_KEYS is set, lane l also
// holds the tile's key (for the paged pool, where the tile lies: its page
// read from the block table), so no copy waits on an index load.
// Dequantization scales ride in the same cp.async group as their rows.
//
// With one split the block writes acc / max(l, 1e-20) in q's dtype itself;
// otherwise it writes (acc, m, l) per query head to the fp32 workspace
// (B, Hkv, n_split, G, hd + 2) and split_combine_body merges the splits
// in split order, so two runs give the same bits. A split (or a warp)
// without a valid row has m = NEG_INF_F, l = 0 and acc = 0 and weighs
// exp(NEG_INF_F - M) = 0 beside one that has. A batch row without a valid
// row (l = 0 after the merge; any valid row makes l >= 1) gets what the
// plain versions give it (write_empty_row): all query heads of a block
// share their rows' validity, so one block-uniform test of head 0's l, in
// the combine or in a one-split block, sends such a row there before the
// merge.
//
// `Rows` says where a batch row's KV rows lie:
//   num_rows(b)                rows [0, num_rows) may be valid;
//   capacity()                 (host) the most rows a batch row has: the
//                              plan's n_split * rows_per_split covers it;
//   valid4(b, j, jend)         bit r set where row j + r is valid and
//                              below jend;
//   TILE_KEYS                  whether tile_key(b, j) is loaded for each
//                              tile (j its first row) and handed to the
//                              tile's row lookups (0 is handed otherwise);
//   offset(b, h, j, key)       element offset of row j's kv head h;
//   k_scales(), v_scales()     dequantization scales, or null;
//   scale_index(b, h, j, key)  row j's index into them.
// A key of -1 makes offset and scale_index look row j up on its own.
//
// The widest head a body takes is its template parameter MAXHD (a lane
// holds MAXHD / 32 dims of each query head): DEC_MAX_HD for both kernels'
// usual bodies, DEC_WIDE_HD for the dense kernel's hd-256 body
// (split_decode_wide_kernel), whose two-stage rings take 64 KB of shared
// memory at fp32 and opt in past the 48 KB default.
// --------------------------------------------------------------------------
constexpr int DEC_TILE = 16;      // rows per tile
constexpr int DEC_MAX_G = 8;      // query heads per kv head
constexpr int DEC_MAX_HD = 128;   // head dim
constexpr int DEC_WIDE_HD = 256;  // head dim of the dense kernel's wide body
constexpr int SPL_WARPS = 4;
constexpr int SPL_THREADS = 32 * SPL_WARPS;
constexpr int SPL_WROWS = DEC_TILE / SPL_WARPS;   // rows per warp per tile
constexpr int SPL_STAGES = 2;
constexpr int DEC_MAX_SPLIT = 64;                 // ops.py plans at most this
// head dims a lane holds in a body of widest head MAXHD (a namespace-scope
// constant, not a local one: a local constexpr changed the code nvcc made
// of the hd <= 128 kernels)
template <int MAXHD>
constexpr int spl_ni = MAXHD / 32;

__host__ __device__ constexpr int spl_row_bytes(int hd, int elem) {
  return (hd * elem + 15) / 16 * 16;
}

// dynamic shared memory of split_decode_body: the warps' stage rings, or
// the merge area that reuses them
constexpr size_t split_smem_bytes(int G, int hd, int elem) {
  const size_t stages = (size_t)SPL_WARPS * SPL_STAGES * SPL_WROWS * 2 *
                        spl_row_bytes(hd, elem);
  const size_t merge = sizeof(float) * SPL_WARPS * G * (hd + 2);
  return stages > merge ? stages : merge;
}

struct SplitWarpScratch {
  unsigned vw[SPL_STAGES];                  // validity word of each stage
  float ksc[SPL_STAGES][SPL_WROWS], vsc[SPL_STAGES][SPL_WROWS];
  float p[SPL_WROWS * DEC_MAX_G];           // weights of the tile's rows
  float alpha[DEC_MAX_G];                   // rescale of each head's acc
};
// the largest case the launchers take fits the 48 KB a block may use
// without opting in to more
static_assert(split_smem_bytes(DEC_MAX_G, DEC_MAX_HD, sizeof(float)) +
                      SPL_WARPS * sizeof(SplitWarpScratch) <=
                  48 * 1024,
              "split_decode_body's shared memory exceeds 48 KB");
// the wide body's, with its opt-in, fits the 227 KB a block may use
static_assert(split_smem_bytes(DEC_MAX_G, DEC_WIDE_HD, sizeof(float)) +
                      SPL_WARPS * sizeof(SplitWarpScratch) <=
                  232448,
              "the wide split_decode_body's shared memory exceeds 227 KB");

// Copy U bytes from global to shared memory, or U zero bytes when !ok
// (nothing is read then). U = 16 and 4 are asynchronous (cp.async); U = 2
// and 1, for rows of 2- or 1-byte elements whose byte length is odd or
// not a multiple of 4, are plain copies.
template <int U>
__device__ __forceinline__ void copy_unit(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (U == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  } else if constexpr (U == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0) : "memory");
  } else if constexpr (U == 2) {
    *static_cast<uint16_t*>(dst) =
        ok ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  } else {
    static_assert(U == 1, "copy units of 16, 4, 2 or 1 bytes");
    *static_cast<uint8_t*>(dst) =
        ok ? *static_cast<const uint8_t*>(src) : uint8_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum N values per lane over the warp so that lane L ends with the sum of
// value L >> (5 - log2 N): each step keeps half of the values (the upper
// half on lanes whose bit O is set) and adds the partner's; once one
// value is left, the remaining steps sum it whole.
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const float send = up ? v[j] : v[j + N / 2];
        const float keep = up ? v[j + N / 2] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

// The output of a batch row with no valid row, for the G query heads of
// kv head h: the plain versions' softmax over scores that are all NEG_INF
// weighs every row alike, so each head gets the mean over rows
// [0, capacity()) of V's kv head h, dequantized. Not inlined: only an empty
// row calls it, and the kernels' served path compiles as without it.
template <typename TQ, typename TKV, typename Rows>
__device__ __noinline__ void write_empty_row(const TKV* __restrict__ vc,
                                             Rows rows, TQ* __restrict__ out,
                                             size_t qbase, int b, int h,
                                             int G, int hd) {
  const int n = rows.capacity();
  const float* vs = rows.v_scales();
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      float x = to_float(vc[rows.offset(b, h, j, -1) + d]);
      if (vs != nullptr) x *= vs[rows.scale_index(b, h, j, -1)];
      sum += x;
    }
    const TQ mean = from_float<TQ>(sum / static_cast<float>(n));
    for (int g = 0; g < G; ++g) out[qbase + (size_t)g * hd + d] = mean;
  }
}

template <int GP, int U, typename TQ, typename TKV, typename Rows,
          int MAXHD = DEC_MAX_HD>
__device__ void split_decode_body(const TQ* __restrict__ q,
                                  const TKV* __restrict__ kc,
                                  const TKV* __restrict__ vc,
                                  TQ* __restrict__ out,
                                  float* __restrict__ part, const Rows& rows,
                                  int H, int Hkv, int hd, int rows_per_split,
                                  float scale) {
  static_assert(GP == 1 || GP == 2 || GP == 4 || GP == 8, "GP: 1, 2, 4, 8");
  constexpr int LOG_GP = GP == 1 ? 0 : GP == 2 ? 1 : GP == 4 ? 2 : 3;
  constexpr unsigned FULL = 0xffffffffu;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char spl_smem[];
  __shared__ SplitWarpScratch scratch[SPL_WARPS];
  SplitWarpScratch& sw = scratch[warp];
  const int rb = spl_row_bytes(hd, sizeof(TKV));
  unsigned char* kbuf =
      spl_smem + (size_t)warp * SPL_STAGES * SPL_WROWS * 2 * rb;
  unsigned char* vbuf = kbuf + SPL_STAGES * SPL_WROWS * rb;
  const int units = hd * (int)sizeof(TKV) / U;    // copy units per row

  const int j0 = split * rows_per_split;
  const int j1 = min(rows.num_rows(b), j0 + rows_per_split);
  const int ntiles = j1 > j0 ? (j1 - j0 + DEC_TILE - 1) / DEC_TILE : 0;

  // this lane's head dims of the group's queries, pre-scaled; heads past G
  // (GP pads G up to a power of two) are zero and never weigh anything
  const size_t qbase = ((size_t)b * H + (size_t)h * G) * hd;
  float qr[GP][spl_ni<MAXHD>], acc[GP][spl_ni<MAXHD>];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < spl_ni<MAXHD>; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < hd) ? to_float(q[qbase + g * hd + d]) * scale
                                   : 0.f;
      acc[g][i] = 0.f;
    }
  // after the reduce-scatter lane L holds row r_lane, head g_lane; the
  // 8 / GP lanes of one (row, head) hold the same value
  const int r_lane = lane >> 3;
  const int g_lane = (lane >> (3 - LOG_GP)) & (GP - 1);
  const bool first_dup = (lane & ((8 >> LOG_GP) - 1)) == 0;
  float m_run = NEG_INF_F, l_run = 0.f;   // of head g_lane

  auto word = [&](int tt) -> unsigned {
    return tt < ntiles ? rows.valid4(b, j0 + tt * DEC_TILE +
                                         warp * SPL_WROWS, j1)
                       : 0u;
  };
  auto key = [&](int tt) -> int {
    if constexpr (Rows::TILE_KEYS)
      return tt < ntiles ? rows.tile_key(b, j0 + tt * DEC_TILE) : 0;
    else
      return 0;
  };
  unsigned mcur = word(lane), mnext = word(32 + lane);
  [[maybe_unused]] int kcur = key(lane), knext = key(32 + lane);

  // copy this warp's rows of tile tt into stage tt % SPL_STAGES; one
  // commit group per call, empty past the last tile
  auto prefetch = [&](int tt) {
    if (tt < ntiles) {
      if (tt > 0 && (tt & 31) == 0) {
        mcur = mnext;
        mnext = word(tt + 32 + lane);
        if constexpr (Rows::TILE_KEYS) {
          kcur = knext;
          knext = key(tt + 32 + lane);
        }
      }
      const unsigned vw = __shfl_sync(FULL, mcur, tt & 31);
      int kt = 0;
      if constexpr (Rows::TILE_KEYS) kt = __shfl_sync(FULL, kcur, tt & 31);
      const int s = tt % SPL_STAGES;
      const int jb = j0 + tt * DEC_TILE + warp * SPL_WROWS;
      if (lane < SPL_WROWS) {
        const bool ok = (vw >> lane) & 1u;
        const float* ksp = rows.k_scales();
        if (ksp != nullptr) {
          const size_t si = ok ? rows.scale_index(b, h, jb + lane, kt) : 0;
          copy_unit<4>(&sw.ksc[s][lane], ksp + si, ok);
          copy_unit<4>(&sw.vsc[s][lane], rows.v_scales() + si, ok);
        } else {
          sw.ksc[s][lane] = sw.vsc[s][lane] = 1.f;
        }
      }
      if (lane == 0) sw.vw[s] = vw;
      for (int e = lane; e < SPL_WROWS * units; e += 32) {
        const int r = e / units, u = e - r * units;
        const bool ok = (vw >> r) & 1u;
        const size_t off = ok ? rows.offset(b, h, jb + r, kt) : 0;
        const size_t dst = (size_t)(s * SPL_WROWS + r) * rb + (size_t)u * U;
        copy_unit<U>(kbuf + dst,
                     reinterpret_cast<const unsigned char*>(kc + off) + u * U,
                     ok);
        copy_unit<U>(vbuf + dst,
                     reinterpret_cast<const unsigned char*>(vc + off) + u * U,
                     ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < SPL_STAGES - 1; ++s) prefetch(s);
  for (int t = 0; t < ntiles; ++t) {
    prefetch(t + SPL_STAGES - 1);
    cp_async_wait<SPL_STAGES - 1>();
    __syncwarp();
    const int s = t % SPL_STAGES;
    const unsigned vw = sw.vw[s];
    if (vw != 0u) {   // warp-uniform: a tile with no valid row changes nothing
      // scores: part[r * GP + g] = lane's share of q_g . k_r
      float part[SPL_WROWS * GP];
#pragma unroll
      for (int r = 0; r < SPL_WROWS; ++r) {
        const TKV* kr =
            reinterpret_cast<const TKV*>(kbuf + (size_t)(s * SPL_WROWS + r) * rb);
        float kf[spl_ni<MAXHD>];
#pragma unroll
        for (int i = 0; i < spl_ni<MAXHD>; ++i) {
          const int d = lane + 32 * i;
          kf[i] = d < hd ? to_float(kr[d]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < spl_ni<MAXHD>; ++i) a += qr[g][i] * kf[i];
          part[r * GP + g] = a;
        }
      }
      reduce_scatter<SPL_WROWS * GP, 16>(part, lane);
      const bool ok = ((vw >> r_lane) & 1u) && g_lane < G;
      const float sc = part[0] * sw.ksc[s][r_lane];
      float mt = ok ? sc : NEG_INF_F;
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 8));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 16));
      const float m_new = fmaxf(m_run, mt);
      const float p = ok ? expf(sc - m_new) : 0.f;
      float ps = p + __shfl_xor_sync(FULL, p, 8);
      ps += __shfl_xor_sync(FULL, ps, 16);
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + ps;
      m_run = m_new;
      if (first_dup) {
        sw.p[r_lane * GP + g_lane] = p * sw.vsc[s][r_lane];
        if (r_lane == 0) sw.alpha[g_lane] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float a = sw.alpha[g];
#pragma unroll
        for (int i = 0; i < spl_ni<MAXHD>; ++i) acc[g][i] *= a;
      }
#pragma unroll
      for (int r = 0; r < SPL_WROWS; ++r) {
        const TKV* vr =
            reinterpret_cast<const TKV*>(vbuf + (size_t)(s * SPL_WROWS + r) * rb);
        float vf[spl_ni<MAXHD>];
#pragma unroll
        for (int i = 0; i < spl_ni<MAXHD>; ++i) {
          const int d = lane + 32 * i;
          vf[i] = d < hd ? to_float(vr[d]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float pr = sw.p[r * GP + g];
#pragma unroll
          for (int i = 0; i < spl_ni<MAXHD>; ++i) acc[g][i] += pr * vf[i];
        }
      }
    }
    __syncwarp();   // the stage and the weights are read before reuse
  }
  cp_async_wait<0>();

  // merge the warps' (m, l, acc) in warp order, in the stage area
  __syncthreads();
  const int ld = hd + 2;
  float* mrg = reinterpret_cast<float*>(spl_smem);   // (warps, G, hd + 2)
  float* mine = mrg + (size_t)warp * G * ld;
  if (lane < 8 && first_dup && g_lane < G) {
    mine[g_lane * ld + hd] = m_run;
    mine[g_lane * ld + hd + 1] = l_run;
  }
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < spl_ni<MAXHD>; ++i) {
      const int d = lane + 32 * i;
      if (g < G && d < hd) mine[g * ld + d] = acc[g][i];
    }
  __syncthreads();
  if (gridDim.z == 1) {   // block-uniform: does the row hold a valid row?
    float l0 = 0.f;
#pragma unroll
    for (int w = 0; w < SPL_WARPS; ++w) l0 += mrg[w * G * ld + hd + 1];
    if (l0 == 0.f) {
      write_empty_row<TQ>(vc, rows, out, qbase, b, h, G, hd);
      return;
    }
  }
  for (int idx = tid; idx < G * hd; idx += SPL_THREADS) {
    const int g = idx / hd, d = idx - g * hd;
    float M = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < SPL_WARPS; ++w)
      M = fmaxf(M, mrg[(w * G + g) * ld + hd]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < SPL_WARPS; ++w) {
      const float* mw = mrg + (w * G + g) * ld;
      const float e = expf(mw[hd] - M);
      L += e * mw[hd + 1];
      A += e * mw[d];
    }
    if (gridDim.z == 1) {
      out[qbase + idx] = from_float<TQ>(A / fmaxf(L, 1e-20f));
    } else {
      float* pp = part + (((size_t)(b * Hkv + h) * gridDim.z + split) * G +
                          g) * ld;
      pp[d] = A;
      if (d == 0) {
        pp[hd] = M;
        pp[hd + 1] = L;
      }
    }
  }
}

// Merge the n_split partials of split_decode_body for one (kv head, batch
// row) block, in split order: out = sum_s e_s acc_s / max(sum_s e_s l_s,
// 1e-20) with e_s = exp(m_s - max_s m_s); a row whose sum is 0 (no valid
// row in any split) goes to write_empty_row. Blocks of SPL_THREADS.
template <typename TQ, typename TKV, typename Rows>
__device__ void split_combine_body(const float* __restrict__ part,
                                   const TKV* __restrict__ vc,
                                   TQ* __restrict__ out, const Rows& rows,
                                   int H, int Hkv, int hd, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv, ld = hd + 2;
  __shared__ float w_s[DEC_MAX_G][DEC_MAX_SPLIT];
  __shared__ float l_s[DEC_MAX_G];
  const float* pb = part + (size_t)(b * Hkv + h) * n_split * G * ld;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = NEG_INF_F;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, pb[(s * G + g) * ld + hd]);
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float e = expf(pb[(s * G + g) * ld + hd] - M);
      w_s[g][s] = e;
      L += e * pb[(s * G + g) * ld + hd + 1];
    }
    l_s[g] = L;
  }
  __syncthreads();
  const size_t qbase = ((size_t)b * H + (size_t)h * G) * hd;
  if (l_s[0] == 0.f) {   // block-uniform
    write_empty_row<TQ>(vc, rows, out, qbase, b, h, G, hd);
    return;
  }
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int g = idx / hd, d = idx - g * hd;
    float A = 0.f;
    for (int s = 0; s < n_split; ++s)
      A += w_s[g][s] * pb[(s * G + g) * ld + d];
    out[qbase + idx] = from_float<TQ>(A / fmaxf(l_s[g], 1e-20f));
  }
}

template <typename TQ, typename TKV, int GP, int U, typename Rows>
__global__ void __launch_bounds__(SPL_THREADS,
                                  (GP <= 2 ? 6 : GP == 4 ? 5 : 4))
split_decode_kernel(const TQ* q, const TKV* k, const TKV* v, TQ* out,
                    float* part, Rows rows, int H, int rows_per_split,
                    float scale) {
  split_decode_body<GP, U, TQ, TKV, Rows>(q, k, v, out, part, rows, H,
                                          rows.Hkv, rows.hd, rows_per_split,
                                          scale);
}

// the dense kernel's hd-256 body: one block an SM may hold all 255
// registers a thread (the query and accumulator registers alone are
// 2 * GP * 8 a lane)
template <typename TQ, typename TKV, int GP, int U, typename Rows>
__global__ void __launch_bounds__(SPL_THREADS, 1)
split_decode_wide_kernel(const TQ* q, const TKV* k, const TKV* v, TQ* out,
                         float* part, Rows rows, int H, int rows_per_split,
                         float scale) {
  split_decode_body<GP, U, TQ, TKV, Rows, DEC_WIDE_HD>(
      q, k, v, out, part, rows, H, rows.Hkv, rows.hd, rows_per_split, scale);
}

template <typename TQ, typename TKV, typename Rows>
__global__ void __launch_bounds__(SPL_THREADS)
split_combine_kernel(const float* part, const TKV* v, TQ* out, Rows rows,
                     int H, int n_split) {
  split_combine_body<TQ, TKV, Rows>(part, v, out, rows, H, rows.Hkv, rows.hd,
                                    n_split);
}

// --------------------------------------------------------------------------
// The one launcher of both decode kernels: it checks the split plan, picks
// the copy unit and GP, launches the split kernel on the grid (kv head,
// batch row, split) and, with more than one split, the combine kernel.
// --------------------------------------------------------------------------
struct SplitLaunch {
  const void *q, *k, *v;   // q (B, 1, H, hd) of TQ; K/V rows of TKV
  void* out;               // like q
  float* part;             // workspace (B, Hkv, n_split, G, hd + 2), or
                           // null for one split
  int B, H, n_split, rows_per_split;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int GP, int U, int MAXHD,
          typename Rows>
int launch_split_kernel(const SplitLaunch& a, const Rows& rows) {
  const size_t smem = split_smem_bytes(a.H / rows.Hkv, rows.hd, sizeof(TKV));
  const dim3 grid(rows.Hkv, a.B, a.n_split);
  const float scale = 1.0f / sqrtf(static_cast<float>(rows.hd));
  if constexpr (MAXHD == DEC_MAX_HD) {
    split_decode_kernel<TQ, TKV, GP, U, Rows>
        <<<grid, SPL_THREADS, smem, a.stream>>>(
            static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
            static_cast<const TKV*>(a.v), static_cast<TQ*>(a.out), a.part,
            rows, a.H, a.rows_per_split, scale);
  } else {
    static_assert(MAXHD == DEC_WIDE_HD, "MAXHD: DEC_MAX_HD or DEC_WIDE_HD");
    const cudaError_t err = cudaFuncSetAttribute(
        split_decode_wide_kernel<TQ, TKV, GP, U, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    split_decode_wide_kernel<TQ, TKV, GP, U, Rows>
        <<<grid, SPL_THREADS, smem, a.stream>>>(
            static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
            static_cast<const TKV*>(a.v), static_cast<TQ*>(a.out), a.part,
            rows, a.H, a.rows_per_split, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// One kv head's G query heads cut into `groups` equal groups of at most
// DEC_MAX_G (launch_decode, for G > DEC_MAX_G): the split and combine
// kernels run each group as a kv head of its own, Hkv = rows.Hkv * groups
// of them with G / groups query heads each, so that virtual head
// h * groups + i holds query heads h * G + i * G / groups + [0, G /
// groups), and every row lookup maps it back to kv head h. Each group's
// blocks read their kv head's rows themselves, the first group from
// device memory and the others mostly from the L2.
template <typename Rows>
struct GroupedRows {
  Rows rows;
  int groups, Hkv, hd;
  static constexpr bool TILE_KEYS = Rows::TILE_KEYS;
  __host__ __device__ int capacity() const { return rows.capacity(); }
  __device__ int num_rows(int b) const { return rows.num_rows(b); }
  __device__ unsigned valid4(int b, int j, int jend) const {
    return rows.valid4(b, j, jend);
  }
  __device__ int tile_key(int b, int j) const { return rows.tile_key(b, j); }
  __device__ size_t offset(int b, int h, int j, int key) const {
    return rows.offset(b, h / groups, j, key);
  }
  __device__ const float* k_scales() const { return rows.k_scales(); }
  __device__ const float* v_scales() const { return rows.v_scales(); }
  __device__ size_t scale_index(int b, int h, int j, int key) const {
    return rows.scale_index(b, h / groups, j, key);
  }
};

// the fewest groups of at most DEC_MAX_G query heads that divide G
// (ops.decode_groups plans the same)
inline int dec_groups(int G) {
  int n = (G + DEC_MAX_G - 1) / DEC_MAX_G;
  while (G % n != 0) ++n;
  return n;
}

// a group of G / groups <= DEC_MAX_G heads takes the GP 8 body: one
// instantiation for every group size
template <typename TQ, typename TKV, int U, int MAXHD, typename Rows>
int launch_split_g(const SplitLaunch& a, const GroupedRows<Rows>& rows) {
  return launch_split_kernel<TQ, TKV, DEC_MAX_G, U, MAXHD>(a, rows);
}

template <typename TQ, typename TKV, int U, int MAXHD, typename Rows>
int launch_split_g(const SplitLaunch& a, const Rows& rows) {
  const int G = a.H / rows.Hkv;
  if (G == 1) return launch_split_kernel<TQ, TKV, 1, U, MAXHD>(a, rows);
  if (G == 2) return launch_split_kernel<TQ, TKV, 2, U, MAXHD>(a, rows);
  if (G <= 4) return launch_split_kernel<TQ, TKV, 4, U, MAXHD>(a, rows);
  return launch_split_kernel<TQ, TKV, 8, U, MAXHD>(a, rows);
}

// The copy unit: 16 bytes where a row's byte length and both bases allow,
// else 4, else the element (2- and 1-byte elements only: a row of 4-byte
// elements always takes 4-byte units), so only those (TKV, U) pairs exist.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan or shape
// the kernels do not take (a head wider than MAXHD among them).
template <typename TQ, typename TKV, int MAXHD, typename Rows>
int launch_split_decode(const SplitLaunch& a, const Rows& rows) {
  const int Hkv = rows.Hkv, hd = rows.hd;
  if (a.H % Hkv != 0 || a.H / Hkv > DEC_MAX_G || hd > MAXHD ||
      a.n_split < 1 || a.n_split > DEC_MAX_SPLIT ||
      a.rows_per_split % DEC_TILE != 0 ||
      (long)a.n_split * a.rows_per_split < rows.capacity() ||
      (a.n_split > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = hd * static_cast<int>(sizeof(TKV));
  int err;
  if (nb % 16 == 0 && aligned(a.k, 16) && aligned(a.v, 16))
    err = launch_split_g<TQ, TKV, 16, MAXHD>(a, rows);
  else if (nb % 4 == 0 && aligned(a.k, 4) && aligned(a.v, 4))
    err = launch_split_g<TQ, TKV, 4, MAXHD>(a, rows);
  else if constexpr (sizeof(TKV) < 4)
    err = launch_split_g<TQ, TKV, static_cast<int>(sizeof(TKV)), MAXHD>(
        a, rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || a.n_split == 1) return err;
  split_combine_kernel<TQ, TKV, Rows>
      <<<dim3(Hkv, a.B), SPL_THREADS, 0, a.stream>>>(
          a.part, static_cast<const TKV*>(a.v), static_cast<TQ*>(a.out), rows,
          a.H, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

// The entry of both decode kernels: any G = H / Hkv; above DEC_MAX_G the
// kv heads' query heads run in groups (GroupedRows), each a block of its
// own, and the plan (n_split) must then count Hkv * dec_groups(G) heads.
// MAXHD picks the body: DEC_MAX_HD, or DEC_WIDE_HD for heads up to 256.
template <typename TQ, typename TKV, int MAXHD = DEC_MAX_HD, typename Rows>
int launch_decode(const SplitLaunch& a, const Rows& rows) {
  if (rows.Hkv < 1 || a.H < rows.Hkv || a.H % rows.Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = dec_groups(a.H / rows.Hkv);
  if (groups == 1) return launch_split_decode<TQ, TKV, MAXHD>(a, rows);
  return launch_split_decode<TQ, TKV, MAXHD>(
      a, GroupedRows<Rows>{rows, groups, rows.Hkv * groups, rows.hd});
}
